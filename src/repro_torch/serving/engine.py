"""The continuous-batching engine loop.

Port of ``repro/serving/engine.py``.  Where the reference AOT-compiles
its programs (``_compile``), the port captures each into a CUDA graph
(``_capture``) at its first use and replays it after: the decode chunk
(``_decode_compiled`` -> ``_decode_program``: ``decode_chunk`` decodes
with sampling after each, one graph per engine), the dense prefill
(``_prefill_compiled`` -> ``_prefill`` of kind "prefill": one graph per
batch signature, i.e. per prompt bucket and conditioning shape) and the
paged prefill chunk (``_prefill_chunk_compiled`` -> kind
"prefill_chunk": one graph per engine).  Each capture first runs its
program once on copies of the buffers it writes (a warm-up, on a side
stream: cuBLAS's workspaces and the paged-attention kernel's build come
before capture); its time counts in ``stats["compile_s"]`` and
``serve.compiles``, outside ``prefill_s`` and ``decode_s``.  A graph
reads and writes fixed addresses, so every program's inputs and outputs
are buffers made once — the cache tensors, the dense engine's one-slot
prefill cache, ``cur_tok``, the ``active`` row mask, the chunk's
tokens, each prefill program's token, conditioning, integer and
logits-row buffers — and every ``pos`` field the models return as a new
tensor is copied back into the cache's own (``cache.copy_into``).  The
per-request integers of a prefill (slot, frontier, valid length, prompt
extent) reach the models as device values; the prefills pick their
logits row on the device, and sampling the first token stays eager, so
the generator draws only after a prompt's last chunk, as in the
reference.  Admission writes those buffers in place.  On the CPU, or
with ``graphs=False``, the same programs run eagerly over the same
buffers, and ``compile_s`` stays 0.0.

Execution model (dense layout — the oracle path):

* ADMISSION — each free slot takes the next arrived queued request: a
  single-request prefill (prompts zero-padded to the next power of two,
  as in the reference, with a ``valid`` length making the padding
  inert) produces the request's first token from the PREFILL logits
  plus a populated one-slot cache, which is copied into the slot batch
  cache (per-slot position vectors — see serving/cache.py).
* DECODE — one chunk per engine step: ``decode_chunk`` single-token
  decodes, sampling (greedy / temperature / top-k) after each.  The
  scheduler absorbs the chunk host-side, evicts finished slots (EOS or
  max-new-tokens; tokens decoded speculatively past a termination are
  discarded), and freed slots are refilled on the next step.

Conditioned families: a vlm request carries ``patch_embeds``
(num_patches, d) and an audio request ``cond`` (cond_len, d) frames and a
(K, T) prompt over K codebooks.  The audio cond frames take the first
cache positions, so every position the engine reckons (bucket, pages,
frontier, pos) counts them (``_cond_extra``); the audio engine's tokens
are (K,) per step, ``cur_tok`` (num_slots, K, 1).

Paged layout (``paged=True``): KV lives in fixed-size page pools behind
per-slot page tables (serving/paging.py decides the pages, cache.py /
attention.py hold the device layout).  The ssm family keeps its O(1)
recurrent state per slot instead: it reserves no pages and shares no
prefix; the ssm and hybrid families' prefill chunk is rounded up to
``ssm_chunk`` so that the SSD chunk decomposition lines up across
prefill calls.

* Admission reserves the request's WORST-CASE pages — ceil((prompt +
  max_new) / page_size) — all-or-nothing: a request that can't get
  pages waits in queue (backpressure) without reordering (scheduler
  pops min (arrival, uid)).  Prompt pages are hash-matched against the prefix store: matched pages are shared
  (refcounted, read-only) and prefill RESUMES at the reuse frontier; a
  partially-reused page is copy-on-extended first.
* Prefill runs CHUNKED — ``prefill_chunk`` tokens of ONE slot per
  engine step, interleaved with everyone else's decode.  The final
  chunk's logits row ``valid-1`` yields the first token, the prompt's
  full pages are published to the prefix store, and the slot joins the
  decode batch (``active`` row mask).
* Decode either gathers the pool into a dense view once per chunk
  (page tables are constant within a chunk) and loops the plain dense
  decode, or — ``use_paged_kernel=True`` — reads K/V straight from the
  pool every step through the paged-attention kernel (K8).
* Greedy paged decode is token-for-token identical to the dense engine:
  the gathered page extent equals the dense cache extent when
  max_len % page_size == 0, and every row's compute depends only on its
  own pages + position.
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import paged_attention
from repro_torch.models.model import build_model
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import Tracer
from repro_torch.serving import cache as cache_lib
from repro_torch.serving import paging
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import SamplingParams, make_token_selector
from repro_torch.serving.scheduler import Scheduler

# per-request latency bucket ladder (ms): sub-ms to minutes, 1-2-5
_LATENCY_BOUNDS_MS = tuple(m * 10.0 ** e for e in range(-1, 6)
                           for m in (1.0, 2.0, 5.0))

# families whose prompt KV depends only on the token ids — prefix pages
# are shareable.  ssm carries non-pageable recurrent state, so it never
# shares.
_SHAREABLE = ("dense", "moe")


def _conditioning(req: Request) -> dict:
    """The request's ``cond`` / ``patch_embeds`` that it has, as tensors."""
    return {name: torch.as_tensor(getattr(req, name))
            for name in ("cond", "patch_embeds")
            if getattr(req, name) is not None}


class _Prefill:
    """One prefill program and the buffers it reads and writes, made once
    at fixed addresses: ``batch`` (``tokens`` (1, [K,] T) int32 and the
    conditioning), ``ints`` = (slot, frontier, valid, total) as a (4,)
    int64 tensor, and ``row``, the (1, 1, [K,] V) logits row the program
    picks at ``valid - 1``.  ``run`` is set by ``Engine._prefill``."""

    def __init__(self, tokens_shape, cond: dict, row_shape, row_dtype,
                 device):
        self.batch = {"tokens": torch.zeros((1,) + tokens_shape,
                                            dtype=torch.int32, device=device)}
        for name, value in cond.items():
            self.batch[name] = torch.zeros((1,) + tuple(value.shape),
                                           dtype=value.dtype, device=device)
        self.ints = torch.zeros((4,), dtype=torch.int64, device=device)
        self.row = torch.zeros(row_shape, dtype=row_dtype, device=device)
        self.run = None

    def stage(self, tokens: np.ndarray, cond: dict, ints) -> None:
        """Copy one prefill's inputs into the buffers."""
        self.batch["tokens"].copy_(torch.from_numpy(tokens)[None])
        for name, value in cond.items():
            self.batch[name].copy_(value[None])
        self.ints.copy_(torch.tensor(ints, dtype=torch.int64))


def _bucket_len(n: int, lo: int, hi: int) -> int:
    """Next power of two >= n, clamped to [lo, hi] but never below n."""
    b = lo
    while b < n:
        b *= 2
    return max(min(b, hi), n)


class Engine:
    def __init__(self, cfg, params, num_slots: int = 8, max_len: int = 256,
                 decode_chunk: int = 8,
                 sampling: SamplingParams = SamplingParams(), seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 32,
                 prefix_share: bool = True, use_paged_kernel: bool = False,
                 registry: Optional[Registry] = None,
                 tracer: Optional[Tracer] = None, device=None,
                 graphs: bool = True):
        """``device``: where the engine runs — ``cuda`` unless given;
        ``params`` must already live there.  ``graphs``: on CUDA, replay
        each program (decode chunk, prefills) as a CUDA graph; ``False``
        runs them eagerly there too, as they always run on the CPU."""
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.model = build_model(cfg, use_paged_kernel=use_paged_kernel)
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.decode_chunk = decode_chunk
        self.sampling = sampling
        self.selector = make_token_selector(cfg, sampling)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.paged = paged
        self.use_paged_kernel = use_paged_kernel
        self.graphs = graphs and self.device.type == "cuda"
        # one memory pool for all of the engine's graphs (see _capture)
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self._program = None          # the decode chunk, see _decode_program
        self._prefills = {}           # signature -> _Prefill, see _prefill
        self._row_shape = ((1, 1) + ((cfg.num_codebooks,)
                                     if cfg.family == "audio" else ())
                           + (cfg.vocab_size,))

        self.sched = Scheduler(num_slots)
        tok_shape = ((num_slots, cfg.num_codebooks, 1)
                     if cfg.family == "audio" else (num_slots, 1))
        # the decode chunk's inputs and outputs, at fixed addresses
        self.cur_tok = torch.zeros(tok_shape, dtype=torch.int32,
                                   device=self.device)
        self._active = torch.zeros((num_slots,), dtype=torch.bool,
                                   device=self.device)
        self._toks = torch.zeros((decode_chunk,) + tok_shape,
                                 dtype=torch.int32, device=self.device)

        if paged:
            if getattr(cfg, "sliding_window", 0):
                raise ValueError("paged cache does not support sliding "
                                 "windows (ring-buffer layout)")
            self.page_size = page_size
            self.max_pages = -(-max_len // page_size)
            # ssd's chunk decomposition must align across prefill calls
            qc = getattr(cfg, "ssm_chunk", 0)
            if cfg.family in ("ssm", "hybrid") and qc:
                prefill_chunk = -(-prefill_chunk // qc) * qc
            self.prefill_chunk_len = prefill_chunk
            # pages for kv-bearing families; ssm state is O(1) per slot
            self.uses_pages = cfg.family != "ssm"
            if num_pages is None:
                num_pages = num_slots * self.max_pages + 1
            self.num_pages = num_pages
            self.pool = paging.PagePool(
                num_pages, page_size,
                share=prefix_share and cfg.family in _SHAREABLE)
            self.cache = cache_lib.init_paged_slot_cache(
                self.model, params, num_slots, num_pages, page_size,
                self.max_pages)
            self._slot_plan = {}          # slot -> AdmitPlan
        else:
            self.cache = cache_lib.init_slot_cache(self.model, params,
                                                   num_slots, max_len)
            # the dense prefill's one-slot cache, reset at every prefill
            self._one = self.model.init_cache(params, 1, max_len)

        self._uid = 0
        self.stats = {"compile_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
                      "prefill_tokens": 0, "decode_steps": 0,
                      "decode_tokens": 0, "chunks": 0, "prefill_chunks": 0,
                      "warmup_steps": 0}
        # telemetry: always-on host-side registry (a caller-supplied one
        # lets serve.py / tests aggregate across engines); the tracer
        # defaults to disabled — spans cost nothing unless requested
        self.obs = registry if registry is not None else Registry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self._t_submit = {}          # uid -> perf_counter at submit()
        self._deadline = {}          # uid -> perf_counter shed deadline
        self._n_done_obs = 0         # finished-dict prefix already observed

    # -- submission ---------------------------------------------------
    def _cond_extra(self, req: Request) -> int:
        """Extra leading cache positions (audio conditioning frames)."""
        return int(req.cond.shape[0]) if req.cond is not None else 0

    def submit(self, tokens, max_new_tokens: int, eos_id: Optional[int] = None,
               arrival: int = 0, cond=None, patch_embeds=None,
               deadline_ms: Optional[float] = None) -> int:
        """Queue one (T,) int prompt — (K, T) for audio, with its ``cond``
        frames; vlm prompts need their ``patch_embeds`` — and return its
        uid."""
        req = Request(uid=self._uid, tokens=tokens,
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      arrival=arrival, cond=cond, patch_embeds=patch_embeds,
                      deadline_ms=deadline_ms)
        if req.prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt_len {req.prompt_len} + max_new_tokens "
                f"{max_new_tokens} exceeds max_len {self.max_len}")
        if self.cfg.family == "vlm" and patch_embeds is None:
            raise ValueError("vlm requests need patch_embeds conditioning")
        if self.paged and self.uses_pages:
            need = self.pool.pages_needed(
                self._cond_extra(req) + req.prompt_len + max_new_tokens)
            if need > self.pool.alloc.usable:
                raise ValueError(
                    f"request needs {need} pages but the pool only has "
                    f"{self.pool.alloc.usable} usable pages")
        self._uid += 1
        self._t_submit[req.uid] = time.perf_counter()
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise ValueError("deadline_ms must be > 0")
            self._deadline[req.uid] = self._t_submit[req.uid] + deadline_ms / 1e3
        self.obs.counter("serve.requests").inc()
        self.sched.submit(req)
        return req.uid

    # -- prefill programs ---------------------------------------------
    def _prefill(self, kind: str, req: Request, tokens: np.ndarray,
                 ints) -> _Prefill:
        """Stage one prefill into the buffers of its program and return
        the program (a ``_Prefill``; call its ``run``): ``tokens`` (T,) or
        (K, T), the request's conditioning, and ``ints`` = (slot,
        frontier, valid, total).  ``kind`` "prefill" is the dense prefill
        of one bucket-padded request from a fresh one-slot cache, one
        program per batch signature (the reference's
        ``_prefill_compiled``); "prefill_chunk" is one paged chunk of one
        slot, written into the slot cache (``_prefill_chunk_compiled``:
        one program per engine, as its shapes never change).  A program is
        made, and on CUDA captured, at its first use, after its inputs are
        staged (its warm-up reads them)."""
        cond = _conditioning(req)
        sig = (kind, tokens.shape) + tuple(
            (name, tuple(v.shape), v.dtype) for name, v in cond.items())
        prog = self._prefills.get(sig)
        if prog is None:
            prog = self._prefills[sig] = _Prefill(
                tokens.shape, cond, self._row_shape,
                self.params["embed"].dtype, self.device)
        prog.stage(tokens, cond, ints)
        if prog.run is None:
            if kind == "prefill":
                body, cache = self._prefill_into, self._one
                name = f"prefill[{tokens.shape[-1]}]"
            else:
                body, cache, name = (self._prefill_chunk_into, self.cache,
                                     "prefill_chunk")
            args = (prog.batch, prog.ints, prog.row)
            prog.run = self._capture(
                name, functools.partial(body, cache, *args),
                lambda: body(cache_lib.clone(cache), prog.batch, prog.ints,
                             torch.empty_like(prog.row)))
        return prog

    def _prefill_into(self, cache, batch, ints, row):
        """The dense prefill: ``cache`` (the one-slot cache) reset to its
        init values — the reference starts every prefill from a fresh
        cache, and the ssm and hybrid states must not leak from the last
        request — then written in place, and the logits row at ``valid -
        1`` (``ints[2]``) copied into ``row``."""
        cache_lib.reset(cache)
        valid = ints[2:3]
        logits, _ = self.model.prefill(self.params, batch, cache, valid)
        row.copy_(logits.index_select(1, valid - 1))

    def _prefill_chunk_into(self, cache, batch, ints, row):
        """One paged prefill chunk of slot ``ints[0]`` from frontier
        ``ints[1]``, ``ints[2]`` live rows of a prompt of ``ints[3]``
        positions, written into ``cache`` in place; the logits row at
        ``valid - 1`` copied into ``row``."""
        slot, frontier, valid, total = ints.split(1)
        logits, _ = self.model.prefill_chunk(self.params, batch, cache, slot,
                                             frontier, valid, total)
        row.copy_(logits.index_select(1, valid - 1))

    # -- dense admission ----------------------------------------------
    def _prefill_tokens(self, req: Request):
        """The prompt zero-padded to its bucket + the true valid length."""
        toks = np.asarray(req.tokens, np.int32)
        T = toks.shape[-1]
        bucket = _bucket_len(T, 8, self.max_len - self._cond_extra(req))
        toks = np.pad(toks, [(0, 0)] * (toks.ndim - 1) + [(0, bucket - T)])
        return toks, T

    def _admit(self):
        while True:
            pairs = self.sched.admissible()
            if not pairs:
                return
            for slot, req in pairs:
                tokens, valid = self._prefill_tokens(req)
                total = self._cond_extra(req) + req.prompt_len
                prog = self._prefill("prefill", req, tokens,
                                     (slot, 0, valid, total))
                t0 = time.perf_counter()
                with self.tracer.span("prefill", cat="prefill",
                                      uid=req.uid, tokens=req.prompt_len):
                    prog.run()
                    first = self.selector(prog.row,
                                          self.generator)  # (1, [K,] 1)
                    first_host = first[0, ..., 0].cpu().numpy()
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.stats["prefill_tokens"] += req.prompt_len
                self._observe_first_token(req.uid)
                self.obs.counter("serve.admitted").inc()
                cache_lib.write_slot(self.cache, self._one, slot, total)
                self.cur_tok[slot] = first[0]
                self.sched.place(slot, req, first_host)
                # a request finishing on its first token frees the slot
                # again — the outer while loop re-runs admission

    # -- paged admission + chunked prefill ----------------------------
    def _admit_paged(self):
        while self.sched.free_slots():
            req = self.sched._pop_arrived()
            if req is None:
                return
            total = self._cond_extra(req) + req.prompt_len
            if self.uses_pages:
                share_toks = (np.asarray(req.tokens, np.int32)
                              if self.cfg.family in _SHAREABLE else None)
                plan = self.pool.admit(share_toks, total,
                                       total + req.max_new_tokens)
                if plan is None:
                    # backpressure: wait for pages; (arrival, uid) order
                    # is restored by the deterministic pop
                    self.obs.counter("serve.backpressure").inc()
                    self.obs.counter("serve.requeued").inc()
                    self.sched.requeue(req)
                    return
            else:
                plan = paging.AdmitPlan(pages=[])
            slot = self.sched.free_slots()[0]
            self._slot_plan[slot] = plan
            if plan.cow is not None:
                dst, src = plan.cow
                cache_lib.copy_page(self.cache, dst, src)
            row = np.zeros((self.max_pages,), np.int32)
            row[:len(plan.pages)] = plan.pages
            cache_lib.admit_slot(self.cache, slot, row)
            self.obs.counter("serve.admitted").inc()
            self.sched.place_prefilling(slot, req, frontier=plan.reuse_len)

    def _chunk_tokens(self, req: Request, frontier: int) -> np.ndarray:
        """The ([K,] C)-token slice of the prompt at ``frontier`` (merged
        coordinates), zero-filled for cond-region and padded positions."""
        C = self.prefill_chunk_len
        ce = self._cond_extra(req)
        toks = np.asarray(req.tokens, np.int32)
        chunk = np.zeros(toks.shape[:-1] + (C,), np.int32)
        lo = max(frontier - ce, 0)               # first token of the chunk
        span = toks[..., lo:max(frontier + C - ce, lo)]
        at = lo + ce - frontier                  # its column in the chunk
        chunk[..., at:at + span.shape[-1]] = span
        return chunk

    def _prefill_step_paged(self):
        """Advance every prefilling slot by one chunk; slots whose prompt
        completes get their first token and join the decode batch."""
        for slot in self.sched.prefilling_slots():
            rec = self.sched.slots[slot]
            req = rec.request
            total = self._cond_extra(req) + req.prompt_len
            f = rec.frontier
            valid = min(self.prefill_chunk_len, total - f)
            prog = self._prefill("prefill_chunk", req,
                                 self._chunk_tokens(req, f),
                                 (slot, f, valid, total))
            t0 = time.perf_counter()
            with self.tracer.span("prefill_chunk", cat="prefill",
                                  uid=req.uid, frontier=f, tokens=valid):
                # writes self.cache in place; pos is set once done
                prog.run()
                rec.frontier = f + valid
                done = rec.frontier >= total
                if done:
                    # sampled only after the last chunk, as the reference
                    first = self.selector(prog.row,
                                          self.generator)  # (1, [K,] 1)
                    first_host = first[0, ..., 0].cpu().numpy()
                elif self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += valid
            self.stats["prefill_chunks"] += 1
            if done:
                if self.uses_pages:
                    # prompt pages are final now: publish for sharing
                    self.pool.finalize_prompt(self._slot_plan[slot], total)
                cache_lib.set_slot_pos(self.cache, slot, total)
                self.cur_tok[slot] = first[0]
                self._observe_first_token(req.uid)
                if self.sched.finish_prefill(slot, first_host):
                    self._release_slot(slot)

    def _release_slot(self, slot: int):
        plan = self._slot_plan.pop(slot, None)
        if plan is not None and self.uses_pages:
            self.pool.release(plan)

    # -- decode chunks ------------------------------------------------
    def _decode_chunk(self, cache, tok, active, generator):
        """``decode_chunk`` single-token decodes over the slot batch from
        ``tok``, sampling after each; the models write ``cache`` in
        place.  Returns the chunk's tokens (C, B, [K,] 1) and the cache
        tuple the last step returned (its ``pos`` fields new tensors).
        ``active``: (B,) bool mask of decoding rows (paged layout
        only)."""
        model, params = self.model, self.params
        toks = []
        if self.paged and self.use_paged_kernel:
            # per-step paged attention: every step reads KV straight
            # from the pool through the paged-attention kernel
            for _ in range(self.decode_chunk):
                logits, cache = model.decode_paged(
                    params, {"tokens": tok}, cache, active)
                tok = self.selector(logits, generator)
                toks.append(tok)
        elif self.paged:
            # hoisted gather: page tables are constant across the
            # chunk, so gather pool -> dense view once, loop the plain
            # dense decode (bitwise the same values), scatter back once
            # (inactive rows -> trash page, pos frozen)
            dense = model.paged_to_dense(cache)
            for _ in range(self.decode_chunk):
                logits, dense = model.decode(params, {"tokens": tok}, dense)
                tok = self.selector(logits, generator)
                toks.append(tok)
            cache = model.paged_restore(cache, dense, active,
                                        self.decode_chunk)
        else:
            for _ in range(self.decode_chunk):
                logits, cache = model.decode(params, {"tokens": tok}, cache)
                tok = self.selector(logits, generator)
                toks.append(tok)
        return torch.stack(toks), cache

    def _chunk_into(self, cache, tok, active, generator, out):
        """One decode chunk that leaves its results in the buffers it was
        given: the tokens in ``out``, the last of them in ``tok``, the
        advanced positions in ``cache``'s own pos tensors."""
        toks, new = self._decode_chunk(cache, tok, active, generator)
        cache_lib.copy_into(cache, new)
        out.copy_(toks)
        tok.copy_(toks[-1])

    def _run_eager(self):
        self._chunk_into(self.cache, self.cur_tok, self._active,
                         self.generator, self._toks)

    def _decode_program(self):
        """The decode chunk as one call over the engine's buffers: it
        reads ``cur_tok``, ``_active`` and the cache, and writes the
        cache, ``_toks`` and ``cur_tok`` in place; captured at the first
        decode step (see ``_capture``; the warm-up's steps count in
        ``stats["warmup_steps"]``).  The engine's generator is registered
        with the graph, so each replay draws from and advances it as the
        eager chunk does."""
        if self._program is None:
            def warm_up():
                gen = torch.Generator(device=self.device)
                gen.set_state(self.generator.get_state())
                self._chunk_into(cache_lib.clone(self.cache),
                                 self.cur_tok.clone(), self._active.clone(),
                                 gen, torch.empty_like(self._toks))
                self.stats["warmup_steps"] += self.decode_chunk
            self._program = self._capture("decode_chunk", self._run_eager,
                                          warm_up, self.generator)
        return self._program

    def _capture(self, name: str, run, warm_up, generator=None):
        """The program ``run`` (a call over the engine's buffers).

        On CUDA (``graphs``) it returns the replay of one CUDA graph of
        ``run``, captured here under the span ``compile:<name>``, timed
        into ``stats["compile_s"]`` and counted in ``serve.compiles``:
        the port of the reference's ``_compile``.  ``warm_up`` first runs
        the same call eagerly on a side stream, over copies of the
        buffers it writes (and of ``generator``), so that everything set
        up at a first call (cuBLAS's handles and workspaces, the
        paged-attention kernel's build) is in place before capture and
        the engine's state is untouched; the copies are freed before the
        capture.  ``generator`` is registered with the graph.  A replay
        runs no Python, so it adds the paged-attention launches its
        capture recorded to that kernel's count.  All of an engine's
        graphs allocate from one memory pool: their replays may come in
        any order, so nothing a caller reads after a replay may live in
        it — every output is written into a buffer made outside capture.
        There is no fallback: a failed capture or replay raises.
        Otherwise (CPU, ``graphs=False``) the program is ``run`` itself,
        eager."""
        if not self.graphs:
            return run
        t0 = time.perf_counter()
        with self.tracer.span(f"compile:{name}", cat="compile"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                warm_up()
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if generator is not None:
                graph.register_generator_state(generator)
            before = paged_attention.captures
            with torch.cuda.graph(graph, pool=self._pool):
                run()
            k8 = paged_attention.captures - before
        self.stats["compile_s"] += time.perf_counter() - t0
        self.obs.counter("serve.compiles").inc()

        def replay():
            graph.replay()
            paged_attention.count_replay(k8)
        return replay

    # -- graceful degradation: deadline shedding ----------------------
    def _shed_expired(self) -> None:
        """Shed every request whose ``deadline_ms`` budget has expired:
        queued requests are dropped at admission (zero tokens), occupied
        slots are evicted between decode chunks keeping their partial
        output.  An overloaded engine degrades the expired tail instead
        of serving everything late."""
        if not self._deadline:
            return
        now = time.perf_counter()
        for uid in [u for u, t in self._deadline.items() if now > t]:
            if uid in self.sched.finished:      # beat the deadline
                self._deadline.pop(uid, None)
                continue
            if self.sched.shed_queued(uid):
                self._shed_obs(uid, "queued")
                continue
            for slot, rec in enumerate(self.sched.slots):
                if rec is not None and rec.request.uid == uid:
                    self.sched.shed_slot(slot)
                    if self.paged:
                        self._release_slot(slot)
                    self._shed_obs(uid, "slot")
                    break

    def _shed_obs(self, uid: int, where: str) -> None:
        self._deadline.pop(uid, None)
        self.obs.counter("serve.deadline_exceeded", where=where).inc()
        self.obs.counter("serve.deadline_exceeded").inc()

    # -- per-request latency bookkeeping ------------------------------
    def _observe_first_token(self, uid: int) -> None:
        """TTFT: submit() -> the request's first emitted token.  Called
        right after the blocking first-token transfer, so the wall clock
        includes queueing, paged backpressure, and (chunked) prefill."""
        t0 = self._t_submit.get(uid)
        if t0 is not None:
            self.obs.histogram("serve.ttft_ms", _LATENCY_BOUNDS_MS).observe(
                (time.perf_counter() - t0) * 1e3)

    def _note_finished(self) -> None:
        """Observe completion latency for newly-finished requests.  The
        scheduler's ``finished`` dict is insertion-ordered, so only the
        suffix past the already-observed prefix is scanned — O(new)."""
        done = self.sched.finished
        if len(done) == self._n_done_obs:
            return
        now = time.perf_counter()
        hist = self.obs.histogram("serve.completion_ms", _LATENCY_BOUNDS_MS)
        for uid in list(done.keys())[self._n_done_obs:]:
            t0 = self._t_submit.pop(uid, None)
            self._deadline.pop(uid, None)
            if t0 is not None:
                hist.observe((now - t0) * 1e3)
            self.obs.counter("serve.finished").inc()
        self._n_done_obs = len(done)

    def _observe_pool(self) -> None:
        if self.paged and self.uses_pages:
            free = self.pool.alloc.num_free
            usable = max(self.pool.alloc.usable, 1)
            self.obs.gauge("serve.pages_free").set(float(free))
            self.obs.gauge("serve.page_occupancy").set(
                round(1.0 - free / usable, 4))
            self.obs.gauge("serve.prefix_hit_rate").set(
                round(self.pool.prefix_hit_rate(), 4))

    # -- the engine loop ----------------------------------------------
    def step(self) -> None:
        """One engine step: shed expired deadlines, admit, advance
        prefills (paged), decode one chunk."""
        self._shed_expired()
        if self.paged:
            self._admit_paged()
            self._prefill_step_paged()
            self._admit_paged()       # finished-on-first-token slots refill
            dec = self.sched.decoding_slots()
            if not dec:
                self.sched.tick()     # arrivals advance while prefilling
                self._note_finished()
                self._observe_pool()
                return
            active = np.zeros((self.num_slots,), bool)
            active[dec] = True
            self._active.copy_(torch.as_tensor(active))
            n_slots = len(dec)
        else:
            self._admit()
            if not self.sched.active_slots():
                self.sched.tick()     # idle tick: arrivals advance
                self._note_finished()
                return
            n_slots = len(self.sched.active_slots())
        program = self._decode_program()
        t0 = time.perf_counter()
        with self.tracer.span("decode_chunk", cat="decode", slots=n_slots,
                              chunk=self.decode_chunk):
            program()
            # (C, B) | (C, B, K); a copy: the next chunk rewrites the
            # buffer, and on the CPU .cpu() returns it as it is
            toks_host = self._toks[..., 0].cpu().numpy().copy()
        dt = time.perf_counter() - t0
        self.stats["decode_s"] += dt
        self.stats["decode_steps"] += self.decode_chunk
        self.stats["chunks"] += 1
        emitted_before = self.sched.tokens_emitted
        freed = self.sched.absorb_chunk(toks_host)
        emitted = self.sched.tokens_emitted - emitted_before
        self.stats["decode_tokens"] += emitted
        # inter-token latency: chunk wall / chunk steps, weighted by the
        # KEPT token positions this chunk produced (codebooks collapse)
        kept = emitted // self._streams
        if kept:
            self.obs.histogram("serve.itl_ms", _LATENCY_BOUNDS_MS).observe(
                dt / self.decode_chunk * 1e3, n=kept)
        if self.paged:
            for slot in freed:
                self._release_slot(slot)
        self._note_finished()
        self._observe_pool()

    @property
    def _streams(self) -> int:
        """Tokens a decode step emits per slot: K codebooks for audio."""
        return self.cfg.num_codebooks if self.cfg.family == "audio" else 1

    def run(self, max_steps: int = 100_000) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {uid: emitted tokens (G,) | (K, G)}."""
        steps = 0
        while self.sched.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return self.sched.results()

    # -- reporting ----------------------------------------------------
    def throughput(self) -> Dict[str, float]:
        """Tokens/s over KEPT tokens only — idle-slot rows and discarded
        speculative post-termination tokens never count.

        ``slot_utilization`` is the honest occupancy: kept decode-token
        positions over the chunk capacity ``decode_steps * num_slots``
        (decode_s pays for the full capacity — idle rows, prefilling
        rows and speculative post-EOS steps are computed either way);
        ``wasted_decode_tokens`` is the capacity that produced nothing.

        Per-request latency: ``ttft_ms`` (submit -> first token,
        includes queueing/backpressure/prefill), ``itl_ms`` (per kept
        decode token), ``completion_ms`` (submit -> eviction) — each a
        {count, mean, min, max, p50, p95, p99} histogram summary — plus
        the admission ``counters``.
        """
        self._note_finished()       # requests finished since last step()
        s = self.stats
        kept = s["decode_tokens"] / self._streams   # token POSITIONS kept
        capacity = s["decode_steps"] * self.num_slots
        out = {
            "compile_s": round(s["compile_s"], 3),
            "prefill_tokens_per_s": round(
                s["prefill_tokens"] / max(s["prefill_s"], 1e-9), 1),
            "decode_tokens_per_s": round(
                s["decode_tokens"] / max(s["decode_s"], 1e-9), 1),
            "slot_utilization": round(kept / max(capacity, 1), 4),
            "wasted_decode_tokens": int(capacity - kept),
        }
        for field, series in (("ttft_ms", "serve.ttft_ms"),
                              ("itl_ms", "serve.itl_ms"),
                              ("completion_ms", "serve.completion_ms")):
            summ = self.obs.histogram(series, _LATENCY_BOUNDS_MS).summary()
            out[field] = {k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in summ.items()}
        out["counters"] = {
            name: self.obs.counter(f"serve.{name}").total
            for name in ("requests", "admitted", "requeued", "backpressure",
                         "finished", "deadline_exceeded")}
        if self.paged:
            out["prefix_hit_rate"] = round(self.pool.prefix_hit_rate(), 4) \
                if self.uses_pages else 0.0
            if self.uses_pages:
                out["cow_copies"] = self.pool.stats["cow_copies"]
        return out
