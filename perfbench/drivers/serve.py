"""A serving cell: the program's paged ``Engine`` (its decode-chunk and
prefill-chunk CUDA graphs, and K8 where the mix asks for the paged
kernel) under an open loop of requests.

Set-up makes the weights from the seed, builds the engine and serves the
mix's warm-up requests, which capture both graphs.  In the window every
request is submitted when it is due and the engine steps while it has
work; a request's first token and its completion are taken when the
``Engine.step`` that produced them returns, which is when a caller of
the engine sees them.  ``ttft_p95_ms`` is the 95th percentile over all
requests due in the window of (first token - due); ``tpot_p95_ms`` that
of (completion - first token) / (tokens - 1).  After the window the
engine drains what was due (at most ``drain_s``); a request that never
finishes counts as missing, with an infinite latency.  Then the engine
is freed and the plain reference reads a sample of the served answers.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from perfbench import check, devtrace, stats, traffic
from perfbench.harness import Outcome, Record
from perfbench.reference import lm
from perfbench.reference.products import Products
from perfbench.reference.weights import derive, make_params


class Tracker:
    """The client's view of the engine: when each request was due, when
    it was first seen in a slot, when its first token and its completion
    came back, its tokens, and the slot it was seen in."""

    def __init__(self, engine):
        self.engine = engine
        self.due, self.admitted, self.first, self.done = {}, {}, {}, {}
        self.tokens, self.slot, self.req = {}, {}, {}
        self._seen_finished = 0

    def submit(self, req: traffic.Due, t_due: float) -> int:
        uid = self.engine.submit(req.prompt, max_new_tokens=req.max_new)
        self.due[uid] = t_due
        self.req[uid] = req
        return uid

    def observe(self, t: float) -> list:
        """Mark what the last step returned; returns the uids finished
        in it."""
        sched = self.engine.sched
        for s, rec in enumerate(sched.slots):
            if rec is None:
                continue
            uid = rec.request.uid
            if uid in self.due:
                self.slot[uid] = s
                self.admitted.setdefault(uid, t)
                if rec.emitted and uid not in self.first:
                    self.first[uid] = t
        new = list(sched.finished.items())[self._seen_finished:]
        self._seen_finished = len(sched.finished)
        out = []
        for uid, rec in new:
            if uid in self.due:
                self.admitted.setdefault(uid, t)
                self.first.setdefault(uid, t)
                self.done[uid] = t
                self.tokens[uid] = rec.tokens()
                out.append(uid)
        return out

    def pending(self) -> bool:
        return len(self.done) < len(self.due)


def latencies(tr: Tracker) -> tuple:
    """(TTFT s, TPOT s) of every tracked request, missing ones inf."""
    ttft, tpot = [], []
    for uid, due in tr.due.items():
        if uid not in tr.done:
            ttft.append(math.inf)
            tpot.append(math.inf)
            continue
        ttft.append(tr.first[uid] - due)
        n = len(tr.tokens[uid])
        tpot.append((tr.done[uid] - tr.first[uid]) / max(n - 1, 1))
    return ttft, tpot


def admission_waits(tr: Tracker) -> list:
    """Seconds from due to first seen in a slot of every tracked request,
    one never admitted inf: above the engine's capacity the slots stay
    full and the wait grows through the window."""
    return [tr.admitted[u] - d if u in tr.admitted else math.inf
            for u, d in tr.due.items()]


def chunk_lengths(pos: np.ndarray, active: np.ndarray, steps: int,
                  cap: int) -> list:
    """Each decode step's row lengths (the live positions K8 reads)
    given the positions after the chunk: an active row advanced one a
    step, an inactive one kept its own."""
    out = []
    for j in range(steps):
        ln = np.where(active, pos - steps + 1 + j, pos + 1)
        out.append(np.minimum(ln, cap).tolist())
    return out


def run(cell) -> Outcome:
    from repro_torch.obs import Tracer
    from repro_torch.runtime.precision import pin_float32
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.sampling import SamplingParams

    cfg, mix, dev = cell.cfg, cell.mix, cell.device
    eng = mix["engine"]
    pin_float32()
    port_cfg = cell.adapter.port_config(cfg)
    params = make_params(cell.reference.leaves(cfg), cell.seed, dev)
    schedule = traffic.serve_schedule(mix, cfg, cell.seed, cell.seconds)
    tracer = Tracer(enabled=cell.trace, collect=cell.trace)
    engine = Engine(port_cfg, params, num_slots=eng["slots"],
                    max_len=traffic.max_len(mix),
                    decode_chunk=eng["decode_chunk"],
                    sampling=SamplingParams(), seed=derive(cell.seed, "eng"),
                    paged=True, page_size=eng["page_size"],
                    prefill_chunk=eng["prefill_chunk"],
                    use_paged_kernel=eng["use_paged_kernel"],
                    tracer=tracer, device=dev)
    # set-up: the warm-up requests capture the prefill-chunk and decode
    # graphs (and build K8)
    for w in traffic.warmup_requests(mix, cfg, cell.seed):
        engine.submit(w.prompt, max_new_tokens=w.max_new)
    engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - cell.t_start

    tr = Tracker(engine)
    tr.observe(0.0)                      # the warm-up's finished requests
    window = devtrace.Window() if cell.trace else None
    prof_at = mix["profile_at"] * cell.seconds
    prof_steps, prof_left = mix["profile_steps"], None
    chunks = []                          # (decode chunk lengths) per step
    S_pad = engine.max_pages * engine.page_size
    st0 = dict(engine.stats)
    i, n = 0, len(schedule)
    stack = contextlib.ExitStack()
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while i < n and schedule[i].due_s <= now:
            tr.submit(schedule[i], schedule[i].due_s)
            i += 1
        if now >= cell.seconds:
            break
        if (window is not None and prof_left is None and now >= prof_at
                and dev.type == "cuda"):
            stack.enter_context(devtrace.traced(window, dev))
            prof_left = prof_steps
        if not engine.sched.has_work():
            time.sleep(max(0.0, min(schedule[i].due_s - now, 0.002))
                       if i < n else 0.002)
            continue
        profiling = prof_left is not None and prof_left > 0
        _step(engine, tr, t0, chunks if cell.trace else None, S_pad,
              profiling)
        if profiling:
            prof_left -= 1
            if prof_left == 0:
                stack.close()
    stack.close()
    close = time.perf_counter()
    st1 = dict(engine.stats)
    window_chunks = len(chunks)
    while tr.pending() and time.perf_counter() - close < mix["drain_s"]:
        _step(engine, tr, t0, None, S_pad)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    ttft, tpot = latencies(tr)
    missing = sum(1 for v in ttft if math.isinf(v))

    record = None
    if cell.trace:
        t_open = (t0 - tracer.t0) * 1e6
        t_shut = (close - tracer.t0) * 1e6
        spans = [(e["name"], e["dur"] / 1e6, e["args"])
                 for e in tracer.events if t_open <= e["ts"] <= t_shut]
        kept = st1["decode_tokens"] - st0["decode_tokens"]
        cap = (st1["decode_steps"] - st0["decode_steps"]) * eng["slots"]
        record = Record(cfg=cfg, mix=mix, spans=spans,
                        window=window if window and window.device else None,
                        extra={"decode_chunks": chunks[:window_chunks],
                               "prof_chunks": [c for c in chunks
                                               if c["profiled"]],
                               "kept_tokens": kept, "capacity": cap,
                               "decode_chunk": eng["decode_chunk"]})

    sample = _sample(tr, cell.seed, mix["check_sample"])
    wrong = sum(1 for uid in tr.done
                if len(tr.tokens[uid]) != tr.req[uid].max_new)
    del engine, tr.engine, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gap = served_gap(cell, sample, Products(tf32=False))
    numbers = {"served_gap": gap, "wrong_length": wrong, "missing": missing}
    correct, checks = check.verdict(numbers, cell.limits)
    return Outcome(correct=correct, attempted=n, failed=missing,
                   metrics={"ttft_p95_ms": stats.percentile(ttft, 95) * 1e3,
                            "tpot_p95_ms": stats.percentile(tpot, 95) * 1e3,
                            "setup_s": setup_s},
                   memory_peak_bytes=peak, checks=checks, record=record,
                   readings={"sample": sample,
                             "done_in_window": sum(
                                 1 for u, t in tr.done.items()
                                 if t <= close - t0),
                             "due": n, "ttft_s": ttft,
                             "admit_wait_s": admission_waits(tr)})


def _step(engine, tr: Tracker, t0: float, chunks, S_pad: int,
          profiling: bool = False) -> None:
    """One engine step, then the client's marks; with ``chunks`` (a
    traced run) each decode chunk's row lengths are kept too, and whether
    the profiler saw it."""
    before = engine.stats["chunks"]
    engine.step()
    finished = tr.observe(time.perf_counter() - t0)
    if chunks is None or engine.stats["chunks"] == before:
        return
    sched = engine.sched
    active = np.zeros(engine.num_slots, bool)
    for s, rec in enumerate(sched.slots):
        active[s] = rec is not None and rec.phase == "decode"
    for uid in finished:
        if uid in tr.slot:
            active[tr.slot[uid]] = True
    pos = engine.cache.pos.cpu().numpy().astype(np.int64)
    chunks.append({"lengths": chunk_lengths(pos, active,
                                            engine.decode_chunk, S_pad),
                   "profiled": profiling})


def _sample(tr: Tracker, seed: int, k: int) -> list:
    """``k`` finished requests drawn from the seed, the longest among
    them: (prompt, served tokens)."""
    done = sorted(tr.done)
    if not done:
        return []
    longest = max(done, key=lambda u: len(tr.req[u].prompt)
                  + len(tr.tokens[u]))
    rng = np.random.default_rng(derive(seed, "sample"))
    rest = [u for u in done if u != longest]
    pick = [longest] + list(rng.choice(rest, size=min(k - 1, len(rest)),
                                       replace=False)) if rest else [longest]
    return [(tr.req[u].prompt, tr.tokens[u]) for u in pick]


def served_gap(cell, sample, products) -> float:
    """The widest gap of a sampled served token below the reference's
    best logit at its position."""
    cfg, dev = cell.cfg, cell.device
    params = make_params(cell.reference.leaves(cfg), cell.seed, dev)
    gap = 0.0
    with products.active():
        for prompt, served in sample:
            p = torch.as_tensor(prompt, device=dev)
            s = torch.as_tensor(np.asarray(served).reshape(-1), device=dev)
            lg = lm.served_logits(cell.reference, params, cfg, p, s,
                                  products)
            gap = max(gap, lm.widest_gap(lg, s))
    del params
    return gap
