"""Serving CLI — a thin command line over the continuous-batching engine
(``repro_torch/serving/``).  Port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --paged --paged-kernel --slots 4 --requests 8 --prompt-len 64 \\
        --mixed-lens --arrive-every 2 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --device cpu --naive
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --smoke --device cpu --paged

What gets served is the registry surface, as in the reference:
``--algo`` resolves an Algorithm, the state is ``--resume``'d from a
training checkpoint of either package (algo-stamp validated) or fresh
from params drawn with a ``torch.Generator`` seeded by ``--seed``, and
the served weights are ``algo.deployable(state)`` — for Parle, the
replica average; for Elastic-SGD, the reference variable ``ref``; for
SGD, its ``params``.  A fresh Parle state's replicas all equal the init,
so its average is taken over the init broadcast to ``--replicas`` rows
without building the n-replica state; a fresh Elastic-SGD ``ref`` and a
fresh SGD ``params`` are the init itself.  Prompts are the reference's:
step 0 of the token stream (``TokenStream(vocab, max(lens), requests,
--seed, K).batch(0)``, threefry, ``data/threefry.py``), each request
its row cut to its length, so both packages serve the same prompts.  A
vlm request's patch embeddings and an audio request's conditioning
frames are float draws (``jax.random.normal`` in the reference, which
the port does not reproduce): they come from a numpy generator seeded
by ``(--seed, 1)``, never a stream of the prompts or the params.  Audio
prompts are (K, T) over the config's codebooks.

Modes:

* default — the engine: ``--slots``-wide continuous batching, mixed
  prompt lengths (``--mixed-lens``), staggered arrivals
  (``--arrive-every``), greedy or ``--temperature``/``--top-k``.  On
  CUDA it replays CUDA graphs: one of its decode chunk, and one of its
  prefill a prompt bucket (dense) or of its prefill chunk (paged); the
  ``serve_summary``'s ``compile_s`` is those graphs' capture.
* ``--naive`` — the one-request-at-a-time reference loop (first token
  from the prefill logits; measured after a warm-up pass).
* ``--paged`` — the paged KV cache: ``--page-size`` token pages behind
  per-slot page tables, ``--prefill-chunk``-token chunked prefill
  interleaved with decode, hash-matched prefix sharing, and
  page-exhaustion backpressure (``--num-pages`` bounds the pool).
  ``--paged-kernel`` decodes through the CUDA paged-attention kernel.

Runs on ``cuda`` unless ``--device cpu``; wall times end on a device
synchronisation.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ParleConfig, get_config, smoke_variant
from repro_torch.core import parle, registry
from repro_torch.data.synthetic import TokenStream
from repro_torch.models.model import build_model, cache_positions
from repro_torch.obs import Obs
from repro_torch.runtime.precision import pin_float32
from repro_torch.serving import (Engine, SamplingParams, make_naive_fns,
                                 naive_generate)
from repro_torch.utils.pytree import FlatLayout


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_lengths(args):
    if not args.mixed_lens:
        return [args.prompt_len] * args.requests
    # a deterministic spread around --prompt-len (at least 4 tokens)
    base = args.prompt_len
    return [max(4, base - 1 + (3 * i) % (base // 2 + 2))
            for i in range(args.requests)]


def make_requests(cfg, args):
    """Per-request prompts from step 0 of the token stream (the
    reference's ``_make_requests``), plus the vlm / audio conditioning
    from ``default_rng((--seed, 1))`` (standard normal, float32)."""
    lens = prompt_lengths(args)
    toks = TokenStream(vocab_size=cfg.vocab_size, seq_len=max(lens),
                       batch_size=args.requests, seed=args.seed,
                       num_codebooks=cfg.num_codebooks).batch(0)[
        "tokens"].numpy()
    cond_rng = np.random.default_rng((args.seed, 1))
    out = []
    for i, T in enumerate(lens):
        req = {"tokens": toks[i, ..., :T]}
        if cfg.family == "vlm":
            req["patch_embeds"] = cond_rng.standard_normal(
                (cfg.num_patches, cfg.d_model), dtype=np.float32)
        if cfg.family == "audio":
            req["cond"] = cond_rng.standard_normal(
                (cfg.cond_len, cfg.d_model), dtype=np.float32)
        out.append(req)
    return out


def _max_len(requests, args) -> int:
    """Cache positions a request can reach: its conditioning frames, its
    prompt and ``--gen`` new tokens."""
    return max(len(r.get("cond", ())) + r["tokens"].shape[-1]
               for r in requests) + args.gen


def init_params(cfg, args, device):
    """Fresh params on ``device`` from ``torch.Generator`` seed --seed."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return build_model(cfg).init(gen)


def served_params(cfg, args, device):
    """``algo.deployable(state)`` of the ``--resume``'d state, or of a
    fresh one over :func:`init_params`.  Returns (params, ParleConfig)."""
    params = init_params(cfg, args, device)
    algo = registry.get(args.algo)
    pcfg = algo.canonicalize_cfg(ParleConfig(n_replicas=args.replicas))
    if args.resume:
        state = ckpt.restore(args.resume, algo.init(params, pcfg),
                             algo=args.algo)
        return algo.deployable(state), pcfg
    if algo.name not in ("parle", "entropy_sgd"):
        return params, pcfg         # Elastic-SGD's ref, SGD's params
    layout = FlatLayout(params)
    x = layout.flatten(params).expand(pcfg.n_replicas, -1)
    return layout.tree(parle.replica_mean(x)), pcfg


def naive_serve(cfg, params, requests, args, obs, device):
    """One request at a time, batch=1 — the engine's oracle.  The first
    pass is a warm-up; the second, device-synced, is reported."""
    fns = make_naive_fns(cfg, SamplingParams(args.temperature, args.top_k))
    model = build_model(cfg)
    max_len = _max_len(requests, args)

    def one_pass():
        outs, pos = [], []
        t0 = time.perf_counter()
        for i, r in enumerate(requests):
            batch = {k: torch.as_tensor(v, device=device)[None]
                     for k, v in r.items()}
            cache = model.init_cache(params, 1, max_len)
            gen = torch.Generator(device=device).manual_seed(args.seed + 1 + i)
            toks, cache = naive_generate(fns, params, batch, cache, args.gen,
                                         generator=gen)
            outs.append(toks[0].cpu().numpy())
            pos.append(int(cache_positions(cache)))
        _sync(device)
        return outs, pos, time.perf_counter() - t0

    _, _, cold_s = one_pass()            # warm-up
    outs, pos, warm_s = one_pass()       # steady state
    gen_total = sum(o.size for o in outs)
    rep = obs.emit(
        "serve_summary", phase="naive", requests=len(requests),
        new_tokens=int(gen_total), warmup_s=round(cold_s, 3),
        wall_s=round(warm_s, 3),
        tokens_per_s=round(gen_total / max(warm_s, 1e-9), 1),
        cache_positions=pos, sample=outs[0].reshape(-1)[:8].tolist())
    print(json.dumps(rep), flush=True)
    return outs, rep


def make_engine(cfg, params, requests, args, obs, device, graphs=True):
    return Engine(cfg, params, num_slots=args.slots,
                  max_len=_max_len(requests, args),
                  decode_chunk=args.decode_chunk,
                  sampling=SamplingParams(args.temperature, args.top_k),
                  seed=args.seed, paged=args.paged,
                  page_size=args.page_size,
                  num_pages=args.num_pages if args.num_pages > 0 else None,
                  prefill_chunk=args.prefill_chunk,
                  use_paged_kernel=args.paged_kernel,
                  registry=obs.registry, tracer=obs.tracer, device=device,
                  graphs=graphs)


def submit_requests(engine, requests, args):
    """Queue every request, each slot-sized wave ``--arrive-every`` engine
    steps after the one before."""
    for i, r in enumerate(requests):
        engine.submit(r["tokens"], max_new_tokens=args.gen,
                      eos_id=args.eos_id if args.eos_id >= 0 else None,
                      arrival=(i // max(args.slots, 1)) * args.arrive_every,
                      cond=r.get("cond"), patch_embeds=r.get("patch_embeds"))


def engine_serve(cfg, params, requests, args, obs, device, graphs=True):
    """Serve ``requests`` through one engine.  Returns (results {uid:
    tokens}, engine, the printed ``serve_summary`` record, whose
    ``compile_s`` is the capture of the engine's CUDA graphs: its decode
    chunk and its prefills).  ``graphs=False`` prefills and decodes
    eagerly on CUDA too (the engine's keyword; the CLI has no flag)."""
    engine = make_engine(cfg, params, requests, args, obs, device, graphs)
    submit_requests(engine, requests, args)
    t0 = time.perf_counter()
    results = engine.run()
    _sync(device)
    wall = time.perf_counter() - t0
    gen_total = sum(int(np.asarray(t).size) for t in results.values())
    rep = engine.throughput()
    rep.update({
        "phase": "engine", "requests": len(requests), "slots": args.slots,
        "decode_chunk": args.decode_chunk, "new_tokens": gen_total,
        "wall_s": round(wall, 3), "device": str(device),
        "sample": np.asarray(results[0]).reshape(-1)[:8].tolist(),
    })
    if args.paged:
        rep.update({"paged": True, "paged_kernel": args.paged_kernel,
                    "page_size": args.page_size,
                    "num_pages": engine.num_pages,
                    "prefill_chunk": engine.prefill_chunk_len})
    rep = obs.emit("serve_summary", **rep)
    print(json.dumps(rep), flush=True)
    return results, engine, rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to serve (no silent fallback to the CPU)")
    ap.add_argument("--algo", default="parle", choices=registry.names())
    ap.add_argument("--replicas", type=int, default=3,
                    help="replica count of the (fresh or restored) state")
    ap.add_argument("--resume", default="",
                    help="training checkpoint to serve (validated "
                         "against --algo's stamp)")
    ap.add_argument("--requests", "--batch", dest="requests", type=int,
                    default=4, help="number of requests to serve")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-batch width of the engine")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps per engine step")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--mixed-lens", action="store_true",
                    help="vary prompt lengths across requests")
    ap.add_argument("--arrive-every", type=int, default=0,
                    help="stagger arrivals: each slot-sized wave of "
                         "requests arrives this many engine steps apart")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop a request early on this token (-1: off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--naive", action="store_true",
                    help="the one-request-at-a-time reference loop")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: page-pool layout, chunked "
                         "prefill, prefix sharing, backpressure")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="paged decode attention through the CUDA kernel "
                         "(needs --paged)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size incl. the trash page "
                         "(0: slots * ceil(max_len/page_size) + 1)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens prefilled per engine step "
                         "(paged mode; interleaves with decode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="",
                    help="write schema-versioned metrics/event JSONL here")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON (prefill / decode "
                         "spans) here")
    args = ap.parse_args(argv)
    if args.paged_kernel and not args.paged:
        ap.error("--paged-kernel needs --paged")
    return args


def main(argv=None):
    pin_float32()
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    params, pcfg = served_params(cfg, args, device)
    print(json.dumps({"serving": args.algo, "arch": cfg.name,
                      "mode": "naive" if args.naive else "engine",
                      "replicas": pcfg.n_replicas,
                      "restored": bool(args.resume),
                      "device": str(device)}), flush=True)

    obs = Obs(args.metrics_out, args.trace_out, process_name="serve")
    requests = make_requests(cfg, args)
    if args.naive:
        naive_serve(cfg, params, requests, args, obs, device)
    else:
        engine_serve(cfg, params, requests, args, obs, device)
    obs.finalize()


if __name__ == "__main__":
    main()
