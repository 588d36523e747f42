#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc`` (``$CUDA_HOME/bin`` or PATH).  It puts ``src`` on ``sys.path``
itself and, in order:

1. prints the card (``nvidia-smi`` name and power limit, and torch's name);
2. builds every CUDA kernel from ``src/repro_torch/csrc`` and prints the
   build time and ``nvcc -Xptxas -v``'s register / shared-memory report;
3. holds each kernel against its plain PyTorch version on the card,
   within atol = rtol = 2e-5, at the unit-test shapes, a shared-pages
   case, a length-1 case and the main path's shapes;
4. times the kernel, its plain version and one PyTorch library call at
   the main path's shapes (CUDA events, L2 flushed before every launch)
   beside the least time the card could take;
5. serves the main path through the port's serve CLI functions:
   full-width Qwen2.5-3B in float32 (random params, torch.Generator
   seed 0), the paged engine decoding through the K8 kernel, 8 requests
   of 63-84 prompt tokens, 32 greedy tokens each; asserts every request
   got its tokens, that K8 launched exactly num_layers x decode steps,
   and that the tokens equal the gather path's (no kernel) on the card;
   then serves it once more under ``torch.profiler`` for the device's
   busy share and the kernels that take its time;
6. prints one JSON line of per-kernel numbers, then, last, the device
   line ``{"ok": true, "device": {...}}``.

Nothing is caught: a failing phase exits non-zero and prints no device
line.  Without a CUDA card it exits 2 before doing anything.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM float32, outside tensor cores
L2_FLUSH_BYTES = 64 * 2 ** 20    # > the 50 MB L2
SPIN_CYCLES = 100_000_000        # ~50 ms of a ~2 GHz SM clock


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def paged_inputs(seed, B, P, H, KV, hd, ps, M, lengths, device):
    """Random q and pools; row b gets distinct random pages, and table
    entries past its live extent name the trash page 0."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen)
    k_pool = torch.randn((P, ps, KV, hd), generator=gen)
    v_pool = torch.randn((P, ps, KV, hd), generator=gen)
    pages = torch.randperm(P - 1, generator=gen) + 1
    table = torch.zeros((B, M), dtype=torch.int32)
    for b, n in enumerate(lengths):
        live = -(-n // ps)
        take = pages[(b * M) % (P - 1):][:live]
        if len(take) < live:                      # wrap around the pool
            take = torch.cat([take, pages[:live - len(take)]])
        table[b, :live] = take
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (q, k_pool, v_pool, table, lengths)]


def time_ms(fn, device, iters=50, warmup=10):
    """Median device time of ``fn`` in ms: CUDA events around each
    launch, the L2 cache flushed before each one (the serve path reads a
    layer's pool cold: every other layer's weights pass in between).  A
    spin kernel holds the card while the host enqueues every iteration,
    so the events time the card's work and not the host's launch rate."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2], enqueue_ms


CASES = {
    "unit_test": dict(B=3, P=12, H=4, KV=2, hd=32, ps=16, M=4,
                      lengths=[1, 64, 56]),
    "shared_pages": None,
    "length_1": dict(B=4, P=12, H=4, KV=2, hd=32, ps=16, M=4,
                     lengths=[1, 1, 1, 1]),
    "main_path": dict(B=4, P=33, H=16, KV=2, hd=128, ps=16, M=8,
                      lengths=[63, 80, 99, 116]),
}
SERVE_ARGV = ["--arch", "qwen2.5-3b", "--device", "cuda", "--paged",
              "--slots", "4", "--page-size", "16", "--prefill-chunk", "32",
              "--decode-chunk", "8", "--requests", "8", "--prompt-len", "64",
              "--mixed-lens", "--arrive-every", "2", "--gen", "32",
              "--seed", "0"]


def device_phase():
    phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return device, kind


def build_phase():
    phase("2. kernel build")
    lib = build.load("paged_attention.cu")
    print(f"paged_attention.cu -> {lib.path.name}: nvcc {lib.build_s:.2f} s "
          f"({' '.join(build.NVCC_FLAGS)})")
    print(lib.report.strip() or "(loaded from an earlier build)", flush=True)


def check_phase(device) -> float:
    """K8 against its plain version at every case; returns the largest
    absolute error seen."""
    phase("3. K8 against its plain version")
    max_abs_err = 0.0
    for i, (name, shape) in enumerate(CASES.items()):
        if shape is None:   # two rows naming the same pages: equal rows
            q, k_pool, v_pool, _, _ = paged_inputs(
                10 + i, B=1, P=8, H=4, KV=2, hd=32, ps=8, M=3,
                lengths=[16], device=device)
            args = [torch.cat([q, q]), k_pool, v_pool,
                    torch.tensor([[3, 5, 1], [3, 5, 2]], dtype=torch.int32,
                                 device=device),
                    torch.tensor([16, 16], dtype=torch.int32, device=device)]
        else:
            args = paged_inputs(10 + i, device=device, **shape)
        got = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize(device)
        want = pa.paged_attention_plain(*args)
        err = (got - want).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        print(f"{name}: q {tuple(args[0].shape)} pool "
              f"{tuple(args[1].shape)} lengths {args[4].tolist()} "
              f"max_abs_err {err:.3e}", flush=True)
        check(torch.allclose(got, want, **TOL),
              f"K8 disagrees with its plain version on {name} ({err:.3e})")
        if shape is None:
            check(torch.equal(got[0], got[1]),
                  "K8 rows over shared pages are not bitwise equal")
    return max_abs_err


def timing_phase(device) -> dict:
    """Kernel, plain and library times at the main path's shapes, and
    the least time the card could take for the same work."""
    phase("4. K8 timing at the main path's shapes")
    shape = CASES["main_path"]
    args = paged_inputs(99, device=device, **shape)
    q, k_pool, v_pool, table, lengths = args
    B, H, hd, KV = shape["B"], shape["H"], shape["hd"], shape["KV"]
    S = shape["M"] * shape["ps"]
    live = sum(shape["lengths"])
    # each live K/V position read once, q read and the output written once
    n_bytes = (2 * live * KV * hd * 4 + 2 * q.numel() * 4
               + table.numel() * 4 + lengths.numel() * 4)
    n_flops = 4 * live * H * hd
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / F32_FLOP_PER_S * 1e3
    kk = k_pool[table].reshape(B, S, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
    vv = v_pool[table].reshape(B, S, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qq = q[:, :, None, :]

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mask)

    lib_err = (library()[:, :, 0] - pa.paged_attention_plain(*args)
               ).abs().max().item()
    timing, enqueue = {}, {}
    for key, fn in (("ms", lambda: pa.paged_attention_cuda(*args)),
                    ("plain_ms", lambda: pa.paged_attention_plain(*args)),
                    ("library_ms", library)):
        timing[key], enqueue[key] = time_ms(fn, device)
    timing.update(bound_ms=max(bytes_ms, ops_ms),
                  bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(json.dumps({"kernel": "paged_attention", **timing,
                      "live_positions": live, "bytes": n_bytes,
                      "flops": n_flops,
                      "library_call": "F.scaled_dot_product_attention over "
                                      "the pre-gathered extent",
                      "library_max_abs_err": lib_err,
                      "host_enqueue_ms_per_50": enqueue}), flush=True)
    return timing


def main_path_phase(device) -> dict:
    """Serve the main path through K8, then the gather path on the same
    params; returns the K8 launch count and the two reports."""
    phase("5. main path: full-width qwen2.5-3b, paged engine through K8")
    args_k = serve.parse_args(SERVE_ARGV + ["--paged-kernel"])
    cfg = get_config(args_k.arch)
    t0 = time.perf_counter()
    params = serve.init_params(cfg, args_k, device)
    torch.cuda.synchronize(device)
    print(f"params: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B "
          f"f32 on {device}, init {time.perf_counter() - t0:.2f} s",
          flush=True)
    requests = serve.make_requests(cfg, args_k)
    print("prompt lengths:", [len(r["tokens"]) for r in requests])

    torch.cuda.reset_peak_memory_stats(device)
    pa.launches = 0
    res_k, engine, rep_k = serve.engine_serve(cfg, params, requests, args_k,
                                              Obs(), device)
    k8_launches = pa.launches
    peak = torch.cuda.max_memory_allocated(device)
    steps = engine.stats["decode_steps"]
    print(f"K8 launches {k8_launches} = {cfg.num_layers} layers x "
          f"{steps} decode steps; peak memory {peak / 2 ** 30:.3f} GiB",
          flush=True)
    check(sorted(res_k) == list(range(len(requests))), "requests missing")
    for uid, toks in res_k.items():
        check(toks.shape == (args_k.gen,),
              f"request {uid} returned {toks.shape} tokens")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"request {uid} returned token ids outside the vocabulary")
    check(k8_launches == cfg.num_layers * steps,
          f"K8 launched {k8_launches} times, expected "
          f"{cfg.num_layers} x {steps}")
    del engine
    torch.cuda.empty_cache()

    # reference on the card: the gather path (no kernel), same params
    res_g, engine, rep_g = serve.engine_serve(
        cfg, params, requests, serve.parse_args(SERVE_ARGV), Obs(), device)
    check(pa.launches == k8_launches, "the gather path launched K8")
    for uid in res_k:
        check(bool((res_k[uid] == res_g[uid]).all()),
              f"request {uid}: kernel tokens {res_k[uid].tolist()} != "
              f"gather-path tokens {res_g[uid].tolist()}")
    print(f"gather path: same tokens for all {len(res_g)} requests",
          flush=True)
    # the first token of request 0 is the argmax of a plain full forward
    prompt = torch.as_tensor(requests[0]["tokens"], device=device)[None]
    logits, _ = tfm.forward(params, cfg, prompt)
    check(logits.shape == (1, prompt.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "forward logits not finite")
    check(int(logits[0, -1].argmax()) == int(res_k[0][0]),
          "request 0's first token is not the argmax of the forward logits")
    del engine, logits
    torch.cuda.empty_cache()
    profile = profile_phase(device, cfg, params, requests, args_k)
    del params
    torch.cuda.empty_cache()
    return {"launches": k8_launches, "decode_steps": steps,
            "peak_memory_gib": round(peak / 2 ** 30, 3),
            "paged_kernel": rep_k, "gather": rep_g, "profile": profile}


def profile_phase(device, cfg, params, requests, args) -> dict:
    """Where the time goes: the K8 main path once more under
    torch.profiler — device busy time against the wall clock, and the
    kernels that take it.  The profiler slows the host side, so the
    idle share is also given against the unprofiled run's wall."""
    phase("5b. main path under torch.profiler")
    # device activity only: with host-op events too, processing the trace
    # of this run took minutes, and busy time needs none of them
    acts = [torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        _, engine, rep = serve.engine_serve(cfg, params, requests, args,
                                            Obs(), device)
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    check(busy_s > 0 and any("paged_attention" in k for _, k, _ in rows),
          "the profiler saw no device time or no K8 launch")
    out = {"profiled_wall_s": rep["wall_s"], "device_busy_s": busy_s,
           "profile_phase_s": round(time.perf_counter() - t0, 1),
           "decode_steps": engine.stats["decode_steps"],
           "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                            "calls": n} for us, k, n in rows[:8]]}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    device, kind = device_phase()
    build_phase()
    max_abs_err = check_phase(device)
    timing = timing_phase(device)
    run = main_path_phase(device)

    phase("6. summary")
    keys = ("decode_tokens_per_s", "prefill_tokens_per_s", "slot_utilization",
            "itl_ms", "ttft_ms", "wall_s")
    print(json.dumps({
        "throughput": {mode: {k: run[mode][k] for k in keys}
                       for mode in ("paged_kernel", "gather")},
        "peak_memory_gib": run["peak_memory_gib"],
        "decode_steps": run["decode_steps"],
        "device_busy_share": round(run["profile"]["device_busy_s"]
                                   / run["paged_kernel"]["wall_s"], 4),
        "total_s": round(time.perf_counter() - t_start, 1)}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:81",
        "launches": run["launches"], "max_abs_err": max_abs_err,
        "ms": timing["ms"], "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "library_ms": timing["library_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
