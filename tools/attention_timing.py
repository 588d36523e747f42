#!/usr/bin/env python3
"""Time the port's attention kernels, K3 (flash attention) and K8 (paged
decode attention), and its SSD scan K9, from the source tree named by
``--src``, on one CUDA card, beside SDPA on the same inputs for K3 and K8.

    python3 tools/attention_timing.py --src src
    python3 tools/attention_timing.py --src path/to/another/checkout/src

Two versions of the kernels are compared on one card by running this
script once per tree in one command, in turns (A, B, B, A).  The inputs
and the timing are those of ``chip_smoke.py`` (CUDA events around each
launch, the L2 cache flushed before each one, a spin kernel holding the
card while the host enqueues, the median): K3 at the Qwen2.5-3B prefill
shape (B 2, T 2048, H 16, hd 128) in float32, K8 at the serve path's
shape (4 rows of 63-116 positions) and at long context (4 rows of
4096-16384 positions), Qwen2.5-3B's decode geometry (H 16, KV 2, hd 128,
page size 16), K9 at the Mamba2-1.3B shape (B 2, T 2048, 64 heads of 64,
state 128, chunk 128) in float32 and bf16, each against its plain
version once.  Prints one JSON line with the card's name and power
limit.  Exits 2 without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

L2_FLUSH_BYTES = 64 * 2 ** 20    # > the 50 MB L2
SPIN_CYCLES = 100_000_000
K3_SHAPE = (2, 2048, 16, 128)
K8_SHAPES = {
    "serve": dict(B=4, P=33, H=16, KV=2, hd=128, ps=16, M=8,
                  lengths=[63, 80, 99, 116]),
    "long_context": dict(B=4, P=4 * 1024 + 1, H=16, KV=2, hd=128, ps=16,
                         M=1024, lengths=[4096, 8192, 12288, 16384]),
}
K9_SHAPE = (2, 2048, 64, 64, 128, 128)   # Mamba2-1.3B: B, T, nh, P, N, Q


def time_ms(fn, device, iters, warmup=3):
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize(device)
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def paged_inputs(seed, B, P, H, KV, hd, ps, M, lengths, device):
    """chip_smoke.py's K8 inputs: random q and pools, distinct random
    pages a row, the trash page 0 past each row's live extent."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen)
    k_pool = torch.randn((P, ps, KV, hd), generator=gen)
    v_pool = torch.randn((P, ps, KV, hd), generator=gen)
    pages = torch.randperm(P - 1, generator=gen) + 1
    table = torch.zeros((B, M), dtype=torch.int32)
    for b, n in enumerate(lengths):
        live = -(-n // ps)
        take = pages[(b * M) % (P - 1):][:live]
        if len(take) < live:
            take = torch.cat([take, pages[:live - len(take)]])
        table[b, :live] = take
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (q, k_pool, v_pool, table, lengths)]


def time_k3(fa, device):
    B, T, H, hd = K3_SHAPE
    gen = torch.Generator(device=device).manual_seed(99)
    q, k, v = (torch.randn((B, T, H, hd), generator=gen, device=device)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    err = (fa.flash_attention_cuda(q, k, v)
           - fa.flash_attention_plain(q, k, v)).abs().max().item()
    return {"ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v), device,
                          30),
            "sdpa_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), device, 30),
            "max_abs_err": err}


def time_k8(pa, shape, device):
    args = paged_inputs(98, device=device, **shape)
    q, k_pool, v_pool, table, lengths = args
    B, H, hd, KV = shape["B"], shape["H"], shape["hd"], shape["KV"]
    S = shape["M"] * shape["ps"]
    err = (pa.paged_attention_cuda(*args)
           - pa.paged_attention_plain(*args)).abs().max().item()
    kk, vv = (pool[table].reshape(B, S, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
        for pool in (k_pool, v_pool))
    mask = (torch.arange(S, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    live = sum(shape["lengths"])
    n_bytes = (2 * live * KV * hd * 4 + 2 * q.numel() * 4
               + table.numel() * 4 + lengths.numel() * 4)
    return {"ms": time_ms(lambda: pa.paged_attention_cuda(*args), device,
                          50),
            "sdpa_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask), device, 20),
            "bound_ms": n_bytes / 3.35e12 * 1e3, "max_abs_err": err}


def time_k9(ssd, dtype, device):
    """chip_smoke.py's K9 timing inputs (seed 98) in ``dtype``."""
    B, T, nh, P, N, Q = K9_SHAPE
    gen = torch.Generator(device=device).manual_seed(98)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, dt = r(B, T, nh, P) * 0.5, torch.nn.functional.softplus(r(B, T, nh))
    A = -torch.exp(r(nh) * 0.3)
    Bm, Cm = r(B, T, N) * 0.5, r(B, T, N) * 0.5
    args = [t.to(dtype) for t in (x, dt)] + [A] + [
        t.to(dtype) for t in (Bm, Cm)]
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(
        ssd.ssd_scan_cuda(*args, Q), ssd.ssd_scan_plain(*args)))
    return {"ms": time_ms(lambda: ssd.ssd_scan_cuda(*args, Q), device, 20),
            "max_abs_err": err}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="the src/ directory holding repro_torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssd_scan as ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    out = {"src": args.src, "card": smi,
           "flash_attention": time_k3(fa, device)}
    for name, shape in K8_SHAPES.items():
        out[f"paged_attention_{name}"] = time_k8(pa, shape, device)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        out[f"ssd_scan_{name}"] = time_k9(ssd, dtype, device)
    out["script_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
