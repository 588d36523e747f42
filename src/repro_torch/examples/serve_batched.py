"""Batched serving example: prefill a batch of prompts on an assigned
architecture (reduced variant) and greedy-decode continuations.  Works
for any --arch, including the SSM (constant-state decode) and the
windowed dense variants.  Port of ``examples/serve_batched.py``.

The loop follows the decode-path contract (``repro_torch/serving``):
the first generated token comes from the PREFILL logits and the cache
advances by exactly one position per decode.  tokens/s is measured on a
second (warm) pass, each pass timed between two device
synchronizations; "compile" is the cold pass minus the warm one (in
eager PyTorch: cuBLAS handles, the caching allocator's first blocks).
For continuous batching over mixed-length, staggered requests use
``python -m repro_torch.launch.serve`` instead.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch llama3-8b --window 64 --device cpu

Runs on ``cuda`` unless ``--device cpu``.  Params come from a
``torch.Generator`` seeded 0 on the device; the vlm ``patch_embeds`` and
audio ``cond`` inputs from a second one, seeded 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data.synthetic import TokenStream
from repro_torch.examples.quickstart import sync
from repro_torch.models.model import build_model, cache_positions
from repro_torch.runtime.precision import pin_float32
from repro_torch.serving import make_naive_fns, naive_generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding window (sub-quadratic attention variant)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to serve (no silent fallback to the CPU)")
    args = ap.parse_args(argv)
    pin_float32()
    device = resolve_device(args.device)

    cfg = smoke_variant(get_config(args.arch))
    if args.window:
        cfg = dataclasses.replace(cfg, sliding_window=args.window)
    model = build_model(cfg)
    # independent streams: params init vs conditioning inputs
    params = model.init(torch.Generator(device=device).manual_seed(0))
    gen_cond = torch.Generator(device=device).manual_seed(1)

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.prompt_len,
                         batch_size=args.batch, device=str(device),
                         num_codebooks=cfg.num_codebooks)
    batch = stream.batch(0)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            (args.batch, cfg.num_patches, cfg.d_model), generator=gen_cond,
            device=device)
    if cfg.family == "audio":
        batch["cond"] = torch.randn(
            (args.batch, cfg.cond_len, cfg.d_model), generator=gen_cond,
            device=device)

    fns = make_naive_fns(cfg)
    max_len = args.prompt_len + args.gen

    def one_pass():
        cache = model.init_cache(params, args.batch, max_len)
        sync(device)
        t0 = time.perf_counter()
        with torch.no_grad():
            gen, cache = naive_generate(fns, params, batch, cache, args.gen)
        sync(device)
        return gen, cache, time.perf_counter() - t0

    _, _, cold_s = one_pass()          # warm-up
    gen, cache, warm_s = one_pass()    # steady state
    pos = int(cache_positions(cache))
    assert pos == args.prompt_len + args.gen - 1, pos
    n = gen.numel()
    sample = gen.reshape(-1)[:12].tolist()
    print(f"decoded {n} tokens in {warm_s:.3f}s "
          f"({n / warm_s:.1f} tok/s; compile {cold_s - warm_s:.2f}s; "
          f"family={cfg.family})")
    print("sample:", sample, flush=True)
    return {"tokens": n, "warm_s": warm_s, "cold_s": cold_s,
            "tokens_per_s": n / warm_s, "compile_s": cold_s - warm_s,
            "family": cfg.family, "cache_position": pos, "sample": sample}


if __name__ == "__main__":
    main()
