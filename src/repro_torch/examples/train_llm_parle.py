"""End-to-end example: Parle-train a ~60M-parameter decoder LM on the
synthetic token stream for a few hundred steps, checkpointing and
reporting the replica diagnostics.  Port of
``examples/train_llm_parle.py``: the same config (``e2e-60m``), the
same Parle settings (n=2, L=10, lr 0.05, weight decay 1e-4), the same
JSON progress lines and the checkpoint in the reference's format.

    PYTHONPATH=src python -m repro_torch.examples.train_llm_parle
    PYTHONPATH=src python -m repro_torch.examples.train_llm_parle \\
        --device cpu --steps 5

Runs on ``cuda`` unless ``--device cpu``.  Params come from a
``torch.Generator`` seeded 0 on the device, as the train CLI's do;
the port's ``TokenStream`` draws its batches on the device, so they are
not the reference's numbers (:func:`train` takes any batch source).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ModelConfig, ParleConfig
from repro_torch.core import ensemble, parle
from repro_torch.data.synthetic import TokenStream, replica_batches
from repro_torch.examples.quickstart import sync
from repro_torch.models.model import build_model
from repro_torch.runtime.precision import pin_float32
from repro_torch.utils.pytree import tree_leaves_with_paths

E2E_CONFIG = ModelConfig(
    name="e2e-60m", family="dense",
    num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
    d_ff=1536, vocab_size=32_000, head_dim=64,
    source="end-to-end example config (~60M params)",
)
WEIGHT_DECAY = 1e-4


def parle_cfg(replicas: int = 2, L: int = 10) -> ParleConfig:
    return ParleConfig(n_replicas=replicas, L=L, lr=0.05, lr_inner=0.05,
                       batches_per_epoch=50)


def make_step(model, pcfg):
    return parle.make_train_step(model.loss, pcfg, weight_decay=WEIGHT_DECAY)


def train(model, params, pcfg, batches, steps: int):
    """Parle from ``params`` for ``steps`` steps; ``batches(i)`` is step
    i's replica batch.  Prints the reference's progress lines at the
    first step and every tenth of the run.  Returns (final state, the
    per-step losses as one tensor, the progress records)."""
    state = parle.init(params, pcfg)
    step = make_step(model, pcfg)
    device = state.x.device
    losses, progress = [], []
    sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step(state, batches(i))
        losses.append(m["loss"].detach())
        if (i + 1) % max(steps // 10, 1) == 0 or i == 0:
            rec = {
                "step": i + 1, "loss": round(float(m["loss"]), 4),
                "gamma": round(float(state.scopes.gamma), 2),
                "rho": round(float(state.scopes.rho), 4),
                "overlap": round(float(ensemble.replica_overlap(state.x)),
                                 4),
                "wall_s": round(time.perf_counter() - t0, 1)}
            print(json.dumps(rec), flush=True)
            progress.append(rec)
    return state, torch.stack(losses), progress


def run(steps=200, replicas=2, batch=4, seq=128, L=10,
        checkpoint="results/e2e_parle.npz", device="cuda") -> dict:
    """The example end to end on ``E2E_CONFIG``; returns what it printed
    (``params``, ``progress``, ``checkpoint``,
    ``final_avg_model_eval_loss``) and, for a resume check, the final
    ``state``, the ``model``, the ``stream`` and the ParleConfig
    ``pcfg``."""
    pin_float32()
    device = resolve_device(device)
    cfg = E2E_CONFIG
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    nparams = sum(t.numel() for _, t in tree_leaves_with_paths(params))
    print(f"model: {cfg.name}  params={nparams/1e6:.1f}M", flush=True)

    pcfg = parle_cfg(replicas, L)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq,
                         batch_size=batch, device=str(device))
    state, losses, progress = train(
        model, params, pcfg,
        lambda i: replica_batches(stream, i, batch, replicas), steps)

    if checkpoint:
        ckpt.save(checkpoint, state, step=steps, meta={"config": cfg.name})
        print(f"checkpoint -> {checkpoint}", flush=True)

    # deployable single model = replica average (paper's end product)
    with torch.no_grad():
        eval_loss, _ = model.loss(parle.average_model(state),
                                  stream.batch(999_983))
    final = round(float(eval_loss), 4)
    print(json.dumps({"final_avg_model_eval_loss": final}), flush=True)
    return {"params": nparams, "progress": progress, "losses": losses,
            "checkpoint": checkpoint, "final_avg_model_eval_loss": final,
            "state": state, "model": model, "stream": stream, "pcfg": pcfg}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--L", type=int, default=10)
    ap.add_argument("--checkpoint", default="results/e2e_parle.npz")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (no silent fallback to the CPU)")
    args = ap.parse_args(argv)
    return run(args.steps, args.replicas, args.batch, args.seq, args.L,
               args.checkpoint, args.device)


if __name__ == "__main__":
    main()
