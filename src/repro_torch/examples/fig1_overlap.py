"""Fig. 1 / §1.2 analogue: independent training vs Parle's coupling.
Port of ``benchmarks/fig1_overlap.py``: the same seven quantities and
three ``holds=`` rules.

  * independent nets: low raw overlap; the one-shot average is near
    catastrophic; the permutation-aligned average much better (greedy
    layer matching).
  * Parle replicas: overlap ~ 1 throughout; the average model is the
    result.

    PYTHONPATH=src python -m repro_torch.examples.fig1_overlap
    PYTHONPATH=src python -m repro_torch.examples.fig1_overlap \\
        --device cpu --steps 60

Runs on ``cuda`` unless ``--device cpu``.  ``run(use_kernel=True)``
routes Parle's updates through K1 / K2.  The two independent runs are stacked
in ``FlatLayout``'s flat form, as a Parle state holds its replicas, for
``replica_overlap``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import ensemble, parle
from repro_torch.examples.common import (errors, make_task, train_parle,
                                         train_sgd)
from repro_torch.runtime.precision import pin_float32
from repro_torch.utils.pytree import FlatLayout


def run(steps: int = 400, seed: int = 0, device="cuda",
        use_kernel=False) -> dict:
    task = make_task(seed, device)
    # two independent runs
    p0, _ = train_sgd(task, steps, seed=0)
    p1, _ = train_sgd(task, steps, seed=1)
    stacked = {k: torch.stack([p0[k], p1[k]]) for k in p0}
    raw_overlap = float(ensemble.replica_overlap(
        FlatLayout(p0).flatten(stacked, lead=(2,))))
    naive_avg = ensemble.one_shot_average(stacked)
    err_naive, _ = errors(naive_avg, task)
    err_single, _ = errors(p0, task)

    aligned_ov = ensemble.aligned_overlap(p0, p1)
    aligned = ensemble.align_mlp(p0, p1)
    aligned_avg = {k: (p0[k] + aligned[k]) / 2 for k in p0}
    err_aligned, _ = errors(aligned_avg, task)

    pst, _ = train_parle(task, 2, steps, seed=0, use_kernel=use_kernel)
    parle_overlap = float(ensemble.replica_overlap(pst.x))
    err_parle, _ = errors(parle.average_model(pst), task)

    return {
        "independent_raw_overlap": raw_overlap,
        "independent_aligned_overlap": aligned_ov,
        "err_single": err_single,
        "err_one_shot_avg": err_naive,
        "err_aligned_avg": err_aligned,
        "parle_overlap": parle_overlap,
        "err_parle_avg": err_parle,
    }


def report(r: dict) -> list:
    """The reference's output lines for :func:`run`'s result."""
    out = []
    for k, v in r.items():
        out.append(f"fig1_{k},0,{v:.4f}")
    # claims: one-shot averaging catastrophic; aligned less so; parle best
    out.append(f"fig1_claim_oneshot_catastrophic,0,"
               f"holds={r['err_one_shot_avg'] > r['err_single'] + 0.05}")
    out.append(f"fig1_claim_alignment_helps,0,"
               f"holds={r['err_aligned_avg'] < r['err_one_shot_avg']}")
    out.append(f"fig1_claim_parle_average_works,0,"
               f"holds={r['err_parle_avg'] < r['err_one_shot_avg']}")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (no silent fallback to the CPU)")
    args = ap.parse_args(argv)
    pin_float32()
    out = report(run(steps=args.steps, device=args.device))
    for line in out:
        print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
