"""Table 1 analogue: Parle vs Elastic-SGD vs Entropy-SGD vs SGD —
validation error and wall-clock at a matched per-replica step budget,
plus the §4.5 train-error comparison (Parle under-fits).  Port of
``benchmarks/table1_baselines.py``: the same rows under the same names
and ``holds=`` rules.

    PYTHONPATH=src python -m repro_torch.examples.table1_baselines
    PYTHONPATH=src python -m repro_torch.examples.table1_baselines \\
        --device cpu --steps 60

Runs on ``cuda`` unless ``--device cpu``.  ``use_kernel=True`` (of
:func:`run`, :func:`run_one`, :func:`trained`) routes the updates through
K1 / K2 (Parle, Entropy-SGD) and K7 (Elastic-SGD); the command line runs
the plain path, as the reference's harness does.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.examples.common import (deployable, errors, make_task,
                                         train_algo)
from repro_torch.runtime.precision import pin_float32

# (name, replica count) — None means "the table's n"; the single-model
# baselines (SGD, Entropy-SGD) stay at 1 as in the paper's Table 1
ALGOS = (("sgd", 1), ("entropy_sgd", 1), ("elastic_sgd", None),
         ("parle", None))


def trained(steps: int, n: int, seed: int, device="cuda",
            use_kernel=False):
    """Yields (name, deployable params, wall_s, task) for each of ALGOS in
    turn; nothing of the next algorithm runs before the caller asks."""
    task = make_task(seed, device)
    for name, algo_n in ALGOS:
        st, wall = train_algo(name, task, steps, n=algo_n or n, seed=seed,
                              use_kernel=use_kernel)
        yield name, deployable(name, st), wall, task


def run_one(steps: int, n: int, seed: int, device="cuda", use_kernel=False):
    """[(name, test error, train error, wall_s)] in ALGOS order."""
    return [(name,) + errors(params, task) + (wall,)
            for name, params, wall, task in trained(steps, n, seed, device,
                                                    use_kernel)]


def summarize(per_seed) -> list:
    """Paper methodology: mean +- std over random-init runs (§4).
    ``per_seed``: one :func:`run_one` result a seed.  Returns [(name,
    test mean, test std, train mean, mean wall_s)]."""
    acc = {}
    for rows in per_seed:
        for name, te, tr, wall in rows:
            acc.setdefault(name, []).append((te, tr, wall))
    rows = []
    for name, vals in acc.items():
        te = np.array([v[0] for v in vals])
        tr = np.array([v[1] for v in vals])
        w = np.mean([v[2] for v in vals])
        rows.append((name, te.mean(), te.std(), tr.mean(), w))
    return rows


def run(steps: int = 600, n: int = 3, seeds=(0, 1, 2), device="cuda",
        use_kernel=False):
    return summarize([run_one(steps, n, seed, device, use_kernel)
                      for seed in seeds])


def report(rows, steps: int) -> list:
    """The reference's output lines for :func:`run`'s rows."""
    out = []
    d = {r[0]: r for r in rows}
    for name, te, std, tr, wall in rows:
        out.append(f"table1_{name},{wall*1e6/steps:.0f},"
                   f"test_err={te:.4f}+-{std:.4f};train_err={tr:.4f}")
    best_baseline = min(d[k][1] for k in d if k != "parle")
    out.append(f"table1_claim_parle_best,0,"
               f"parle={d['parle'][1]:.4f};best_baseline={best_baseline:.4f};"
               f"holds={d['parle'][1] <= best_baseline + d['parle'][2]}")
    out.append(f"table1_claim_underfit,0,"
               f"parle_train={d['parle'][3]:.4f};sgd_train={d['sgd'][3]:.4f};"
               f"holds={d['parle'][3] >= d['sgd'][3] - 0.005}")
    out.append(f"table1_claim_parle_beats_sgd,0,"
               f"parle={d['parle'][1]:.4f};sgd={d['sgd'][1]:.4f};"
               f"holds={d['parle'][1] <= d['sgd'][1] + d['parle'][2]}")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (no silent fallback to the CPU)")
    args = ap.parse_args(argv)
    pin_float32()
    out = report(run(steps=args.steps, device=args.device), args.steps)
    for line in out:
        print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
