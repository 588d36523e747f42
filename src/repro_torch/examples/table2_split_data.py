"""Table 2 analogue (paper §5): splitting the dataset between replicas.
Cases: (n=2, 50% of the data each) and (n=4, 25% each), against
full-data SGD and per-shard SGD.  Port of
``benchmarks/table2_split_data.py``: the same rows and ``holds=`` rule.

    PYTHONPATH=src python -m repro_torch.examples.table2_split_data
    PYTHONPATH=src python -m repro_torch.examples.table2_split_data \\
        --device cpu --steps 60

Runs on ``cuda`` unless ``--device cpu``.  ``run(use_kernel=True)``
routes Parle's updates through K1 / K2 and Elastic-SGD's through K7; the
command line runs the plain path, as the reference's harness does.
Elastic-SGD is evaluated at its deployable, the shared variable
(``layout.tree(state.ref)``, the reference's ``est.ref`` tree).
"""
from __future__ import annotations

import argparse

from repro_torch.core import parle
from repro_torch.examples.common import (deployable, errors, make_task,
                                         train_elastic, train_parle,
                                         train_sgd)
from repro_torch.runtime.precision import pin_float32


def run(steps: int = 400, seed: int = 0, device="cuda", use_kernel=False):
    """[(case, test error, wall_s)]."""
    task = make_task(seed, device)
    rows = []
    sgd_full, t = train_sgd(task, steps, seed=seed)
    te, _ = errors(sgd_full, task)
    rows.append(("sgd_full_data", te, t))

    for n in (2, 4):
        pst, tp = train_parle(task, n, steps, split=True, seed=seed,
                              use_kernel=use_kernel)
        te_p, _ = errors(parle.average_model(pst), task)
        rows.append((f"parle_n{n}_{100//n}pct", te_p, tp))

        est, te_t = train_elastic(task, n, steps, split=True, seed=seed,
                                  use_kernel=use_kernel)
        te_e, _ = errors(deployable("elastic_sgd", est), task)
        rows.append((f"elastic_n{n}_{100//n}pct", te_e, te_t))

        shard_params, ts = train_sgd(task, steps, seed=seed, shard=(0, n))
        te_s, _ = errors(shard_params, task)
        rows.append((f"sgd_shard_{100//n}pct", te_s, ts))
    return rows


def report(rows, steps: int) -> list:
    """The reference's output lines for :func:`run`'s rows (µs per step
    over ``steps``; the reference divides by its default 400)."""
    d = {r[0]: r[1] for r in rows}
    out = []
    for name, te, wall in rows:
        out.append(f"table2_{name},{wall*1e6/steps:.0f},test_err={te:.4f}")
    # claim T3: split-Parle beats per-shard SGD (both n)
    for n in (2, 4):
        holds = d[f"parle_n{n}_{100//n}pct"] < d[f"sgd_shard_{100//n}pct"] + 0.01
        out.append(f"table2_claim_split_n{n},0,"
                   f"parle={d[f'parle_n{n}_{100//n}pct']:.4f};"
                   f"sgd_shard={d[f'sgd_shard_{100//n}pct']:.4f};holds={holds}")
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
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
