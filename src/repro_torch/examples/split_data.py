"""Paper §5: splitting the dataset between replicas.  Port of
``examples/split_data.py``.

Each Parle replica sees only a disjoint 1/n shard of the training data;
the ONLY way information crosses shards is the elastic proximal term
(1/2rho)||x^a - x||^2.  Compares against SGD restricted to one shard
and SGD with full data (Table 2 of the paper), and asserts that Parle's
test error is below the one-shard SGD's + 0.01.

    PYTHONPATH=src python -m repro_torch.examples.split_data [--steps 400]
    PYTHONPATH=src python -m repro_torch.examples.split_data --device cpu

Runs on ``cuda`` unless ``--device cpu``.  The MLP's params are drawn on
the host from a ``torch.Generator`` seeded 0 and moved to the device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ParleConfig
from repro_torch.core import parle
from repro_torch.data.synthetic import TeacherTask, replica_batches
from repro_torch.examples.common import mlp_params
from repro_torch.examples.quickstart import loss_fn
from repro_torch.models.convnet import error_rate, mlp_forward
from repro_torch.optim import sgd
from repro_torch.runtime.precision import pin_float32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (no silent fallback to the CPU)")
    args = ap.parse_args(argv)
    pin_float32()
    device = resolve_device(args.device)
    n = args.replicas

    task = TeacherTask(device=str(device))
    bs = 128

    def eval_err(p):
        with torch.no_grad():
            return float(error_rate(mlp_forward, p, task.test_batch()))

    # SGD, full data
    st = sgd.init(mlp_params(0, device))
    step = sgd.make_train_step(loss_fn, 0.1)
    for i in range(args.steps):
        st, _ = step(st, task.train_batch(i, bs))
    err_full = eval_err(st.layout.tree(st.params))

    # SGD, one shard only (1/n of the data)
    st = sgd.init(mlp_params(0, device))
    for i in range(args.steps):
        st, _ = step(st, task.train_batch(i, bs, shard=(0, n)))
    err_shard = eval_err(st.layout.tree(st.params))

    # Parle, data split across replicas (shard a -> replica a)
    pcfg = ParleConfig(n_replicas=n, L=25, lr=0.1, lr_inner=0.1,
                       batches_per_epoch=task.batches_per_epoch(bs))
    pst = parle.init(mlp_params(0, device), pcfg)
    pstep = parle.make_train_step(loss_fn, pcfg)
    for i in range(args.steps):
        pst, _ = pstep(pst, replica_batches(task, i, bs, n, split=True))
    err_parle = eval_err(parle.average_model(pst))

    print(f"SGD  full data          : {err_full:.4f}")
    print(f"SGD  one {100//n}% shard      : {err_shard:.4f}")
    print(f"Parle n={n}, {100//n}% per rep : {err_parle:.4f}")
    print("\nThe elastic term pulls shard-limited replicas toward a region"
          "\nthat works for the union of the shards (paper §5, Table 2).",
          flush=True)
    assert err_parle < err_shard + 0.01
    return {"err_full": err_full, "err_shard": err_shard,
            "err_parle": err_parle}


if __name__ == "__main__":
    main()
