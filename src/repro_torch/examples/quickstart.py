"""Quickstart: Parle vs SGD in about a minute, through the ``Algorithm``
protocol — every optimizer of the port (parle, entropy_sgd, elastic_sgd,
sgd) is driven by the SAME loop.  Port of ``examples/quickstart.py``.

Trains the same MLP classifier on the teacher task (``TeacherTask``, the
reference's data bit for bit) with (a) SGD and (b) Parle with 3 replicas
(the paper's hyper-parameters: L=25, alpha=0.75, gamma0=100, rho0=1,
Nesterov 0.9), then prints the paper's Table-1-style comparison and
asserts its claim, Parle's test error <= SGD's + 0.02.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 400]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on ``cuda`` unless ``--device cpu``.  The MLP's params are drawn on
the host from a ``torch.Generator`` seeded 0 (not the reference's PRNG)
and moved to the device, so the CPU and the card start from the same
params.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ParleConfig
from repro_torch.core import registry
from repro_torch.core.parle import dealias_state
from repro_torch.data.synthetic import TeacherTask, replica_batches
from repro_torch.models.convnet import (classification_loss, error_rate,
                                        init_mlp, mlp_forward)
from repro_torch.runtime.precision import pin_float32
from repro_torch.utils.pytree import tree_map

BATCH = 128


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(algo_name, task, loss_fn, params, cfg, steps, bs=BATCH, *,
          batches=None, use_kernel=False):
    """The whole training loop, for ANY registered algorithm.  Returns
    (the deployable params, the final state, the wall in seconds).

    ``batches(i, n)``: the batch of step ``i`` for ``n`` replicas (the
    algorithm's, after ``canonicalize_cfg``); default
    ``replica_batches(task, i, bs, n)``.  ``use_kernel`` is forwarded to
    ``make_step``.  The wall is taken between two device
    synchronizations."""
    algo = registry.get(algo_name)
    cfg = algo.canonicalize_cfg(cfg)
    state = dealias_state(algo.init(params, cfg))
    step = algo.make_step(loss_fn, cfg, use_kernel=use_kernel)
    if batches is None:
        batches = lambda i, n: replica_batches(task, i, bs, n)  # noqa: E731
    device = task.x_train.device
    sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        state, _ = step(state, batches(i, cfg.n_replicas))
    sync(device)
    return algo.deployable(state), state, time.perf_counter() - t0


def paper_cfg(n: int, task: TeacherTask) -> ParleConfig:
    return ParleConfig(n_replicas=n, L=25, lr=0.1, lr_inner=0.1,
                       batches_per_epoch=task.batches_per_epoch(BATCH))


_CLASSIFY = classification_loss(mlp_forward)


def loss_fn(params, batch):
    return _CLASSIFY(params, batch)[0], ()


def errors(task: TeacherTask, model) -> tuple:
    """(test error, train error) of ``model`` as floats."""
    with torch.no_grad():
        return (float(error_rate(mlp_forward, model, task.test_batch())),
                float(error_rate(mlp_forward, model,
                                 {"x": task.x_train, "y": task.y_train})))


def run(steps: int = 400, replicas: int = 3, device="cuda") -> dict:
    """Both trainings and the comparison table; returns the errors and
    walls.  Raises AssertionError when Parle generalizes worse than SGD
    by more than 0.02."""
    pin_float32()
    device = resolve_device(device)
    task = TeacherTask(device=str(device))
    params = tree_map(lambda t: t.to(device),
                      init_mlp(torch.Generator().manual_seed(0)))

    # ---- identical loop code for both algorithms ------------------
    sgd_model, _, t_sgd = train("sgd", task, loss_fn, params,
                                paper_cfg(1, task), steps)
    parle_model, pst, t_parle = train("parle", task, loss_fn, params,
                                      paper_cfg(replicas, task), steps)
    sgd_test, sgd_train = errors(task, sgd_model)
    parle_test, parle_train = errors(task, parle_model)

    print(f"{'':14}{'test err':>10}{'train err':>11}{'wall (s)':>10}")
    print(f"{'SGD':14}{sgd_test:10.4f}{sgd_train:11.4f}{t_sgd:10.1f}")
    print(f"{'Parle n=' + str(replicas):14}"
          f"{parle_test:10.4f}{parle_train:11.4f}{t_parle:10.1f}")
    diag = registry.get("parle").diagnostics(pst)
    print(f"\nreplica overlap: {diag['overlap']:.4f}"
          f"   (elastic coupling keeps replicas aligned, paper §1.2)")
    print(f"scopes at end:  gamma={diag['gamma']:.2f} "
          f"rho={diag['rho']:.3f}   (Eq. 9 scoping)", flush=True)
    assert parle_test <= sgd_test + 0.02, "Parle should generalize >= SGD"
    return {"sgd_test": sgd_test, "sgd_train": sgd_train,
            "parle_test": parle_test, "parle_train": parle_train,
            "sgd_wall_s": t_sgd, "parle_wall_s": t_parle}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (no silent fallback to the CPU)")
    args = ap.parse_args(argv)
    return run(args.steps, args.replicas, args.device)


if __name__ == "__main__":
    main()
