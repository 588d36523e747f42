"""Shared harness of the paper's experiments (Table 1, Table 2, Fig. 1).
Port of ``benchmarks/common.py``.

Each table is reproduced as a scaled analogue on the synthetic teacher
classification task (``data/synthetic.py::TeacherTask``, the
reference's data bit for bit) with the paper's hyper-parameters (L=25,
alpha=0.75, gamma0=100, rho0=1, Nesterov 0.9) and the §3.1 annealing
(lr dropped 5x at 60% and 85% of the budget, for every algorithm).
What is checked is the paper's claims about orderings:

  T1  Parle error < {SGD, Entropy-SGD, Elastic-SGD} error   (Table 1)
  T2  Parle train error > SGD train error (under-fitting, §4.5)
  T3  split-data Parle < per-shard SGD                      (Table 2)
  T4  one-shot averaging catastrophic vs Parle's average    (Fig. 1)

Every algorithm trains through the ``Algorithm`` protocol, in the
quickstart's loop (``quickstart.train``).  The MLP's params are drawn on
the host from ``torch.Generator().manual_seed(seed)`` and moved to the
task's device, so the CPU and the card start from the same params (not
the reference's PRNG: ``params=`` takes any param tree instead).
``use_kernel`` routes Parle's and Entropy-SGD's updates through K1 / K2
and Elastic-SGD's through K7; SGD has no kernel.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs import ParleConfig
from repro_torch.core import registry
from repro_torch.data.synthetic import TeacherTask, replica_batches
from repro_torch.examples import quickstart
from repro_torch.models.convnet import init_mlp
from repro_torch.utils.pytree import tree_map

LOSS_FN = quickstart.loss_fn
BS = 128


def make_task(seed=0, device="cuda") -> TeacherTask:
    return TeacherTask(num_train=4096, num_test=1024, seed=seed,
                       device=str(resolve_device(device)))


def mlp_params(seed, device) -> dict:
    """The MLP drawn on the host from ``seed``, on ``device``."""
    return tree_map(lambda t: t.to(device),
                    init_mlp(torch.Generator().manual_seed(seed)))


def bench_cfg(task, n, steps, lr=0.1, L=25) -> ParleConfig:
    """The paper's hyper-parameters + the §3.1 annealing (5x drops at 60%
    and 85% of the budget) as ParleConfig step-decay fields."""
    return ParleConfig(n_replicas=n, L=L, lr=lr, lr_inner=lr,
                       batches_per_epoch=task.batches_per_epoch(BS),
                       lr_drop_steps=(int(steps * .6), int(steps * .85)),
                       lr_drop_factor=0.2)


def _train(name, task, steps, cfg, seed, params, batches, use_kernel):
    if params is None:
        params = mlp_params(seed, task.x_train.device)
    _, state, wall = quickstart.train(name, task, LOSS_FN, params, cfg,
                                      steps, BS, batches=batches,
                                      use_kernel=use_kernel)
    return state, wall


def train_algo(name, task, steps, n=3, split=False, seed=0, L=25, lr=0.1,
               *, params=None, use_kernel=False):
    """Train any registered algorithm; returns (final state, wall_s)."""
    return _train(name, task, steps, bench_cfg(task, n, steps, lr=lr, L=L),
                  seed, params,
                  lambda i, m: replica_batches(task, i, BS, m, split=split),
                  use_kernel)


def deployable(name, state) -> dict:
    return registry.get(name).deployable(state)


# ---- per-algorithm wrappers (table2 / fig1 call these directly) ------

def train_sgd(task, steps, seed=0, shard=(0, 1), lr=0.1, *, params=None):
    """SGD on a fixed data shard (Table 2's per-shard baseline); returns
    (params, wall_s).  shard=(0, 1) is full-data SGD."""
    batches = lambda i, m: {k: v[None] for k, v in  # noqa: E731
                            task.train_batch(i, BS, shard=shard).items()}
    state, wall = _train("sgd", task, steps, bench_cfg(task, 1, steps, lr=lr),
                         seed, params, batches, False)
    return deployable("sgd", state), wall


def train_parle(task, n, steps, split=False, seed=0, L=25, lr=0.1, *,
                use_kernel=False):
    return train_algo("parle", task, steps, n=n, split=split, seed=seed,
                      L=L, lr=lr, use_kernel=use_kernel)


def train_entropy(task, steps, seed=0, L=25, lr=0.1, *, use_kernel=False):
    return train_algo("entropy_sgd", task, steps, n=1, seed=seed, L=L,
                      lr=lr, use_kernel=use_kernel)


def train_elastic(task, n, steps, split=False, seed=0, lr=0.1, *,
                  use_kernel=False):
    return train_algo("elastic_sgd", task, steps, n=n, split=split,
                      seed=seed, lr=lr, use_kernel=use_kernel)


def errors(params, task) -> tuple:
    """(test error, train error) as floats."""
    return quickstart.errors(task, params)
