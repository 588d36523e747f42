"""Entropy-SGD (Chaudhari et al., 2016) — Eq. (6).  Port of
``repro/core/entropy_sgd.py``.

Exactly Parle with n = 1: the elastic term (x^a - xbar)/rho vanishes
identically because the replica mean of a single replica is itself
(§2.1, §3 of the Parle paper).  Implemented as a thin wrapper so the
equivalence is structural, not re-derived.  A group of ranks has nothing
to shard at n = 1: the sharded step takes only the trivial group
(``core/algorithm.py`` refuses a larger one with the reference's
message).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import parle


def _n1(cfg):
    return dataclasses.replace(cfg, n_replicas=1, mode="entropy_sgd")


def init(params, cfg):
    return parle.init(params, _n1(cfg))


def make_train_step(loss_fn, cfg, weight_decay: float = 0.0,
                    use_kernel: bool = False, lr_schedule=None):
    return parle.make_train_step(loss_fn, _n1(cfg), weight_decay=weight_decay,
                                 use_kernel=use_kernel,
                                 lr_schedule=lr_schedule)


def make_sharded_train_step(loss_fn, cfg, group, weight_decay: float = 0.0,
                            use_kernel: bool = False, lr_schedule=None):
    return parle.make_sharded_train_step(
        loss_fn, _n1(cfg), group, weight_decay=weight_decay,
        use_kernel=use_kernel, lr_schedule=lr_schedule)


def average_model(state):
    return parle.average_model(state)
