"""SGD with Nesterov momentum — the paper's baseline optimizer (§4) — plus
step-decay learning-rate schedules of the form the paper uses ("dropped
by a factor of 5-10 at epochs [...]").  Port of ``repro/optim/sgd.py``,
in one process or with the data shards over the ranks of a
``torch.distributed`` group (the sharded step and round).

The state keeps params and v as ONE ``(M,)`` row each, in the flat layout
of ``utils/pytree.py::FlatLayout``, and the updates run IN PLACE.  The
Algorithm-protocol step reads the batch's leading axis as n data shards:
each shard's grad is taken at the one param row (its compute copy under
``precision="bf16"``), the n grads are summed into one float32 (M,)
buffer and divided by n, and one Nesterov step follows.  There is no
kernel: the reference ignores ``use_kernel`` for SGD, and so does the
port.  Across ranks (``sharding/partition.py::ReplicaGroup``) each rank
takes the grads of its k shards, and their sum is all-reduced (one
model-size all-reduce a step) before the division by n, so every rank
keeps the same params.  Inside a replica (a ``MeshGroups``) a rank
holds its blocks of params and v (``utils/pytree.py::ShardedLayout``):
the step gathers them into one full row, takes the k shards' grads there
and reduce-scatters their sum to the rank's blocks
(``core/parle.py::ShardGrads``); the all-reduce over the replica
subgroup then moves shard-size rows.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core.parle import (GradBuffer, shard_grads_for, replica_grads,
                                    schedule_scale)
from repro_torch.sharding.partition import (active, check_divisible,
                                            layout_for,
                                            make_sharded_step_fn,
                                            replica_group)


class SGDState(NamedTuple):
    params: torch.Tensor   # (M,) float32
    v: torch.Tensor        # (M,) Nesterov momentum
    step: torch.Tensor     # () int32
    layout: FlatLayout

    def tree(self) -> dict:
        """The reference SGDState's pytree (leaf views)."""
        return {"params": self.layout.tree(self.params),
                "v": self.layout.tree(self.v), "step": self.step}


def init(params, group=None) -> SGDState:
    """One model at ``params`` (under axes inside a replica, the rank's
    blocks of it)."""
    layout = layout_for(params, group)
    row = layout.flatten(params)
    return SGDState(params=row, v=torch.zeros_like(row),
                    step=torch.zeros((), dtype=torch.int32), layout=layout)


def step_decay_schedule(base_lr: float, boundaries: Sequence[int],
                        factor: float):
    """step -> ``base_lr * factor ** (boundaries passed)`` as a 0-dim
    float32 tensor, computed in float32 as the reference does."""
    b = torch.tensor(list(boundaries), dtype=torch.int32)
    base = torch.tensor(base_lr, dtype=torch.float32)
    fac = torch.tensor(factor, dtype=torch.float32)

    def lr_at(step):
        drops = (torch.as_tensor(step) >= b).sum()
        return base * fac ** drops.float()

    return lr_at


def update(state: SGDState, grads, lr, momentum: float = 0.9,
           weight_decay: float = 0.0) -> SGDState:
    """One Nesterov step on the flat (M,) ``grads`` (float32; consumed as
    a scratch buffer).  Updates params and v in place."""
    if weight_decay:
        grads.add_(weight_decay * state.params)
    state.v.mul_(momentum).add_(grads)                        # v' = mu v + g
    state.params.sub_(torch.mul(state.v, momentum).add_(grads).mul_(lr))
    return state._replace(step=state.step + 1)


def make_train_step(loss_fn: Callable, lr_schedule, momentum: float = 0.9,
                    weight_decay: float = 0.0):
    """Single-model step: ``lr_schedule`` is a step -> lr callable or a
    constant lr; ``batch`` has no shard axis."""
    gbuf = GradBuffer()

    def step(state: SGDState, batch):
        row = state.params.detach().requires_grad_(True)
        loss, _ = loss_fn(state.layout.split(row), batch)
        g, = torch.autograd.grad(loss, row)
        lr = lr_schedule(state.step) if callable(lr_schedule) else lr_schedule
        new_state = update(state, gbuf.like(state.params).copy_(g), lr,
                           momentum, weight_decay)
        return new_state, {"loss": loss.detach(), "lr": lr}

    return step


# ------------------------------------------------------------------
# The Algorithm-protocol steps (core/algorithm.py): the batch carries a
# leading shard axis of size n and SGD treats it as plain data
# parallelism — per-shard grads are averaged every step.
# ------------------------------------------------------------------

def _make_step_body(loss_fn: Callable, cfg, weight_decay, lr_schedule,
                    group=None):
    """The step of :func:`make_replica_train_step`; under an active
    ``group`` the shard grads' sum is all-reduced and the step emits its
    k local losses as ``local_loss_per_replica``."""
    gbuf = GradBuffer()
    shard = shard_grads_for(group)
    grads_fn = shard if shard is not None else replica_grads
    cdt = cfg.compute_dtype()
    group = active(group)

    def step(state: SGDState, batch):
        k = next(iter(batch.values())).shape[0]
        row = state.params.to(cdt)
        losses = grads_fn(loss_fn, state.layout, [row] * k, batch,
                          gbuf.like(state.params))
        if group is None:
            grads = gbuf.buf.div_(k)              # the mean over the shards
        else:
            grads = group.all_reduce_(
                gbuf.buf, state.layout.segments).div_(group.n)
        lr = cfg.lr * schedule_scale(lr_schedule, state.step)
        new_state = update(state, grads, lr, cfg.momentum, weight_decay)
        if group is None:
            return new_state, {"loss": losses.mean(), "lr": lr}
        return new_state, {"local_loss_per_replica": losses, "lr": lr}

    return step


def make_replica_train_step(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                            lr_schedule=None):
    """Protocol-shaped SGD step: ``batch`` leaves carry a leading shard
    axis of size cfg.n_replicas; grads are averaged across shards every
    step (one model copy, an n-times-larger effective batch).
    ``lr_schedule``: step -> multiplier applied to cfg.lr."""
    return _make_step_body(loss_fn, cfg, weight_decay, lr_schedule)


def make_sharded_train_step(loss_fn: Callable, cfg, group,
                            weight_decay: float = 0.0, lr_schedule=None):
    """Data-parallel SGD over the ranks of ``group``: each rank's batch
    holds its k shards; params and momentum are whole on every rank, and
    the grad mean is one model-size all-reduce per step — the O(2nN)
    baseline of §4.1."""
    return make_sharded_step_fn(
        _make_step_body(loss_fn, cfg, weight_decay, lr_schedule, group),
        group, cfg.n_replicas)


def make_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                  lr_schedule=None, group=None):
    """cfg.L steps per call (SGD has no sync boundary; the round length
    mirrors the Parle family's).  ``batches`` leaves are (L, n, B, ...).
    Metrics: the round-mean ``loss``, the per-step ``losses`` (L,), the
    last step's ``lr`` and ``step``.  ``group``: see
    :func:`make_sharded_round_fn`."""
    step_fn = _make_step_body(loss_fn, cfg, weight_decay, lr_schedule, group)
    group = active(group)

    def round_fn(state: SGDState, batches):
        losses = []
        for i in range(cfg.L):
            state, m = step_fn(state, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"] if group is None
                          else m["local_loss_per_replica"])
        losses = (torch.stack(losses) if group is None
                  else group.replica_means(torch.stack(losses, 1)))
        return state, {"loss": losses.mean(), "losses": losses,
                       "lr": m["lr"], "step": state.step}

    return round_fn


def make_sharded_round_fn(loss_fn: Callable, cfg, group,
                          weight_decay: float = 0.0, lr_schedule=None):
    """Data-parallel fused round over the ranks of ``group``: L steps,
    each with its model-size all-reduce, and one gather of the (k, L)
    step losses."""
    rg = replica_group(group)
    check_divisible(cfg.n_replicas, rg.world, rg.axis)
    return make_round_fn(loss_fn, cfg, weight_decay, lr_schedule,
                         group=group)
