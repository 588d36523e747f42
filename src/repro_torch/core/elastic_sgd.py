"""Elastic-SGD (Zhang et al., 2015) — Eq. (7) — with the paper's rho-scoping
(§2.4, §4.4), for PyTorch.  Port of ``repro/core/elastic_sgd.py``, in
one process or with the workers over the ranks of a ``torch.distributed``
group (the sharded step and round).

Unlike Parle, the elastic coupling fires on EVERY step: each worker takes
a gradient step with the elastic term, and the reference variable moves
toward the replica mean.

    x^a <- x^a - lr [grad f(x^a) + (x^a - ref)/rho]     (7a), Nesterov mu
    ref <- ref - lr (ref - mean_a x^a)                  (7b), plain lr

State layout as Parle's (``core/parle.py``): x and v are ONE ``(n, M)``
buffer each, row a holding worker a's whole param tree in the flat layout
of ``utils/pytree.py::FlatLayout``; ref is one ``(M,)`` row.  The updates
work on the buffers IN PLACE, so the fields must be distinct buffers
(:func:`init` makes them so, :func:`dealias_state` restores it).

With ``use_kernel``, (7a) is the CUDA kernel K7 (``kernels/ops.py``: one
launch over all workers and leaves, ref read once per worker row and
never broadcast); the default path is the same arithmetic as eager torch
ops, one worker row at a time.  (7b) takes the replica mean of the NEW x
into one reused (M,) buffer.  Grads are taken at the compute copy of x
(under ``precision="bf16"`` a bf16 copy of one row at a time); weight
decay uses the f32 master x.

Across ranks (``sharding/partition.py::ReplicaGroup``) each rank holds
its k = n / W worker rows of x and v and the whole ref; (7b)'s mean is
one model-size all-reduce of the local row sums every step
(``mean_rows``), so every rank applies the same (7b) update to its ref
and K7 reads the same ref on every rank.  A round's step losses meet in
one small all-gather after its L steps.

Inside a replica (a ``MeshGroups``) each rank holds its blocks of its
workers' rows and of ref (``utils/pytree.py::ShardedLayout``): a
worker's grads gather its blocks into one full row and reduce-scatter
the full grad row back (``core/parle.py::ShardGrads``), K7 runs on the
shard buffers, and (7b)'s mean is the all-reduce of the shard rows over
the replica subgroup.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.parle import (GradBuffer, dealias_state,  # noqa: F401
                                    shard_grads_for, full_tree, replica_grads,
                                    replica_mean, schedule_scale)
from repro_torch.core.scoping import Scopes, init_scopes, update_scopes
from repro_torch.sharding.partition import (active, check_divisible,
                                            layout_for,
                                            make_sharded_step_fn,
                                            replica_group)


class ElasticState(NamedTuple):
    """x, ref and v are float32 masters whatever the compute precision;
    ``step`` and the scopes are host tensors (int32 / float32)."""

    x: torch.Tensor        # (n, M) workers x^a
    ref: torch.Tensor      # (M,) reference / parameter-server variable
    v: torch.Tensor        # (n, M) Nesterov momentum of x^a
    step: torch.Tensor     # () int32
    scopes: Scopes
    layout: FlatLayout

    def tree(self) -> dict:
        """The reference ElasticState's pytree: x and v as nested dicts of
        ``(n, ...)`` leaf views, ref of ``(...)`` leaf views."""
        return {"x": self.layout.tree(self.x),
                "ref": self.layout.tree(self.ref),
                "v": self.layout.tree(self.v), "step": self.step,
                "scopes": {"gamma": self.scopes.gamma,
                           "rho": self.scopes.rho}}


def init(params, cfg, group=None) -> ElasticState:
    """``params``: single-model param tree; every worker and the
    reference start at it (under a ``group``, only the rank's k worker
    rows are made; under axes inside a replica, its blocks of them)."""
    layout = layout_for(params, group)
    ref = layout.flatten(params)
    k = cfg.n_replicas if active(group) is None else group.local
    x = ref.expand(k, -1).clone()
    return ElasticState(x=x, ref=ref, v=torch.zeros_like(x),
                        step=torch.zeros((), dtype=torch.int32),
                        scopes=init_scopes(cfg), layout=layout)


def update(state: ElasticState, grads, cfg, use_kernel: bool = False,
           lr_scale=1.0, xbar=None, group=None) -> ElasticState:
    """One Eq. (7) step.  ``grads``: ``(n, M)`` flat buffer of grad
    f(x^a), float32 or the bf16 compute dtype (accumulated in f32).
    ``xbar``: an (M,) float32 buffer for the replica mean (one is
    allocated when None); under an active ``group`` the mean is over the
    workers of every rank (one all-reduce)."""
    mu, lr = cfg.momentum, cfg.lr * lr_scale
    inv_rho = 1.0 / state.scopes.rho

    if use_kernel:
        from repro_torch.kernels import ops as kops
        kops.elastic_worker_update(state.x, state.v, grads, state.ref,
                                   inv_rho=inv_rho, lr=lr, mu=mu)
    else:
        # one f32 rounding of lr, as the kernel takes it
        lr_t = torch.as_tensor(lr, dtype=torch.float32)
        for a in range(state.x.shape[0]):
            x, v = state.x[a], state.v[a]
            g_e = grads[a].float() + inv_rho * (x - state.ref)      # (7a)
            v.copy_(mu * v + g_e)                                   # Nesterov
            x.copy_(x - lr_t * (g_e + mu * v))
            del g_e

    # (7b): ref <- ref - lr (ref - mean_a x^a)   [plain lr, not lr/rho]
    xbar = (replica_mean(state.x, out=xbar) if active(group) is None
            else active(group).mean_rows(state.x, out=xbar,
                                         segments=state.layout.segments))
    diff = torch.sub(state.ref, xbar, out=xbar)
    state.ref.sub_(diff.mul_(lr))

    # scope rho once per L steps, mirroring Eq. (9)
    step = state.step + 1
    scopes = (update_scopes(state.scopes, cfg) if int(step) % cfg.L == 0
              else state.scopes)
    return state._replace(step=step, scopes=scopes)


def _make_step_body(loss_fn: Callable, cfg, weight_decay, use_kernel,
                    lr_schedule, group=None):
    """The step of :func:`make_train_step`; under an active ``group`` it
    emits its k local losses as ``local_loss_per_replica``."""
    gbuf, mbuf = GradBuffer(), GradBuffer()   # (n, M) grads, (M,) mean
    shard = shard_grads_for(group)
    grads_fn = shard if shard is not None else replica_grads
    cdt = cfg.compute_dtype()
    group = active(group)

    def step(state: ElasticState, batch):
        gdt = cdt
        if weight_decay:    # g + wd * x with an f32 x is f32 (as jnp's)
            gdt = torch.promote_types(cdt, state.x.dtype)
        losses = grads_fn(loss_fn, state.layout,
                          (row.to(cdt) for row in state.x), batch,
                          gbuf.like(state.x, gdt), weight_decay, state.x)
        new_state = update(state, gbuf.buf, cfg, use_kernel=use_kernel,
                           lr_scale=schedule_scale(lr_schedule, state.step),
                           xbar=mbuf.like(state.ref), group=group)
        if group is None:
            metrics = {"loss": losses.mean(), "loss_per_replica": losses}
        else:
            metrics = {"local_loss_per_replica": losses}
        return new_state, dict(metrics, rho=new_state.scopes.rho,
                               step=new_state.step)

    return step


def make_train_step(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                    use_kernel: bool = False, lr_schedule=None):
    """loss_fn(params, batch) -> (scalar, aux); ``batch`` leaves carry a
    leading replica axis of size n.  ``lr_schedule``: step -> multiplier
    on cfg.lr.  Returns step(state, batch) -> (state, metrics); the step
    consumes ``state`` (its buffers are updated in place)."""
    return _make_step_body(loss_fn, cfg, weight_decay, use_kernel,
                           lr_schedule)


def make_sharded_train_step(loss_fn: Callable, cfg, group,
                            weight_decay: float = 0.0,
                            use_kernel: bool = False, lr_schedule=None):
    """Distributed Elastic-SGD over the ranks of ``group``: workers are
    the rank's k local rows, ref is whole on every rank (each applies the
    identical (7b) update).  One model-size all-reduce per step — L times
    Parle's traffic per step — plus the gather of the per-replica
    losses."""
    return make_sharded_step_fn(
        _make_step_body(loss_fn, cfg, weight_decay, use_kernel, lr_schedule,
                        group), group, cfg.n_replicas)


def make_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                  use_kernel: bool = False, lr_schedule=None, group=None):
    """cfg.L steps per call.  Elastic-SGD couples on every step, so a
    round is just the step loop (it equals L calls of the train step bit
    for bit).  ``batches`` leaves: (L, n, B, ...).  Metrics: the
    round-mean ``loss``, the per-step ``losses`` (L,), ``rho``, ``step``.
    ``group``: see :func:`make_sharded_round_fn`."""
    step_fn = _make_step_body(loss_fn, cfg, weight_decay, use_kernel,
                              lr_schedule, group)
    group = active(group)

    def round_fn(state: ElasticState, batches):
        losses = []
        for i in range(cfg.L):
            state, m = step_fn(state, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"] if group is None
                          else m["local_loss_per_replica"])
        losses = (torch.stack(losses) if group is None
                  else group.replica_means(torch.stack(losses, 1)))
        return state, {"loss": losses.mean(), "losses": losses,
                       "rho": state.scopes.rho, "step": state.step}

    return round_fn


def make_sharded_round_fn(loss_fn: Callable, cfg, group,
                          weight_decay: float = 0.0,
                          use_kernel: bool = False, lr_schedule=None):
    """Distributed fused round: L steps, each with its model-size
    all-reduce (that O(2nN) wire cost is the point of the baseline), and
    one gather of the (k, L) step losses."""
    rg = replica_group(group)
    check_divisible(cfg.n_replicas, rg.world, rg.axis)
    return make_round_fn(loss_fn, cfg, weight_decay, use_kernel, lr_schedule,
                         group=group)


def average_model(state: ElasticState, group=None) -> dict:
    """The deployable model: the reference variable (its blocks gathered
    into full leaves under axes inside a replica)."""
    return full_tree(state.ref, state.layout, group)
