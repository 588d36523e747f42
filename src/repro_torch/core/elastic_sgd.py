"""Elastic-SGD (Zhang et al., 2015) — Eq. (7) — with the paper's rho-scoping
(§2.4, §4.4), for PyTorch.  Port of ``repro/core/elastic_sgd.py``: the
local path (the sharded functions come with the replica axis across
processes, ROADMAP.md queue 1 item 6).

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
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.parle import (GradBuffer, dealias_state,  # noqa: F401
                                    replica_grads, replica_mean,
                                    schedule_scale)
from repro_torch.core.scoping import Scopes, init_scopes, update_scopes
from repro_torch.utils.pytree import FlatLayout


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


def init(params, cfg) -> ElasticState:
    """``params``: single-model param tree; every worker and the
    reference start at it."""
    layout = FlatLayout(params)
    ref = layout.flatten(params)
    x = ref.expand(cfg.n_replicas, -1).clone()
    return ElasticState(x=x, ref=ref, v=torch.zeros_like(x),
                        step=torch.zeros((), dtype=torch.int32),
                        scopes=init_scopes(cfg), layout=layout)


def update(state: ElasticState, grads, cfg, use_kernel: bool = False,
           lr_scale=1.0, xbar=None) -> ElasticState:
    """One Eq. (7) step.  ``grads``: ``(n, M)`` flat buffer of grad
    f(x^a), float32 or the bf16 compute dtype (accumulated in f32).
    ``xbar``: an (M,) float32 buffer for the replica mean (one is
    allocated when None)."""
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
    xbar = replica_mean(state.x, out=xbar)
    diff = torch.sub(state.ref, xbar, out=xbar)
    state.ref.sub_(diff.mul_(lr))

    # scope rho once per L steps, mirroring Eq. (9)
    step = state.step + 1
    scopes = (update_scopes(state.scopes, cfg) if int(step) % cfg.L == 0
              else state.scopes)
    return state._replace(step=step, scopes=scopes)


def make_train_step(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                    use_kernel: bool = False, lr_schedule=None):
    """loss_fn(params, batch) -> (scalar, aux); ``batch`` leaves carry a
    leading replica axis of size n.  ``lr_schedule``: step -> multiplier
    on cfg.lr.  Returns step(state, batch) -> (state, metrics); the step
    consumes ``state`` (its buffers are updated in place)."""
    gbuf, mbuf = GradBuffer(), GradBuffer()   # (n, M) grads, (M,) mean
    cdt = cfg.compute_dtype()

    def step(state: ElasticState, batch):
        gdt = cdt
        if weight_decay:    # g + wd * x with an f32 x is f32 (as jnp's)
            gdt = torch.promote_types(cdt, state.x.dtype)
        losses = replica_grads(loss_fn, state.layout,
                               (row.to(cdt) for row in state.x), batch,
                               gbuf.like(state.x, gdt), weight_decay, state.x)
        new_state = update(state, gbuf.buf, cfg, use_kernel=use_kernel,
                           lr_scale=schedule_scale(lr_schedule, state.step),
                           xbar=mbuf.like(state.ref))
        return new_state, {"loss": losses.mean(), "loss_per_replica": losses,
                           "rho": new_state.scopes.rho,
                           "step": new_state.step}

    return step


def make_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                  use_kernel: bool = False, lr_schedule=None):
    """cfg.L steps per call.  Elastic-SGD couples on every step, so a
    round is just the step loop (it equals L calls of the train step bit
    for bit).  ``batches`` leaves: (L, n, B, ...).  Metrics: the
    round-mean ``loss``, the per-step ``losses`` (L,), ``rho``, ``step``."""
    step_fn = make_train_step(loss_fn, cfg, weight_decay, use_kernel,
                              lr_schedule)

    def round_fn(state: ElasticState, batches):
        losses = []
        for i in range(cfg.L):
            state, m = step_fn(state, {k: v[i] for k, v in batches.items()})
            losses.append(m["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses.mean(), "losses": losses,
                       "rho": state.scopes.rho, "step": state.step}

    return round_fn


def average_model(state: ElasticState) -> dict:
    """The deployable model: the reference variable."""
    return state.layout.tree(state.ref)
