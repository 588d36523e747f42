"""Parle (Chaudhari et al., 2017) — Eq. (8a)-(8d) — for PyTorch.  Port of
``repro/core/parle.py`` (the local-replica path with ``sync_compress =
"none"``; compression, overlap, meshes and the async half are not
ported yet, ROADMAP.md queue 1 items 4, 6 and 7).

State layout: each of x, y, z, v_y, v_x is ONE ``(n, M)`` buffer, row a
holding replica a's whole param tree in the flat layout of
``utils/pytree.py::FlatLayout`` (every leaf at a multiple of 8192
elements, zeros in the gaps).  The updates work on the buffers IN PLACE:
a step consumes the state it is given (its buffers are those of the
state it returns), the counterpart of the reference's donated buffers.
So the five fields must be distinct buffers — :func:`init` makes them
so, and :func:`dealias_state` restores it for a state built by hand.

Updates (Nesterov momentum mu=0.9 per Remark 2):

  inner_step (every step; zero cross-replica traffic):
    g_y   = grad f(y) + (y - x)/gamma            (8a)
    v_y  <- mu v_y + g_y ;  y <- y - lr' (g_y + mu v_y)
    z    <- alpha z + (1-alpha) y                (8b)

  sync_step (when k/L integer):
    xbar  = mean_a x^a                           (8d with eta''=rho/n)
    g_x   = (x - z) + (x - xbar)/rho             (8c)
    v_x  <- mu v_x + g_x ;  x <- x - lr (g_x + mu v_x)
    y, z <- x  (inner-loop reset);  gamma, rho <- scoping decay (Eq. 9)

With ``use_kernel`` the two updates are the CUDA kernels K1 and K2
(``kernels/ops.py``: one launch each over all replicas and leaves); the
default path is the same arithmetic as eager torch ops, one replica row
at a time (so its temporaries stay at one row's size).

Per-replica grads come from a Python loop over the replicas (only one
replica's activations are alive at a time; each replica is independent,
as under the reference's ``jax.vmap``).  Replica a's ``y`` row is made a
leaf that requires grad, and the params are ``torch.split`` views of it,
so autograd hands back one row-shaped grad (``FlatLayout.split``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.scoping import Scopes, init_scopes, update_scopes
from repro_torch.utils.pytree import FlatLayout, tree_map

_NOT_PORTED = ("{what} is not ported yet (ROADMAP.md queue 1, item "
               "{item})")


class ParleState(NamedTuple):
    """Dtype layout under mixed precision (cfg.precision="bf16"): ``y``
    (the compute iterate — what the loss/grad sees) is bfloat16; ``x``,
    ``z`` and both momenta stay float32 masters.  ``step`` and the scopes
    are host tensors (int32 / float32); ``layout`` maps a buffer row to
    the param tree."""

    x: torch.Tensor        # (n, M) replicas x^a                 [f32 master]
    y: torch.Tensor        # (n, M) inner Entropy-SGD iterate    [compute dtype]
    z: torch.Tensor        # (n, M) exponential average of y     [f32 master]
    v_y: torch.Tensor      # (n, M) Nesterov momentum of y       [f32 master]
    v_x: torch.Tensor      # (n, M) Nesterov momentum of x^a     [f32 master]
    step: torch.Tensor     # () int32, counts inner steps k
    scopes: Scopes
    layout: FlatLayout

    def tree(self) -> dict:
        """The reference ParleState's pytree (sync_compress "none", no
        overlap): each field a nested dict of ``(n, ...)`` leaf views."""
        out = {f: self.layout.tree(getattr(self, f))
               for f in ("x", "y", "z", "v_y", "v_x")}
        out["step"] = self.step
        out["scopes"] = {"gamma": self.scopes.gamma, "rho": self.scopes.rho}
        return out


def _check_cfg(cfg):
    if getattr(cfg, "sync_compress", "none") != "none":
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"sync_compress={cfg.sync_compress!r} (kernels K4-K6)",
            item=4))
    if getattr(cfg, "sync_overlap", False):
        raise NotImplementedError(_NOT_PORTED.format(
            what="the staleness-1 overlapped sync", item=4))


def init(params, cfg) -> ParleState:
    """``params``: single-model param tree; replicated n_replicas times.
    All replicas start at the same point."""
    layout = FlatLayout(params)
    row = layout.flatten(params)
    return _state_from_x(row.expand(cfg.n_replicas, -1).clone(), layout, cfg)


def init_from_replicas(replica_params, cfg) -> ParleState:
    """Start from distinct per-replica params (leading axis n)."""
    layout = FlatLayout(tree_map(lambda l: l[0], replica_params))
    x = layout.flatten(replica_params, lead=(cfg.n_replicas,))
    return _state_from_x(x, layout, cfg)


def _state_from_x(x, layout, cfg) -> ParleState:
    _check_cfg(cfg)
    return ParleState(
        x=x, y=x.to(cfg.compute_dtype(), copy=True), z=x.clone(),
        v_y=torch.zeros_like(x), v_x=torch.zeros_like(x),
        step=torch.zeros((), dtype=torch.int32),
        scopes=init_scopes(cfg), layout=layout)


def dealias_state(state: ParleState) -> ParleState:
    """A state whose five buffers are distinct: any field that shares
    storage with an earlier one is copied (the updates run in place, so
    an aliased y and x would corrupt x).  A state from :func:`init` or a
    restore is returned as it is — no model-size copy."""
    seen, repl = set(), {}
    for f in ("x", "y", "z", "v_y", "v_x"):
        t = getattr(state, f)
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            repl[f] = t.clone()
        seen.add(ptr)
    return state._replace(**repl)


# ------------------------------------------------------------------
# Inner step (8a)-(8b)
# ------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def inner_step(state: ParleState, grads, cfg, use_kernel: bool = False,
               lr_scale=1.0) -> ParleState:
    """grads: ``(n, M)`` flat buffer of grad f(y^a), y's dtype.
    ``lr_scale``: multiplier on lr_inner (step-decay schedules, §4).

    Mixed precision: y and grads may be bf16 while z, v, x are f32
    masters; the update accumulates in f32 — bf16 operands are upcast on
    read and only the y output is cast back."""
    mu, lr = cfg.momentum, cfg.lr_inner * lr_scale
    inv_gamma = 1.0 / state.scopes.gamma
    alpha = cfg.alpha

    if use_kernel:
        from repro_torch.kernels import ops as kops
        kops.parle_inner_update(state.y, state.z, state.v_y, grads, state.x,
                                inv_gamma=inv_gamma, lr=lr, mu=mu,
                                alpha=alpha)
    else:
        # f32 scalars, and 1 - alpha taken in f32, as the kernel does
        lr, alpha = _f32(lr), _f32(alpha)
        for a in range(state.x.shape[0]):
            y, z, v = state.y[a], state.z[a], state.v_y[a]
            yf = y.float()
            g_y = grads[a].float() + inv_gamma * (yf - state.x[a])  # (8a)
            v.copy_(mu * v + g_y)                                   # Nesterov
            y_new = yf - lr * (g_y + mu * v)
            del g_y
            z.copy_(alpha * z + (1.0 - alpha) * y_new)              # (8b)
            y.copy_(y_new)
    return state._replace(step=state.step + 1)


# ------------------------------------------------------------------
# Sync step (8c)-(8d)
# ------------------------------------------------------------------

def consensus_step(state: ParleState, xbar, cfg, *,
                   use_kernel: bool = False, lr_scale=1.0) -> ParleState:
    """The Eq. (8c)-(8d) consensus update given the reduced ``xbar``
    ((M,), the replica mean), then the inner-loop reset y, z <- x',
    v_y <- 0 and the Eq. (9) scope decay.

    Under bf16 the compute copy y' = bf16(x') is written by the update
    itself (K2's fused third output); in f32 the reset copies x' into y.
    The reset moves, per replica row of M elements, 2 streams for z, 2
    for an f32 y and 1 for v_y."""
    mu, lr = cfg.momentum, cfg.lr * lr_scale
    inv_rho = 1.0 / state.scopes.rho
    gamma_scale = 1.0 if cfg.scale_lr_by_gamma else 1.0 / state.scopes.gamma
    fused_y = state.y.dtype != torch.float32

    if use_kernel:
        from repro_torch.kernels import ops as kops
        kops.parle_sync_update(state.x, state.z, state.v_x, xbar,
                               gamma_scale=gamma_scale, inv_rho=inv_rho,
                               lr=lr, mu=mu,
                               y_out=state.y if fused_y else None)
    else:
        lr, gamma_scale = _f32(lr), _f32(gamma_scale)
        for a in range(state.x.shape[0]):
            x, v = state.x[a], state.v_x[a]
            g_x = gamma_scale * (x - state.z[a]) + inv_rho * (x - xbar)  # (8c)
            v.copy_(mu * v + g_x)
            x.copy_(x - lr * (g_x + mu * v))
            del g_x
            if fused_y:
                state.y[a].copy_(x)
    state.z.copy_(state.x)           # reset y, z to x^a (paper: "we
    if not fused_y:                  # initialize y to x every L")
        state.y.copy_(state.x)
    state.v_y.zero_()
    return state._replace(scopes=update_scopes(state.scopes, cfg))


def replica_mean(x) -> torch.Tensor:
    """(n, M) -> (M,): the Eq. (8d) mean (sum, then a true division by
    n, as ``jnp.mean``)."""
    return x.sum(0) / x.shape[0]


def sync_step(state: ParleState, cfg, use_kernel: bool = False,
              lr_scale=1.0) -> ParleState:
    # (8d) with eta'' = rho/n: the reference IS the replica mean; one
    # (M,) buffer shared by every replica's update
    return consensus_step(state, replica_mean(state.x), cfg,
                          use_kernel=use_kernel, lr_scale=lr_scale)


def fused_step(state: ParleState, grads, cfg, use_kernel: bool = False,
               lr_scale=1.0) -> ParleState:
    """One Parle step: inner update + conditional sync (k/L integer)."""
    state = inner_step(state, grads, cfg, use_kernel=use_kernel,
                       lr_scale=lr_scale)
    if int(state.step) % cfg.L == 0:
        state = sync_step(state, cfg, use_kernel=use_kernel,
                          lr_scale=lr_scale)
    return state


# ------------------------------------------------------------------
# Train-step factory
# ------------------------------------------------------------------

def _replica_grads(loss_fn: Callable, state: ParleState, batch, grads,
                   weight_decay: float) -> torch.Tensor:
    """Fill ``grads`` (n, M) with each replica's grad f(y^a) and return
    the (n,) losses.  ``batch`` leaves carry the leading replica axis."""
    losses = []
    for a in range(state.y.shape[0]):
        row = state.y[a].detach().requires_grad_(True)
        loss, _ = loss_fn(state.layout.split(row),
                          {k: v[a] for k, v in batch.items()})
        g, = torch.autograd.grad(loss, row)
        if weight_decay:
            g = g + weight_decay * state.y[a]
        grads[a].copy_(g)
        losses.append(loss.detach())
    return torch.stack(losses)


class _GradBuffer:
    """The (n, M) grad buffer of a step/round factory, allocated at its
    first use and reused by every later step."""

    def __init__(self):
        self.buf = None

    def like(self, y) -> torch.Tensor:
        if (self.buf is None or self.buf.shape != y.shape
                or self.buf.dtype != y.dtype or self.buf.device != y.device):
            self.buf = torch.empty_like(y)
        return self.buf


def _scale(lr_schedule, step):
    return lr_schedule(step) if lr_schedule is not None else 1.0


def make_train_step(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                    use_kernel: bool = False, lr_schedule=None):
    """loss_fn(params, batch) -> (scalar, aux).  Returns

        step(state, batch) -> (state, metrics)

    where ``batch`` leaves carry a leading replica axis of size n.
    ``lr_schedule``: step -> multiplier on BOTH cfg.lr and cfg.lr_inner.
    The step consumes ``state`` (its buffers are updated in place)."""
    _check_cfg(cfg)
    gbuf = _GradBuffer()

    def step(state: ParleState, batch):
        losses = _replica_grads(loss_fn, state, batch, gbuf.like(state.y),
                                weight_decay)
        new_state = fused_step(state, gbuf.buf, cfg, use_kernel=use_kernel,
                               lr_scale=_scale(lr_schedule, state.step))
        return new_state, {
            "loss": losses.mean(), "loss_per_replica": losses,
            "gamma": new_state.scopes.gamma, "rho": new_state.scopes.rho,
            "step": new_state.step}

    return step


def make_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                  use_kernel: bool = False, lr_schedule=None):
    """One whole Parle round per call: the L = cfg.L inner steps (8a-8b)
    followed by the sync (8c-8d) — Python enters once per round, and no
    per-step ``k % L`` test sits in the loop.

    Contract: ``batches`` leaves carry a leading round axis of length
    cfg.L (then the replica axis); the state's step counter must be a
    multiple of L on entry.  Under those invariants the result equals L
    calls of the train step bit for bit: the per-step lr_scale is taken
    at the same counters, and the sync uses the lr_scale of the round's
    last inner step (schedule(step - 1)).  Metrics: the round-mean
    ``loss`` plus the per-step ``losses`` (L,)."""
    _check_cfg(cfg)
    gbuf = _GradBuffer()

    def round_fn(state: ParleState, batches):
        if int(state.step) % cfg.L:
            raise ValueError(f"a round starts at a multiple of L={cfg.L}, "
                             f"not at step {int(state.step)}")
        step_losses = []
        for i in range(cfg.L):
            losses = _replica_grads(loss_fn, state,
                                    {k: v[i] for k, v in batches.items()},
                                    gbuf.like(state.y), weight_decay)
            state = inner_step(state, gbuf.buf, cfg, use_kernel=use_kernel,
                               lr_scale=_scale(lr_schedule, state.step))
            step_losses.append(losses.mean())
        state = sync_step(state, cfg, use_kernel=use_kernel,
                          lr_scale=_scale(lr_schedule, state.step - 1))
        losses = torch.stack(step_losses)
        return state, {"loss": losses.mean(), "losses": losses,
                       "gamma": state.scopes.gamma, "rho": state.scopes.rho,
                       "step": state.step}

    return round_fn


def average_model(state: ParleState) -> dict:
    """The deployable single model: mean of replicas (what the paper
    evaluates after scoping collapses the ensemble)."""
    return state.layout.tree(replica_mean(state.x))


def replica_model(state: ParleState, a: int) -> dict:
    return state.layout.tree(state.x[a])
