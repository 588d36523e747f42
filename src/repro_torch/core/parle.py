"""Parle (Chaudhari et al., 2017) — Eq. (8a)-(8d) — for PyTorch.  Port of
``repro/core/parle.py``: the local-replica path, with the compressed
(``sync_compress`` bf16 / int8, error feedback) and the staleness-1
overlapped (``sync_overlap``) sync, in one process or with the replica
axis over the ranks of a ``torch.distributed`` group (the sharded
factories, the reference's ``shard_map`` over its ``pod`` / ``replica``
axis), and the async half: the inner-only round, the contribution a
worker pushes to the host-side coordinator and the apply of the
staleness-weighted consensus it pulls back (``runtime/coordinator.py``,
the async policy of ``runtime/policies.py``).

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

Compressed sync (cfg.sync_compress): each replica's contribution c_a =
x_a + e_a is formed in place in the residual buffer ``e``, quantized
(``core/compress.py``; with ``use_kernel`` and int8 the CUDA kernel K4),
the residual e_a' = c_a - dequant(q_a) replaces it, and the Eq. (8d) mean
is taken over the dequantized payloads (with ``use_kernel`` and int8 the
kernel K5 fuses that mean into the update).

Overlapped sync (cfg.sync_overlap): a round starts with its head — apply
the consensus ``c`` carried from the previous round, then take this
round's payload and carry its mean in ``c`` — and runs its L inner steps
after it; :func:`make_flush_fn` applies the last ``c``.  x only changes
at a consensus, so R overlapped rounds plus the flush are R barrier
rounds with rotated boundaries (bit for bit here).  With ``use_kernel``
and int8 the head after the first is the kernel K6 (apply + quantize in
one pass).

Across ranks (``sharding/partition.py::ReplicaGroup``): each rank holds
only its k = n / W rows of every buffer, the inner steps cross no process
boundary, and the sync's Eq. (8d) mean is one model-size all-reduce of
the local row sums (``mean_rows``), or, compressed, one all-gather of the
payloads in rank order, so K5 and the dequantized mean read the n rows in
the single-process order.  The per-step losses of a round meet in one
small all-gather after its inner steps.  A group of one rank takes the
single-process path.

Per-replica grads come from a Python loop over the replicas
(:func:`replica_grads`, shared with Elastic-SGD and SGD: only one
replica's activations are alive at a time; each replica is independent,
as under the reference's ``jax.vmap``).  Replica a's ``y`` row is made a
leaf that requires grad, and the params are ``torch.split`` views of it,
so autograd hands back one row-shaped grad (``FlatLayout.split``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import compress
from repro_torch.core.scoping import Scopes, init_scopes, update_scopes
from repro_torch.sharding.partition import (active, check_divisible,
                                            make_sharded_step_fn)
from repro_torch.utils.pytree import FlatLayout, tree_map


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
    e: Optional[torch.Tensor] = None   # (n, M) sync-compression residual
    c: Optional[torch.Tensor] = None   # (M,) in-flight overlap consensus

    def tree(self) -> dict:
        """The reference ParleState's pytree: each field a nested dict of
        ``(n, ...)`` leaf views (``c``'s leaves have no replica axis);
        ``e`` and ``c`` only when present, as in the reference."""
        out = {f: self.layout.tree(getattr(self, f))
               for f in ("x", "y", "z", "v_y", "v_x")}
        out["step"] = self.step
        out["scopes"] = {"gamma": self.scopes.gamma, "rho": self.scopes.rho}
        for f in ("e", "c"):
            if getattr(self, f) is not None:
                out[f] = self.layout.tree(getattr(self, f))
        return out


FIELDS = ("x", "y", "z", "v_y", "v_x", "e", "c")   # the buffers of a state


def _sync_compress(cfg) -> str:
    method = getattr(cfg, "sync_compress", "none")
    compress.check_method(method)
    return method


def init(params, cfg, group=None) -> ParleState:
    """``params``: single-model param tree; replicated n_replicas times
    (under a ``group``, only the rank's k local rows are made).  All
    replicas start at the same point."""
    layout = FlatLayout(params)
    row = layout.flatten(params)
    k = cfg.n_replicas if active(group) is None else group.local
    return _state_from_x(row.expand(k, -1).clone(), layout, cfg)


def init_from_replicas(replica_params, cfg) -> ParleState:
    """Start from distinct per-replica params (leading axis n)."""
    layout = FlatLayout(tree_map(lambda l: l[0], replica_params))
    x = layout.flatten(replica_params, lead=(cfg.n_replicas,))
    return _state_from_x(x, layout, cfg)


def _state_from_x(x, layout, cfg) -> ParleState:
    return ParleState(
        x=x, y=x.to(cfg.compute_dtype(), copy=True), z=x.clone(),
        v_y=torch.zeros_like(x), v_x=torch.zeros_like(x),
        step=torch.zeros((), dtype=torch.int32),
        scopes=init_scopes(cfg), layout=layout,
        e=torch.zeros_like(x) if _sync_compress(cfg) != "none" else None,
        # placeholder until the first overlapped head issues a real
        # consensus — never applied (the apply is gated on step > 0)
        c=(x.new_zeros(x.shape[-1]) if getattr(cfg, "sync_overlap", False)
           else None))


def dealias_state(state):
    """A state whose buffers are distinct: any tensor field that shares
    storage with an earlier one is copied (the updates run in place, so
    an aliased y and x would corrupt x).  A state from :func:`init` or a
    restore is returned as it is — no model-size copy.  Any of the port's
    algorithm states (Parle, Elastic-SGD, SGD) works."""
    seen, repl = set(), {}
    for f in state._fields:
        t = getattr(state, f)
        if not isinstance(t, torch.Tensor):
            continue
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
        one_minus_alpha = 1.0 - alpha
        # in place, one op at a time (each rounds as its out-of-place
        # form would): two row-sized temporaries alive at most
        for a in range(state.x.shape[0]):
            y, z, v = state.y[a], state.z[a], state.v_y[a]
            yf = y.float()                     # y itself when f32
            g_y = torch.sub(yf, state.x[a]).mul_(inv_gamma).add_(
                grads[a].float())                                   # (8a)
            v.mul_(mu).add_(g_y)                                    # Nesterov
            yf.sub_(g_y.add_(torch.mul(v, mu)).mul_(lr))            # y'
            del g_y
            z.mul_(alpha).add_(torch.mul(yf, one_minus_alpha))      # (8b)
            if yf is not y:
                y.copy_(yf)
    return state._replace(step=state.step + 1)


# ------------------------------------------------------------------
# Sync step (8c)-(8d)
# ------------------------------------------------------------------

def _reset_inner_loop(state: ParleState, cfg) -> ParleState:
    """y, z <- x' (paper: "we initialize y to x every L"), v_y <- 0, and
    the Eq. (9) scope decay.  Under bf16 the update itself wrote y' =
    bf16(x'); in f32 x' is copied into y.  Per replica row of M elements:
    2 streams for z, 2 for an f32 y and 1 for v_y."""
    state.z.copy_(state.x)
    if state.y.dtype == torch.float32:
        state.y.copy_(state.x)
    state.v_y.zero_()
    return state._replace(scopes=update_scopes(state.scopes, cfg))


def _sync_scalars(state: ParleState, cfg, lr_scale) -> dict:
    return dict(mu=cfg.momentum, lr=cfg.lr * lr_scale,
                inv_rho=1.0 / state.scopes.rho,
                gamma_scale=(1.0 if cfg.scale_lr_by_gamma
                             else 1.0 / state.scopes.gamma))


def consensus_step(state: ParleState, xbar, cfg, *,
                   use_kernel: bool = False, lr_scale=1.0,
                   payload=None) -> ParleState:
    """The Eq. (8c)-(8d) consensus update given the reduced ``xbar``
    ((M,), the replica mean), then the inner-loop reset y, z <- x',
    v_y <- 0 and the Eq. (9) scope decay.  ``payload``: instead of xbar,
    the (q, s) int8 payloads of all replicas for the fused dequantize +
    mean + update kernel K5 (``use_kernel`` only).  ``e`` and ``c`` pass
    through untouched — the caller owns them.

    Under bf16 the compute copy y' = bf16(x') is written by the update
    itself (K2's or K5's fused third output)."""
    kw = _sync_scalars(state, cfg, lr_scale)
    fused_y = state.y.dtype != torch.float32
    y_out = state.y if fused_y else None

    if use_kernel:
        from repro_torch.kernels import ops as kops
        if payload is not None:
            kops.parle_sync_dequant_update(state.x, state.z, state.v_x,
                                           *payload, y_out=y_out, **kw)
        else:
            kops.parle_sync_update(state.x, state.z, state.v_x, xbar,
                                   y_out=y_out, **kw)
    else:
        mu, inv_rho = kw["mu"], kw["inv_rho"]
        lr, gamma_scale = _f32(kw["lr"]), _f32(kw["gamma_scale"])
        # in place, one op at a time (each rounds as its out-of-place
        # form would): at most two row-sized temporaries alive
        for a in range(state.x.shape[0]):
            x, v = state.x[a], state.v_x[a]
            g_x = torch.sub(x, state.z[a]).mul_(gamma_scale)
            t = torch.sub(x, xbar).mul_(inv_rho)
            g_x.add_(t)                       # (8c): g_x
            del t
            v.mul_(mu).add_(g_x)              # v' = mu v + g_x
            g_x.add_(torch.mul(v, mu))        # g_x + mu v'
            x.sub_(g_x.mul_(lr))              # x' = x - lr (g_x + mu v')
            del g_x
            if fused_y:
                state.y[a].copy_(x)
    return _reset_inner_loop(state, cfg)


def replica_mean(x, out=None) -> torch.Tensor:
    """(n, M) -> (M,): the Eq. (8d) mean (sum, then a division by n).
    ``out``: an (M,) buffer to write it into."""
    return torch.sum(x, 0, out=out).div_(x.shape[0])


def _compress_payload(state: ParleState, method: str, use_kernel: bool):
    """Each replica's contribution c_a = x_a + e_a, formed in place in
    ``e``, quantized; ``e`` becomes the residual c_a - dequant(q_a).
    Returns the payload (q (n, M), s (n, M/1024) or None).  With
    ``use_kernel`` and int8 this is one launch of K4; otherwise the codec
    runs one replica row at a time (temporaries of one row)."""
    e = state.e
    e.add_(state.x)
    if use_kernel and method == "int8":
        from repro_torch.kernels import ops as kops
        q, s, _ = kops.quantize_ef(e, in_place=True)
        return q, s
    n, M = e.shape
    q = e.new_empty((n, M), dtype=torch.int8 if method == "int8"
                    else torch.bfloat16)
    s = e.new_empty((n, M // compress.CHUNK)) if method == "int8" else None
    for a in range(n):
        qa, sa, ea = compress.quantize_ef(e[a], method)
        q[a].copy_(qa)
        e[a].copy_(ea)
        if s is not None:
            s[a].copy_(sa)
    return q, s


def _sync_stats(state: ParleState, cfg, use_kernel: bool, out=None,
                group=None):
    """The Eq. (8d) replica mean of the (optionally compressed) ``x+e``
    payload — the reduction half of the sync, shared by the barrier sync
    and the overlapped head; updates ``e`` in place.  Returns (xbar,
    payload): with ``use_kernel`` and int8, (None, (q, s)) for K5;
    otherwise (the (M,) mean, written into ``out`` when given, None).
    Under a ``group`` the mean is over all n replicas: the local rows'
    all-reduce, or the local payloads' all-gather (the collective)."""
    group = active(group)
    method = _sync_compress(cfg)
    if method == "none":
        if group is not None:
            return group.mean_rows(state.x, out=out), None
        return replica_mean(state.x, out=out), None
    q, s = _compress_payload(state, method, use_kernel)
    if group is not None:
        q, s = compress.gather_payload(q, s, group)
    if use_kernel and method == "int8":
        return None, (q, s)
    return compress.dequantize_mean(q, s, method, out=out), None


def sync_step(state: ParleState, cfg, use_kernel: bool = False,
              lr_scale=1.0, group=None) -> ParleState:
    """(8d) with eta'' = rho/n: the reference IS the replica mean; one
    (M,) buffer (or, under K5, the payloads) shared by every replica's
    update."""
    xbar, payload = _sync_stats(state, cfg, use_kernel, group=group)
    return consensus_step(state, xbar, cfg, use_kernel=use_kernel,
                          lr_scale=lr_scale, payload=payload)


def fused_step(state: ParleState, grads, cfg, use_kernel: bool = False,
               lr_scale=1.0, group=None) -> ParleState:
    """One Parle step: inner update + conditional sync (k/L integer)."""
    state = inner_step(state, grads, cfg, use_kernel=use_kernel,
                       lr_scale=lr_scale)
    if int(state.step) % cfg.L == 0:
        state = sync_step(state, cfg, use_kernel=use_kernel,
                          lr_scale=lr_scale, group=group)
    return state


# ------------------------------------------------------------------
# Staleness-1 overlapped sync (cfg.sync_overlap): the Eq. (8d) payload is
# taken at the START of a round, before the L inner steps (which do not
# read it), and its mean is applied at the start of the NEXT round,
# carried in ParleState.c.  x only changes at a consensus, so the payload
# taken right after the apply is the barrier path's end-of-round x.
# ------------------------------------------------------------------

def overlap_head(state: ParleState, cfg, use_kernel: bool = False,
                 lr_scale=1.0, group=None) -> ParleState:
    """The overlapped round's head: (1) apply the carried consensus
    ``state.c`` (when step > 0 — the first round has nothing in flight),
    (2) compress the new x+e as the next payload, update the residual,
    and carry its mean in ``c`` (written in place).  ``lr_scale`` is the
    apply's outer-lr multiplier — schedule(step - 1), the value the
    barrier sync it replays would have used."""
    if use_kernel and _sync_compress(cfg) == "int8":
        return _overlap_head_fused(state, cfg, lr_scale, group)
    if int(state.step) > 0:
        state = consensus_step(state, state.c, cfg, use_kernel=use_kernel,
                               lr_scale=lr_scale)
    _sync_stats(state, cfg, use_kernel, out=state.c, group=group)
    return state


def _overlap_head_fused(state: ParleState, cfg, lr_scale,
                        group=None) -> ParleState:
    """The ``use_kernel`` int8 head: the consensus apply and the next
    payload's int8 quantize + EF in ONE memory pass (K6); the first round
    (nothing in flight) quantizes the initial x + e with K4.  Under a
    ``group`` the local payloads are gathered before the mean."""
    from repro_torch.kernels import ops as kops
    if int(state.step) > 0:
        _, _, _, q, s, _ = kops.parle_apply_consensus_quantize(
            state.x, state.z, state.v_x, state.c, state.e,
            y_out=state.y if state.y.dtype != torch.float32 else None,
            **_sync_scalars(state, cfg, lr_scale))
        state = _reset_inner_loop(state, cfg)
    else:
        q, s = _compress_payload(state, "int8", use_kernel=True)
    if active(group) is not None:
        q, s = compress.gather_payload(q, s, group)
    compress.dequantize_mean(q, s, "int8", out=state.c)
    return state


def make_flush_fn(cfg, lr_schedule=None):
    """flush(state) -> state: apply the still-in-flight consensus after
    the LAST overlapped round, completing the rotation — the flushed
    state equals the barrier trajectory's.  A never-run state (step 0)
    flushes to itself.  Always the plain apply, as in the reference.

    Call it exactly once, on the state about to be evaluated or
    deployed; checkpoints written at round boundaries stay PRE-flush, so
    a resumed run continues the overlapped trajectory exactly."""

    def flush(state: ParleState) -> ParleState:
        if int(state.step) == 0:
            return state
        return consensus_step(state, state.c, cfg,
                              lr_scale=schedule_scale(lr_schedule,
                                                      state.step - 1))

    return flush


# ------------------------------------------------------------------
# Train-step factory
# ------------------------------------------------------------------

def replica_grads(loss_fn: Callable, layout: FlatLayout, rows, batch, out,
                  weight_decay: float = 0.0, decay_rows=None) -> torch.Tensor:
    """Replica a's grad of ``loss_fn`` at the params of ``rows[a]`` (an
    (M,) row; the rows of an (n, M) buffer are views, so no copy) on row
    a of ``batch`` (leaves with the leading replica axis), plus
    ``weight_decay * decay_rows[a]`` when ``weight_decay`` is set.  ``out``
    is an (n, M) buffer that receives each grad in its row, or an (M,)
    buffer that receives their sum; the gaps between its leaves must be
    zero (``GradBuffer`` makes them so) and stay untouched.  Each leaf's
    grad is written into ``out`` as autograd hands it back, so no
    row-shaped grad is ever made beside ``out``.  Returns the (n,)
    losses."""
    losses = []
    for a, r in enumerate(rows):
        row = r.detach().requires_grad_(True)
        params, leaves = layout.split_leaves(row)
        loss, _ = loss_fn(params, {k: v[a] for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        dst = layout.views(out[a] if out.dim() == 2 else out)
        decay = layout.views(decay_rows[a]) if weight_decay else None
        for i, (d, g) in enumerate(zip(dst, grads)):
            if g is None:                     # a leaf the loss never read
                g = torch.zeros_like(leaves[i])
            if weight_decay:
                g = g + weight_decay * decay[i]
            if out.dim() == 2 or a == 0:
                d.copy_(g)
            else:
                d.add_(g)
        del grads, g
        losses.append(loss.detach())
    return torch.stack(losses)


class GradBuffer:
    """The grad buffer of a step/round factory, allocated (zero, so the
    gaps between leaves stay zero) at its first use and reused by every
    later step."""

    def __init__(self):
        self.buf = None

    def like(self, t, dtype=None) -> torch.Tensor:
        """A buffer of ``t``'s shape and device, and of ``dtype`` (default
        ``t``'s)."""
        dtype = dtype or t.dtype
        if (self.buf is None or self.buf.shape != t.shape
                or self.buf.dtype != dtype or self.buf.device != t.device):
            self.buf = torch.zeros_like(t, dtype=dtype)
        return self.buf


def schedule_scale(lr_schedule, step):
    """The lr multiplier at ``step`` (1.0 without a schedule)."""
    return lr_schedule(step) if lr_schedule is not None else 1.0


def _make_step_body(loss_fn: Callable, cfg, weight_decay, use_kernel,
                    lr_schedule, group=None):
    """The step of :func:`make_train_step`; under an active ``group`` it
    emits its k local losses as ``local_loss_per_replica`` (the sharded
    wrapper gathers them)."""
    _sync_compress(cfg)
    gbuf = GradBuffer()
    group = active(group)

    def step(state: ParleState, batch):
        losses = _grads_at_y(loss_fn, state, batch, gbuf, weight_decay)
        new_state = fused_step(state, gbuf.buf, cfg, use_kernel=use_kernel,
                               lr_scale=schedule_scale(lr_schedule,
                                                       state.step),
                               group=group)
        if group is None:
            metrics = {"loss": losses.mean(), "loss_per_replica": losses}
        else:
            metrics = {"local_loss_per_replica": losses}
        return new_state, dict(metrics, gamma=new_state.scopes.gamma,
                               rho=new_state.scopes.rho,
                               step=new_state.step)

    return step


def make_train_step(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                    use_kernel: bool = False, lr_schedule=None):
    """loss_fn(params, batch) -> (scalar, aux).  Returns

        step(state, batch) -> (state, metrics)

    where ``batch`` leaves carry a leading replica axis of size n.
    ``lr_schedule``: step -> multiplier on BOTH cfg.lr and cfg.lr_inner.
    The step consumes ``state`` (its buffers are updated in place)."""
    return _make_step_body(loss_fn, cfg, weight_decay, use_kernel,
                           lr_schedule)


def make_sharded_train_step(loss_fn: Callable, cfg, group,
                            weight_decay: float = 0.0,
                            use_kernel: bool = False, lr_schedule=None):
    """Distributed variant of :func:`make_train_step` over the ranks of
    ``group`` (a ``ReplicaGroup``): the state (from ``init(..., group)``)
    and the batch hold the rank's k local replicas.  The inner steps make
    no collective; the sync's replica mean is one all-reduce of the model
    size (or one all-gather of the compressed payloads); the per-replica
    losses are gathered each step into the global (n,)
    ``loss_per_replica`` and its mean ``loss``."""
    return make_sharded_step_fn(
        _make_step_body(loss_fn, cfg, weight_decay, use_kernel, lr_schedule,
                        group), group, cfg.n_replicas)


def _grads_at_y(loss_fn, state: ParleState, batch, gbuf, weight_decay):
    """grad f(y^a) of every replica into the (n, M) buffer of ``gbuf``;
    returns the (n,) losses."""
    return replica_grads(loss_fn, state.layout, state.y, batch,
                         gbuf.like(state.y), weight_decay, state.y)


def _round_entry(state: ParleState, cfg):
    if int(state.step) % cfg.L:
        raise ValueError(f"a round starts at a multiple of L={cfg.L}, "
                         f"not at step {int(state.step)}")


def _inner_steps(loss_fn, state: ParleState, batches, cfg, gbuf,
                 weight_decay, use_kernel, lr_schedule, group=None):
    """The round's L inner steps (8a-8b); returns (state, (L,) losses).
    Under an active ``group`` each step keeps its k local losses, and
    one gather after the L steps makes the means over all n."""
    step_losses = []
    for i in range(cfg.L):
        losses = _grads_at_y(loss_fn, state,
                             {k: v[i] for k, v in batches.items()}, gbuf,
                             weight_decay)
        state = inner_step(state, gbuf.buf, cfg, use_kernel=use_kernel,
                           lr_scale=schedule_scale(lr_schedule, state.step))
        step_losses.append(losses if group is not None else losses.mean())
    if group is not None:
        return state, group.replica_means(torch.stack(step_losses, 1))
    return state, torch.stack(step_losses)


def _round_metrics(state: ParleState, losses) -> dict:
    return {"loss": losses.mean(), "losses": losses,
            "gamma": state.scopes.gamma, "rho": state.scopes.rho,
            "step": state.step}


def make_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                  use_kernel: bool = False, lr_schedule=None, group=None):
    """One whole Parle round per call: the L = cfg.L inner steps (8a-8b)
    followed by the sync (8c-8d) — Python enters once per round, and no
    per-step ``k % L`` test sits in the loop.

    Contract: ``batches`` leaves carry a leading round axis of length
    cfg.L (then the replica axis); the state's step counter must be a
    multiple of L on entry.  Under those invariants the result equals L
    calls of the train step bit for bit: the per-step lr_scale is taken
    at the same counters, and the sync uses the lr_scale of the round's
    last inner step (schedule(step - 1)).  Metrics: the round-mean
    ``loss`` plus the per-step ``losses`` (L,).  ``group``: see
    :func:`make_sharded_round_fn`."""
    _sync_compress(cfg)
    gbuf = GradBuffer()
    group = active(group)

    def round_fn(state: ParleState, batches):
        _round_entry(state, cfg)
        state, losses = _inner_steps(loss_fn, state, batches, cfg, gbuf,
                                     weight_decay, use_kernel, lr_schedule,
                                     group)
        state = sync_step(state, cfg, use_kernel=use_kernel,
                          lr_scale=schedule_scale(lr_schedule,
                                                  state.step - 1),
                          group=group)
        return state, _round_metrics(state, losses)

    return round_fn


def make_sharded_round_fn(loss_fn: Callable, cfg, group,
                          weight_decay: float = 0.0,
                          use_kernel: bool = False, lr_schedule=None):
    """Distributed fused round over the ranks of ``group``: the L inner
    steps on the rank's k rows with no collective, then the sync — one
    model-size all-reduce of the local row sums (or one all-gather of the
    compressed payloads) — and one gather of the (k, L) step losses.
    With one replica a rank it equals the single-process round bit for
    bit; with more, the sync mean sums the rows in another grouping
    (ulps), as the reference's pmean of local means does."""
    check_divisible(cfg.n_replicas, group.world, group.axis)
    return make_round_fn(loss_fn, cfg, weight_decay, use_kernel, lr_schedule,
                         group=group)


def make_overlap_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                          use_kernel: bool = False, lr_schedule=None,
                          group=None):
    """One staleness-1 overlapped round per call: :func:`overlap_head`
    (apply the carried consensus, take this round's payload) then the L
    inner steps.  Same entry invariants and metrics as
    :func:`make_round_fn`; the per-step losses equal the barrier round's
    (the inner steps start from the same post-consensus state), and the
    state trails it by exactly the in-flight ``c`` (see
    :func:`make_flush_fn`)."""
    _sync_compress(cfg)
    gbuf = GradBuffer()
    group = active(group)

    def round_fn(state: ParleState, batches):
        _round_entry(state, cfg)
        state = overlap_head(state, cfg, use_kernel=use_kernel,
                             lr_scale=schedule_scale(lr_schedule,
                                                     state.step - 1),
                             group=group)
        state, losses = _inner_steps(loss_fn, state, batches, cfg, gbuf,
                                     weight_decay, use_kernel, lr_schedule,
                                     group)
        return state, _round_metrics(state, losses)

    return round_fn


def make_sharded_overlap_round_fn(loss_fn: Callable, cfg, group,
                                  weight_decay: float = 0.0,
                                  use_kernel: bool = False,
                                  lr_schedule=None):
    """Distributed overlapped round: the head's collective (the
    all-reduce, or the payload all-gather) comes first, then the L inner
    steps; the carried ``c`` is the same on every rank, and
    :func:`make_flush_fn` needs no collective."""
    check_divisible(cfg.n_replicas, group.world, group.axis)
    return make_overlap_round_fn(loss_fn, cfg, weight_decay, use_kernel,
                                 lr_schedule, group=group)


# ------------------------------------------------------------------
# Asynchronous / elastic consensus (the runtime "async" sync policy):
# each worker runs rounds at its own pace, pushes its (optionally
# quantized) x+e contribution to a host-side coordinator when ITS round
# ends, and pulls back a staleness-weighted mean — no barrier.  The math
# halves are here; the wire/coordination halves are in
# runtime/coordinator.py.  The coordinator's half runs in numpy on the
# host, in the reference's operation order, so a consensus is the
# reference's bit for bit for the same contributions.
# ------------------------------------------------------------------

def staleness_weighted_mean(means, counts, rounds, decay=0.5):
    """The async Eq. (8d): a staleness-weighted average of per-worker
    replica means.  ``means``: one list of flat f32 numpy vectors per
    worker (its ``counts[a]`` replicas' mean, leaf by leaf); ``rounds``:
    each worker's completed-round index.  A worker ``r_max - r_a``
    rounds behind the freshest weighs

        w_a = counts[a] * decay ** (r_max - r_a)
        xbar = sum_a w_a * mean_a / sum_a w_a

    With every worker at one round this is the count-weighted mean (the
    barrier path's replica mean); a single worker's consensus is its own
    mean, returned untouched (no float round trip)."""
    if not means:
        raise ValueError("staleness_weighted_mean of zero contributions")
    if len(means) == 1:
        return means[0]
    r_max = max(rounds)
    ws = [float(c) * float(decay) ** (r_max - r)
          for c, r in zip(counts, rounds)]
    tot = sum(ws)

    def leaf(*vals):
        # the reference's operations in its order, in place (the same
        # roundings): one model-size accumulator, not one per operation
        acc = ws[0] * vals[0]
        for w, v in zip(ws[1:], vals[1:]):
            acc += w * v
        acc /= tot
        return acc.astype(vals[0].dtype, copy=False)

    return [leaf(*vals) for vals in zip(*means)]


def contribution_norm(means) -> float:
    """L2 norm of a worker's dequantized contribution (flat per-leaf
    vectors), accumulated in float64 on the host.  NaN/Inf anywhere
    propagates into the result — the quarantine keys off exactly that."""
    total = 0.0
    for v in means:
        a = np.asarray(v, np.float64).ravel()
        total += float(np.dot(a, a))
    return float(np.sqrt(total))


def should_quarantine(norm: float, trailing, k: float = 10.0,
                      min_history: int = 3):
    """Poisoned-update gate at the coordinator's ingest: quarantine a
    contribution whose norm is non-finite, or, once ``min_history``
    accepted contributions make a baseline, more than ``k`` x the
    trailing median norm (a diverged-but-finite replica).  Returns
    ``(quarantine, reason)``; a quarantined norm never enters the
    trailing window."""
    if not np.isfinite(norm):
        return True, "nonfinite"
    hist = list(trailing)
    if len(hist) >= min_history:
        med = float(np.median(np.asarray(hist, np.float64)))
        if med > 0.0 and norm > k * med:
            return True, (f"norm {norm:.3e} exceeds {k:g}x trailing "
                          f"median {med:.3e}")
    return False, ""


def reseed_from_consensus(state: ParleState, xbar) -> ParleState:
    """Recovery of a quarantined worker: every local replica restarts
    from the consensus ``xbar`` ((M,), :func:`consensus_from_flat`) — x,
    y and z become xbar (written in place, so they stay distinct
    buffers), both momenta and the residual ``e`` zero; ``step`` and the
    scopes are kept, so the annealing schedule is undisturbed."""
    for f in ("x", "y", "z"):
        getattr(state, f).copy_(xbar.expand_as(state.x))
    for f in ("v_y", "v_x", "e"):
        if getattr(state, f) is not None:
            getattr(state, f).zero_()
    return state


def make_inner_round_fn(loss_fn: Callable, cfg, weight_decay: float = 0.0,
                        use_kernel: bool = False, lr_schedule=None):
    """The async round's compute half: the L = cfg.L inner steps (8a-8b)
    with NO sync (each a launch of K1 with ``use_kernel``); the worker
    then pushes :func:`async_contribution` to the coordinator and applies
    the consensus it gets back with :func:`make_async_apply_fn`.  Entry
    invariants and metrics as :func:`make_round_fn`; x only changes at
    the consensus apply, so the payload is the same whether taken before
    or after the inner steps."""
    _sync_compress(cfg)
    gbuf = GradBuffer()

    def round_fn(state: ParleState, batches):
        _round_entry(state, cfg)
        state, losses = _inner_steps(loss_fn, state, batches, cfg, gbuf,
                                     weight_decay, use_kernel, lr_schedule)
        return state, _round_metrics(state, losses)

    return round_fn


def _host(t) -> np.ndarray:
    """A contiguous CPU copy of ``t`` (never a view of it) as numpy; bf16
    as its uint16 bit patterns."""
    t = torch.empty(t.shape, dtype=t.dtype).copy_(t)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def async_contribution(state: ParleState, cfg):
    """The async worker's push payload: each LOCAL replica's sync
    contribution ``c_a = x_a + e_a``, compressed per ``cfg.sync_compress``
    with the plain codec (``core/compress.py``), as the barrier sync
    compresses it, so the wire carries the quantized bytes.

    Returns ``(payload, e_new)``.  ``payload`` is a list in the
    reference's leaf order (``tree_flatten`` of x: the layout's sorted
    paths) of ``{"q": (r, M_leaf) ndarray, "scales": ndarray | None}`` on
    the host: for "none" the leaf's f32 values, unpadded; for bf16 /
    int8 its codes padded to the 8192-element chunk edge (the layout's
    gap), bf16 as uint16 bit patterns, int8 with one f32 scale a 1024
    chunk.  ``e_new`` is the refreshed residual — ``state.e``, written
    in place — or None without compression.  The leaves come out of the
    flat buffers at ``layout.offsets``; a leaf's padded span there is the
    reference's padded leaf (zeros in the gap), so the payload is the
    reference's bit for bit."""
    method = _sync_compress(cfg)
    lay = state.layout
    if method == "none":
        return [{"q": _host(state.x[:, o:o + n]), "scales": None}
                for o, n in zip(lay.offsets, lay.sizes)], None
    e = state.e
    e.add_(state.x)                        # c = x + e, in place
    payload = []
    for o, n in zip(lay.offsets, lay.sizes):
        # leaf by leaf, as the reference pads and quantizes: the codec's
        # temporaries stay a leaf's size
        padded = -(-n // compress.PAD_MULTIPLE) * compress.PAD_MULTIPLE
        c = e[:, o:o + padded]
        q, s, res = compress.quantize_ef(c, method)
        c.copy_(res)
        payload.append({"q": _host(q),
                        "scales": None if s is None else _host(s)})
    return payload, e


def consensus_from_flat(vectors, like: ParleState) -> torch.Tensor:
    """The (M,) f32 consensus row on ``like``'s device from the
    coordinator's flat vectors (one per leaf of the layout, in its
    order; each may carry codec padding past the leaf's size, which is
    trimmed), zeros in the layout's gaps."""
    lay = like.layout
    out = torch.zeros(lay.numel, dtype=torch.float32, device=like.x.device)
    for v, o, n in zip(vectors, lay.offsets, lay.sizes):
        leaf = np.require(np.asarray(v)[:n], np.float32, ["C", "W"])
        out[o:o + n].copy_(torch.from_numpy(leaf))
    return out


def make_async_apply_fn(cfg, lr_schedule=None):
    """``apply(state, xbar) -> state``: the Eq. (8c)-(8d) consensus update
    against a coordinator-supplied staleness-weighted mean (an (M,) row),
    at the outer-lr scale the barrier sync would use (schedule(step -
    1)).  The plain update, as in the reference (no kernel); ``e`` passes
    through (:func:`async_contribution` refreshed it in place)."""

    def apply(state: ParleState, xbar) -> ParleState:
        return consensus_step(state, xbar, cfg,
                              lr_scale=schedule_scale(lr_schedule,
                                                      state.step - 1))

    return apply


def average_model(state: ParleState, group=None) -> dict:
    """The deployable single model: mean of replicas (what the paper
    evaluates after scoping collapses the ensemble); under a ``group``,
    of all n (one all-reduce)."""
    if active(group) is not None:
        return state.layout.tree(group.mean_rows(state.x))
    return state.layout.tree(replica_mean(state.x))


def replica_model(state: ParleState, a: int) -> dict:
    return state.layout.tree(state.x[a])
