"""Mixture-of-experts MLP with top-k token-choice routing.

Port of ``repro/models/moe.py``: the router's softmax picks ``top_k``
experts a token, the routed slots are sorted by expert (stable, so ties
keep token order), each expert's bucket takes its first ``C`` slots
(``_capacity``, a host integer from the shapes), the (E, C, d) buffer
goes through one batched SwiGLU, and each token sums its kept experts'
outputs times their renormalised gates.  A switch-transformer
load-balance loss (weight ``cfg.router_aux_weight``) comes back beside
the output; it is batch-global in every dispatch (the mean router
probability and the top-1 fraction over all of ``x``'s tokens).

Three dispatches share one core (:func:`_dispatch`), as the reference's
three functions do:

* the flat dispatch (``_moe_forward_flat``): every token of ``x`` in one
  group, capacity ``_capacity(B T)``;
* the grouped dispatch (``cfg.moe_groups`` = G > 1,
  :func:`moe_forward_grouped`): the B·T tokens split into G contiguous
  groups, each with its own stable sort, its own capacity
  ``_capacity(B T / G)`` and its own dump row.  It equals the flat
  dispatch only where nothing is dropped.  The reference's sharding
  constraints on each stage have no eager meaning and are dropped;
* the expert-parallel dispatch (``cfg.moe_impl == "shard_map"`` under an
  :func:`expert_parallel` context, :func:`moe_forward_shard_map`):
  column m of M computes the experts ``split(E, M, m)`` (the reference's
  [m E/M, (m+1) E/M) where M divides E) at ``_capacity(B T)``, slots of
  the other columns' experts go to a dump bucket, the shared expert's ff
  dimension is split over the columns the same way, and the column's
  partial output is summed over the context's "model" ranks
  (``MeshGroups.model_sum_``, counted as ``pod.collective_bytes{op=
  "all_reduce", axis="model"}``).  Each expert's bucket keeps the flat
  dispatch's token order, so the M columns sum to the flat dispatch at
  any capacity, up to the order of that sum.  Without a group the
  column's partial comes back as it is (the dry run counts one column;
  tests sum M of them).  A backward through the sum across ranks
  raises: the grads of a product split over "model" are the Megatron
  half of ROADMAP.md queue 1 item 6a.  With no context set, the
  shard_map setting takes the grouped or flat dispatch, as the
  reference does when its ambient mesh is None.

The reference scatters tokens into the buffer and scatter-adds the
results back.  Here both directions are gathers: buffer row (e, c) reads
the token of sorted slot ``starts[e] + c``, and each routing reads its
row back through the inverse of the sort, so the combine is a sum over
the ``top_k`` axis.  Every step is a gather, a sort or an elementwise
op: nothing reads a count on the host (no ``bincount``, no boolean
indexing, no ``.item()``), and the backward is deterministic under
``torch.use_deterministic_algorithms``.  The routed products are plain
``torch.einsum`` calls: the reference computes them outside any Pallas
kernel.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.models.layers import dense_init, silu

MEGATRON_BACKWARD = (
    "a backward through the expert-parallel MoE's sum over the 'model' "
    "ranks is not ported yet: the grads of a product split over 'model' "
    "come with the Megatron half of ROADMAP.md queue 1, item 6a (the "
    "forward across ranks works)")


def init_moe_params(generator, cfg, dtype=torch.float32, layers=()):
    """Router, routed experts (E, d, ff) / (E, ff, d) and the optional
    shared expert; ``layers=(L,)`` draws them stacked over L layers."""
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    lead = tuple(layers)
    p = {
        "router": dense_init(generator, lead + (d, E), dtype=dtype),
        "w_gate": dense_init(generator, lead + (E, d, ff), dtype=dtype),
        "w_up": dense_init(generator, lead + (E, d, ff), dtype=dtype),
        "w_down": dense_init(generator, lead + (E, ff, d), dtype=dtype),
    }
    if cfg.num_shared_experts > 0:
        sff = cfg.shared_expert_d_ff
        p["shared"] = {
            "w_gate": dense_init(generator, lead + (d, sff), dtype=dtype),
            "w_up": dense_init(generator, lead + (d, sff), dtype=dtype),
            "w_down": dense_init(generator, lead + (sff, d), dtype=dtype),
        }
    return p


def _capacity(num_tokens: int, cfg) -> int:
    c = int(num_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)   # pad to a multiple of 8


def split(size: int, parts: int, index: int):
    """[lo, hi) of part ``index`` of ``size`` items in ``parts`` nearly
    equal parts, the first ``size % parts`` one larger."""
    base, extra = divmod(size, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


@dataclass(frozen=True)
class ExpertParallel:
    """Where the expert-parallel dispatch runs: column ``column`` of
    ``columns`` (the "model" axis), and ``group``, the ``MeshGroups``
    whose "model" ranks hold the other columns (None: the column's
    partial output is returned unsummed)."""

    columns: int
    column: int
    group: Optional[object] = None

    def experts(self, num_experts: int):
        """[lo, hi) of the column's experts."""
        return split(num_experts, self.columns, self.column)


_EXPERT_PARALLEL = contextvars.ContextVar("expert_parallel", default=None)


@contextlib.contextmanager
def expert_parallel(ep: ExpertParallel):
    """Run the ``moe_impl == "shard_map"`` MoE blocks called inside as
    column ``ep.column`` of ``ep.columns``."""
    if not 0 <= ep.column < ep.columns:
        raise ValueError(f"column {ep.column} of {ep.columns}")
    token = _EXPERT_PARALLEL.set(ep)
    try:
        yield ep
    finally:
        _EXPERT_PARALLEL.reset(token)


def route(params, cfg, xf):
    """Router of ``xf`` (T, d): (probs (T, E) float32, renormalised gate
    values (T, K), expert ids (T, K) int64), the top-k in descending
    probability."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_ids


def _aux(cfg, probs, expert_ids):
    """Switch-style load-balance loss over all tokens: mean router prob x
    fraction routed (top-1)."""
    E = cfg.num_experts
    experts = torch.arange(E, device=probs.device)
    top1 = (expert_ids[:, :1] == experts).to(probs.dtype)      # (T, E)
    return cfg.router_aux_weight * E * torch.sum(probs.mean(0) * top1.mean(0))


def _dispatch(experts, cfg, xf, expert_ids, gate_vals, groups: int,
              lo: int, C: int):
    """The routed output (T, d) of ``xf`` (T, d) through the expert stack
    ``experts`` (its w_gate / w_up / w_down: experts [lo, lo + n) of the
    E), with the T tokens in ``groups`` contiguous groups, each sorted
    and bucketed on its own at capacity ``C``.  Routings to an expert
    outside the stack go to a dump bucket sorted last, and are dropped."""
    Tflat, d = xf.shape
    G, K = groups, cfg.top_k
    n = experts["w_gate"].shape[0]
    Tg = Tflat // G
    S = Tg * K
    dev = xf.device

    # ---- sort-based dispatch, per group -----------------------------
    local = expert_ids.reshape(G, S) - lo
    mine = (local >= 0) & (local < n)
    local = torch.where(mine, local, n)                       # dump bucket
    order = torch.argsort(local, dim=1, stable=True)
    inv = torch.argsort(order, dim=1)                         # sorted slot
    buckets = torch.arange(n + 1, device=dev)
    counts = (local[..., None] == buckets).sum(1)             # (G, n + 1)
    # exclusive prefix sum of the counts, as a masked sum (no cumsum)
    starts = (counts[:, None, :]
              * (buckets[None, None, :] < buckets[None, :, None])).sum(2)
    pos = inv - torch.gather(starts, 1, local)                # in its bucket
    keep = mine & (pos < C)

    # buffer row (g, e, c) <- the token of sorted slot starts[g, e] + c
    c_idx = torch.arange(C, device=dev)
    src = torch.clamp(starts[:, :n, None] + c_idx, max=S - 1)   # (G, n, C)
    live = c_idx < counts[:, :n, None]
    tok = torch.gather(order, 1, src.reshape(G, n * C)).reshape(G, n, C)
    tok = tok // K + (torch.arange(G, device=dev) * Tg)[:, None, None]
    eb = torch.where(live[..., None], xf[tok],
                     torch.zeros((), dtype=xf.dtype, device=dev))

    # ---- expert computation (batched SwiGLU) -----------------------
    g = torch.einsum("gecd,edf->gecf", eb, experts["w_gate"])
    u = torch.einsum("gecd,edf->gecf", eb, experts["w_up"])
    out = torch.einsum("gecf,efd->gecd", silu(g) * u,
                       experts["w_down"]).reshape(G * n * C, d)

    # ---- combine: each routing reads its row back ------------------
    row = (torch.clamp(local * C + pos, max=n * C - 1)
           + (torch.arange(G, device=dev) * (n * C))[:, None])
    w = (gate_vals.reshape(G, S) * keep).to(xf.dtype)
    return (out[row] * w[..., None]).reshape(Tflat, K, d).sum(1)


def _shared(sp, xf):
    return (silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]


def moe_forward(params, cfg, x):
    """x: (B, T, d) -> (B, T, d), aux_loss scalar.  The expert-parallel
    dispatch under ``cfg.moe_impl == "shard_map"`` and an
    :func:`expert_parallel` context, else the grouped dispatch when
    ``cfg.moe_groups`` > 1, else the flat one."""
    ep = _EXPERT_PARALLEL.get()
    if cfg.moe_impl == "shard_map" and ep is not None:
        return moe_forward_shard_map(params, cfg, x, ep)
    if cfg.moe_groups > 1:
        return moe_forward_grouped(params, cfg, x)
    return _moe_forward_flat(params, cfg, x)


def _moe_forward_flat(params, cfg, x):
    return _forward(params, cfg, x, 1)


def moe_forward_grouped(params, cfg, x):
    """The grouped dispatch: ``cfg.moe_groups`` groups of B·T / G
    tokens, each bucketed at ``_capacity(B T / G)``."""
    B, T, _ = x.shape
    if (B * T) % cfg.moe_groups:
        raise ValueError(f"{B * T} tokens do not split into "
                         f"moe_groups={cfg.moe_groups} groups")
    return _forward(params, cfg, x, cfg.moe_groups)


def _forward(params, cfg, x, groups: int):
    B, T, d = x.shape
    xf = x.reshape(B * T, d)
    probs, gate_vals, expert_ids = route(params, cfg, xf)
    aux = _aux(cfg, probs, expert_ids)
    y = _dispatch(params, cfg, xf, expert_ids, gate_vals, groups, 0,
                  _capacity(B * T // groups, cfg))
    if cfg.num_shared_experts > 0:
        y = y + _shared(params["shared"], xf)
    return y.reshape(B, T, d), aux


def _column(stack, full: int, lo: int, hi: int, dim: int):
    """A column's slice [lo, hi) along ``dim`` of ``stack``: the whole
    of ``full`` items is sliced, the column's own ``hi - lo`` pass."""
    size = stack.shape[dim]
    if size == full:
        return stack.narrow(dim, lo, hi - lo)
    if size == hi - lo:
        return stack
    raise ValueError(f"an expert-parallel column [{lo}, {hi}) of {full} "
                     f"takes {full} or {hi - lo} along dim {dim}, not "
                     f"{size}")


def moe_forward_shard_map(params, cfg, x, ep: ExpertParallel):
    """Column ``ep.column`` of the expert-parallel dispatch: x (B, T, d)
    -> (its partial summed over ``ep.group``'s "model" ranks, or the
    partial alone without a group), aux_loss.  ``params`` hold every
    expert (and the whole shared ff), or only the column's own."""
    B, T, d = x.shape
    E = cfg.num_experts
    if ep.columns > E:
        raise ValueError(f"{ep.columns} expert-parallel columns for "
                         f"{E} experts")
    lo, hi = ep.experts(E)
    xf = x.reshape(B * T, d)
    probs, gate_vals, expert_ids = route(params, cfg, xf)
    aux = _aux(cfg, probs, expert_ids)
    experts = {k: _column(params[k], E, lo, hi, 0)
               for k in ("w_gate", "w_up", "w_down")}
    y = _dispatch(experts, cfg, xf, expert_ids, gate_vals, 1, lo,
                  _capacity(B * T, cfg))
    if cfg.num_shared_experts > 0:
        sp = params["shared"]
        sff = cfg.shared_expert_d_ff
        flo, fhi = split(sff, ep.columns, ep.column)
        y = y + _shared({"w_gate": _column(sp["w_gate"], sff, flo, fhi, 1),
                         "w_up": _column(sp["w_up"], sff, flo, fhi, 1),
                         "w_down": _column(sp["w_down"], sff, flo, fhi, 0)},
                        xf)
    if ep.group is not None:
        y = _ModelSum.apply(y, ep.group)
    return y.reshape(B, T, d), aux


class _ModelSum(torch.autograd.Function):
    """The one collective of the expert-parallel dispatch: the columns'
    partial outputs summed over the "model" ranks.  Forward only."""

    @staticmethod
    def forward(ctx, partial, group):
        return group.model_sum_(partial.clone())

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(MEGATRON_BACKWARD)
