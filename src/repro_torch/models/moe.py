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
* the expert-parallel dispatch (``cfg.moe_impl == "shard_map"`` under
  ``models/megatron.py``'s tensor-parallel context,
  :func:`moe_forward_split`): column m of M computes the experts
  ``split(E, M, m)`` (the reference's [m E/M, (m+1) E/M) where M divides
  E) at ``_capacity(B T)``, slots of the other columns' experts go to a
  dump bucket, the shared expert's ff dimension is split over the
  columns the same way, and the column's partial output is summed over
  the context's "model" ranks (``MeshGroups.reduce_from_model``, counted
  as ``pod.collective_bytes{op="all_reduce", axis="model"}``; the tokens
  and gates enter through ``copy_to_model``, so a backward sums their
  grads over the ranks).  Each expert's bucket keeps the flat
  dispatch's token order, so the M columns sum to the flat dispatch at
  any capacity, up to the order of that sum.  Without a group the
  column's partial comes back as it is (the dry run counts one column;
  tests sum M of them).  With no context set, the shard_map setting
  takes the grouped or flat dispatch, as the reference does when its
  ambient mesh is None.

The training step under a mesh runs :func:`moe_forward_split` under the
same context: the columns where M divides E (any M under shard_map),
and on a "data" axis the batch's ONE flat dispatch — the capacity of
all the batch's tokens, each rank's slots placed after those of the
ranks before it, the aux loss batch-global — exactly as the
reference's flat dispatch runs on the global batch under pjit.  Each
rank's expert buffer is sized at that global capacity (at most its own
slots, ``min(C, S)``), so at D "data" ranks it computes up to D times
the rows it can fill (ROADMAP.md item 6g).

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

import torch

from repro_torch.models import megatron
from repro_torch.models.layers import dense_init, silu


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


def _aux(cfg, probs, expert_ids, top1=None):
    """Switch-style load-balance loss over all tokens: mean router prob x
    fraction routed (top-1).  ``top1``: the (E,) top-1 fractions of the
    whole batch where ``probs`` holds only this rank's rows (its mean
    router probabilities carry the grad; the data ranks' mean of this
    aux is the batch's)."""
    E = cfg.num_experts
    if top1 is None:
        experts = torch.arange(E, device=probs.device)
        top1 = (expert_ids[:, :1] == experts).to(probs.dtype).mean(0)
    return cfg.router_aux_weight * E * torch.sum(probs.mean(0) * top1)


def _dispatch(experts, cfg, xf, expert_ids, gate_vals, groups: int,
              lo: int, C: int, before=None):
    """The routed output (T, d) of ``xf`` (T, d) through the expert stack
    ``experts`` (its w_gate / w_up / w_down: experts [lo, lo + n) of the
    E), with the T tokens in ``groups`` contiguous groups, each sorted
    and bucketed on its own at capacity ``C``.  Routings to an expert
    outside the stack go to a dump bucket sorted last, and are dropped.

    ``before`` (n,): the routed slots of tokens on the ranks before this
    one in each expert's bucket (one group; ``xf`` the rank's tokens of a
    batch split over "data"): a slot's place in its bucket is counted
    from there, so tokens drop where the batch's one dispatch drops
    them."""
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
    if before is None:
        keep = mine & (pos < C)
    else:
        ahead = torch.cat([before, before.new_zeros(1)])[local]
        keep = mine & (pos + ahead < C)
        C = min(C, S)              # a rank's buffer holds its kept slots

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
    """x: (B, T, d) -> (B, T, d), aux_loss scalar.  Under a
    tensor-parallel context (``models/megatron.py``: the training step
    under a mesh, the expert-parallel dispatch), the split dispatch
    (:func:`moe_forward_split`); else the grouped dispatch when
    ``cfg.moe_groups`` > 1, else the flat one."""
    tp = megatron.context()
    if tp is not None:
        return moe_forward_split(params, cfg, x, tp)
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


def moe_forward_split(params, cfg, x, tp):
    """The MoE under a tensor-parallel context ``tp``, the batch's one
    dispatch (flat, or grouped under ``cfg.moe_groups``; one group under
    ``cfg.moe_impl == "shard_map"``), in two ways:

    * over "model": the rank computes its E/M experts and its 1/M of the
      shared expert's ff where M divides them (under shard_map, balanced
      parts where it does not), the rest whole; the router runs whole on
      every rank.  ``params`` hold every expert (and the whole shared
      ff), or only the column's own;
    * over "data" (``tp.data`` ranks, each with a contiguous slice of the
      batch's rows): the flat dispatch at the capacity of the whole
      batch's tokens, each routed slot placed in its expert's bucket
      after the slots of the ranks before it (one all-gather over "data"
      a layer of the (E,) slot counts, with the (E,) top-1 counts of the
      aux loss); the grouped dispatch's groups each lie on one rank.

    The split parts take the tokens and the gates through ``tp.copy``
    and their partial sums leave through ``tp.reduce``, so the router's
    grads are whole on every rank."""
    M = tp.columns
    if cfg.moe_impl == "shard_map" and M > cfg.num_experts:
        raise ValueError(f"{M} expert-parallel columns for "
                         f"{cfg.num_experts} experts")
    groups = 1 if cfg.moe_impl == "shard_map" else max(cfg.moe_groups, 1)
    if tp.data > 1 and groups > 1:
        if groups % tp.data:
            raise ValueError(f"moe_groups={groups} groups do not split "
                             f"over {tp.data} data ranks")
        groups //= tp.data
    split_experts = megatron.splits_experts(cfg, M)
    split_shared = megatron.splits_shared(cfg, M)
    B, T, d = x.shape
    E = cfg.num_experts
    xf = x.reshape(B * T, d)
    probs, gate_vals, expert_ids = route(params, cfg, xf)
    lo, hi = tp.part(E) if split_experts else (0, E)
    top1 = before = None
    tokens = B * T              # the tokens of one capacity's bucket
    if tp.data > 1:
        ids = torch.arange(E, device=x.device)
        counts = torch.stack([
            (expert_ids.reshape(-1)[:, None] == ids).sum(0),
            (expert_ids[:, 0][:, None] == ids).sum(0)])
        every = tp.group.data_gather(counts)                  # (D, 2, E)
        top1 = every[:, 1].sum(0).to(probs.dtype) / (tokens * tp.data)
        if groups == 1:
            before = every[:tp.group.data_index, 0].sum(0)[lo:hi]
            tokens *= tp.data
    aux = _aux(cfg, probs, expert_ids, top1)
    experts = {k: tp.cols(params[k], E, 0) if split_experts else params[k]
               for k in ("w_gate", "w_up", "w_down")}
    xc = tp.copy(xf) if split_experts or split_shared else xf
    partial = whole = None
    routed = _dispatch(experts, cfg, xc if split_experts else xf,
                       expert_ids,
                       tp.copy(gate_vals) if split_experts else gate_vals,
                       groups, lo, _capacity(tokens // groups, cfg), before)
    if split_experts:
        partial = routed
    else:
        whole = routed
    if cfg.num_shared_experts > 0:
        sp, sff = params["shared"], cfg.shared_expert_d_ff
        if split_shared:
            sp = {"w_gate": tp.cols(sp["w_gate"], sff, -1),
                  "w_up": tp.cols(sp["w_up"], sff, -1),
                  "w_down": tp.cols(sp["w_down"], sff, -2)}
            s = _shared(sp, xc)
            partial = s if partial is None else partial + s
        else:
            s = _shared(sp, xf)
            whole = s if whole is None else whole + s
    y = tp.reduce(partial) if partial is not None else None
    y = whole if y is None else (y if whole is None else y + whole)
    return y.reshape(B, T, d), aux
