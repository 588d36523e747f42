"""Mixture-of-experts MLP with top-k token-choice routing.

Port of ``repro/models/moe.py``'s flat dispatch (``_moe_forward_flat``):
the router's softmax picks ``top_k`` experts a token, the routed slots
are sorted by expert (stable, so ties keep token order), each expert's
bucket takes its first ``C`` slots (``_capacity``, a host integer from
the shapes), the (E, C, d) buffer goes through one batched SwiGLU, and
each token sums its kept experts' outputs times their renormalised
gates.  A switch-transformer load-balance loss (weight
``cfg.router_aux_weight``) comes back beside the output.

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

The grouped (``cfg.moe_groups > 1``) and shard_map (``cfg.moe_impl ==
"shard_map"``) dispatches are expert-parallel layouts over a device
mesh; they raise (ROADMAP.md queue 1 item 7).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import dense_init, silu

_EXPERT_PARALLEL_NOT_PORTED = (
    "the grouped and shard_map MoE dispatches (cfg.moe_groups > 1, "
    "cfg.moe_impl == 'shard_map') are not ported yet (ROADMAP.md queue 1, "
    "item 7); the port runs the flat dispatch only")


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


def moe_forward(params, cfg, x):
    """x: (B, T, d) -> (B, T, d), aux_loss scalar (the flat dispatch)."""
    if cfg.moe_groups > 1 or cfg.moe_impl == "shard_map":
        raise NotImplementedError(_EXPERT_PARALLEL_NOT_PORTED)
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    Tflat = B * T
    xf = x.reshape(Tflat, d)
    dev = x.device

    probs, gate_vals, expert_ids = route(params, cfg, xf)
    experts = torch.arange(E, device=dev)
    # switch-style load-balance loss: mean router prob x fraction routed
    top1 = (expert_ids[:, :1] == experts).to(probs.dtype)      # (T, E)
    aux = cfg.router_aux_weight * E * torch.sum(probs.mean(0) * top1.mean(0))

    # ---- sort-based dispatch ---------------------------------------
    C = _capacity(Tflat, cfg)
    flat_expert = expert_ids.reshape(-1)                       # (T*K,)
    order = torch.argsort(flat_expert, stable=True)
    inv = torch.argsort(order)                                 # sorted slot
    counts = (flat_expert[:, None] == experts).sum(0)          # (E,)
    # exclusive prefix sum of the counts, as a masked sum (no cumsum)
    starts = (counts[None, :] * (experts[None, :] < experts[:, None])).sum(1)
    pos = inv - starts[flat_expert]                            # in its bucket
    keep = pos < C

    # buffer row (e, c) <- the token of sorted slot starts[e] + c
    c_idx = torch.arange(C, device=dev)
    src = torch.clamp(starts[:, None] + c_idx, max=Tflat * K - 1)
    live = c_idx[None, :] < counts[:, None]                    # (E, C)
    eb = torch.where(live[..., None], xf[order[src] // K],
                     torch.zeros((), dtype=x.dtype, device=dev))

    # ---- expert computation (batched SwiGLU) -----------------------
    g = torch.einsum("ecd,edf->ecf", eb, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", eb, params["w_up"])
    out = torch.einsum("ecf,efd->ecd", silu(g) * u,
                       params["w_down"]).reshape(E * C, d)

    # ---- combine: each routing reads its row back ------------------
    row = torch.clamp(flat_expert * C + pos, max=E * C - 1)
    w = (gate_vals.reshape(-1) * keep).to(x.dtype)
    y = (out[row] * w[:, None]).reshape(Tflat, K, d).sum(1)

    if cfg.num_shared_experts > 0:
        sp = params["shared"]
        y = y + (silu(xf @ sp["w_gate"]) * (xf @ sp["w_up"])) @ sp["w_down"]
    return y.reshape(B, T, d), aux
