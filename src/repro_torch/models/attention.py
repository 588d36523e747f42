"""Grouped-query attention with RoPE, optional QKV bias, sliding window,
a rolling KV cache for decode, and the paged KV cache for serving.

Port of ``repro/models/attention.py``.  The reference is functional (its
serving programs donate the cache buffers); here every cache write is an
in-place ``index_put_`` / slice assignment on the caller's tensors, and
the returned cache tuple names the same storage.  Explicit clamps and
trash-page redirects are kept exactly where the reference has them:
torch raises (CPU) or faults (CUDA) on an out-of-range index where JAX
would clamp or drop it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import megatron
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S, KV, hd) — S = sliding_window if windowed
    v: torch.Tensor      # (B, S, KV, hd)
    pos: torch.Tensor    # () or (B,) int32 — tokens already absorbed.
                         # A (B,) vector gives every batch row (= serving
                         # slot) its own offset; decode handles both.


def init_attn_params(generator, cfg, dtype=torch.float32, layers=()):
    """Attention weights; ``layers=(L,)`` draws them stacked over L
    layers in one call per leaf."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = tuple(layers)
    p = {
        "wq": dense_init(generator, lead + (d, H * hd), dtype=dtype),
        "wk": dense_init(generator, lead + (d, KV * hd), dtype=dtype),
        "wv": dense_init(generator, lead + (d, KV * hd), dtype=dtype),
        "wo": dense_init(generator, lead + (H * hd, d), dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros(lead + (H * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (KV * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (KV * hd,), dtype=dtype, device=dev)
    return p


def _repeat_kv(x, groups: int):
    """(B, T, KV, hd) -> (B, T, KV*groups, hd)."""
    if groups == 1:
        return x
    b, t, kv, hd = x.shape
    x = x[:, :, :, None, :].expand(b, t, kv, groups, hd)
    return x.reshape(b, t, kv * groups, hd)


def _project_qkv(params, cfg, x):
    """(B, T, d) -> q (B, T, H, hd), k and v (B, T, KV, hd), pre-RoPE."""
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(B, T, H, hd), k.reshape(B, T, KV, hd),
            v.reshape(B, T, KV, hd))


# query-chunking threshold: above this T the O(T^2) logits tensor is
# never materialized whole
CHUNKED_THRESHOLD = 2048
CHUNK_Q = 1024

def attention_core(q, k, v, mask, use_flash: bool = False,
                   window: int = 0, causal: bool = True):
    """q: (B, Tq, H, hd); k/v: (B, Tk, H, hd); mask: (B|1, 1, Tq, Tk) bool.

    Returns (B, Tq, H, hd).
    """
    if use_flash and causal and q.shape[1] == k.shape[1]:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, window=window)
    if causal and q.shape[1] == k.shape[1] and q.shape[1] > CHUNKED_THRESHOLD:
        return chunked_attention(q, k, v, window=window)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q, k, v, window: int = 0, chunk: int = 0):
    """Memory-efficient causal attention: a loop over query chunks so the
    (Tq, Tk) logits tensor is materialized one (chunk, Tk) slab at a
    time."""
    if chunk == 0:
        chunk = CHUNK_Q
    B, T, H, hd = q.shape
    chunk = min(chunk, T)
    while T % chunk:
        chunk //= 2                  # largest power-of-two divisor fallback
    scale = hd ** -0.5
    k_pos = torch.arange(T, device=q.device)
    outs = []
    for i in range(T // chunk):
        qi = q[:, i * chunk:(i + 1) * chunk]
        q_pos = i * chunk + torch.arange(chunk, device=q.device)
        m = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            m &= k_pos[None, :] > q_pos[:, None] - window
        logits = torch.einsum("bqhd,bkhd->bhqk", qi, k).float() * scale
        logits = torch.where(m[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
    return torch.cat(outs, dim=1)


def causal_mask(t_q: int, t_k: int, window: int = 0, offset: int = 0,
                device=None):
    """(1, 1, Tq, Tk) bool. ``offset`` = t_k - t_q for cached prefixes."""
    q_pos = torch.arange(t_q, device=device)[:, None] + offset
    k_pos = torch.arange(t_k, device=device)[None, :]
    m = k_pos <= q_pos
    if window > 0:
        m &= k_pos > q_pos - window
    return m[None, None]


def _attn_full(params, cfg, x, positions, use_flash=False):
    """Full-sequence attention; also returns the roped k and v
    (B, T, KV, hd) that a prefill writes into its cache."""
    B, T, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    mask = causal_mask(T, T, window=cfg.sliding_window, device=x.device)
    o = attention_core(q, _repeat_kv(k, H // KV), _repeat_kv(v, H // KV),
                       mask, use_flash=use_flash, window=cfg.sliding_window)
    return o.reshape(B, T, H * hd) @ params["wo"], k, v


def attn_forward(params, cfg, x, positions, use_flash=False):
    """Full-sequence (training / prefill) attention.

    x: (B, T, d); positions: (B, T) int32.  Returns (B, T, d).  Under a
    tensor-parallel context that splits the heads, the rank's heads
    (:func:`_attn_split`).
    """
    tp = megatron.current()
    if tp is not None and megatron.splits_attention(cfg, tp.columns):
        return _attn_split(params, cfg, x, positions, tp, use_flash)
    return _attn_full(params, cfg, x, positions, use_flash=use_flash)[0]


def _attn_split(params, cfg, x, positions, tp, use_flash=False):
    """Column ``tp.column`` of attention split over ``tp.columns`` "model"
    ranks: the rank's H/M query heads, the KV heads they read, and its
    H/M · hd rows of ``wo``; the partial output summed over "model".

    The KV heads: where M divides KV, the column of ``wk`` / ``wv`` holds
    exactly the rank's KV heads.  Where it does not (GQA with fewer KV
    heads than ranks), a column of ``wk`` / ``wv`` may end mid-head, so
    every rank's K / V columns are GATHERED over "model" (one all-gather
    of the (B, T, 2 KV hd / M) activations, ``gather_summed``: the
    backward reduce-scatters each rank's use of a head) and the rank takes
    its heads; a ``wk`` / ``wv`` held whole (M does not divide KV hd) is
    read at the rank's heads, its grads summed over "model"
    (``ColumnLayout``'s ``summed``)."""
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    M, m = tp.columns, tp.column
    Hm, G = H // M, H // KV
    k0, k1 = m * Hm // G, ((m + 1) * Hm - 1) // G + 1   # its KV heads
    xc = tp.copy(x)
    q = xc @ tp.cols(params["wq"], H * hd, -1)
    if cfg.qkv_bias:
        q = q + tp.cols(params["bq"], H * hd, -1)

    def proj(name):
        w, b = params["w" + name], params.get("b" + name)
        if KV % M == 0 or w.shape[-1] != KV * hd:    # the rank's columns
            return xc @ tp.cols(w, KV * hd, -1) + (
                tp.cols(b, KV * hd, -1) if b is not None else 0)
        cols = slice(k0 * hd, k1 * hd)               # its heads of a whole
        return xc @ w[:, cols] + (b[cols] if b is not None else 0)

    k, v = proj("k"), proj("v")
    if KV % M and params["wk"].shape[-1] != KV * hd:
        kv = tp.gather_summed(torch.cat([k, v], -1), -1)
        kv = kv.reshape(B, T, M, 2, KV * hd // M).transpose(2, 3)
        kv = kv.reshape(B, T, 2, KV * hd)[..., k0 * hd:k1 * hd]
        k, v = kv.unbind(2)
    q = apply_rope(q.reshape(B, T, Hm, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, T, k1 - k0, hd), positions, cfg.rope_theta)
    v = v.reshape(B, T, k1 - k0, hd)
    heads = torch.arange(m * Hm, (m + 1) * Hm, device=x.device) // G - k0
    mask = causal_mask(T, T, window=cfg.sliding_window, device=x.device)
    o = attention_core(q, k[:, :, heads], v[:, :, heads], mask,
                       use_flash=use_flash, window=cfg.sliding_window)
    return tp.reduce(o.reshape(B, T, Hm * hd)
                     @ tp.cols(params["wo"], H * hd, -2))


def init_kv_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
                  device=None, layers=()) -> KVCache:
    """Zeroed cache; ``layers=(L,)`` stacks k and v over L layers."""
    S = cfg.sliding_window if cfg.sliding_window else max_len
    shape = tuple(layers) + (batch, S, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def attn_prefill(params, cfg, x, positions, cache: KVCache, use_flash=False):
    """Run full attention over a prompt AND populate the cache (in
    place)."""
    T = x.shape[1]
    out, k, v = _attn_full(params, cfg, x, positions, use_flash=use_flash)
    S = cache.k.shape[1]
    if T >= S:
        # keep only the last S tokens, placed so token p sits at slot p % S
        # (ring-buffer invariant shared with attn_decode)
        cache.k.copy_(torch.roll(k[:, -S:], shifts=T % S, dims=1))
        cache.v.copy_(torch.roll(v[:, -S:], shifts=T % S, dims=1))
    else:
        cache.k[:, :T] = k
        cache.v[:, :T] = v
    return out, KVCache(cache.k, cache.v, cache.pos + T)


def attn_decode(params, cfg, x, cache: KVCache):
    """One-token decode.  x: (B, 1, d).  Rolling window if configured.

    ``cache.pos`` may be a scalar (whole batch at one offset) or a (B,)
    vector (per-row offsets — the serving engine's slot batch, where
    every row is a different request).  Writes the cache in place.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = cache.k.shape[1]
    pos = cache.pos                                        # () or (B,) int32
    posv = torch.broadcast_to(pos, (B,)).to(torch.int32)   # (B,)
    q, k, v = _project_qkv(params, cfg, x)
    posb = posv[:, None]                                   # (B, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)

    if cfg.sliding_window:
        slot = posv % S         # rolling ring buffer
    else:
        slot = torch.clamp(posv, max=S - 1)
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot] = k[:, 0]
    cache.v[rows, slot] = v[:, 0]

    kk = _repeat_kv(cache.k, H // KV)
    vv = _repeat_kv(cache.v, H // KV)
    # valid slots: with a rolling window every slot < min(pos+1, S) is live
    live = (torch.arange(S, device=x.device)[None, None, None, :]
            < torch.clamp(posv + 1, max=S)[:, None, None, None])
    o = attention_core(q, kk, vv, live, causal=False)
    out = o.reshape(B, 1, H * hd) @ params["wo"]
    return out, KVCache(cache.k, cache.v, pos + 1)


# ------------------------------------------------------------------
# Paged KV cache (serving): page-pool layout + page-table attention
# ------------------------------------------------------------------

class PagedKVCache(NamedTuple):
    """KV storage as a shared page pool indexed through per-slot tables.

    Position p of slot b lives at ``pool[table[b, p // ps], p % ps]``
    (ps = page_size, static from the pool shape).  Page 0 is the trash
    page (paging.TRASH_PAGE): table entries default to it, and writes
    that must not land anywhere — inactive decode rows, positions past a
    slot's allocated range — are redirected there.
    """
    k: torch.Tensor      # (L, num_pages, page_size, KV, hd)
    v: torch.Tensor      # (L, num_pages, page_size, KV, hd)
    table: torch.Tensor  # (num_slots, max_pages) int32 page ids
    pos: torch.Tensor    # (num_slots,) int32 — tokens absorbed per slot


def init_paged_kv_pool(cfg, num_slots: int, num_pages: int, page_size: int,
                       max_pages: int, dtype=torch.float32, device=None,
                       layers=()):
    """Pool pair + table + pos; ``layers=(L,)`` stacks the pools over L
    layers (the family cache constructors)."""
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    shape = tuple(layers) + (num_pages, page_size, KV, hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros((num_slots, max_pages), dtype=torch.int32,
                        device=device),
            torch.zeros((num_slots,), dtype=torch.int32, device=device))


def paged_gather(pool, table):
    """Materialize the contiguous view: pool (P, ps, KV, hd) + table
    (B, M) -> (B, M*ps, KV, hd).  Gathered values are bit-identical to
    the dense cache rows, so downstream attention matches the dense
    engine exactly when M*ps equals the dense max_len."""
    B, M = table.shape
    g = pool[table]                                  # (B, M, ps, KV, hd)
    return g.reshape(B, M * pool.shape[1], *pool.shape[2:])


def attn_prefill_paged(params, cfg, x, positions, pool_k, pool_v, table_row):
    """Chunked prefill through the page table, single slot (B = 1).

    x: (1, C, d); positions: (1, C) absolute cache positions (may run
    past the valid prompt — padded tail); table_row: (max_pages,).
    Writes the chunk's K/V into the slot's pages in place (out-of-range
    positions go to the trash page) and attends causally against the
    slot's whole paged extent.  Returns (out, pool_k, pool_v).
    """
    B, C, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = pool_k.shape[1]
    M = table_row.shape[0]
    S_pad = M * ps
    q, k, v = _project_qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    p = positions[0]                                    # (C,)
    in_range = p < S_pad
    pidx = torch.clamp(p // ps, max=M - 1)
    pages = torch.where(in_range, table_row[pidx], 0)   # trash when OOR
    off = p % ps
    pool_k[pages, off] = k[0]
    pool_v[pages, off] = v[0]

    kk = _repeat_kv(paged_gather(pool_k, table_row[None]), H // KV)
    vv = _repeat_kv(paged_gather(pool_v, table_row[None]), H // KV)
    mask = (torch.arange(S_pad, device=x.device)[None, :]
            <= p[:, None])[None, None]
    o = attention_core(q, kk, vv, mask, causal=False)
    out = o.reshape(B, C, H * hd) @ params["wo"]
    return out, pool_k, pool_v


def paged_to_dense_kv(pc: PagedKVCache) -> KVCache:
    """Materialize the dense slot-cache view of a paged cache: pool
    (L, P, ps, KV, hd) gathered through the table into (L, B, M*ps, KV,
    hd) — a copy.  Gathered rows are bitwise the pool rows, so running
    the plain dense ``attn_decode`` on the view is bit-identical to
    paged decode.

    The engine uses this to hoist the gather OUT of the decode chunk:
    one gather + one scatter (``dense_to_paged_kv``) per chunk instead
    of per token — the page table cannot change mid-chunk.
    """
    L = pc.k.shape[0]
    B, M = pc.table.shape
    ps = pc.k.shape[2]
    tail = pc.k.shape[3:]
    gk = pc.k[:, pc.table].reshape(L, B, M * ps, *tail)
    gv = pc.v[:, pc.table].reshape(L, B, M * ps, *tail)
    return KVCache(k=gk, v=gv, pos=pc.pos)


def dense_to_paged_kv(pc: PagedKVCache, dc: KVCache, active,
                      steps: int) -> PagedKVCache:
    """Scatter a chunk's dense view back into the pool, in place.
    Inactive rows (idle / mid-prefill) scatter to the trash page — their
    view rows absorbed garbage decode writes that must not touch their
    real pages.  Shared prefix pages appear in several active rows'
    tables, but decode only writes past the prompt (private pages), so
    the duplicate scatter payloads are bitwise equal and the result does
    not depend on the order in which the writes land.
    """
    L = pc.k.shape[0]
    B, M = pc.table.shape
    ps = pc.k.shape[2]
    tail = pc.k.shape[3:]
    tbl = torch.where(active[:, None], pc.table, 0)
    pc.k[:, tbl] = dc.k.reshape(L, B, M, ps, *tail)
    pc.v[:, tbl] = dc.v.reshape(L, B, M, ps, *tail)
    pos = pc.pos + steps * active.to(torch.int32)
    return PagedKVCache(k=pc.k, v=pc.v, table=pc.table, pos=pos)


def attn_decode_paged(params, cfg, x, pool_k, pool_v, table, pos, active,
                      use_kernel: bool = False):
    """One-token decode over the whole slot batch through page tables.

    x: (B, 1, d); pos: (B,) int32; active: (B,) bool — inactive rows
    (idle / still prefilling) write to the trash page and their output
    is garbage the engine never keeps.  Mirrors ``attn_decode`` exactly
    for active rows: when max_pages*page_size == the dense max_len the
    gathered extent and mask coincide and the result is bit-identical.
    ``use_kernel`` reads K/V straight from the pool through the paged
    attention kernel (K8) instead of gathering the extent.
    """
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = pool_k.shape[1]
    M = table.shape[1]
    S_pad = M * ps
    posv = torch.broadcast_to(pos, (B,)).to(torch.int32)
    q, k, v = _project_qkv(params, cfg, x)
    posb = posv[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)
    k = apply_rope(k, posb, cfg.rope_theta)

    ok = active & (posv < S_pad)
    pidx = torch.clamp(posv // ps, max=M - 1)
    rows = torch.arange(B, device=x.device)
    pages = torch.where(ok, table[rows, pidx], 0)
    off = posv % ps
    pool_k[pages, off] = k[:, 0]
    pool_v[pages, off] = v[:, 0]

    if use_kernel:
        from repro_torch.kernels import ops as kops
        # lengths >= 1 always: pos >= 0, so min(pos + 1, S_pad) >= 1
        lengths = torch.clamp(posv + 1, max=S_pad)
        o = kops.paged_attention(q[:, 0], pool_k, pool_v, table,
                                 lengths)[:, None]
    else:
        kk = _repeat_kv(paged_gather(pool_k, table), H // KV)
        vv = _repeat_kv(paged_gather(pool_v, table), H // KV)
        live = (torch.arange(S_pad, device=x.device)[None, None, None, :]
                < torch.clamp(posv + 1, max=S_pad)[:, None, None, None])
        o = attention_core(q, kk, vv, live, causal=False)
    out = o.reshape(B, 1, H * hd) @ params["wo"]
    return out, pool_k, pool_v
