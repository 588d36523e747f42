"""Zamba2-style hybrid: Mamba2 backbone + ONE shared attention block
(arXiv:2411.15242) applied after every ``cfg.attn_every`` SSM layers.

Port of ``repro/models/hybrid.py``.  The attention block's weights are
shared across all of its applications (the sites); each site keeps its
own KV cache, stacked along a leading site axis.  The SSM layers are
``mamba2.py``'s blocks and the block's attention is ``attention.py``'s:
``use_flash`` sends the sites' full causal attention through the
flash-attention kernel (K3), ``use_kernel`` the SSM layers' forward scan
through the SSD-scan kernel (K9), and the paged decode's
``use_kernel`` the sites' decode attention through the paged-attention
kernel (K8).  Caches are written in place, as in ``mamba2.py`` and
``transformer.py``; every cache tuple returned names the same storage
with its three ``pos`` fields advanced.  In training under a "model"
axis (``models/megatron.py``) the SSM layers and the shared block are
split over its ranks as the ssm and dense families are.

Simplification vs the released model (as in the reference): the shared
block consumes the hidden stream directly rather than concat(hidden,
original embedding), and LoRA-per-invocation adapters are omitted.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import (dense_init, device_index, embed_init,
                                       rms_norm)
from repro_torch.models.transformer import (_decoder_layer, _positions,
                                            _remat, embed_tokens,
                                            layer_params)


class HybridCache(NamedTuple):
    ssm: mamba2.SSMCache
    kv: tuple                   # KVCache or PagedKVCache; leading axis =
                                # the shared-attention sites
    pos: torch.Tensor           # () or (B,) int32


def _group_sizes(cfg):
    L, k = cfg.num_layers, cfg.attn_every
    sizes = [k] * (L // k)
    if L % k:
        sizes.append(L % k)
    return sizes


def num_attn_sites(cfg) -> int:
    return len(_group_sizes(cfg))


def _groups(params, cfg):
    """[(site g, [(layer index l, layer view), ...])] in stack order."""
    layers = list(enumerate(layer_params(params["layers"], cfg.num_layers)))
    out, start = [], 0
    for g, size in enumerate(_group_sizes(cfg)):
        out.append((g, layers[start:start + size]))
        start += size
    return out


def init_params(generator, cfg, dtype=torch.float32):
    """Random params drawn on ``generator`` (and on its device)."""
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    shared = {
        "ln1": torch.ones((d,), dtype=dtype, device=dev),
        "ln2": torch.ones((d,), dtype=dtype, device=dev),
        "attn": attn.init_attn_params(generator, cfg, dtype),
        "mlp": {
            "w_gate": dense_init(generator, (d, f), dtype=dtype),
            "w_up": dense_init(generator, (d, f), dtype=dtype),
            "w_down": dense_init(generator, (f, d), dtype=dtype),
        },
    }
    return {
        "embed": embed_init(generator, (cfg.vocab_size, d), dtype),
        "layers": mamba2.init_stacked_ssm(generator, cfg, dtype=dtype),
        "shared_attn": shared,
        "ln_f": torch.ones((d,), dtype=dtype, device=dev),
        "head": dense_init(generator, (d, cfg.vocab_size), dtype=dtype),
    }


def _shared_block(sp, cfg, x, attend):
    """The shared pre-norm block around an attention callable: the
    decoder layer of ``transformer.py`` (its heads and ff split over
    "model" under a tensor-parallel context, at every site)."""
    return _decoder_layer(sp, cfg, x, attend)[0]


def _logits(params, cfg, x):
    return rms_norm(x, params["ln_f"], cfg.norm_eps) @ params["head"]


def forward_hidden(params, cfg, tokens, remat=False, use_flash=False,
                   use_kernel=False):
    """Returns (final-normed hidden (B, T, d), aux_loss = 0).  ``remat``
    recomputes the SSM blocks in the backward, not the shared attention
    block (as the reference)."""
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = _positions(B, T, x.device)
    sp = params["shared_attn"]
    ssm_body = _remat(lambda lp, h: mamba2.ssm_block_forward(
        lp, cfg, h, use_kernel=use_kernel)[0], remat)
    for _, group in _groups(params, cfg):
        for _, lp in group:
            x = ssm_body(lp, x)
        x = _shared_block(sp, cfg, x, lambda u: attn.attn_forward(
            sp["attn"], cfg, u, positions, use_flash=use_flash))
    return (rms_norm(x, params["ln_f"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(params, cfg, tokens, remat=False, use_flash=False,
            use_kernel=False):
    """tokens: (B, T) -> logits (B, T, V), aux_loss."""
    h, aux = forward_hidden(params, cfg, tokens, remat=remat,
                            use_flash=use_flash, use_kernel=use_kernel)
    return h @ params["head"], aux


# ------------------------------------------------------------------
# Serving: dense caches
# ------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=torch.float32,
               device=None) -> HybridCache:
    return HybridCache(
        ssm=mamba2.init_cache(cfg, batch, dtype, device=device),
        kv=attn.init_kv_cache(cfg, batch, max_len, dtype, device=device,
                              layers=(num_attn_sites(cfg),)),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def _advance(cache: HybridCache, step) -> HybridCache:
    """Every pos field moved by ``step`` (new tensors, as the caches'
    pos fields must not alias)."""
    return HybridCache(ssm=cache.ssm._replace(pos=cache.ssm.pos + step),
                       kv=cache.kv._replace(pos=cache.kv.pos + step),
                       pos=cache.pos + step)


def prefill(params, cfg, tokens, cache: HybridCache, use_flash=False,
            valid=None):
    """Absorb a prompt, the caches written in place.  ``valid``:
    optional int for bucketed (zero-padded) prompts — positions >= valid
    are made inert in the SSM scan and the conv ring ends at ``valid``
    (their KV rows hold garbage that decode overwrites before its live
    mask exposes them).  None keeps the unpadded path."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    positions = _positions(B, T, x.device)
    sp = params["shared_attn"]
    for g, group in _groups(params, cfg):
        for l, lp in group:
            x = mamba2.prefill_layer(lp, cfg, x, cache.ssm, l, valid)
        lc = attn.KVCache(cache.kv.k[g], cache.kv.v[g], cache.kv.pos)
        x = _shared_block(sp, cfg, x, lambda u: attn.attn_prefill(
            sp["attn"], cfg, u, positions, lc, use_flash=use_flash)[0])
    return _logits(params, cfg, x), _advance(cache, T)


def decode_step(params, cfg, token, cache: HybridCache):
    """token: (B, 1) int32 -> logits (B, 1, V); caches updated in place."""
    x = params["embed"][token]
    sp = params["shared_attn"]
    for g, group in _groups(params, cfg):
        for l, lp in group:
            x = mamba2.decode_layer(lp, cfg, x, cache.ssm, l)
        lc = attn.KVCache(cache.kv.k[g], cache.kv.v[g], cache.kv.pos)
        x = _shared_block(sp, cfg, x, lambda u: attn.attn_decode(
            sp["attn"], cfg, u, lc)[0])
    return _logits(params, cfg, x), _advance(cache, 1)


# ------------------------------------------------------------------
# Paged-engine entry points: the shared-attn KV goes through page
# tables (pool leading axis = attention sites), the SSM state stays
# dense per slot (O(1) per request — nothing to page).
# ------------------------------------------------------------------

def init_paged_cache(params, cfg, num_slots, num_pages, page_size, max_pages,
                     dtype=torch.float32):
    dev = params["embed"].device
    k, v, table, pos = attn.init_paged_kv_pool(
        cfg, num_slots, num_pages, page_size, max_pages, dtype, device=dev,
        layers=(num_attn_sites(cfg),))
    ssm = mamba2.init_paged_cache(params, cfg, num_slots, num_pages,
                                  page_size, max_pages, dtype)
    return HybridCache(ssm=ssm,
                       kv=attn.PagedKVCache(k=k, v=v, table=table, pos=pos),
                       pos=torch.zeros((num_slots,), dtype=torch.int32,
                                       device=dev))


def prefill_chunk(params, cfg, tokens, cache: HybridCache, slot, frontier,
                  valid):
    """One resumable prefill chunk for a single slot.  tokens: (1, C);
    ``slot``, ``frontier`` and ``valid``: ints or (1,) int64 device
    tensors.  pos is not advanced (the engine sets it once the prompt is
    in)."""
    C = tokens.shape[1]
    x = params["embed"][tokens]
    positions = (frontier + torch.arange(C, dtype=torch.int32,
                                         device=x.device))[None]
    slot = device_index(slot, x.device)
    table_row = cache.kv.table.index_select(0, slot)[0]
    sp = params["shared_attn"]
    for g, group in _groups(params, cfg):
        for l, lp in group:
            x = mamba2.prefill_chunk_layer(lp, cfg, x, cache.ssm, l, slot,
                                           valid)
        x = _shared_block(sp, cfg, x, lambda u: attn.attn_prefill_paged(
            sp["attn"], cfg, u, positions, cache.kv.k[g], cache.kv.v[g],
            table_row)[0])
    return _logits(params, cfg, x), cache


def decode_step_paged(params, cfg, token, cache: HybridCache, active,
                      use_kernel=False):
    """decode_step over the slot batch: shared-attn KV through the page
    tables (inactive rows -> trash page), SSM state frozen on inactive
    rows."""
    x = params["embed"][token]
    sp = params["shared_attn"]
    kv = cache.kv
    for g, group in _groups(params, cfg):
        for l, lp in group:
            x = mamba2.decode_layer(lp, cfg, x, cache.ssm, l, active)
        x = _shared_block(sp, cfg, x, lambda u: attn.attn_decode_paged(
            sp["attn"], cfg, u, kv.k[g], kv.v[g], kv.table, kv.pos, active,
            use_kernel=use_kernel)[0])
    return _logits(params, cfg, x), _advance(cache, active.to(torch.int32))


def paged_to_dense(cache: HybridCache) -> HybridCache:
    """Chunk view for decode: the shared-attn page pool gathered into a
    dense per-slot KV cache, the SSM half copied (see
    ``mamba2.paged_to_dense``)."""
    return HybridCache(ssm=mamba2.paged_to_dense(cache.ssm),
                       kv=attn.paged_to_dense_kv(cache.kv), pos=cache.pos)


def paged_restore(cache: HybridCache, dense: HybridCache, active,
                  steps) -> HybridCache:
    return HybridCache(
        ssm=mamba2.paged_restore(cache.ssm, dense.ssm, active, steps),
        kv=attn.dense_to_paged_kv(cache.kv, dense.kv, active, steps),
        pos=cache.pos + steps * active.to(torch.int32))
