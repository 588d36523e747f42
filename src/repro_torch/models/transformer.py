"""Pre-norm decoder transformer with GQA over stacked layer parameters.

Port of ``repro/models/transformer.py``.  The same block serves the
dense, moe (MLP swapped for the routed MoE of ``moe.py``), vlm and audio
families; their embedding and head handling lives in model.py, vlm.py
and audio.py, which hand merged embeddings in as ``extra_embeds``.  The
reference scans the stacked blocks with ``lax.scan``; here each scan is
a Python loop over the layer index over views of the same stacked
tensors (so reference params load without reshaping), taken by one
``unbind(0)`` per leaf: its backward is one ``stack``, where indexing
each layer out would write a zero-filled copy of the whole stacked leaf
per layer.  Caches are written in place (see attention.py).

``remat`` (the training forward's ``remat=`` argument, as the
reference's ``_remat``) recomputes each block in the backward through
``torch.utils.checkpoint``: ``True`` keeps nothing of a block, ``"dots"``
keeps its products without batch dims (the projections' ``mm``) and
recomputes the rest.  A checkpointed block takes its layer's views as
inputs, so the one ``unbind`` above still serves every layer.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import megatron
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (dense_init, device_index, embed_init,
                                       rms_norm, swiglu)


# ------------------------------------------------------------------
# Parameters
# ------------------------------------------------------------------

def init_stacked_blocks(generator, cfg, dtype=torch.float32):
    """All ``num_layers`` decoder blocks, each leaf stacked along a
    leading layer axis."""
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    dev = generator.device
    p = {
        "ln1": torch.ones((L, d), dtype=dtype, device=dev),
        "ln2": torch.ones((L, d), dtype=dtype, device=dev),
        "attn": attn.init_attn_params(generator, cfg, dtype, layers=(L,)),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe_params(generator, cfg, dtype, layers=(L,))
    else:
        p["mlp"] = {
            "w_gate": dense_init(generator, (L, d, f), dtype=dtype),
            "w_up": dense_init(generator, (L, d, f), dtype=dtype),
            "w_down": dense_init(generator, (L, f, d), dtype=dtype),
        }
    return p


def init_params(generator, cfg, dtype=torch.float32):
    """Random params drawn on ``generator`` (and on its device)."""
    p = {
        "embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype),
        "blocks": init_stacked_blocks(generator, cfg, dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype,
                           device=generator.device),
    }
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size),
                               dtype=dtype)
    return p


def layer_params(blocks, num_layers: int) -> list:
    """The stacked block tree as one tree of views per layer, from one
    ``unbind(0)`` per leaf."""
    per_layer = [{} for _ in range(num_layers)]
    for k, v in blocks.items():
        parts = (layer_params(v, num_layers) if isinstance(v, dict)
                 else v.unbind(0))
        for l in range(num_layers):
            per_layer[l][k] = parts[l]
    return per_layer


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the products with no batch dims (``mm`` / ``addmm``: every ``x @ w``
    of a projection), recompute everything else (the batched ``bmm`` of
    Q·Kᵀ and P·V among it)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, remat):
    """``body`` recomputed in the backward: remat=True keeps nothing of
    it, remat="dots" keeps its unbatched products (cheaper recompute at
    more live memory); remat=False returns ``body`` as it is.  Non-
    reentrant, so gradients taken with ``torch.autograd.grad`` pass
    through it."""
    if not remat:
        return body
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    # the recompute runs the block under its forward's tensor-parallel
    # context (autograd may run it on another thread)
    return lambda *args: checkpoint(megatron.within(megatron.context(),
                                                    body),
                                    *args, use_reentrant=False, **kw)


def _mlp(bp, cfg, u):
    """(MLP output, the MoE's aux loss or None).  Under a tensor-parallel
    context that splits the ff dim: gate and up column-parallel, down
    row-parallel, the partial output summed over "model"."""
    if cfg.family == "moe":
        return moe_mod.moe_forward(bp["moe"], cfg, u)
    tp = megatron.current()
    if tp is not None and megatron.splits_mlp(cfg, tp.columns):
        f, p = cfg.d_ff, bp["mlp"]
        return tp.reduce(swiglu(tp.copy(u), tp.cols(p["w_gate"], f, -1),
                                tp.cols(p["w_up"], f, -1),
                                tp.cols(p["w_down"], f, -2))), None
    return swiglu(u, **bp["mlp"]), None


# ------------------------------------------------------------------
# Forward
# ------------------------------------------------------------------

def _decoder_layer(bp, cfg, h, attend):
    """One pre-norm block around an attention callable ``attend(x)``;
    returns (h, aux loss or None)."""
    h = h + attend(rms_norm(h, bp["ln1"], cfg.norm_eps))
    m, aux = _mlp(bp, cfg, rms_norm(h, bp["ln2"], cfg.norm_eps))
    return h + m, aux


def block_forward(bp, cfg, x, positions, use_flash=False):
    """x: (B, T, d) -> (B, T, d); returns (x, aux_loss)."""
    x, aux = _decoder_layer(bp, cfg, x, lambda u: attn.attn_forward(
        bp["attn"], cfg, u, positions, use_flash=use_flash))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def stack_forward(params, cfg, x, positions, use_flash=False, remat=False):
    """Loop over the stacked blocks.  Returns (hidden, total_aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat(lambda bp, h: block_forward(bp, cfg, h, positions,
                                              use_flash=use_flash), remat)
    for bp in layer_params(params["blocks"], cfg.num_layers):
        x, a = body(bp, x)
        aux = aux + a
    return x, aux


def head_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _positions(B, T, device):
    return torch.arange(T, dtype=torch.int32, device=device).expand(B, T)


def _embed(params, tokens, extra_embeds):
    """Token embeddings, plus ``extra_embeds`` (B, T, d) where given (the
    vlm and audio families' merged inputs)."""
    x = params["embed"][tokens]
    return x if extra_embeds is None else x + extra_embeds


def embed_tokens(params, cfg, tokens):
    """The token embeddings (B, T, d).  Under a tensor-parallel context
    that splits d: the rank's d/M columns, gathered over "model"."""
    tp = megatron.current()
    if tp is not None and megatron.splits_embed(cfg, tp.columns):
        return tp.gather(tp.cols(params["embed"], cfg.d_model, -1)[tokens],
                         -1)
    return params["embed"][tokens]


def forward_hidden(params, cfg, tokens, use_flash=False, remat=False):
    """Returns (final-normed hidden (B, T, d), aux_loss)."""
    B, T = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    h, aux = stack_forward(params, cfg, x, _positions(B, T, x.device),
                           use_flash=use_flash, remat=remat)
    return rms_norm(h, params["ln_f"], cfg.norm_eps), aux


def logits_from_hidden(params, cfg, h):
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return h @ head_matrix(params, cfg)


def forward(params, cfg, tokens, use_flash=False, remat=False):
    """tokens: (B, T) -> logits (B, T, V)."""
    B, T = tokens.shape
    x = params["embed"][tokens]
    h, aux = stack_forward(params, cfg, x, _positions(B, T, x.device),
                           use_flash=use_flash, remat=remat)
    return logits_from_hidden(params, cfg, h), aux


# ------------------------------------------------------------------
# Serving: prefill + single-token decode with per-layer KV caches
# ------------------------------------------------------------------

def init_cache(params, cfg, batch, max_len, dtype=torch.float32):
    return attn.init_kv_cache(cfg, batch, max_len, dtype,
                              device=params["embed"].device,
                              layers=(cfg.num_layers,))


def prefill(params, cfg, tokens, cache, use_flash=False, extra_embeds=None):
    B, T = tokens.shape
    x = _embed(params, tokens, extra_embeds)
    positions = _positions(B, T, x.device)
    h = x
    for l, bp in enumerate(layer_params(params["blocks"], cfg.num_layers)):
        lc = attn.KVCache(cache.k[l], cache.v[l], cache.pos)
        h, _ = _decoder_layer(bp, cfg, h, lambda u: attn.attn_prefill(
            bp["attn"], cfg, u, positions, lc, use_flash=use_flash)[0])
    new_cache = attn.KVCache(cache.k, cache.v, cache.pos + T)
    return logits_from_hidden(params, cfg, h), new_cache


def decode_step(params, cfg, token, cache, extra_embeds=None):
    """token: (B, 1) int32 -> logits (B, 1, V), updated cache."""
    x = _embed(params, token, extra_embeds)
    h = x
    for l, bp in enumerate(layer_params(params["blocks"], cfg.num_layers)):
        lc = attn.KVCache(cache.k[l], cache.v[l], cache.pos)
        h, _ = _decoder_layer(bp, cfg, h, lambda u: attn.attn_decode(
            bp["attn"], cfg, u, lc)[0])
    new_cache = attn.KVCache(cache.k, cache.v, cache.pos + 1)
    return logits_from_hidden(params, cfg, h), new_cache


# ------------------------------------------------------------------
# Serving: paged cache (page pools + per-slot tables) + chunked prefill
# ------------------------------------------------------------------

def init_paged_cache(params, cfg, num_slots, num_pages, page_size, max_pages,
                     dtype=torch.float32):
    return attn.PagedKVCache(*attn.init_paged_kv_pool(
        cfg, num_slots, num_pages, page_size, max_pages, dtype,
        device=params["embed"].device, layers=(cfg.num_layers,)))


def prefill_chunk(params, cfg, tokens, cache, slot, frontier, valid,
                  extra_embeds=None):
    """One chunk of a single slot's prefill through the page table.

    tokens: (1, C) — the chunk's slice of the prompt, zero-padded past
    ``valid``; ``frontier`` is the chunk's absolute start position.  The
    padded tail's writes land past the slot's allocated pages (-> trash)
    or in not-yet-live positions later overwritten by decode, so only
    ``valid`` logit rows are meaningful.  ``slot`` and ``frontier`` are
    ints or (1,) int64 device tensors (``layers.device_index``).  Returns
    (logits (1, C, V), cache); cache.pos is NOT advanced (the engine sets
    it once the whole prompt is in).
    """
    del valid  # attention needs no masking: padded rows are causal-future
    C = tokens.shape[1]
    x = _embed(params, tokens, extra_embeds)
    positions = (frontier + torch.arange(C, dtype=torch.int32,
                                         device=x.device))[None]
    table_row = cache.table.index_select(0, device_index(slot, x.device))[0]
    h = x
    for l, bp in enumerate(layer_params(params["blocks"], cfg.num_layers)):
        h, _ = _decoder_layer(bp, cfg, h, lambda u: attn.attn_prefill_paged(
            bp["attn"], cfg, u, positions, cache.k[l], cache.v[l],
            table_row)[0])
    return logits_from_hidden(params, cfg, h), cache


def decode_step_paged(params, cfg, token, cache, active, extra_embeds=None,
                      use_kernel=False):
    """token: (B, 1) int32 -> logits (B, 1, V), updated paged cache.
    ``active``: (B,) bool — inactive rows write to the trash page and
    keep their pos."""
    x = _embed(params, token, extra_embeds)
    h = x
    for l, bp in enumerate(layer_params(params["blocks"], cfg.num_layers)):
        h, _ = _decoder_layer(bp, cfg, h, lambda u: attn.attn_decode_paged(
            bp["attn"], cfg, u, cache.k[l], cache.v[l], cache.table,
            cache.pos, active, use_kernel=use_kernel)[0])
    new_cache = cache._replace(pos=cache.pos + active.to(torch.int32))
    return logits_from_hidden(params, cfg, h), new_cache


def paged_to_dense(cache):
    """Page tables are constant within a decode chunk, so the engine
    gathers the pool into a dense per-slot view ONCE per chunk and runs
    the plain ``decode_step`` inside the chunk loop (bitwise the same
    values the per-step paged path attends over)."""
    return attn.paged_to_dense_kv(cache)


def paged_restore(cache, dense, active, steps):
    """Scatter the chunk's dense view back into the page pool; inactive
    rows land on the trash page and keep their pos."""
    return attn.dense_to_paged_kv(cache, dense, active, steps)
