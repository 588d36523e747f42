"""MusicGen-style audio decoder (arXiv:2306.05284).

Port of ``repro/models/audio.py``.  A decoder-only transformer over
``num_codebooks`` (K) parallel EnCodec token streams: the input
embedding is the sum of K per-codebook embeddings (``embed`` is
(K, V, d)), the output one LM head per codebook (``head`` is (d, K·V)).
The EnCodec tokenizer and the T5 text conditioner are stubs, as in the
reference: requests carry ``cond_len`` precomputed conditioning frames
(B, cond_len, d_model), prepended to the sequence (MusicGen's
prepend-conditioning mode).  Every cache path counts MERGED positions:
the cond frames occupy [0, cond_len) of the cache and the tokens follow.

The merged embeddings go through ``transformer.py``'s stack as
``extra_embeds`` on all-zero tokens over codebook 0's table (the
reference's zero-token trick), so ``use_flash`` reaches K3 and the paged
decode's ``use_kernel`` K8 as in the dense family.  In training under a
"model" axis (``models/megatron.py``) the blocks split as the dense
family's, each codebook table takes the rank's d/M columns and the head
its K·V/M columns (the per-codebook vocab-parallel CE of
``models/model.py::lm_cross_entropy``).
"""
from __future__ import annotations

import torch

from repro_torch.models import megatron, transformer
from repro_torch.models.layers import dense_init, embed_init, rms_norm


def init_params(generator, cfg, dtype=torch.float32):
    K = cfg.num_codebooks
    return {
        "embed": embed_init(generator, (K, cfg.vocab_size, cfg.d_model),
                            dtype),
        "blocks": transformer.init_stacked_blocks(generator, cfg, dtype),
        "ln_f": torch.ones((cfg.d_model,), dtype=dtype,
                           device=generator.device),
        "head": dense_init(generator, (cfg.d_model, K * cfg.vocab_size),
                           dtype=dtype),
    }


def _embed(params, tokens, cfg=None):
    """tokens: (B, K, T) -> (B, T, d) summed codebook embeddings.  With
    ``cfg`` under a tensor-parallel context that splits d (training): the
    rank's d/M columns of each table summed, gathered over "model"."""
    tp = megatron.current() if cfg is not None else None
    table = params["embed"]
    split = tp is not None and megatron.splits_embed(cfg, tp.columns)
    if split:
        table = tp.cols(table, cfg.d_model, -1)
    out = 0.0
    for k in range(tokens.shape[1]):
        out = out + table[k][tokens[:, k]]
    return tp.gather(out, -1) if split else out


def _with_cond(x, cond):
    if cond is None:
        return x
    return torch.cat([cond.to(x.dtype), x], dim=1)


def _stack_params(params):
    """The params as ``transformer.py`` reads them: codebook 0's table as
    ``embed`` (under the zero tokens) and the (d, K·V) head."""
    return {**params, "embed": params["embed"][0]}


def _zero_trick(params, x):
    """(all-zero tokens (B, T), extra_embeds) whose sum is ``x``."""
    zero_tokens = torch.zeros(x.shape[:2], dtype=torch.int32,
                              device=x.device)
    return zero_tokens, x - params["embed"][0][zero_tokens]


def forward_hidden(params, cfg, tokens, cond=None, use_flash=False,
                   remat=False):
    """Returns final-normed hidden over the token region: (B, T, d)."""
    B, K, T = tokens.shape
    x = _with_cond(_embed(params, tokens, cfg), cond)
    Tt = x.shape[1]
    h, aux = transformer.stack_forward(
        params, cfg, x, transformer._positions(B, Tt, x.device),
        use_flash=use_flash, remat=remat)
    return rms_norm(h[:, -T:], params["ln_f"], cfg.norm_eps), aux


def forward(params, cfg, tokens, cond=None, use_flash=False, remat=False):
    """tokens: (B, K, T); cond: (B, cond_len, d).
    Returns logits (B, T, K, V) over the token region only."""
    B, K, T = tokens.shape
    h, aux = forward_hidden(params, cfg, tokens, cond=cond,
                            use_flash=use_flash, remat=remat)
    return (h @ params["head"]).reshape(B, T, K, cfg.vocab_size), aux


def init_cache(params, cfg, batch, max_len, dtype=torch.float32):
    return transformer.init_cache(params, cfg, batch, max_len, dtype)


def prefill(params, cfg, tokens, cache, cond=None, use_flash=False):
    B, K, T = tokens.shape
    zero_tokens, extra = _zero_trick(
        params, _with_cond(_embed(params, tokens), cond))
    logits, cache = transformer.prefill(
        _stack_params(params), cfg, zero_tokens, cache, use_flash=use_flash,
        extra_embeds=extra)
    return logits[:, -T:].reshape(B, T, K, cfg.vocab_size), cache


def decode_step(params, cfg, token, cache):
    """token: (B, K, 1) -> logits (B, 1, K, V)."""
    B, K, _ = token.shape
    zero_tokens, extra = _zero_trick(params, _embed(params, token))
    logits, cache = transformer.decode_step(
        _stack_params(params), cfg, zero_tokens, cache, extra_embeds=extra)
    return logits.reshape(B, 1, K, cfg.vocab_size), cache


# ------------------------------------------------------------------
# Paged-engine entry points.  Positions are MERGED coordinates: the
# cond frames occupy [0, cond_len) of the cache, tokens follow — the
# engine's frontier / total / pos all count merged positions.
# ------------------------------------------------------------------

def init_paged_cache(params, cfg, num_slots, num_pages, page_size, max_pages,
                     dtype=torch.float32):
    return transformer.init_paged_cache(params, cfg, num_slots, num_pages,
                                        page_size, max_pages, dtype)


def prefill_chunk(params, cfg, tokens, cache, slot, frontier, valid,
                  cond=None):
    """One prefill chunk.  tokens: (1, K, C) aligned to MERGED positions
    frontier .. frontier + C - 1 (the engine zero-fills entries whose
    position falls in the cond region or the padded tail).  Rows in the
    cond region take the conditioning frame instead of the token
    embedding — row for row what ``_with_cond`` builds for the whole
    prompt.  Returns logits (1, C, K, V): only token-region rows are
    meaningful."""
    B, K, C = tokens.shape
    x = _embed(params, tokens)                          # (1, C, d)
    if cond is not None:
        cl = cond.shape[1]
        p = frontier + torch.arange(C, dtype=torch.int64, device=x.device)
        crow = cond[0][torch.clamp(p, 0, cl - 1)].to(x.dtype)[None]
        x = torch.where((p < cl)[None, :, None], crow, x)
    zero_tokens, extra = _zero_trick(params, x)
    logits, cache = transformer.prefill_chunk(
        _stack_params(params), cfg, zero_tokens, cache, slot, frontier,
        valid, extra_embeds=extra)
    return logits.reshape(B, C, K, cfg.vocab_size), cache


def decode_step_paged(params, cfg, token, cache, active, use_kernel=False):
    B, K, _ = token.shape
    zero_tokens, extra = _zero_trick(params, _embed(params, token))
    logits, cache = transformer.decode_step_paged(
        _stack_params(params), cfg, zero_tokens, cache, active,
        extra_embeds=extra, use_kernel=use_kernel)
    return logits.reshape(B, 1, K, cfg.vocab_size), cache
