"""VLM backbone (InternVL2-1B-style, arXiv:2404.16821).

Port of ``repro/models/vlm.py``.  The vision frontend (InternViT + MLP
projector) is a stub, as in the reference: requests carry precomputed
patch embeddings of shape (B, num_patches, d_model).  This module is the
language decoder that consumes them: the RMS-normed (``patch_ln``) patch
embeddings take the first ``num_patches`` token positions (the <img>
placeholder region, cut short when the prompt is shorter), the token
embeddings the rest, then the dense decoder of ``transformer.py`` runs
(``use_flash`` reaches K3, the paged decode's ``use_kernel`` K8).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.layers import rms_norm


def init_params(generator, cfg, dtype=torch.float32):
    p = transformer.init_params(generator, cfg, dtype)
    # learned norm weight applied to incoming patch embeddings
    p["patch_ln"] = torch.ones((cfg.d_model,), dtype=dtype,
                               device=generator.device)
    return p


def _merge(params, cfg, tokens, patch_embeds):
    """The additive embedding stream and the token mask: patches occupy
    positions [0, num_patches), text embeddings the rest (the mask
    zeroes the placeholder tokens' embeddings)."""
    B, T = tokens.shape
    npatch = min(patch_embeds.shape[1], T)   # prompt shorter than the image
    pe = rms_norm(patch_embeds[:, :npatch], params["patch_ln"], cfg.norm_eps)
    extra = torch.cat([pe, pe.new_zeros((B, T - npatch, cfg.d_model))],
                      dim=1)
    mask = (torch.arange(T, device=tokens.device) >= npatch).to(
        extra.dtype)[None, :, None]
    return extra, mask


def forward_hidden(params, cfg, tokens, patch_embeds, use_flash=False):
    B, T = tokens.shape
    extra, mask = _merge(params, cfg, tokens, patch_embeds)
    x = params["embed"][tokens] * mask + extra
    h, aux = transformer.stack_forward(
        params, cfg, x, transformer._positions(B, T, x.device),
        use_flash=use_flash)
    return rms_norm(h, params["ln_f"], cfg.norm_eps), aux


def forward(params, cfg, tokens, patch_embeds, use_flash=False):
    h, aux = forward_hidden(params, cfg, tokens, patch_embeds,
                            use_flash=use_flash)
    return h @ transformer.head_matrix(params, cfg), aux


def init_cache(params, cfg, batch, max_len, dtype=torch.float32):
    return transformer.init_cache(params, cfg, batch, max_len, dtype)


def prefill(params, cfg, tokens, patch_embeds, cache, use_flash=False):
    """``transformer.prefill`` over the merged embeddings, handed in as
    ``extra_embeds`` with the mask baked in (emb * mask + patches), as
    the reference computes them."""
    extra, mask = _merge(params, cfg, tokens, patch_embeds)
    emb = params["embed"][tokens]
    extra = extra - emb * (1.0 - mask)
    return transformer.prefill(params, cfg, tokens, cache,
                               use_flash=use_flash, extra_embeds=extra)


def decode_step(params, cfg, token, cache):
    return transformer.decode_step(params, cfg, token, cache)


# ------------------------------------------------------------------
# Paged-engine entry points
# ------------------------------------------------------------------

def init_paged_cache(params, cfg, num_slots, num_pages, page_size, max_pages,
                     dtype=torch.float32):
    return transformer.init_paged_cache(params, cfg, num_slots, num_pages,
                                        page_size, max_pages, dtype)


def prefill_chunk(params, cfg, tokens, patch_embeds, cache, slot, frontier,
                  valid, total):
    """One prefill chunk with the patch/text merge done chunk-locally:
    absolute positions < min(num_patches, total) take the (normed) patch
    embedding, the rest the token embedding — row for row the values
    ``_merge`` gives the whole prompt."""
    C = tokens.shape[1]
    npatch = patch_embeds.shape[1]
    pe = rms_norm(patch_embeds, params["patch_ln"], cfg.norm_eps)
    p = frontier + torch.arange(C, dtype=torch.int64, device=tokens.device)
    in_img = (p < min(npatch, total))[None, :, None]
    rows = pe[0][torch.clamp(p, 0, npatch - 1)][None]        # (1, C, d)
    emb = params["embed"][tokens]
    extra = (torch.where(in_img, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
             - emb * in_img.to(emb.dtype))
    return transformer.prefill_chunk(params, cfg, tokens, cache, slot,
                                     frontier, valid, extra_embeds=extra)


def decode_step_paged(params, cfg, token, cache, active, use_kernel=False):
    return transformer.decode_step_paged(params, cfg, token, cache, active,
                                         use_kernel=use_kernel)
