"""Family dispatch: a uniform Model API over the architecture families.

Port of ``repro/models/model.py``: all six families (dense, moe, ssm,
hybrid, vlm, audio).

    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    logits, aux = model.apply(params, batch)          # forward
    loss, aux  = model.loss(params, batch)            # training loss
    cache      = model.init_cache(params, batch_size, max_len)
    logits, cache = model.prefill(params, batch, cache)
    logits, cache = model.decode(params, batch, cache)

``batch`` is a dict; its keys per family (see data/synthetic.py):
    dense / moe / ssm / hybrid : tokens (B, T), labels (B, T)
    vlm                        : tokens, labels, patch_embeds (B, P, d)
    audio                      : tokens (B, K, T), labels (B, K, T),
                                 cond (B, cond_len, d)

Cache position contract (``cache_positions`` / ``with_cache_positions``):
every cache tuple carries one or more ``pos`` fields counting tokens
absorbed so far.  ``prefill`` over T tokens advances pos by EXACTLY T and
each ``decode`` call by EXACTLY 1 — so after prefill(T) + G decodes,
``cache_positions(cache) == T + G``.  The first generated token comes
from the PREFILL logits (``logits[:, -1]``).  ``pos`` may be a scalar or a
(B,) vector — the serving engine uses the vector form so every batch
row (slot) keeps its own offset.  Cache buffers are updated in place;
the returned tuple names the same storage with the new ``pos``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models import audio as audio_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import mamba2 as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models import vlm as vlm_mod
from repro_torch.models import megatron
from repro_torch.models.layers import (chunked_cross_entropy,
                                       vocab_parallel_cross_entropy)


@dataclass(frozen=True)
class Model:
    cfg: Any
    init: Callable               # (generator, dtype=f32) -> params
    apply: Callable              # (params, batch) -> (logits, aux)
    init_cache: Callable         # (params, batch_size, max_len) -> cache
    prefill: Callable            # (params, batch, cache[, valid]) ->
                                 # (logits, cache); ``valid`` marks tokens
                                 # >= valid as bucket padding
    decode: Callable             # (params, batch, cache) -> (logits, cache)
    loss: Callable = None        # (params, batch) -> (scalar, aux)
    # paged serving — page-pool cache, chunked prefill, masked decode
    init_paged_cache: Callable = None
    # (params, num_slots, num_pages, page_size, max_pages) -> cache
    prefill_chunk: Callable = None
    # (params, batch, cache, slot, frontier, valid, total) -> (logits, cache):
    # one (1, C)-token chunk of one slot's prompt; ``frontier`` its absolute
    # start, ``valid`` the live rows, ``total`` the full prompt extent.  The
    # four integers may be Python ints or (1,) int64 device tensors (the
    # engine's captured chunk reads them from a device buffer), and so
    # may ``prefill``'s ``valid``
    decode_paged: Callable = None
    # (params, batch, cache, active) -> (logits, cache): one decode step over
    # the slot batch; ``active`` (B,) bool freezes inactive rows
    paged_to_dense: Callable = None
    # (paged_cache) -> dense cache view: page tables are constant within a
    # decode chunk, so the engine gathers once and loops plain ``decode``
    paged_restore: Callable = None
    # (paged_cache, dense_cache, active, steps) -> paged_cache: scatter the
    # chunk's view back (inactive rows -> trash page, pos frozen)


def is_pos_entry(name) -> bool:
    """Whether a cache field name names a position counter."""
    return name == "pos"


def _is_cache(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_asdict")


def _find_pos(cache):
    for name, leaf in cache._asdict().items():
        if is_pos_entry(name):
            return leaf
        if _is_cache(leaf):
            found = _find_pos(leaf)
            if found is not None:
                return found
    return None


def cache_positions(cache):
    """The cache's token count: () or (B,) int32.

    Every cache NamedTuple (nested or not) tags its counters as ``pos``
    fields; they all advance in lockstep, so any one of them is *the*
    position.  Returns the first.
    """
    pos = _find_pos(cache)
    if pos is None:
        raise ValueError("cache has no 'pos' field")
    return pos


def with_cache_positions(cache, pos):
    """Return ``cache`` with EVERY ``pos`` field replaced by ``pos``.

    Passing a (num_slots,) vector switches the cache to per-slot
    offsets — the layout the serving engine decodes with.  Each field
    gets its own buffer: several pos fields must not alias, since they
    are updated in place.
    """
    pos = torch.as_tensor(pos, dtype=torch.int32)
    repl = {}
    for name, leaf in cache._asdict().items():
        if is_pos_entry(name):
            repl[name] = pos.to(leaf.device).clone()
        elif _is_cache(leaf):
            repl[name] = with_cache_positions(leaf, pos)
    return cache._replace(**repl)


def lm_cross_entropy(params, cfg, h, labels):
    """The LM head's T-chunked CE of the hidden states ``h`` (the audio
    family's: the mean over its K codebook heads, ``labels`` (B, T, K));
    under a tensor-parallel context that splits the head (an untied
    one), vocab-parallel.  A tied head is read whole on every rank."""
    K = cfg.num_codebooks if cfg.family == "audio" else 0
    tp = megatron.current()
    if tp is not None and megatron.splits_head(cfg, tp.columns):
        return vocab_parallel_cross_entropy(
            h, tp.cols(params["head"], megatron.head_width(cfg), -1),
            labels, tp, cfg.vocab_size, num_streams=K)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return chunked_cross_entropy(h, head, labels, num_streams=K)


def _lm_loss(hidden_fn, cfg):
    """Hidden states + T-chunked CE: the (B, T, V) logits tensor is
    never materialized whole (the audio family's labels (B, K, T) read
    as (B, T, K)).  The loss carries its ``cfg`` (the training step
    under a mesh reads it for the Megatron split)."""
    def loss(params, batch):
        h, aux = hidden_fn(params, batch)
        labels = batch["labels"]
        if cfg.family == "audio":
            labels = labels.transpose(1, 2)
        ce = lm_cross_entropy(params, cfg, h, labels)
        return ce + aux, {"ce": ce, "aux": aux}
    loss.cfg = cfg
    return loss


def build_model(cfg, use_flash: bool = False, remat=False,
                use_paged_kernel: bool = False) -> Model:
    """``remat`` (False, True or "dots"; ``transformer._remat``) recomputes
    each block of the training forward in the backward; it reaches
    ``loss`` and ``apply`` only, as in the reference.  ``use_flash``
    sends full causal attention (``apply``, ``loss`` and,
    where the reference passes it, ``prefill``) through the
    flash-attention kernel (K3; forward only, as the reference);
    ``use_paged_kernel`` sends paged decode attention through the
    paged-attention kernel (K8).  The ssm family takes neither, as in the
    reference; its SSD-scan kernel (K9), and the hybrid's, are reached
    through ``mamba2.forward`` / ``hybrid.forward`` with
    ``use_kernel=True``."""
    fam = cfg.family
    if fam in ("dense", "moe"):
        return Model(
            cfg=cfg,
            init=lambda generator, dtype=torch.float32:
                tfm.init_params(generator, cfg, dtype),
            apply=lambda p, b: tfm.forward(p, cfg, b["tokens"],
                                           use_flash=use_flash, remat=remat),
            init_cache=lambda p, bs, ml, dtype=torch.float32:
                tfm.init_cache(p, cfg, bs, ml, dtype),
            prefill=lambda p, b, c, valid=None:
                tfm.prefill(p, cfg, b["tokens"], c, use_flash=use_flash),
            decode=lambda p, b, c: tfm.decode_step(p, cfg, b["tokens"], c),
            loss=_lm_loss(lambda p, b: tfm.forward_hidden(
                p, cfg, b["tokens"], use_flash=use_flash, remat=remat), cfg),
            init_paged_cache=lambda p, bs, np_, ps, mp, dtype=torch.float32:
                tfm.init_paged_cache(p, cfg, bs, np_, ps, mp, dtype),
            prefill_chunk=lambda p, b, c, slot, frontier, valid, total:
                tfm.prefill_chunk(p, cfg, b["tokens"], c, slot, frontier,
                                  valid),
            decode_paged=lambda p, b, c, active:
                tfm.decode_step_paged(p, cfg, b["tokens"], c, active,
                                      use_kernel=use_paged_kernel),
            paged_to_dense=tfm.paged_to_dense,
            paged_restore=tfm.paged_restore,
        )
    if fam == "ssm":
        return Model(
            cfg=cfg,
            init=lambda generator, dtype=torch.float32:
                ssm_mod.init_params(generator, cfg, dtype),
            apply=lambda p, b: ssm_mod.forward(p, cfg, b["tokens"],
                                               remat=remat),
            init_cache=lambda p, bs, ml, dtype=torch.float32:
                ssm_mod.init_cache(cfg, bs, dtype,
                                   device=p["embed"].device),
            prefill=lambda p, b, c, valid=None:
                ssm_mod.prefill(p, cfg, b["tokens"], c, valid=valid),
            decode=lambda p, b, c: ssm_mod.decode_step(p, cfg, b["tokens"],
                                                       c),
            loss=_lm_loss(lambda p, b: ssm_mod.forward_hidden(
                p, cfg, b["tokens"], remat=remat), cfg),
            init_paged_cache=lambda p, bs, np_, ps, mp, dtype=torch.float32:
                ssm_mod.init_paged_cache(p, cfg, bs, np_, ps, mp, dtype),
            prefill_chunk=lambda p, b, c, slot, frontier, valid, total:
                ssm_mod.prefill_chunk(p, cfg, b["tokens"], c, slot,
                                      frontier, valid),
            decode_paged=lambda p, b, c, active:
                ssm_mod.decode_step_paged(p, cfg, b["tokens"], c, active),
            paged_to_dense=ssm_mod.paged_to_dense,
            paged_restore=ssm_mod.paged_restore,
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda generator, dtype=torch.float32:
                hybrid_mod.init_params(generator, cfg, dtype),
            apply=lambda p, b: hybrid_mod.forward(p, cfg, b["tokens"],
                                                  remat=remat,
                                                  use_flash=use_flash),
            init_cache=lambda p, bs, ml, dtype=torch.float32:
                hybrid_mod.init_cache(cfg, bs, ml, dtype,
                                      device=p["embed"].device),
            prefill=lambda p, b, c, valid=None:
                hybrid_mod.prefill(p, cfg, b["tokens"], c,
                                   use_flash=use_flash, valid=valid),
            decode=lambda p, b, c: hybrid_mod.decode_step(p, cfg,
                                                          b["tokens"], c),
            loss=_lm_loss(lambda p, b: hybrid_mod.forward_hidden(
                p, cfg, b["tokens"], remat=remat, use_flash=use_flash), cfg),
            init_paged_cache=lambda p, bs, np_, ps, mp, dtype=torch.float32:
                hybrid_mod.init_paged_cache(p, cfg, bs, np_, ps, mp, dtype),
            prefill_chunk=lambda p, b, c, slot, frontier, valid, total:
                hybrid_mod.prefill_chunk(p, cfg, b["tokens"], c, slot,
                                         frontier, valid),
            decode_paged=lambda p, b, c, active:
                hybrid_mod.decode_step_paged(p, cfg, b["tokens"], c, active,
                                             use_kernel=use_paged_kernel),
            paged_to_dense=hybrid_mod.paged_to_dense,
            paged_restore=hybrid_mod.paged_restore,
        )
    if fam == "vlm":
        return Model(
            cfg=cfg,
            init=lambda generator, dtype=torch.float32:
                vlm_mod.init_params(generator, cfg, dtype),
            apply=lambda p, b: vlm_mod.forward(p, cfg, b["tokens"],
                                               b["patch_embeds"],
                                               use_flash=use_flash,
                                               remat=remat),
            init_cache=lambda p, bs, ml, dtype=torch.float32:
                vlm_mod.init_cache(p, cfg, bs, ml, dtype),
            prefill=lambda p, b, c, valid=None:
                vlm_mod.prefill(p, cfg, b["tokens"], b["patch_embeds"], c),
            decode=lambda p, b, c: vlm_mod.decode_step(p, cfg, b["tokens"],
                                                       c),
            loss=_lm_loss(lambda p, b: vlm_mod.forward_hidden(
                p, cfg, b["tokens"], b["patch_embeds"],
                use_flash=use_flash, remat=remat), cfg),
            init_paged_cache=lambda p, bs, np_, ps, mp, dtype=torch.float32:
                vlm_mod.init_paged_cache(p, cfg, bs, np_, ps, mp, dtype),
            prefill_chunk=lambda p, b, c, slot, frontier, valid, total:
                vlm_mod.prefill_chunk(p, cfg, b["tokens"], b["patch_embeds"],
                                      c, slot, frontier, valid, total),
            decode_paged=lambda p, b, c, active:
                vlm_mod.decode_step_paged(p, cfg, b["tokens"], c, active,
                                          use_kernel=use_paged_kernel),
            paged_to_dense=tfm.paged_to_dense,
            paged_restore=tfm.paged_restore,
        )
    if fam == "audio":
        return Model(
            cfg=cfg,
            init=lambda generator, dtype=torch.float32:
                audio_mod.init_params(generator, cfg, dtype),
            apply=lambda p, b: audio_mod.forward(p, cfg, b["tokens"],
                                                 b.get("cond"),
                                                 use_flash=use_flash,
                                                 remat=remat),
            init_cache=lambda p, bs, ml, dtype=torch.float32:
                audio_mod.init_cache(p, cfg, bs, ml, dtype),
            prefill=lambda p, b, c, valid=None:
                audio_mod.prefill(p, cfg, b["tokens"], c, cond=b.get("cond")),
            decode=lambda p, b, c: audio_mod.decode_step(p, cfg,
                                                         b["tokens"], c),
            loss=_lm_loss(lambda p, b: audio_mod.forward_hidden(
                p, cfg, b["tokens"], b.get("cond"), use_flash=use_flash,
                remat=remat), cfg),
            init_paged_cache=lambda p, bs, np_, ps, mp, dtype=torch.float32:
                audio_mod.init_paged_cache(p, cfg, bs, np_, ps, mp, dtype),
            prefill_chunk=lambda p, b, c, slot, frontier, valid, total:
                audio_mod.prefill_chunk(p, cfg, b["tokens"], c, slot,
                                        frontier, valid, cond=b.get("cond")),
            decode_paged=lambda p, b, c, active:
                audio_mod.decode_step_paged(p, cfg, b["tokens"], c, active,
                                            use_kernel=use_paged_kernel),
            paged_to_dense=tfm.paged_to_dense,
            paged_restore=tfm.paged_restore,
        )
    raise ValueError(f"unknown family: {fam}")
