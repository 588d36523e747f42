"""The naive generation loop — the engine's exact-match oracle.

Port of ``repro/serving/naive.py``: one batch of same-length prompts,
the first generated token selected from the prefill logits
(``logits[:, -1]``), then one decode per further token, so after
prefill(T) plus G decode steps ``cache_positions(cache) == T + G``.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import build_model
from repro_torch.serving.sampling import SamplingParams, make_token_selector


def make_naive_fns(cfg, sampling: SamplingParams = SamplingParams()):
    """Returns (prefill, decode, selector)."""
    model = build_model(cfg)
    return model.prefill, model.decode, make_token_selector(cfg, sampling)


def naive_generate(fns, params, batch, cache, gen: int, generator=None):
    """Emits ``gen`` tokens per row: token 1 from the prefill logits,
    tokens 2..gen from ``gen - 1`` decode steps.  Returns
    (tokens (B, gen) | (B, K, gen), final cache).  ``generator`` feeds
    sampled (non-greedy) selection; it defaults to seed 0 on the
    params' device."""
    prefill, decode, selector = fns
    if generator is None:
        generator = torch.Generator(
            device=params["embed"].device).manual_seed(0)
    logits, cache = prefill(params, batch, cache)
    tok = selector(logits, generator)            # (B, 1) or (B, K, 1)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = decode(params, {"tokens": tok}, cache)
        tok = selector(logits, generator)
        out.append(tok)
    return torch.cat(out, dim=-1), cache
