"""Token selection: greedy (temperature 0) / temperature / top-k.

One code path for the engine's decode chunk, the naive reference loop,
and the first token taken from the PREFILL logits.  Random draws come
from an explicit ``torch.Generator`` (on the logits' device); greedy
needs none.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 -> greedy argmax
    top_k: int = 0               # 0 -> no truncation


def select_tokens(logits, generator, sp: SamplingParams):
    """logits: (..., V) -> (...) int32 token ids.  Greedy takes the FIRST
    maximal index, as ``jnp.argmax`` does."""
    if sp.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / sp.temperature
    if 0 < sp.top_k < logits.shape[-1]:
        kth = torch.topk(logits, sp.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def make_token_selector(cfg, sp: SamplingParams):
    """(logits, generator) -> next decode input tokens.

    Handles the family shapes uniformly: logits (B, T, V) -> (B, 1)
    for text families; (B, T, K, V) -> (B, K, 1) for audio streams.
    Only the LAST time step's logits are consumed.
    """
    def next_tokens(logits, generator):
        last = logits[:, -1]                     # (B, V) or (B, K, V)
        return select_tokens(last, generator, sp)[..., None]
    return next_tokens
