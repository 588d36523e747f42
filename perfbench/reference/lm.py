"""The language-model loss and the served-token gaps of a plain
reference (a model-type module with ``hidden`` and ``logits``)."""
from __future__ import annotations

import torch

from perfbench.reference.products import F32


def loss(model, params, cfg, tokens, labels, P=F32):
    """Mean next-token cross-entropy over every position of (B, T)."""
    lg = model.logits(params, cfg, model.hidden(params, cfg, tokens, P), P)
    lg = lg.float()
    gold = lg.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(lg, -1) - gold).mean()


@torch.no_grad()
def served_logits(model, params, cfg, prompt, served, P=F32, rows=512):
    """The logits (G, V) that predict each of the G ``served`` tokens
    after ``prompt``, from one causal forward over prompt + served[:-1]
    (the head applied ``rows`` positions at a time)."""
    seq = torch.cat([prompt, served[:-1]])[None]
    h = model.hidden(params, cfg, seq, P)[0, prompt.shape[0] - 1:]
    return torch.cat([model.logits(params, cfg, h[i:i + rows], P).float()
                      for i in range(0, h.shape[0], rows)])


def widest_gap(ref_logits, tokens) -> float:
    """The widest gap by which a token's logit lies below the best logit
    of its row (0 where every token is a row's best)."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())
