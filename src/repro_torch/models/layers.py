"""Shared building blocks: RMSNorm, RoPE, SwiGLU, cross-entropy,
initializers.

Port of ``repro/models/layers.py``.  Weights keep the reference layout,
``(d_in, d_out)``, so every projection is ``x @ w``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint


def dense_init(generator: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32):
    """LeCun-normal fan-in init, drawn on ``generator``'s device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    w.normal_(generator=generator).div_(math.sqrt(fan_in))
    return w.to(dtype)


def device_index(i, device):
    """``i`` as a (1,) int64 tensor on ``device``: a Python int, or a
    1-element int64 tensor already there (then returned as it is).  The
    serving engine's captured prefills hand every per-request integer
    (slot, frontier, valid length, prompt extent) in as a device value: a
    Python int reaching a CUDA graph is baked into it, and indexing by a
    0-dim tensor reads it back to the host."""
    return torch.as_tensor(i, dtype=torch.int64, device=device).reshape(1)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32):
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return w.normal_(generator=generator).mul_(0.02).to(dtype)


def rms_norm(x, weight, eps=1e-5):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight).to(dtype)


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """log(1 + exp(x)), as ``jax.nn.softplus``."""
    return torch.nn.functional.softplus(x)


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


# ------------------------------------------------------------------
# Rotary position embeddings
# ------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _chunk_nll_sum(hc, head_w, lc, num_streams: int):
    """Summed next-token NLL of one T-chunk: its logits, logsumexp minus
    the gold logit."""
    logits = (hc @ head_w).float()
    if num_streams:
        logits = logits.reshape(*logits.shape[:2], num_streams, -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_cross_entropy(h, head_w, labels, chunk: int = 512,
                          num_streams: int = 0):
    """Mean next-token CE computed in T-chunks so the (B, T, V) logits
    tensor is never materialized whole (V is 151936 for Qwen2.5).

    h: (B, T, d); head_w: (d, V) or (d, K*V); labels: (B, T) int, or
    (B, T, K) with ``num_streams=K`` for multi-codebook (audio) heads.
    Each chunk runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): the backward recomputes one chunk's logits at a
    time, so it holds O(B x chunk x V) floats (311 MB at B 1, chunk 512,
    V 151936), not the whole (B, T, V); the recompute runs the same ops,
    so the values and grads are those of the saved forward bit for bit.
    The single-chunk case (T not a multiple of ``chunk``) recomputes its
    one chunk too."""
    B, T, d = h.shape
    if T % chunk:
        chunk = T                       # degenerate: single chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, chunk):
        total = total + checkpoint(_chunk_nll_sum, h[:, i:i + chunk], head_w,
                                   labels[:, i:i + chunk], num_streams,
                                   use_reentrant=False)
    return total / (B * T * (num_streams or 1))


def _chunk_nll_sum_vocab(hc, head_w, lc, tp, lo: int, vocab: int,
                         num_streams: int):
    """:func:`_chunk_nll_sum` of the rank's columns [lo, lo + W) of the
    head's ``max(num_streams, 1)`` streams of ``vocab`` logits side by
    side: per stream, the max and the sum of exponentials over its part
    (empty on a rank that holds none of it) taken over "model" (the max
    all-reduced without grad, the sums and the target logits, which only
    their holders have, in one all-reduce)."""
    logits = (hc @ head_w).float()                      # (B, c, W)
    W = logits.shape[-1]
    K = max(num_streams, 1)
    lab = lc.long() if num_streams else lc.long()[..., None]   # (B, c, K)
    parts = [(max(k * vocab, lo) - lo, min((k + 1) * vocab, lo + W) - lo)
             for k in range(K)]
    det = logits.detach()
    shift = torch.stack([det[..., a:b].amax(-1) if a < b else
                         det.new_full(det.shape[:-1], float("-inf"))
                         for a, b in parts], -1).contiguous()
    shift = tp.max_(shift)                              # (B, c, K)
    sumexp = torch.stack([
        torch.exp(logits[..., a:b] - shift[..., k:k + 1]).sum(-1)
        if a < b else logits.new_zeros(logits.shape[:-1])
        for k, (a, b) in enumerate(parts)], -1)
    local = lab + torch.arange(K, device=lab.device) * vocab - lo
    mine = (local >= 0) & (local < W)
    gold = logits.gather(-1, local.clamp(0, W - 1)) * mine
    sumexp, gold = tp.reduce(torch.stack([sumexp, gold])).unbind(0)
    return (shift + torch.log(sumexp) - gold).sum()


def vocab_parallel_cross_entropy(h, head_w, labels, tp, vocab: int,
                                 chunk: int = 512, num_streams: int = 0):
    """:func:`chunked_cross_entropy` over a head split over "model" (the
    tensor-parallel context ``tp``): ``head_w`` (d, V/M) is the column of
    vocab ids ``tp.part(vocab)``; with ``num_streams=K`` (labels (B, T,
    K)) the head is K heads of ``vocab`` side by side, (d, K·V/M) the
    rank's contiguous columns ``tp.part(K * vocab)`` of it, and the CE
    the mean over the K streams.  ``h`` enters the split region once
    (its grads summed over "model" in one all-reduce); each chunk runs
    under ``torch.utils.checkpoint``, as there, so one chunk's logits are
    held for the backward, and its recompute repeats the chunk's two
    all-reduces."""
    lo, _ = tp.part(vocab * max(num_streams, 1))
    h = tp.copy(h)
    B, T = h.shape[:2]
    if T % chunk:
        chunk = T
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, chunk):
        total = total + checkpoint(_chunk_nll_sum_vocab, h[:, i:i + chunk],
                                   head_w, labels[:, i:i + chunk], tp, lo,
                                   vocab, num_streams, use_reentrant=False)
    return total / (B * T * (num_streams or 1))


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE.  logits: (..., V); labels: (...,) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: (..., T) int32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)       # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
