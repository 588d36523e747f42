"""Shared building blocks: RMSNorm, RoPE, SwiGLU, cross-entropy,
initializers.

Port of ``repro/models/layers.py``.  Weights keep the reference layout,
``(d_in, d_out)``, so every projection is ``x @ w``.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, in_axis=-2,
               dtype=torch.float32):
    """LeCun-normal fan-in init, drawn on ``generator``'s device."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    w.normal_(generator=generator).div_(math.sqrt(fan_in))
    return w.to(dtype)


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


def chunked_cross_entropy(h, head_w, labels, chunk: int = 512,
                          num_streams: int = 0):
    """Mean next-token CE computed in T-chunks so the (B, T, V) logits
    tensor is never materialized whole (V is 151936 for Qwen2.5).

    h: (B, T, d); head_w: (d, V) or (d, K*V); labels: (B, T) int, or
    (B, T, K) with ``num_streams=K`` for multi-codebook (audio) heads.
    The reference rematerializes each chunk in the backward
    (``jax.checkpoint``); here autograd keeps each chunk's logits for the
    backward — one chunk is B x chunk x V floats (311 MB at B 2, T 256,
    V 151936), and the single-chunk case (T not a multiple of ``chunk``)
    has nothing to recompute anyway."""
    B, T, d = h.shape
    if T % chunk:
        chunk = T                       # degenerate: single chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, chunk):
        logits = (h[:, i:i + chunk] @ head_w).float()
        if num_streams:
            logits = logits.reshape(*logits.shape[:2], num_streams, -1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, i:i + chunk, ..., None].long())[
            ..., 0]
        total = total + (lse - gold).sum()
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
