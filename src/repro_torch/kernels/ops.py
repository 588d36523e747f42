"""Public wrappers for the port's kernels (mirrors ``repro/kernels/ops.py``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises —
there is no fallback.  A CPU tensor takes the kernel's plain PyTorch
version.  Only K8 (paged attention) is ported so far; the other TPU
kernels of the reference are listed in ROADMAP.md queue 2.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa


def paged_attention(q, k_pool, v_pool, table, lengths):
    """Single-token paged decode attention: q (B, H, hd) against the
    pages named by ``table`` (B, M), ``lengths`` (B,) live positions."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pool, v_pool, table, lengths)
    return _pa.paged_attention_cuda(q, k_pool, v_pool, table, lengths)
