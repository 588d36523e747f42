"""Public wrappers for the port's kernels (mirrors ``repro/kernels/ops.py``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises —
there is no fallback.  A CPU tensor takes the kernel's plain PyTorch
version.  Ported so far: K1 and K2 (the Parle updates) and K8 (paged
attention); the other TPU kernels of the reference are listed in
ROADMAP.md queue 2.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import parle_update as _pu


def paged_attention(q, k_pool, v_pool, table, lengths):
    """Single-token paged decode attention: q (B, H, hd) against the
    pages named by ``table`` (B, M), ``lengths`` (B,) live positions."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pool, v_pool, table, lengths)
    return _pa.paged_attention_cuda(q, k_pool, v_pool, table, lengths)


def parle_inner_update(y, z, v, g, x, *, inv_gamma, lr, mu, alpha):
    """Fused Parle inner step (Eq. 8a-8b, K1) over flat state buffers
    of one shape: y and g in the compute dtype, z, v and x float32.
    Updates y, z and v IN PLACE and returns them."""
    scalars = _pu.pack_scalars(inv_gamma, lr, mu, alpha, device=y.device)
    if y.device.type == "cpu":
        for buf, new in zip((y, z, v), _pu.parle_inner_update_plain(
                y, z, v, g, x, scalars)):
            buf.copy_(new)
        return y, z, v
    return _pu.parle_inner_update_cuda(y, z, v, g, x, scalars)


def parle_sync_update(x, z, v, xbar, *, gamma_scale, inv_rho, lr, mu,
                      y_out=None):
    """Fused Parle sync step (Eq. 8c-8d, K2): x, z, v (R, M) float32
    against the un-broadcast replica mean ``xbar`` (M,).  Updates x and v
    IN PLACE.  Always returns (x', v', y'): with a bf16 ``y_out`` the
    cast y' = bf16(x') is written into it by the same pass; otherwise y'
    IS x' (the caller copies it where it needs a distinct buffer)."""
    if y_out is not None and y_out.dtype != torch.bfloat16:
        raise TypeError("parle_sync_update: y_out is the fused bf16 compute "
                        f"copy, got {y_out.dtype}; with float32 compute y' "
                        "is x'")
    scalars = _pu.pack_scalars(gamma_scale, inv_rho, lr, mu, device=x.device)
    if x.device.type == "cpu":
        out = _pu.parle_sync_update_plain(
            x, z, v, xbar, scalars,
            y_dtype=y_out.dtype if y_out is not None else None)
        for buf, new in zip((x, v, y_out), out):
            buf.copy_(new)
    else:
        _pu.parle_sync_update_cuda(x, z, v, xbar, scalars, y_out=y_out)
    return x, v, (y_out if y_out is not None else x)
