"""Public wrappers for the port's kernels (mirrors ``repro/kernels/ops.py``).

A CUDA tensor launches the hand-written kernel, or the wrapper raises —
there is no fallback.  A CPU tensor takes the kernel's plain PyTorch
version.  Every TPU kernel of the reference has its counterpart: K1 and
K2 (the Parle updates), K3 (causal flash attention), K4-K6 (the int8
compressed sync), K7 (the Elastic-SGD worker step), K8 (paged attention)
and K9 (the chunked SSD scan).  Models call them through
``use_flash=True`` / ``use_kernel=True`` / ``use_paged_kernel=True``; the
default model path is the plain one.
"""
from __future__ import annotations

import torch

from repro_torch.core import compress
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import parle_update as _pu
from repro_torch.kernels import ssd_scan as _ssd


def _forward_only(kernel: str, flag: str, *tensors) -> None:
    """The reference's flash and SSD kernels have no VJP (``jax.grad``
    through them fails), so neither port has a backward: a call autograd
    would have to differentiate raises instead of returning a result with
    no grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} is forward only: the reference "
                           f"defines no VJP for its kernel, so {flag} "
                           "cannot be differentiated (train without it)")


def flash_attention(q, k, v, window: int = 0):
    """Causal (optionally sliding-window) attention over q, k, v
    (B, T, H, hd), GQA already expanded (K3).  Forward only (see
    :func:`_forward_only`).  The Pallas kernel's ``block_q`` / ``block_k``
    are not taken: the CUDA kernel always tiles 64 x 64."""
    _forward_only("flash_attention (K3)", "use_flash=True", q, k, v)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, window=window)
    return _fa.flash_attention_cuda(q, k, v, window=window)


def paged_attention(q, k_pool, v_pool, table, lengths):
    """Single-token paged decode attention: q (B, H, hd) against the
    pages named by ``table`` (B, M), ``lengths`` (B,) live positions."""
    if q.device.type == "cpu":
        return _pa.paged_attention_plain(q, k_pool, v_pool, table, lengths)
    return _pa.paged_attention_cuda(q, k_pool, v_pool, table, lengths)


def ssd_scan(x, dt, A, B_mat, C_mat, chunk: int = 128, h0=None):
    """The Mamba2 selective scan over chunks of ``min(chunk, T)`` tokens
    (K9): x (B, T, nh, P), dt (B, T, nh), A (nh,), B_mat / C_mat
    (B, T, N).  Returns (y, final state).  The kernel starts from a zero
    state, so a call with ``h0`` (a resumed prefix) takes the model's
    chunked path, as the reference dispatches.  T must be a multiple of
    the chunk, as the reference asserts.  Forward only, like K3."""
    if h0 is not None:
        from repro_torch.models.mamba2 import ssd_chunked
        return ssd_chunked(x, dt, A, B_mat, C_mat, chunk, h0=h0)
    _forward_only("ssd_scan (K9)", "use_kernel=True", x, dt, A, B_mat,
                  C_mat)
    T = x.shape[1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"ssd_scan: T {T} is not a multiple of the chunk "
                         f"{Q}")
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, B_mat, C_mat)
    return _ssd.ssd_scan_cuda(x, dt, A.float().contiguous(), B_mat, C_mat,
                              Q)


def _check_y_out(fn, y_out):
    if y_out is not None and y_out.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: y_out is the fused bf16 compute copy, got "
                        f"{y_out.dtype}; with float32 compute y' is x'")


def _copy_into(bufs, news):
    for buf, new in zip(bufs, news):
        if buf is not None:
            buf.copy_(new)


def parle_inner_update(y, z, v, g, x, *, inv_gamma, lr, mu, alpha):
    """Fused Parle inner step (Eq. 8a-8b, K1) over flat state buffers
    of one shape: y and g in the compute dtype, z, v and x float32.
    Updates y, z and v IN PLACE and returns them."""
    scalars = _pu.pack_scalars(inv_gamma, lr, mu, alpha, device=y.device)
    if y.device.type == "cpu":
        _copy_into((y, z, v), _pu.parle_inner_update_plain(y, z, v, g, x,
                                                            scalars))
        return y, z, v
    return _pu.parle_inner_update_cuda(y, z, v, g, x, scalars)


def parle_sync_update(x, z, v, xbar, *, gamma_scale, inv_rho, lr, mu,
                      y_out=None):
    """Fused Parle sync step (Eq. 8c-8d, K2): x, z, v (R, M) float32
    against the un-broadcast replica mean ``xbar`` (M,).  Updates x and v
    IN PLACE.  Always returns (x', v', y'): with a bf16 ``y_out`` the
    cast y' = bf16(x') is written into it by the same pass; otherwise y'
    IS x' (the caller copies it where it needs a distinct buffer)."""
    _check_y_out("parle_sync_update", y_out)
    scalars = _pu.pack_scalars(gamma_scale, inv_rho, lr, mu, device=x.device)
    if x.device.type == "cpu":
        _copy_into((x, v, y_out), _pu.parle_sync_update_plain(
            x, z, v, xbar, scalars,
            y_dtype=y_out.dtype if y_out is not None else None))
    else:
        _pu.parle_sync_update_cuda(x, z, v, xbar, scalars, y_out=y_out)
    return x, v, (y_out if y_out is not None else x)


def elastic_worker_update(x, v, g, ref, *, inv_rho, lr, mu):
    """Fused Elastic-SGD worker step (Eq. 7a, K7): x, v (R, M) float32 and
    the grads g (R, M) in the compute dtype against the un-broadcast
    reference variable ``ref`` (M,).  Updates x and v IN PLACE and returns
    them; ref is only read (its Eq. 7b update is the caller's)."""
    scalars = _pu.pack_scalars(inv_rho, lr, mu, device=x.device)
    if x.device.type == "cpu":
        _copy_into((x, v), _pu.elastic_worker_update_plain(x, v, g, ref,
                                                           scalars))
        return x, v
    return _pu.elastic_worker_update_cuda(x, v, g, ref, scalars)


def quantize_ef(c, *, in_place: bool = False):
    """Fused per-chunk int8 quantize + error-feedback residual (K4) on a
    flat (R, M) f32 stream, M % 8192 == 0.  Returns (q, scales, residual);
    with ``in_place`` the residual is written over ``c`` (the caller's
    x + e buffer becomes the new e, no (R, M) temporary)."""
    R, M = c.shape
    if c.device.type == "cpu":
        q, s, e = _pu.quantize_ef_plain(c)
        if in_place:
            c.copy_(e)
            e = c
        return q, s, e
    q = torch.empty((R, M), dtype=torch.int8, device=c.device)
    s = torch.empty((R, M // compress.CHUNK), device=c.device)
    e = c if in_place else torch.empty_like(c)
    return _pu.quantize_ef_cuda(c, q, s, e)


def parle_sync_dequant_update(x, z, v, q, s, *, gamma_scale, inv_rho, lr,
                              mu, y_out=None):
    """Fused dequantize + replica mean + sync update (K5, the int8
    compressed sync): x, z, v (R, M) f32 against the mean of the n int8
    payloads q (n, M) with scales s (n, M/1024).  Updates x and v IN
    PLACE; returns (x', v', y') like :func:`parle_sync_update`."""
    _check_y_out("parle_sync_dequant_update", y_out)
    scalars = _pu.pack_scalars(gamma_scale, inv_rho, lr, mu, device=x.device)
    if x.device.type == "cpu":
        _copy_into((x, v, y_out), _pu.parle_sync_dequant_update_plain(
            x, z, v, q, s, scalars,
            y_dtype=y_out.dtype if y_out is not None else None))
    else:
        _pu.parle_sync_dequant_update_cuda(x, z, v, q, s, scalars,
                                           y_out=y_out)
    return x, v, (y_out if y_out is not None else x)


def parle_apply_consensus_quantize(x, z, v, c, e, *, gamma_scale, inv_rho,
                                   lr, mu, y_out=None):
    """Fused staleness-1 overlap head (K6, int8 compressed sync): apply
    the CARRIED consensus ``c`` (M,) (Eq. 8c-8d with the stale mean) and
    quantize the new x + e as the next sync's payload, one memory pass.
    x, v and e are updated IN PLACE.  Returns (x', v', y', q, s, e') —
    y' is x' on f32, the fused cast into ``y_out`` on bf16."""
    _check_y_out("parle_apply_consensus_quantize", y_out)
    scalars = _pu.pack_scalars(gamma_scale, inv_rho, lr, mu, device=x.device)
    if x.device.type == "cpu":
        x2, v2, q, s, e2, *y2 = _pu.parle_apply_quantize_plain(
            x, z, v, c, e, scalars,
            y_dtype=y_out.dtype if y_out is not None else None)
        _copy_into((x, v, e, y_out), (x2, v2, e2, *y2))
    else:
        R, M = x.shape
        q = torch.empty((R, M), dtype=torch.int8, device=x.device)
        s = torch.empty((R, M // compress.CHUNK), device=x.device)
        _pu.parle_apply_quantize_cuda(x, z, v, c, e, q, s, scalars,
                                      y_out=y_out)
    return x, v, (y_out if y_out is not None else x), q, s, e
