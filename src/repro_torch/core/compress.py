"""Lossy compression of the Eq. (8d) sync payload, on torch tensors.  Port
of ``repro/core/compress.py`` (a copy: the port imports nothing of the
JAX package).

  bf16 — round-to-nearest-even bfloat16 cast; half the f32 bytes.
  int8 — symmetric per-chunk quantization (chunk = 1024 elements, one f32
         scale per chunk = max|c| * f32(1/127), or 1 for an all-zero
         chunk); a quarter of the f32 bytes plus ~0.4% of scales.

Each replica's contribution ``c_a = x_a + e_a`` is compressed on its own
(not the local mean), and the error-feedback residual ``e_a' = c_a -
dequant(quant(c_a))`` is carried to the next sync, so the quantization
error telescopes (O(1/K) over K syncs).

Every function works on flat ``(..., M)`` streams with M a multiple of
:data:`CHUNK`.  The port's state buffers already are such streams: each
leaf starts at a multiple of :data:`PAD_MULTIPLE` elements with zeros in
the gaps (``utils/pytree.py::FlatLayout``), which is where the
reference's per-leaf :func:`pad_to_chunk` puts the chunk edges, and a
zero gap quantizes to scale 1 / code 0.

:func:`dequantize_mean` is the one Eq. (8d) reduction of n payloads, used
by the barrier sync, the overlapped head and the plain version of the
fused dequantize + sync kernel alike, so their means agree bit for bit.
Across ranks, :func:`gather_payload` assembles the n payloads in rank
order first, so the mean reads them in the single-process order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

METHODS = ("none", "bf16", "int8")
CHUNK = 1024            # elements per int8 scale
PAD_MULTIPLE = 8 * CHUNK
# f32(1/127): the reference multiplies by the reciprocal (XLA would
# strength-reduce x/127 to it under jit), and so does the CUDA kernel
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def check_method(method: str):
    if method not in METHODS:
        raise ValueError(f"sync_compress must be one of {METHODS}, "
                         f"got {method!r}")


def pad_to_chunk(flat):
    """Pad the trailing dim of (..., M) with zeros to a PAD_MULTIPLE
    multiple (an all-zero chunk quantizes to scale 1 / payload 0, so
    padding never perturbs scales or the dequantized mean)."""
    pad = (-flat.shape[-1]) % PAD_MULTIPLE
    return F.pad(flat, (0, pad)) if pad else flat


def _chunked(t):
    return t.reshape(*t.shape[:-1], t.shape[-1] // CHUNK, CHUNK)


def quantize(c, method: str):
    """c: (..., M) f32 with M % CHUNK == 0.  Returns (q, scales):
    bf16 -> (bf16 tensor, None); int8 -> (int8 tensor, (..., M/CHUNK)
    f32).  Rounding is half to even (``torch.round``) after a true
    division, as ``jnp.round(c / scale)``."""
    if method == "bf16":
        return c.to(torch.bfloat16), None
    if method == "int8":
        chunked = _chunked(c)
        amax = chunked.abs().amax(-1)
        scales = torch.where(amax == 0, torch.ones_like(amax),
                             amax * INV_127.to(amax.device))
        q = chunked / scales[..., None]
        q.round_().clamp_(-127, 127)
        return q.to(torch.int8).reshape(c.shape), scales
    raise ValueError(f"no quantizer for method {method!r}")


def dequantize(q, scales, method: str):
    """Inverse of :func:`quantize`, back to f32."""
    if method == "bf16":
        return q.float()
    if method == "int8":
        return (_chunked(q).float() * scales[..., None]).reshape(q.shape)
    raise ValueError(f"no dequantizer for method {method!r}")


def quantize_ef(c, method: str):
    """Quantize with error feedback: returns (q, scales, residual) where
    residual = c - dequantize(q) is what the caller carries to the next
    sync."""
    q, scales = quantize(c, method)
    return q, scales, c - dequantize(q, scales, method)


def gather_payload(q, scales, group):
    """The payloads of all n replicas from each rank's k local rows, in
    rank order (so row a is replica a, as in one process): one
    all-gather of the ``group`` (``sharding/partition.py``), int8 codes
    and their scales together.  Returns (q (n, M), scales (n, M/CHUNK) or
    None)."""
    if scales is None:
        return group.all_gather_rows(q), None
    return group.all_gather_rows(q, scales)


def dequantize_mean(q, scales, method: str, out=None):
    """The Eq. (8d) replica mean of n payloads, q (n, M) (scales (n,
    M/CHUNK) for int8) -> (M,) f32: the dequantized rows summed left to
    right, one replica at a time (no (n, M) f32 temporary), then a true
    division by n.  For n = 2 this is ``jnp.mean(dequantize(q), 0)`` bit
    for bit; the CUDA kernel that fuses it into the sync sums in the same
    order.  ``out``: an (M,) f32 buffer to write into."""
    n = q.shape[0]
    row = lambda a: dequantize(q[a], None if scales is None else scales[a],
                               method)
    if out is None:
        out = row(0)
    else:
        out.copy_(row(0))
    for a in range(1, n):
        out.add_(row(a))
    # a 0-dim tensor on out's device: a divisor that is a Python number
    # becomes a multiplication by its reciprocal in PyTorch's CUDA kernel
    return out.div_(torch.full((), float(n), device=out.device))
