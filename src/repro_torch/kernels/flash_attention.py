"""Causal flash attention (K3): the hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``.  q, k, v are (B, T, H, hd) with GQA already expanded;
attention is causal, optionally over a sliding ``window`` (key k is seen
by query q when q - window < k <= q).  Forward only, as the reference:
no VJP is defined for it.

* ``flash_attention_cuda`` launches ``csrc/flash_attention.cu`` (built on
  first use by ``kernels/build.py``).  At the prefill shapes it is bound
  by operations; the source's header says how its design meets that:
  tensor-core products, float32 to float32 accuracy through the 3xTF32
  split.
* ``flash_attention_plain`` is the torch form of the reference oracle
  ``repro/kernels/ref.py::flash_attention``: the whole (T, T) logits,
  masked to -1e30, softmax in float32, probabilities cast to v's dtype.
  The CPU path and the on-card comparison use it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_Q = 64                     # query rows of one kernel block

# kernel launches since process start (or since the caller reset it)
launches = 0


def flash_attention_plain(q, k, v, window: int = 0):
    """q, k, v: (B, T, H, hd).  Causal softmax attention; returns
    (B, T, H, hd) in v's dtype."""
    T = q.shape[1]
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _library():
    lib = build.load("flash_attention.cu")
    fn = lib.lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"expected q's CUDA device {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes float32 or bfloat16, one dtype "
                            "for q, k and v")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} "
                             f"must be (B, T, H, hd) like q "
                             f"{tuple(q.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")
    B, T, H, hd = q.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if min(B, T, H) < 1 or window < 0:
        raise ValueError("flash_attention: empty batch, sequence or heads, "
                         "or a negative window")
    if B > 65535 or -(-T // BLOCK_Q) > 65535:
        raise ValueError(f"flash_attention: B {B} or {-(-T // BLOCK_Q)} "
                         "query tiles past the grid's 65535")


def flash_attention_cuda(q, k, v, window: int = 0):
    """Launch the K3 kernel on the current stream (no synchronisation).
    Same contract as :func:`flash_attention_plain`, any T (a ragged last
    tile is masked in the kernel); raises on anything the kernel does
    not take."""
    global launches
    _check(q, k, v, window)
    fn = _library()
    B, T, H, hd = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, T, H, hd, window, DTYPES[q.dtype], hd ** -0.5,
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
