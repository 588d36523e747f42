"""Chunked SSD (Mamba2) selective scan (K9): the hand-written CUDA kernel
for Hopper and its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
and its jnp epilogue for the final state.  Per batch row b and head h,
with state N and head dim P:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,    y_t = C_t . h_t

x: (B, T, nh, P); dt: (B, T, nh), already softplus'd; A: (nh,),
negative; B_mat, C_mat: (B, T, N), one group shared by every head.
Returns y (B, T, nh, P) and the final state (B, nh, N, P), both in x's
dtype.

* ``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu`` (built on first use by
  ``kernels/build.py``): the chunked SSD algorithm over chunks of Q
  tokens, from a zero state, as four chunk-parallel passes (C B^T, chunk
  states, state passing, chunk scan) on the TF32 tensor cores in the
  3xTF32 split, with float32 scratch the wrapper allocates.  One call is
  one launch in ``launches``.  It is bound by operations; the source's
  header says how its design meets that.
* ``ssd_scan_plain`` is the torch form of the reference oracle
  ``repro/kernels/ref.py::ssd_scan``: the naive O(T) recurrence, in
  float32, from ``h0`` or zeros.  The CPU path and the on-card
  comparison use it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_HEAD_DIMS = (32, 64)
MAX_CHUNK = 128
MAX_STATE = 128
MAX_SMEM_BYTES = 232448          # per-block dynamic shared memory, sm_90

# kernel launches since process start (or since the caller reset it)
launches = 0


def ssd_scan_plain(x, dt, A, B_mat, C_mat, h0=None):
    """The naive recurrence, one token at a time, in float32."""
    Bsz, T, nh, P = x.shape
    N = B_mat.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B_mat, C_mat))
    Af = A.float()
    h = (torch.zeros((Bsz, nh, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(T):
        a = torch.exp(dtf[:, t] * Af)                                # (B, nh)
        dBx = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t])
        h = a[:, :, None, None] * h + dBx
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h.to(x.dtype)


def _round16(v: int) -> int:
    return (v + 15) // 16 * 16


def smem_bytes(chunk: int, N: int, P: int) -> int:
    """The largest dynamic shared memory of the kernel's passes, with Q
    and N rounded up to 16: C B^T (64 rows of C and the keys of B, rows
    of N + 8), the chunk states (two slots of x (Q, P+4), dt and w of 4
    heads) and the chunk scan (x (Q, P+4), h_in (N, P+4), dt and cum)."""
    Qp, Np = _round16(chunk), _round16(N)
    return 4 * max((64 + Qp) * (Np + 8), Qp * (2 * (P + 4) + 8),
                   (Qp + Np) * (P + 4) + 2 * Qp)


def _library():
    lib = build.load("ssd_scan.cu")
    fn = lib.lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 8
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B_mat, C_mat, chunk):
    tensors = {"x": x, "dt": dt, "A": A, "B_mat": B_mat, "C_mat": C_mat}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, expected "
                             f"x's CUDA device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: x is {x.dtype}; the kernel takes "
                        "float32 or bfloat16")
    for name in ("dt", "B_mat", "C_mat"):
        if tensors[name].dtype != x.dtype:
            raise TypeError(f"ssd_scan: {name} is {tensors[name].dtype}, "
                            f"expected x's {x.dtype}")
    if A.dtype != torch.float32 or A.dim() != 1 or not A.is_contiguous():
        raise TypeError("ssd_scan: A must be a contiguous float32 (nh,)")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} must be "
                         "(B, T, nh, P)")
    Bsz, T, nh, P = x.shape
    N = B_mat.shape[-1]
    if (tuple(dt.shape) != (Bsz, T, nh) or tuple(A.shape) != (nh,)
            or tuple(B_mat.shape) != (Bsz, T, N)
            or tuple(C_mat.shape) != (Bsz, T, N)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B_mat.shape)}, C {tuple(C_mat.shape)} do "
                         "not agree")
    # the kernel takes the batch and time strides; within a token the
    # heads of x are P apart and every innermost axis is dense
    if x.stride(3) != 1 or x.stride(2) != P:
        raise ValueError("ssd_scan: x's (nh, P) axes must be dense")
    if dt.stride(2) != 1 or B_mat.stride(2) != 1 or C_mat.stride(2) != 1:
        raise ValueError("ssd_scan: dt, B_mat and C_mat must be dense in "
                         "their last axis")
    if P not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"ssd_scan: head dim {P} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not 1 <= N <= MAX_STATE or N % 8:
        raise ValueError(f"ssd_scan: state {N} must be a multiple of 8 "
                         f"up to {MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK or T % chunk:
        raise ValueError(f"ssd_scan: T {T} must be a multiple of the chunk "
                         f"{chunk} (at most {MAX_CHUNK})")
    if smem_bytes(chunk, N, P) > MAX_SMEM_BYTES:
        raise ValueError("ssd_scan: the chunk's tiles do not fit one "
                         "block's shared memory")


def ssd_scan_cuda(x, dt, A, B_mat, C_mat, chunk: int):
    """Launch the K9 kernel on the current stream (no synchronisation):
    the scan from a zero state over chunks of ``chunk`` tokens
    (T % chunk == 0).  Returns (y, h_final) like :func:`ssd_scan_plain`;
    raises on anything the kernel does not take."""
    global launches
    _check(x, dt, A, B_mat, C_mat, chunk)
    fn = _library()
    Bsz, T, nh, P = x.shape
    N = B_mat.shape[-1]
    y = torch.empty((Bsz, T, nh, P), dtype=x.dtype, device=x.device)
    h_final = torch.empty((Bsz, nh, N, P), dtype=x.dtype, device=x.device)
    # float32 scratch of the passes: C B^T of each chunk (Q rounded up to
    # 16), each chunk's state (then the state entering it) and decay
    nc, Qp = T // chunk, _round16(chunk)
    cb = torch.empty((Bsz, nc, Qp, Qp), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, nh, N, P), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((Bsz, nc, nh), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
             C_mat.data_ptr(), y.data_ptr(), h_final.data_ptr(),
             cb.data_ptr(), states.data_ptr(), decay.data_ptr(),
             Bsz, T, nh, P, N, chunk,
             *x.stride()[:2], *dt.stride()[:2], *B_mat.stride()[:2],
             *C_mat.stride()[:2],
             DTYPES[x.dtype], x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return y, h_final
