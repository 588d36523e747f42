"""Parle's inner step (K1) and sync step (K2): the hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Replaces the Pallas TPU kernels ``repro/kernels/parle_update.py::
parle_update_flat`` (K1, Eq. 8a-8b) and ``parle_sync_flat`` (K2,
Eq. 8c-8d).  Both are elementwise over the Parle state, which the port
keeps as one flat ``(n, M)`` buffer per field (see
``repro_torch/utils/pytree.py::FlatLayout``), so each kernel launches
once for all replicas and leaves.

* ``parle_inner_update_cuda`` / ``parle_sync_update_cuda`` launch
  ``csrc/parle_update.cu`` (built on first use by ``kernels/build.py``)
  and update their state operands IN PLACE.  Both are bound by bytes;
  the source's header says how the design meets that.
* ``parle_inner_update_plain`` / ``parle_sync_update_plain`` are the
  reference oracles ``repro/kernels/ref.py::parle_inner_update`` /
  ``parle_sync_update`` op by op, with the casts of the Pallas bodies
  (y and g upcast on read, only y' cast back; y' = bf16(x') fused into
  the sync).  They return new tensors.  The CPU path and the on-card
  comparison use them.

``scalars`` is a (4,) float32 tensor on the operands' device:
[inv_gamma, lr, mu, alpha] for K1, [gamma_scale, inv_rho, lr, mu] for K2.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# kernel launches since process start (or since the caller reset them)
inner_launches = 0
sync_launches = 0

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def pack_scalars(*vals, device=None) -> torch.Tensor:
    """(len(vals),) float32 on ``device``; each value rounds to float32
    on its own first (Python floats and 0-dim tensors alike)."""
    t = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                     for v in vals])
    return t.to(device) if device is not None else t


# ------------------------------------------------------------------
# plain versions
# ------------------------------------------------------------------

def parle_inner_update_plain(y, z, v, g, x, scalars):
    """Eq. 8a-8b.  y, g: compute dtype (f32 or bf16); z, v, x: f32, all
    one shape.  Returns (y', z', v'); y' in y's dtype."""
    inv_gamma, lr, mu, alpha = scalars.unbind(0)
    yf = y.float()
    g_y = g.float() + inv_gamma * (yf - x)
    v_new = mu * v + g_y
    y_new = yf - lr * (g_y + mu * v_new)
    z_new = alpha * z + (1.0 - alpha) * y_new
    return y_new.to(y.dtype), z_new, v_new


def parle_sync_update_plain(x, z, v, xbar, scalars, y_dtype=None):
    """Eq. 8c-8d.  x, z, v: (R, M) f32; xbar: (M,) f32, broadcast over
    the replicas.  Returns (x', v'), or (x', v', y') with y' = x' cast to
    ``y_dtype`` when that is bf16."""
    gamma_scale, inv_rho, lr, mu = scalars.unbind(0)
    g_x = gamma_scale * (x - z) + inv_rho * (x - xbar)
    v_new = mu * v + g_x
    x_new = x - lr * (g_x + mu * v_new)
    if y_dtype is not None and y_dtype != torch.float32:
        return x_new, v_new, x_new.to(y_dtype)
    return x_new, v_new


# ------------------------------------------------------------------
# CUDA launches
# ------------------------------------------------------------------

def _library():
    lib = build.load("parle_update.cu").lib
    if lib.parle_inner_update.argtypes is None:
        p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.parle_inner_update.argtypes = [p] * 6 + [i64, i, i, i, p]
        lib.parle_inner_update.restype = i
        lib.parle_sync_update.argtypes = [p] * 6 + [i, i64, i, i, p]
        lib.parle_sync_update.restype = i
    return lib


def _check(fn, tensors, dtypes, device):
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the "
                             f"CUDA device {device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.dtype not in dtypes.get(name, (torch.float32,)):
            raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel takes "
                            f"{dtypes.get(name, (torch.float32,))}")
    scalars = tensors["scalars"]
    if tuple(scalars.shape) != (4,):
        raise ValueError(f"{fn}: scalars must be (4,), got "
                         f"{tuple(scalars.shape)}")


def _aligned(tensors) -> bool:
    """Whether every stream takes 4-element vector accesses: 16-byte
    aligned f32, 8-byte aligned bf16."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def parle_inner_update_cuda(y, z, v, g, x, scalars):
    """Launch K1 on the current stream (no synchronisation): y, z, v are
    updated in place and returned.  Same contract as
    :func:`parle_inner_update_plain`; raises on anything the kernel does
    not take."""
    global inner_launches
    fn = "parle_inner_update"
    tensors = {"y": y, "z": z, "v": v, "g": g, "x": x, "scalars": scalars}
    _check(fn, tensors, {"y": COMPUTE_DTYPES, "g": COMPUTE_DTYPES},
           y.device)
    if g.dtype != y.dtype:
        raise TypeError(f"{fn}: g is {g.dtype} but y is {y.dtype}")
    for name in ("z", "v", "g", "x"):
        if tensors[name].shape != y.shape:
            raise ValueError(f"{fn}: {name} {tuple(tensors[name].shape)} "
                             f"does not match y {tuple(y.shape)}")
    if y.numel() == 0:
        raise ValueError(f"{fn}: empty state")
    vec = _aligned([y, z, v, g, x])
    err = _library().parle_inner_update(
        y.data_ptr(), z.data_ptr(), v.data_ptr(), g.data_ptr(), x.data_ptr(),
        scalars.data_ptr(), y.numel(), int(y.dtype == torch.bfloat16),
        int(vec), y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError_t {err}")
    inner_launches += 1
    return y, z, v


def parle_sync_update_cuda(x, z, v, xbar, scalars, y_out=None):
    """Launch K2 on the current stream (no synchronisation): x and v are
    updated in place; ``y_out`` (R, M) bf16, when given, receives
    bf16(x').  Returns (x, v) or (x, v, y_out).  Same contract as
    :func:`parle_sync_update_plain`; raises on anything the kernel does
    not take."""
    global sync_launches
    fn = "parle_sync_update"
    tensors = {"x": x, "z": z, "v": v, "xbar": xbar, "scalars": scalars}
    if y_out is not None:
        tensors["y_out"] = y_out
    _check(fn, tensors, {"y_out": (torch.bfloat16,)}, x.device)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{fn}: x must be (R, M) with R, M >= 1, got "
                         f"{tuple(x.shape)}")
    R, M = x.shape
    if R > 65535:
        raise ValueError(f"{fn}: {R} replicas exceed the grid's 65535 rows")
    for name in ("z", "v") + (("y_out",) if y_out is not None else ()):
        if tensors[name].shape != x.shape:
            raise ValueError(f"{fn}: {name} {tuple(tensors[name].shape)} "
                             f"does not match x {tuple(x.shape)}")
    if tuple(xbar.shape) != (M,):
        raise ValueError(f"{fn}: xbar must be ({M},), got "
                         f"{tuple(xbar.shape)}")
    vec = M % 4 == 0 and _aligned(list(tensors.values())[:4]
                                  + ([y_out] if y_out is not None else []))
    err = _library().parle_sync_update(
        x.data_ptr(), z.data_ptr(), v.data_ptr(), xbar.data_ptr(),
        y_out.data_ptr() if y_out is not None else None, scalars.data_ptr(),
        R, M, int(vec), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError_t {err}")
    sync_launches += 1
    return (x, v) if y_out is None else (x, v, y_out)
