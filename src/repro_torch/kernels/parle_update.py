"""Parle's update kernels for Hopper and their plain PyTorch versions:
the inner step (K1), the sync step (K2), the Elastic-SGD worker step
(K7) and the compressed sync (K4-K6).

Replaces the Pallas TPU kernels of ``repro/kernels/parle_update.py``:

* K1 ``parle_update_flat`` — Eq. 8a-8b;
* K2 ``parle_sync_flat`` — Eq. 8c-8d against one (M,) xbar;
* K7 ``elastic_update_flat`` — Elastic-SGD's Eq. 7a against one (M,)
  reference variable;
* K4 ``quantize_ef_flat`` — per-1024-chunk int8 quantize + the
  error-feedback residual;
* K5 ``parle_sync_dequant_flat`` — dequantize n int8 payloads, their
  mean, then Eq. 8c-8d;
* K6 ``parle_apply_quantize_flat`` — Eq. 8c-8d against the carried
  consensus c, then K4's quantize of x' + e, in one pass.

All work on the Parle state as one flat ``(n, M)`` buffer per field (see
``repro_torch/utils/pytree.py::FlatLayout``: every leaf at a multiple of
8192 elements, so the int8 chunks never straddle two leaves), so each
kernel launches once for all replicas and leaves.

* ``*_cuda`` launch ``csrc/parle_update.cu`` (built on first use by
  ``kernels/build.py``) and update their state operands IN PLACE.  All
  are bound by bytes; the source's header says how the design meets that.
* ``*_plain`` are the reference oracles of ``repro/kernels/ref.py`` op by
  op, with the casts of the Pallas bodies (y and g upcast on read, only
  y' cast back; y' = bf16(x') fused into the sync).  They return new
  tensors.  The CPU path and the on-card comparison use them.

``scalars`` is a float32 tensor on the operands' device: (4,)
[inv_gamma, lr, mu, alpha] for K1, (4,) [gamma_scale, inv_rho, lr, mu]
for K2, K5 and K6, (3,) [inv_rho, lr, mu] for K7.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import compress
from repro_torch.kernels import build

# kernel launches since process start (or since the caller reset them)
inner_launches = 0
sync_launches = 0
elastic_launches = 0
quantize_launches = 0
dequant_sync_launches = 0
apply_quantize_launches = 0


def launch_counts() -> dict:
    """{kernel: launches} of the training path's six kernels (K1, K2,
    K7, K4, K5, K6) since process start or the caller's reset."""
    return {"parle_inner_update": inner_launches,
            "parle_sync_update": sync_launches,
            "elastic_update": elastic_launches,
            "quantize_ef": quantize_launches,
            "parle_sync_dequant": dequant_sync_launches,
            "parle_apply_quantize": apply_quantize_launches}

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


def elastic_worker_update_plain(x, v, g, ref, scalars):
    """K7, Eq. 7a.  x, v: (R, M) f32; g: (R, M) f32 or bf16 (upcast on
    read); ref: (M,) f32, broadcast over the replicas.  Returns (x', v')."""
    inv_rho, lr, mu = scalars.unbind(0)
    g_e = g.float() + inv_rho * (x - ref)
    v_new = mu * v + g_e
    x_new = x - lr * (g_e + mu * v_new)
    return x_new, v_new


def quantize_ef_plain(c):
    """K4.  c: (R, M) f32, M % 1024 == 0.  Returns (q (R, M) int8,
    s (R, M/1024) f32, e = c - dequant(q) f32): the codec of
    ``core/compress.py``, the oracle ``ref.quantize_ef``."""
    return compress.quantize_ef(c, "int8")


def parle_sync_dequant_update_plain(x, z, v, q, s, scalars, y_dtype=None):
    """K5.  x, z, v: (R, M) f32; q: (n, M) int8 and s: (n, M/1024) f32,
    the payloads of all n replicas.  xbar = the dequantized mean
    (``compress.dequantize_mean``: left to right over n, then / n), then
    Eq. 8c-8d as :func:`parle_sync_update_plain`."""
    xbar = compress.dequantize_mean(q, s, "int8")
    return parle_sync_update_plain(x, z, v, xbar, scalars, y_dtype=y_dtype)


def parle_apply_quantize_plain(x, z, v, c, e, scalars, y_dtype=None):
    """K6.  x, z, v, e: (R, M) f32; c: (M,) f32, the carried consensus.
    Eq. 8c-8d against c, then K4 on x' + e.  Returns (x', v', q, s, e')
    or, with a bf16 ``y_dtype``, (x', v', q, s, e', y')."""
    x_new, v_new, *y = parle_sync_update_plain(x, z, v, c, scalars,
                                               y_dtype=y_dtype)
    q, s, e_new = quantize_ef_plain(x_new + e)
    return (x_new, v_new, q, s, e_new, *y)


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
        lib.elastic_update.argtypes = [p] * 5 + [i, i64, i, i, i, p]
        lib.elastic_update.restype = i
        lib.quantize_ef.argtypes = [p] * 4 + [i64, i, p]
        lib.quantize_ef.restype = i
        lib.parle_sync_dequant.argtypes = [p] * 7 + [i, i, i64, i, p]
        lib.parle_sync_dequant.restype = i
        lib.parle_apply_quantize.argtypes = [p] * 9 + [i, i64, i, p]
        lib.parle_apply_quantize.restype = i
    return lib


def _check(fn, tensors, dtypes, device, n_scalars=4):
    for name, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{fn}: {name} is on {t.device}, expected the "
                             f"CUDA device {device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.dtype not in dtypes.get(name, (torch.float32,)):
            raise TypeError(f"{fn}: {name} is {t.dtype}; the kernel takes "
                            f"{dtypes.get(name, (torch.float32,))}")
    scalars = tensors.get("scalars")
    if scalars is not None and tuple(scalars.shape) != (n_scalars,):
        raise ValueError(f"{fn}: scalars must be ({n_scalars},), got "
                         f"{tuple(scalars.shape)}")


def _check_shapes(fn, tensors, shapes):
    for name, want in shapes.items():
        got = tuple(tensors[name].shape)
        if got != tuple(want):
            raise ValueError(f"{fn}: {name} is {got}, expected {tuple(want)}")


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


def elastic_worker_update_cuda(x, v, g, ref, scalars):
    """Launch K7 on the current stream (no synchronisation): x and v are
    updated in place and returned; ref is only read.  Same contract as
    :func:`elastic_worker_update_plain`; raises on anything the kernel
    does not take."""
    global elastic_launches
    fn = "elastic_update"
    tensors = {"x": x, "v": v, "g": g, "ref": ref, "scalars": scalars}
    _check(fn, tensors, {"g": COMPUTE_DTYPES}, x.device, n_scalars=3)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{fn}: x must be (R, M) with R, M >= 1, got "
                         f"{tuple(x.shape)}")
    R, M = x.shape
    if R > 65535:
        raise ValueError(f"{fn}: {R} replicas exceed the grid's 65535 rows")
    _check_shapes(fn, tensors, {"v": (R, M), "g": (R, M), "ref": (M,)})
    vec = M % 4 == 0 and _aligned([x, v, g, ref])
    err = _library().elastic_update(
        x.data_ptr(), v.data_ptr(), g.data_ptr(), ref.data_ptr(),
        scalars.data_ptr(), R, M, int(g.dtype == torch.bfloat16), int(vec),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError_t {err}")
    elastic_launches += 1
    return x, v


# ------------------------------------------------------------------
# the compressed sync: K4, K5, K6
# ------------------------------------------------------------------

def _chunked_rows(fn, x):
    """(R, M) of a compressed-sync kernel: R >= 1, M a positive multiple
    of 8192 (the flat layout's leaf alignment)."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{fn}: expected (R, M) with R, M >= 1, got "
                         f"{tuple(x.shape)}")
    R, M = x.shape
    if M % compress.PAD_MULTIPLE:
        raise ValueError(f"{fn}: M = {M} is not a multiple of "
                         f"{compress.PAD_MULTIPLE}")
    return R, M


def _require_aligned(fn, tensors):
    """Every stream is accessed four elements at a time."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"{fn}: {name} is not aligned to "
                             f"{4 * t.element_size()} bytes")


def quantize_ef_cuda(c, q, s, e):
    """Launch K4 on the current stream: q (R, M) int8, s (R, M/1024) f32
    and e (R, M) f32 receive the codes, scales and residual of c (R, M)
    f32.  ``e`` may be ``c`` itself (the residual replaces the
    contribution in place).  Returns (q, s, e)."""
    global quantize_launches
    fn = "quantize_ef"
    tensors = {"c": c, "q": q, "s": s, "e": e}
    _check(fn, tensors, {"q": (torch.int8,)}, c.device)
    R, M = _chunked_rows(fn, c)
    _check_shapes(fn, tensors, {"q": (R, M), "s": (R, M // compress.CHUNK),
                                "e": (R, M)})
    _require_aligned(fn, {"c": c, "q": q, "e": e})
    err = _library().quantize_ef(
        c.data_ptr(), q.data_ptr(), s.data_ptr(), e.data_ptr(),
        R * (M // compress.CHUNK), c.device.index,
        torch.cuda.current_stream(c.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError_t {err}")
    quantize_launches += 1
    return q, s, e


def parle_sync_dequant_update_cuda(x, z, v, q, s, scalars, y_out=None):
    """Launch K5 on the current stream: x, v (R, M) f32 updated in place
    against the mean of the n payloads q (n, M) int8 / s (n, M/1024);
    ``y_out`` (R, M) bf16, when given, receives bf16(x').  Returns (x, v)
    or (x, v, y_out)."""
    global dequant_sync_launches
    fn = "parle_sync_dequant"
    tensors = {"x": x, "z": z, "v": v, "q": q, "s": s, "scalars": scalars}
    if y_out is not None:
        tensors["y_out"] = y_out
    _check(fn, tensors, {"q": (torch.int8,), "y_out": (torch.bfloat16,)},
           x.device)
    R, M = _chunked_rows(fn, x)
    n = q.shape[0] if q.dim() == 2 else 0
    if n < 1:
        raise ValueError(f"{fn}: q must be (n, M) with n >= 1, got "
                         f"{tuple(q.shape)}")
    _check_shapes(fn, tensors, {"z": (R, M), "v": (R, M), "q": (n, M),
                                "s": (n, M // compress.CHUNK),
                                **({"y_out": (R, M)} if y_out is not None
                                   else {})})
    _require_aligned(fn, {"x": x, "z": z, "v": v, "q": q, "y_out": y_out})
    err = _library().parle_sync_dequant(
        x.data_ptr(), z.data_ptr(), v.data_ptr(), q.data_ptr(), s.data_ptr(),
        y_out.data_ptr() if y_out is not None else None, scalars.data_ptr(),
        R, n, M, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError_t {err}")
    dequant_sync_launches += 1
    return (x, v) if y_out is None else (x, v, y_out)


def parle_apply_quantize_cuda(x, z, v, c, e, q, s, scalars, y_out=None):
    """Launch K6 on the current stream: x, v and e (R, M) f32 are updated
    in place (e' = the residual of the next payload x' + e), q (R, M)
    int8 and s (R, M/1024) f32 receive that payload; c (M,) is the
    carried consensus.  ``y_out`` (R, M) bf16, when given, receives
    bf16(x').  Returns (x, v, q, s, e) or (x, v, q, s, e, y_out)."""
    global apply_quantize_launches
    fn = "parle_apply_quantize"
    tensors = {"x": x, "z": z, "v": v, "c": c, "e": e, "q": q, "s": s,
               "scalars": scalars}
    if y_out is not None:
        tensors["y_out"] = y_out
    _check(fn, tensors, {"q": (torch.int8,), "y_out": (torch.bfloat16,)},
           x.device)
    R, M = _chunked_rows(fn, x)
    _check_shapes(fn, tensors, {"z": (R, M), "v": (R, M), "c": (M,),
                                "e": (R, M), "q": (R, M),
                                "s": (R, M // compress.CHUNK),
                                **({"y_out": (R, M)} if y_out is not None
                                   else {})})
    _require_aligned(fn, {"x": x, "z": z, "v": v, "c": c, "e": e, "q": q,
                          "y_out": y_out})
    err = _library().parle_apply_quantize(
        x.data_ptr(), z.data_ptr(), v.data_ptr(), c.data_ptr(), e.data_ptr(),
        q.data_ptr(), s.data_ptr(),
        y_out.data_ptr() if y_out is not None else None, scalars.data_ptr(),
        R, M, x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError_t {err}")
    apply_quantize_launches += 1
    out = (x, v, q, s, e)
    return out if y_out is None else out + (y_out,)
