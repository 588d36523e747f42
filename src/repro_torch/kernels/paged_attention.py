"""Paged decode attention (K8): the hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py::
paged_attention``.  One query token per batch row (the serving engine's
decode step); the KV pages of row ``b`` are named by ``table[b]`` and
``lengths[b]`` counts its live positions.  GQA is folded: query head
``h`` reads KV head ``h // (H // KV)``.

* ``paged_attention_cuda`` launches ``csrc/paged_attention.cu`` (built on
  first use by ``kernels/build.py``).  It is bound by the bytes of live
  K/V; the source's header says how its design meets that: the page loop
  is split across blocks (flash-decoding), ``split_span`` pages a split,
  and the splits' partials are combined in fixed order.
* ``paged_attention_plain`` is the torch form of the reference oracle
  ``repro/kernels/ref.py::paged_attention``: gather each row's pages
  into the contiguous extent, masked softmax.  The CPU path and the
  on-card comparison use it.

Precondition (as on the serve path, ``lengths = min(pos + 1, M * ps)``):
``1 <= lengths[b] <= M * ps``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256)
MAX_SMEM_BYTES = 232448          # per-block dynamic shared memory, sm_90
BLOCKS_PER_SM = 4                # the split grid's aim
RING_PAGES = 4                   # csrc/paged_attention.cu's kStages

# kernel launches since process start (or since the caller reset it)
launches = 0


def paged_attention_plain(q, k_pool, v_pool, table, lengths):
    """q: (B, H, hd); k_pool/v_pool: (P, ps, KV, hd); table: (B, M) page
    ids; lengths: (B,) live positions.  Returns (B, H, hd)."""
    B, H, hd = q.shape
    P, ps, KV, _ = k_pool.shape
    M = table.shape[1]
    S = M * ps
    group = H // KV
    k = k_pool[table].reshape(B, S, KV, hd).repeat_interleave(group, dim=2)
    v = v_pool[table].reshape(B, S, KV, hd).repeat_interleave(group, dim=2)
    scale = hd ** -0.5
    logits = torch.einsum("bhd,bshd->bhs", q, k).float() * scale
    live = (torch.arange(S, device=q.device)[None, None, :]
            < lengths[:, None, None])
    logits = torch.where(live, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhs,bshd->bhd", probs, v)


def split_span(B: int, KV: int, M: int, sm_count: int) -> int:
    """Pages a split takes: enough splits that the (B, KV, splits) grid
    holds about ``BLOCKS_PER_SM`` blocks an SM, at least one page a
    split.  It reads only shapes, never ``lengths``, so choosing it needs
    no device-to-host copy."""
    want = -(-BLOCKS_PER_SM * sm_count // (B * KV))
    return -(-M // max(1, min(M, want)))


def smem_bytes(H: int, KV: int, hd: int, ps: int, span: int) -> int:
    """Shared memory of one split block: the group's queries, the ring of
    K and V pages, the page's scores, three per-head stats and the
    split's page ids."""
    G = H // KV
    return 4 * (G * hd + 2 * RING_PAGES * ps * hd + G * ps + 3 * G + span)


def _library():
    lib = build.load("paged_attention.cu")
    fn = lib.lib.paged_attention_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, table, lengths):
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "table": table,
               "lengths": lengths}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"paged_attention: {name} is on {t.device}, "
                             f"expected q's CUDA device {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    for name in ("q", "k_pool", "v_pool"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"paged_attention: {name} is "
                            f"{tensors[name].dtype}; the kernel takes "
                            "float32 only")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")
    for name in ("table", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"paged_attention: {name} is "
                            f"{tensors[name].dtype}, expected int32")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError("paged_attention: q must be (B, H, hd) and the "
                         "pools (P, ps, KV, hd)")
    B, H, hd = q.shape
    P, ps, KV, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd:
        raise ValueError(f"paged_attention: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if table.dim() != 2 or table.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention: table {tuple(table.shape)} and "
                         f"lengths {tuple(lengths.shape)} must be (B, M) "
                         f"and (B,) with B = {B}")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if KV < 1 or H % KV or H // KV > 32:
        raise ValueError(f"paged_attention: {H} query heads over {KV} KV "
                         "heads must form groups of at most 32")
    if table.shape[1] < 1 or ps < 1 or B < 1:
        raise ValueError("paged_attention: empty batch, table or page")
    if max(B, KV) > 65535:
        raise ValueError("paged_attention: more than 65535 rows or KV heads")


def paged_attention_cuda(q, k_pool, v_pool, table, lengths):
    """Launch the K8 kernels on the current stream (no synchronisation,
    no read of ``lengths`` on the host): the split kernel and, with more
    than one split, the combine kernel — one launch in ``launches``.
    Same contract as :func:`paged_attention_plain`; raises on anything
    the kernel does not take."""
    global launches
    _check(q, k_pool, v_pool, table, lengths)
    fn = _library()
    B, H, hd = q.shape
    P, ps, KV, _ = k_pool.shape
    M = table.shape[1]
    span = split_span(B, KV, M, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    splits = -(-M // span)
    if smem_bytes(H, KV, hd, ps, span) > MAX_SMEM_BYTES:
        raise ValueError(f"paged_attention: {RING_PAGES} pages of {ps} x "
                         f"{hd} K and V do not fit one block's shared "
                         "memory")
    out = torch.empty_like(q)
    if splits > 1:     # per-split (m, l) and unnormalised acc
        stats = torch.empty((2, B, H, splits), dtype=torch.float32,
                            device=q.device)
        acc = torch.empty((B, H, splits, hd), dtype=torch.float32,
                          device=q.device)
        scratch = (stats[0].data_ptr(), stats[1].data_ptr(), acc.data_ptr())
    else:
        scratch = (None, None, None)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             table.data_ptr(), lengths.data_ptr(), out.data_ptr(), *scratch,
             B, H, KV, hd, P, ps, M, span, hd ** -0.5,
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    return out
