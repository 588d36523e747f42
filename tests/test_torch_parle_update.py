"""K1 (Parle inner step) and K2 (sync step): their plain versions against
the reference oracles (``repro.kernels.ref``) and the Pallas kernels in
interpret mode, on the same numpy inputs; the wrappers' in-place and
dispatch contracts; the flat state layout; and the CUDA kernels against
their plain versions (``gpu``, skipped without a card).

Tolerance: the reference's own kernel-vs-jnp bound, rtol 1e-5 and
atol 1e-6 (tests/test_core_parle.py); the fused bf16 y' of K2 is
compared bit for bit."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import parle_update as ref_pu
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import ops
from repro_torch.kernels import parle_update as pu
from repro_torch.utils.pytree import ALIGN, FlatLayout
from torch_parity import assert_close

TOL = dict(rtol=1e-5, atol=1e-6)
INNER = dict(inv_gamma=0.1, lr=0.05, mu=0.9, alpha=0.75)
SYNC = dict(gamma_scale=1.0, inv_rho=2.0, lr=0.1, mu=0.9)
SIZES = (1, 7, 1000, 8193)            # ragged: no block or vector multiple


def _streams(seed, shape, k):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(k)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf16(a):
    """numpy f32 -> (torch bf16, numpy ml_dtypes bf16) holding equal bits."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


# ------------------------------------------------------------------
# plain versions against the reference
# ------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("m", SIZES)
def test_inner_plain_matches_reference_oracle(n, m):
    y, z, v, g, x = _streams(n * 10 + m, (n, m), 5)
    want = ref_oracle.parle_inner_update(*map(jnp.asarray, (y, z, v, g, x)),
                                         **INNER)
    got = pu.parle_inner_update_plain(*map(_t, (y, z, v, g, x)),
                                      pu.pack_scalars(*INNER.values()))
    for name, a, b in zip(("y", "z", "v"), got, want):
        assert_close(a, b, TOL, f"K1 plain {name} n={n} m={m}")


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("m", SIZES)
def test_sync_plain_matches_reference_oracle(n, m):
    x, z, v = _streams(n * 20 + m, (n, m), 3)
    xbar = x.mean(0)
    want = ref_oracle.parle_sync_update(
        *map(jnp.asarray, (x, z, v, xbar[None])), **SYNC)
    got = pu.parle_sync_update_plain(*map(_t, (x, z, v, xbar)),
                                     pu.pack_scalars(*SYNC.values()))
    for name, a, b in zip(("x", "v"), got, want):
        assert_close(a, b, TOL, f"K2 plain {name} n={n} m={m}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3])
def test_inner_plain_matches_pallas_kernel(n, dtype):
    """Against ``parle_update_flat`` (interpret mode) on the flat
    (n * M,) stream, M = one 8192 block: bf16 y and g upcast on read,
    only y' cast back."""
    y, z, v, g, x = _streams(n, (n, ALIGN), 5)
    if dtype == "bf16":
        (ty, ry), (tg, rg) = _bf16(y), _bf16(g)
    else:
        ty, ry, tg, rg = _t(y), y, _t(g), g
    scal = np.array(list(INNER.values()), np.float32)
    want = ref_pu.parle_update_flat(
        *(jnp.asarray(a).reshape(-1) for a in (ry, z, v, rg, x)),
        jnp.asarray(scal), interpret=True)
    got = pu.parle_inner_update_plain(ty, _t(z), _t(v), tg, _t(x),
                                      torch.from_numpy(scal))
    assert got[0].dtype == ty.dtype
    for name, a, b in zip(("y", "z", "v"), got, want):
        a = a.float().reshape(-1)
        b = np.asarray(b).astype(np.float32)
        assert_close(a, b, TOL, f"K1 vs Pallas {name} {dtype} n={n}")


@pytest.mark.parametrize("emit_y", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_sync_plain_matches_pallas_kernel(n, emit_y):
    """Against ``parle_sync_flat`` (interpret mode): (R, M) streams
    against one (M,) xbar; with the fused bf16 y' it must equal the
    Pallas kernel's y' and bf16(x') bit for bit."""
    x, z, v = _streams(30 + n, (n, ALIGN), 3)
    xbar = x.mean(0)
    scal = np.array(list(SYNC.values()), np.float32)
    want = ref_pu.parle_sync_flat(
        *map(jnp.asarray, (x, z, v, xbar, scal)), interpret=True,
        y_dtype=jnp.bfloat16 if emit_y else None)
    got = pu.parle_sync_update_plain(
        *map(_t, (x, z, v, xbar)), torch.from_numpy(scal),
        y_dtype=torch.bfloat16 if emit_y else None)
    assert len(got) == len(want) == (3 if emit_y else 2)
    for name, a, b in zip(("x", "v"), got, want):
        assert_close(a, b, TOL, f"K2 vs Pallas {name} n={n}")
    if emit_y:
        assert torch.equal(got[2], got[0].to(torch.bfloat16))
        ref_bits = np.asarray(want[2]).view(np.uint16)
        port_bits = got[2].view(torch.int16).numpy().view(np.uint16)
        # both round the same x' bits; x' itself may differ by an ulp
        same_x = np.asarray(want[0]) == got[0].numpy()
        np.testing.assert_array_equal(port_bits[same_x], ref_bits[same_x])


# ------------------------------------------------------------------
# the wrappers: in place, CPU -> plain version
# ------------------------------------------------------------------

def test_wrappers_update_in_place_on_cpu():
    y, z, v, g, x = map(_t, _streams(5, (2, 300), 5))
    want = pu.parle_inner_update_plain(y, z, v, g, x,
                                       pu.pack_scalars(*INNER.values()))
    ptrs = [t.data_ptr() for t in (y, z, v)]
    out = ops.parle_inner_update(y, z, v, g, x, **INNER)
    assert [t.data_ptr() for t in out] == ptrs
    for a, b in zip((y, z, v), want):
        assert torch.equal(a, b)

    xbar = x.mean(0)
    want = pu.parle_sync_update_plain(x, z, v, xbar,
                                      pu.pack_scalars(*SYNC.values()),
                                      y_dtype=torch.bfloat16)
    y16 = torch.zeros(x.shape, dtype=torch.bfloat16)
    x2, v2, y2 = ops.parle_sync_update(x, z, v, xbar, y_out=y16, **SYNC)
    assert x2 is x and v2 is v and y2 is y16
    for a, b in zip((x, v, y16), want):
        assert torch.equal(a, b)
    x3, _, y3 = ops.parle_sync_update(x, z, v, xbar, **SYNC)
    assert y3 is x3                      # f32 compute: y' IS x'
    with pytest.raises(TypeError):
        ops.parle_sync_update(x, z, v, xbar, y_out=torch.zeros_like(x),
                              **SYNC)


def test_cuda_wrappers_raise_on_cpu_tensors():
    """The CUDA entry points never take a CPU tensor (no fallback)."""
    y, z, v, g, x = map(_t, _streams(6, (2, 64), 5))
    scal = pu.pack_scalars(*INNER.values())
    before = (pu.inner_launches, pu.sync_launches)
    with pytest.raises(ValueError, match="CUDA"):
        pu.parle_inner_update_cuda(y, z, v, g, x, scal)
    with pytest.raises(ValueError, match="CUDA"):
        pu.parle_sync_update_cuda(x, z, v, x.mean(0), scal)
    assert (pu.inner_launches, pu.sync_launches) == before


# ------------------------------------------------------------------
# the flat layout
# ------------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"b": {"w": (3, 5), "bias": (5,)}, "a": (7, 2), "s": (1,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return draw(shapes)


def test_flat_layout_round_trips_a_param_tree():
    tree = _tree(0)
    lay = FlatLayout(tree)
    assert lay.numel == 4 * ALIGN and lay.numel % ALIGN == 0
    assert lay.offsets == [0, ALIGN, 2 * ALIGN, 3 * ALIGN]   # sorted keys
    assert lay.paths == [("a",), ("b", "bias"), ("b", "w"), ("s",)]
    buf = lay.flatten(tree)
    for view, (off, size) in zip(lay.views(buf), zip(lay.offsets, lay.sizes)):
        assert view.data_ptr() == buf[off:].data_ptr()
    back = lay.tree(buf)
    assert torch.equal(back["b"]["w"], tree["b"]["w"])
    assert torch.equal(back["a"], tree["a"])
    rows = lay.flatten({k: (torch.stack([v, 2 * v]) if not isinstance(v, dict)
                            else {kk: torch.stack([vv, 2 * vv])
                                  for kk, vv in v.items()})
                        for k, v in tree.items()}, lead=(2,))
    assert torch.equal(rows[1], 2 * rows[0])
    # split: the autograd form hands back one row-shaped grad, zero gaps
    row = buf.clone().requires_grad_(True)
    p = lay.split(row)
    (p["b"]["w"].sum() + 3 * p["s"].sum()).backward()
    grad = row.grad
    assert grad.shape == (lay.numel,)
    assert torch.equal(lay.tree(grad)["b"]["w"], torch.ones(3, 5))
    assert float(lay.tree(grad)["s"][0]) == 3.0
    assert float(grad.abs().sum()) == 15 + 3


def test_gaps_stay_zero_under_both_updates():
    tree = _tree(1)
    lay = FlatLayout(tree)
    gen = torch.Generator().manual_seed(0)
    x, z, v, g = (lay.flatten(tree, lead=(2,)) + 0 * i for i in range(4))
    for t in (z, v, g):
        for view in lay.views(t):
            view.normal_(generator=gen)
    y = x.clone()
    ops.parle_inner_update(y, z, v, g, x, **INNER)
    ops.parle_sync_update(x, z, v, x.mean(0), **SYNC)
    live = torch.zeros(lay.numel, dtype=torch.bool)
    for view in lay.views(live):
        view.fill_(True)
    for t in (x, y, z, v):
        assert float(t[:, ~live].abs().sum()) == 0.0
        assert float(t[:, live].abs().sum()) > 0.0


# ------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions, bitwise
# ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1001, 3 * ALIGN])
def test_cuda_kernels_equal_plain_versions(dtype, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    y, z, v, g, x = (torch.from_numpy(a).to(dev)
                     for a in _streams(m, (3, m), 5))
    y, g = y.to(dtype), g.to(dtype)
    scal = pu.pack_scalars(*INNER.values(), device=dev)
    want = pu.parle_inner_update_plain(y, z, v, g, x, scal)
    pu.parle_inner_update_cuda(y, z, v, g, x, scal)
    for a, b in zip((y, z, v), want):
        assert torch.equal(a, b)
    scal = pu.pack_scalars(*SYNC.values(), device=dev)
    xbar = x.mean(0)
    y_out = torch.empty_like(x, dtype=torch.bfloat16)
    want = pu.parle_sync_update_plain(x, z, v, xbar, scal,
                                      y_dtype=torch.bfloat16)
    pu.parle_sync_update_cuda(x, z, v, xbar, scal, y_out=y_out)
    for a, b in zip((x, v, y_out), want):
        assert torch.equal(a, b)
