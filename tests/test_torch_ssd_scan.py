"""The port's SSD scan (K9) against the JAX reference on the same numpy
inputs: its plain version and the model's ``ssd_chunked`` against the
reference's naive recurrence (``repro.kernels.ref.ssd_scan``) and the
Pallas kernel in interpret mode at ``test_ssd_scan_vs_naive``'s tier-1
cases, (T, chunk) = (128, 128) with (N, P) = (16, 32) and (64, 64), at
1e-4; ``ssd_chunked`` from an ``h0`` and at T % Q != 0; the chunk-size
invariance property (2e-4); the ``ops.ssd_scan`` dispatch; a torch
model of the kernel's three passes (chunk states, state passing, chunk
scan with C B^T shared by the heads), its products through the 3xTF32
split, against both references at cases of several chunks and a ragged
chunk (1e-4), and the same model with one TF32 product per float32
product, to show why the split is needed; and the kernel against its
plain version on a card (``gpu``, skipped without one).  Also the one place the port departs from the reference on
purpose: ``ssd_chunked``'s backward stays finite where the reference's
turns NaN (masked decays that overflow, see ROADMAP.md §3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import mamba2 as ref_mamba2
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.mamba2 import ssd_chunked
from torch_parity import _product_1xtf32, _product_3xtf32, assert_close

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PROP_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16 outputs: both sides round their float32 result to bfloat16 (8
# significant bits), so they may part by one or two units of 2^-8
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _inputs(B, T, nh, P, N, seed=0, h0=False):
    """The reference kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, nh, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32) * 0.5
    Cm = rng.standard_normal((B, T, N)).astype(np.float32) * 0.5
    out = [x, dt, A, Bm, Cm]
    if h0:
        out.append(rng.standard_normal((B, nh, N, P)).astype(np.float32)
                   * 0.1)
    return out


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("N,P", [(16, 32), (64, 64)])
def test_plain_and_chunked_match_naive_and_pallas(N, P):
    arrays = _inputs(2, 128, 3, P, N, seed=N)
    y_r, h_r = ref_kernels.ssd_scan(*_jax(arrays))
    y_k, h_k = ref_ops.ssd_scan(*_jax(arrays), chunk=128)
    for name, (y, h) in {
            "plain": ssd.ssd_scan_plain(*_torch(arrays)),
            "ssd_chunked": ssd_chunked(*_torch(arrays), 128)}.items():
        assert_close(y, y_r, TOL, f"{name} y vs naive")
        assert_close(h, h_r, TOL, f"{name} h vs naive")
        assert_close(y, y_k, TOL, f"{name} y vs pallas")
        assert_close(h, h_k, TOL, f"{name} h vs pallas")


@pytest.mark.parametrize("T,chunk", [(64, 16), (50, 16)])
def test_chunked_from_h0_and_ragged_matches_naive(T, chunk):
    """A resumed prefix (h0) and T % Q != 0 (dt = 0 padding)."""
    arrays = _inputs(1, T, 2, 16, 8, seed=T, h0=True)
    y_r, h_r = ref_kernels.ssd_scan(*_jax(arrays[:5]), h0=jnp.asarray(
        arrays[5]))
    t = _torch(arrays)
    y, h = ssd_chunked(*t[:5], chunk, h0=t[5])
    assert_close(y, y_r, TOL, f"y T={T} chunk={chunk}")
    assert_close(h, h_r, TOL, f"h T={T} chunk={chunk}")
    y_ref, h_ref = ref_mamba2.ssd_chunked(*_jax(arrays[:5]), chunk,
                                          h0=jnp.asarray(arrays[5]))
    assert_close(y, y_ref, TOL, "y vs the reference's ssd_chunked")
    assert_close(h, h_ref, TOL, "h vs the reference's ssd_chunked")
    yp, hp = ssd.ssd_scan_plain(*t[:5], h0=t[5])
    assert_close(yp, y_r, TOL, "plain from h0")
    assert_close(hp, h_r, TOL, "plain h from h0")


@given(seed=st.integers(0, 30), chunk=st.sampled_from([4, 8, 16, 64]))
@settings(max_examples=20, deadline=None)
def test_ssd_chunk_size_invariance(seed, chunk):
    """SSD output must not depend on the chunking (the reference's
    property test, on the port, against the port's plain version)."""
    x, dt, A, Bm, Cm = _torch(_inputs(1, 64, 2, 8, 4, seed=seed))
    y, h = ssd_chunked(x, dt, A, Bm, Cm, chunk)
    yr, hr = ssd.ssd_scan_plain(x, dt, A, Bm, Cm)
    assert_close(y, yr.numpy(), PROP_TOL, f"y chunk={chunk}")
    assert_close(h, hr.numpy(), PROP_TOL, f"h chunk={chunk}")


def test_ops_dispatch():
    x, dt, A, Bm, Cm, h0 = _torch(_inputs(1, 32, 2, 8, 8, seed=3, h0=True))
    before = ssd.launches
    # with h0: the model's chunked path, as the reference dispatches
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16, h0=h0)
    y2, h2 = ssd_chunked(x, dt, A, Bm, Cm, 16, h0=h0)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    # a CPU tensor: the plain version
    y, h = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=16)
    y2, h2 = ssd.ssd_scan_plain(x, dt, A, Bm, Cm)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert ssd.launches == before
    # T % Q != 0 is refused, as the reference asserts
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(x[:, :24], dt[:, :24], A, Bm[:, :24], Cm[:, :24],
                     chunk=16)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.ssd_scan(x.requires_grad_(True), dt, A, Bm, Cm, chunk=16)


def test_cuda_wrapper_rejects_cpu_tensors():
    before = ssd.launches
    with pytest.raises(ValueError, match="CUDA device"):
        ssd.ssd_scan_cuda(*_torch(_inputs(1, 32, 2, 32, 8)), 16)
    assert ssd.launches == before


def test_chunked_backward_stays_finite_where_the_reference_is_nan():
    """Within one chunk, cum_i - cum_j for the masked j > i reaches
    dt |A| Q = 0.1 x 16 x 128 = 205 > 88.7: the reference's
    where(mask, exp(delta), 0) keeps the forward but its backward
    multiplies the masked zeros by exp(delta) = inf (NaN); the port's
    exp(-inf) = 0 gives the same forward and a finite backward."""
    x, _, _, Bm, Cm = _inputs(1, 128, 2, 8, 8, seed=1)
    dt = np.full((1, 128, 2), 0.1, np.float32)
    A = np.array([-1.0, -16.0], np.float32)
    ref_grad = jax.grad(lambda d: ref_mamba2.ssd_chunked(
        jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(Bm), jnp.asarray(Cm),
        128)[0].sum())(jnp.asarray(dt))
    assert bool(jnp.isnan(ref_grad).any())
    dtt = torch.from_numpy(dt).requires_grad_(True)
    y, _ = ssd_chunked(torch.from_numpy(x), dtt, torch.from_numpy(A),
                       torch.from_numpy(Bm), torch.from_numpy(Cm), 128)
    y.sum().backward()
    assert bool(torch.isfinite(dtt.grad).all())
    y_ref, _ = ref_mamba2.ssd_chunked(*_jax([x, dt, A, Bm, Cm]), 128)
    assert_close(y, y_ref, TOL, "forward where the reference's grad is NaN")


def _three_pass_model(x, dt, A, Bm, Cm, Q, product):
    """K9's float32 arithmetic, pass by pass, with its four products
    through ``product``: (1) each chunk's state s_c = (B w)^T x, w_j =
    exp(cum_last - cum_j) dt_j, and its decay exp(cum_last); (2) the
    state entering each chunk, h_in[c] = h, h = decay_c h + s_c; (3) C B^T
    once per (b, chunk), shared by every head, then y = exp(cum_i) (C
    h_in) + scores x with scores_ij = (C B^T)_ij exp(cum_i - cum_j) dt_j
    for j <= i."""
    Bsz, T, nh, P = x.shape
    N, nc = Bm.shape[-1], T // Q
    xc = x.reshape(Bsz, nc, Q, nh, P)
    dtc = dt.reshape(Bsz, nc, Q, nh)
    Bc, Cc = Bm.reshape(Bsz, nc, Q, N), Cm.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(dtc * A, dim=2)                    # (B, nc, Q, nh)
    last = cum[:, :, -1:]
    bw = Bc[:, :, :, None, :] * (torch.exp(last - cum) * dtc)[..., None]
    states = product("bcjhn,bcjhp->bchnp", bw, xc)        # pass 1
    decay = torch.exp(last[:, :, 0])                      # (B, nc, nh)
    h = torch.zeros((Bsz, nh, N, P))
    h_in = []
    for c in range(nc):                                   # pass 2
        h_in.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                       # (B, nc, nh, N, P)
    cb = product("bcin,bcjn->bcij", Cc, Bc)               # pass 3
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nc, i, j, nh)
    decayed = torch.exp(delta.masked_fill(~causal[:, :, None], float("-inf")))
    scores = cb[..., None] * decayed * dtc[:, :, None, :, :]
    y = (torch.exp(cum)[..., None] * product("bcin,bchnp->bcihp", Cc, h_in)
         + product("bcijh,bcjhp->bcihp", scores, xc))
    return y.reshape(Bsz, T, nh, P), h


@pytest.mark.parametrize("B,T,nh,P,N,Q", [(2, 512, 3, 32, 16, 128),
                                          (2, 512, 3, 64, 64, 128),
                                          (2, 96, 3, 32, 16, 24)],
                         ids=["n16_p32", "n64_p64", "ragged_q24"])
def test_three_pass_3xtf32_model_matches_naive_and_pallas(B, T, nh, P, N, Q):
    """Several chunks, so the state passes between them (the tier-1
    cases above are one chunk each), and a chunk of 24 (ragged 16-row
    tiles on the card): the 3xTF32 model within 1e-4 of the naive
    recurrence and of the Pallas kernel; one TF32 product per float32
    product lands far off (its error printed beside the split's)."""
    arrays = _inputs(B, T, nh, P, N, seed=T + N)
    y_r, h_r = ref_kernels.ssd_scan(*_jax(arrays))
    y_k, h_k = ref_ops.ssd_scan(*_jax(arrays), chunk=Q)
    y, h = _three_pass_model(*_torch(arrays), Q, _product_3xtf32)
    err_3x = assert_close(y, y_r, TOL, "3xTF32 model y vs naive")
    assert_close(h, h_r, TOL, "3xTF32 model h vs naive")
    assert_close(y, y_k, TOL, "3xTF32 model y vs pallas")
    assert_close(h, h_k, TOL, "3xTF32 model h vs pallas")
    y1, h1 = _three_pass_model(*_torch(arrays), Q, _product_1xtf32)
    err_1x = max(assert_close(y1, y_r, dict(rtol=1, atol=1),
                              "1xTF32 model y vs naive"),
                 assert_close(h1, h_r, dict(rtol=1, atol=1),
                              "1xTF32 model h vs naive"))
    assert err_1x > 10 * err_3x and err_1x > TOL["atol"], (err_1x, err_3x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["n16_p32", "n64_p64", "bf16",
                                  "multi_chunk", "strided",
                                  "multi_chunk_n16_p32",
                                  "multi_chunk_n64_p64", "multi_chunk_bf16",
                                  "zamba2", "q24", "q5_n8",
                                  "strided_xbc"])
def test_kernel_matches_plain_on_card(case, cuda_device):
    shape = {"n16_p32": (2, 128, 3, 32, 16, 128),
             "n64_p64": (2, 128, 3, 64, 64, 128),
             "bf16": (2, 128, 3, 64, 64, 128),
             "multi_chunk": (2, 256, 4, 64, 128, 64),
             "strided": (1, 64, 2, 32, 16, 16),
             "multi_chunk_n16_p32": (2, 512, 3, 32, 16, 128),
             "multi_chunk_n64_p64": (2, 512, 3, 64, 64, 128),
             "multi_chunk_bf16": (2, 512, 3, 64, 64, 128),
             # Zamba2-1.2B's geometry: 64 heads of 64, state 64
             "zamba2": (2, 2048, 64, 64, 64, 128),
             "q24": (2, 96, 3, 32, 16, 24),
             "q5_n8": (1, 20, 2, 32, 8, 5),
             "strided_xbc": (2, 256, 4, 64, 128, 128)}[case]
    B, T, nh, P, N, chunk = shape
    dtype = torch.bfloat16 if "bf16" in case else torch.float32
    x, dt, A, Bm, Cm = [t.to(cuda_device) for t in _torch(
        _inputs(B, T, nh, P, N, seed=9))]
    x, dt, Bm, Cm = (t.to(dtype) for t in (x, dt, Bm, Cm))
    if case.startswith("strided"):   # x, B, C as slices of one xBC row
        xbc = torch.cat([x.reshape(B, T, nh * P), Bm, Cm], dim=-1)
        x = xbc[..., :nh * P].reshape(B, T, nh, P)
        Bm, Cm = xbc[..., nh * P:nh * P + N], xbc[..., nh * P + N:]
    before = ssd.launches
    y, h = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
    y2, h2 = ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize(cuda_device)
    assert ssd.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    y_p, h_p = ssd.ssd_scan_plain(x, dt, A, Bm, Cm)
    tol = BF16_TOL if dtype == torch.bfloat16 else TOL
    assert_close(y.float().cpu(), y_p.float().cpu().numpy(), tol, f"{case} y")
    assert_close(h.float().cpu(), h_p.float().cpu().numpy(), tol, f"{case} h")
