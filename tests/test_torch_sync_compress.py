"""The compressed Eq. (8d) sync of the port (``--sync-compress bf16|int8``):
the codec (``repro_torch.core.compress``) against ``repro.core.compress``,
the plain versions of K4 (int8 quantize + error feedback) and K5
(dequantize + mean + sync update) against the reference oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode, the
contracts of tests/test_sync_compress.py inside the port, two smoke
rounds against the reference, and the CUDA kernels against their plain
versions (``gpu``, skipped without a card).

Tolerances: the int8 payload (codes and scales) is compared bit for bit,
as the reference's own kernel test does; residuals at rtol = atol = 1e-6
(that test's bound); K5 at 1e-5 / 1e-6; trajectories at 1e-4 (the
training parity bound of tests/test_torch_train.py)."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import compress as ref_compress
from repro.core import parle as ref_parle
from repro.data.synthetic import TokenStream as RefTokenStream
from repro.data.synthetic import make_round_batch_fn as ref_round_batches
from repro.kernels import parle_update as ref_pu
from repro.kernels import ref as ref_oracle
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCHS, ParleConfig, smoke_variant
from repro_torch.core import compress, parle, registry
from repro_torch.kernels import ops
from repro_torch.kernels import parle_update as pu
from repro_torch.models.convert import state_from_numpy, state_to_numpy
from torch_parity import (assert_close, leaf_pairs, numpy_params,
                          port_rounds, ref_rounds)

E_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
SYNC = dict(gamma_scale=1.0, inv_rho=2.0, lr=0.1, mu=0.9)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bits(q):
    """A payload as comparable numpy: int8 codes, or bf16 as uint16."""
    if isinstance(q, torch.Tensor):
        if q.dtype == torch.bfloat16:
            return q.view(torch.int16).numpy().view(np.uint16)
        return q.numpy()
    q = np.asarray(q)
    return q.view(np.uint16) if q.dtype == ml_dtypes.bfloat16 else q


def _stream():
    """The reference test's (3, 20000) * 7 stream, padded to 8192."""
    return np.asarray(ref_compress.pad_to_chunk(
        jax.random.normal(jax.random.PRNGKey(2), (3, 20000)) * 7.0))


def _edge_chunks():
    """Chunk 0 has amax 127, so its scale is exactly 1.0, and holds
    +-k.5 values: they pin half-to-even rounding (0.5 -> 0, 1.5 -> 2,
    2.5 -> 2, 126.5 -> 126).  Chunk 1 is all zeros (scale 1, codes 0).
    The rest of the row is random."""
    rng = np.random.default_rng(11)
    c = rng.standard_normal((2, compress.PAD_MULTIPLE)).astype(np.float32)
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5,
                     4.5], np.float32)
    c[0, :compress.CHUNK] = rng.uniform(-100, 100, compress.CHUNK)
    c[0, :half.size] = half
    c[0, compress.CHUNK:2 * compress.CHUNK] = 0.0
    return c


CODEC_INPUTS = {"stream": _stream, "edge_chunks": _edge_chunks}


# ------------------------------------------------------------------
# the codec against repro.core.compress
# ------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(CODEC_INPUTS))
def test_codec_matches_reference_bit_for_bit(case, method):
    c = CODEC_INPUTS[case]()
    rq, rs, re = ref_compress.quantize_ef(jnp.asarray(c), method)
    q, s, e = compress.quantize_ef(_t(c), method)
    np.testing.assert_array_equal(_bits(q), _bits(rq))
    if method == "int8":
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    else:
        assert q.dtype == torch.bfloat16 and s is None and rs is None
    assert_close(e, re, E_TOL, f"residual {case} {method}")
    np.testing.assert_array_equal(
        compress.dequantize(q, s, method).numpy(),
        np.asarray(ref_compress.dequantize(rq, rs, method)))


def test_int8_edge_chunks_round_half_to_even():
    q, s, e = compress.quantize_ef(_t(_edge_chunks()), "int8")
    assert float(s[0, 0]) == 1.0 and float(s[0, 1]) == 1.0
    assert q[0, :10].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -4, 4]
    assert not q[0, 1024:2048].any() and not e[0, 1024:2048].any()


def test_int8_quantize_error_bounded_per_chunk():
    rng = np.random.default_rng(0)
    c = compress.pad_to_chunk(torch.from_numpy(
        (rng.standard_normal((2, 5000)) * np.linspace(0.1, 30, 5000))
        .astype(np.float32)))
    assert c.shape == (2, compress.PAD_MULTIPLE)
    q, s, res = compress.quantize_ef(c, "int8")
    assert q.dtype == torch.int8
    step = s[..., None]                      # scale = one int8 step
    assert bool((res.reshape(2, -1, compress.CHUNK).abs()
                 <= step / 2 + 1e-7).all())


def test_nan_chunk_gets_a_nan_scale_as_in_the_reference():
    c = _edge_chunks()
    c[1, 5] = np.nan
    _, rs, _ = ref_compress.quantize_ef(jnp.asarray(c), "int8")
    _, s, _ = compress.quantize_ef(_t(c), "int8")
    np.testing.assert_array_equal(np.isnan(s.numpy()),
                                  np.isnan(np.asarray(rs)))
    assert bool(torch.isnan(s[1, 0])) and not bool(torch.isnan(s[1, 1:]).any())


def test_dequantize_mean_is_the_reference_mean():
    """n = 2: the left-to-right sum over replicas, then / n, is
    ``jnp.mean(dequantize(q), 0)`` bit for bit; n = 4 to 1e-6."""
    for n in (2, 4):
        c = np.random.default_rng(n).standard_normal(
            (n, compress.PAD_MULTIPLE)).astype(np.float32) * 3
        rq, rs = ref_compress.quantize(jnp.asarray(c), "int8")
        want = np.asarray(jnp.mean(ref_compress.dequantize(rq, rs, "int8"),
                                   axis=0))
        q, s = compress.quantize(_t(c), "int8")
        got = compress.dequantize_mean(q, s, "int8")
        if n == 2:
            np.testing.assert_array_equal(got.numpy(), want)
        assert_close(got, want, E_TOL, f"dequantized mean n={n}")
        out = torch.empty(compress.PAD_MULTIPLE)
        assert compress.dequantize_mean(q, s, "int8", out=out) is out
        assert torch.equal(out, got)


# ------------------------------------------------------------------
# K4, K5: plain versions against the oracles and the Pallas kernels
# ------------------------------------------------------------------

def test_quantize_kernel_matches_oracle():
    c = _stream()
    w_q, w_s, w_e = ref_oracle.quantize_ef(jnp.asarray(c))
    g_q, g_s, g_e = ref_pu.quantize_ef_flat(jnp.asarray(c), interpret=True)
    q, s, e = pu.quantize_ef_plain(_t(c))
    for want in ((w_q, w_s, w_e), (g_q, g_s, g_e)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want[1]))
        assert_close(e, want[2], E_TOL, "K4 residual")


@pytest.mark.parametrize("emit_y", [False, True])
def test_dequant_update_kernel_matches_composed_oracle(emit_y):
    """K5's plain version against dequantize -> mean -> sync update (the
    oracle) and the Pallas kernel, at R = 2 local rows and n = 4
    payloads; the fused bf16 y' is bf16(x')."""
    rng = np.random.default_rng(3)
    r, n, m = 2, 4, 2 * compress.PAD_MULTIPLE
    x, z, v = (rng.standard_normal((r, m)).astype(np.float32)
               for _ in range(3))
    c = rng.standard_normal((n, m)).astype(np.float32) * 3.0
    q, s = ref_compress.quantize(jnp.asarray(c), "int8")
    want = ref_oracle.parle_sync_dequant_update(
        *map(jnp.asarray, (x, z, v)), q, s, **SYNC)
    scal = np.array(list(SYNC.values()), np.float32)
    pallas = ref_pu.parle_sync_dequant_flat(
        *map(jnp.asarray, (x, z, v)), q, s.reshape(n, -1), jnp.asarray(scal),
        y_dtype=jnp.bfloat16 if emit_y else None)
    got = pu.parle_sync_dequant_update_plain(
        *map(_t, (x, z, v, q, s)), torch.from_numpy(scal),
        y_dtype=torch.bfloat16 if emit_y else None)
    assert len(got) == len(pallas) == (3 if emit_y else 2)
    for ref_out in (want, pallas):
        for name, a, b in zip(("x", "v"), got, ref_out):
            assert_close(a, b, TOL, f"K5 plain {name}")
    if emit_y:
        assert torch.equal(got[2], got[0].to(torch.bfloat16))


def test_wrappers_on_cpu_run_in_place():
    rng = np.random.default_rng(4)
    c = _t(rng.standard_normal((2, compress.PAD_MULTIPLE)).astype(np.float32))
    want = pu.quantize_ef_plain(c)
    q, s, e = ops.quantize_ef(c.clone())
    buf = c.clone()
    q2, s2, e2 = ops.quantize_ef(buf, in_place=True)
    assert e2 is buf
    for a, b, d in zip((q, s, e), (q2, s2, e2), want):
        assert torch.equal(a, d) and torch.equal(b, d)

    x, z, v = (_t(rng.standard_normal(c.shape).astype(np.float32))
               for _ in range(3))
    scal = pu.pack_scalars(*SYNC.values())
    want = pu.parle_sync_dequant_update_plain(x, z, v, q, s, scal,
                                              y_dtype=torch.bfloat16)
    y16 = torch.zeros(x.shape, dtype=torch.bfloat16)
    x2, v2, y2 = ops.parle_sync_dequant_update(x, z, v, q, s, y_out=y16,
                                               **SYNC)
    assert x2 is x and v2 is v and y2 is y16
    for a, b in zip((x, v, y16), want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError):
        ops.parle_sync_dequant_update(x, z, v, q, s, y_out=torch.zeros_like(x),
                                      **SYNC)


def test_cuda_launchers_raise_on_cpu_tensors():
    """The CUDA entry points never take a CPU tensor (no fallback)."""
    c = torch.zeros(2, compress.PAD_MULTIPLE)
    q = torch.zeros(c.shape, dtype=torch.int8)
    s = torch.zeros(2, compress.PAD_MULTIPLE // compress.CHUNK)
    scal = pu.pack_scalars(*SYNC.values())
    before = (pu.quantize_launches, pu.dequant_sync_launches,
              pu.apply_quantize_launches)
    with pytest.raises(ValueError, match="CUDA"):
        pu.quantize_ef_cuda(c, q, s, c)
    with pytest.raises(ValueError, match="CUDA"):
        pu.parle_sync_dequant_update_cuda(c, c, c, q, s, scal)
    with pytest.raises(ValueError, match="CUDA"):
        pu.parle_apply_quantize_cuda(c, c, c, c[0], c, q, s, scal)
    assert (pu.quantize_launches, pu.dequant_sync_launches,
            pu.apply_quantize_launches) == before


# ------------------------------------------------------------------
# error feedback and the sync step (tests/test_sync_compress.py)
# ------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_error_feedback_drives_quantization_error_to_zero(method):
    """Fixed contribution c: with the residual carried across syncs the
    running mean of the payloads telescopes to c at O(1/K)."""
    rng = np.random.default_rng(4)
    c = compress.pad_to_chunk(torch.from_numpy(
        (rng.standard_normal((1, 4000)) * 13.7).astype(np.float32)))
    e = torch.zeros_like(c)
    acc = torch.zeros_like(c)
    errs = []
    for k in range(1, 33):
        q, s, e = compress.quantize_ef(c + e, method)
        acc = acc + compress.dequantize(q, s, method)
        errs.append(float((acc / k - c).abs().max()))
    assert errs[-1] < errs[0] / 8, errs[::8]
    assert float(e.abs().max()) < float(c.abs().max()) * 0.01


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sync_step_carries_residual_and_stays_near_mean(use_kernel):
    """The first sync's residual is exactly c - dequant(q) of x (e
    started at 0), and the reference's sync step gives the same state."""
    kw = dict(n_replicas=4, L=1, batches_per_epoch=10, sync_compress="int8")
    cfg, rcfg = ParleConfig(**kw), RefParleConfig(**kw)
    w = np.random.default_rng(5).standard_normal((4, 300)).astype(
        np.float32) * 5.0
    state = parle.init_from_replicas({"w": _t(w)}, cfg)
    assert state.e is not None and state.e.shape == (4, compress.PAD_MULTIPLE)
    out = parle.sync_step(state, cfg, use_kernel=use_kernel)
    _, _, res = compress.quantize_ef(compress.pad_to_chunk(_t(w)), "int8")
    assert torch.equal(out.layout.tree(out.e)["w"], res[:, :300])
    assert not out.e[:, 300:].any()                  # the gap stays zero
    ref = ref_parle.sync_step(ref_parle.init_from_replicas(
        {"w": jnp.asarray(w)}, rcfg), rcfg, use_kernel=use_kernel)
    got = state_to_numpy(out)
    assert_close(got["e"]["w"], ref.e["w"], E_TOL, "residual")
    assert_close(got["x"]["w"], ref.x["w"], TOL, "x after the sync")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_inner_and_sync_steps_match_reference(method, use_kernel, precision):
    """A random state (e included) through one inner step and one
    compressed sync in both packages."""
    kw = dict(n_replicas=2, L=2, lr=0.1, lr_inner=0.05, gamma0=10.0,
              batches_per_epoch=5, precision=precision, sync_compress=method)
    rcfg, pcfg = RefParleConfig(**kw), ParleConfig(**kw)
    rng = np.random.default_rng(6)
    tree = lambda: {"w": jnp.asarray(rng.standard_normal((2, 3, 5))
                                     .astype(np.float32)),
                    "b": {"u": jnp.asarray(rng.standard_normal((2, 7))
                                           .astype(np.float32))}}
    ref = ref_parle.init_from_replicas(tree(), rcfg)
    cd = ref.y["w"].dtype
    ref = ref._replace(y=jax.tree.map(lambda a: a.astype(cd), tree()),
                       z=tree(), v_y=tree(), v_x=tree(),
                       e=jax.tree.map(lambda a: 0.01 * a, tree()))
    port = state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    grads = tree()
    ref = ref_parle.inner_step(ref, jax.tree.map(lambda a: a.astype(cd),
                                                 grads), rcfg,
                               use_kernel=use_kernel)
    port = parle.inner_step(port, port.layout.flatten(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), grads),
        lead=(2,), dtype=port.y.dtype), pcfg, use_kernel=use_kernel)
    ref = ref_parle.sync_step(ref, rcfg, use_kernel=use_kernel)
    port = parle.sync_step(port, pcfg, use_kernel=use_kernel)
    got = state_to_numpy(port)
    for f in ("x", "y", "z", "v_y", "v_x", "e"):
        for path, p, r in leaf_pairs(got[f], getattr(ref, f)):
            if r.dtype == jnp.bfloat16:
                p = p.view(jnp.bfloat16)
            assert_close(np.asarray(p, np.float32), np.asarray(r, np.float32),
                         TOL, f"{method} {f}{path}")


def test_compressed_trajectory_tracks_uncompressed_loosely():
    """int8 + EF is lossy per sync but tracks the uncompressed
    trajectory closely on a smooth problem."""
    algo = registry.get("parle")

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).mean(), ()

    params = {"w": torch.from_numpy(np.random.default_rng(6)
                                    .standard_normal(64).astype(np.float32))}
    batch = {"t": torch.zeros(2, 64)}
    outs = {}
    for method in ("none", "int8"):
        cfg = ParleConfig(n_replicas=2, L=2, lr=0.05, lr_inner=0.05,
                          batches_per_epoch=10, sync_compress=method)
        state = algo.init(params, cfg)
        step = algo.make_step(loss, cfg)
        for _ in range(8):
            state, _ = step(state, batch)
        outs[method] = algo.deployable(state)["w"]
    np.testing.assert_allclose(outs["int8"].numpy(), outs["none"].numpy(),
                               rtol=5e-3, atol=5e-3)


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError, match="sync_compress must be one of"):
        parle.init({"w": torch.zeros(3)}, ParleConfig(sync_compress="fp8"))


def test_int8_checkpoint_roundtrip_resumes_training(tmp_path):
    algo = registry.get("parle")
    cfg = ParleConfig(n_replicas=2, L=2, lr=0.05, lr_inner=0.05,
                      batches_per_epoch=10, sync_compress="int8",
                      precision="bf16")

    def loss(p, b):
        return ((p["w"].float() - b["t"]) ** 2).mean(), ()

    rng = np.random.default_rng(7)
    params = {"w": torch.from_numpy(rng.standard_normal(40).astype(
        np.float32))}
    batch = {"t": torch.from_numpy(rng.standard_normal((2, 40)).astype(
        np.float32))}
    state = algo.init(params, cfg)
    step = algo.make_step(loss, cfg)
    for _ in range(4):                       # crosses 2 sync boundaries
        state, _ = step(state, batch)
    assert float(state.e.abs().max()) > 0    # EF active
    path = str(tmp_path / "int8.npz")
    ckpt.save(path, state, step=4, algo="parle")
    restored = ckpt.restore(path, algo.init(params, cfg), algo="parle")
    assert torch.equal(state.e, restored.e)
    assert torch.equal(algo.deployable(state)["w"],
                       algo.deployable(restored)["w"])
    s_a, _ = step(state, batch)
    s_b, _ = step(restored, batch)
    assert torch.equal(s_a.x, s_b.x) and torch.equal(s_a.e, s_b.e)


@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_kernel_path_equals_plain_path_on_cpu(method):
    """On the CPU, --use-kernel runs K4/K5's plain versions: the same
    arithmetic as the default path's row-by-row codec, so the same bits
    (losses, x and the residual)."""
    from test_torch_parle import CFG, _batches
    from repro_torch.models.model import build_model
    model = build_model(CFG)
    pcfg = ParleConfig(n_replicas=2, L=2, batches_per_epoch=2,
                       sync_compress=method)
    params = model.init(torch.Generator().manual_seed(1))
    out = []
    for use_kernel in (False, True):
        st = parle.init(params, pcfg)
        rnd = parle.make_round_fn(model.loss, pcfg, use_kernel=use_kernel)
        b = _batches(4, 2, seed=4)
        for r in range(2):
            st, m = rnd(st, {k: v[2 * r:2 * r + 2] for k, v in b.items()})
        out.append((st.x.clone(), st.e.clone(), m["losses"]))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ------------------------------------------------------------------
# two smoke Qwen2.5-3B rounds against the reference
# ------------------------------------------------------------------

RCFG = ref_smoke_variant(REF_ARCHS["qwen2.5-3b"])
CFG = smoke_variant(ARCHS["qwen2.5-3b"])
N, L, B, T = 2, 3, 2, 32


@pytest.fixture(scope="module")
def smoke_inputs():
    stage = ref_round_batches(RefTokenStream(RCFG.vocab_size, T, B, seed=0),
                              L, B, N)
    return (numpy_params(RCFG, seed=0),
            [jax.tree.map(np.asarray, stage(r * L)) for r in range(2)])


def _step_bound(method, x, e):
    """An upper bound of one quantization step of each element's
    payload c ~ x + e: a bf16 ulp (at most 2^-7 |c|), or the int8 scale
    of its 1024-element chunk (max |c| / 127), with 10% to spare for
    the sync's move of x since the payload was taken."""
    c = np.abs(x) + np.abs(e)
    if method == "bf16":
        return 1.1 * 2.0 ** -7 * c
    n = c.shape[0]
    flat = c.reshape(n, -1)
    pad = (-flat.shape[1]) % compress.CHUNK
    amax = np.pad(flat, ((0, 0), (0, pad))).reshape(
        n, -1, compress.CHUNK).max(-1)
    step = np.repeat(amax, compress.CHUNK, axis=1)[:, :flat.shape[1]]
    return 1.1 * step.reshape(c.shape) / 127.0


def assert_trajectories_close(port, port_losses, ref, ref_losses, method,
                              what):
    """Per-step losses and the final x and e at TRAJ_TOL, except where a
    payload code flipped between the packages: x differs by float noise
    across XLA and PyTorch (~1e-5), and an element on a rounding edge of
    the codec then takes the neighbouring code in one package.  Its
    residual then differs by one quantization step, and its x by that
    step times lr (1 + mu) inv_rho / n.  Such elements are allowed only
    up to those bounds and only at 1 in 10^4 of the state; their count
    and largest error are printed (``pytest -s``) and named in any
    failure."""
    assert_close(port_losses, ref_losses, TRAJ_TOL, f"{what} losses")
    got = state_to_numpy(port)
    flips, worst, size = 0, 0.0, 0
    for (path, px, rx), (_, pe, re) in zip(leaf_pairs(got["x"], ref.x),
                                           leaf_pairs(got["e"], ref.e)):
        rx, re = np.asarray(rx), np.asarray(re)
        step = _step_bound(method, rx, re)
        size += rx.size
        for f, p, r, bound in (("x", px, rx, step * 0.1 * 1.9 * 2.0 / N),
                               ("e", pe, re, step)):
            err = np.abs(p - r)
            off = ~np.isclose(p, r, **TRAJ_TOL)
            assert (err[off] <= bound[off]).all(), (
                f"{what} final {f}{path}: {int(off.sum())} elements beyond "
                f"1e-4, max abs err {float(err.max()):.3e}, beyond one "
                f"quantization step")
            if f == "e":
                flips += int(off.sum())
            worst = max(worst, float(err.max()))
    print(f"[parity] {what}: final x and e max_abs_err {worst:.3e}; "
          f"{flips} of {size} residuals differ by a flipped code")
    assert flips <= size // 10_000, (
        f"{what}: {flips} of {size} payload codes flipped (max abs err "
        f"{worst:.3e})")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("method", ["bf16", "int8"])
def test_two_rounds_match_reference(smoke_inputs, method, use_kernel):
    np_params, batches = smoke_inputs
    kw = dict(n_replicas=N, L=L, batches_per_epoch=1, sync_compress=method)
    ref, ref_losses = ref_rounds(RCFG, np_params, batches, use_kernel, **kw)
    port, port_losses = port_rounds(CFG, np_params, batches, use_kernel,
                                    **kw)
    assert_trajectories_close(port, port_losses, ref, ref_losses, method,
                              f"{method} barrier use_kernel={use_kernel}")
    assert float(port.scopes.gamma) == float(ref.scopes.gamma)


# ------------------------------------------------------------------
# on the card: K4 and K5 against their plain versions, bit for bit
# ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(1, 1), (2, 2), (2, 3)])
def test_cuda_k4_k5_equal_plain_versions(rows, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    m = 3 * compress.PAD_MULTIPLE
    gen = torch.Generator(device=dev).manual_seed(rows * 10 + n)
    c = torch.randn((n, m), generator=gen, device=dev) * 5
    q = torch.empty(c.shape, dtype=torch.int8, device=dev)
    s = torch.empty((n, m // compress.CHUNK), device=dev)
    want = pu.quantize_ef_plain(c)
    got = pu.quantize_ef_cuda(c.clone(), q, s, c.clone())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    x, z, v = (torch.randn((rows, m), generator=gen, device=dev)
               for _ in range(3))
    scal = pu.pack_scalars(*SYNC.values(), device=dev)
    y_out = torch.empty_like(x, dtype=torch.bfloat16)
    want = pu.parle_sync_dequant_update_plain(x, z, v, q, s, scal,
                                              y_dtype=torch.bfloat16)
    got = pu.parle_sync_dequant_update_cuda(x, z, v, q, s, scal, y_out=y_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
