"""The port's Elastic-SGD against the reference: K7's plain version against
the oracle ``repro.kernels.ref.elastic_worker_update`` and the Pallas
``elastic_update_flat`` (interpret mode); the wrapper's in-place and
dispatch contracts; ``core/elastic_sgd.update`` on the same numpy state;
the contracts of tests/test_core_parle.py (Eq. 7b with plain lr, workers
pulled to the reference); scope decay every L; a round equal to the step
loop bit for bit; and two smoke Qwen2.5-3B rounds against the
reference's, with and without the kernel and in bf16.

Tolerances: K7 and one update, atol = rtol = 1e-6 (f32 arithmetic in
the same order; XLA may contract a product into an FMA), f32 or bf16
grads; the f32 smoke rounds, atol = rtol = 1e-4 (as
tests/test_torch_train.py: XLA and PyTorch sum the model's products in
different orders).  The bf16 smoke round is held at atol = rtol = 1e-2:
there the two packages round the bf16 model's activations differently
(on the same params ~10% of the bf16 embedding grads differ by an ulp),
so the losses part by up to ~5e-3 after a few updates, as Parle's bf16
rounds do; the bf16 kernel path equals the plain path bit for bit."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import elastic_sgd as ref_elastic
from repro.core import parle as ref_parle
from repro.core import registry as ref_registry
from repro.data.synthetic import TokenStream as RefTokenStream
from repro.data.synthetic import make_round_batch_fn as ref_round_batches
from repro.kernels import parle_update as ref_pu
from repro.kernels import ref as ref_oracle
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import ARCHS, ParleConfig, smoke_variant
from repro_torch.core import elastic_sgd, registry
from repro_torch.core.scoping import scopes_at
from repro_torch.kernels import ops
from repro_torch.kernels import parle_update as pu
from repro_torch.models.convert import (params_from_numpy, state_from_numpy,
                                        state_to_numpy)
from repro_torch.models.model import build_model
from repro_torch.utils.pytree import ALIGN
from torch_parity import assert_close, leaf_pairs, numpy_params

torch.set_float32_matmul_precision("highest")

TOL = dict(rtol=1e-6, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TRAJ_TOL = dict(rtol=1e-2, atol=1e-2)   # bf16 resolution is 2^-8
ELASTIC = dict(inv_rho=2.0, lr=0.1, mu=0.9)
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


def quad_loss(params, batch):
    """||p - 3||^2 / 2 — the reference tests' strongly convex objective."""
    del batch
    return 0.5 * ((params["w"] - 3.0) ** 2).sum(), ()


# ------------------------------------------------------------------
# K7: the plain version against the reference
# ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("m", SIZES)
def test_elastic_plain_matches_reference_oracle(n, m, dtype):
    x, v, g = _streams(n * 40 + m, (n, m), 3)
    ref, = _streams(m + 1, (m,), 1)
    tg, rg = _bf16(g) if dtype == "bf16" else (_t(g), g)
    want = ref_oracle.elastic_worker_update(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(rg).astype(jnp.float32),
        jnp.asarray(ref), **ELASTIC)
    got = pu.elastic_worker_update_plain(_t(x), _t(v), tg, _t(ref),
                                         pu.pack_scalars(*ELASTIC.values()))
    for name, a, b in zip(("x", "v"), got, want):
        assert a.dtype == torch.float32
        assert_close(a, b, TOL, f"K7 plain {name} {dtype} n={n} m={m}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3])
def test_elastic_plain_matches_pallas_kernel(n, dtype):
    """Against ``elastic_update_flat`` (interpret mode): (R, M) streams
    against one (M,) ref, M = one 8192 block; a bf16 g upcast on read."""
    x, v, g = _streams(50 + n, (n, ALIGN), 3)
    ref, = _streams(60 + n, (ALIGN,), 1)
    tg, rg = _bf16(g) if dtype == "bf16" else (_t(g), g)
    scal = np.array(list(ELASTIC.values()), np.float32)
    want = ref_pu.elastic_update_flat(
        *map(jnp.asarray, (x, v, rg, ref, scal)), interpret=True)
    got = pu.elastic_worker_update_plain(_t(x), _t(v), tg, _t(ref),
                                         torch.from_numpy(scal))
    for name, a, b in zip(("x", "v"), got, want):
        assert_close(a, b, TOL, f"K7 vs Pallas {name} {dtype} n={n}")


def test_elastic_wrapper_updates_in_place_on_cpu():
    x, v, g = map(_t, _streams(7, (2, 300), 3))
    ref = _t(_streams(8, (300,), 1)[0])
    ref0 = ref.clone()
    want = pu.elastic_worker_update_plain(x, v, g, ref,
                                          pu.pack_scalars(*ELASTIC.values()))
    ptrs = (x.data_ptr(), v.data_ptr())
    out = ops.elastic_worker_update(x, v, g, ref, **ELASTIC)
    assert out[0] is x and out[1] is v
    assert (x.data_ptr(), v.data_ptr()) == ptrs
    for a, b in zip((x, v), want):
        assert torch.equal(a, b)
    assert torch.equal(ref, ref0)            # ref is only read


def test_elastic_cuda_launcher_raises_on_cpu_tensors():
    x, v, g = map(_t, _streams(9, (2, 64), 3))
    before = pu.elastic_launches
    with pytest.raises(ValueError, match="CUDA"):
        pu.elastic_worker_update_cuda(x, v, g, x[0].clone(),
                                      pu.pack_scalars(*ELASTIC.values()))
    assert pu.elastic_launches == before


# ------------------------------------------------------------------
# core/elastic_sgd.py against the reference
# ------------------------------------------------------------------

def _rand_tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (3, 5)).astype(np.float32),
            "b": {"u": rng.standard_normal(lead + (7,)).astype(np.float32)}}


def _ref_state(seed, n, cfg):
    """A reference ElasticState with x, v, ref random and distinct."""
    rng = np.random.default_rng(seed)
    as_j = lambda t: jax.tree.map(jnp.asarray, t)
    st = ref_elastic.init(as_j(_rand_tree(rng)), cfg)
    return st._replace(x=as_j(_rand_tree(rng, (n,))),
                       v=as_j(_rand_tree(rng, (n,))),
                       step=jnp.asarray(2, jnp.int32))


def _assert_state_close(port, ref, what):
    got = state_to_numpy(port)
    for f in ("x", "v", "ref"):
        for path, p, r in leaf_pairs(got[f], getattr(ref, f)):
            assert_close(p, r, TOL, f"{what} {f}{path}")
    assert int(got["step"]) == int(ref.step)
    assert np.float32(got["scopes"]["rho"]) == np.float32(ref.scopes.rho)
    assert np.float32(got["scopes"]["gamma"]) == np.float32(
        ref.scopes.gamma)


@pytest.mark.parametrize("gdtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_update_matches_reference(use_kernel, gdtype):
    cfg = RefParleConfig(n_replicas=3, L=3, lr=0.1, rho0=0.5,
                         batches_per_epoch=2)
    ref_st = _ref_state(1, 3, cfg)
    rng = np.random.default_rng(2)
    grads_np = _rand_tree(rng, (3,))
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if gdtype == "bf16" \
        else (lambda a: a)
    grads_np = jax.tree.map(cast, grads_np)
    want = ref_elastic.update(ref_st, jax.tree.map(jnp.asarray, grads_np),
                              cfg, use_kernel=use_kernel)
    st = state_from_numpy(jax.tree.map(np.asarray, ref_st), "cpu")
    grads = st.layout.flatten(params_from_numpy(grads_np, "cpu"), lead=(3,),
                              dtype=torch.bfloat16 if gdtype == "bf16"
                              else torch.float32)
    got = elastic_sgd.update(st, grads, ParleConfig(
        n_replicas=3, L=3, lr=0.1, rho0=0.5, batches_per_epoch=2),
        use_kernel=use_kernel)
    _assert_state_close(got, want, f"update use_kernel={use_kernel} {gdtype}")
    assert float(got.scopes.rho) < 0.5          # step 3 = L: decayed


def test_elastic_ref_update_matches_eq7b():
    """(7b): ref <- ref - lr (ref - mean x'), plain lr (the reference's
    regression test for the lr/rho bug)."""
    cfg = ParleConfig(n_replicas=2, lr=0.25, rho0=0.5)
    st = elastic_sgd.init({"w": torch.zeros(3)}, cfg)
    st.x[0].fill_(1.0)
    st.x[1].fill_(3.0)
    new = elastic_sgd.update(st, torch.zeros_like(st.x), cfg)
    xbar = new.layout.tree(new.x)["w"].numpy().mean(0)
    np.testing.assert_allclose(new.layout.tree(new.ref)["w"].numpy(),
                               0.0 - 0.25 * (0.0 - xbar), rtol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_elastic_sgd_pulls_workers_to_reference(use_kernel):
    cfg = ParleConfig(n_replicas=3, lr=0.1, rho0=0.5, rho_min=0.01,
                      batches_per_epoch=5)
    gen = torch.Generator().manual_seed(1)
    st = elastic_sgd.init({"w": torch.randn(6, generator=gen)}, cfg)
    step = elastic_sgd.make_train_step(quad_loss, cfg, use_kernel=use_kernel)
    for _ in range(200):
        st, _ = step(st, {"x": torch.zeros(3, 1)})
    np.testing.assert_allclose(st.layout.tree(st.ref)["w"].numpy(), 3.0,
                               atol=5e-2)
    np.testing.assert_allclose(st.layout.tree(st.x)["w"].numpy(),
                               np.full((3, 6), 3.0), atol=5e-2)


def test_scope_decays_exactly_every_L():
    cfg = ParleConfig(n_replicas=2, L=3, batches_per_epoch=2, rho0=1.0)
    st = elastic_sgd.init({"w": torch.ones(4)}, cfg)
    step = elastic_sgd.make_train_step(quad_loss, cfg)
    for k in range(1, 10):
        st, m = step(st, {"x": torch.zeros(2, 1)})
        assert int(m["step"]) == k
        want = scopes_at(cfg, k // cfg.L)
        assert float(st.scopes.rho) == float(want.rho), k
        assert float(m["rho"]) == float(want.rho)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_round_bit_identical_to_step_loop(use_kernel):
    cfg = ParleConfig(n_replicas=2, L=3, batches_per_epoch=2,
                      lr_drop_steps=(4,))
    rng = np.random.default_rng(3)
    params = params_from_numpy(_rand_tree(rng), "cpu")
    batches = torch.from_numpy(rng.standard_normal((2, 3, 2, 5)).astype(
        np.float32))

    def loss(p, b):
        return ((p["w"].sum(0) - b["x"]) ** 2).mean() + p["b"]["u"].sum(), ()

    algo = registry.get("elastic_sgd")
    step = algo.make_step(loss, cfg, use_kernel=use_kernel)
    s_loop = algo.init(params, cfg)
    loop_losses = []
    for r in range(2):
        for i in range(3):
            s_loop, m = step(s_loop, {"x": batches[r, i]})
            loop_losses.append(m["loss"])
    rnd = algo.make_round_fn(loss, cfg, use_kernel=use_kernel)
    s_round = algo.init(params, cfg)
    round_losses = []
    for r in range(2):
        s_round, m = rnd(s_round, {"x": batches[r]})
        round_losses.append(m["losses"])
        assert set(m) == {"loss", "losses", "rho", "step"}
    assert torch.equal(torch.stack(loop_losses), torch.cat(round_losses))
    for f in ("x", "v", "ref"):
        assert torch.equal(getattr(s_loop, f), getattr(s_round, f)), f
    assert int(s_round.step) == 6
    assert float(s_round.scopes.rho) == float(s_loop.scopes.rho)


def test_init_buffers_are_distinct_and_deployable_is_ref():
    cfg = ParleConfig(n_replicas=2)
    params = {"w": torch.arange(5.0)}
    st = elastic_sgd.init(params, cfg)
    ptrs = {t.untyped_storage().data_ptr() for t in (st.x, st.v, st.ref)}
    assert len(ptrs) == 3
    assert elastic_sgd.dealias_state(st).x is st.x
    dep = registry.get("elastic_sgd").deployable(st)
    assert torch.equal(dep["w"], params["w"])
    assert dep["w"].data_ptr() == st.ref.data_ptr()


# ------------------------------------------------------------------
# two smoke Qwen2.5-3B rounds against the reference
# ------------------------------------------------------------------

RCFG = ref_smoke_variant(REF_ARCHS["qwen2.5-3b"])
CFG = smoke_variant(ARCHS["qwen2.5-3b"])
N, L, B, T = 2, 3, 2, 32


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(RCFG, seed=0)


@pytest.fixture(scope="module")
def ref_batches():
    stage = ref_round_batches(RefTokenStream(RCFG.vocab_size, T, B, seed=0),
                              L, B, N)
    return [jax.tree.map(np.asarray, stage(r * L)) for r in range(2)]


def _port_smoke_rounds(np_params, batches, use_kernel, kw):
    algo = registry.get("elastic_sgd")
    pcfg = algo.canonicalize_cfg(ParleConfig(**kw))
    st = algo.init(params_from_numpy(np_params, "cpu"), pcfg)
    rnd = algo.make_round_fn(build_model(CFG).loss, pcfg,
                             use_kernel=use_kernel)
    losses = []
    for b in batches:
        st, m = rnd(st, {k: torch.from_numpy(np.array(v))
                         for k, v in b.items()})
        losses.append(m["losses"])
    return st, torch.cat(losses)


@pytest.mark.parametrize("use_kernel,precision", [
    (False, "f32"), (True, "f32"), (True, "bf16")])
def test_two_smoke_rounds_match_reference(np_params, ref_batches, use_kernel,
                                          precision):
    kw = dict(n_replicas=N, L=L, batches_per_epoch=1, precision=precision)
    algo_r = ref_registry.get("elastic_sgd")
    rcfg = algo_r.canonicalize_cfg(RefParleConfig(**kw))
    ref_st = ref_parle.dealias_state(algo_r.init(
        jax.tree.map(jnp.asarray, np_params), rcfg))
    ref_round = algo_r.make_round_fn(ref_build_model(RCFG).loss, rcfg,
                                     use_kernel=use_kernel)
    ref_losses = []
    for b in ref_batches:
        ref_st, m = ref_round(ref_st, jax.tree.map(jnp.asarray, b))
        ref_losses.append(np.asarray(m["losses"]))
    st, losses = _port_smoke_rounds(np_params, ref_batches, use_kernel, kw)
    tol = BF16_TRAJ_TOL if precision == "bf16" else TRAJ_TOL
    assert_close(losses, np.concatenate(ref_losses), tol,
                 f"per-step losses use_kernel={use_kernel} {precision}")
    got = state_to_numpy(st)
    for f in ("x", "ref"):
        for path, p, r in leaf_pairs(got[f], getattr(ref_st, f)):
            assert_close(p, r, tol, f"final {f}{path}")
    assert st.x.dtype == torch.float32          # f32 masters under bf16
    assert float(st.scopes.rho) == float(ref_st.scopes.rho)
    if precision == "bf16":     # the same bf16 grads through K7 and plain
        st_p, losses_p = _port_smoke_rounds(np_params, ref_batches, False,
                                            kw)
        assert torch.equal(losses, losses_p)
        assert torch.equal(st.x, st_p.x) and torch.equal(st.ref, st_p.ref)


# ------------------------------------------------------------------
# on the card: K7 against its plain version, bitwise
# ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1001, 3 * ALIGN])
def test_cuda_k7_equals_plain_version(dtype, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x, v, g = (torch.from_numpy(a).to(dev) for a in _streams(m, (3, m), 3))
    ref = torch.from_numpy(_streams(m + 1, (m,), 1)[0]).to(dev)
    g = g.to(dtype)
    scal = pu.pack_scalars(*ELASTIC.values(), device=dev)
    want = pu.elastic_worker_update_plain(x, v, g, ref, scal)
    pu.elastic_worker_update_cuda(x, v, g, ref, scal)
    for a, b in zip((x, v), want):
        assert torch.equal(a, b)
