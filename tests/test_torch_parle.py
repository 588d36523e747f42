"""The port's Parle (``repro_torch.core.parle``): its inner and sync steps
against the reference's on the same numpy state, then the contracts of
tests/test_core_parle.py, tests/test_mixed_precision.py::
test_bf16_state_dtype_layout and tests/test_round_fused.py (round equals
step loop bit for bit) inside the port.  Tolerance against the
reference: rtol 1e-5, atol 1e-6 (its own kernel-vs-jnp bound)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import parle as ref_parle
from repro_torch.configs.base import ModelConfig, ParleConfig
from repro_torch.core import parle, registry
from repro_torch.core.scoping import init_scopes, scopes_at, update_scopes
from repro_torch.models.convert import state_from_numpy, state_to_numpy
from repro_torch.models.model import build_model
from repro_torch.utils.pytree import FlatLayout
from torch_parity import assert_close

TOL = dict(rtol=1e-5, atol=1e-6)


def quad_loss(params, batch):
    """||p - 3||^2 / 2 — the reference tests' strongly convex objective."""
    del batch
    return 0.5 * ((params["w"] - 3.0) ** 2).sum(), ()


def _rand_tree(rng, lead=()):
    return {"w": rng.standard_normal(lead + (3, 5)).astype(np.float32),
            "b": {"u": rng.standard_normal(lead + (7,)).astype(np.float32)}}


def _ref_state(seed, n, cfg):
    """A reference ParleState with every field random and distinct."""
    rng = np.random.default_rng(seed)
    st = ref_parle.init_from_replicas(
        jax.tree.map(jnp.asarray, _rand_tree(rng, (n,))), cfg)
    rand = lambda: jax.tree.map(jnp.asarray, _rand_tree(rng, (n,)))
    return st._replace(y=jax.tree.map(lambda a: a.astype(st.y["w"].dtype),
                                      rand()),
                       z=rand(), v_y=rand(), v_x=rand())


def _assert_state_close(port, ref, what):
    got = state_to_numpy(port)
    for f in ("x", "y", "z", "v_y", "v_x"):
        for path, r in jax.tree_util.tree_leaves_with_path(getattr(ref, f)):
            p = got[f]
            for k in path:
                p = p[k.key]
            if r.dtype == jnp.bfloat16:
                p = p.view(jnp.bfloat16)
            assert_close(np.asarray(p, np.float32), np.asarray(r, np.float32),
                         TOL, f"{what} {f}{jax.tree_util.keystr(path)}")
    assert int(got["step"]) == int(ref.step)
    assert np.float32(got["scopes"]["gamma"]) == np.float32(ref.scopes.gamma)
    assert np.float32(got["scopes"]["rho"]) == np.float32(ref.scopes.rho)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_inner_and_sync_steps_match_reference(use_kernel, precision):
    kw = dict(n_replicas=2, L=2, lr=0.1, lr_inner=0.05, gamma0=10.0,
              batches_per_epoch=5, precision=precision)
    rcfg, pcfg = RefParleConfig(**kw), ParleConfig(**kw)
    ref = _ref_state(0, 2, rcfg)
    port = state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    _assert_state_close(port, ref, "converted")

    rng = np.random.default_rng(1)
    grads = _rand_tree(rng, (2,))
    rgrads = jax.tree.map(lambda a: jnp.asarray(a).astype(ref.y["w"].dtype),
                          grads)
    ref = ref_parle.inner_step(ref, rgrads, rcfg, use_kernel=use_kernel)
    pgrads = port.layout.flatten(
        jax.tree.map(lambda a: torch.from_numpy(a), grads), lead=(2,),
        dtype=port.y.dtype)
    port = parle.inner_step(port, pgrads, pcfg, use_kernel=use_kernel)
    _assert_state_close(port, ref, "inner_step")

    ref = ref_parle.sync_step(ref, rcfg, use_kernel=use_kernel)
    port = parle.sync_step(port, pcfg, use_kernel=use_kernel)
    _assert_state_close(port, ref, "sync_step")


def test_sync_resets_inner_loop_and_decays_scopes():
    cfg = ParleConfig(n_replicas=3, batches_per_epoch=10)
    st = parle.init({"w": torch.ones(4)}, cfg)
    st.y.add_(1.0)
    st.z.mul_(0.5)
    new = parle.sync_step(st, cfg)
    assert torch.equal(new.y, new.x) and torch.equal(new.z, new.x)
    assert float(new.v_y.abs().sum()) == 0.0
    assert float(new.scopes.gamma) == pytest.approx(100.0 * (1 - 1 / 20))
    assert float(new.scopes.rho) == pytest.approx(1.0 * (1 - 1 / 20))


def test_fused_step_syncs_exactly_every_L():
    cfg = ParleConfig(n_replicas=2, L=4, batches_per_epoch=10)
    st = parle.init({"w": torch.zeros(2)}, cfg)
    step = parle.make_train_step(quad_loss, cfg)
    gammas, xs = [], []
    for _ in range(9):
        prev_x = st.x.clone()
        st, m = step(st, {"x": torch.zeros(2, 1)})
        gammas.append(float(m["gamma"]))
        xs.append(not torch.equal(st.x, prev_x))
    f = cfg.scoping_factor()
    np.testing.assert_allclose(
        gammas, [100.0] * 3 + [100.0 * f] * 4 + [100.0 * f * f] * 2,
        rtol=1e-6)
    assert xs == [(i + 1) % 4 == 0 for i in range(9)]   # x moves only at syncs
    assert int(st.step) == 9


def test_entropy_sgd_is_parle_n1():
    """Entropy-SGD == Parle(n=1) exactly (§2.1), through the registry."""
    params = {"w": torch.tensor([1.0, -2.0, 0.5])}
    cfg = ParleConfig(n_replicas=1, L=3, lr=0.1, lr_inner=0.1)
    ent, par = registry.get("entropy_sgd"), registry.get("parle")
    es = ent.init(params, ParleConfig(n_replicas=4, L=3))
    assert es.x.shape[0] == 1                 # canonicalized to n = 1
    ps = par.init(params, cfg)
    e_step = ent.make_step(quad_loss, cfg)
    p_step = par.make_step(quad_loss, cfg)
    batch = {"x": torch.zeros(1, 1)}
    for _ in range(7):
        es, _ = e_step(es, batch)
        ps, _ = p_step(ps, batch)
    assert torch.equal(es.x, ps.x)


def test_scoping_matches_reference_bits():
    from repro.core.scoping import init_scopes as r_init
    from repro.core.scoping import update_scopes as r_update
    kw = dict(batches_per_epoch=8, gamma0=100.0, rho0=1.0)
    cfg, rcfg = ParleConfig(**kw), RefParleConfig(**kw)
    s, r = init_scopes(cfg), r_init(rcfg)
    for k in range(1, 120):
        s, r = update_scopes(s, cfg), r_update(r, rcfg)
        assert np.float32(s.gamma) == np.float32(r.gamma), k
        assert np.float32(s.rho) == np.float32(r.rho), k
        closed = scopes_at(cfg, k)
        assert float(s.gamma) == pytest.approx(float(closed.gamma), rel=1e-5)
    assert float(scopes_at(cfg, 10_000).rho) == pytest.approx(cfg.rho_min)


def test_average_model_and_reset_invariant_after_sync():
    cfg = ParleConfig(n_replicas=4, L=1, batches_per_epoch=10)
    reps = {"w": torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 6)).astype(np.float32))}
    st = parle.init_from_replicas(reps, cfg)
    st.z.mul_(0.2)
    new = parle.sync_step(st, cfg)
    avg = parle.average_model(new)
    reps = np.stack([parle.replica_model(new, a)["w"].numpy()
                     for a in range(4)])
    np.testing.assert_allclose(avg["w"].numpy(), reps.mean(0),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(new.y, new.x) and torch.equal(new.z, new.x)


def test_init_buffers_are_distinct_and_dealias_copies_only_aliases():
    cfg = ParleConfig(n_replicas=2)
    st = parle.init({"w": torch.ones(3)}, cfg)
    ptrs = {getattr(st, f).data_ptr() for f in ("x", "y", "z", "v_y", "v_x")}
    assert len(ptrs) == 5
    assert parle.dealias_state(st).x is st.x          # nothing copied
    aliased = st._replace(y=st.x, z=st.x)
    fixed = parle.dealias_state(aliased)
    assert fixed.x is st.x and fixed.y is not st.x and fixed.z is not st.x
    assert torch.equal(fixed.y, st.x) and fixed.y.data_ptr() != fixed.z.data_ptr()


def test_bf16_state_dtype_layout():
    """y is bf16, the masters f32, through steps and a sync boundary."""
    cfg = ParleConfig(n_replicas=2, L=3, precision="bf16")
    st = parle.init({"w": torch.randn(74, generator=torch.Generator()
                                      .manual_seed(0))}, cfg)
    assert st.y.dtype == torch.bfloat16
    for f in ("x", "z", "v_y", "v_x"):
        assert getattr(st, f).dtype == torch.float32
    step = registry.get("parle").make_step(quad_loss, cfg)
    for _ in range(cfg.L):
        st, metrics = step(st, {"x": torch.zeros(2, 1)})
    assert st.y.dtype == torch.bfloat16 and st.x.dtype == torch.float32
    assert torch.equal(st.y, st.x.to(torch.bfloat16))   # fused y' = bf16(x')
    assert np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------------------
# round == step loop, bit for bit (tests/test_round_fused.py contract)
# ------------------------------------------------------------------

CFG = ModelConfig(**dataclasses.asdict(FAMILY_CONFIGS["dense"]))


def _batches(steps, n, B=2, T=16, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, CFG.vocab_size, size=(steps, n, B, T + 1))
    return {"tokens": torch.from_numpy(toks[..., :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[..., 1:].astype(np.int32))}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_round_bit_identical_to_step_loop(use_kernel):
    model = build_model(CFG)
    pcfg = ParleConfig(n_replicas=2, L=3, lr=0.05, lr_inner=0.05,
                       batches_per_epoch=2, lr_drop_steps=(4,))
    algo = registry.get("parle")
    params = model.init(torch.Generator().manual_seed(0))
    batches = _batches(6, 2)

    s1 = algo.init(params, pcfg)
    step = algo.make_step(model.loss, pcfg, use_kernel=use_kernel)
    step_losses = []
    for i in range(6):
        s1, m = step(s1, {k: v[i] for k, v in batches.items()})
        step_losses.append(m["loss"])

    s2 = algo.init(params, pcfg)
    rnd = algo.make_round_fn(model.loss, pcfg, use_kernel=use_kernel)
    round_losses = []
    for r in range(2):
        s2, m = rnd(s2, {k: v[3 * r:3 * r + 3] for k, v in batches.items()})
        round_losses.append(m["losses"])
    assert torch.equal(torch.stack(step_losses), torch.cat(round_losses))
    for f in ("x", "y", "z", "v_y", "v_x"):
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    assert int(s1.step) == int(s2.step) == 6
    assert float(s1.scopes.gamma) == float(s2.scopes.gamma)
    with pytest.raises(ValueError, match="multiple of L"):
        rnd(parle.inner_step(s2, torch.zeros_like(s2.y), pcfg),
            {k: v[:3] for k, v in batches.items()})


def test_kernel_path_equals_plain_path_on_cpu():
    """On the CPU, --use-kernel runs the kernels' plain versions: the same
    arithmetic as the default path, so the same bits."""
    model = build_model(CFG)
    pcfg = ParleConfig(n_replicas=2, L=2, batches_per_epoch=2)
    params = model.init(torch.Generator().manual_seed(1))
    out = []
    for use_kernel in (False, True):
        st = parle.init(params, pcfg)
        rnd = parle.make_round_fn(model.loss, pcfg, use_kernel=use_kernel)
        b = _batches(4, 2, seed=4)
        for r in range(2):
            st, m = rnd(st, {k: v[2 * r:2 * r + 2] for k, v in b.items()})
        out.append((st.x.clone(), m["losses"]))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_flat_layout_matches_model_tree():
    model = build_model(CFG)
    params = model.init(torch.Generator().manual_seed(0))
    st = parle.init(params, ParleConfig(n_replicas=2))
    assert isinstance(st.layout, FlatLayout)
    assert st.x.shape == (2, st.layout.numel)
    tree = st.layout.tree(st.x[1])
    assert torch.equal(tree["blocks"]["attn"]["wq"],
                       params["blocks"]["attn"]["wq"])
