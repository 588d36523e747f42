"""Property-based tests (hypothesis) of the port's invariants, the
counterparts of ``tests/test_properties.py`` under the same strategies
and settings: Parle's replica symmetry, the scoping schedule, the
average model, chunked CE and attention against their plain forms, the
SSD scan's chunk-size invariance and the teacher task's data split.
Each property is also held against the reference's own function at one
fixed draw, with the tolerance stated there (one JAX program a
property, not one a hypothesis example)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.configs import ParleConfig  # noqa: E402
from repro_torch.core import parle  # noqa: E402
from repro_torch.core.scoping import scopes_at  # noqa: E402
from repro_torch.data.synthetic import TeacherTask  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.layers import (chunked_cross_entropy,  # noqa: E402
                                       cross_entropy)
from repro_torch.models.mamba2 import ssd_chunked  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401 (autouse)

SET = dict(max_examples=20, deadline=None)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------
# Parle invariants
# ------------------------------------------------------------------

def _quadratic(p, b):
    return 0.5 * ((p["w"] - b["t"]) ** 2).sum(), ()


def _port_identical_run(n, w):
    cfg = ParleConfig(n_replicas=n, L=3)
    st_ = parle.init({"w": torch.from_numpy(w)}, cfg)
    step = parle.make_train_step(_quadratic, cfg)
    batch = {"t": torch.ones((n, 1))}
    for _ in range(5):
        st_, _ = step(st_, batch)
    return np.stack([parle.replica_model(st_, a)["w"].numpy()
                     for a in range(n)])


@given(n=st.integers(2, 5), dim=st.integers(1, 16), seed=st.integers(0, 99))
@settings(**SET)
def test_identical_replicas_stay_identical(n, dim, seed):
    """With identical init AND identical per-replica batches, replicas
    can never diverge (the dynamics are replica-symmetric)."""
    w = _port_identical_run(n, _normal(seed, (dim,)))
    for a in range(1, n):
        np.testing.assert_allclose(w[a], w[0], rtol=1e-6, atol=1e-7)


def test_identical_replicas_equal_the_reference():
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core import parle as ref_parle
    n, w0 = 3, _normal(7, (9,))
    cfg = RefParleConfig(n_replicas=n, L=3)
    st_ = ref_parle.init({"w": jnp.asarray(w0)}, cfg)
    step = ref_parle.make_train_step(
        lambda p, b: (0.5 * jnp.sum((p["w"] - b["t"]) ** 2), ()), cfg)
    for _ in range(5):
        st_, _ = step(st_, {"t": jnp.ones((n, 1))})
    # f32 updates of a 9-element quadratic, 5 steps and one sync
    np.testing.assert_allclose(_port_identical_run(n, w0),
                               np.asarray(st_.x["w"]), rtol=1e-6, atol=1e-7)


@given(k=st.integers(0, 500), bpe=st.integers(1, 400))
@settings(**SET)
def test_scoping_monotone_and_clipped(k, bpe):
    cfg = ParleConfig(batches_per_epoch=bpe)
    s1 = scopes_at(cfg, k)
    s2 = scopes_at(cfg, k + 1)
    assert float(s2.gamma) <= float(s1.gamma)
    assert float(s2.rho) <= float(s1.rho)
    assert float(s2.gamma) >= cfg.gamma_min
    assert float(s2.rho) >= cfg.rho_min


def test_scoping_equals_the_reference():
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core.scoping import scopes_at as ref_scopes_at
    for k, bpe in ((0, 1), (123, 7), (499, 400), (60, 2)):
        got = scopes_at(ParleConfig(batches_per_epoch=bpe), k)
        want = ref_scopes_at(RefParleConfig(batches_per_epoch=bpe), k)
        # float32 scalars, bit for bit
        assert float(got.gamma) == float(want.gamma)
        assert float(got.rho) == float(want.rho)


@given(seed=st.integers(0, 99), n=st.integers(1, 4))
@settings(**SET)
def test_average_model_is_mean_of_replicas(seed, n):
    cfg = ParleConfig(n_replicas=n)
    reps = {"w": torch.from_numpy(_normal(seed, (n, 7)))}
    avg = parle.average_model(parle.init_from_replicas(reps, cfg))
    np.testing.assert_allclose(avg["w"].numpy(), reps["w"].numpy().mean(0),
                               rtol=1e-6)


def test_average_model_equals_the_reference():
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core import parle as ref_parle
    reps = _normal(11, (4, 7))
    got = parle.average_model(parle.init_from_replicas(
        {"w": torch.from_numpy(reps)}, ParleConfig(n_replicas=4)))
    want = ref_parle.average_model(ref_parle.init_from_replicas(
        {"w": jnp.asarray(reps)}, RefParleConfig(n_replicas=4)))
    # a mean of four float32 rows
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------
# Numerics invariants
# ------------------------------------------------------------------

def _ce_inputs(b, t, v, seed, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            rng.standard_normal((d, v)).astype(np.float32),
            rng.integers(0, v, (b, t)).astype(np.int32))


@given(b=st.integers(1, 3), t=st.sampled_from([8, 16, 32]),
       v=st.sampled_from([32, 100]), seed=st.integers(0, 50))
@settings(**SET)
def test_chunked_ce_equals_plain_ce(b, t, v, seed):
    h, head, labels = (torch.from_numpy(a) for a in _ce_inputs(b, t, v,
                                                                 seed))
    plain = cross_entropy(torch.einsum("btd,dv->btv", h, head), labels)
    chunked = chunked_cross_entropy(h, head, labels, chunk=8)
    np.testing.assert_allclose(float(chunked), float(plain), rtol=1e-5)


def test_chunked_ce_equals_the_reference():
    from repro.models.layers import chunked_cross_entropy as ref_chunked
    h, head, labels = _ce_inputs(2, 32, 100, 3)
    got = chunked_cross_entropy(*(torch.from_numpy(a)
                                  for a in (h, head, labels)), chunk=8)
    want = ref_chunked(jnp.asarray(h), jnp.asarray(head),
                       jnp.asarray(labels), chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _qkv(seed, B=1, T=64, H=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, hd)).astype(np.float32)
            for _ in range(3)]


@given(seed=st.integers(0, 50), window=st.sampled_from([0, 16, 64]))
@settings(**SET)
def test_chunked_attention_equals_masked_softmax(seed, window):
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed))
    T, hd = q.shape[1], q.shape[-1]                # chunk=16 for the test
    out_c = attn.chunked_attention(q, k, v, window=window, chunk=16)
    mask = attn.causal_mask(T, T, window=window)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    logits = torch.where(mask, logits, torch.tensor(-1e30))
    out_p = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    np.testing.assert_allclose(out_c.numpy(), out_p.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_chunked_attention_equals_the_reference():
    from repro.models import attention as ref_attn
    q, k, v = _qkv(5)
    for window in (0, 16):
        got = attn.chunked_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     window=window, chunk=16)
        want = ref_attn.chunked_attention(
            *(jnp.asarray(a) for a in (q, k, v)), window=window, chunk=16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _ssd_inputs(seed, B=1, T=64, nh=2, P=8, N=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, nh, P)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, T, nh))))     # softplus
    A = -np.exp(rng.standard_normal((nh,)) * 0.3)
    Bm = rng.standard_normal((B, T, N)) * 0.5
    Cm = rng.standard_normal((B, T, N)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


@given(seed=st.integers(0, 30), chunk=st.sampled_from([4, 8, 16, 64]))
@settings(**SET)
def test_ssd_chunk_size_invariance(seed, chunk):
    """SSD output must not depend on the chunking."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(seed)]
    y, h = ssd_chunked(*args, chunk)
    yr, hr = ssd_scan_plain(*args)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=2e-4, atol=2e-4)


def test_ssd_chunked_equals_the_reference():
    from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked
    inputs = _ssd_inputs(9)
    y, h = ssd_chunked(*(torch.from_numpy(a) for a in inputs), 16)
    yr, hr = ref_ssd_chunked(*(jnp.asarray(a) for a in inputs), 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=2e-4,
                               atol=2e-4)


def _shard_rows_inside(task, n):
    """Every drawn row of shard a lies inside shard a's slice of
    ``x_train``; returns the shards' batches."""
    per = task.num_train // n
    xs = np.asarray(task.x_train)
    out = []
    for a in range(n):
        b = task.train_batch(0, 256, shard=(a, n))
        assert tuple(b["x"].shape) == (256, 64)
        rows = np.asarray(b["x"])
        shard_rows = xs[a * per:(a + 1) * per]
        for r in rows[:8]:
            assert (np.abs(shard_rows - r).sum(axis=1) < 1e-6).any()
        out.append(b)
    return out


@given(seed=st.integers(0, 30))
@settings(**SET)
def test_data_split_partitions_index_space(seed):
    """Paper §5: shards are disjoint and cover the training set."""
    _shard_rows_inside(TeacherTask(num_train=512, num_test=64, seed=seed), 4)


def test_data_split_equals_the_reference():
    from repro.data.synthetic import TeacherTask as RefTeacherTask
    got = _shard_rows_inside(TeacherTask(num_train=512, num_test=64,
                                         seed=4), 4)
    ref = RefTeacherTask(num_train=512, num_test=64, seed=4)
    for a, b in enumerate(got):
        want = ref.train_batch(0, 256, shard=(a, 4))
        # the same numpy draws: bit for bit
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(want["x"]))
        np.testing.assert_array_equal(b["y"].numpy(), np.asarray(want["y"]))
