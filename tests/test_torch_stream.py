"""The port's token stream against the reference's, bit for bit, on the
CPU: the threefry draws (``data/threefry.py``: ``PRNGKey``, ``fold_in``,
``split``, ``randint``, ``bernoulli``) against ``jax.random``'s, then
``TokenStream.batch``, ``replica_batches`` (split and interleaved), a
staged round (``make_round_batch_fn``) and the serve CLI's prompts
against ``repro.data.synthetic`` and ``repro.launch.serve``.

The reference runs with ``jax_threefry_partitionable`` on (the default
of the JAX it is pinned against here); the port implements that mode
only, so the first test asserts the flag: a JAX that changes it fails
there, not as a mismatch further down.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.data import synthetic as ref_synthetic
from repro.launch import serve as ref_serve
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.data import synthetic, threefry
from repro_torch.launch import serve
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

SEEDS = (0, 1, 7 * 100003 + 5, 2 ** 31 - 1, -3)


def _same(port, ref):
    np.testing.assert_array_equal(port.cpu().numpy(), np.asarray(ref))


def _key_words(key):
    return np.asarray(key).astype(np.int64)


def test_reference_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    pkey = threefry.prng_key(seed)
    _same(pkey, _key_words(key))
    for data in (0, 1, 2 ** 32 - 1):
        _same(threefry.fold_in(pkey, data),
              _key_words(jax.random.fold_in(key, data)))
    _same(threefry.split(pkey, 5), _key_words(jax.random.split(key, 5)))


@pytest.mark.parametrize("vocab", [1, 7, 50280, 151936])
def test_randint_matches_jax(vocab):
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        for shape in ((5,), (3, 33), (2, 4, 17)):
            _same(threefry.randint(threefry.prng_key(seed), shape, 0, vocab),
                  jax.random.randint(key, shape, 0, vocab))
    # a span of 1 and an empty one give minval, as JAX's do
    key = jax.random.PRNGKey(3)
    for lo, hi in ((4, 5), (9, 2)):
        _same(threefry.randint(threefry.prng_key(3), (6,), lo, hi),
              jax.random.randint(key, (6,), lo, hi))


@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli_and_uniform_match_jax(p):
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        pkey = threefry.fold_in(threefry.prng_key(seed), 1)
        _same(threefry.bernoulli(pkey, p, (4, 65)),
              jax.random.bernoulli(key, p, (4, 65)))
        _same(threefry.uniform(pkey, (64,)),
              jax.random.uniform(key, (64,), jnp.float32))


def _streams(vocab, K=0, seq=33, batch=3, seed=2):
    return (synthetic.TokenStream(vocab, seq, batch, seed=seed,
                                  num_codebooks=K),
            ref_synthetic.TokenStream(vocab, seq, batch, seed=seed,
                                      num_codebooks=K))


def _same_batch(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == torch.int32
        _same(port[k], ref[k])


@pytest.mark.parametrize("step", [0, 1, 2 ** 20 + 3])
@pytest.mark.parametrize("vocab,K", [(50280, 0), (151936, 0), (2048, 4)])
def test_token_stream_batches_match_reference(vocab, K, step):
    port, ref = _streams(vocab, K)
    _same_batch(port.batch(step), ref.batch(step))


@pytest.mark.parametrize("split", [False, True])
def test_replica_batches_and_staged_round_match_reference(split):
    for vocab, K in ((151936, 0), (2048, 4)):
        port, ref = _streams(vocab, K, seq=17, batch=2, seed=5)
        _same_batch(synthetic.replica_batches(port, 4, 2, 4, split=split),
                    ref_synthetic.replica_batches(ref, 4, 2, 4, split=split))
        stage = synthetic.make_round_batch_fn(port, 3, 2, 4, split=split)
        ref_stage = ref_synthetic.make_round_batch_fn(ref, 3, 2, 4,
                                                      split=split)
        _same_batch(stage(6), ref_stage(6))
        # a rank's rows are those rows of the whole draw
        rows = synthetic.make_round_batch_fn(port, 3, 2, 4, split=split,
                                             rows=slice(2, 4))(6)
        for k, v in rows.items():
            assert torch.equal(v, stage(6)[k][:, 2:4])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-large"])
def test_serve_prompts_match_reference(arch):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests",
            "8", "--prompt-len", "20", "--mixed-lens", "--seed", "3"]
    args = serve.parse_args(argv)
    got = serve.make_requests(smoke_variant(ARCHS[arch]), args)
    want = ref_serve._make_requests(ref_smoke_variant(REF_ARCHS[arch]),
                                    args, jax.random.PRNGKey(4))
    assert [r["tokens"].shape for r in got] == [
        np.asarray(r["tokens"]).shape for r in want]
    assert len({r["tokens"].shape[-1] for r in got}) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], np.asarray(w["tokens"]))
