"""Serving a trained model: the port's serve CLI restores a Parle
checkpoint written by the JAX reference (``--algo``, ``--replicas``,
``--resume``) and serves ``algo.deployable(state)``, the replica
average; its engine then emits the same greedy tokens as the reference
engine serving the reference's restore of the same file.  Elastic-SGD
and SGD checkpoints serve their ``ref`` and ``params``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import registry as ref_registry
from repro.serving import Engine as RefEngine
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.launch import serve
from repro_torch.serving import Engine
from torch_parity import numpy_params

RCFG = ref_smoke_variant(REF_ARCHS["qwen2.5-3b"])
CFG = smoke_variant(ARCHS["qwen2.5-3b"])
ARGV = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
        "--replicas", "2"]


@pytest.fixture(scope="module")
def ref_checkpoint(tmp_path_factory):
    """A reference Parle state whose two replicas differ, saved by the
    reference's checkpoint writer."""
    rng = np.random.default_rng(4)
    algo = ref_registry.get("parle")
    st = algo.init(jax.tree.map(jnp.asarray, numpy_params(RCFG, seed=0)),
                   RefParleConfig(n_replicas=2))
    st = st._replace(x=jax.tree.map(
        lambda a: a + 0.05 * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), st.x))
    path = str(tmp_path_factory.mktemp("ref") / "step000003.npz")
    ref_ckpt.save(path, st, step=3, algo="parle")
    return path, algo.deployable(st)


def _tokens(engine_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, num_slots=2, max_len=32, decode_chunk=3,
                     **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    return eng.run()


def test_reference_checkpoint_serves_the_same_tokens(ref_checkpoint):
    path, ref_params = ref_checkpoint
    args = serve.parse_args(ARGV + ["--resume", path])
    params, pcfg = serve.served_params(CFG, args, torch.device("cpu"))
    assert pcfg.n_replicas == 2
    for (p_path, leaf), r in zip(
            sorted(_leaves(params).items()),
            [l for _, l in sorted(_leaves(ref_params).items())]):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7, err_msg=p_path)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, CFG.vocab_size, size=T).astype(np.int32)
               for T in (5, 9, 12)]
    want = _tokens(RefEngine, RCFG, ref_params, prompts)
    got = _tokens(Engine, CFG, params, prompts, device="cpu")
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def test_serve_cli_checks_the_algo_stamp(ref_checkpoint, capsys):
    path, _ = ref_checkpoint
    serve.main(ARGV + ["--resume", path, "--requests", "2", "--gen", "3",
                       "--prompt-len", "6"])
    assert '"restored": true' in capsys.readouterr().out
    with pytest.raises(ValueError, match="written by algo 'parle'"):
        serve.main(ARGV + ["--algo", "entropy_sgd", "--resume", path])


def test_fresh_state_serves_the_replica_average_of_the_init():
    args = serve.parse_args(ARGV)
    params, _ = serve.served_params(CFG, args, torch.device("cpu"))
    init = serve.init_params(CFG, args, torch.device("cpu"))
    for k, leaf in _leaves(init).items():     # (x + x) / 2 is x exactly
        assert torch.equal(_leaves(params)[k], leaf), k


@pytest.mark.parametrize("algo_name", ["elastic_sgd", "sgd"])
def test_elastic_and_sgd_checkpoints_serve_ref_and_params(tmp_path,
                                                          algo_name):
    """A reference Elastic-SGD checkpoint serves its ``ref`` (not a worker
    or their mean) and an SGD checkpoint its ``params``, leaf for leaf;
    the algo stamp is checked; a fresh state of either serves the init."""
    rng = np.random.default_rng(5)
    algo = ref_registry.get(algo_name)
    st = algo.init(jax.tree.map(jnp.asarray, numpy_params(RCFG, seed=0)),
                   algo.canonicalize_cfg(RefParleConfig(n_replicas=2)))
    noise = lambda t: jax.tree.map(lambda a: a + 0.05 * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), t)
    if algo_name == "elastic_sgd":
        st = st._replace(x=noise(st.x), ref=noise(st.ref))
    else:
        st = st._replace(params=noise(st.params))
    path = str(tmp_path / "step000003.npz")
    ref_ckpt.save(path, st, step=3, algo=algo_name)
    argv = ARGV + ["--algo", algo_name]
    params, _ = serve.served_params(CFG, serve.parse_args(
        argv + ["--resume", str(tmp_path)]), torch.device("cpu"))
    want = _leaves(algo.deployable(st))
    got = _leaves(params)
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    with pytest.raises(ValueError, match=f"written by algo '{algo_name}'"):
        serve.served_params(CFG, serve.parse_args(ARGV + ["--resume", path]),
                            torch.device("cpu"))
    args = serve.parse_args(argv)
    fresh, _ = serve.served_params(CFG, args, torch.device("cpu"))
    init = serve.init_params(CFG, args, torch.device("cpu"))
    for k, leaf in _leaves(init).items():
        assert torch.equal(_leaves(fresh)[k], leaf), k


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
