"""The port's SGD baseline and the Algorithm surface of the two algorithms
this slice adds, against the reference: the data-parallel SGD step on
the paper's MLP, the mean over data shards, the §4 step decay
(tests/test_algorithm_api.py: ``test_lr_drop_boundaries_take_effect``
for parle, elastic_sgd and sgd, ``test_explicit_lr_schedule_overrides_cfg``),
the registry's names, and ``deployable`` / ``diagnostics`` / the
checkpoint's algo stamp for elastic_sgd and sgd.

Tolerance against the reference: atol = rtol = 1e-6 (one MLP forward and
backward in f32, summed in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import registry as ref_registry
from repro.data.synthetic import TeacherTask as RefTeacherTask
from repro.data.synthetic import replica_batches as ref_replica_batches
from repro.models.convnet import classification_loss as ref_cls_loss
from repro.models.convnet import init_mlp as ref_init_mlp
from repro.models.convnet import mlp_forward as ref_mlp_forward
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ParleConfig
from repro_torch.core import registry
from repro_torch.data.synthetic import TeacherTask, replica_batches
from repro_torch.launch import serve, train
from repro_torch.models.convert import (params_from_numpy, state_from_numpy,
                                        state_to_numpy)
from repro_torch.models.convnet import classification_loss, mlp_forward
from torch_parity import assert_close, leaf_pairs

torch.set_float32_matmul_precision("highest")

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def tasks():
    return RefTeacherTask(num_train=512, num_test=128), TeacherTask(
        num_train=512, num_test=128)


@pytest.fixture(scope="module")
def mlp_params():
    return jax.tree.map(np.asarray, ref_init_mlp(jax.random.PRNGKey(0)))


def _ref_loss(p, b):
    return ref_cls_loss(ref_mlp_forward)(p, b)[0], ()


def _loss(p, b):
    return classification_loss(mlp_forward)(p, b)[0], ()


@pytest.mark.parametrize("n,weight_decay", [(1, 0.0), (3, 0.0), (2, 1e-3)])
def test_sgd_step_matches_reference_on_the_mlp(tasks, mlp_params, n,
                                               weight_decay):
    ref_task, task = tasks
    kw = dict(n_replicas=n, L=25, lr=0.1, lr_drop_steps=(2,))
    ralgo, algo = ref_registry.get("sgd"), registry.get("sgd")
    rcfg = ralgo.canonicalize_cfg(RefParleConfig(**kw))
    pcfg = algo.canonicalize_cfg(ParleConfig(**kw))
    rst = ralgo.init(jax.tree.map(jnp.asarray, mlp_params), rcfg)
    st = algo.init(params_from_numpy(mlp_params, "cpu"), pcfg)
    rstep = jax.jit(ralgo.make_step(_ref_loss, rcfg,
                                    weight_decay=weight_decay))
    step = algo.make_step(_loss, pcfg, weight_decay=weight_decay)
    for i in range(4):
        rst, rm = rstep(rst, ref_replica_batches(ref_task, i, 32, n))
        st, m = step(st, replica_batches(task, i, 32, n))
        assert_close(m["loss"], rm["loss"], TOL, f"loss step {i}")
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-7)
    got = state_to_numpy(st)
    for f in ("params", "v"):
        for path, p, r in leaf_pairs(got[f], getattr(rst, f)):
            assert_close(p, r, TOL, f"{f}{path}")
    assert int(got["step"]) == int(rst.step) == 4


def test_single_model_sgd_step_matches_reference(tasks, mlp_params):
    """``sgd.make_train_step`` (no shard axis) with a step-decay lr
    schedule and weight decay, three steps on the MLP."""
    from repro.optim import sgd as ref_sgd
    from repro_torch.optim import sgd
    ref_task, task = tasks
    rst = ref_sgd.init(jax.tree.map(jnp.asarray, mlp_params))
    st = sgd.init(params_from_numpy(mlp_params, "cpu"))
    rstep = jax.jit(ref_sgd.make_train_step(
        _ref_loss, ref_sgd.step_decay_schedule(0.1, (1,), 0.5),
        weight_decay=1e-3))
    step = sgd.make_train_step(_loss, sgd.step_decay_schedule(0.1, (1,), 0.5),
                               weight_decay=1e-3)
    for i in range(3):
        rst, rm = rstep(rst, ref_task.train_batch(i, 32))
        st, m = step(st, task.train_batch(i, 32))
        assert_close(m["loss"], rm["loss"], TOL, f"loss step {i}")
        assert float(m["lr"]) == float(rm["lr"])
    for path, p, r in leaf_pairs(state_to_numpy(st)["params"], rst.params):
        assert_close(p, r, TOL, f"params{path}")


def test_sgd_step_averages_the_shard_grads():
    """lr 1, momentum 0, a linear loss sum(w * x_shard): the step moves w
    by exactly the mean over the n shards of their x."""
    algo = registry.get("sgd")
    cfg = algo.canonicalize_cfg(ParleConfig(n_replicas=3, lr=1.0,
                                            momentum=0.0))
    st = algo.init({"w": torch.zeros(5)}, cfg)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 5)).astype(np.float32))
    st, m = algo.make_step(lambda p, b: ((p["w"] * b["x"]).sum(), ()),
                           cfg)(st, {"x": xs})
    np.testing.assert_allclose(algo.deployable(st)["w"].numpy(),
                               -xs.numpy().mean(0), rtol=1e-6, atol=1e-7)


def _lin_loss(params, batch):
    del batch
    return params["w"].sum(), ()            # grad == 1 everywhere


@pytest.mark.parametrize("name", ["parle", "elastic_sgd", "sgd"])
def test_lr_drop_boundaries_take_effect(name):
    """With momentum 0 and a constant unit gradient, the per-step
    parameter displacement IS the lr — so the drop boundary is visible
    exactly at lr_drop_steps."""
    algo = registry.get(name)
    cfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=1, L=1000, momentum=0.0, gamma0=1e9, rho0=1e9,
        lr=0.1, lr_inner=0.1, lr_drop_steps=(3,), lr_drop_factor=0.1))
    st = algo.init({"w": torch.zeros(4)}, cfg)
    step = algo.make_step(_lin_loss, cfg)

    def main_iterate(s):
        if name == "sgd":
            return algo.deployable(s)["w"].clone()
        return s.layout.tree(s.x if name == "elastic_sgd" else s.y)[
            "w"].clone()

    prev, deltas = main_iterate(st), []
    for _ in range(6):
        st, _ = step(st, {"x": torch.zeros(1, 1)})
        cur = main_iterate(st)
        deltas.append(float((cur - prev).abs().mean()))
        prev = cur
    np.testing.assert_allclose(deltas[:3], [0.1] * 3, rtol=1e-5)
    np.testing.assert_allclose(deltas[3:], [0.01] * 3, rtol=1e-5)


def test_explicit_lr_schedule_overrides_cfg():
    algo = registry.get("sgd")
    cfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=1, momentum=0.0, lr=1.0, lr_drop_steps=(1,)))
    step = algo.make_step(_lin_loss, cfg, lr_schedule=lambda k: 0.5)
    st = algo.init({"w": torch.zeros(2)}, cfg)
    st, m = step(st, {"x": torch.zeros(1, 1)})
    assert float(m["lr"]) == pytest.approx(0.5)


def test_registry_names_are_the_reference_four_and_the_cli_choices():
    assert registry.names() == ref_registry.names() == [
        "elastic_sgd", "entropy_sgd", "parle", "sgd"]
    algo = next(a for a in train.build_argparser()._actions
                if a.dest == "algo")
    assert list(algo.choices) == registry.names()
    for name in registry.names():
        assert registry.get(name).name == name
        assert serve.parse_args(["--arch", "qwen2.5-3b", "--algo",
                                 name]).algo == name
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "qwen2.5-3b", "--algo", "adam"])
    with pytest.raises(KeyError, match="unknown algorithm"):
        registry.get("adam")


@pytest.mark.parametrize("name", ["elastic_sgd", "sgd"])
def test_deployable_diagnostics_and_algo_stamp(name, mlp_params, tmp_path):
    """The same numpy state in both packages: the same deployable tree and
    diagnostics keys (values within TOL); a checkpoint stamped ``name``
    refuses to restore as another algorithm, in both packages."""
    kw = dict(n_replicas=2, rho0=0.7)
    ralgo, algo = ref_registry.get(name), registry.get(name)
    rcfg = ralgo.canonicalize_cfg(RefParleConfig(**kw))
    pcfg = algo.canonicalize_cfg(ParleConfig(**kw))
    rst = ralgo.init(jax.tree.map(jnp.asarray, mlp_params), rcfg)
    if name == "elastic_sgd":     # workers apart from the reference
        rng = np.random.default_rng(1)
        rst = rst._replace(x=jax.tree.map(lambda a: a + jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), rst.x))
    st = state_from_numpy(jax.tree.map(np.asarray, rst), "cpu")
    for path, p, r in leaf_pairs(
            {k: v.numpy() for k, v in algo.deployable(st).items()},
            ralgo.deployable(rst)):
        assert_close(p, r, TOL, f"deployable{path}")
    rdiag, diag = ralgo.diagnostics(rst), algo.diagnostics(st)
    assert set(diag) == set(rdiag)
    for k in diag:
        assert diag[k] == pytest.approx(rdiag[k], rel=1e-5, abs=1e-6), k
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, st, step=3, algo=name)
    other = "parle" if name == "sgd" else "sgd"
    with pytest.raises(ValueError, match=f"written by algo '{name}'"):
        ckpt.restore(path, algo.init(params_from_numpy(mlp_params, "cpu"),
                                     pcfg), algo=other)
    assert algo.make_round_flush_fn(pcfg) is None
