"""The paper's own models and task in the port, against the reference:
``TeacherTask`` (its data and batches bit for bit: both draw from
numpy's RandomState), the MLP and the reduced All-CNN on the same params
(including stride-2 convs at even and odd sizes, where XLA's SAME
padding is (0, 1), not conv2d's (1, 1)), the first 25 steps of the
quickstart's loop for sgd and parle, ``one_shot_average``, ``align_mlp``
and ``aligned_overlap``; and the quickstart's own claim (Parle
generalizes >= SGD) at its default 400 steps on the CPU.

Tolerances: logits atol = rtol = 1e-5 (one f32 forward, different
summation orders); 25 training steps atol = rtol = 1e-4 (the same
differences carried through 25 updates)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import ensemble as ref_ensemble
from repro.core import registry as ref_registry
from repro.data.synthetic import TeacherTask as RefTeacherTask
from repro.data.synthetic import replica_batches as ref_replica_batches
from repro.models import convnet as ref_convnet
from repro_torch.core import ensemble
from repro_torch.data.synthetic import TeacherTask, replica_batches
from repro_torch.examples import quickstart
from repro_torch.models import convnet
from repro_torch.models.convert import params_from_numpy
from torch_parity import assert_close, leaf_pairs

torch.set_float32_matmul_precision("highest")

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tasks():
    return RefTeacherTask(), TeacherTask()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_teacher_task_equals_the_reference_bit_for_bit(tasks):
    ref, port = tasks
    for name in ("x_train", "y_train", "x_test", "y_test"):
        r, p = np.asarray(getattr(ref, name)), getattr(port, name).numpy()
        assert p.dtype == r.dtype, name
        np.testing.assert_array_equal(p, r, err_msg=name)
    assert port.batches_per_epoch(128) == ref.batches_per_epoch(128) == 32
    for split in (False, True):
        for step in (0, 7):
            want = ref_replica_batches(ref, step, 16, 3, split=split)
            got = replica_batches(port, step, 16, 3, split=split)
            for k in ("x", "y"):
                assert got[k].shape == (3, 16) + tuple(want[k].shape[2:])
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


def test_mlp_logits_match_reference(tasks):
    params = _np(ref_convnet.init_mlp(jax.random.PRNGKey(1)))
    x = np.array(tasks[0].x_test[:64])
    want = ref_convnet.mlp_forward(jax.tree.map(jnp.asarray, params),
                                   jnp.asarray(x))
    got = convnet.mlp_forward(params_from_numpy(params, "cpu"),
                              torch.from_numpy(x))
    assert_close(got, want, LOGIT_TOL, "mlp logits")


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (6, 5)])
def test_allcnn_logits_match_reference(hw):
    params = _np(ref_convnet.init_allcnn(jax.random.PRNGKey(2),
                                         channels=(8, 16)))
    x = np.random.default_rng(3).standard_normal((2,) + hw + (3,)).astype(
        np.float32)
    want = ref_convnet.allcnn_forward(jax.tree.map(jnp.asarray, params),
                                      jnp.asarray(x))
    got = convnet.allcnn_forward(params_from_numpy(params, "cpu"),
                                 torch.from_numpy(x))
    assert got.shape == (2, 10)
    assert_close(got, want, LOGIT_TOL, f"allcnn logits {hw}")


@pytest.mark.parametrize("size", [8, 9])
def test_stride2_conv_pads_as_xla_same(size):
    """A stride-2 3x3 conv alone: SAME pads (0, 1) on an even size and
    (1, 1) on an odd one; conv2d(padding=1) agrees only on the odd one."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 2)).astype(np.float32)
    w = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
    b = np.zeros(4, np.float32)
    want = ref_convnet._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=2)
    got = convnet._conv(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), stride=2)
    assert_close(got, want, LOGIT_TOL, f"stride-2 conv {size}x{size}")
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
        padding=1).permute(0, 2, 3, 1)
    assert sym.shape == got.shape
    assert torch.allclose(sym, got, **LOGIT_TOL) == (size % 2 == 1)


def _ref_train(name, task, params, cfg, steps, bs=128):
    algo = ref_registry.get(name)
    cfg = algo.canonicalize_cfg(cfg)
    loss = lambda p, b: (ref_convnet.classification_loss(
        ref_convnet.mlp_forward)(p, b)[0], ())
    state = algo.init(jax.tree.map(jnp.asarray, params), cfg)
    step = jax.jit(algo.make_step(loss, cfg))
    for i in range(steps):
        state, _ = step(state, ref_replica_batches(task, i, bs,
                                                   cfg.n_replicas))
    return algo.deployable(state)


@pytest.mark.parametrize("name,n", [("sgd", 1), ("parle", 3)])
def test_quickstart_loop_matches_reference_for_25_steps(tasks, name, n):
    ref_task, task = tasks
    params = _np(ref_convnet.init_mlp(jax.random.PRNGKey(0)))
    kw = dict(n_replicas=n, L=25, lr=0.1, lr_inner=0.1,
              batches_per_epoch=task.batches_per_epoch(128))
    want = _ref_train(name, ref_task, params, RefParleConfig(**kw), 25)
    got, _, _ = quickstart.train(name, task, quickstart.loss_fn,
                                 params_from_numpy(params, "cpu"),
                                 quickstart.paper_cfg(n, task), 25)
    for path, p, r in leaf_pairs({k: v.numpy() for k, v in got.items()},
                                 want):
        assert_close(p, r, TRAJ_TOL, f"{name} deployable{path}")


def test_one_shot_average_and_alignment_match_reference():
    a = _np(ref_convnet.init_mlp(jax.random.PRNGKey(4), hidden=16))
    b = _np(ref_convnet.init_mlp(jax.random.PRNGKey(5), hidden=16))
    stacked = jax.tree.map(lambda u, v: np.stack([u, v]), a, b)
    want = ref_ensemble.one_shot_average(jax.tree.map(jnp.asarray, stacked))
    got = ensemble.one_shot_average(params_from_numpy(stacked, "cpu"))
    for path, p, r in leaf_pairs({k: v.numpy() for k, v in got.items()},
                                 want):
        assert_close(p, r, LOGIT_TOL, f"one-shot average{path}")

    pa, pb = params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu")
    want = ref_ensemble.align_mlp(a, b)
    got = ensemble.align_mlp(pa, pb)
    for path, p, r in leaf_pairs({k: v.numpy() for k, v in got.items()},
                                 want):
        np.testing.assert_array_equal(p, np.asarray(r), err_msg=path)
    assert ensemble.aligned_overlap(pa, pb) == pytest.approx(
        ref_ensemble.aligned_overlap(a, b), rel=1e-5)
    # a permuted copy aligns back onto the original: overlap 1
    perm = np.random.default_rng(6).permutation(16)
    shuffled = dict(b, w1=b["w1"][:, perm], b1=b["b1"][perm],
                    w2=b["w2"][perm])
    assert ensemble.aligned_overlap(
        pb, params_from_numpy(shuffled, "cpu")) == pytest.approx(1.0,
                                                                 abs=1e-6)


def test_quickstart_claim_holds_on_cpu(capsys):
    """The quickstart at its default 400 steps: Parle's test error within
    0.02 of SGD's or better (its own assert), and the table printed."""
    out = quickstart.main(["--device", "cpu"])
    assert out["parle_test"] <= out["sgd_test"] + 0.02
    text = capsys.readouterr().out
    assert "SGD" in text and "Parle n=3" in text and "replica overlap" in text
