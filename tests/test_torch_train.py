"""The port's training path against the JAX reference: the smoke
Qwen2.5-3B loss and grads, the per-step losses of two fused Parle rounds
fed the reference's own batches (with and without the kernels on both
sides), Parle, Elastic-SGD and SGD checkpoints that cross-load in both
directions (and an Elastic-SGD resume that continues exactly), and the
train CLI (its JSON records for parle, elastic_sgd and sgd, its
refusals, and the device rule).

Tolerances: loss and grads of one forward/backward at MODEL_TOL (rtol =
atol = 1e-4: XLA and PyTorch sum in different orders); the six per-step
losses and the final x of a two-round trajectory at rtol = atol = 1e-4
(the same differences, carried through six updates at lr 0.1)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import parle as ref_parle
from repro.core import registry as ref_registry
from repro.data.synthetic import TokenStream as RefTokenStream
from repro.data.synthetic import make_round_batch_fn as ref_round_batches
from repro.models.model import build_model as ref_build_model
from repro.obs.events import KINDS as REF_KINDS
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCHS, ParleConfig, smoke_variant
from repro_torch.core import registry
from repro_torch.launch import train
from repro_torch.models.convert import (params_from_numpy, state_from_numpy,
                                        state_to_numpy)
from repro_torch.models.model import build_model
from torch_parity import (MODEL_TOL, assert_close, leaf_pairs, numpy_params,
                          port_rounds, ref_rounds)

ROOT = Path(__file__).resolve().parents[1]
RCFG = ref_smoke_variant(REF_ARCHS["qwen2.5-3b"])
CFG = smoke_variant(ARCHS["qwen2.5-3b"])
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
N, L, B, T = 2, 3, 2, 32


@pytest.fixture(scope="module")
def np_params():
    return numpy_params(RCFG, seed=0)


def _ref_batches():
    """The reference's own two rounds of (L, n, B, T) batches, as numpy."""
    stage = ref_round_batches(RefTokenStream(RCFG.vocab_size, T, B, seed=0),
                              L, B, N)
    return [jax.tree.map(np.asarray, stage(r * L)) for r in range(2)]


def test_loss_and_grads_match_reference(np_params):
    rng = np.random.default_rng(2)
    toks = rng.integers(0, CFG.vocab_size, size=(B, T + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rp = jax.tree.map(jnp.asarray, np_params)
    (r_loss, _), r_grads = jax.jit(jax.value_and_grad(
        ref_build_model(RCFG).loss, has_aux=True))(
        rp, jax.tree.map(jnp.asarray, batch))
    pp = params_from_numpy(np_params, "cpu")
    leaves = jax.tree_util.tree_leaves_with_path(np_params)
    p_loss, _ = build_model(CFG).loss(
        jax.tree.map(lambda t: t.requires_grad_(True), pp),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    p_loss.backward()
    assert_close(p_loss, r_loss, MODEL_TOL, "smoke loss")
    for path, _ in leaves:
        g, r = pp, r_grads
        for k in path:
            g, r = g[k.key], r[k.key]
        assert_close(g.grad, r, MODEL_TOL,
                     f"grad{jax.tree_util.keystr(path)}")


def test_cross_entropy_matches_reference():
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        assert_close(layers.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m)),
            ref_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if m is None else jnp.asarray(m)),
            MODEL_TOL, f"cross_entropy mask={m is not None}")
    h = rng.standard_normal((2, 8, 6)).astype(np.float32)
    w = rng.standard_normal((6, 40)).astype(np.float32)
    lab = rng.integers(0, 40, size=(2, 8)).astype(np.int32)
    for chunk in (4, 3):              # 3 does not divide T: one chunk
        assert_close(layers.chunked_cross_entropy(
            torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lab),
            chunk=chunk),
            ref_layers.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                             jnp.asarray(lab), chunk=chunk),
            MODEL_TOL, f"chunked_cross_entropy chunk={chunk}")


def test_layer_views_come_from_one_unbind():
    """Each layer's params are views from ONE unbind(0) of each stacked
    leaf (backward: one stack), not a per-layer select (backward: a
    zero-filled copy of the whole stacked leaf per layer)."""
    from repro_torch.models import transformer as tfm
    blocks = {"ln1": torch.ones(3, 4, requires_grad=True),
              "mlp": {"w": torch.ones(3, 4, 5, requires_grad=True)}}
    per_layer = tfm.layer_params(blocks, 3)
    assert len(per_layer) == 3
    for l, bp in enumerate(per_layer):
        assert bp["ln1"].grad_fn.name() == "UnbindBackward0"
        assert bp["mlp"]["w"].grad_fn.name() == "UnbindBackward0"
        assert bp["mlp"]["w"].data_ptr() == blocks["mlp"]["w"][l].data_ptr()
    sum(bp["mlp"]["w"].sum() * (l + 1)
        for l, bp in enumerate(per_layer)).backward()
    assert torch.equal(blocks["mlp"]["w"].grad[:, 0, 0],
                       torch.tensor([1.0, 2.0, 3.0]))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_two_rounds_match_reference(np_params, use_kernel):
    batches = _ref_batches()
    kw = dict(n_replicas=N, L=L, batches_per_epoch=1)
    ref_state, ref_losses = ref_rounds(RCFG, np_params, batches, use_kernel,
                                       **kw)
    st, losses = port_rounds(CFG, np_params, batches, use_kernel, **kw)
    assert_close(losses, ref_losses, TRAJ_TOL,
                 f"per-step losses use_kernel={use_kernel}")
    for path, p, r in leaf_pairs(state_to_numpy(st)["x"], ref_state.x):
        assert_close(p, r, TRAJ_TOL, f"final x{path}")
    assert float(st.scopes.gamma) == float(ref_state.scopes.gamma)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_checkpoints_cross_load_both_ways(np_params, tmp_path, precision):
    pcfg_kw = dict(n_replicas=N, L=L, precision=precision)
    rcfg = RefParleConfig(**pcfg_kw)
    rng = np.random.default_rng(9)
    # a reference state with every field distinct (x != y != z ...)
    ref = ref_registry.get("parle").init(jax.tree.map(jnp.asarray, np_params),
                                         rcfg)
    bump = lambda t, s: jax.tree.map(
        lambda a: (a.astype(jnp.float32) + s * jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32))).astype(a.dtype),
        t)
    ref = ref._replace(y=bump(ref.y, 0.1), z=bump(ref.z, 0.2),
                       v_y=bump(ref.v_y, 0.3), v_x=bump(ref.v_x, 0.4),
                       step=jnp.asarray(6, jnp.int32),
                       scopes=ref.scopes._replace(
                           gamma=jnp.asarray(12.5, jnp.float32)))

    # reference writes, port restores
    ref_path = str(tmp_path / "ref" / "step000006.npz")
    ref_ckpt.save(ref_path, ref, step=6, algo="parle")
    pcfg = ParleConfig(**pcfg_kw)
    algo = registry.get("parle")
    fresh = lambda: algo.init(params_from_numpy(np_params, "cpu"), pcfg)
    port = ckpt.restore(ref_path, fresh(), algo="parle")
    want = state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for f in ("x", "y", "z", "v_y", "v_x"):
        assert torch.equal(getattr(port, f), getattr(want, f)), f
    assert int(port.step) == 6 and float(port.scopes.gamma) == 12.5
    assert ckpt.latest_step(ref_path) == 6

    # port writes, reference restores
    port_path = str(tmp_path / "port" / "step000006.npz")
    ckpt.save(port_path, port, step=6, algo="parle")
    with open(port_path + ".json") as f:
        assert json.load(f)["keys"] == sorted(np.load(ref_path).files)
    like = ref_parle.dealias_state(ref_registry.get("parle").init(
        jax.tree.map(jnp.asarray, np_params), rcfg))
    back = ref_ckpt.restore(port_path, like, algo="parle")
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # the algo stamp is checked both ways
    with pytest.raises(ValueError, match="written by algo 'parle'"):
        ckpt.restore(ref_path, fresh(), algo="entropy_sgd")
    with pytest.raises(ValueError, match="written by algo 'parle'"):
        ref_ckpt.restore(port_path, like, algo="entropy_sgd")
    # a precision mismatch names the key
    other = ParleConfig(**dict(pcfg_kw, precision="bf16" if precision == "f32"
                               else "f32"))
    with pytest.raises(ValueError, match="'y/"):
        ckpt.restore(port_path,
                     algo.init(params_from_numpy(np_params, "cpu"), other))


def test_compressed_overlap_checkpoints_cross_load_both_ways(np_params,
                                                            tmp_path):
    """An int8 + overlap state (residual ``e``, carried consensus ``c``)
    written by either package restores into the other, bit for bit, and
    the sidecar keys are the same."""
    kw = dict(n_replicas=N, L=L, sync_compress="int8", sync_overlap=True)
    rcfg, pcfg = RefParleConfig(**kw), ParleConfig(**kw)
    rng = np.random.default_rng(10)
    ref = ref_registry.get("parle").init(jax.tree.map(jnp.asarray, np_params),
                                         rcfg)
    noise = lambda t, s: jax.tree.map(lambda a: a + s * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), t)
    ref = ref._replace(y=noise(ref.y, 0.1), e=noise(ref.e, 0.01),
                       c=noise(ref.c, 1.0), step=jnp.asarray(6, jnp.int32))
    ref_path = str(tmp_path / "ref" / "step000006.npz")
    ref_ckpt.save(ref_path, ref, step=6, algo="parle")
    algo = registry.get("parle")
    port = ckpt.restore(ref_path, algo.init(params_from_numpy(np_params,
                                                              "cpu"), pcfg),
                        algo="parle")
    want = state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for f in ("x", "y", "z", "v_y", "v_x", "e", "c"):
        assert torch.equal(getattr(port, f), getattr(want, f)), f
    assert port.c.shape == (port.layout.numel,)

    port_path = str(tmp_path / "port" / "step000006.npz")
    ckpt.save(port_path, port, step=6, algo="parle")
    with open(port_path + ".json") as f:
        keys = json.load(f)["keys"]
    assert keys == sorted(np.load(ref_path).files)
    assert any(k.startswith("e/") for k in keys)
    assert any(k.startswith("c/") for k in keys)
    like = ref_parle.dealias_state(ref_registry.get("parle").init(
        jax.tree.map(jnp.asarray, np_params), rcfg))
    back = ref_ckpt.restore(port_path, like, algo="parle")
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a checkpoint without e and c does not restore into such a state
    plain = str(tmp_path / "none.npz")
    ckpt.save(plain, algo.init(params_from_numpy(np_params, "cpu"),
                               ParleConfig(n_replicas=N, L=L)), step=0)
    with pytest.raises(KeyError, match="missing key [ce]/"):
        ckpt.restore(plain, algo.init(params_from_numpy(np_params, "cpu"),
                                      pcfg))


def test_train_cli_int8_overlap_on_cpu(tmp_path):
    """The int8 + overlap smoke run: the reference's progress and final
    records on stdout, one ``staleness_flush`` event and the flush
    counter in the metrics file, and checkpoints that carry e and c."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ck, metrics = tmp_path / "ck", tmp_path / "m.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--device", "cpu", "--smoke", "--replicas", "2",
         "--L", "3", "--steps", "6", "--batch", "2", "--seq", "32",
         "--use-kernel", "--round-fused", "--sync-compress", "int8",
         "--sync-overlap", "--log-every", "3", "--checkpoint-dir", str(ck),
         "--checkpoint-every", "3", "--metrics-out", str(metrics)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    assert [r["step"] for r in recs if r["kind"] == "train_progress"] == [3, 6]
    final = [r for r in recs if r["kind"] == "train_final"]
    assert len(final) == 1 and np.isfinite(final[0]["final_eval_loss"])
    from repro.obs.events import read_events as ref_read_events
    events = ref_read_events(str(metrics))      # the reference's schema
    flushes = [e for e in events if e["kind"] == "staleness_flush"]
    assert len(flushes) == 1 and flushes[0]["step"] == 6
    snap = [e for e in events if e["kind"] == "metrics_snapshot"]
    assert "train.staleness_flushes" in json.dumps(snap[0]["snapshot"])
    keys = np.load(ck / "step000006.npz").files
    assert "c/embed" in keys and "e/embed" in keys


def test_train_cli_on_cpu_prints_the_reference_records(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ck = tmp_path / "ck"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2.5-3b", "--device", "cpu", "--smoke", "--replicas", "2",
         "--L", "3", "--steps", "6", "--batch", "2", "--seq", "32",
         "--use-kernel", "--round-fused", "--log-every", "3",
         "--checkpoint-dir", str(ck), "--checkpoint-every", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    prog = [r for r in recs if r["kind"] == "train_progress"]
    final = [r for r in recs if r["kind"] == "train_final"]
    assert [r["step"] for r in prog] == [3, 6]
    assert [r["round"] for r in prog] == [1, 2]
    envelope = {"v", "kind", "ts"}
    for r in prog:
        assert set(r) == envelope | set(REF_KINDS["train_progress"])
        assert set(r["diag"]) == {"gamma", "rho", "overlap", "spread"}
        assert np.isfinite(r["loss"])
    assert len(final) == 1
    assert set(final[0]) == envelope | set(REF_KINDS["train_final"])
    assert final[0]["algo"] == "parle"
    assert final[0]["arch"] == "qwen2.5-3b-smoke"
    assert sorted(os.listdir(ck)) == ["step000003.npz", "step000003.npz.json",
                                      "step000006.npz", "step000006.npz.json"]
    assert ref_ckpt.saved_meta(str(ck / "step000006.npz"))["algo"] == "parle"


def test_train_wants_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])


@pytest.mark.parametrize("argv,exc,match", [
    # without a torch.distributed world, a replica axis of 2 says how to
    # start one (the axes inside a replica are still item 6)
    (["--mesh", "replica:2"], SystemExit, "torch.distributed.run"),
    # the reference's guards on the overlapped sync, with its messages
    (["--sync-overlap"], SystemExit, "requires --round-fused"),
    (["--sync-overlap", "--round-fused", "--algo", "elastic_sgd"],
     SystemExit, "no round-level sync"),
    # the async policy is the pod launcher's, as in the reference
    (["--sync-policy", "async"], SystemExit, "multi-process pod mode"),
])
def test_train_cli_names_what_is_not_ported(argv, exc, match):
    with pytest.raises(exc, match=match):
        train.main(["--smoke", "--device", "cpu", "--steps", "1"] + argv)


def test_train_cli_mesh_pod1_is_the_single_process_run(capsys):
    """``--mesh pod:1`` (the trivial group, no world needed) prints the
    same records as the run without ``--mesh``, bit for bit, after its
    mesh line; an axis inside a replica names its ROADMAP item."""
    argv = ["--round-fused", "--use-kernel", "--sync-compress", "int8"]
    plain = _cli_records(capsys, argv)
    meshed = _cli_records(capsys, argv + ["--mesh", "pod:1"])
    assert meshed[0]["kind"] == "mesh" and meshed[0]["mesh"] == {"pod": 1}
    strip = lambda recs: [{k: v for k, v in r.items()
                           if k not in ("ts", "wall_s", "total_wall_s")}
                          for r in recs if r["kind"] != "mesh"]
    assert strip(meshed) == strip(plain)
    with pytest.raises(SystemExit, match="item 6"):
        train.main(["--smoke", "--device", "cpu", "--steps", "1", "--mesh",
                    "pod:1,data:2"])


def _cli_records(capsys, argv):
    train.main(["--arch", "qwen2.5-3b", "--device", "cpu", "--smoke",
                "--replicas", "2", "--L", "3", "--steps", "6", "--batch",
                "2", "--seq", "32", "--log-every", "3"] + argv)
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


@pytest.mark.parametrize("algo,extra,diag", [
    ("elastic_sgd", ["--use-kernel", "--round-fused"],
     {"rho", "overlap", "spread"}),
    ("sgd", [], set()),
])
def test_train_cli_runs_elastic_sgd_and_sgd(capsys, tmp_path, algo, extra,
                                            diag):
    """``--algo elastic_sgd --use-kernel --round-fused`` (K7's plain
    version here) and ``--algo sgd`` (per step) print the reference's
    records and write checkpoints stamped with their algo."""
    ck = tmp_path / "ck"
    recs = _cli_records(capsys, ["--algo", algo, "--checkpoint-dir",
                                 str(ck), "--checkpoint-every", "3"] + extra)
    prog = [r for r in recs if r["kind"] == "train_progress"]
    final = [r for r in recs if r["kind"] == "train_final"]
    envelope = {"v", "kind", "ts"}
    assert [r["step"] for r in prog] == ([3, 6] if extra else [1, 3, 6])
    for r in prog:
        assert set(r) == envelope | set(REF_KINDS["train_progress"])
        assert set(r["diag"]) == diag and np.isfinite(r["loss"])
    assert len(final) == 1
    assert set(final[0]) == envelope | set(REF_KINDS["train_final"])
    assert final[0]["algo"] == algo
    assert np.isfinite(final[0]["final_eval_loss"])
    assert ref_ckpt.saved_meta(str(ck / "step000006.npz"))["algo"] == algo
    keys = np.load(ck / "step000006.npz").files
    field = "ref" if algo == "elastic_sgd" else "params"
    assert f"{field}/embed" in keys and "v/embed" in keys


def _bumped(tree, rng, scale):
    return jax.tree.map(lambda a: a + scale * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), tree)


@pytest.mark.parametrize("algo_name", ["elastic_sgd", "sgd"])
def test_elastic_and_sgd_checkpoints_cross_load_both_ways(np_params, tmp_path,
                                                          algo_name):
    kw = dict(n_replicas=N, L=L)
    ralgo, algo = ref_registry.get(algo_name), registry.get(algo_name)
    rcfg = ralgo.canonicalize_cfg(RefParleConfig(**kw))
    pcfg = algo.canonicalize_cfg(ParleConfig(**kw))
    rng = np.random.default_rng(11)
    ref = ralgo.init(jax.tree.map(jnp.asarray, np_params), rcfg)
    if algo_name == "elastic_sgd":
        ref = ref._replace(x=_bumped(ref.x, rng, 0.1),
                           v=_bumped(ref.v, rng, 0.2),
                           scopes=ref.scopes._replace(
                               rho=jnp.asarray(0.75, jnp.float32)))
    else:
        ref = ref._replace(params=_bumped(ref.params, rng, 0.1),
                           v=_bumped(ref.v, rng, 0.2))
    ref = ref._replace(step=jnp.asarray(6, jnp.int32))
    fresh = lambda: algo.init(params_from_numpy(np_params, "cpu"), pcfg)

    ref_path = str(tmp_path / "ref" / "step000006.npz")
    ref_ckpt.save(ref_path, ref, step=6, algo=algo_name)
    port = ckpt.restore(ref_path, fresh(), algo=algo_name)
    want = state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    fields = ("x", "ref", "v") if algo_name == "elastic_sgd" \
        else ("params", "v")
    for f in fields:
        assert torch.equal(getattr(port, f), getattr(want, f)), f
    assert int(port.step) == 6

    port_path = str(tmp_path / "port" / "step000006.npz")
    ckpt.save(port_path, port, step=6, algo=algo_name)
    with open(port_path + ".json") as f:
        assert json.load(f)["keys"] == sorted(np.load(ref_path).files)
    like = ref_parle.dealias_state(ralgo.init(
        jax.tree.map(jnp.asarray, np_params), rcfg))
    back = ref_ckpt.restore(port_path, like, algo=algo_name)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match=f"written by algo '{algo_name}'"):
        ckpt.restore(ref_path, fresh(), algo="parle")
    with pytest.raises(ValueError, match=f"written by algo '{algo_name}'"):
        ref_ckpt.restore(port_path, like, algo="parle")


def test_resumed_elastic_round_continues_exactly(np_params, tmp_path):
    """Two Elastic-SGD rounds straight, and one round, a checkpoint, a
    restore into a fresh state and the second round: bit for bit."""
    algo = registry.get("elastic_sgd")
    pcfg = algo.canonicalize_cfg(ParleConfig(n_replicas=N, L=L,
                                             batches_per_epoch=1))
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
               for b in _ref_batches()]
    rnd = algo.make_round_fn(build_model(CFG).loss, pcfg, use_kernel=True)
    fresh = lambda: algo.init(params_from_numpy(np_params, "cpu"), pcfg)
    straight = fresh()
    for b in batches:
        straight, m_straight = rnd(straight, b)
    st, _ = rnd(fresh(), batches[0])
    path = str(tmp_path / "step000003.npz")
    ckpt.save(path, st, step=3, algo="elastic_sgd")
    resumed = ckpt.restore(path, fresh(), algo="elastic_sgd")
    resumed, m_resumed = rnd(resumed, batches[1])
    assert torch.equal(m_straight["losses"], m_resumed["losses"])
    for f in ("x", "ref", "v"):
        assert torch.equal(getattr(straight, f), getattr(resumed, f)), f
    assert int(resumed.step) == 6
    assert float(resumed.scopes.rho) == float(straight.scopes.rho)
