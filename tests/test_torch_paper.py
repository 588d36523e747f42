"""The paper's experiments and the three remaining examples in the port
(``repro_torch/examples/``), against the reference's
(``benchmarks/common.py``, ``table1_baselines.py``,
``table2_split_data.py``, ``fig1_overlap.py``, ``examples/*.py``):

(a) the harness: ``train_algo`` for all four algorithms at 30 steps
    (both §3.1 lr drops, at 18 and 25, and one sync), ``train_sgd`` on a
    shard and Parle / Elastic-SGD on split data, from the reference's
    params: deployables and errors within TRAJ_TOL;
(b) Table 1, Table 2 and Fig. 1 at a few steps: the reference's row
    names in its order, and, given the same numbers, the reference's
    lines character for character (so the same ``holds=`` rules);
(c) ``tests/test_system.py::test_parle_replicas_stay_aligned`` and
    ``test_trainer_checkpoint_resume`` on the port, and (d) its three
    ``slow`` contracts of the paper's claims and the LM's loss, marked
    ``slow`` as there;
(e) ``train_llm_parle``'s loop at a narrow config against the reference
    loop (12 steps, one sync at L = 10), its checkpoint restoring to the
    same next step, and ``split_data`` / ``serve_batched`` through
    ``main``;
(f) without ``--device cpu`` every new entry point raises where there is
    no card.

TRAJ_TOL (atol = rtol = 1e-4): float32 summation orders of XLA's and
PyTorch's CPU matmuls carried through 30 (12) updates, as in
``tests/test_torch_convnet.py``."""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:       # the reference's benchmarks/ folder
    sys.path.insert(0, str(ROOT))

from benchmarks import common as ref_common  # noqa: E402
from benchmarks import fig1_overlap as ref_fig1  # noqa: E402
from benchmarks import table1_baselines as ref_table1  # noqa: E402
from benchmarks import table2_split_data as ref_table2  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.configs.base import ParleConfig as RefParleConfig  # noqa: E402
from repro.core import ensemble as ref_ensemble  # noqa: E402
from repro.core import parle as ref_parle  # noqa: E402
from repro.data.synthetic import TokenStream as RefTokenStream  # noqa: E402
from repro.data.synthetic import replica_batches as ref_replica_batches  # noqa: E402,E501
from repro.models import convnet as ref_convnet  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import (ParleConfig, get_config,  # noqa: E402
                                 smoke_variant)
from repro_torch.core import ensemble, parle  # noqa: E402
from repro_torch.data.synthetic import (TeacherTask, TokenStream,  # noqa: E402
                                        replica_batches)
from repro_torch.examples import (common, fig1_overlap, quickstart,  # noqa: E402,E501
                                  serve_batched, split_data,
                                  table1_baselines, table2_split_data,
                                  train_llm_parle)
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.convnet import error_rate, mlp_forward  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.utils.pytree import FlatLayout, tree_map  # noqa: E402
from torch_parity import (assert_close, leaf_pairs, numpy_params,  # noqa: E402,F401,E501
                          one_torch_thread, port_config)

torch.set_float32_matmul_precision("highest")

TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 30


@pytest.fixture(scope="module")
def tasks():
    return ref_common.make_task(0), common.make_task(0, "cpu")


def _mlp_numpy(seed):
    return jax.tree.map(np.asarray,
                        ref_convnet.init_mlp(jax.random.PRNGKey(seed)))


def _assert_params_close(got, want, what):
    for path, p, r in leaf_pairs({k: v.numpy() for k, v in got.items()},
                                 want):
        assert_close(p, r, TRAJ_TOL, f"{what}{path}")


# ------------------------------------------------------------------
# (a) the harness against benchmarks/common.py
# ------------------------------------------------------------------

@pytest.mark.parametrize("name,n,split", [
    ("sgd", 1, False), ("entropy_sgd", 1, False), ("elastic_sgd", 3, False),
    ("parle", 3, False), ("elastic_sgd", 3, True), ("parle", 3, True)])
def test_train_algo_matches_reference(tasks, name, n, split):
    ref_task, task = tasks
    ref_st, _ = ref_common.train_algo(name, ref_task, STEPS, n=n,
                                      split=split, seed=0)
    st, wall = common.train_algo(
        name, task, STEPS, n=n, split=split, seed=0,
        params=params_from_numpy(_mlp_numpy(0), "cpu"))
    assert wall > 0
    want = ref_common.deployable(name, ref_st)
    got = common.deployable(name, st)
    _assert_params_close(got, want, f"{name} split={split} deployable")
    np.testing.assert_allclose(common.errors(got, task),
                               ref_common.errors(want, ref_task), **TRAJ_TOL)


def test_train_sgd_on_a_shard_matches_reference(tasks):
    ref_task, task = tasks
    want, _ = ref_common.train_sgd(ref_task, STEPS, seed=1, shard=(0, 2))
    got, _ = common.train_sgd(task, STEPS, seed=1, shard=(0, 2),
                              params=params_from_numpy(_mlp_numpy(1), "cpu"))
    _assert_params_close(got, want, "sgd shard (0, 2)")
    np.testing.assert_allclose(common.errors(got, task),
                               ref_common.errors(want, ref_task), **TRAJ_TOL)


def test_bench_cfg_is_the_reference_annealing(tasks):
    ref_task, task = tasks
    want = ref_common.bench_cfg(ref_task, 3, STEPS)
    got = common.bench_cfg(task, 3, STEPS)
    for f in ("n_replicas", "L", "lr", "lr_inner", "batches_per_epoch",
              "lr_drop_steps", "lr_drop_factor", "alpha", "gamma0", "rho0"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.lr_drop_steps == (18, 25)


# ------------------------------------------------------------------
# (b) the row names and the claim rules
# ------------------------------------------------------------------

def _names(lines):
    return [line.split(",")[0] for line in lines]


def _recording(monkeypatch, module):
    """Patches ``module.run`` to keep what it returns in the dict it
    returns."""
    kept, orig = {}, module.run
    monkeypatch.setattr(module, "run",
                        lambda **kw: kept.setdefault("rows", orig(**kw)))
    return kept


def _ref_lines(monkeypatch, module, rows, *args):
    """The reference script's ``main`` printing ``rows`` (its ``run``
    patched to return them)."""
    with monkeypatch.context() as m:
        m.setattr(module, "run", lambda **kw: rows)
        return module.main(*args)


def test_table1_rows_and_claims_match_reference(monkeypatch):
    steps = 4
    kept = _recording(monkeypatch, table1_baselines)
    lines = table1_baselines.main(["--steps", str(steps), "--device", "cpu"])
    assert len(lines) == 7
    # the same numbers through the reference's main: the same lines
    assert _ref_lines(monkeypatch, ref_table1, kept["rows"], steps) == lines
    # a real reference run at the same steps (one seed): the same names
    monkeypatch.setattr(ref_table1, "run",
                        functools.partial(ref_table1.run, seeds=(0,)))
    assert _names(ref_table1.main(steps)) == _names(lines)


def test_table2_rows_and_claims_match_reference(monkeypatch):
    kept = _recording(monkeypatch, table2_split_data)
    lines = table2_split_data.main(["--steps", "4", "--device", "cpu"])
    assert len(lines) == 9
    # the reference divides each wall by its default 400 steps
    assert _ref_lines(monkeypatch, ref_table2, kept["rows"]) == \
        table2_split_data.report(kept["rows"], 400)
    monkeypatch.setattr(ref_table2, "run",
                        functools.partial(ref_table2.run, steps=4))
    assert _names(ref_table2.main()) == _names(lines)


def test_fig1_rows_and_claims_match_reference(monkeypatch):
    kept = _recording(monkeypatch, fig1_overlap)
    lines = fig1_overlap.main(["--steps", "4", "--device", "cpu"])
    assert len(lines) == 10
    assert _ref_lines(monkeypatch, ref_fig1, kept["rows"]) == lines
    monkeypatch.setattr(ref_fig1, "run",
                        functools.partial(ref_fig1.run, steps=4))
    assert _names(ref_fig1.main()) == _names(lines)


def test_fig1_overlap_of_stacked_runs_is_the_reference_tree_overlap():
    """The flat (2, M) stacking of two param trees gives the reference's
    ``replica_overlap`` of the stacked tree."""
    a, b = _mlp_numpy(0), _mlp_numpy(1)
    want = ref_ensemble.replica_overlap(
        jax.tree.map(lambda u, v: jnp.stack([u, v]), a, b))
    pa, pb = params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu")
    flat = FlatLayout(pa).flatten({k: torch.stack([pa[k], pb[k]])
                                   for k in pa}, lead=(2,))
    assert float(ensemble.replica_overlap(flat)) == pytest.approx(
        float(want), rel=1e-5)


# ------------------------------------------------------------------
# (c), (d) tests/test_system.py's contracts of the paper's claims
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def system_task():
    return TeacherTask(num_train=2048, num_test=512)


def _system_sgd(task, steps=300, bs=128, seed=0):
    st = sgd.init(common.mlp_params(seed, "cpu"))
    step = sgd.make_train_step(quickstart.loss_fn, 0.1)
    for i in range(steps):
        st, _ = step(st, task.train_batch(i, bs))
    return st.layout.tree(st.params)


def _system_parle(task, n=3, steps=300, bs=128, split=False, seed=0):
    cfg = ParleConfig(n_replicas=n, L=25, lr=0.1, lr_inner=0.1,
                      batches_per_epoch=task.batches_per_epoch(bs))
    batches = lambda i, m: replica_batches(task, i, bs, m,  # noqa: E731
                                           split=split)
    _, st, _ = quickstart.train("parle", task, quickstart.loss_fn,
                                common.mlp_params(seed, "cpu"), cfg, steps,
                                bs, batches=batches)
    return st


def _err(params, batch):
    with torch.no_grad():
        return float(error_rate(mlp_forward, params, batch))


def test_parle_replicas_stay_aligned(system_task):
    """§1.2: the elastic term keeps replica overlap near 1 during
    training (vs ~uncorrelated for independent runs)."""
    pst = _system_parle(system_task, steps=200)
    assert float(ensemble.replica_overlap(pst.x)) > 0.95
    assert float(ensemble.replica_spread(pst.x)) < 0.2


@pytest.mark.slow
def test_parle_generalizes_better_than_sgd(system_task):
    """Paper Table 1 (scaled): Parle's averaged model beats SGD on
    held-out error at matched per-replica step budget, while
    under-fitting the training set (§4.5)."""
    task = system_task
    sgd_params = _system_sgd(task)
    avg = parle.average_model(_system_parle(task))
    test, train = task.test_batch(), {"x": task.x_train, "y": task.y_train}
    err_sgd, err_parle = _err(sgd_params, test), _err(avg, test)
    tr_sgd, tr_parle = _err(sgd_params, train), _err(avg, train)
    assert err_parle < err_sgd + 0.01, (err_parle, err_sgd)
    assert tr_parle >= tr_sgd - 0.005, (tr_parle, tr_sgd)  # under-fits


@pytest.mark.slow
def test_split_data_parle_beats_split_sgd(system_task):
    """Paper §5 / Table 2: with data split across replicas, Parle's
    average model beats SGD trained on a single shard."""
    task, n = system_task, 2
    avg = parle.average_model(_system_parle(task, n=n, split=True))
    err_parle = _err(avg, task.test_batch())
    st = sgd.init(common.mlp_params(0, "cpu"))
    step = sgd.make_train_step(quickstart.loss_fn, 0.1)
    for i in range(300):
        st, _ = step(st, task.train_batch(i, 128, shard=(0, n)))
    err_sgd_shard = _err(st.layout.tree(st.params), task.test_batch())
    assert err_parle < err_sgd_shard + 0.01, (err_parle, err_sgd_shard)


# ------------------------------------------------------------------
# (e) the examples
# ------------------------------------------------------------------

NARROW = RefModelConfig(name="t-e2e", family="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=256, head_dim=16)


def test_train_llm_parle_loop_matches_reference_and_resumes(tmp_path):
    """The example's loop (Parle n=2, L=10, lr 0.05, weight decay 1e-4)
    on the reference's params, each package on its own token stream (the
    same batches bit for bit): per-step losses within
    TRAJ_TOL over 12 steps (one sync), then the checkpoint restores into
    a fresh state that takes the same next step bit for bit."""
    steps, n = 12, 2
    np_params = numpy_params(NARROW)
    stream = RefTokenStream(vocab_size=NARROW.vocab_size, seq_len=16,
                            batch_size=2)
    batches = [jax.tree.map(np.asarray, ref_replica_batches(stream, i, 2, n))
               for i in range(steps + 1)]

    pcfg = RefParleConfig(n_replicas=n, L=10, lr=0.05, lr_inner=0.05,
                          batches_per_epoch=50)
    model = ref_build_model(NARROW)
    st = ref_parle.init(jax.tree.map(jnp.asarray, np_params), pcfg)
    step = jax.jit(ref_parle.make_train_step(model.loss, pcfg,
                                             weight_decay=1e-4))
    want = []
    for b in batches[:steps]:
        st, m = step(st, jax.tree.map(jnp.asarray, b))
        want.append(float(m["loss"]))

    to_torch = lambda b: {k: torch.from_numpy(np.array(v))  # noqa: E731
                          for k, v in b.items()}
    # the port's own stream: the reference's batches bit for bit
    own = TokenStream(vocab_size=NARROW.vocab_size, seq_len=16, batch_size=2)
    for i in (0, steps):
        mine = replica_batches(own, i, 2, n)
        for k, v in batches[i].items():
            np.testing.assert_array_equal(mine[k].numpy(), v)
    port_model = build_model(port_config(NARROW))
    port_pcfg = train_llm_parle.parle_cfg(n, 10)
    state, losses, progress = train_llm_parle.train(
        port_model, params_from_numpy(np_params, "cpu"), port_pcfg,
        lambda i: replica_batches(own, i, 2, n), steps)
    assert_close(losses, np.array(want), TRAJ_TOL, "e2e losses")
    assert [r["step"] for r in progress] == list(range(1, steps + 1))
    assert int(state.step) == steps and float(state.scopes.rho) < 1.0

    path = str(tmp_path / "e2e_parle.npz")
    ckpt.save(path, state, step=steps, meta={"config": NARROW.name})
    like = parle.init(tree_map(torch.zeros_like,
                               parle.replica_model(state, 0)), port_pcfg)
    restored = ckpt.restore(path, like)
    step = train_llm_parle.make_step(port_model, port_pcfg)
    nxt = to_torch(batches[steps])
    s2, m2 = step(restored, nxt)
    s1, m1 = step(state, nxt)
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(s1.x, s2.x) and int(s1.step) == int(s2.step)


def _smoke_parle(arch, pcfg, seq, batch):
    """(model, fresh Parle state, step, stream) on the CPU for the smoke
    variant of ``arch``."""
    cfg = smoke_variant(get_config(arch))
    model = build_model(cfg)
    state = parle.init(model.init(torch.Generator().manual_seed(0)), pcfg)
    step = parle.make_train_step(model.loss, pcfg)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=seq,
                         batch_size=batch)
    return model, state, step, stream


@pytest.mark.slow
def test_lm_parle_training_reduces_loss():
    """tests/test_system.py's contract: a reduced assigned-arch config
    (qwen2.5-3b smoke) trained with Parle on the token stream, cycling 4
    fixed batches: the loss falls by more than 0.3."""
    pcfg = ParleConfig(n_replicas=2, L=5, lr=0.1, lr_inner=0.1,
                       batches_per_epoch=20)
    _, st, step, stream = _smoke_parle("qwen2.5-3b", pcfg, 32, 4)
    batches = [replica_batches(stream, i, 4, 2) for i in range(4)]
    losses = []
    for i in range(40):
        st, m = step(st, batches[i % 4])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]


def test_trainer_checkpoint_resume(tmp_path):
    """tests/test_system.py's contract: save -> restore -> identical
    next step (llama3-8b smoke, Parle n=2, L=3)."""
    pcfg = ParleConfig(n_replicas=2, L=3)
    _, st, step, stream = _smoke_parle("llama3-8b", pcfg, 16, 2)
    for i in range(4):
        st, _ = step(st, replica_batches(stream, i, 2, 2))
    path = str(tmp_path / "st.npz")
    ckpt.save(path, st, step=4)
    restored = ckpt.restore(path, parle.init(
        tree_map(torch.zeros_like, parle.replica_model(st, 0)), pcfg))
    b = replica_batches(stream, 4, 2, 2)
    _, m2 = step(restored, b)
    _, m1 = step(st, b)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-6)


def test_split_data_main_on_cpu(capsys):
    out = split_data.main(["--device", "cpu"])
    assert out["err_parle"] < out["err_shard"] + 0.01
    assert "Parle n=2, 50% per rep" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2-1.3b"], ["--arch", "llama3-8b", "--window", "64"],
    ["--arch", "internvl2-1b"]], ids=["ssm", "dense-window", "vlm"])
def test_serve_batched_main_on_cpu(argv, capsys):
    out = serve_batched.main(argv + ["--device", "cpu", "--gen", "4",
                                     "--prompt-len", "8", "--batch", "2"])
    assert out["tokens"] == 2 * 4 and out["cache_position"] == 8 + 4 - 1
    assert "tok/s" in capsys.readouterr().out


# ------------------------------------------------------------------
# (f) no card: no silent fallback
# ------------------------------------------------------------------

@pytest.mark.parametrize("main,argv", [
    (table1_baselines.main, ["--steps", "2"]),
    (table2_split_data.main, ["--steps", "2"]),
    (fig1_overlap.main, ["--steps", "2"]),
    (split_data.main, ["--steps", "2"]),
    (train_llm_parle.main, ["--steps", "1", "--checkpoint", ""]),
    (serve_batched.main, ["--gen", "2"])],
    ids=["table1", "table2", "fig1", "split_data", "train_llm_parle",
         "serve_batched"])
def test_entry_points_raise_without_a_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
