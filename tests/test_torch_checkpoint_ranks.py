"""Checkpoint and resume across the ranks of a ``torch.distributed`` group:
the train CLI's ``--checkpoint-dir`` / ``--resume`` under ``--mesh
pod:2`` (two gloo ranks spawned once for the module,
``torch_ranks.spawn``) and in one process (``--mesh pod:1``), smoke-width
Qwen2.5-3B on the CPU, ``--round-fused``, L = 2, checkpoints every 2
steps.

1. Parle int8 + overlap, n = 2: resumed from step 2 under pod:2 and
   under pod:1, the run equals the uninterrupted pod:2 run bit for bit
   (per-step losses, eval loss, final rows of x, e and c).
2. f32 barrier Parle, n = 4 (two rows a rank): resumed under pod:2 it
   equals the uninterrupted pod:2 run bit for bit; resumed under pod:1,
   the first round's losses are bit for bit and the rest within the sum-
   order bound of ``test_torch_distributed_sync.py`` (one process sums
   the four rows in another grouping than two ranks of two).
3. Elastic-SGD and SGD, saved under pod:2, resumed under pod:1: bit for
   bit.
4. The pod:2 file equals the one-process port checkpoint of the same run
   key for key and leaf for leaf, restores in the reference's
   ``repro.checkpoint.checkpoint.restore`` onto the reference's state
   template, and a reference-written checkpoint of the same state
   resumes under pod:2 as the port's own does.
5. Each checkpoint is one ``gather`` a rank, of the bytes of the rank's
   rows of the six row fields; the sync collectives are those of the
   same run without checkpoints.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import parle as ref_parle
from repro.core import registry as ref_registry
from repro_torch.configs import ARCHS, ParleConfig, smoke_variant
from repro_torch.core import registry
from repro_torch.models.model import build_model
from repro_torch.utils.pytree import FlatLayout
from torch_parity import numpy_params
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

RCFG = ref_smoke_variant(REF_ARCHS["qwen2.5-3b"])
BASE = ["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu", "--L", "2",
        "--batch", "2", "--seq", "32", "--round-fused", "--log-every", "2",
        "--seed", "0"]
INT8 = BASE + ["--replicas", "2", "--sync-compress", "int8",
               "--sync-overlap", "--use-kernel"]
# f32 rows summed as (x0 + x1) + (x2 + x3) across two ranks: the bound of
# test_torch_distributed_sync.py's two-replicas-a-rank Parle cases
SUM_ORDER_TOL = dict(rtol=1e-6, atol=1e-7)
ROW_FIELDS = ("x", "y", "z", "v_y", "v_x", "e")


def _argv(base, steps, mesh, ckpt=None, resume=None):
    argv = base + ["--steps", str(steps), "--mesh", mesh]
    if ckpt:
        argv += ["--checkpoint-dir", ckpt, "--checkpoint-every", "2"]
    if resume:
        argv += ["--resume", resume]
    return argv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: [rank 0's, rank 1's]} of the pod:2 jobs and {name: result}
    of the one-process jobs, with the directories they wrote."""
    d = tmp_path_factory.mktemp("ckpt_ranks")
    dirs = {k: str(d / k) for k in ("int8", "one", "ref", "f32", "elastic",
                                    "sgd")}
    one = {"int8": torch_ranks.train_cli(_argv(INT8, 6, "pod:1",
                                               ckpt=dirs["one"]))}
    # a reference-written checkpoint of the same state: the one-process
    # port file at step 2, through the reference's restore and save
    like = ref_parle.dealias_state(ref_registry.get("parle").init(
        jax.tree.map(jnp.asarray, numpy_params(RCFG)),
        RefParleConfig(n_replicas=2, L=2, sync_compress="int8",
                       sync_overlap=True)))
    ref_ckpt.save(f"{dirs['ref']}/step000002.npz",
                  ref_ckpt.restore(f"{dirs['one']}/step000002.npz", like,
                                   algo="parle"), step=2, algo="parle")
    f32 = BASE + ["--replicas", "4"]
    el = BASE + ["--replicas", "2", "--algo", "elastic_sgd", "--use-kernel"]
    sgd = BASE + ["--replicas", "2", "--algo", "sgd"]
    jobs = {
        "int8": _argv(INT8, 6, "pod:2", ckpt=dirs["int8"]),
        "int8_nockpt": _argv(INT8, 6, "pod:2"),
        "int8_resume": _argv(INT8, 4, "pod:2",
                             resume=f"{dirs['int8']}/step000002.npz"),
        "int8_from_ref": _argv(INT8, 4, "pod:2", resume=dirs["ref"]),
        "f32": _argv(f32, 6, "pod:2", ckpt=dirs["f32"]),
        "f32_resume": _argv(f32, 4, "pod:2",
                            resume=f"{dirs['f32']}/step000002.npz"),
        "elastic": _argv(el, 6, "pod:2", ckpt=dirs["elastic"]),
        "sgd": _argv(sgd, 6, "pod:2", ckpt=dirs["sgd"]),
    }
    per_rank = torch_ranks.spawn(torch_ranks.train_cli_jobs, 2,
                                 str(d / "store"), jobs)
    pod = {k: [r[k] for r in per_rank] for k in jobs}
    for name, base, src in (("int8", INT8, "int8"), ("f32", f32, "f32"),
                            ("elastic", el, "elastic"), ("sgd", sgd, "sgd")):
        one[f"{name}_resume"] = torch_ranks.train_cli(_argv(
            base, 4, "pod:1", resume=f"{dirs[src]}/step000002.npz"))
    return pod, one, dirs


def _rows(ranks, f):
    """The pod's field: the ranks' rows in rank order (a field without a
    replica axis is whole on every rank, and equal there)."""
    if ranks[0]["fields"][f].ndim == 1 or f == "params":
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["fields"][f],
                                          ranks[0]["fields"][f])
        return ranks[0]["fields"][f]
    return np.concatenate([r["fields"][f] for r in ranks])


def _assert_resumed(got_losses, got_eval, got_fields, full):
    """A run resumed at step 2 against the uninterrupted pod:2 run
    ``full`` (rank results): bit for bit."""
    np.testing.assert_array_equal(got_losses, full[0]["losses"][2:])
    assert got_eval == full[0]["eval_loss"]
    for f in full[0]["fields"]:
        np.testing.assert_array_equal(got_fields(f), _rows(full, f),
                                      err_msg=f"final {f}")


def test_parle_int8_overlap_resumes_under_two_ranks_and_one(runs):
    pod, one, _ = runs
    full = pod["int8"]
    assert set(full[0]["fields"]) == {"x", "e", "c"}
    # the checkpointed run is the run without checkpoints
    for r, plain in zip(full, pod["int8_nockpt"]):
        np.testing.assert_array_equal(r["losses"], plain["losses"])
        for f in r["fields"]:
            np.testing.assert_array_equal(r["fields"][f], plain["fields"][f])
    for r in pod["int8_resume"]:
        np.testing.assert_array_equal(r["losses"], full[0]["losses"][2:])
    _assert_resumed(pod["int8_resume"][0]["losses"],
                    pod["int8_resume"][0]["eval_loss"],
                    lambda f: _rows(pod["int8_resume"], f), full)
    res = one["int8_resume"]
    _assert_resumed(res["losses"], res["eval_loss"],
                    lambda f: res["fields"][f], full)


def test_two_rows_a_rank_resume_under_two_ranks_and_one(runs):
    pod, one, _ = runs
    full = pod["f32"]
    _assert_resumed(pod["f32_resume"][0]["losses"],
                    pod["f32_resume"][0]["eval_loss"],
                    lambda f: _rows(pod["f32_resume"], f), full)
    res = one["f32_resume"]
    assert res["fields"]["x"].shape[0] == 4
    # before the next sync every replica is its own: bit for bit
    np.testing.assert_array_equal(res["losses"][:2], full[0]["losses"][2:4])
    np.testing.assert_allclose(res["losses"], full[0]["losses"][2:],
                               **SUM_ORDER_TOL)
    np.testing.assert_allclose(res["fields"]["x"], _rows(full, "x"),
                               **SUM_ORDER_TOL)


@pytest.mark.parametrize("algo", ["elastic", "sgd"])
def test_baselines_saved_under_two_ranks_resume_in_one(runs, algo):
    pod, one, _ = runs
    res = one[f"{algo}_resume"]
    _assert_resumed(res["losses"], res["eval_loss"],
                    lambda f: res["fields"][f], pod[algo])


def test_pod_file_is_the_one_process_file_and_the_reference_reads_it(runs):
    pod, one, dirs = runs
    for step in (2, 4, 6):
        name = f"step{step:06d}.npz"
        with np.load(f"{dirs['int8']}/{name}") as got, \
                np.load(f"{dirs['one']}/{name}") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        like = ref_parle.dealias_state(ref_registry.get("parle").init(
            jax.tree.map(jnp.asarray, numpy_params(RCFG)),
            RefParleConfig(n_replicas=2, L=2, sync_compress="int8",
                           sync_overlap=True)))
        back = ref_ckpt.restore(f"{dirs['int8']}/{name}", like,
                                algo="parle")
        with np.load(f"{dirs['int8']}/{name}") as got:
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    back._asdict()):
                key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                            p)))
                               for p in path)
                np.testing.assert_array_equal(np.asarray(leaf), got[key])
    assert ref_ckpt.latest_step(f"{dirs['int8']}/step000006.npz") == 6
    # the uninterrupted one-process run is the pod's, bit for bit
    np.testing.assert_array_equal(one["int8"]["losses"],
                                  pod["int8"][0]["losses"])
    # a reference-written checkpoint resumes under pod:2 as the port's
    for got, want in zip(pod["int8_from_ref"], pod["int8_resume"]):
        np.testing.assert_array_equal(got["losses"], want["losses"])
        assert got["eval_loss"] == want["eval_loss"]
        for f in want["fields"]:
            np.testing.assert_array_equal(got["fields"][f],
                                          want["fields"][f])


def test_a_checkpoint_is_one_gather_a_rank(runs):
    pod, _, _ = runs
    cfg = smoke_variant(ARCHS["qwen2.5-3b"])
    layout = FlatLayout(build_model(cfg).init(
        torch.Generator().manual_seed(0)))
    row_bytes = 4 * sum(layout.sizes) * len(ROW_FIELDS)
    specs = registry.get("parle").state_pspecs(
        "pod", ParleConfig(sync_compress="int8", sync_overlap=True))
    assert {f for f, axis in specs.items() if axis == "pod"} == set(
        ROW_FIELDS)
    assert {f for f, axis in specs.items() if axis is None} == {
        "step", "scopes", "c"}
    for r, plain in zip(pod["int8"], pod["int8_nockpt"]):
        assert r["counts"]["gather"] == (3, 3 * row_bytes)
        assert "gather" not in plain["counts"]
        sync = {op: c for op, c in r["counts"].items() if op != "gather"}
        assert sync == plain["counts"]
