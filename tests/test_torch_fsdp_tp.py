"""FSDP x TP inside a replica, composed with the replica axis: the port's
counterpart of tests/test_fsdp_tp.py (the sharding planner end to end,
``sharding/partition.py::MeshGroups``).

One world of eight gloo ranks is spawned (``torch_ranks.spawn``) once for
the module, on the reference's ``t-dense`` model (2 layers, d 128, 4 / 2
heads of 32, ff 256, vocab 512; its token stream at seq 16, batch 2), and
runs every case of :data:`CASES` on a ``MeshGroups`` of its spec:

  * planner-sharded state: each rank's block of every ``wq`` leaf is 1/8
    of the leaf, at the slice ``Spec("replica", None, "data", "model")``
    gives;
  * sharded == one process across two L = 3 syncs (7 steps): losses and
    the deployable model within the reference's ``rtol=2e-5`` (and
    ``atol=2e-6``), the losses also against the reference's own local
    path;
  * the bytes by axis: the Eq. (8d) sync moves at most a shard + 4096
    bytes over the replica axis, a step without a sync only the scalar
    loss; inside a replica the blocks are gathered over "data" only and
    "model" carries the Megatron split's activations, never a leaf;
  * ``replica:2,model:4`` (no data axis; 2 KV heads over 4 ranks, so a
    rank's K / V columns end mid-head): the dense replica split over
    "model" within the composed-mesh bounds, its compute row about 1/4
    of the row, and the ssm family (each rank 2 of its 8 SSD heads)
    likewise;
  * int8 + overlap + flush through the kernels' plain versions,
    Elastic-SGD and SGD at the tolerances stated by each test;
  * the train CLI under ``torch.distributed.run`` on four ranks prints
    the reference's records, the async policy refuses naming its
    ROADMAP.md item, and the checkpoint paths (item 6b) and a moe
    architecture on a data axis (item 6a) run.

``replica:2,model:2`` runs in the four-rank world of
``tests/test_torch_megatron.py``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from repro.configs.base import ModelConfig as RefModelConfig
from repro_torch.launch import train
from repro_torch.sharding import planner
from repro_torch.sharding.rules import Spec
from torch_parity import (numpy_params, one_torch_thread,  # noqa: F401
                          port_config, ssm_init_draws)

RCFG = RefModelConfig(name="t-dense", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=512, head_dim=32)
CFG = port_config(RCFG)
RCFG_SSM = RefModelConfig(name="t-ssm", family="ssm", num_layers=2,
                          d_model=64, num_heads=0, num_kv_heads=0, d_ff=0,
                          vocab_size=512, ssm_state=16, ssm_head_dim=16,
                          ssm_expand=2, ssm_chunk=8)
STREAM = dict(vocab_size=512, seq_len=16, batch_size=2, seed=0)
MESH = "replica:2,data:2,model:2"
TOL = dict(rtol=2e-5)                         # the reference's loss bound
DEPLOY_TOL = dict(rtol=2e-5, atol=2e-6)       # and its deployable bound


def _case(algo="parle", mesh=MESH, steps=7, mode="step", **kw):
    return dict(algo=algo, n=2, L=3, mesh=mesh, steps=steps, mode=mode,
                **kw)


CASES = {
    "parle": _case(),
    "parle-model4": _case(mesh="replica:2,model:4"),
    "ssm-model4": _case(mesh="replica:2,model:4", model="ssm"),
    "parle-int8-overlap": _case(mode="round", steps=6, compress="int8",
                                overlap=True, use_kernel=True),
    "elastic_sgd": _case("elastic_sgd", mode="round", steps=6,
                         use_kernel=True),
    "sgd": _case("sgd", mode="round", steps=6),
}


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, numpy_params(RCFG))


@pytest.fixture(scope="module")
def models(np_params):
    """{model name: (port config fields, numpy params)} of the cases."""
    ssm = ssm_init_draws(jax.tree.map(np.asarray, numpy_params(RCFG_SSM)))
    return {"dense": (dataclasses.asdict(CFG), np_params),
            "ssm": (dataclasses.asdict(port_config(RCFG_SSM)), ssm)}


@pytest.fixture(scope="module")
def world(models, tmp_path_factory):
    """Every case on eight spawned ranks: {case: [each rank's result]}."""
    store = str(tmp_path_factory.mktemp("fsdp_tp") / "store")
    per_rank = torch_ranks.spawn(
        torch_ranks.fsdp_tp_cases, 8, store, list(CASES.values()), models,
        STREAM)
    return {k: [r[i] for r in per_rank] for i, k in enumerate(CASES)}


@pytest.fixture(scope="module")
def single(models):
    """Every case in this process, all n replicas."""
    return {k: torch_ranks.run_mesh_case(
        c, None, *models[c.get("model", "dense")], STREAM)
        for k, c in CASES.items()}


def _nparam(np_params):
    return sum(int(np.prod(l.shape)) for l in jax.tree.leaves(np_params))


def _step_bytes(counts, axis):
    """Bytes moved over ``axis`` in each step (or round), from the
    cumulative counts after each."""
    tot = [sum(b for _, b in c.get(axis, {}).values()) for c in counts]
    return np.diff([0] + tot)


def test_state_is_planner_sharded(world, np_params):
    """Each rank's block of the stacked ``wq`` is 1/8 of the leaf (n = 2
    replicas x 2 layers x 128 x 128), at the slice that
    ``Spec("replica", None, "data", "model")`` gives its coordinate."""
    specs = planner.plan_tree(
        {"blocks": {"attn": {"wq": np_params["blocks"]["attn"]["wq"]}}},
        axis_sizes={"replica": 2, "data": 2, "model": 2})
    assert specs.pspecs_with_leading("replica")["blocks"]["attn"]["wq"] \
        == Spec("replica", None, "data", "model")
    wq = np_params["blocks"]["attn"]["wq"]
    for r in world["parle"]:
        c = r["coords"]
        block = r["wq_block"]
        assert block.size * 8 == 2 * wq.size
        d, m = c["data"], c["model"]
        np.testing.assert_array_equal(
            block[0], wq[:, 64 * d:64 * (d + 1), 64 * m:64 * (m + 1)])


def test_sharded_equals_one_process_across_syncs(world, single, np_params):
    """7 steps across two L = 3 syncs under replica:2,data:2,model:2: the
    losses within rtol 2e-5 of the port's one-process run and of the
    reference's local path, the deployable within rtol 2e-5 / atol
    2e-6, and every rank reports the same."""
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core import registry as ref_registry
    from repro.data.synthetic import TokenStream, replica_batches
    from repro.models.model import build_model

    one = single["parle"]
    for r in world["parle"]:
        np.testing.assert_allclose(r["losses"], one["losses"], **TOL)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **DEPLOY_TOL)
    algo = ref_registry.get("parle")
    cfg = algo.canonicalize_cfg(RefParleConfig(
        n_replicas=2, L=3, lr=0.1, lr_inner=0.1, batches_per_epoch=5))
    st = algo.init(jax.tree.map(jnp.asarray, np_params), cfg)
    step = jax.jit(algo.make_step(build_model(RCFG).loss, cfg))
    stream = TokenStream(**STREAM)
    ref = []
    for i in range(7):
        st, m = step(st, replica_batches(stream, i, 2, 2))
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(world["parle"][0]["losses"], ref, **TOL)
    for k, v in one["deploy"].items():
        ref_leaf = algo.deployable(st)
        for p in k.split("/"):
            ref_leaf = ref_leaf[p]
        np.testing.assert_allclose(world["parle"][0]["deploy"][k],
                                   np.asarray(ref_leaf), err_msg=k,
                                   **DEPLOY_TOL)


def _activation_bytes(mesh):
    """The bytes a rank gathers over "model" in a step of t-dense split
    over it (one local replica, the rank's B / D rows): the embedding's
    d/M columns, and where M does not divide the 2 KV heads, each layer's
    K and V columns."""
    D, M = (int(dict(a.split(":") for a in mesh.split(",")).get(k, 1))
            for k in ("data", "model"))
    rows = STREAM["batch_size"] // D * STREAM["seq_len"]
    kv = 0 if RCFG.num_kv_heads % M == 0 else (
        RCFG.num_layers * 2 * RCFG.num_kv_heads * RCFG.head_dim // M)
    return rows * (RCFG.d_model // M + kv) * 4


def test_bytes_by_axis(world, np_params):
    """The sync (steps 3 and 6) moves over the replica axis between a
    shard of the model (its bytes / (data x model)) and that plus 4096
    bytes; every other step only the scalar loss.  Inside a replica each
    step gathers the blocks over "data" (one all-gather a step) and
    reduce-scatters the grads there; "model" carries only the split's
    activations: its all-gathers are the embedding's columns, never a
    leaf, and no collective spans "data,model"."""
    shard = _nparam(np_params) * 4 // 4
    for r in world["parle"]:
        rep = _step_bytes(r["counts"], "replica")
        for i, b in enumerate(rep):
            if (i + 1) % 3 == 0:
                assert shard <= b <= shard + 4096, (i, b, shard)
            else:
                assert b <= 64, (i, b)
        by_axis = r["counts"][-1]
        assert by_axis["data"]["all_gather"][0] == 7
        assert by_axis["data"]["reduce_scatter"][0] == 7
        gathered = [c.get("model", {}).get("all_gather", (0, 0))[1]
                    for c in r["counts"]]
        assert list(np.diff([0] + gathered)) == [_activation_bytes(MESH)] * 7
        assert set(by_axis) == {"replica", "data", "model"}


def test_model_axis_alone_is_bit_for_bit(world, single):
    """Under replica:2,model:4 the ssm family is split over "model" too
    (each rank its 2 of the 8 SSD heads; they were bit for bit while
    every rank computed the whole replica on the gathered row): the
    losses within rtol 2e-5 of the one-process run's, each final x row
    and the deployable within rtol 2e-5 / atol 2e-6; with no data axis
    "model" carries only the split's activations (no leaf) and no grad
    is reduced."""
    one = single["ssm-model4"]
    for r in world["ssm-model4"]:
        rel = np.abs(r["losses"] / one["losses"] - 1).max()
        print(f"[fsdp_tp] ssm replica:2,model:4: losses max rel err "
              f"{rel:.3e}")
        np.testing.assert_allclose(r["losses"], one["losses"], **TOL)
        rep = r["coords"]["replica"]
        np.testing.assert_allclose(r["full_rows"][0],
                                   one["full_rows"][rep], **DEPLOY_TOL)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **DEPLOY_TOL)
        assert set(r["counts"][-1]) == {"replica", "model"}
        # the norms, conv bias and per-head scalars (816 elements) whole
        assert r["column"] == (r["row"] - 816) // 4 + 816


def test_model_axis_alone_splits_a_dense_replica(world, single):
    """Under replica:2,model:4 a dense replica is split over "model" (the
    reference's composed-mesh contract: losses within rtol 2e-5, the
    deployable within rtol 2e-5 / atol 2e-6 of one process): no leaf is
    gathered over "model" (its all-gathers are the embedding's columns
    and the K / V columns of the 2 KV heads, 4 ranks ending mid-head),
    and a rank computes on about a quarter of the row."""
    one = single["parle-model4"]
    for r in world["parle-model4"]:
        rel = np.abs(r["losses"] / one["losses"] - 1).max()
        dep = max(np.abs(r["deploy"][k] - v).max()
                  for k, v in one["deploy"].items())
        print(f"[fsdp_tp] dense replica:2,model:4: losses max rel err "
              f"{rel:.3e}, deployable max abs err {dep:.3e}")
        np.testing.assert_allclose(r["losses"], one["losses"], **TOL)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **DEPLOY_TOL)
        gathered = [c["model"]["all_gather"][1] for c in r["counts"]]
        assert list(np.diff([0] + gathered)) == \
            [_activation_bytes("replica:2,model:4")] * 7
        assert set(r["counts"][-1]) == {"replica", "model"}
        # the norms (3 leaves, 640 elements) are whole on every rank
        assert r["column"] == (r["row"] - 640) // 4 + 640


@pytest.mark.parametrize("case,loss_tol,deploy_tol", [
    # int8 chunks follow the shard layout (other chunk edges than one
    # process's over "model"), so each sync's dequantized mean differs by
    # up to half a quantization step of a chunk (measured: losses 1.2e-4
    # relative, the deployable 6.6e-4 absolute; a step is max|w| / 127,
    # 3.5e-3 for the projections' |w| < 0.45)
    ("parle-int8-overlap", dict(rtol=5e-4), dict(rtol=0, atol=2e-3)),
    # f32: the data split's sums only (measured 1.2e-7 / 6.1e-7)
    ("elastic_sgd", TOL, DEPLOY_TOL),
    ("sgd", TOL, DEPLOY_TOL),
])
def test_other_paths_hold(world, single, case, loss_tol, deploy_tol):
    """int8 + overlap + flush (the kernels' plain versions on the shard
    buffers), Elastic-SGD (K7's) and SGD under replica:2,data:2,model:2:
    the round losses and the deployable within the stated tolerances of
    one process."""
    one = single[case]
    for r in world[case]:
        rel = np.abs(r["losses"] / one["losses"] - 1).max()
        dep = max(np.abs(r["deploy"][k] - v).max()
                  for k, v in one["deploy"].items())
        print(f"[fsdp_tp] {case}: losses max rel err {rel:.3e}, "
              f"deployable max abs err {dep:.3e}")
        np.testing.assert_allclose(r["losses"], one["losses"], **loss_tol)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **deploy_tol)


def test_train_cli_on_four_ranks(tmp_path):
    """``torch.distributed.run --nproc-per-node 4 -m
    repro_torch.launch.train --mesh replica:2,data:2`` prints the
    reference's records (the mesh with its in-replica axes, the progress
    and final records) from rank 0 only."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--standalone", "--nproc-per-node", "4", "-m",
           "repro_torch.launch.train", "--mesh", "replica:2,data:2",
           "--smoke", "--device", "cpu", "--L", "2", "--steps", "4",
           "--batch", "2", "--seq", "16", "--round-fused", "--use-kernel",
           "--log-every", "2"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=180, cwd=str(tmp_path))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = [json.loads(l) for l in res.stdout.splitlines()
            if l.startswith("{")]
    kinds = [r["kind"] for r in recs]
    assert kinds == ["mesh", "train_progress", "train_progress",
                     "train_final"], kinds
    mesh = recs[0]
    assert {"mesh", "replica_axis", "in_replica_axes",
            "replicas_per_device"} <= set(mesh)
    assert mesh["mesh"] == {"replica": 2, "data": 2}
    assert mesh["in_replica_axes"] == ["data"]
    assert {"step", "round", "loss", "wall_s", "diag"} <= set(recs[1])
    assert {"final_eval_loss", "algo", "arch"} <= set(recs[-1])
    assert np.isfinite(recs[-1]["final_eval_loss"])


@pytest.fixture(scope="module")
def item_runs(tmp_path_factory):
    """The "item 6b" and "item 6a" cases below, run on two spawned ranks
    (with "ck" a directory of their own): the first checkpoints every
    step under replica:1,model:2, the second resumes from the directory,
    the third trains a moe architecture under replica:1,data:2.  Returns
    the directory and {case: rank 0's result}."""
    d = tmp_path_factory.mktemp("item_runs")
    ck = str(d / "ck")
    jobs = {i: [ck if a == "ck" else a for a in
                ["--smoke", "--device", "cpu", "--steps", "1"] + argv]
            for i, argv in ((0, ITEMS[0][0]), (1, ITEMS[1][0]),
                            (2, ITEMS[2][0]))}
    per_rank = torch_ranks.spawn(torch_ranks.train_cli_jobs, 2,
                                 str(d / "store"), jobs)
    return ck, per_rank[0]


# (argv, the ROADMAP.md item): "item 6a" and "item 6b" are ported (the
# cases run), "item 6d" refuses naming its item, as the reference refuses
# the async policy on any mesh
ITEMS = [
    (["--arch", "qwen2-moe-a2.7b", "--mesh", "replica:1,data:2"],
     "item 6a"),
    (["--mesh", "replica:1,model:2", "--checkpoint-dir", "ck",
      "--checkpoint-every", "1"], "item 6b"),
    (["--mesh", "replica:1,model:2", "--resume", "ck"], "item 6b"),
    (["--mesh", "replica:1,data:2", "--sync-policy", "async"], "item 6d"),
]


@pytest.mark.parametrize("argv,match", ITEMS)
def test_unported_paths_name_their_item(argv, match, request):
    """The async policy on a mesh with an axis inside a replica exits
    naming its ROADMAP.md item; the ported items run on two ranks: the
    checkpoint paths of item 6b (the first case writes a step-1 file of
    the one-process shapes, whole leaves, n = 1; the second resumes from
    the directory and takes step 2 to a finite loss) and a moe
    architecture under a data axis (item 6a: its step-1 loss within the
    reference's composed-mesh bound of the one-process run's)."""
    if match == "item 6d":
        with pytest.raises(SystemExit, match=match):
            train.main(["--smoke", "--device", "cpu", "--steps", "1"]
                       + argv)
        return
    ck, results = request.getfixturevalue("item_runs")
    if match == "item 6a":
        one = torch_ranks.train_cli(["--smoke", "--device", "cpu",
                                     "--steps", "1", "--replicas", "1",
                                     "--arch", "qwen2-moe-a2.7b"])
        np.testing.assert_allclose(results[0]["losses"], one["losses"],
                                   **TOL)
        np.testing.assert_allclose(results[0]["eval_loss"],
                                   one["eval_loss"], **TOL)
        assert results[0]["by_axis"]["data"]["reduce_scatter"][0] == 1
    elif "--checkpoint-dir" in argv:
        from repro_torch.checkpoint import checkpoint as ckpt
        path = ckpt.resolve(ck)
        assert ckpt.latest_step(path) == 1
        with np.load(path) as f:
            assert f["x/blocks/attn/wq"].shape == (1, 2, 256, 256)
        assert len(results[1]["losses"]) == 1
    else:
        assert np.isfinite(results[2]["losses"]).all()
        assert np.isfinite(results[2]["eval_loss"])


def test_moe_model_axis_is_not_refused():
    """A moe architecture over "model" alone gets past the checks (to
    the launch hint: no world of two ranks here)."""
    with pytest.raises(SystemExit, match="torch.distributed.run"):
        train.main(["--smoke", "--device", "cpu", "--steps", "1", "--arch",
                    "qwen2-moe-a2.7b", "--mesh", "replica:1,model:2"])


def test_collective_counts_sum_over_axes():
    """``collective_counts`` keys by op and sums the ``axis`` series (as
    its readers from before the axis label expect),
    ``collective_counts_by_axis`` splits them."""
    from repro_torch.obs import Obs
    from repro_torch.sharding.partition import (collective_counts,
                                                collective_counts_by_axis)
    reg = Obs().registry
    for axis, calls, nbytes in (("replica", 2, 40), ("data,model", 3, 300),
                                ("replica", 1, 4)):
        reg.counter("pod.collectives", op="all_gather", axis=axis).inc(calls)
        reg.counter("pod.collective_bytes", op="all_gather",
                    axis=axis).inc(nbytes)
    reg.counter("pod.collectives", op="all_reduce", axis="replica").inc()
    reg.counter("pod.collective_bytes", op="all_reduce",
                axis="replica").inc(16)
    assert collective_counts(reg) == {"all_gather": (6, 344),
                                      "all_reduce": (1, 16)}
    assert collective_counts_by_axis(reg) == {
        "replica": {"all_gather": (3, 44), "all_reduce": (1, 16)},
        "data,model": {"all_gather": (3, 300)}}
