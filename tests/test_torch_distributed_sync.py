"""The replica axis across processes (``sharding/partition.py``,
``launch/mesh.py`` and the sharded factories of ``core/``): the port's
counterparts of tests/test_distributed_sync.py and of
tests/test_system.py::test_communication_amortization_accounting.

Two gloo ranks are spawned (``torch_ranks.spawn``, a ``FileStore`` under
``tmp_path``) once for the module; each runs every case on its replica
rows.  With one replica a rank the pod equals the port's single-process
run bit for bit (sync none, bf16 and int8; barrier and overlap + flush;
Parle, Elastic-SGD and SGD).  With two a rank the bf16 and int8 payloads
are gathered in rank order, so they are bit for bit too; the f32 mean
sums (x0 + x1) + (x2 + x3), ulps from one pass over four rows, and is
held at rtol 1e-6 (the reference's own 8-device bound; Elastic-SGD and
SGD, which take the mean every step, at 1e-5).  Every pod is
held to the reference's single-process rounds at the f32 tolerance of
1e-4, and its collective counters to the paper's communication claim.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke
from repro_torch.configs import ParleConfig
from repro_torch.core import registry
from repro_torch.launch import mesh, steps, train
from repro_torch.models.convert import params_from_numpy
from repro_torch.sharding.partition import ReplicaGroup
from repro_torch.utils.pytree import FlatLayout, tree_map
from torch_parity import (assert_close, leaf_pairs, numpy_params,
                          one_torch_thread, port_config,  # noqa: F401
                          ref_rounds)

RCFG = ref_smoke(ref_get_config("qwen2.5-3b"))
CFG = port_config(RCFG)
L, ROUNDS, B, T = 3, 2, 2, 32
REF_TOL = dict(rtol=1e-4, atol=1e-4)      # the f32 smoke-trajectory bound
# two replicas a rank: the f32 mean sums (x0 + x1) + (x2 + x3).  Parle
# meets the reference's own 8-device bound; Elastic-SGD and SGD take that
# mean every step, and 6 steps of momentum carry its ulps further: the
# port's kernel-vs-plain bound (rtol 1e-5, test_torch_parle.py), with an
# atol of 1e-5 of the largest magnitude for the elements near zero
SUM_ORDER_TOL = {"parle": (1e-6, 1e-7), "elastic_sgd": (1e-5, None),
                 "sgd": (1e-5, None)}


def assert_sum_order_close(got, want, algo, what):
    rtol, atol = SUM_ORDER_TOL[algo]
    if atol is None:
        atol = rtol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, err_msg=what, rtol=rtol,
                               atol=atol)


def _case(algo="parle", n=2, compress="none", overlap=False,
          use_kernel=False, mode="round"):
    return dict(algo=algo, n=n, L=L, compress=compress, overlap=overlap,
                use_kernel=use_kernel, mode=mode)


CASES = {
    "parle-none-barrier": _case(use_kernel=True),
    "parle-none-overlap": _case(overlap=True),
    "parle-bf16-barrier": _case(compress="bf16"),
    "parle-bf16-overlap": _case(compress="bf16", overlap=True),
    "parle-int8-barrier": _case(compress="int8"),
    "parle-int8-barrier-kernel": _case(compress="int8", use_kernel=True),
    "parle-int8-overlap-kernel": _case(compress="int8", overlap=True,
                                       use_kernel=True),
    "parle-none-step": _case(mode="step"),
    "elastic_sgd": _case("elastic_sgd", use_kernel=True),
    "sgd": _case("sgd"),
    # two replicas a rank
    "parle-none-barrier-k2": _case(n=4),
    "parle-bf16-barrier-k2": _case(n=4, compress="bf16"),
    "parle-int8-barrier-k2": _case(n=4, compress="int8", use_kernel=True),
    "parle-int8-overlap-k2": _case(n=4, compress="int8", overlap=True),
    "elastic_sgd-k2": _case("elastic_sgd", n=4),
    "sgd-k2": _case("sgd", n=4),
}
K1 = [k for k, c in CASES.items() if c["n"] == 2]
K2 = [k for k, c in CASES.items() if c["n"] == 4]


@pytest.fixture(scope="module")
def inputs():
    np_params = jax.tree.map(np.asarray, numpy_params(RCFG))
    rng = np.random.default_rng(3)
    batches = {n: rng.integers(0, RCFG.vocab_size, size=(ROUNDS, L, n, B, T))
               .astype(np.int32) for n in (2, 4)}
    return np_params, batches


@pytest.fixture(scope="module")
def pod(inputs, tmp_path_factory):
    """Every case on two spawned ranks: {case: [rank 0's, rank 1's]}."""
    np_params, batches = inputs
    store = str(tmp_path_factory.mktemp("pod") / "store")
    per_rank = torch_ranks.spawn(
        torch_ranks.run_cases, 2, store, list(CASES.values()),
        dataclasses.asdict(CFG), np_params, batches)
    return {k: [r[i] for r in per_rank] for i, k in enumerate(CASES)}


@pytest.fixture(scope="module")
def single(inputs):
    """Every case in this process, all n replicas (the trivial group)."""
    np_params, batches = inputs
    return {k: torch_ranks.run_case(c, ReplicaGroup(c["n"]),
                                    dataclasses.asdict(CFG), np_params,
                                    batches[c["n"]])
            for k, c in CASES.items()}


def _assembled(ranks, field):
    """A field of the pod's final state: the ranks' rows in rank order
    (ref and SGD's params / v are whole on every rank: rank 0's)."""
    if ranks[0]["fields"][field].ndim == 1:
        return ranks[0]["fields"][field]
    return np.concatenate([r["fields"][field] for r in ranks])


# ------------------------------------------------------------------
# mesh specs and the group (pure, in-process)
# ------------------------------------------------------------------

def test_parse_mesh_spec():
    assert mesh.parse_mesh_spec("replica:4") == {"replica": 4}
    assert mesh.parse_mesh_spec("replica:2,data:4") == {"replica": 2,
                                                         "data": 4}
    assert mesh.parse_mesh_spec(" replica : 8 ") == {"replica": 8}
    with pytest.raises(ValueError):
        mesh.parse_mesh_spec("replica")
    with pytest.raises(ValueError):
        mesh.parse_mesh_spec("")


def test_parse_mesh_spec_rejects_zero_size():
    with pytest.raises(ValueError, match="positive"):
        mesh.parse_mesh_spec("replica:0")


def test_group_from_spec_single_rank_needs_no_world():
    group = mesh.group_from_spec("pod:1", n=3)
    assert group.trivial and (group.n, group.local) == (3, 3)
    assert group.rows == slice(0, 3)
    assert mesh.replica_axis_of(mesh.parse_mesh_spec("replica:1")) \
        == "replica"


def test_group_from_spec_rejects_oversubscription(tmp_path, monkeypatch):
    """The counterpart of the reference's oversubscribed mesh: a spec
    whose replica axis spans more ranks than the world has."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh.group_from_spec("pod:2")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            mesh.group_from_spec("pod:2")
    finally:
        dist.destroy_process_group()


def test_in_replica_axes_name_their_roadmap_item():
    """An axis inside a replica is ported: without a world, a spec with
    one above size 1 asks for a world of all its ranks (the launch hint
    for 2 ranks, without the replica-only pod launcher)."""
    with pytest.raises(RuntimeError, match="spans 2 ranks") as e:
        mesh.groups_from_spec("pod:1,data:2")
    assert "--nproc-per-node 2" in str(e.value)
    assert "dist_run" not in str(e.value)
    with pytest.raises(ValueError, match="groups_from_spec"):
        mesh.group_from_spec("pod:1,data:2")
    with pytest.raises(ValueError, match="no replica axis"):
        mesh.group_from_spec("data:2")
    with pytest.raises(ValueError, match="not divisible"):
        ReplicaGroup(3, 0, 2)


def test_gather_and_means_keep_the_rank_order(tmp_path):
    """One all-gather of f32, bf16 and int8 rows returns every rank's rows
    in rank order; ``mean_rows`` and ``replica_means`` are the means over
    all n rows; each operation counted once."""
    out = torch_ranks.spawn(torch_ranks.gather_orders, 2,
                            str(tmp_path / "store"))
    want = np.arange(4, dtype=np.float32)[:, None] * 10 + np.arange(3.0)
    for rank, r in enumerate(out):
        assert r["rows"] == (2 * rank, 2 * rank + 2)
        for g in r["gathered"]:
            np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(r["mean"], want.mean(0))
        np.testing.assert_allclose(r["means"], want.mean(0), rtol=1e-7)
        assert r["counts"] == {"all_gather": (2, 2 * 3 * (4 + 2 + 1)
                                              + 2 * 3 * 4),
                               "all_reduce": (1, 3 * 4)}


def test_entropy_sgd_is_refused_across_ranks():
    """entropy_sgd is Parle at n = 1: two ranks have nothing to shard
    (the reference's messages, from the factory and from the trainer)."""
    algo = registry.get("entropy_sgd")
    two = ReplicaGroup(2, 0, 2)
    with pytest.raises(ValueError, match="entropy_sgd runs a single "
                                         "replica.*pod:2"):
        algo.make_sharded_step(None, ParleConfig(n_replicas=2), two)
    with pytest.raises(ValueError, match="nothing to shard"):
        algo.make_round_fn(None, ParleConfig(n_replicas=2), mesh=two)
    with pytest.raises(SystemExit, match="canonicalizes --replicas 2 to "
                                         "n_replicas=1"):
        train.main(["--smoke", "--device", "cpu", "--algo", "entropy_sgd",
                    "--mesh", "pod:2", "--replicas", "2"])
    with pytest.raises(SystemExit, match="--replicas 1 is not divisible"):
        train.main(["--smoke", "--device", "cpu", "--algo", "entropy_sgd",
                    "--mesh", "pod:2"])


def test_entropy_sgd_module_is_parle_at_one_replica(inputs):
    """``core/entropy_sgd.py``: n forced to 1; its step (and its sharded
    step on the trivial group) equals the registry's entropy_sgd step
    bit for bit."""
    from repro_torch.core import entropy_sgd
    from repro_torch.models.model import build_model
    np_params, batches = inputs
    cfg = ParleConfig(n_replicas=4, L=L, batches_per_epoch=1)
    loss = build_model(CFG).loss
    b = {"tokens": torch.from_numpy(batches[2][0, 0, :1]),
         "labels": torch.from_numpy(batches[2][0, 0, :1])}
    out = []
    for step in (entropy_sgd.make_train_step(loss, cfg),
                 entropy_sgd.make_sharded_train_step(loss, cfg,
                                                     ReplicaGroup(1)),
                 registry.get("entropy_sgd").make_step(loss, cfg)):
        st = entropy_sgd.init(params_from_numpy(np_params, "cpu"), cfg)
        assert st.x.shape[0] == 1
        for _ in range(L):
            st, m = step(st, b)
        out.append((m["loss"], entropy_sgd.average_model(st)))
    for loss_i, model_i in out[1:]:
        assert torch.equal(loss_i, out[0][0])
        for a, c in zip(jax.tree_util.tree_leaves(model_i),
                        jax.tree_util.tree_leaves(out[0][1])):
            assert torch.equal(a, c)


def test_steps_factories_take_a_group(inputs):
    """``launch/steps.py``'s sharded factories over the trivial group
    equal the single-process ones bit for bit."""
    np_params, batches = inputs
    pcfg = ParleConfig(n_replicas=2, L=L, batches_per_epoch=1)
    algo = registry.get("parle")
    b = {"tokens": torch.from_numpy(batches[2][0]),
         "labels": torch.from_numpy(batches[2][0])}
    out = []
    for fn in (steps.make_algorithm_round("parle", CFG, pcfg),
               steps.make_algorithm_round("parle", CFG, pcfg,
                                          mesh=ReplicaGroup(2))):
        st = algo.init(params_from_numpy(np_params, "cpu"), pcfg)
        st, m = fn(st, b)
        out.append((m["losses"], st.x))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    step = steps.make_algorithm_sharded_step("parle", CFG, pcfg,
                                             ReplicaGroup(2))
    st = algo.init(params_from_numpy(np_params, "cpu"), pcfg)
    st, m = step(st, {k: v[0] for k, v in b.items()})
    assert m["loss_per_replica"].shape == (2,)


# ------------------------------------------------------------------
# the pod against the single-process run
# ------------------------------------------------------------------

@pytest.mark.parametrize("case", K1)
def test_one_replica_a_rank_equals_single_process_bitwise(pod, single,
                                                          case):
    ranks, one = pod[case], single[case]
    np.testing.assert_array_equal(ranks[0]["losses"], one["losses"])
    np.testing.assert_array_equal(ranks[1]["losses"], one["losses"])
    for f, want in one["fields"].items():
        np.testing.assert_array_equal(_assembled(ranks, f), want,
                                      err_msg=f"{case}: final {f}")
    if CASES[case]["mode"] == "step":
        for got, want in zip(ranks[0]["per_replica"], one["per_replica"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", K2)
def test_two_replicas_a_rank(pod, single, case):
    """bf16 / int8 payloads are gathered: bit for bit.  The f32 mean
    (Parle none, Elastic-SGD, SGD) sums the rows in another grouping."""
    ranks, one = pod[case], single[case]
    exact = CASES[case]["compress"] != "none"
    for f, want in one["fields"].items():
        got = _assembled(ranks, f)
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"{case} {f}")
        else:
            assert_sum_order_close(got, want, CASES[case]["algo"],
                                   f"{case} {f}")
    if exact:
        np.testing.assert_array_equal(ranks[0]["losses"], one["losses"])
    else:
        assert_sum_order_close(ranks[0]["losses"], one["losses"],
                               CASES[case]["algo"], f"{case} losses")


@pytest.mark.parametrize("case", [k for k in CASES
                                  if CASES[k]["mode"] == "round"])
def test_pod_matches_reference_rounds(inputs, pod, case):
    """The pod's per-step losses (and, for the f32 sync, its final x or
    params) against the reference's single-process rounds, 1e-4."""
    np_params, batches = inputs
    c = CASES[case]
    kw = dict(n_replicas=c["n"], L=L, lr=0.05, lr_inner=0.05,
              batches_per_epoch=1, sync_compress=c["compress"],
              sync_overlap=c["overlap"])
    rb = [{"tokens": b, "labels": b} for b in batches[c["n"]]]
    ref, ref_losses = ref_rounds(RCFG, np_params, rb, False,
                                 algo=c["algo"], **kw)
    ranks = pod[case]
    assert_close(ranks[0]["losses"], ref_losses, REF_TOL, f"{case} losses")
    if c["compress"] != "none":
        return          # the codecs' flipped codes: test_torch_sync_*.py
    field = "params" if c["algo"] == "sgd" else "x"
    layout = FlatLayout(params_from_numpy(np_params, "cpu"))
    got = tree_map(lambda t: t.numpy(), layout.tree(
        torch.from_numpy(_assembled(ranks, field))))
    for path, p, r in leaf_pairs(got, getattr(ref, field)):
        assert_close(p, r, REF_TOL, f"{case} final {field}{path}")


# ------------------------------------------------------------------
# communication accounting
# ------------------------------------------------------------------

def _m(ranks):
    return ranks[0]["fields"]["x" if "x" in ranks[0]["fields"]
                              else "params"].shape[-1]


def test_compiled_sync_is_single_model_size_all_reduce(pod):
    """Parle: one all-reduce of 4 M bytes a rank a round (the Eq. 8d
    mean), one gather of the (k, L) step losses, nothing in the inner
    steps; the per-step path syncs on the L-th step only."""
    for case in ("parle-none-barrier", "parle-none-overlap",
                 "parle-none-barrier-k2"):
        ranks = pod[case]
        m, k = _m(ranks), CASES[case]["n"] // 2
        for r in ranks:
            for i, counts in enumerate(r["counts"], 1):
                assert counts == {"all_reduce": (i, i * 4 * m),
                                  "all_gather": (i, i * 4 * k * L)}, case
    steps_ = pod["parle-none-step"][0]["counts"]
    m = _m(pod["parle-none-step"])
    for i, counts in enumerate(steps_, 1):
        assert counts.get("all_reduce", (0, 0)) == (i // L, i // L * 4 * m)
        assert counts["all_gather"] == (i, i * 4)     # the step's losses


@pytest.mark.parametrize("case,code_bytes", [
    ("parle-int8-barrier", 1), ("parle-int8-barrier-kernel", 1),
    ("parle-int8-barrier-k2", 1), ("parle-int8-overlap-kernel", 1),
    ("parle-bf16-barrier", 2), ("parle-bf16-overlap", 2)])
def test_compressed_sync_is_one_payload_all_gather(pod, case, code_bytes):
    """bf16 / int8: no all-reduce; one all-gather of the k local payloads
    a round — k M codes (+ k M / 1024 f32 scales for int8) — besides the
    step losses'."""
    ranks = pod[case]
    m, k = _m(ranks), CASES[case]["n"] // 2
    payload = k * m * code_bytes + (4 * k * m // 1024 if code_bytes == 1
                                    else 0)
    for r in ranks:
        for i, counts in enumerate(r["counts"], 1):
            assert counts == {"all_gather": (2 * i,
                                             i * (payload + 4 * k * L))}


def test_communication_amortization_accounting(pod):
    """Paper §4.1: Elastic-SGD and SGD all-reduce the model every step,
    L times Parle's bytes, which all-reduces once a round."""
    parle_bytes = pod["parle-none-barrier"][0]["counts"][0]["all_reduce"][1]
    for case in ("elastic_sgd", "sgd", "elastic_sgd-k2", "sgd-k2"):
        ranks = pod[case]
        m = _m(ranks)
        for r in ranks:
            for i, counts in enumerate(r["counts"], 1):
                assert counts["all_reduce"] == (i * L, i * L * 4 * m), case
        assert ranks[0]["counts"][0]["all_reduce"][1] == L * parle_bytes
