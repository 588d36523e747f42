"""Checkpoint and resume under a composed mesh (axes inside a replica):
the port's counterpart of tests/test_checkpoint_sharded.py, with the
train CLI's ``--checkpoint-dir`` / ``--resume`` under ``--mesh
replica:R,data:D,model:M`` (``torch_ranks.spawn``: gloo ranks, spawned
once a world for the module), on the CPU, ``--round-fused``, L = 2,
checkpoints every 2 steps, at smoke width in two families
(``runs`` is parametrized): Qwen2.5-3B (dense: heads, ff, embedding
and head) and Mamba2-1.3B (ssm: the SSD heads of the Mamba2 mixer, its
embedding and head).  Under "model" either replica is split
(``models/megatron.py``), its sums in another order, so a run or a file
under "model" is held to one process within the reference's
composed-mesh bounds (rtol 2e-5 on losses, rtol 2e-5 / atol 2e-6 on the
state), and a resume under the same split mesh to the uninterrupted
split run bit for bit.

Where "bit for bit" stands below against one process, those bounds
hold.

1. The reference's contract: 3 steps under replica:2,data:2,model:2
   (eight ranks, crossing an L = 2 sync), saved, restored onto
   replica:2,data:4: the deployable model equals the saved one exactly,
   one more step gives a finite loss, and a wrong ``algo`` stamp raises
   ValueError.
2. The file is the reference's: under replica:2,model:2 (f32) its leaves
   equal the one-process file's of the same step byte for byte, the
   reference's ``restore`` reads it into its Parle template, and a
   reference-written file resumes under the composed mesh.
3. Resume across shapes, f32: a replica:2,model:2 file resumes in one
   process, under pod:2 and under replica:2,model:2 bit for bit with the
   uninterrupted run; a pod:2 file resumes under replica:2,model:2 bit for
   bit and under replica:2,data:2 within the reference's composed-mesh
   bound (rtol 2e-5: the data split sums each grad in two halves).
4. int8 + overlap (``e`` and ``c`` in the file): resumed under the same
   mesh the run continues bit for bit; resumed in one process within the
   bound ``tests/test_torch_fsdp_tp.py`` measured for composed int8
   (losses 1.15e-4 relative: the int8 chunks follow each mesh's blocks).
5. Elastic-SGD and SGD, saved under replica:2,model:2, resume in one
   process bit for bit.
6. A checkpoint is one gather a rank on each axis it crosses: the
   in-replica stage of the bytes of the rank's blocks, the replica stage
   (the replica's first in-replica rank) of its whole rows.
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
from repro_torch.checkpoint.checkpoint import _members
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.launch.mesh import parse_mesh_spec
from repro_torch.models import megatron
from repro_torch.models.model import build_model
from repro_torch.sharding import planner
from repro_torch.sharding.partition import mesh_coords
from repro_torch.utils.pytree import ShardedLayout
from torch_parity import numpy_params
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCH_UNDER_TEST = ("qwen2.5-3b", "mamba2-1.3b")


def _base(arch):
    return ["--arch", arch, "--smoke", "--device", "cpu", "--L", "2",
            "--batch", "2", "--seq", "32", "--round-fused", "--log-every",
            "2", "--seed", "0"]


BASE = _base("qwen2.5-3b")
RM, RD = "replica:2,model:2", "replica:2,data:2"
COMPOSED_TOL = dict(rtol=2e-5)          # the reference's loss bound
STATE_TOL = dict(rtol=2e-5, atol=2e-6)  # ... and its deployable's
INT8_TOL = dict(rtol=5e-4)              # test_torch_fsdp_tp.py's int8 bound
ROW_FIELDS = ("x", "y", "z", "v_y", "v_x")


def _argvs(arch):
    f32 = _base(arch) + ["--replicas", "2"]
    return {"f32": f32,
            "int8": f32 + ["--sync-compress", "int8", "--sync-overlap",
                           "--use-kernel"],
            "el": f32 + ["--algo", "elastic_sgd", "--use-kernel"],
            "sgd": f32 + ["--algo", "sgd"]}


def _same(arch, got, want, tol=COMPOSED_TOL, what="", show=True):
    """``got`` = ``want`` within ``tol`` (``arch``'s replica split over
    "model": its sums in another order), printing the error unless not
    ``show``; the max abs err."""
    assert megatron.splits_family(ARCHS[arch])
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    if show:
        print(f"[ckpt_mesh] {arch} {what}: max abs err {err:.3e}")
    np.testing.assert_allclose(got, want, err_msg=what, **tol)
    return err


def _argv(base, steps, mesh=None, ckpt=None, resume=None):
    argv = base + ["--steps", str(steps)]
    if mesh:
        argv += ["--mesh", mesh]
    if ckpt:
        argv += ["--checkpoint-dir", ckpt, "--checkpoint-every", "2"]
    if resume:
        argv += ["--resume", resume]
    return argv


def _step2(d):
    return f"{d}/step000002.npz"


def _pod(jobs, world, store):
    """{name: [each rank's train_cli result]} of ``jobs`` on ``world``
    spawned ranks."""
    per_rank = torch_ranks.spawn(torch_ranks.train_cli_jobs, world, store,
                                 jobs)
    return {k: [r[k] for r in per_rank] for k in jobs}


@pytest.fixture(scope="module", params=ARCH_UNDER_TEST)
def runs(request, tmp_path_factory):
    """{name: [each rank's result]} of the composed and pod jobs, {name:
    result} of the one-process jobs, the directories written, and the
    arch."""
    arch = request.param
    a = _argvs(arch)
    F32, INT8, EL, SGD = a["f32"], a["int8"], a["el"], a["sgd"]
    d = tmp_path_factory.mktemp("ckpt_mesh")
    dirs = {k: str(d / k) for k in ("one", "pod", "rm", "int8", "el",
                                    "sgd", "ref")}
    one = {"f32": torch_ranks.train_cli(_argv(F32, 4, ckpt=dirs["one"]))}
    # a reference-written checkpoint of the same state: the one-process
    # port file at step 2, through the reference's restore and save
    ref_ckpt.save(_step2(dirs["ref"]), ref_ckpt.restore(
        _step2(dirs["one"]), _ref_like(arch), algo="parle"), step=2,
        algo="parle")
    pod = _pod({"f32": _argv(F32, 4, "pod:2", ckpt=dirs["pod"])}, 2,
               str(d / "store2"))
    mesh = _pod({
        "f32": _argv(F32, 4, RM, ckpt=dirs["rm"]),
        "f32_resume": _argv(F32, 2, RM, resume=_step2(dirs["rm"])),
        "from_pod": _argv(F32, 2, RM, resume=_step2(dirs["pod"])),
        "from_ref": _argv(F32, 2, RM, resume=_step2(dirs["ref"])),
        "data_from_pod": _argv(F32, 2, RD, resume=_step2(dirs["pod"])),
        "int8": _argv(INT8, 4, RM, ckpt=dirs["int8"]),
        "int8_resume": _argv(INT8, 2, RM, resume=_step2(dirs["int8"])),
        "el": _argv(EL, 4, RM, ckpt=dirs["el"]),
        "sgd": _argv(SGD, 4, RM, ckpt=dirs["sgd"]),
    }, 4, str(d / "store4"))
    pod.update(_pod({"from_rm": _argv(F32, 2, "pod:2",
                                      resume=_step2(dirs["rm"]))},
                    2, str(d / "store2b")))
    for name, base, src in (("f32_resume", F32, "rm"),
                            ("int8_resume", INT8, "int8"),
                            ("el_resume", EL, "el"),
                            ("sgd_resume", SGD, "sgd")):
        one[name] = torch_ranks.train_cli(_argv(base, 2,
                                                resume=_step2(dirs[src])))
    return mesh, pod, one, dirs, arch


def _ref_like(arch):
    rcfg = ref_smoke_variant(REF_ARCHS[arch])
    return ref_parle.dealias_state(ref_registry.get("parle").init(
        jax.tree.map(jnp.asarray, numpy_params(rcfg)),
        RefParleConfig(n_replicas=2, L=2)))


def _layouts(arch, mesh):
    """Each in-replica rank's ShardedLayout of the smoke model under
    ``mesh``, in rank order."""
    axes = parse_mesh_spec(mesh)
    inner = {a: s for a, s in axes.items() if a != "replica"}
    params = planner.meta_params(build_model(smoke_variant(ARCHS[arch])))
    ctx = planner.ShardContext(inner)
    coords = [dict(zip(inner, idx)) for idx in np.ndindex(*inner.values())]
    return [ShardedLayout(params, ctx, coords, i) for i in range(len(coords))]


def _whole(arch, ranks, mesh, f="x"):
    """The (R, M) FlatLayout rows of field ``f`` (k = 1 row a replica
    index) from the ranks' blocks."""
    lay = _layouts(arch, mesh)[0]
    axes = parse_mesh_spec(mesh)
    rows = []
    for rep in range(axes["replica"]):
        blocks = np.concatenate([
            np.atleast_2d(r["fields"][f]) for i, r in enumerate(ranks)
            if mesh_coords(axes, i)["replica"] == rep])
        full = torch.zeros(lay.full.numel)
        lay.gather_into(torch.from_numpy(blocks), full)
        rows.append(full.numpy())
    return np.stack(rows)


def _resumed(got_losses, got_eval, full_losses, full_eval, arch=None):
    """Steps 3-4 and the eval loss of a run resumed at step 2 = the
    uninterrupted run's: bit for bit, or (given ``arch``: the two runs
    on different meshes, one split) within the composed-mesh bound."""
    if arch is None:
        np.testing.assert_array_equal(got_losses, full_losses[2:])
        assert got_eval == full_eval
        return
    _same(arch, got_losses, full_losses[2:], what="resumed losses")
    _same(arch, got_eval, full_eval, what="resumed eval loss")


def test_reference_contract_across_mesh_shapes(tmp_path):
    """Saved at step 3 under replica:2,data:2,model:2 (eight ranks, one
    L = 2 sync crossed), restored onto replica:2,data:4: every rank's
    deployable equals the saved one exactly, one more step's loss is
    finite, and the wrong algo stamp raises ValueError."""
    argv = BASE + ["--replicas", "2", "--steps", "3", "--mesh",
                   "replica:2,data:2,model:2", "--checkpoint-dir",
                   str(tmp_path / "ck"), "--checkpoint-every", "3"]
    argv.remove("--round-fused")
    per_rank = torch_ranks.spawn(torch_ranks.checkpoint_contract, 8,
                                 str(tmp_path / "store"), argv,
                                 "replica:2,data:4")
    for r in per_rank:
        assert r["saved"].keys() == r["deploy"].keys()
        for k, v in r["saved"].items():
            np.testing.assert_array_equal(r["deploy"][k], v, err_msg=k)
        assert np.isfinite(r["loss"])
        assert r["refused"]
    assert len({r["coords"]["data"] for r in per_rank}) == 4


def test_composed_file_is_the_one_process_file(runs):
    """replica:2,model:2 in f32: the file's leaves (keys, shapes, dtypes;
    bytes, or a split replica's values within the composed-mesh bound)
    equal the one-process file's of the same step, and the reference's
    restore reads it into its Parle template."""
    _, _, _, dirs, arch = runs
    for step in (2, 4):
        name = f"step{step:06d}.npz"
        err = 0.0
        with np.load(f"{dirs['rm']}/{name}") as got, \
                np.load(f"{dirs['one']}/{name}") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].shape == want[k].shape, k
                err = max(err, _same(arch, got[k], want[k], STATE_TOL,
                                     f"step {step} {k}", show=False))
                if k.startswith("x/"):
                    assert got[k].shape[0] == 2
        print(f"[ckpt_mesh] {arch} step {step} file: max abs err {err:.3e}")
        back = ref_ckpt.restore(f"{dirs['rm']}/{name}", _ref_like(arch),
                                algo="parle")
        with np.load(f"{dirs['rm']}/{name}") as got:
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    back._asdict()):
                key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                            p)))
                               for p in path)
                np.testing.assert_array_equal(np.asarray(leaf), got[key])
    assert set(_members(_step2(dirs["rm"]))) == set(
        _members(_step2(dirs["one"])))


def test_reference_file_resumes_under_a_composed_mesh(runs):
    """The reference-written file (the one-process state at step 2)
    resumed under replica:2,model:2 = the composed file resumed there
    (a split replica: within the composed-mesh bounds, the two files'
    states differing by them)."""
    mesh, _, _, _, arch = runs
    for got, want in zip(mesh["from_ref"], mesh["f32_resume"]):
        _same(arch, got["losses"], want["losses"], what="losses")
        _same(arch, got["eval_loss"], want["eval_loss"], what="eval loss")
        for f in want["fields"]:
            _same(arch, got["fields"][f], want["fields"][f], STATE_TOL, f)


@pytest.mark.parametrize("where", ["one", "pod:2", RM])
def test_composed_file_resumes_bit_for_bit(runs, where):
    """From the replica:2,model:2 file at step 2: the losses of steps 3-4,
    the eval loss and the final x rows equal the uninterrupted
    one-process run's (a split replica: within the composed-mesh bounds;
    resumed under replica:2,model:2 itself, the uninterrupted split
    run's bit for bit)."""
    mesh, pod, one, _, arch = runs
    full = one["f32"]
    if where == "one":
        got = one["f32_resume"]
        _resumed(got["losses"], got["eval_loss"], full["losses"],
                 full["eval_loss"], arch)
        _same(arch, got["fields"]["x"], full["fields"]["x"], STATE_TOL, "x")
    elif where == "pod:2":
        for rank, got in enumerate(pod["from_rm"]):
            _resumed(got["losses"], got["eval_loss"], full["losses"],
                     full["eval_loss"], arch)
            _same(arch, got["fields"]["x"],
                  full["fields"]["x"][rank:rank + 1], STATE_TOL, "x")
    else:
        for got, want in zip(mesh["f32_resume"], mesh["f32"]):
            _resumed(got["losses"], got["eval_loss"], want["losses"],
                     want["eval_loss"])
            np.testing.assert_array_equal(got["fields"]["x"],
                                          want["fields"]["x"])
        _same(arch, _whole(arch, mesh["f32_resume"], RM),
              full["fields"]["x"], STATE_TOL, "x")
    # the uninterrupted composed run is the one-process run
    for got in mesh["f32"]:
        _same(arch, got["losses"], full["losses"], what="losses")


def test_pod_file_resumes_under_composed_meshes(runs):
    """The pod:2 file at step 2 under replica:2,model:2: bit for bit (a
    split replica: within the bounds); under replica:2,data:2: within
    the reference's composed-mesh bound."""
    mesh, pod, one, _, arch = runs
    full = one["f32"]
    np.testing.assert_array_equal(pod["f32"][0]["losses"], full["losses"])
    for got in mesh["from_pod"]:
        _resumed(got["losses"], got["eval_loss"], full["losses"],
                 full["eval_loss"], arch)
    _same(arch, _whole(arch, mesh["from_pod"], RM), full["fields"]["x"],
          STATE_TOL, "x")
    for got in mesh["data_from_pod"]:
        rel = np.abs(got["losses"] / full["losses"][2:] - 1).max()
        print(f"[ckpt_mesh] {arch} pod:2 file under {RD}: losses max rel "
              f"err {rel:.3e}")
        np.testing.assert_allclose(got["losses"], full["losses"][2:],
                                   **COMPOSED_TOL)
        np.testing.assert_allclose(got["eval_loss"], full["eval_loss"],
                                   **COMPOSED_TOL)


def test_int8_overlap_round_trips_and_continues(runs):
    """int8 + overlap under replica:2,model:2: the file carries ``e`` and
    ``c``; resumed under the same mesh the run is the uninterrupted one
    bit for bit (losses, eval, final x, e and c blocks); resumed in one
    process, within the composed-int8 bound."""
    mesh, _, one, dirs, arch = runs
    with np.load(_step2(dirs["int8"])) as f:
        fields = {k.split("/")[0] for k in f.files}
    assert {"e", "c"} <= fields
    full = mesh["int8"]
    for got, want in zip(mesh["int8_resume"], full):
        _resumed(got["losses"], got["eval_loss"], want["losses"],
                 want["eval_loss"])
        for f in ("x", "e", "c"):
            np.testing.assert_array_equal(got["fields"][f],
                                          want["fields"][f], err_msg=f)
    got = one["int8_resume"]
    rel = np.abs(got["losses"] / full[0]["losses"][2:] - 1).max()
    print(f"[ckpt_mesh] {arch} int8 file resumed in one process: losses "
          f"max rel err {rel:.3e}")
    np.testing.assert_allclose(got["losses"], full[0]["losses"][2:],
                               **INT8_TOL)


@pytest.mark.parametrize("algo", ["el", "sgd"])
def test_baselines_saved_under_the_mesh_resume_in_one(runs, algo):
    """Elastic-SGD and SGD saved under replica:2,model:2 at step 2,
    resumed in one process: the uninterrupted composed run's steps 3-4,
    eval loss and final model bit for bit (a split replica: within the
    composed-mesh bounds)."""
    mesh, _, one, _, arch = runs
    full, got = mesh[algo], one[f"{algo}_resume"]
    _resumed(got["losses"], got["eval_loss"], full[0]["losses"],
             full[0]["eval_loss"], arch)
    if algo == "el":
        _same(arch, got["fields"]["x"], _whole(arch, full, RM, "x"),
              STATE_TOL, "x")
    else:               # every replica holds the one model
        for row in _whole(arch, full, RM, "params"):
            _same(arch, got["fields"]["params"], row, STATE_TOL, "params")


def test_a_checkpoint_is_one_gather_a_rank_on_each_axis(runs):
    """Two checkpoints (steps 2 and 4) under replica:2,model:2: each rank
    makes one in-replica ("model") gather a checkpoint, of its blocks of
    the five row fields (and, in replica 0, of the rest: none in f32
    Parle); the replica's first rank one replica-axis gather of its
    whole rows; no other rank crosses the replica axis for it."""
    mesh, _, _, _, arch = runs
    lays = _layouts(arch, RM)
    full = 4 * sum(lays[0].full.sizes) * len(ROW_FIELDS)
    axes = parse_mesh_spec(RM)
    for rank, r in enumerate(mesh["f32"]):
        c = mesh_coords(axes, rank)
        blocks = 4 * sum(lays[c["model"]].sizes) * len(ROW_FIELDS)
        assert r["counts"]["gather"][0] == 2 * (1 + (c["model"] == 0))
        gathers = {a: ops["gather"] for a, ops in r["by_axis"].items()
                   if "gather" in ops}
        assert gathers["model"] == (2, 2 * blocks)
        if c["model"] == 0:
            assert gathers["replica"] == (2, 2 * full)
        else:
            assert "replica" not in gathers
