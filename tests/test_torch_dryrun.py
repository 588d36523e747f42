"""The port's dry run (``launch/dryrun.py``): the reference's integration
contract at smoke size on a ``pod:2,data:4,model:2`` mesh (its
``tests/test_dryrun_integration.py``), ``model_flops`` and
``_combine_extrapolated`` against the reference's own functions, the
meta program's FLOPs and argument bytes against the real step's on the
CPU, the predicted collectives against the counters of one real step of
four gloo ranks (and, for a moe replica split over data:2,model:2, its
FLOPs too), and a moe training pair on a data axis (ROADMAP.md item 6a,
once refused) reported on both production meshes."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_ranks
from repro_torch.configs import ARCHS, ParleConfig, get_config, smoke_variant
from repro_torch.core import parle
from repro_torch.launch import dryrun as dr
from repro_torch.launch import specs, steps
from repro_torch.models.model import build_model
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _reference_dryrun():
    """The reference's dryrun module, imported with the process's
    XLA_FLAGS kept: its import sets 512 host devices, and jax reads the
    variable when its backend starts (after this import)."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as ref
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


ref_dr = _reference_dryrun()
from repro.configs import ARCHS as REF_ARCHS  # noqa: E402

TRAIN = dict(kind="train", seq_len=64, global_batch=16)
DECODE = dict(kind="decode", seq_len=128, global_batch=8)


@pytest.fixture(autouse=True)
def options():
    """The dry run's knobs at their defaults, restored after each test."""
    saved = dict(dr.OPTIONS)
    yield dr.OPTIONS
    dr.OPTIONS.update(saved)


def _run(cfg, mesh, shape, **kw):
    return {p.tag: dr.analyze_one(p, 16) for p in
            dr.build_programs(cfg, mesh, shape, **kw)}


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-1.3b"])
def test_multipod_smoke_dryrun(arch):
    """The reference's contract: train lowers and computes, the Parle
    sync moves weight bytes across the pod axis, decode computes."""
    cfg = smoke_variant(get_config(arch))
    mesh = "pod:2,data:4,model:2"
    train = _run(cfg, mesh, TRAIN)
    assert train["train_inner"]["flops_per_device"] > 0
    sync = train["parle_sync"]["collectives"]
    assert sync["bytes"]["pod/all_reduce"] > 0 and \
        sync["total_bytes"] == sync["bytes"]["pod/all_reduce"], sync
    assert _run(cfg, mesh, DECODE)["decode"]["flops_per_device"] > 0


def test_model_flops_match_reference():
    for arch in ARCHS:
        for shape, info in specs.INPUT_SHAPES.items():
            got = dr.model_flops(specs.adapt_for_shape(ARCHS[arch], shape),
                                 info, info["kind"])
            want = ref_dr.model_flops(REF_ARCHS[arch], info, info["kind"])
            assert got == want, (arch, shape)


def _program(tag, flops, nbytes, coll, model_flops=0.0):
    return {"program": tag, "flops_per_device": flops,
            "flops_total": flops * 16, "bytes_accessed_per_device": nbytes,
            "model_flops": model_flops,
            "model_flops_ratio": model_flops / (flops * 16),
            "collectives": {
                "bytes": coll, "total_bytes": sum(coll.values()),
                "counts": {k: 2 + v // 1000 for k, v in coll.items()},
                "links": {k: "network" for k in coll}}}


@pytest.mark.parametrize("L0,L", [(2, 36), (2, 126), (6, 38), (2, 2)])
def test_combine_extrapolated_matches_reference(L0, L):
    small = [_program("train_inner", 1.5e12, 3e9, {"data/all_gather": 7000,
                                                   "pod/all_gather": 4},
                      model_flops=2.0e13),
             _program("parle_sync", 1e6, 2e8, {"pod/all_reduce": 50_000})]
    big = [_program("train_inner", 2.75e12, 5.5e9,
                    {"data/all_gather": 13000, "pod/all_gather": 4},
                    model_flops=4.0e13),
           _program("parle_sync", 1.5e6, 3.1e8, {"pod/all_reduce": 98_000})]
    got = dr._combine_extrapolated(small, big, L0, L, 16)
    want = ref_dr._combine_extrapolated(small, big, L0, L, 16)
    for g, w in zip(got, want):
        for key in ("program", "flops_per_device", "flops_total",
                    "bytes_accessed_per_device", "model_flops",
                    "model_flops_ratio", "accounting"):
            assert g[key] == w[key], key
        for key in ("bytes", "total_bytes", "counts"):
            assert g["collectives"][key] == w["collectives"][key], key
        # the port's roofline: the same arithmetic at the H100's rates
        assert g["roofline"] == dr.roofline_terms(
            g["flops_per_device"], g["bytes_accessed_per_device"],
            g["collectives"])
        assert g["dominant"] == max(g["roofline"], key=g["roofline"].get)


@pytest.mark.parametrize("remat", [False, True])
def test_meta_program_equals_the_real_step(options, remat):
    """FLOPs (the backward and remat's recompute included) and argument
    bytes of the meta train_inner = those of the real inner step on the
    CPU at the same shapes, in one process (n = 2, f32)."""
    options["remat"] = remat
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    rec = _run(cfg, {}, TRAIN, n_replicas=2, precision="f32")["train_inner"]

    pcfg = ParleConfig(n_replicas=2, lr=0.1, lr_inner=0.1)
    inner, _, _ = steps.make_parle_steps(cfg, pcfg, weight_decay=5e-4,
                                         remat=remat)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    state = parle.dealias_state(parle.init(params, pcfg))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 8, 64), dtype=np.int32))
        for k in ("tokens", "labels")}
    held = sum(getattr(state, f).nbytes for f in specs.PARLE_ROW_FIELDS) + \
        sum(t.nbytes for t in batch.values())
    with FlopCounterMode(display=False) as fc:
        inner(state, batch)
    assert rec["flops_per_device"] == fc.get_total_flops() > 0
    assert rec["memory"]["argument_size_bytes"] == held
    assert rec["collectives"]["total_bytes"] == 0


def _predicted(cfg, spec, batch_rows):
    """The dry run's rank-0 train_inner and parle_sync of ``cfg`` on
    ``spec`` (f32, no remat): its counters by axis after each, as one
    rank's cumulative counters read, and train_inner's FLOPs."""
    dr.OPTIONS["remat"] = False
    recs = _run(cfg, spec, dict(TRAIN, global_batch=batch_rows),
                precision="f32")
    want, total = [], {}
    for tag in ("train_inner", "parle_sync"):
        coll = recs[tag]["collectives"]
        for key in coll["bytes"]:
            axis, op = key.split("/")
            calls, nbytes = total.get(axis, {}).get(op, (0, 0))
            total.setdefault(axis, {})[op] = (
                calls + coll["counts"][key], nbytes + coll["bytes"][key])
        want.append({a: dict(ops) for a, ops in total.items()})
    return want, recs["train_inner"]["flops_per_device"]


def test_predicted_collectives_equal_four_ranks(tmp_path):
    """One real train_inner and parle_sync on four gloo ranks of
    replica:2,data:2: every rank's counters by axis and op = the dry
    run's prediction for rank 0."""
    spec = "replica:2,data:2"
    cfg = smoke_variant(get_config("llama3-8b"))
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 8, 64), dtype=np.int32)
             for k in ("tokens", "labels")}
    got = torch_ranks.spawn(torch_ranks.dry_run_counters, 4,
                            os.path.join(tmp_path, "store"), spec,
                            dataclasses.asdict(cfg), batch, False)
    want, _ = _predicted(cfg, spec, 16)
    assert set(want[0]) == {"data", "replica"}         # the step's axes
    assert want[1]["replica"]["all_reduce"][1] > 0     # the sync's mean
    for rank in got:
        assert rank["counts"] == want


def test_moe_split_program_equals_four_ranks(tmp_path):
    """A moe replica split over data:2,model:2 (the batch's one flat
    dispatch, the experts' columns): every rank's counters by axis and
    op after a real train_inner and parle_sync = the dry run's
    prediction for rank 0, and rank 0's train_inner FLOPs = the meta
    program's (about half the one-process step's: the split over
    "model")."""
    spec = "replica:1,data:2,model:2"
    cfg = smoke_variant(get_config("qwen2-moe-a2.7b"))
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, 16, 64), dtype=np.int32)
             for k in ("tokens", "labels")}
    got = torch_ranks.spawn(torch_ranks.dry_run_counters, 4,
                            os.path.join(tmp_path, "store"), spec,
                            dataclasses.asdict(cfg), batch, False)
    want, flops = _predicted(cfg, spec, 16)
    assert {"data", "model"} <= set(want[0])
    assert got[0]["flops"] == flops
    for rank in got:
        assert rank["counts"] == want


def test_moe_training_on_a_data_axis_is_refused(tmp_path):
    """Once refused (ROADMAP.md item 6a), the pair now runs on both
    production meshes: train_inner and parle_sync with their numbers,
    train_inner gathering over "data" (the blocks, and each layer's
    expert counts) and summing over "model"."""
    dr.main(["--arch", "qwen2-moe-a2.7b", "--shape", "train_4k", "--mesh",
             "both", "--out", str(tmp_path)])
    for tag in ("sp", "mp"):
        with open(tmp_path / f"qwen2-moe-a2.7b__train_4k__{tag}.json") as f:
            rec = json.load(f)
        assert "refused" not in rec
        assert [p["program"] for p in rec["programs"]] == [
            "train_inner", "parle_sync"]
        inner = rec["programs"][0]
        assert inner["flops_per_device"] > 0
        keys = set(inner["collectives"]["bytes"])
        assert {"data/all_gather", "model/all_reduce"} <= keys, keys
