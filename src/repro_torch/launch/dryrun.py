"""Multi-pod dry run: every (architecture x input shape) on the
production meshes, one rank's program run once on the ``meta`` device —
nothing is allocated and no kernel is reached.  Port of
``repro/launch/dryrun.py``:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

The meshes are ``launch/mesh.py::PRODUCTION_MESHES``: ``data:16,
model:16`` (one pod, one replica) and ``pod:2,data:16,model:16`` (the
Parle replica axis across two pods).  A record is what rank 0 of the
mesh holds and computes under the PORT's design, which is not the
reference's:

* train programs (``train_inner``, ``parle_sync``; the Parle inner step
  and the sync, as separate programs — the sync's bytes amortize over L
  inner steps): the rank holds its planner blocks of its replicas'
  state (``MeshGroups`` / ``ShardedLayout``) and the replica's whole
  batch; ``train_inner`` gathers the replica's blocks over "data" into
  the rank's column (the replica split over "model" as
  ``models/megatron.py`` says, in every family: its FLOPs about 1/M of
  the replica's), runs the forward and backward over the rank's
  "data" rows, reduce-scatters the grads to its blocks and applies the
  Parle update there; ``parle_sync`` is the mean over the replica axis
  on its blocks (no collective on a mesh of one replica);
* prefill / decode: the rank's "data" rows of the batch and of the cache
  (``cache_pspecs``' "data" entry; its "model" entry is not applied, as
  each model rank computes the whole replica) on full weights.  Under
  ``--moe-impl shard_map`` each MoE block computes the rank's column of
  the experts and sums the columns over "model"
  (``models/moe.py::moe_forward_split`` under a context that splits
  only the experts, ``models/megatron.py``).

Per program it records:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``
  over the meta program (the backward and the recompute ``--remat``
  implies included);
* ``bytes_accessed_per_device``: the inputs plus outputs of every aten
  op the program dispatches (views excluded) — eager and unfused, so
  an upper bound on what a fused program moves; the collectives' host
  staging is not in it;
* ``collectives``: bytes and calls by axis and op (keys ``axis/op``),
  the ``pod.collective_bytes{op, axis}`` counters the program's groups
  add: its ``ReplicaGroup`` / ``MeshGroups`` are dry (rank 0 of no
  world: each collective counted, not run);
* ``memory``: the arguments' bytes (state, batch, cache, params on the
  device), the outputs', the peak of live meta storage above the
  arguments while the program runs (``temp``), and whether arguments +
  temp fit the card's 79.2 GiB;
* ``roofline``: compute, memory and collective seconds at the H100's
  rates (below), and the dominant one.

Every pair runs, moe training on a data axis included (the batch's one
flat dispatch, ``models/moe.py::moe_forward_split``).  The steps take ``use_kernel=False`` and
``use_flash=False``, as the reference's dry run does, so nothing
touches CUDA: this runs on any host.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import weakref
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, ParleConfig, get_config
from repro_torch.core import parle as parle_mod
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import megatron
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import build_model
from repro_torch.obs import Obs
from repro_torch.sharding.partition import (collective_counts_by_axis,
                                            mesh_rank, replica_axis_of)
from repro_torch.sharding.rules import DATA, MODEL
from repro_torch.utils.pytree import tree_map

# ------------------------------------------------------------------
# NVIDIA H100 hardware model (per card)
# ------------------------------------------------------------------
PEAK_FLOPS = 989e12     # bf16 dense tensor cores, FLOP/s (NVIDIA H100 SXM5
                        # 80GB, 700 W, datasheet: 1,979 T with sparsity)
HBM_BW = 3.35e12        # HBM3, bytes/s (NVIDIA H100 SXM5 80GB, 700 W,
                        # datasheet)
NVLINK_BW = 450e9       # NVLink 4, bytes/s a direction (NVIDIA H100 SXM5
                        # 80GB, 700 W, datasheet: 900 GB/s both ways)
NETWORK_BW = 50e9       # one 400 Gb/s ConnectX-7 port a card across nodes
                        # (NVIDIA DGX H100 datasheet)
NODE_CARDS = 8          # cards of a node joined by NVLink (DGX H100)
CARD_BYTES = int(79.2 * 2 ** 30)   # an H100 80GB's memory torch can use
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}

MESH_LABELS = {mesh_lib.PRODUCTION_MESHES["single"]: "16x16",
               mesh_lib.PRODUCTION_MESHES["multi"]: "2x16x16"}

# perf-iteration knobs, as the reference's; set via CLI
OPTIONS = {"policy": "fsdp_tp", "remat": True, "moe_groups": 0,
           "moe_impl": ""}

# archs whose full-depth meta trace takes more than 60 s: their records
# are DEPTH-EXTRAPOLATED — traced at L0 and 2*L0, the per-layer delta
# scaled to the real L (depth-independent parts cancel exactly).  arch ->
# L0.  Measured on one CPU core: musicgen-large's train_4k takes 68-78 s
# and its prefill_32k 115-157 s (32,768 tokens + 64 cond frames split the
# attention's query loop into 513 chunks of 64 a layer, 48 layers); every
# other pair traces at full depth within 48 s (mamba2-1.3b's and
# zamba2-1.2b's prefill_32k are the slowest).
EXTRAPOLATED_ARCHS = {"musicgen-large": 2}

DESIGN_TRAIN = (
    "the replica is split over 'model' (models/megatron.py): "
    "the rank computes its column of each split product on its 'data' "
    "rows, its FLOPs about 1/M of the replica's, temp holding its column "
    "of the row and autograd's grads of its leaves (a module M does not "
    "divide: computed whole on its gathered leaves); "
    "a moe replica on a 'data' axis runs the batch's one flat dispatch, "
    "each rank's expert buffer at the batch's capacity, so up to D times "
    "the rows it can fill (ROADMAP.md item 6g); "
    "the batch argument is the replica's whole batch, of which the rank "
    "takes its 'data' rows")
DESIGN_SERVE = (
    "full weights on every rank; the rank's 'data' rows of the batch and "
    "of the cache (cache_pspecs' 'model' entry not applied: each model "
    "rank computes the whole replica; only training splits it)")
DESIGN_SHARD_MAP = (
    "each MoE block computes the rank's column of the experts, then one "
    "all-reduce over 'model'")
UNFUSED = "bytes accessed: eager, unfused aten ops"


@dataclass
class Program:
    tag: str
    fn: object
    args: tuple
    obs: Obs                      # the registry the dry groups count in
    axes: dict                    # the mesh, a replica axis first
    ep: Optional[object] = None   # the moe expert-parallel context
    notes: tuple = ()


# ------------------------------------------------------------------
# Program builders per input-shape kind
# ------------------------------------------------------------------

def _axes(mesh) -> dict:
    return mesh_lib.with_replica_axis(mesh if mesh else {})


def _moe_cfg(cfg):
    if cfg.family != "moe":
        return cfg
    if OPTIONS["moe_groups"]:
        cfg = dataclasses.replace(cfg, moe_groups=OPTIONS["moe_groups"])
    if OPTIONS["moe_impl"]:
        cfg = dataclasses.replace(cfg, moe_impl=OPTIONS["moe_impl"])
    return cfg


def _expert_parallel(cfg, axes, group):
    """The shard_map dispatch's context on rank 0 of ``axes``: column 0 of
    the "model" axis, summed over the dry group (None: no context)."""
    M = axes.get(MODEL, 1)
    if cfg.family != "moe" or cfg.moe_impl != "shard_map" or M == 1:
        return None
    return megatron.TensorParallel(M, 0, group, experts_only=True)


def _spec(mesh) -> str:
    if isinstance(mesh, str):
        return mesh
    return ",".join(f"{a}:{s}" for a, s in (mesh or {}).items())


def build_train_programs(cfg, mesh, shape_info, n_replicas=None,
                         precision="bf16"):
    """[Program] of the Parle training path: train_inner and parle_sync
    of rank 0, its state and batch on ``meta``."""
    axes = _axes(mesh)
    n = n_replicas or axes[replica_axis_of(axes)]
    pcfg = ParleConfig(n_replicas=n, lr=0.1, lr_inner=0.1,
                       precision=precision)
    obs = Obs()
    group = mesh_lib.dry_groups_from_spec(axes, n, policy=OPTIONS["policy"],
                                          obs=obs)
    inner, sync, _ = steps_lib.make_parle_steps(
        cfg, pcfg, weight_decay=5e-4, remat=OPTIONS["remat"], mesh=group)
    state = parle_mod.init(specs_lib.param_shapes(cfg, torch.float32), pcfg,
                           group)
    k = state.x.shape[0]                       # the rank's replicas
    batch = specs_lib.train_batch_specs(
        cfg, shape_info["seq_len"], shape_info["global_batch"] // n, k,
        pcfg.compute_dtype())
    notes = (DESIGN_TRAIN,)
    return [Program("train_inner", inner, (state, batch), obs, axes,
                    notes=notes),
            Program("parle_sync", sync, (state,), obs, axes, notes=notes)]


def build_serve_program(kind, cfg, mesh, shape_info, precision="bf16"):
    """[Program] of ``kind`` ("prefill" or "decode") for rank 0: its
    "data" rows of the batch and of the cache, on full weights."""
    axes = _axes(mesh)
    gb, T = shape_info["global_batch"], shape_info["seq_len"]
    rows = specs_lib.batch_rows(gb, axes.get(DATA, 1)) or gb
    dtype = ParleConfig(precision=precision).compute_dtype()
    params = specs_lib.param_shapes(cfg, dtype)
    cache = build_model(cfg).init_cache(params, rows, T, dtype)
    obs = Obs()
    group = mesh_lib.dry_groups_from_spec(axes, policy=OPTIONS["policy"],
                                          obs=obs)
    ep = _expert_parallel(cfg, axes, group)
    notes = (DESIGN_SERVE,) + ((DESIGN_SHARD_MAP,) if ep else ())
    if kind == "prefill":
        fn = steps_lib.make_prefill_step(cfg)
        batch = specs_lib.prefill_batch_specs(cfg, T, rows, dtype)
    else:
        decode = steps_lib.make_decode_step(cfg)
        gen = torch.Generator()              # greedy: never drawn from
        fn = lambda p, b, c: decode(p, b, c, generator=gen)  # noqa: E731
        batch = specs_lib.decode_batch_specs(cfg, rows)
    return [Program(kind, fn, (params, batch, cache), obs, axes, ep, notes)]


def moe_block_program(cfg, batch: int, seq: int, mesh,
                      dtype=torch.float32) -> Program:
    """One moe block's forward on (batch, seq, d) tokens, as rank 0 of
    ``mesh`` runs it: under ``cfg.moe_impl == "shard_map"`` its column of
    the experts, summed over "model"."""
    axes = _axes(mesh)
    obs = Obs()
    group = mesh_lib.dry_groups_from_spec(axes, policy=OPTIONS["policy"],
                                          obs=obs)
    params = tree_map(lambda t: t[0].clone(), specs_lib.param_shapes(
        cfg, dtype)["blocks"]["moe"])
    x = torch.empty((batch, seq, cfg.d_model), dtype=dtype, device="meta")
    fn = torch.no_grad()(lambda p, x: moe_mod.moe_forward(p, cfg, x))
    return Program("moe_block", fn, (params, x), obs, axes,
                   _expert_parallel(cfg, axes, group))


def build_programs(cfg, mesh, shape, n_replicas=None, precision="bf16"):
    """The programs of ``shape`` (a name of ``specs.INPUT_SHAPES`` or such
    a dict) for rank 0 of ``mesh`` (a spec or its axis sizes; empty: one
    process).  ``n_replicas``: the train programs' replicas (default:
    the replica axis's size); ``precision``: "bf16" (params, activations
    and Parle's y in bf16, x, z and the momenta f32 masters) or "f32"."""
    if isinstance(shape, str):
        info = specs_lib.INPUT_SHAPES[shape]
        cfg = specs_lib.adapt_for_shape(cfg, shape)
    else:
        info = shape
    cfg = _moe_cfg(cfg)
    if info["kind"] == "train":
        return build_train_programs(cfg, mesh, info, n_replicas, precision)
    return build_serve_program(info["kind"], cfg, mesh, info, precision)


# ------------------------------------------------------------------
# What a program holds, computes and moves
# ------------------------------------------------------------------

def _storages(tree, device: str) -> dict:
    """{storage key: bytes} of the tensors of ``tree`` on ``device``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type == device:
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def device_bytes(tree, device: str = "meta") -> int:
    """The bytes of the distinct storages of ``tree``'s tensors on
    ``device`` (a state's buffers, a batch: what a rank holds)."""
    return sum(_storages(tree, device).values())


class _Meter(TorchDispatchMode):
    """Every aten op's input and output bytes (views excluded), and the
    live bytes of the storages the ops make (freed as their last tensor
    goes: a storage's finalizer), with their peak."""

    def __init__(self, args_keys, device="meta"):
        super().__init__()
        self.device, self.args = device, set(args_keys)
        self.accessed = self.live = self.peak = 0
        self.made: dict = {}

    def _free(self, key, n):
        self.live -= n
        self.made.pop(key, None)

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args or key in self.made:
            return
        n = st.nbytes()
        self.made[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        on = [t for t in tree_leaves(out)
              if isinstance(t, torch.Tensor) and t.device.type == self.device]
        for t in on:
            self._track(t)
        if not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)
                   and t.device.type == self.device]
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in ins + on)
        return out


def _counts(registry) -> dict:
    return {f"{axis}/{op}": tuple(v)
            for axis, ops in collective_counts_by_axis(registry).items()
            for op, v in ops.items()}


def axis_link(axes: dict, label: str) -> str:
    """"nvlink" when the ranks of a collective over ``label`` (its axes,
    comma-joined) lie in one node of NODE_CARDS, else "network"."""
    names = label.split(",")
    span = mesh_rank(axes, {a: axes[a] - 1 for a in names if a in axes}) + 1
    return "nvlink" if span <= NODE_CARDS else "network"


def collectives(before: dict, after: dict, axes: dict) -> dict:
    """The counters a program added: bytes and calls by ``axis/op``, their
    total, and the link each axis rides."""
    keys = sorted(k for k in after if after[k] != before.get(k, (0, 0)))
    calls = {k: after[k][0] - before.get(k, (0, 0))[0] for k in keys}
    nbytes = {k: after[k][1] - before.get(k, (0, 0))[1] for k in keys}
    return {"bytes": nbytes, "total_bytes": sum(nbytes.values()),
            "counts": calls,
            "links": {k: axis_link(axes, k.split("/")[0]) for k in keys}}


def roofline_terms(flops, bytes_accessed, coll) -> dict:
    """Seconds one card needs for each term at the H100's rates: every
    number is per device (one rank's program)."""
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": sum(b / LINK_BW[coll["links"][k]]
                            for k, b in coll["bytes"].items()),
    }


def model_flops(cfg, shape_info, kind: str, n_replicas: int = 1) -> float:
    """Analytic MODEL_FLOPS = 6*N*D (train) / 2*N*D (fwd-only), using
    active params for MoE.  Total across devices."""
    n_active = cfg.active_params()
    gb, T = shape_info["global_batch"], shape_info["seq_len"]
    if kind == "train":
        tokens = gb * T          # global batch is split across replicas
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * gb * T
    return 2.0 * n_active * gb   # decode: one token per sequence


def analyze_one(prog: Program, num_chips: int, mflops=0.0) -> dict:
    """Run ``prog`` once on ``meta`` under the FLOP counter and the meter;
    its record."""
    arg_keys = _storages(prog.args, "meta")
    before = _counts(prog.obs.registry)
    meter = _Meter(arg_keys)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, meter, (
            megatron.tensor_parallel(prog.ep) if prog.ep is not None
            else contextlib.nullcontext()):
        out = prog.fn(*prog.args)
    trace_s = time.perf_counter() - t0
    coll = collectives(before, _counts(prog.obs.registry), prog.axes)
    flops = int(fc.get_total_flops())
    out_keys = {k: v for k, v in _storages(out, "meta").items()
                if k not in arg_keys}
    terms = roofline_terms(flops, meter.accessed, coll)
    arg_bytes = sum(arg_keys.values())
    return {
        "program": prog.tag,
        "trace_s": round(trace_s, 2),
        "flops_per_device": flops,
        "flops_total": flops * num_chips,
        "bytes_accessed_per_device": meter.accessed,
        "model_flops": mflops,
        "model_flops_ratio": (mflops / (flops * num_chips)) if flops
                             else None,
        "collectives": coll,
        "roofline": terms,
        "dominant": max(terms, key=terms.get),
        "memory": {
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": sum(out_keys.values()),
            "temp_size_bytes": meter.peak,
            "fits": arg_bytes + meter.peak <= CARD_BYTES,
        },
        "accounting": "; ".join(("full",) + prog.notes + (UNFUSED,)),
    }


def _combine_extrapolated(rec_small, rec_big, L0, L_target, num_chips):
    """corrected = f(L0) + (L - L0)/L0 * (f(2*L0) - f(L0)), per metric."""
    scale = (L_target - L0) / float(L0)
    out = []
    small = {p["program"]: p for p in rec_small}
    big = {p["program"]: p for p in rec_big}
    for tag, ps in small.items():
        pb = big[tag]
        rec = dict(ps)
        for key in ("flops_per_device", "flops_total",
                    "bytes_accessed_per_device"):
            rec[key] = ps[key] + scale * (pb[key] - ps[key])
        coll = {}
        for kind in ps["collectives"]["bytes"]:
            coll[kind] = ps["collectives"]["bytes"][kind] + scale * (
                pb["collectives"]["bytes"][kind] - ps["collectives"]["bytes"][kind])
        rec["collectives"] = {
            "bytes": coll, "total_bytes": sum(coll.values()),
            "counts": {k: ps["collectives"]["counts"][k] + int(scale * (
                pb["collectives"]["counts"][k] - ps["collectives"]["counts"][k]))
                for k in ps["collectives"]["counts"]},
            "links": ps["collectives"].get("links", {}),
        }
        # the reference keeps f(L0)'s memory; here it scales the same way
        mem = {key: ps["memory"][key] + scale * (
            pb["memory"][key] - ps["memory"][key])
            for key in ("argument_size_bytes", "output_size_bytes",
                        "temp_size_bytes") if key in ps.get("memory", {})}
        if mem:
            mem["fits"] = (mem["argument_size_bytes"]
                           + mem["temp_size_bytes"] <= CARD_BYTES)
            rec["memory"] = mem
        rec["roofline"] = roofline_terms(rec["flops_per_device"],
                                         rec["bytes_accessed_per_device"],
                                         rec["collectives"])
        rec["dominant"] = max(rec["roofline"], key=rec["roofline"].get)
        if rec.get("model_flops"):
            rec["model_flops_ratio"] = rec["model_flops"] / rec["flops_total"]
        rec["accounting"] = "; ".join(
            [f"depth_extrapolated(L0={L0})"]
            + ps.get("accounting", "").split("; ")[1:])
        out.append(rec)
    return out


def run_pair(arch: str, shape_name: str, multi_pod: bool, verbose=True,
             mesh: Optional[str] = None):
    """The record of (``arch``, ``shape_name``) on the production mesh
    (``mesh``: another spec)."""
    cfg = get_config(arch)
    spec = mesh or mesh_lib.production_mesh_spec(multi_pod)
    num_chips = mesh_lib.mesh_size(spec)
    info = specs_lib.INPUT_SHAPES[shape_name]
    out = {"arch": arch, "shape": shape_name,
           "mesh": MESH_LABELS.get(spec, spec), "mesh_spec": spec,
           "num_chips": num_chips, "programs": []}
    extrapolate = arch in EXTRAPOLATED_ARCHS
    L0 = EXTRAPOLATED_ARCHS.get(arch, 2)
    if extrapolate:
        recs = {}
        for L in (L0, 2 * L0):
            c = dataclasses.replace(cfg, num_layers=L)
            mf = model_flops(c, info, info["kind"])
            recs[L] = [analyze_one(p, num_chips, mflops=(
                mf if p.tag != "parle_sync" else 0.0))
                for p in build_programs(c, spec, shape_name)]
        combined = _combine_extrapolated(recs[L0], recs[2 * L0], L0,
                                         cfg.num_layers, num_chips)
        # model_flops must reflect the REAL depth
        for rec in combined:
            if rec.get("model_flops"):
                rec["model_flops"] = model_flops(cfg, info, info["kind"])
                rec["model_flops_ratio"] = (rec["model_flops"] /
                                            rec["flops_total"])
        out["programs"] = combined
    else:
        for p in build_programs(cfg, spec, shape_name):
            mf = (model_flops(cfg, info, info["kind"])
                  if p.tag != "parle_sync" else 0.0)
            out["programs"].append(analyze_one(p, num_chips, mflops=mf))
    if verbose:
        for rec in out["programs"]:
            print(roofline_line(out, rec), flush=True)
    return out


def roofline_line(pair: dict, rec: dict) -> str:
    r, m = rec["roofline"], rec["memory"]
    gib = (m["argument_size_bytes"] + m["temp_size_bytes"]) / 2 ** 30
    return (f"  [{pair['mesh']}] {pair['arch']} x {pair['shape']} :: "
            f"{rec['program']}: compute {r['compute_s']:.3e}s  mem "
            f"{r['memory_s']:.3e}s  coll {r['collective_s']:.3e}s  -> "
            f"{rec['dominant']}  ({gib:.1f} GiB a card, fits "
            f"{m['fits']}; trace {rec['trace_s']}s, "
            f"{rec['accounting'].split(';')[0]})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(specs_lib.INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--policy", default="fsdp_tp",
                    choices=["fsdp_tp", "tp_only", "dp_only"],
                    help="weight sharding policy (§Perf knob)")
    ap.add_argument("--remat", default="full", choices=["full", "dots", "none"],
                    help="activation checkpoint policy (§Perf knob)")
    ap.add_argument("--tag", default="", help="suffix for result files")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip pairs whose result JSON already exists")
    ap.add_argument("--moe-groups", type=int, default=0,
                    help="GShard grouped MoE dispatch (§Perf knob)")
    ap.add_argument("--moe-impl", default="",
                    choices=["", "pjit", "shard_map"],
                    help="MoE dispatch implementation (§Perf knob)")
    args = ap.parse_args(argv)
    OPTIONS["moe_groups"] = args.moe_groups
    OPTIONS["moe_impl"] = args.moe_impl
    OPTIONS["policy"] = args.policy
    OPTIONS["remat"] = {"full": True, "dots": "dots", "none": False}[args.remat]

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = (list(specs_lib.INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                if args.tag:
                    tag += f"__{args.tag}"
                if args.skip_existing and os.path.exists(
                        os.path.join(args.out, tag + ".json")):
                    print(f"  skip {tag} (exists)", flush=True)
                    continue
                try:
                    rec = run_pair(arch, shape, mp)
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(rec, f, indent=1)
                except Exception as e:  # noqa: BLE001 — report, keep sweeping
                    print(f"  FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                    failures.append((tag, str(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        sys.exit(1)
    print("\nALL DRY-RUNS PASSED")


if __name__ == "__main__":
    main()
