"""Multi-process pod launcher: N real worker processes on one machine,
under either of two runtime sync policies.  Port of
``repro/launch/dist_run.py``.

``--sync-policy barrier`` (default) — each worker a rank of a
``torch.distributed`` world on gloo:

    PYTHONPATH=src python -m repro_torch.launch.dist_run --nproc 2 \\
        --smoke --steps 6 --L 3 --device cpu

Worker i of ``--nproc`` N is rank i of the ``pod:N`` replica axis
(``launch/mesh.py``): it holds replicas [i k, (i + 1) k) of the n
(``--replicas``, default N; k = n / N) and runs the algorithm's sharded
step (``core/algorithm.py``: Parle's sync is one model-size all-reduce
every L steps, Elastic-SGD's and SGD's one every step) through the
runtime's ``RoundRunner``.  The parent then runs the single-process
reference — the same config, all n replicas in one process — and
compares the two loss streams BIT FOR BIT (float hex, not allclose):
with one replica a rank the cross-process all-reduce sums the rows in
the single-process order, so the pod must reproduce it exactly.

A composed spec runs too, as the reference's does (``--mesh
pod:2,data:2``, ``replica:2,model:2``): one process a rank, so
``--nproc`` is the product of the spec's sizes, and each worker joins
the rank's ``MeshGroups`` (``sharding/partition.py``: its blocks of
every state leaf, a replica's weights gathered for its forward, its
grads reduce-scattered over "data").  Under "model" alone (f32) every
rank computes its replica on the one-process row, so the verdict is bit
for bit; a "data" axis sums each grad in two halves of the batch, so
pass ``--tol`` (the reference's composed-mesh bound is 2e-5).  The train
CLI's refusals on such a mesh hold here: a moe architecture with "data"
above 1 (ROADMAP.md item 6a) and ``--sync-policy async`` (item 6d).

    PYTHONPATH=src python -m repro_torch.launch.dist_run --nproc 4 \\
        --mesh replica:2,model:2 --smoke --steps 6 --L 3 --device cpu

``--use-kernel`` runs the updates through the CUDA kernels (K1 / K2,
Elastic-SGD's K7; their plain versions on the CPU), and each worker's
``--metrics-out`` then carries its launches of each
(``pod.kernel_launches{kernel, worker}``) beside its peak device memory.

On CUDA (``--device cuda``, the default, as the train CLI's) the ranks
share the card or cards of the machine and stage every collective
through pinned host memory (``sharding/partition.py``).  Each worker,
and the reference run, trains under
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``: without them the embedding and
cross-entropy backwards accumulate with atomics, and no two runs (pod
or not) are bit for bit equal.

``--sync-policy async`` — asynchronous/ELASTIC replica execution: no
process group, no barrier.  Each worker owns replicas [i k, (i + 1) k)
of the fleet (k = replicas / nproc), runs inner-only rounds (Eq. 8a-8b)
at its own pace, and after ITS round pushes its quantized ``x+e``
contribution to the parent's consensus ``Coordinator``
(``runtime/coordinator.py``), pulling back the staleness-weighted mean
(``core/parle.py::staleness_weighted_mean``).  A straggler delays
nobody: the only wait is the exchange RPC, measured per worker as
``pod.sync_wait_ms``.  Workers may join and leave mid-run (a dead
worker is an implicit leave); ``--checkpoint-out`` / ``--resume`` let a
pod stop and resume with a DIFFERENT worker count, and ``--fault-plan``
replays a seeded chaos script (``runtime/faults.py``):

    PYTHONPATH=src python -m repro_torch.launch.dist_run --nproc 3 \\
        --sync-policy async --smoke --steps 9 --L 3 --device cpu \\
        --straggle-ms 300 --straggle-worker 2

The parent never touches the card (the coordinator is numpy on the
host); the workers run on ``--device``.  The parent hands the workers
its resolved model config as JSON (``--_config``), so :func:`main` can
run a pod at any config, such as a full-width model cut in depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ParleConfig, get_config, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parle, registry
from repro_torch.core.algorithm import validate_replicas
from repro_torch.core.parle import dealias_state
from repro_torch.data.synthetic import (TokenStream, make_round_batch_fn,
                                        replica_batches)
from repro_torch.kernels import parle_update
from repro_torch.launch.mesh import (groups_from_spec, inner_axes, mesh_size,
                                     parse_mesh_spec, replica_axis)
from repro_torch.launch.train import check_in_replica
from repro_torch.models.model import build_model
from repro_torch.obs import EventSink, Obs, merge_snapshots, read_events
from repro_torch.runtime import (CRASH_RC, AsyncElasticPolicy,
                                 CoordinatorClient, CoordinatorSupervisor,
                                 FaultPlan, RoundRunner, consensus_digest,
                                 load_consensus)
from repro_torch.runtime.precision import pin_float32

LOSS_TAG = "DISTLOSS "
START_WINDOW_S = 120.0      # async: how long a worker waits for its peers
# async: seconds of the coordinator's host work an exchange per GB of the
# f32 consensus (receive, dequantize, norm, fold, checkpoint, reply):
# 8.7 measured on an H100 host at Qwen2.5-3B cut to 4 layers
# (tools/coordinator_timing.py, PERF.md §5), with a third more for noise
EXCHANGE_S_PER_GB = 12.0
SRC = str(Path(__file__).resolve().parents[2])     # the port's src/ dir


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2,
                    help="number of processes (ranks) of the pod")
    ap.add_argument("--mesh", default="",
                    help="mesh spec (default 'pod:<nproc>'), e.g. "
                         "'replica:2,model:2'; it must span --nproc "
                         "ranks, one a process")
    ap.add_argument("--algo", default="parle")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every rank trains (no silent fallback to "
                         "the CPU)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="0 = the mesh replica-axis size")
    ap.add_argument("--L", type=int, default=3)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=2, help="per-replica batch")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="barrier: the updates through the CUDA kernels "
                         "(K1 / K2, Elastic-SGD's K7); the reference run "
                         "too")
    ap.add_argument("--port", type=int, default=9876,
                    help="TCP port of the torch.distributed rendezvous")
    ap.add_argument("--sync-policy", default="barrier",
                    choices=("barrier", "async"),
                    help="barrier: bulk-synchronous pod (bit for bit vs "
                         "the single-process run); async: elastic "
                         "per-worker rounds + staleness-weighted "
                         "consensus via the host coordinator")
    ap.add_argument("--sync-compress", default="none",
                    choices=("none", "bf16", "int8"),
                    help="async contribution codec (the x+e payload "
                         "each worker pushes; error feedback rides the "
                         "worker state)")
    ap.add_argument("--decay", type=float, default=0.5,
                    help="async staleness decay: a contribution r rounds "
                         "behind the freshest weighs count * decay**r")
    ap.add_argument("--coord-port", type=int, default=0,
                    help="consensus coordinator port (async; default "
                         "--port + 1)")
    ap.add_argument("--straggle-ms", type=float, default=0.0,
                    help="inject this per-round delay into "
                         "--straggle-worker (straggler-tolerance probe)")
    ap.add_argument("--straggle-worker", type=int, default=-1)
    ap.add_argument("--checkpoint-out", default="",
                    help="async: checkpoint the final consensus (+ "
                         "per-worker contribution stamps) here")
    ap.add_argument("--resume", default="",
                    help="async: resume the consensus from a "
                         "--checkpoint-out file OR a checkpoint "
                         "directory (resolves to its newest valid "
                         "checkpoint; a corrupt file falls back to the "
                         "newest valid sibling); the worker count may "
                         "differ from the writing pod's")
    ap.add_argument("--fault-plan", default="",
                    help="chaos harness: a seeded FaultPlan as inline "
                         "JSON or @file (runtime/faults.py) — scripted "
                         "worker crash/hang/drop/corrupt/poison/jitter "
                         "faults plus coordinator kills, replayed "
                         "deterministically from the plan seed")
    ap.add_argument("--liveness-s", type=float, default=30.0,
                    help="async: coordinator heartbeat-liveness "
                         "deadline; a worker silent this long is "
                         "evicted from the consensus table")
    ap.add_argument("--no-compare", action="store_true",
                    help="skip the single-process reference run")
    ap.add_argument("--tol", type=float, default=0.0,
                    help="relative loss tolerance for the comparison; "
                         "0 (default) = bit for bit (more than one replica "
                         "a rank sums the sync mean in another grouping)")
    ap.add_argument("--metrics-out", default="",
                    help="pod metrics JSONL: each worker writes "
                         "<path>.worker<i>; the parent merges the "
                         "per-process registry snapshots into <path> "
                         "as a pod_merged event")
    ap.add_argument("--trace-out", default="",
                    help="pod Chrome trace: workers write "
                         "<path>.worker<i>; the parent concatenates "
                         "them into <path> (one pid per process)")
    ap.add_argument("--_worker", type=int, default=-1,
                    help="(internal) worker index; set by the parent")
    ap.add_argument("--_config", default="",
                    help="(internal) the model config's fields as JSON; "
                         "set by the parent")
    return ap


def _mesh_spec(args) -> str:
    return args.mesh or f"pod:{args.nproc}"


_mesh_size = mesh_size      # the reference's name


def _model_config(args):
    """The model config the parent resolved (``--_config``), else the
    one ``--arch`` / ``--smoke`` name."""
    if args._config:
        return ModelConfig(**json.loads(args._config))
    cfg = get_config(args.arch)
    return smoke_variant(cfg) if args.smoke else cfg


def _maybe_fail_for_test(worker: int):
    """Orphan-handling test hook: REPRO_TEST_FAIL_WORKER=<i> makes
    worker i die with rc 41 right after joining the process group — its
    peers then wait in their first collective, which is the wedge the
    parent's process-group kill must break."""
    if os.environ.get("REPRO_TEST_FAIL_WORKER", "") == str(worker):
        sys.stderr.write(f"worker {worker}: injected test failure\n")
        sys.exit(41)


def run_worker(args) -> list:
    """One process of the barrier pod: join the process group (when
    nproc > 1), build the sharded step over this rank's replicas (its
    blocks of them under a composed spec), and hand the step stream to
    the runtime's ``RoundRunner``.  Emits bit-exact losses (proc 0
    only).  With nproc 1 it is the single-process reference: the local
    step over all n replicas."""
    if args.device == "cuda":
        # cuBLAS reads this once, at its first use (still ahead)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.use_deterministic_algorithms(True)
    pin_float32()
    proc = args._worker
    if args.nproc > 1:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{args.port}",
                                rank=proc, world_size=args.nproc)
    _maybe_fail_for_test(proc)

    # each worker writes its own telemetry files (the parent passed
    # per-worker paths); the trace pid is the rank, one lane a process
    obs = Obs(args.metrics_out, args.trace_out, pid=proc,
              process_name=f"pod-worker{proc}")
    cfg = _model_config(args)
    check_in_replica(args)
    model = build_model(cfg)
    algo = registry.get(args.algo)
    spec = _mesh_spec(args)
    axis, size = replica_axis(spec)
    pcfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=args.replicas or size, L=args.L, lr=args.lr,
        lr_inner=args.lr, batches_per_epoch=max(args.steps // 4, 1)))
    n = pcfg.n_replicas
    validate_replicas(args.algo, args.replicas, n, axis, size)
    group = None
    kw = dict(use_kernel=args.use_kernel)
    if args.nproc > 1:
        group = groups_from_spec(spec, n, obs)
        step_fn = algo.make_sharded_step(model.loss, pcfg, group, **kw)
    else:
        step_fn = algo.make_step(model.loss, pcfg, **kw)
    rows = group.rows if group is not None else slice(None)
    local = group.local if group is not None else n

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = dealias_state(algo.init(model.init(gen), pcfg, group))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed,
                         device=str(device))
    mesh_rec = obs.emit("mesh", mesh=parse_mesh_spec(spec),
                        replica_axis=axis,
                        in_replica_axes=list(getattr(group, "inner_axes",
                                                     ())),
                        processes=args.nproc, replicas_per_process=local,
                        device=str(device))
    if proc == 0:
        print(json.dumps(mesh_rec), flush=True)

    # barrier-wait probe: a tiny all-reduce, outside the group's counted
    # collectives, at every round start.  Every process makes it at the
    # same point of the step sequence, so its duration is how long THIS
    # worker waits for the slowest peer — without touching the step
    probe = None
    if args.nproc > 1 and obs.enabled:
        one = torch.ones(1)
        probe = lambda: dist.all_reduce(one)
    round_t = {"t": None}
    records = []

    def pre_step(i):
        if i % args.L:
            return
        # round boundary: injected straggle, then the sync-wait probe
        if args.straggle_ms > 0 and proc == args.straggle_worker:
            time.sleep(args.straggle_ms / 1e3)
        if probe is not None:
            t = time.perf_counter()
            probe()
            obs.registry.histogram("pod.sync_wait_ms", worker=proc) \
               .observe((time.perf_counter() - t) * 1e3)
        now = time.perf_counter()
        if round_t["t"] is not None and obs.enabled:
            obs.registry.histogram("pod.round_wall_ms", worker=proc) \
               .observe((now - round_t["t"]) * 1e3)
        round_t["t"] = now

    def on_step(i, metrics, sp):
        loss = float(metrics["loss"])      # the mean over all n replicas
        sp.set(loss=round(loss, 6))
        rec = {"step": i + 1, "loss_hex": loss.hex(),
               "loss": round(loss, 6)}
        if obs.enabled:
            obs.registry.gauge("pod.loss").set(rec["loss"])
        obs.emit("pod_step", step=i + 1, loss=rec["loss"], proc=proc,
                 loss_hex=rec["loss_hex"])
        records.append(rec)
        if proc == 0:
            print(LOSS_TAG + json.dumps(rec), flush=True)

    runner = RoundRunner(obs, ns="pod", group=group)
    runner.run_steps(
        state, step_fn,
        lambda i: replica_batches(stream, i, args.batch, n, rows=rows),
        start=0, steps=args.steps, L=args.L,
        tokens_per_step=args.batch * args.seq * local, span_cat="train",
        on_step=on_step, pre_step=pre_step)
    if round_t["t"] is not None and obs.enabled:
        obs.registry.histogram("pod.round_wall_ms", worker=proc) \
           .observe((time.perf_counter() - round_t["t"]) * 1e3)
    if obs.enabled:
        for name, count in parle_update.launch_counts().items():
            obs.registry.gauge("pod.kernel_launches", kernel=name,
                               worker=proc).set(count)
        if device.type == "cuda":
            obs.registry.gauge("pod.peak_device_memory_bytes",
                               worker=proc).set(
                torch.cuda.max_memory_allocated(device))
    obs.finalize()
    if args.nproc > 1:
        dist.destroy_process_group()
    return records


def _run_async_worker(args) -> list:
    """One process of the async/elastic pod: a plain process (no
    process group: a fixed-size world cannot be elastic) owning
    replicas [offset, offset + local_n) of the fleet.  Rounds are the
    inner-only round; the consensus is the AsyncElasticPolicy exchange
    after each round."""
    if args.algo != "parle":
        raise SystemExit("--sync-policy async implements the Parle Eq. 8 "
                         f"consensus; --algo {args.algo} has no round "
                         "contribution to push")
    proc = args._worker
    _maybe_fail_for_test(proc)
    n_total = args.replicas or args.nproc
    if n_total % args.nproc:
        raise SystemExit(f"--replicas {n_total} not divisible by --nproc "
                         f"{args.nproc} (each async worker owns an equal "
                         "replica block)")
    local_n = n_total // args.nproc
    offset = proc * local_n
    if args.device == "cuda":
        # cuBLAS reads this once, at its first use (still ahead)
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.use_deterministic_algorithms(True)
    pin_float32()

    obs = Obs(args.metrics_out, args.trace_out, pid=proc,
              process_name=f"pod-worker{proc}")
    cfg = _model_config(args)
    model = build_model(cfg)
    algo = registry.get(args.algo)
    pcfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=local_n, L=args.L, lr=args.lr, lr_inner=args.lr,
        batches_per_epoch=max(args.steps // 4, 1),
        sync_compress=args.sync_compress))

    wfaults = (FaultPlan.from_spec(args.fault_plan).worker_faults(proc)
               if args.fault_plan else None)
    # heartbeat a few times per liveness window so only a TRUE hang
    # (frozen beater included) crosses the eviction deadline
    client = CoordinatorClient(
        args.coord_port or args.port + 1, worker=f"worker{proc}",
        count=local_n,
        heartbeat_s=min(max(args.liveness_s / 3.0, 0.05), 1.0))
    hello = client.join()
    base_round = hello["round"]
    # every worker of the launch joins before any exchanges, so all of
    # them start at the pod's round (bounded: a worker that never comes
    # is absent, which an elastic pod survives)
    client.wait_for_peers(args.nproc, timeout_s=START_WINDOW_S)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = algo.init(model.init(gen), pcfg)
    if hello["consensus"] is not None:
        # join an in-flight / resumed consensus: every replica starts AT
        # it (a fresh state's momenta and residual are zero already)
        state = parle.reseed_from_consensus(
            state, parle.consensus_from_flat(hello["consensus"], state))
    del hello
    state = dealias_state(state)          # the updates run in place
    # the coordinator's host work grows with the model: one exchange
    # takes ~9 s a GB of consensus on an H100 host (PERF.md §5), and
    # each of the pod's exchanges may be queued ahead of this one
    gb = 4 * state.layout.numel / 1e9
    client.recv_timeout_s = 30.0 + EXCHANGE_S_PER_GB * args.nproc * gb
    client.rpc_timeout_s = 2 * client.recv_timeout_s

    policy = AsyncElasticPolicy(client, pcfg, obs, worker=proc,
                                faults=wfaults)
    round_fn = policy.make_round_fn(algo, model.loss, pcfg)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed,
                         device=str(device))
    stage = make_round_batch_fn(stream, args.L, args.batch, n_total,
                                rows=slice(offset, offset + local_n))
    rounds = args.steps // args.L
    start = base_round * args.L

    rec0 = obs.emit("mesh", mesh={"async": args.nproc},
                    replica_axis="replica", n_total=n_total,
                    local_replicas=local_n, replica_offset=offset,
                    base_round=base_round, device=str(device))
    if proc == 0:
        print(json.dumps(rec0), flush=True)

    records = []
    round_t = {"t": time.perf_counter()}

    def pre_round(r):
        if args.straggle_ms > 0 and proc == args.straggle_worker:
            time.sleep(args.straggle_ms / 1e3)
        if wfaults is not None:
            # the fault "round" is the GLOBAL consensus round this local
            # round's exchange will carry (base_round + r + 1)
            wfaults.pre_round(base_round + r + 1, client=client, obs=obs)

    def post_round(state, r, gstep, metrics):
        return policy.exchange(state, base_round + r, gstep, metrics)

    def on_round(r, gstep, metrics):
        losses = metrics["losses"].detach().cpu().reshape(-1).tolist()
        for j, lv in enumerate(losses):
            stepno = gstep - args.L + j + 1
            rec = {"step": stepno, "loss_hex": float(lv).hex(),
                   "loss": round(float(lv), 6)}
            obs.emit("pod_step", step=stepno, loss=rec["loss"], proc=proc,
                     loss_hex=rec["loss_hex"])
            records.append(rec)
            if proc == 0:
                print(LOSS_TAG + json.dumps(rec), flush=True)
        if obs.enabled:
            obs.registry.gauge("pod.loss").set(round(float(losses[-1]), 6))
            now = time.perf_counter()
            # steady state only: the first round's wall includes the
            # first launches (kernel loads, allocator warm-up)
            if r > 0:
                obs.registry.histogram("pod.round_wall_ms", worker=proc) \
                   .observe((now - round_t["t"]) * 1e3)
            round_t["t"] = now
        if r == 0 and proc == 0 and policy.last_reply is not None:
            # continuity markers for an elastic resume: the first pulled
            # consensus, as a digest and an order-free L2 norm (the same
            # contributions folded in another arrival order can differ
            # in the last ulp, so the norm is the robust comparison)
            vecs = policy.last_reply["consensus"]
            print(json.dumps({"first_consensus_digest":
                              consensus_digest(vecs),
                              "first_consensus_l2":
                              round(parle.contribution_norm(vecs), 6)}), flush=True)

    runner = RoundRunner(obs, ns="pod")
    runner.run_rounds(
        state, round_fn, stage, start=start, rounds=rounds, L=args.L,
        tokens_per_round=args.L * args.batch * args.seq * local_n,
        progress_every=0, progress=None, pre_round=pre_round,
        post_round=post_round, on_round=on_round)
    client.leave()
    if obs.enabled and device.type == "cuda":
        obs.registry.gauge("pod.peak_device_memory_bytes", worker=proc) \
           .set(torch.cuda.max_memory_allocated(device))
    obs.finalize()
    return records


def _spawn(worker_args, env_extra=None):
    """One worker process, leading its own process group / session so a
    wedged pod can be killed as a unit (workers + any children)."""
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dist_run"] + worker_args,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, start_new_session=True)


def _losses(output: str) -> list:
    return [json.loads(line[len(LOSS_TAG):])
            for line in output.splitlines() if line.startswith(LOSS_TAG)]


def _wait_workers(procs, tolerate=frozenset()):
    """Reap the pod, draining all pipes concurrently (a failed worker
    can fill its pipe with a long traceback while its peers block in a
    collective — a serial read would deadlock the launcher).

    If any worker exits nonzero while peers are still running, the
    survivors are wedged (their next collective waits on a corpse):
    kill each survivor's whole process group and report the FAILING
    worker — the first seen to fail — not the -9s we inflicted.
    ``tolerate`` names the workers a chaos plan crashes on purpose:
    exactly those, at exactly :data:`CRASH_RC`, are not failures (an
    elastic pod outlives a dead member).  Returns (outputs,
    failed_index_or_None, n_killed)."""
    pool = ThreadPoolExecutor(max_workers=len(procs))
    futs = [pool.submit(p.communicate) for p in procs]
    failed, killed = None, 0
    while True:
        codes = [p.poll() for p in procs]
        if failed is None:
            for i, rc in enumerate(codes):
                if rc not in (None, 0) and not (i in tolerate
                                                and rc == CRASH_RC):
                    failed = i
                    break
        if failed is not None and any(c is None for c in codes):
            for p in procs:
                if p.poll() is None:
                    try:
                        os.killpg(os.getpgid(p.pid), signal.SIGKILL)
                    except OSError:                # pragma: no cover
                        p.kill()
                    killed += 1
            break
        if all(c is not None for c in codes):
            break
        time.sleep(0.01)
    outs = [f.result()[0] for f in futs]
    pool.shutdown()
    return outs, failed, killed


def _fail_pod(procs, outs, failed, killed):
    """Surface the failing worker's output tail and exit nonzero."""
    rc = procs[failed].returncode
    tail = "\n".join(outs[failed].splitlines()[-40:])
    sys.stderr.write(f"--- worker {failed} exited rc={rc}; killed "
                     f"{killed} orphaned peer(s) ---\n{tail}\n")
    return rc if rc else 1


def _merge_pod_obs(args, sink=None, extra_counters=None,
                   evicted_workers=0):
    """Fold every worker's final registry snapshot into one pod view
    (the merge is associative) and concatenate the worker traces into
    one Chrome trace, one pid lane per process.  A worker whose
    ``<path>.worker<i>`` file is missing or holds no final snapshot (it
    crashed mid-run) is logged as a ``note`` and counted in
    ``missing_workers``; a crashed worker's surviving events still fold
    in (torn final line tolerated).  ``evicted_workers`` (the
    coordinator's heartbeat evictions: hung but alive, a different
    failure) is its own field; ``extra_counters`` (fault counters, a
    checkpoint's counter stamp) fold in, so pod counters stay monotonic
    across elastic resumes.  Returns the merged snapshot (or None
    without --metrics-out)."""
    merged = None
    if args.metrics_out:
        snaps, missing = [], []
        for i in range(args.nproc):
            try:
                evs = read_events(f"{args.metrics_out}.worker{i}",
                                  tolerate_torn_tail=True)
            except FileNotFoundError:
                missing.append(i)
                continue
            final = [e for e in evs if e["kind"] == "metrics_snapshot"]
            if final:
                snaps.append(final[-1]["snapshot"])
            else:
                missing.append(i)
        own_sink = sink is None
        if own_sink:
            sink = EventSink(args.metrics_out)
        for i in missing:
            sink.emit("note", msg=f"pod merge: no metrics snapshot from "
                      f"worker {i} ({args.metrics_out}.worker{i})")
        merged = merge_snapshots(*snaps)
        if extra_counters:
            merged = merge_snapshots(
                merged, {"counters": list(extra_counters), "gauges": [],
                         "hists": []})
        rec = sink.emit("pod_merged", processes=len(snaps),
                        missing_workers=len(missing),
                        evicted_workers=int(evicted_workers),
                        snapshot=merged)
        if own_sink:
            sink.close()
        print(json.dumps({"pod_merged": args.metrics_out,
                          "processes": rec["processes"],
                          "missing_workers": rec["missing_workers"],
                          "evicted_workers": rec["evicted_workers"]}),
              flush=True)
    if args.trace_out:
        events = []
        for i in range(args.nproc):
            try:
                with open(f"{args.trace_out}.worker{i}") as f:
                    events.extend(json.load(f)["traceEvents"])
            except FileNotFoundError:
                sys.stderr.write(f"pod merge: no trace from worker {i} "
                                 f"({args.trace_out}.worker{i})\n")
        with open(args.trace_out, "w") as f:
            json.dump({"traceEvents": events}, f)
    return merged


def _worker_flags(args, i):
    """Per-worker flags the reference run must NOT inherit."""
    flags = ["--straggle-ms", str(args.straggle_ms),
             "--straggle-worker", str(args.straggle_worker)]
    if args.metrics_out:
        flags += ["--metrics-out", f"{args.metrics_out}.worker{i}"]
    if args.trace_out:
        flags += ["--trace-out", f"{args.trace_out}.worker{i}"]
    return flags


def _base_args(args, cfg):
    return ["--mesh", _mesh_spec(args), "--algo", args.algo,
            "--arch", args.arch, "--device", args.device,
            "--replicas", str(args.replicas),
            "--L", str(args.L), "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--lr", str(args.lr), "--seed", str(args.seed),
            "--port", str(args.port),
            "--_config", json.dumps(dataclasses.asdict(cfg))] + (
                ["--use-kernel"] if args.use_kernel else [])


def verdict(dist_recs: list, ref_recs: list) -> dict:
    """The pod's losses against the single-process run's: equal float
    hex at every step, or the largest relative difference."""
    mismatches = [
        {"step": d["step"], "dist": d["loss_hex"], "single": r["loss_hex"]}
        for d, r in zip(dist_recs, ref_recs)
        if d["loss_hex"] != r["loss_hex"]]
    rel = [abs(float.fromhex(d["loss_hex"]) - float.fromhex(r["loss_hex"]))
           / max(abs(float.fromhex(r["loss_hex"])), 1e-12)
           for d, r in zip(dist_recs, ref_recs)]
    return {"compared_steps": min(len(dist_recs), len(ref_recs)),
            "bitwise_equal": (not mismatches
                              and len(dist_recs) == len(ref_recs)),
            "max_rel_diff": max(rel) if rel else None,
            "mismatches": mismatches[:5]}


def _run_async_pod(args, cfg) -> int:
    """Async-pod parent: host the consensus coordinator (behind its
    kill/restart supervisor), spawn the elastic workers, merge their
    telemetry, and checkpoint the consensus for an elastic resume when
    asked.  With ``--fault-plan`` the parent fires the plan's
    coordinator kills and tolerates exactly the worker crashes the plan
    scripts; the merged snapshot carries the pod-lifetime fault
    counters (quarantines, evictions, restarts, corrupt frames)."""
    plan = (FaultPlan.from_spec(args.fault_plan) if args.fault_plan
            else FaultPlan())
    kills = plan.coordinator_kills()
    tolerate = plan.crash_workers()
    sink = EventSink(args.metrics_out) if args.metrics_out else None
    consensus, start_round, extra_counters = None, 0, None
    if args.resume:
        args.resume = ckpt.resolve(args.resume)   # dir / corrupt fallback
        consensus, start_round, meta = load_consensus(args.resume)
        extra_counters = ckpt.saved_metrics(args.resume)
        print(json.dumps({"async_resume": args.resume, "round": start_round,
                          "consensus_digest": meta.get("digest", "")}),
              flush=True)
    # periodic crash-recovery checkpoints: the restart source of
    # scripted coordinator kills, kept next to --checkpoint-out when one
    # is asked for (a temporary directory otherwise, removed at the end)
    ck_dir, tmp_ck = "", ""
    if args.checkpoint_out:
        ck_dir = args.checkpoint_out + ".d"
    elif kills:
        ck_dir = tmp_ck = tempfile.mkdtemp(prefix="repro_async_ck_")
    sup = CoordinatorSupervisor(
        args.coord_port or args.port + 1, kills=kills, sink=sink,
        method=args.sync_compress, decay=args.decay, consensus=consensus,
        start_round=start_round, liveness_s=args.liveness_s,
        ck_dir=ck_dir)
    del consensus
    print(json.dumps({"launch": "dist_run", "mode": "async",
                      "nproc": args.nproc, "coord_port": sup.port,
                      "replicas": args.replicas or args.nproc,
                      "rounds": args.steps // args.L,
                      "faults": len(plan.faults), "device": args.device}),
          flush=True)

    base = _base_args(args, cfg) + [
        "--sync-policy", "async", "--sync-compress", args.sync_compress,
        "--decay", str(args.decay), "--coord-port", str(sup.port),
        "--liveness-s", str(args.liveness_s)]
    if args.fault_plan:
        base += ["--fault-plan", plan.to_json()]
    try:
        procs = [_spawn(base + ["--nproc", str(args.nproc),
                                "--_worker", str(i)]
                        + _worker_flags(args, i))
                 for i in range(args.nproc)]
        outs, failed, killed = _wait_workers(procs, tolerate=tolerate)
        if failed is not None:
            return _fail_pod(procs, outs, failed, killed)
        crashed = [i for i, p in enumerate(procs) if p.returncode]
        for i in crashed:
            sys.stderr.write(f"worker {i} crashed per fault plan "
                             f"(rc={procs[i].returncode}); pod "
                             f"continued without it\n")
        sys.stdout.write(outs[0])
        if not _losses(outs[0]) and 0 not in crashed:
            sys.stderr.write("worker 0 produced no loss records\n"
                             + outs[0])
            return 1
        fault_counters = [
            {"name": "pod.evicted_workers", "labels": {},
             "total": sup.counter("evictions")},
            {"name": "pod.coordinator_restarts", "labels": {},
             "total": sup.restarts},
            {"name": "pod.worker_crashes", "labels": {},
             "total": len(crashed)},
            {"name": "pod.corrupt_frames", "labels": {},
             "total": sup.counter("corrupt_frames")},
            {"name": "pod.duplicate_exchanges", "labels": {},
             "total": sup.counter("duplicates")},
        ]
        merged = _merge_pod_obs(
            args, sink=sink,
            extra_counters=fault_counters + list(extra_counters or []),
            evicted_workers=sup.counter("evictions"))
        if args.checkpoint_out:
            sup.save(args.checkpoint_out,
                     metrics=(merged or {}).get("counters"))
            print(json.dumps({"async_checkpoint": args.checkpoint_out,
                              "round": sup.round,
                              "consensus_digest": sup.digest()}),
                  flush=True)
        return 0
    finally:
        sup.close()
        if sink is not None:
            sink.close()
        if tmp_ck:
            shutil.rmtree(tmp_ck, ignore_errors=True)


def main(argv=None, cfg=None) -> int:
    """Run the pod (or, with ``--_worker``, one of its workers).
    ``cfg``: the model config (default: ``--arch`` / ``--smoke``)."""
    args = build_argparser().parse_args(argv)
    if args._worker >= 0:
        if args.sync_policy == "async":
            _run_async_worker(args)
        else:
            run_worker(args)
        return 0
    cfg = cfg or _model_config(args)
    check_in_replica(args)
    if args.sync_policy == "async":
        return _run_async_pod(args, cfg)

    spec = _mesh_spec(args)
    need = mesh_size(spec)
    if need != args.nproc:
        inner = (f" ({'x'.join(str(s) for s in parse_mesh_spec(spec).values())}"
                 ")" if inner_axes(spec) else "")
        raise SystemExit(f"mesh {spec!r} spans {need} ranks{inner}, --nproc "
                         f"is {args.nproc}: pass --nproc {need} (one rank a "
                         "process; --replicas puts several replicas on a "
                         "rank)")
    base = _base_args(args, cfg)
    print(json.dumps({"launch": "dist_run", "nproc": args.nproc,
                      "mesh": spec, "device": args.device}), flush=True)

    procs = [_spawn(base + ["--nproc", str(args.nproc), "--_worker", str(i)]
                    + _worker_flags(args, i))
             for i in range(args.nproc)]
    outs, failed, killed = _wait_workers(procs)
    if failed is not None:
        return _fail_pod(procs, outs, failed, killed)
    sys.stdout.write(outs[0])
    dist_recs = _losses(outs[0])
    if not dist_recs:
        sys.stderr.write("worker 0 produced no loss records\n" + outs[0])
        return 1
    _merge_pod_obs(args)
    if args.no_compare:
        return 0

    # single-process reference: the same config and replicas, all in one
    # process — only the process boundary (and its collectives) goes
    ref_proc = _spawn(base + ["--nproc", "1", "--_worker", "0"])
    ref_out = ref_proc.communicate()[0]
    if ref_proc.returncode != 0:
        sys.stderr.write(f"--- reference run failed ---\n{ref_out}\n")
        return ref_proc.returncode
    result = verdict(dist_recs, _losses(ref_out))
    print(json.dumps(result), flush=True)
    ok = result["bitwise_equal"] or (
        args.tol > 0 and len(dist_recs) == len(_losses(ref_out))
        and result["max_rel_diff"] <= args.tol)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
