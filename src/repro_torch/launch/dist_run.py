"""Multi-process pod launcher: N real worker processes on one machine,
each a rank of a ``torch.distributed`` world on gloo.  Port of the
barrier half of ``repro/launch/dist_run.py``:

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

On CUDA (``--device cuda``, the default, as the train CLI's) the ranks
share the card or cards of the machine and stage every collective
through pinned host memory (``sharding/partition.py``).  Each worker,
and the reference run, trains under
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``: without them the embedding and
cross-entropy backwards accumulate with atomics, and no two runs (pod
or not) are bit for bit equal.

``--sync-policy async`` (elastic pods with the consensus coordinator)
is not ported yet (ROADMAP.md queue 1, item 4).  The parent hands the
workers its resolved model config as JSON (``--_config``), so
:func:`main` can run a pod at any config, such as a full-width model
cut in depth.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ParleConfig, get_config, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.core import registry
from repro_torch.core.algorithm import validate_replicas
from repro_torch.core.parle import dealias_state
from repro_torch.data.synthetic import TokenStream, replica_batches
from repro_torch.launch.mesh import group_from_spec, mesh_size, replica_axis
from repro_torch.models.model import build_model
from repro_torch.obs import EventSink, Obs, merge_snapshots, read_events
from repro_torch.runtime import RoundRunner
from repro_torch.runtime.precision import pin_float32

LOSS_TAG = "DISTLOSS "
SRC = str(Path(__file__).resolve().parents[2])     # the port's src/ dir


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=2,
                    help="number of processes (ranks) of the pod")
    ap.add_argument("--mesh", default="",
                    help="mesh spec (default 'pod:<nproc>'); its replica "
                         "axis must span --nproc ranks")
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
    ap.add_argument("--port", type=int, default=9876,
                    help="TCP port of the torch.distributed rendezvous")
    ap.add_argument("--sync-policy", default="barrier",
                    choices=("barrier", "async"),
                    help="barrier: bulk-synchronous pod (bit for bit vs "
                         "the single-process run); async is not ported yet")
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
    nproc > 1), build the sharded step over this rank's replicas, and
    hand the step stream to the runtime's ``RoundRunner``.  Emits
    bit-exact losses (proc 0 only).  With nproc 1 it is the
    single-process reference: the local step over all n replicas."""
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
    if args.nproc > 1:
        group = group_from_spec(spec, n, obs)
        step_fn = algo.make_sharded_step(model.loss, pcfg, group)
    else:
        step_fn = algo.make_step(model.loss, pcfg)
    rows = group.rows if group is not None else slice(None)
    local = group.local if group is not None else n

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = dealias_state(algo.init(model.init(gen), pcfg, group))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed,
                         device=str(device))
    mesh_rec = obs.emit("mesh", mesh={axis: size}, replica_axis=axis,
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
    obs.finalize()
    if args.nproc > 1:
        dist.destroy_process_group()
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


def _wait_workers(procs):
    """Reap the pod, draining all pipes concurrently (a failed worker
    can fill its pipe with a long traceback while its peers block in a
    collective — a serial read would deadlock the launcher).

    If any worker exits nonzero while peers are still running, the
    survivors are wedged (their next collective waits on a corpse):
    kill each survivor's whole process group and report the FAILING
    worker — the first seen to fail — not the -9s we inflicted.
    Returns (outputs, failed_index_or_None, n_killed)."""
    pool = ThreadPoolExecutor(max_workers=len(procs))
    futs = [pool.submit(p.communicate) for p in procs]
    failed, killed = None, 0
    while True:
        codes = [p.poll() for p in procs]
        if failed is None:
            for i, rc in enumerate(codes):
                if rc not in (None, 0):
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


def _merge_pod_obs(args):
    """Fold every worker's final registry snapshot into one pod view
    (the merge is associative) and concatenate the worker traces into
    one Chrome trace, one pid lane per process.  A worker whose
    ``<path>.worker<i>`` file is missing or holds no final snapshot is
    logged as a ``note`` and counted in ``missing_workers``.  Returns
    the merged snapshot (or None without --metrics-out)."""
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
        sink = EventSink(args.metrics_out)
        for i in missing:
            sink.emit("note", msg=f"pod merge: no metrics snapshot from "
                      f"worker {i} ({args.metrics_out}.worker{i})")
        merged = merge_snapshots(*snaps)
        rec = sink.emit("pod_merged", processes=len(snaps),
                        missing_workers=len(missing), snapshot=merged)
        sink.close()
        print(json.dumps({"pod_merged": args.metrics_out,
                          "processes": rec["processes"],
                          "missing_workers": rec["missing_workers"]}),
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
    flags = []
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
            "--_config", json.dumps(dataclasses.asdict(cfg))]


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


def main(argv=None, cfg=None) -> int:
    """Run the pod (or, with ``--_worker``, one of its workers).
    ``cfg``: the model config (default: ``--arch`` / ``--smoke``)."""
    args = build_argparser().parse_args(argv)
    if args.sync_policy == "async":
        raise SystemExit("--sync-policy async (elastic pods with the "
                         "consensus coordinator) is not ported yet "
                         "(ROADMAP.md queue 1, item 4)")
    if args._worker >= 0:
        run_worker(args)
        return 0

    spec = _mesh_spec(args)
    axis, size = replica_axis(spec)
    if size != args.nproc:
        raise SystemExit(f"mesh {spec!r}: its replica axis {axis!r} spans "
                         f"{size} ranks, --nproc is {args.nproc} (one rank "
                         "a process; --replicas puts several replicas on "
                         "a rank)")
    base = _base_args(args, cfg or _model_config(args))
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
