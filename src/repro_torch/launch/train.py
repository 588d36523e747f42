"""Training entry point.  Port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --algo parle --use-kernel --round-fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --replicas 2 --L 3 --steps 6 --batch 2 \\
        --seq 32 --use-kernel --round-fused --sync-compress int8 \\
        --sync-overlap
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --algo elastic_sgd --replicas 2 --L 3 \\
        --steps 6 --batch 2 --seq 32 --use-kernel --round-fused
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --smoke --device cpu --replicas 2 --L 2 --steps 4 --batch 2 \\
        --seq 64 --use-kernel --round-fused
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --mesh pod:2 --smoke --device cpu \\
        --L 3 --steps 6 --batch 2 --seq 32 --round-fused

Runs any registered algorithm (``repro_torch.core.registry``: parle,
entropy_sgd, elastic_sgd, sgd) on a dense, moe, ssm (Mamba2) or hybrid
(Zamba2) architecture through one code path that talks only to the
Algorithm protocol, on the synthetic token stream, with algo-stamped
checkpoints and the replica diagnostics of §1.2 (overlap / spread).  It
takes the reference's flags and prints its JSON lines
(``train_progress``, ``train_final``), plus ``--device``: ``cuda``
unless ``--device cpu`` (no silent fallback to the CPU).  With
``--use-kernel`` Parle's every inner step runs the CUDA kernel K1 and
every sync K2, and Elastic-SGD's every worker step (Eq. 7a) K7 (their
plain versions on the CPU); SGD has no kernel and ignores the flag, as
the reference does.  Under ``--sync-compress int8`` Parle's sync is K4
(quantize + error feedback) and K5 (dequantize + mean + update), and
under ``--sync-overlap`` (with ``--round-fused``) each round's head is K4
(the first) or K6 (apply + quantize), with a plain flush after the last
round; Elastic-SGD and SGD ignore ``--sync-compress`` and refuse
``--sync-overlap``, as the reference does.

``--mesh pod:N`` (or ``replica:N``) puts the replica axis over the N
ranks of a ``torch.distributed`` world on gloo, as ``python -m
torch.distributed.run`` or the pod launcher (``launch/dist_run.py``)
starts it: each rank holds its n / N replicas, the inner steps cross no
process, and each sync is one all-reduce of the model size (or one
all-gather of the compressed payload); Elastic-SGD and SGD all-reduce
once a step.  It combines with ``--use-kernel``, ``--round-fused``,
``--sync-compress`` and ``--sync-overlap``; rank 0 prints the records.
Without a world, ``--mesh`` with an axis above 1 exits saying how to
start one; ``pod:1`` is the single-process run.

Params are drawn from a ``torch.Generator`` seeded by ``--seed`` on the
training device, and so are the batches: neither is the reference's
threefry stream.  Every rank draws the same params, and the batches of
its own replicas.  ``--sync-policy async`` exits pointing at the pod
launcher (``launch/dist_run.py``), as the reference's does.  Not ported
yet, each exiting with the ROADMAP.md item that ports it: axes inside a
replica in ``--mesh`` (queue 1 item 6), ``--checkpoint-dir`` /
``--resume`` under more than one rank (item 3a); ``--host-devices`` is
the reference's XLA CPU mesh and has no counterpart.  The vlm and audio families need
batches with ``patch_embeds`` / ``cond``, which the token stream does
not draw (as in the reference's CLI): they train through the Algorithm
API with their own batches.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ParleConfig, get_config, smoke_variant
from repro_torch.core import registry
from repro_torch.core.parle import dealias_state   # any algorithm's state
from repro_torch.core.algorithm import validate_replicas
from repro_torch.data.synthetic import (TokenStream, make_round_batch_fn,
                                        replica_batches)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model import build_model
from repro_torch.obs import Obs
from repro_torch.runtime import (CheckpointSpec, RoundRunner, emit_progress,
                                 resolve_train_policy)
from repro_torch.runtime.precision import pin_float32


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-runnable)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to train (no silent fallback to the CPU)")
    ap.add_argument("--algo", default="parle", choices=registry.names())
    ap.add_argument("--replicas", type=int, default=0,
                    help="replica count; 0 = the mesh replica-axis size, "
                         "or 3 without --mesh")
    ap.add_argument("--L", type=int, default=25)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4, help="per-replica batch")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--lr-drop-steps", default="",
                    help="comma-separated step boundaries where lr (and "
                         "lr_inner) drop by --lr-drop-factor (paper §4)")
    ap.add_argument("--lr-drop-factor", type=float, default=0.2)
    ap.add_argument("--split-data", action="store_true",
                    help="paper §5: each replica sees a disjoint shard")
    ap.add_argument("--use-kernel", action="store_true",
                    help="the Parle updates through the CUDA kernels K1 "
                         "(inner step) and K2 (sync), K4-K6 under "
                         "--sync-compress int8; Elastic-SGD's worker step "
                         "through K7")
    ap.add_argument("--round-fused", action="store_true",
                    help="run one whole L-step round (inner steps + sync) "
                         "per call, staging each round's batches "
                         "at once; --steps is rounded down to a multiple "
                         "of L")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                    help="bf16: store the compute iterate (y / activations"
                         " / grads) in bfloat16; x, z and momenta stay "
                         "f32 masters")
    ap.add_argument("--sync-compress", default="none",
                    choices=("none", "bf16", "int8"),
                    help="quantize the Eq. 8d sync payload (parle/"
                         "entropy_sgd): bf16 halves, int8 (per-chunk "
                         "scales + error-feedback residual in the state) "
                         "quarters its bytes")
    ap.add_argument("--sync-policy", default="",
                    choices=("", "barrier", "overlap", "async"),
                    help="consensus schedule: 'barrier' (the default), "
                         "'overlap' (= --sync-overlap); 'async' is a "
                         "multi-process pod mode (launch/dist_run.py)")
    ap.add_argument("--sync-overlap", action="store_true",
                    help="staleness-1 overlapped sync (parle/entropy_sgd "
                         "with --round-fused): take each round's Eq. 8d "
                         "payload BEFORE its inner steps and apply the "
                         "consensus at the start of the next round; the "
                         "trajectory equals the barrier path's after the "
                         "end-of-training flush")
    ap.add_argument("--mesh", default="",
                    help="shard replicas over the ranks of a "
                         "torch.distributed world, e.g. 'pod:2' (start it "
                         "with python -m torch.distributed.run or "
                         "repro_torch.launch.dist_run)")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="XLA host-platform devices of the reference's "
                         "CPU mesh (no counterpart: a rank is a process)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", default="",
                    help="checkpoint file OR directory to restore (a "
                         "directory resolves to its newest valid "
                         "checkpoint; digests are verified; validates "
                         "that it was written by the same --algo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="",
                    help="write schema-versioned JSONL events + a final "
                         "metrics_snapshot to this path")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace JSON of the run's spans "
                         "(rounds/steps, eval); spans end on "
                         "torch.cuda.synchronize")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_args(argv=None):
    args = build_argparser().parse_args(argv)
    if args.host_devices:
        raise SystemExit("--host-devices sizes the reference's XLA CPU "
                         "mesh; the port's replica axis spans the ranks of "
                         "a torch.distributed world (--mesh pod:N under "
                         "python -m torch.distributed.run)")
    return args


CHECKPOINT_ACROSS_RANKS = (
    "--checkpoint-dir / --resume under a --mesh of more than one rank: "
    "the checkpoint holds all n replica rows, which would gather to one "
    "rank; not ported yet (ROADMAP.md queue 1, item 3a)")


def parle_config(args, algo) -> ParleConfig:
    drops = tuple(int(s) for s in args.lr_drop_steps.split(",") if s)
    default_n = 3
    if args.mesh:
        default_n = _replica_axis(args)[1]
    return algo.canonicalize_cfg(ParleConfig(
        n_replicas=args.replicas or default_n, L=args.L, lr=args.lr,
        lr_inner=args.lr, batches_per_epoch=max(args.steps // 4, 1),
        lr_drop_steps=drops, lr_drop_factor=args.lr_drop_factor,
        precision=args.precision, sync_compress=args.sync_compress,
        sync_overlap=args.sync_overlap))


def _replica_axis(args):
    try:
        return mesh_mod.replica_axis(args.mesh)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def make_group(args, pcfg, obs):
    """The ReplicaGroup of ``--mesh`` (None without it), after the
    reference trainer's replica checks; a spec above one rank joins the
    torch.distributed world of the environment, or exits saying how to
    start one."""
    if not args.mesh:
        return None
    axis, size = _replica_axis(args)
    validate_replicas(args.algo, args.replicas, pcfg.n_replicas, axis, size)
    try:
        group = mesh_mod.group_from_spec(args.mesh, pcfg.n_replicas, obs)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None
    if group.world > 1 and (args.checkpoint_dir or args.resume):
        raise SystemExit(CHECKPOINT_ACROSS_RANKS)
    return group


def run(args, cfg, device, obs, pre_round=None, on_round=None):
    """Train ``cfg`` as ``args`` say, on ``device``.  Returns (final
    state, progress history, the final eval loss as a float).  The hooks
    go to ``RoundRunner.run_rounds`` (``--round-fused``).  Under
    ``--mesh`` the state holds this rank's replicas."""
    pin_float32()
    policy = resolve_train_policy(args)
    model = build_model(cfg)
    algo = registry.get(args.algo)
    pcfg = parle_config(args, algo)
    n = pcfg.n_replicas
    group = make_group(args, pcfg, obs)
    rows = group.rows if group is not None else slice(None)
    k = group.local if group is not None else n    # replicas held here
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed,
                         device=str(device))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = algo.init(model.init(gen), pcfg, group)
    start = 0
    if args.resume:
        args.resume = ckpt.resolve(args.resume)
        state = ckpt.restore(args.resume, state, algo=args.algo)
        try:                    # continue the stream + checkpoint numbering
            start = ckpt.latest_step(args.resume)
        except FileNotFoundError:       # sidecar-less foreign checkpoint
            start = 0
        obs.registry.restore_counters(ckpt.saved_metrics(args.resume))
    state = dealias_state(state)        # the updates run in place

    t0 = time.time()
    runner = RoundRunner(obs, ns="train", checkpoint=CheckpointSpec(
        dir=args.checkpoint_dir, every=args.checkpoint_every,
        algo=args.algo, arch=cfg.name), group=group)
    if group is not None:
        rec = obs.emit("mesh", mesh=mesh_mod.parse_mesh_spec(args.mesh),
                       replica_axis=group.axis, in_replica_axes=[],
                       ranks=group.world, replicas_per_device=group.local)
        if runner.prints:
            print(json.dumps(rec), flush=True)

    def progress(step, rnd, st, metrics):
        return emit_progress(obs, algo, st, metrics, step, rnd, t0, group)

    if args.round_fused:
        L = pcfg.L
        rounds = args.steps // L
        if args.steps % L:
            print(json.dumps(obs.emit(
                "note", msg=f"--round-fused runs whole L={L} rounds; "
                f"running {rounds * L} of {args.steps} steps")), flush=True)
        if start % L:
            raise SystemExit(f"--round-fused resumes only from round "
                             f"boundaries (step {start} % L={L} != 0)")
        state, history = runner.run_rounds(
            state, policy.make_round_fn(algo, model.loss, pcfg, mesh=group,
                                        use_kernel=args.use_kernel),
            make_round_batch_fn(stream, L, args.batch, n,
                                split=args.split_data, rows=rows),
            start=start, rounds=rounds, L=L,
            tokens_per_round=L * args.batch * args.seq * k,
            progress_every=max(1, args.log_every // L), progress=progress,
            pre_round=pre_round, on_round=on_round,
            flush_fn=policy.make_flush_fn(algo, pcfg))
    else:
        state, history = runner.run_steps(
            state, policy.make_step_fn(algo, model.loss, pcfg, mesh=group,
                                       use_kernel=args.use_kernel),
            lambda i: replica_batches(stream, i, args.batch, n,
                                      split=args.split_data, rows=rows),
            start=start, steps=args.steps, L=pcfg.L,
            tokens_per_step=args.batch * args.seq * k,
            progress_every=args.log_every, progress=progress)

    with obs.tracer.span("eval") as sp, torch.no_grad():
        loss, _ = model.loss(algo.deployable(state, group),
                             stream.batch(10_000_019))   # held-out step
        sp.block(loss)
    rec = obs.emit("train_final", final_eval_loss=round(float(loss), 4),
                   algo=args.algo, arch=cfg.name,
                   total_wall_s=round(time.time() - t0, 1))
    if runner.prints:
        print(json.dumps(rec), flush=True)
    return state, history, float(loss)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    rank = int(os.environ.get("RANK", "0")) if args.mesh else 0
    metrics_out, trace_out = args.metrics_out, args.trace_out
    if rank:                # each rank of a pod writes its own files
        metrics_out = metrics_out and f"{metrics_out}.worker{rank}"
        trace_out = trace_out and f"{trace_out}.worker{rank}"
    obs = Obs(metrics_out, trace_out, pid=rank, process_name="train")
    joined = dist.is_initialized()
    try:
        _, history, _ = run(args, cfg, device, obs)
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()
    obs.finalize()
    return history


if __name__ == "__main__":
    main()
