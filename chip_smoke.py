#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc`` (``$CUDA_HOME/bin`` or PATH).  It puts ``src`` on ``sys.path``
itself and, in order:

1. prints the card (``nvidia-smi`` name and power limit, and torch's name);
2. builds every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together) and prints the build times and
   ``nvcc -Xptxas -v``'s register / shared-memory report;
3. holds each kernel against its plain PyTorch version on the card:
   K8 (paged attention) within atol = rtol = 2e-5 at the unit-test
   shapes, a shared-pages case (rows bitwise equal), a length-1 case,
   the serve path's shapes, lengths on the edges of its splits (one and
   two spans of positions, one short, one over, and 1) and a length of
   1 over 512 pages, each launched twice (bitwise equal) and once with
   host synchronisation forbidden (``set_sync_debug_mode("error")``); K1 (Parle inner step) and K2 (sync step) bit for bit at
   ragged lengths, 1-3 replicas, bf16 y/g (K1), with and without the
   fused bf16 y' (K2), and with each scalar bumped (the result moves);
   K4 (int8 quantize + error feedback, also in place), K5 (dequantize +
   mean + sync) and K6 (apply + quantize) bit for bit in codes, scales,
   residuals and state at 1-3 rows and 1-3 payloads, a half-to-even and
   an all-zero chunk, with and without the fused bf16 y', each scalar
   bumped; and a NaN chunk (its scale NaN in both); K7 (Elastic-SGD
   worker step) bit for bit at ragged lengths, 1-3 replicas, f32 and
   bf16 g, each scalar bumped, and once updating x and v in place (ref
   only read); K3 (flash attention) within 2e-5 in float32 and 5e-2 in
   bf16 at the reference test's cases, a ragged T of 200 (with and
   without a window), T of 65, 127 and 129 at hd 128, bf16 at hd 128 and
   the Qwen2.5-3B prefill shape (2, 2048, 16, 128), each launched with
   host synchronisation forbidden; K9 (SSD scan) in y and the final
   state within 1e-4 (1e-2 for bf16 outputs) at the reference test's
   cases, cases of several chunks (f32 and bf16), chunks of 24 and 5,
   Zamba2-1.2B's geometry (N 64, T 2048), x, B and C as views of one
   xBC tensor (as the Mamba2 model hands them over) and the Mamba2-1.3B
   shape (B 2, T 2048, 64 heads, P 64, N 128, Q 128), each launched
   twice (bitwise equal) and once with host synchronisation forbidden;
   then (phase 3g) K3 and K8 at the moe, hybrid, vlm and audio families'
   geometries: K3 at (2, 1024) x 32 heads of 64 (and T 1088: MusicGen's
   64 cond frames), 14 heads of 64 and 16 heads of 128, K8 at hd 64 with
   groups of 1, hd 64 with a group of 7 (14 over 2 KV heads) and hd 128
   with groups of 1, at the serve rows' lengths and on its splits'
   edges, each launched twice (bitwise equal) and once with host
   synchronisation forbidden;
4. times each kernel, its plain version and, where one exists, one
   PyTorch library call (CUDA events, L2 flushed before every launch)
   beside the least time the card could take: K8 at the serve path's
   shapes and at long context (Qwen2.5-3B's decode geometry, 4096-16384
   positions a row; checked against its plain version there too), each
   beside one empty kernel launch timed the same way, K1, K2, K4, K5, K6
   and K7 at 2 replicas x 2^26 float32 elements, K3 at the prefill shape
   (SDPA with is_causal as the library call; its bound counts each
   float32 product as three TF32 tensor-core products, with the SIMT
   float32 bound beside it), K9 at the Mamba2-1.3B shape in float32
   and bf16 (its bound counts C B^T once per (b, chunk) and each
   float32 product as three TF32 products, the SIMT bound beside it),
   and (phase 4h) K3 and K8 at the new families' geometries beside their
   plain versions and SDPA, the card's name and power limit on each
   line;
5. serves through the port's serve CLI functions: full-width
   Qwen2.5-3B in float32 (random params, torch.Generator seed 0), the
   paged engine decoding through K8, 8 requests of 63-84 prompt tokens,
   32 greedy tokens each; every engine decodes through one CUDA graph of
   its decode chunk and prefills through CUDA graphs too — one a prompt
   bucket (dense) or one of the prefill chunk (paged) — each captured
   at its first use after a warm-up run, unless it is built with
   ``graphs=False`` (then all of it runs eagerly); asserts every request
   got its tokens, that each captured engine captured exactly the
   programs the reference compiles (decode + buckets dense, 2 paged),
   that K8 launched exactly num_layers x (decode steps + the warm-up's
   steps), counted through the replays (a prefill launches none), and
   that the tokens equal the gather path's (no kernel), captured and
   eager; then (5b) profiles that run, captured and eager (K8 named in
   one of them); then (5j) holds the captured engine against the eager
   one: the same tokens greedy and sampled (temperature 0.8, top-k 50,
   one seed), one replay of the decode graph and one of the prefill
   chunk graph with host synchronisation forbidden, ITL, prefill
   tokens/s, TTFT, capture seconds and the device's busy share of both
   (whole runs and a two-step window); then (5k) one captured engine
   serves the 8 requests twice, a cold pass (captures included, each
   timed) and a warm pass (no capture), each with phase 5's tokens,
   beside the eager engine: prefill tokens/s, TTFT, ITL, busy shares
   (whole pass and two-step window) and peak memory of each; then
   prefills
   2 x 1024 tokens on the same params through
   ``launch/steps.py::make_prefill_step(use_flash=True)`` (K3 once per
   layer, 36 launches) and without K3: logits and KV caches within 1e-3,
   the same next token in both rows; then full-width Mamba2-1.3B (48
   layers, d_model 2048, float32, random params): a forward over 2 x
   2048 tokens through K9 (48 launches) against ``ssd_chunked`` (logits
   within 1e-3), and 8 requests served through the engine, dense and
   paged (each captured; the dense prefill graphs replayed once more
   with host synchronisation forbidden) and paged eagerly, with equal
   tokens; then
   (phases 5f-5i) the four remaining
   families at full width and an eighth of their depth (Zamba2 12 of
   38 layers: two sites), float32, random
   params (seed 0), each freed before the next is built —
   Qwen1.5-MoE-A2.7B (3 of 24 layers), Zamba2-1.2B, InternVL2-1B (256
   patch embeddings a request)
   and MusicGen-large (64 cond frames, 4 codebooks): 8 requests, 32
   greedy tokens each, 4 slots, page size 16, through the paged engine
   prefilling and decoding (K8) through its CUDA graphs (launches =
   attention layers or sites x (decode steps + the warm-up's)), the same
   eagerly and the gather path eagerly, equal tokens (the hybrid also
   through the dense engine's graphs; the moe family compared up to the
   first token whose decode step routed a token below a router margin of
   1e-4 on the gather path), ITL, prefill tokens/s, TTFT and busy
   windows of the captured and the eager K8 path,
   then a 2 x 1024 prefill (moe, through
   ``steps.make_prefill_step``) or forward through K3 (24, 7, 24 and 48
   launches; the hybrid also through K9, 38) against the plain path:
   logits within 1e-3 and the same next tokens (moe: on every position
   whose routings all clear the margin and that no routing difference
   reaches; a routing difference whose margin clears it fails), with
   each phase's wall time and peak memory;
6. trains through the port's train CLI functions, under deterministic
   algorithms: full-width Qwen2.5-3B (d_model 2048, 16 q / 2 KV heads,
   head_dim 128, d_ff 11008, vocab 151936) with its depth cut from 36
   to 4 layers — one float32 copy of 4 layers is 3.72 GB, the Parle
   state holds five per replica, and 36 layers at 2 replicas would need
   177 GB — Parle with 2 replicas, L = 4, 2 rounds (8 steps, 2 syncs),
   batch 2 x 256 tokens per replica, ``--use-kernel --round-fused``;
   asserts K1 launched 8 times and K2 twice, every loss is finite, and
   the same run without ``--use-kernel`` gives the same losses and the
   same final x bit for bit, and so does the ``--sync-overlap`` run after
   its flush (K2 launched once, at the second round's head); then
   profiles one more round, runs one round in bf16 (``--precision
   bf16``) with and without the kernels (bit for bit again), and trains
   with ``--sync-compress int8``: the barrier path through K4 and K5 (2
   launches each), the overlapped path through K4 (first head) and K6
   (second head), each equal to its run without the kernels in losses,
   final x, residual e (and c) bit for bit, and the two equal to each
   other; peak and free device memory after each run; trains Elastic-SGD
   on the same cell through K7 (8 launches in 8 steps; losses and final
   x, v and ref equal to the run without ``--use-kernel`` bit for bit)
   and SGD (finite losses, no port kernel), and Mamba2-1.3B cut to 4
   layers, Qwen1.5-MoE-A2.7B cut to 1 layer (4.77 GB a copy, five copies
   a replica) and Zamba2-1.2B cut to 12 layers through K1 / K2 (8 and 2
   launches; losses and final x equal to the plain path's bit for bit);
   then holds K1, K2, K4, K5, K6 and K7
   against their plain versions at the training shape;
7. prints one JSON line of per-kernel numbers;
8. runs the quickstart (``repro_torch.examples.quickstart``: the MLP on
   the teacher task, SGD against Parle n=3, 400 steps) on the card and
   fails unless Parle's test error is within 0.02 of SGD's or better;
9. runs the paper's experiments (``repro_torch/examples/``) on the card
   at half the reference's default steps (for the script's time limit):
   Table 1's seed 0 (300 steps, n=3)
   twice, through K1 / K2 / K7 and through their plain versions, under
   deterministic algorithms — the four algorithms' deployables and errors
   equal bit for bit, K1 launched 300 times and K2 12 for Parle and for
   Entropy-SGD, K7 300 for Elastic-SGD, none for SGD and none on the
   plain run — then Table 2 (200 steps, n=2 and 4) and Fig. 1 (200
   steps) through the kernels (launches checked; Table 1's seeds 1 and 2
   left out), printing
   every row the reference prints as a JSON line with the card's name
   and power limit (the ``holds=`` values are findings, not gates); then
   ``split_data`` at its defaults (its assert is a gate),
   ``train_llm_parle`` at its defaults (full-width e2e-60m, 200 steps,
   n=2; the mean loss of the last tenth of the steps below the first
   tenth's; its checkpoint, in a temporary directory, restores into a
   fresh state that takes the same next step bit for bit) and
   ``serve_batched`` on ``mamba2-1.3b`` and on ``llama3-8b --window 64``
   (the reference's cache-position assert), none of them launching a port
   kernel; then prints the card's name and power limit again and, last,
   the device line ``{"ok": true, "device": {...}}``;
10. (run right after phase 6, before its 6c) puts Parle's replica axis
   over two ranks of a gloo ``torch.distributed`` world on the one card:
   two spawned processes, each holding one of phase 6's two replicas
   and staging every collective through pinned host memory, run phase
   6's argv plus ``--mesh pod:2`` under deterministic algorithms — the
   f32 barrier run through K1 / K2, the int8 barrier (K4 / K5) and
   overlap (K4 / K6 and the flush) runs, and Elastic-SGD through K7 —
   and each rank's losses (8; Elastic-SGD's 4), eval loss and final rows
   (x; e, c; v, ref)
   equal phase 6's bit for bit (sha256 of each row), with each kernel's
   launches a rank and each collective a rank counted; beside the
   ranks, the pod launcher (``launch/dist_run.py --nproc 2 --smoke
   --device cuda``) ends ``bitwise_equal``; round walls, each
   collective's bytes and its d2h / gloo / h2d times, peak memory a rank
   and the phase wall are printed (two ranks time-slicing one card over
   loopback: not a multi-card figure);
11. (run right after phase 10) the async / elastic pod: (11a) the async
   policy with one worker in this process at phase 6's cell — each
   round's inner steps through K1 (8 launches, K2 none), the consensus
   math of the coordinator on the host (the contribution, its
   dequantized mean, the staleness-weighted mean of one worker, the
   consensus row, the plain apply) — equal to phase 6's barrier run bit
   for bit (8 losses, sha256 of each final row of x), with the host
   seconds of each part; (11b) ``dist_run --sync-policy async --device
   cuda`` at 12a's model (Mamba2-1.3B cut to 2 layers; phase 6's L, steps
   and batch), 2 workers of one replica with int8
   contributions through the wire, its consensus checkpointed at round
   2, then resumed as ONE worker (f32) for one round: the checkpoint's
   digest echoed, base round 2, the first consensus L2 within 1e-5 of the
   checkpoint's, ``pod.steps`` 16 then 20, no missing worker; each
   exchange's wall,
   the largest frame's bytes, staleness, round wall and peak device
   memory a worker and the pod parent's peak RSS printed with the card;
   (11c) the reference's chaos plan (a crash, a hang past a 0.5 s
   liveness deadline, a NaN-poisoned round, a corrupt frame, a
   coordinator kill) on a 4-worker smoke-width pod beside its
   fault-free twin: both end at round 5, final consensus L2 within
   1e-3, every fault class counted and announced;
12. (12a in phase 10's world, 12b and 12c after phase 11) (12a)
   checkpoint and resume across ranks: full-width Mamba2-1.3B cut to 2
   layers, Parle n = 2 over the two ranks (``--mesh pod:2 --use-kernel
   --round-fused --sync-compress int8 --sync-overlap``, L = 2, 6 steps,
   a checkpoint at step 4, each rank's rows gathered to rank 0, which
   writes the one file, under /dev/shm when it has room), then resumed
   from step 4 under pod:2 and, in this process beside the ranks, under
   pod:1: both
   equal the uninterrupted run bit for bit (losses of steps 5-6,
   eval loss, sha256 of each final row of x, e and of c), K1 / K4 / K6
   launched as counted (the flush is plain), one gather a rank a
   checkpoint; the file's bytes, the gather, save and restore seconds
   and peak memory a rank printed; (12b) remat: full-width Qwen2.5-3B
   cut to 4 layers, n = 2, batch 1 x 2048, one round (L = 2) of
   ``steps.make_algorithm_round(..., use_kernel=True, remat=r)`` through
   K1 / K2 for r in (False, True, "dots") under deterministic
   algorithms: losses and final x rows equal bit for bit, peak memory
   and round wall of each; (12c) the reference's token stream drawn on
   the card equals the CPU's bit for bit at the training cell's shapes
   (interleaved, split, a staged round), and
   ``repro_torch.examples.obs_report`` accepts 12a's rank-0 metrics and
   trace;
13. (after 12c) axes inside a replica: the one-process references
   (full-width Mamba2-1.3B cut to 2 layers, Parle n = 2, L = 2, 2 steps
   of 2 x 256 through the kernels, the int8 barrier; 13c's runs below;
   deterministic algorithms), then four spawned gloo ranks on the one
   card, each holding half of one replica's state as the sharding
   planner assigns it (``sharding/partition.py::MeshGroups``): 13b
   ``--mesh replica:2,data:2`` (int8, one round: K1 2 / K4 1 / K5 1 a
   rank) —
   losses within rtol 2e-5 of the one-process int8 run, the replica axis
   moving a shard's int8 payload and its scales a sync; 13c, on the same
   ranks: full-width Mamba2-1.3B cut to 2 layers, Parle n = 2, L = 2, f32
   through K1 / K2, split over "model" (each rank its SSD heads),
   checkpointed at step 2 under ``--mesh replica:2,model:2`` (each leaf's
   blocks gathered inside the replica, then the replicas' rows to rank 0,
   which writes the one file) — its every leaf within rtol 2e-5 / atol
   2e-6 of the one-process state at step 2, and read back there = each
   rank's state at step 2 bit for bit (sha256 of its rows) — resumed for
   2 steps under ``replica:2,model:2`` (steps 3-4, eval loss and final x
   = the uninterrupted split run's bit for bit), under
   ``replica:2,data:2`` (a layout sharded over "data", no split) and,
   beside the ranks, in this process with no mesh (both: losses and eval
   loss within rtol 2e-5 of the uninterrupted runs'); the save's
   in-replica gather, replica gather and write seconds, each resume's
   seconds, the file's bytes and peak memory a rank printed; then 13a
   through the pod launcher, ``dist_run --nproc 4 --mesh
   replica:2,model:2 --device cuda --use-kernel`` (f32, K1 4 / K2 2 a
   rank, from each worker's ``--metrics-out``): its verdict against its
   own one-process run bit for bit; each collective's bytes by axis, its
   d2h / gloo / h2d seconds, the step wall, peak memory a rank and the
   phase wall printed (four ranks time-slicing one card over loopback,
   not a multi-card figure); on the same ranks after 13c, the Megatron
   split (``models/megatron.py``): 13d full-width Qwen2.5-3B cut to 2
   layers under ``replica:2,model:2`` (n = 2, L = 2, 4 steps of 2 x 256,
   f32, K1 4 / K2 2 a rank; each rank computes its half of the heads,
   the ff and the vocab on its column of each leaf) and 13e full-width
   Qwen1.5-MoE-A2.7B cut to 1 layer under ``replica:1,data:2,model:2``
   (n = 1, 2 steps, K1 2 / K2 1 a rank; its 30 of 60 experts, the
   batch's one flat dispatch over the two data ranks' rows) — each
   rank's losses and eval loss within rtol 2e-5 of the one-process
   run's, its blocks of the deployable (Parle's mean row) within rtol
   2e-5 / atol 2e-6 of the one-process row, its bytes by axis and op,
   step wall and peak memory printed;
14. (after 13) the dry run against the card (``launch/dryrun.py``, each
   program on PyTorch's meta device): (14a) at phase 6's cell (n = 2 in
   one process, f32, remat off) a round of L train_inner programs and
   the sync = the FLOPs ``FlopCounterMode`` counted over the plain run's
   first round on the card, as integers, and the program's arguments =
   the card's state plus one step's batch in bytes (arguments + temp
   printed beside the run's peak); (14b) at 13a's mesh, 4 train_inner
   and 2 parle_sync = 13a's counters by axis and op, and the predicted
   shard's row and blocks = its gathers' and all-reduces' bytes; at
   13d's mesh, 4 train_inner and 2 parle_sync = 13d's "model" counters
   and replica all-reduces (rank 0's, over its training rounds); (14c)
   the dry-run CLI at full size (Qwen2.5-3B train_4k on both production
   meshes, Qwen1.5-MoE decode_32k through the expert-parallel dispatch
   and prefill_32k through the grouped one, each record's roofline line
   printed) with the card's allocator counting no allocation and no
   port kernel launched; (14d, run in 5f) one forward of a Qwen1.5-MoE
   block with 4 groups = the flat dispatch within rtol 1e-5 / atol 1e-6
   at a drop-free capacity, and the routings each drops at 1.25; (14e,
   run on phase 13's four ranks) one full-width Qwen1.5-MoE block split
   over the "model" pairs (30 of 60 experts and half the shared ff a
   rank) summed over each pair = each rank's flat forward (gated in
   float64, the float32 error printed), one float32 all-reduce of
   4,194,304 B a rank = the dry run's prediction, and, in float64, the
   grads through the sum (of the tokens, the router and the rank's
   experts and shared ff) = the flat dispatch's.

Nothing is caught: a failing phase exits non-zero and prints no device
line.  Without a CUDA card it exits 2 before doing anything.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

# cuBLAS reads its workspace setting once, at its first use: deterministic
# float32 products for the training phase's bitwise comparison
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import ParleConfig, get_config  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import parle, registry  # noqa: E402
from repro_torch.data.synthetic import (TokenStream,  # noqa: E402
                                        make_round_batch_fn,
                                        replica_batches)
from repro_torch.examples import common as paper  # noqa: E402
from repro_torch.examples import obs_report  # noqa: E402
from repro_torch.examples import (fig1_overlap, quickstart,  # noqa: E402
                                  serve_batched, split_data,
                                  table1_baselines, table2_split_data,
                                  train_llm_parle)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import parle_update as pu  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import (dryrun, serve, specs, steps,  # noqa: E402
                                train)
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.models import megatron  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import (Obs, Registry, read_events,  # noqa: E402
                             snapshot_summaries)
from repro_torch.runtime import (AsyncElasticPolicy,  # noqa: E402
                                 consensus_digest, load_consensus)
from repro_torch.runtime.coordinator import (_np_dequant,  # noqa: E402
                                             free_ports)
from repro_torch.runtime.precision import pin_float32  # noqa: E402
from repro_torch.serving.engine import _bucket_len  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.sharding import partition, planner  # noqa: E402
from repro_torch.sharding.partition import (  # noqa: E402
    collective_counts, collective_counts_by_axis)
from repro_torch.utils.pytree import ShardedLayout, tree_map  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
SOURCES = ("paged_attention.cu", "parle_update.cu", "flash_attention.cu",
           "ssd_scan.cu")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_FLOP_PER_S = 67e12           # H100 SXM float32, outside tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32 tensor cores
L2_FLUSH_BYTES = 64 * 2 ** 20    # > the 50 MB L2
SPIN_CYCLES = 100_000_000        # ~50 ms of a ~2 GHz SM clock


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


T_IMPORT = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name}  [{time.perf_counter() - T_IMPORT:.1f} s]", flush=True)


def paged_inputs(seed, B, P, H, KV, hd, ps, M, lengths, device):
    """Random q and pools; row b gets distinct random pages, and table
    entries past its live extent name the trash page 0."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, hd), generator=gen)
    k_pool = torch.randn((P, ps, KV, hd), generator=gen)
    v_pool = torch.randn((P, ps, KV, hd), generator=gen)
    pages = torch.randperm(P - 1, generator=gen) + 1
    table = torch.zeros((B, M), dtype=torch.int32)
    for b, n in enumerate(lengths):
        live = -(-n // ps)
        take = pages[(b * M) % (P - 1):][:live]
        if len(take) < live:                      # wrap around the pool
            take = torch.cat([take, pages[:live - len(take)]])
        table[b, :live] = take
    lengths = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (q, k_pool, v_pool, table, lengths)]


def time_ms(fn, device, iters=50, warmup=10):
    """Median device time of ``fn`` in ms: CUDA events around each
    launch, the L2 cache flushed before each one (the serve path reads a
    layer's pool cold: every other layer's weights pass in between).  A
    spin kernel holds the card while the host enqueues every iteration,
    so the events time the card's work and not the host's launch rate."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=device)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2], enqueue_ms


CASES = {
    "unit_test": dict(B=3, P=12, H=4, KV=2, hd=32, ps=16, M=4,
                      lengths=[1, 64, 56]),
    "shared_pages": None,
    "length_1": dict(B=4, P=12, H=4, KV=2, hd=32, ps=16, M=4,
                     lengths=[1, 1, 1, 1]),
    "main_path": dict(B=4, P=33, H=16, KV=2, hd=128, ps=16, M=8,
                      lengths=[63, 80, 99, 116]),
    # lengths at a split's edge, L = span * ps: L, L - 1, L + 1, 2L,
    # 2L + 1 and 1 (split_lengths fills them in on the card)
    "split_boundary": dict(B=6, P=80, H=16, KV=2, hd=128, ps=16, M=512,
                           lengths="split_edges"),
    "length_1_large_M": dict(B=2, P=40, H=8, KV=2, hd=64, ps=16, M=512,
                             lengths=[1, 1]),
}
# Qwen2.5-3B's decode geometry at long context: 40960 live positions,
# 84 MB of K and V
LONG_CONTEXT = dict(B=4, P=4 * 1024 + 1, H=16, KV=2, hd=128, ps=16, M=1024,
                    lengths=[4096, 8192, 12288, 16384])
SERVE_ARGV = ["--arch", "qwen2.5-3b", "--device", "cuda", "--paged",
              "--slots", "4", "--page-size", "16", "--prefill-chunk", "32",
              "--decode-chunk", "8", "--requests", "8", "--prompt-len", "64",
              "--mixed-lens", "--arrive-every", "2", "--gen", "32",
              "--seed", "0"]


def device_phase():
    phase("1. device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    return device, kind, smi


def build_phase():
    phase("2. kernel build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
        libs = list(ex.map(build.load, SOURCES))
    for src, lib in zip(SOURCES, libs):
        print(f"{src} -> {lib.path.name}: nvcc {lib.build_s:.2f} s "
              f"({' '.join(build.NVCC_FLAGS)})")
        print(lib.report.strip() or "(loaded from an earlier build)",
              flush=True)
    print(f"build phase {time.perf_counter() - t0:.2f} s", flush=True)


def device_kernels(fn, device, calls=2) -> dict:
    """The device kernels a call of ``fn`` launches, as torch.profiler
    shows them (host and device activity traced over ``calls`` calls,
    every row that took device time), each with its device ms a call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize(device)
    return {e.key: e.self_device_time_total / calls / 1e3
            for e in sorted(prof.key_averages(), key=lambda e: e.key)
            if str(e.device_type).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0}


def split_lengths(device, B, KV, M, ps):
    """Row lengths at the edges of K8's splits on this card."""
    span = pa.split_span(B, KV, M, torch.cuda.get_device_properties(
        device).multi_processor_count)
    edge = span * ps
    lengths = [edge, edge - 1, edge + 1, 2 * edge, 2 * edge + 1, 1][:B]
    check(span > 1 and max(lengths) <= M * ps,
          f"split_boundary: span {span} gives no split edge inside "
          f"{M} pages")
    return lengths


def without_sync(fn, *args, **kwargs):
    """``fn`` under ``torch.cuda.set_sync_debug_mode("error")``: any
    device-to-host synchronisation inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_phase(device) -> float:
    """K8 against its plain version at every case, each launched twice
    (bitwise equal), once with host synchronisation forbidden; returns
    the largest absolute error seen."""
    phase("3. K8 against its plain version")
    max_abs_err = 0.0
    for i, (name, shape) in enumerate(CASES.items()):
        if shape is not None and shape["lengths"] == "split_edges":
            shape = dict(shape, lengths=split_lengths(
                device, shape["B"], shape["KV"], shape["M"], shape["ps"]))
        if shape is None:   # two rows naming the same pages: equal rows
            q, k_pool, v_pool, _, _ = paged_inputs(
                10 + i, B=1, P=8, H=4, KV=2, hd=32, ps=8, M=3,
                lengths=[16], device=device)
            args = [torch.cat([q, q]), k_pool, v_pool,
                    torch.tensor([[3, 5, 1], [3, 5, 2]], dtype=torch.int32,
                                 device=device),
                    torch.tensor([16, 16], dtype=torch.int32, device=device)]
        else:
            args = paged_inputs(10 + i, device=device, **shape)
        got = without_sync(pa.paged_attention_cuda, *args)
        again = pa.paged_attention_cuda(*args)
        torch.cuda.synchronize(device)
        check(torch.equal(got, again),
              f"two K8 launches on {name} differ")
        want = pa.paged_attention_plain(*args)
        err = (got - want).abs().max().item()
        max_abs_err = max(max_abs_err, err)
        print(f"{name}: q {tuple(args[0].shape)} pool "
              f"{tuple(args[1].shape)} lengths {args[4].tolist()} "
              f"max_abs_err {err:.3e}", flush=True)
        check(torch.allclose(got, want, **TOL),
              f"K8 disagrees with its plain version on {name} ({err:.3e})")
        if shape is None:
            check(torch.equal(got[0], got[1]),
                  "K8 rows over shared pages are not bitwise equal")
    return max_abs_err


def timing_phase(device) -> dict:
    """Kernel, plain and library times at the main path's shapes, and
    the least time the card could take for the same work."""
    phase("4. K8 timing at the main path's shapes")
    shape = CASES["main_path"]
    args = paged_inputs(99, device=device, **shape)
    q, _, _, table, lengths = args
    live = sum(shape["lengths"])
    n_bytes, n_flops = paged_bytes_flops(shape, q, table, lengths)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / F32_FLOP_PER_S * 1e3
    library = sdpa_over_extent(shape, args, device)
    lib_err = (library()[:, :, 0] - pa.paged_attention_plain(*args)
               ).abs().max().item()
    timing, enqueue = {}, {}
    for key, fn in (("ms", lambda: pa.paged_attention_cuda(*args)),
                    ("plain_ms", lambda: pa.paged_attention_plain(*args)),
                    ("library_ms", library),
                    ("empty_launch_ms", lambda: torch.cuda._sleep(0))):
        timing[key], enqueue[key] = time_ms(fn, device)
    timing.update(bound_ms=max(bytes_ms, ops_ms),
                  bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"K8 bound {timing['bound_ms']:.6f} ms beside one empty kernel "
          f"launch {timing['empty_launch_ms']:.6f} ms (torch.cuda._sleep(0),"
          " timed the same way)", flush=True)
    print(json.dumps({"kernel": "paged_attention", **timing,
                      "live_positions": live, "bytes": n_bytes,
                      "flops": n_flops,
                      "library_call": "F.scaled_dot_product_attention over "
                                      "the pre-gathered extent",
                      "library_max_abs_err": lib_err,
                      "host_enqueue_ms_per_50": enqueue}), flush=True)
    return timing


def sdpa_over_extent(shape, args, device):
    """K8's library yardstick: SDPA over each row's pages gathered into
    the contiguous extent (GQA expanded, dead positions masked); the
    gather is done here, outside the timing."""
    q, k_pool, v_pool, table, lengths = args
    B, H, hd, KV = shape["B"], shape["H"], shape["hd"], shape["KV"]
    S = shape["M"] * shape["ps"]
    kk, vv = (pool[table].reshape(B, S, KV, hd).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
        for pool in (k_pool, v_pool))
    mask = (torch.arange(S, device=device)[None, :]
            < lengths[:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask)


def paged_bytes_flops(shape, q, table, lengths):
    """K8's bytes (each live K/V position read once, q, table and
    lengths read and the output written once) and FLOP (q.k and p.v)."""
    live = sum(shape["lengths"])
    KV, H, hd = shape["KV"], shape["H"], shape["hd"]
    n_bytes = (2 * live * KV * hd * 4 + 2 * q.numel() * 4
               + table.numel() * 4 + lengths.numel() * 4)
    return n_bytes, 4 * live * H * hd


def long_context_phase(device) -> dict:
    """K8 at Qwen2.5-3B's decode geometry with 4096-16384 live positions:
    against its plain version (TOL), then timed beside its byte bound,
    SDPA over the pre-gathered extent and one empty kernel launch timed
    the same way (torch.cuda._sleep(0))."""
    phase("4g. K8 at long context (Qwen2.5-3B decode geometry)")
    shape = LONG_CONTEXT
    args = paged_inputs(97, device=device, **shape)
    q, _, _, table, lengths = args
    got = pa.paged_attention_cuda(*args)
    want = pa.paged_attention_plain(*args)
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, **TOL),
          f"K8 disagrees with its plain version at long context ({err:.3e})")
    del got, want
    n_bytes, n_flops = paged_bytes_flops(shape, q, table, lengths)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_flops / F32_FLOP_PER_S * 1e3
    library = sdpa_over_extent(shape, args, device)
    t = {}
    for key, fn, iters in (
            ("ms", lambda: pa.paged_attention_cuda(*args), 50),
            ("plain_ms", lambda: pa.paged_attention_plain(*args), 5),
            ("library_ms", library, 20),
            ("empty_launch_ms", lambda: torch.cuda._sleep(0), 50)):
        t[key], _ = time_ms(fn, device, iters=iters, warmup=3)
    t.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(json.dumps({"kernel": "paged_attention", "shape": "long_context",
                      **t, "lengths": shape["lengths"],
                      "splits": -(-shape["M"] // pa.split_span(
                          shape["B"], shape["KV"], shape["M"],
                          torch.cuda.get_device_properties(
                              device).multi_processor_count)),
                      "bytes": n_bytes, "flops": n_flops,
                      "max_abs_err": err,
                      "achieved_bytes_per_s": n_bytes / (t["ms"] / 1e3),
                      "share_of_bound": t["bound_ms"] / t["ms"],
                      "library_call": "F.scaled_dot_product_attention over "
                                      "the pre-gathered extent",
                      "library_kernels": device_kernels(library, device),
                      "kernel_kernels": device_kernels(
                          lambda: pa.paged_attention_cuda(*args), device)}),
          flush=True)
    del args, q, table, lengths, library
    torch.cuda.empty_cache()
    return t


INNER_SCALARS = (0.1, 0.05, 0.9, 0.75)     # inv_gamma, lr, mu, alpha
SYNC_SCALARS = (1.0, 2.0, 0.1, 0.9)        # gamma_scale, inv_rho, lr, mu
PARLE_CASES = {                            # replicas, elements per replica
    "ragged_n1": (1, 1001, torch.float32),
    "ragged_n2": (2, 8195, torch.float32),
    "aligned_n3": (3, 3 * 8192, torch.float32),
    "bf16_ragged_n3": (3, 1001, torch.bfloat16),
    "bf16_n2": (2, 4 * 8192, torch.bfloat16),
}
PARLE_TIMING = (2, 1 << 26)                # 2 replicas x 2^26 float32
RANDN_CHUNK = 1 << 26                      # main-path inputs drawn in chunks


def _randn(seed, shape, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


def _k1(y, z, v, g, x, scalars, device):
    """(kernel outputs, plain outputs) of K1 on copies of the inputs."""
    s = pu.pack_scalars(*scalars, device=device)
    want = pu.parle_inner_update_plain(y, z, v, g, x, s)
    got = pu.parle_inner_update_cuda(y.clone(), z.clone(), v.clone(), g, x, s)
    return got, want


def _k2(x, z, v, xbar, scalars, emit_y, device):
    s = pu.pack_scalars(*scalars, device=device)
    y_dtype = torch.bfloat16 if emit_y else None
    want = pu.parle_sync_update_plain(x, z, v, xbar, s, y_dtype=y_dtype)
    y_out = torch.empty_like(x, dtype=torch.bfloat16) if emit_y else None
    got = pu.parle_sync_update_cuda(x.clone(), z, v.clone(), xbar, s,
                                    y_out=y_out)
    return got, want


def _bump(scalars, i):
    return tuple(s * 1.5 + 0.25 if j == i else s
                 for j, s in enumerate(scalars))


def parle_check_phase(device) -> dict:
    """K1 and K2 against their plain versions, bit for bit, at every
    case; each scalar bumped must move the result.  Returns the largest
    absolute error seen per kernel (0.0 when every case is bitwise)."""
    phase("3b. K1 and K2 against their plain versions (bitwise)")
    errs = {"parle_inner_update": 0.0, "parle_sync_update": 0.0}
    for i, (name, (n, m, dtype)) in enumerate(PARLE_CASES.items()):
        y, z, v, g, x = (_randn(100 * i + s, (n, m), device)
                         for s in range(5))
        y, g = y.to(dtype), g.to(dtype)
        got, want = _k1(y, z, v, g, x, INNER_SCALARS, device)
        torch.cuda.synchronize(device)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        errs["parle_inner_update"] = max(errs["parle_inner_update"], err)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K1 differs from its plain version on {name} ({err:.3e})")
        for j in range(4):
            moved, _ = _k1(y, z, v, g, x, _bump(INNER_SCALARS, j), device)
            check(not all(torch.equal(a, b) for a, b in zip(moved, got)),
                  f"K1 ignores scalar {j} on {name}")
        line = [f"{name}: (n {n}, M {m}, {str(dtype)[6:]}) K1 bitwise"]
        # any (M,) row: with one replica its own mean would cancel inv_rho
        xbar = _randn(100 * i + 5, (m,), device)
        for emit_y in (False, True):
            got, want = _k2(x, z, v, xbar, SYNC_SCALARS, emit_y, device)
            torch.cuda.synchronize(device)
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(got, want))
            errs["parle_sync_update"] = max(errs["parle_sync_update"], err)
            check(len(got) == len(want)
                  and all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K2 (y' {emit_y}) differs from its plain version on "
                  f"{name} ({err:.3e})")
            if emit_y:
                check(torch.equal(got[2], got[0].to(torch.bfloat16)),
                      "K2's fused y' is not bf16(x')")
            for j in range(4):
                moved, _ = _k2(x, z, v, xbar, _bump(SYNC_SCALARS, j), emit_y,
                               device)
                check(not all(torch.equal(a, b) for a, b in zip(moved, got)),
                      f"K2 ignores scalar {j} on {name}")
            line.append(f"K2{' + bf16 y' if emit_y else ''} bitwise")
        print(", ".join(line) + "; every scalar moves both", flush=True)
    return errs


COMPRESS_CASES = {                # local rows R, payloads n, elements M
    "R1_n1": (1, 1, 8192),
    "R2_n2": (2, 2, 16384),
    "R3_n3": (3, 3, 24576),
    "R2_n3": (2, 3, 16384),
    "R3_n1": (3, 1, 8192),
}
HALF_EVEN = (127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5, 4.5)


def _payload_input(seed, n, m, device):
    """c (n, m): random, except row 0's chunk 0 (amax 127, so scale 1.0
    exactly, with +-k.5 values that pin half-to-even rounding) and
    chunk 1 (all zeros: scale 1, codes 0)."""
    c = _randn(seed, (n, m), device) * 5
    c[0, :1024] = _randn(seed + 1, (1024,), device).clamp(-100, 100)
    c[0, :len(HALF_EVEN)] = torch.tensor(HALF_EVEN, device=device)
    c[0, 1024:2048] = 0
    return c


def _k4(c):
    want = pu.quantize_ef_plain(c)
    R, M = c.shape
    q = torch.empty((R, M), dtype=torch.int8, device=c.device)
    s = torch.empty((R, M // 1024), device=c.device)
    got = pu.quantize_ef_cuda(c.clone(), q, s, torch.empty_like(c))
    in_place = c.clone()
    got_in_place = pu.quantize_ef_cuda(in_place, q.clone(), s.clone(),
                                       in_place)
    return got, got_in_place, want


def _k5(x, z, v, q, s, scalars, emit_y, device):
    sc = pu.pack_scalars(*scalars, device=device)
    y_dtype = torch.bfloat16 if emit_y else None
    want = pu.parle_sync_dequant_update_plain(x, z, v, q, s, sc,
                                              y_dtype=y_dtype)
    y_out = torch.empty_like(x, dtype=torch.bfloat16) if emit_y else None
    got = pu.parle_sync_dequant_update_cuda(x.clone(), z, v.clone(), q, s, sc,
                                            y_out=y_out)
    return got, want


def _k6(x, z, v, c, e, scalars, emit_y, device):
    sc = pu.pack_scalars(*scalars, device=device)
    y_dtype = torch.bfloat16 if emit_y else None
    want = pu.parle_apply_quantize_plain(x, z, v, c, e, sc, y_dtype=y_dtype)
    R, M = x.shape
    q = torch.empty((R, M), dtype=torch.int8, device=device)
    s = torch.empty((R, M // 1024), device=device)
    y_out = torch.empty_like(x, dtype=torch.bfloat16) if emit_y else None
    got = pu.parle_apply_quantize_cuda(x.clone(), z, v.clone(), c, e.clone(),
                                       q, s, sc, y_out=y_out)
    return got, want


def _max_err(got, want):
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(got, want))


def _same(got, want):
    return len(got) == len(want) and all(torch.equal(a, b)
                                         for a, b in zip(got, want))


def compress_check_phase(device) -> dict:
    """K4, K5 and K6 against their plain versions, bit for bit (codes,
    scales, residuals and the updated state), at every case: 1-3 rows,
    K5 with as many and with other numbers of payloads than rows, a
    half-to-even chunk and an all-zero chunk, with and without the fused
    bf16 y'; each scalar bumped must move K5's and K6's result.  Then a
    chunk holding a NaN: its scale is NaN in both, all else equal."""
    phase("3c. K4, K5 and K6 against their plain versions (bitwise)")
    errs = {"quantize_ef": 0.0, "parle_sync_dequant": 0.0,
            "parle_apply_quantize": 0.0}
    for i, (name, (R, n, m)) in enumerate(COMPRESS_CASES.items()):
        c = _payload_input(300 + 10 * i, n, m, device)
        got, got_in_place, want = _k4(c)
        torch.cuda.synchronize(device)
        errs["quantize_ef"] = max(errs["quantize_ef"], _max_err(got, want))
        check(_same(got, want) and _same(got_in_place, want),
              f"K4 differs from its plain version on {name}")
        check(float(want[1][0, 0]) == 1.0 and float(want[1][0, 1]) == 1.0
              and want[0][0, :len(HALF_EVEN)].tolist()
              == [127, 0, 2, 2, 0, -2, -2, 126, -4, 4],
              "the half-to-even / zero chunks did not quantize as expected")
        q, s, _ = got
        x, z, v, e = (_randn(400 + 10 * i + k, (R, m), device)
                      for k in range(4))
        cbar = _randn(450 + i, (m,), device)
        for t in (x, z, v, e):
            t[:, 2048:3072] = 0            # K6's payload: an all-zero chunk
        cbar[2048:3072] = 0
        line = [f"{name}: (R {R}, n {n}, M {m}) K4 bitwise (+ in place)"]
        for emit_y in (False, True):
            for kernel, key, args in (
                    (_k5, "parle_sync_dequant", (x, z, v, q, s)),
                    (_k6, "parle_apply_quantize", (x, z, v, cbar, e))):
                got, want = kernel(*args, SYNC_SCALARS, emit_y, device)
                torch.cuda.synchronize(device)
                errs[key] = max(errs[key], _max_err(got, want))
                check(_same(got, want), f"{key} (y' {emit_y}) differs from "
                      f"its plain version on {name}")
                if emit_y:
                    check(torch.equal(got[-1], got[0].to(torch.bfloat16)),
                          f"{key}'s fused y' is not bf16(x')")
                for j in range(4):
                    moved, _ = kernel(*args, _bump(SYNC_SCALARS, j), emit_y,
                                      device)
                    check(not _same(moved, got),
                          f"{key} ignores scalar {j} on {name}")
            line.append(f"K5 + K6{' + bf16 y' if emit_y else ''} bitwise")
        print(", ".join(line) + "; every scalar moves both", flush=True)

    c = _payload_input(390, 2, 16384, device)
    c[1, 3000] = float("nan")                  # row 1, chunk 2
    got, _, want = _k4(c)
    torch.cuda.synchronize(device)
    nan_s = torch.isnan(want[1])
    check(torch.equal(nan_s, torch.isnan(got[1])) and bool(nan_s[1, 2])
          and int(nan_s.sum()) == 1, "K4's scale of a NaN chunk is not NaN "
          "as in its plain version")
    keep = torch.ones_like(c, dtype=torch.bool)
    keep[1, 2048:3072] = False
    check(torch.equal(got[0][keep], want[0][keep])
          and torch.equal(got[1][~nan_s], want[1][~nan_s])
          and torch.equal(got[2][keep], want[2][keep])
          and bool(torch.isnan(got[2][~keep]).all()),
          "K4 differs from its plain version outside a NaN chunk")
    print("NaN chunk: scale NaN in both, residuals NaN, every other chunk "
          "bitwise", flush=True)
    return errs


ELASTIC_SCALARS = (2.0, 0.1, 0.9)          # inv_rho, lr, mu


def _k7(x, v, g, ref, scalars, device):
    """(kernel outputs, plain outputs) of K7 on copies of x and v."""
    s = pu.pack_scalars(*scalars, device=device)
    want = pu.elastic_worker_update_plain(x, v, g, ref, s)
    got = pu.elastic_worker_update_cuda(x.clone(), v.clone(), g, ref, s)
    return got, want


def elastic_check_phase(device) -> dict:
    """K7 against its plain version, bit for bit, at the K1/K2 cases
    (ragged lengths, 1-3 replicas) with g in float32 and in bf16; each
    scalar bumped must move the result.  Then one launch on the inputs
    themselves: x and v updated in place, ref only read.  Returns the
    largest absolute error seen."""
    phase("3d. K7 against its plain version (bitwise)")
    err = 0.0
    for i, (name, (n, m, _)) in enumerate(PARLE_CASES.items()):
        x, v, g = (_randn(500 + 10 * i + s, (n, m), device) for s in range(3))
        ref = _randn(500 + 10 * i + 3, (m,), device)
        for dtype in (torch.float32, torch.bfloat16):
            got, want = _k7(x, v, g.to(dtype), ref, ELASTIC_SCALARS, device)
            torch.cuda.synchronize(device)
            err = max(err, _max_err(got, want))
            check(_same(got, want), f"K7 (g {dtype}) differs from its plain "
                  f"version on {name} ({err:.3e})")
            for j in range(3):
                moved, _ = _k7(x, v, g.to(dtype), ref,
                               _bump(ELASTIC_SCALARS, j), device)
                check(not _same(moved, got),
                      f"K7 ignores scalar {j} on {name}")
        print(f"{name}: (n {n}, M {m}) K7 bitwise with f32 and bf16 g; "
              f"every scalar moves it", flush=True)
    x, v, g = (_randn(590 + s, (3, 8195), device) for s in range(3))
    ref = _randn(593, (8195,), device)
    ref_before = ref.clone()
    s = pu.pack_scalars(*ELASTIC_SCALARS, device=device)
    want = pu.elastic_worker_update_plain(x, v, g, ref, s)
    ptrs = (x.data_ptr(), v.data_ptr())
    out = pu.elastic_worker_update_cuda(x, v, g, ref, s)
    torch.cuda.synchronize(device)
    check(out[0] is x and out[1] is v and (x.data_ptr(), v.data_ptr()) == ptrs
          and _same((x, v), want) and torch.equal(ref, ref_before),
          "K7 in place: x, v not updated in place as the plain version, or "
          "ref written")
    print("in place: x and v updated where they lie, bitwise; ref untouched",
          flush=True)
    return {"elastic_update": err}


def parle_main_shape_phase(device, n, m) -> dict:
    """K1, K2, K4-K7 at the training path's shape, (n, m) float32, against
    their plain versions.  The inputs are drawn column chunk by column
    chunk from per-chunk seeds, so after the kernel has run in place
    each chunk's inputs are drawn again and the plain version (which is
    elementwise) is evaluated one chunk at a time: the full-size plain
    temporaries never exist."""
    phase(f"6c. K1, K2, K4, K5, K6 and K7 at the training path's shape "
          f"({n}, {m})")
    chunks = [(c, min(RANDN_CHUNK, m - c)) for c in range(0, m, RANDN_CHUNK)]

    def draw(stream, j, width):
        return _randn(7919 * j + stream, (n, width), device)

    def fill(streams):
        bufs = [torch.empty((n, m), device=device) for _ in streams]
        for j, (c, w) in enumerate(chunks):
            for s, buf in zip(streams, bufs):
                buf[:, c:c + w] = draw(s, j, w)
        return bufs

    errs = {}
    y, z, v, g, x = fill(range(5))
    pu.parle_inner_update_cuda(y, z, v, g, x,
                               pu.pack_scalars(*INNER_SCALARS, device=device))
    s = pu.pack_scalars(*INNER_SCALARS, device=device)
    err, same = 0.0, True
    for j, (c, w) in enumerate(chunks):
        want = pu.parle_inner_update_plain(*(draw(k, j, w) for k in range(5)),
                                           s)
        for got, wa in zip((y, z, v), want):
            err = max(err, (got[:, c:c + w] - wa).abs().max().item())
            same &= torch.equal(got[:, c:c + w], wa)
    errs["parle_inner_update"] = err
    check(same, f"K1 differs from its plain version at ({n}, {m}) "
          f"({err:.3e})")
    del y, z, v, g, x
    torch.cuda.empty_cache()

    x, z, v = fill(range(10, 13))
    xbar = torch.empty(m, device=device)
    for j, (c, w) in enumerate(chunks):
        xbar[c:c + w] = _randn(7919 * j + 13, (w,), device)
    pu.parle_sync_update_cuda(x, z, v, xbar,
                              pu.pack_scalars(*SYNC_SCALARS, device=device))
    s = pu.pack_scalars(*SYNC_SCALARS, device=device)
    err, same = 0.0, True
    for j, (c, w) in enumerate(chunks):
        want = pu.parle_sync_update_plain(
            *(draw(k, j, w) for k in range(10, 13)),
            _randn(7919 * j + 13, (w,), device), s)
        for got, wa in zip((x, v), want):
            err = max(err, (got[:, c:c + w] - wa).abs().max().item())
            same &= torch.equal(got[:, c:c + w], wa)
    errs["parle_sync_update"] = err
    check(same, f"K2 differs from its plain version at ({n}, {m}) "
          f"({err:.3e})")
    del x, z, v, xbar
    torch.cuda.empty_cache()

    # K4 in place (c = e, as the sync runs it), then K5 on its payload;
    # the plain versions see the same column chunks (1024-aligned, so
    # no int8 chunk is cut)
    e, = fill([20])
    q = torch.empty((n, m), dtype=torch.int8, device=device)
    s = torch.empty((n, m // 1024), device=device)
    pu.quantize_ef_cuda(e, q, s, e)
    err, same = 0.0, True
    for j, (c, w) in enumerate(chunks):
        want = pu.quantize_ef_plain(draw(20, j, w))
        got = (q[:, c:c + w], s[:, c // 1024:(c + w) // 1024],
               e[:, c:c + w])
        err = max(err, _max_err(got, want))
        same &= _same(got, want)
    errs["quantize_ef"] = err
    check(same, f"K4 differs from its plain version at ({n}, {m})")
    del e
    torch.cuda.empty_cache()
    x, z, v = fill(range(21, 24))
    sc = pu.pack_scalars(*SYNC_SCALARS, device=device)
    pu.parle_sync_dequant_update_cuda(x, z, v, q, s, sc)
    err, same = 0.0, True
    for j, (c, w) in enumerate(chunks):
        want = pu.parle_sync_dequant_update_plain(
            *(draw(k, j, w) for k in range(21, 24)), q[:, c:c + w],
            s[:, c // 1024:(c + w) // 1024], sc)
        got = (x[:, c:c + w], v[:, c:c + w])
        err = max(err, _max_err(got, want))
        same &= _same(got, want)
    errs["parle_sync_dequant"] = err
    check(same, f"K5 differs from its plain version at ({n}, {m})")
    del x, z, v
    torch.cuda.empty_cache()

    x, z, v, e = fill(range(30, 34))
    cbar = torch.empty(m, device=device)
    for j, (c, w) in enumerate(chunks):
        cbar[c:c + w] = _randn(7919 * j + 34, (w,), device)
    pu.parle_apply_quantize_cuda(x, z, v, cbar, e, q, s, sc)
    err, same = 0.0, True
    for j, (c, w) in enumerate(chunks):
        want = pu.parle_apply_quantize_plain(
            *(draw(k, j, w) for k in range(30, 33)), cbar[c:c + w],
            draw(33, j, w), sc)
        got = (x[:, c:c + w], v[:, c:c + w], q[:, c:c + w],
               s[:, c // 1024:(c + w) // 1024], e[:, c:c + w])
        err = max(err, _max_err(got, want))
        same &= _same(got, want)
    errs["parle_apply_quantize"] = err
    check(same, f"K6 differs from its plain version at ({n}, {m})")
    del x, z, v, e, cbar, q, s
    torch.cuda.empty_cache()

    x, v, g = fill(range(40, 43))
    ref = torch.empty(m, device=device)
    for j, (c, w) in enumerate(chunks):
        ref[c:c + w] = _randn(7919 * j + 43, (w,), device)
    sc = pu.pack_scalars(*ELASTIC_SCALARS, device=device)
    pu.elastic_worker_update_cuda(x, v, g, ref, sc)
    err, same = 0.0, True
    for j, (c, w) in enumerate(chunks):
        want = pu.elastic_worker_update_plain(
            *(draw(k, j, w) for k in range(40, 43)), ref[c:c + w], sc)
        got = (x[:, c:c + w], v[:, c:c + w])
        err = max(err, _max_err(got, want))
        same &= _same(got, want)
    errs["elastic_update"] = err
    check(same, f"K7 differs from its plain version at ({n}, {m})")
    del x, v, g, ref
    torch.cuda.empty_cache()
    print(f"K1, K2, K4, K5, K6 and K7 bitwise equal to their plain versions "
          f"over {len(chunks)} chunks", flush=True)
    return errs


def parle_timing_phase(device) -> dict:
    """K1 and K2 kernel and plain times at 2 replicas x 2^26 float32,
    beside the byte bound.  No single PyTorch call computes Eq. 8a-8b or
    8c-8d, so there is no library column."""
    phase("4b. K1 and K2 timing at 2 replicas x 2^26 float32")
    n, m = PARLE_TIMING
    y, z, v, g, x = (_randn(900 + s, (n, m), device) for s in range(5))
    xbar = x.mean(0)
    s1 = pu.pack_scalars(*INNER_SCALARS, device=device)
    s2 = pu.pack_scalars(*SYNC_SCALARS, device=device)
    # bytes: each input read once, each output written once (in place:
    # K1 reads y, z, v, g, x and writes y, z, v; K2 reads x, z, v and
    # the one xbar row and writes x, v); operations per element: 15 / 11
    work = {
        "parle_inner_update": (8 * n * m * 4, 15 * n * m,
                               lambda: pu.parle_inner_update_cuda(
                                   y, z, v, g, x, s1),
                               lambda: pu.parle_inner_update_plain(
                                   y, z, v, g, x, s1)),
        "parle_sync_update": ((3 * n + 1) * m * 4 + 2 * n * m * 4, 11 * n * m,
                              lambda: pu.parle_sync_update_cuda(
                                  x, z, v, xbar, s2),
                              lambda: pu.parle_sync_update_plain(
                                  x, z, v, xbar, s2)),
    }
    return _time_flat_kernels(work, device, n, m)


def _time_flat_kernels(work, device, n, m) -> dict:
    """``work``: name -> (bytes, operations, kernel, plain).  Times each
    kernel and its plain version beside its bound; none has a library
    call that computes the same function."""
    out = {}
    for name, (n_bytes, n_ops, kernel, plain) in work.items():
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_FLOP_PER_S * 1e3
        t = {}
        for key, fn in (("ms", kernel), ("plain_ms", plain)):
            t[key], _ = time_ms(fn, device, iters=30, warmup=5)
        t.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                 library_ms=None)
        print(json.dumps({"kernel": name, **t, "replicas": n,
                          "elements_per_replica": m, "bytes": n_bytes,
                          "flops": n_ops,
                          "achieved_bytes_per_s": n_bytes / (t["ms"] / 1e3),
                          "share_of_3.35TB/s": bytes_ms / t["ms"],
                          "library_call": "none: no single PyTorch call "
                                          "computes this function"}),
              flush=True)
        out[name] = t
    return out


def compress_timing_phase(device) -> dict:
    """K4, K5 and K6 kernel and plain times at 2 replicas x 2^26 float32
    (K5 with the 2 replicas' payloads), beside the byte bound.  No single
    PyTorch call computes any of the three, so there is no library
    column."""
    phase("4c. K4, K5 and K6 timing at 2 replicas x 2^26 float32")
    n, m = PARLE_TIMING
    x, z, v, e, c = (_randn(950 + k, (n, m), device) for k in range(5))
    cbar = c.mean(0)
    q = torch.empty((n, m), dtype=torch.int8, device=device)
    s = torch.empty((n, m // 1024), device=device)
    pu.quantize_ef_cuda(c, q, s, torch.empty_like(c))
    q_out, s_out = q.clone(), s.clone()
    sc = pu.pack_scalars(*SYNC_SCALARS, device=device)
    nm, n_s = n * m, n * m // 1024            # elements, scales
    # bytes: each input read once, each output written once.  K4 reads
    # c, writes q (1 B), s and e; K5 reads x, z, v and the n payloads,
    # writes x, v; K6 reads x, z, v, e and the one (m,) c, writes x, v,
    # e, q and s.  Operations per element: K4 8 (abs, max, divide, round,
    # 2 clamps, multiply, subtract), K5 2n + 11 (dequantize, sum, mean,
    # then K2's 11), K6 20 (K2's 11, + e, then K4's 8)
    work = {
        "quantize_ef": (9 * nm + 4 * n_s, 8 * nm,
                        lambda: pu.quantize_ef_cuda(c, q_out, s_out, e),
                        lambda: pu.quantize_ef_plain(c)),
        "parle_sync_dequant": (20 * nm + nm + 4 * n_s, (2 * n + 11) * nm,
                               lambda: pu.parle_sync_dequant_update_cuda(
                                   x, z, v, q, s, sc),
                               lambda: pu.parle_sync_dequant_update_plain(
                                   x, z, v, q, s, sc)),
        "parle_apply_quantize": (29 * nm + 4 * m + 4 * n_s, 20 * nm,
                                 lambda: pu.parle_apply_quantize_cuda(
                                     x, z, v, cbar, e, q_out, s_out, sc),
                                 lambda: pu.parle_apply_quantize_plain(
                                     x, z, v, cbar, e, sc)),
    }
    out = _time_flat_kernels(work, device, n, m)
    del work, x, z, v, e, c, cbar, q, s, q_out, s_out
    torch.cuda.empty_cache()
    return out


def elastic_timing_phase(device) -> dict:
    """K7 kernel and plain times at 2 replicas x 2^26 float32, beside the
    byte bound.  No single PyTorch call computes Eq. 7a, so there is no
    library column."""
    phase("4d. K7 timing at 2 replicas x 2^26 float32")
    n, m = PARLE_TIMING
    x, v, g = (_randn(980 + k, (n, m), device) for k in range(3))
    ref = x.mean(0)
    sc = pu.pack_scalars(*ELASTIC_SCALARS, device=device)
    # bytes: K7 reads x, v, g and the one ref row and writes x, v (in
    # place); operations per element: 9 (x - ref, * inv_rho, + g, mu v,
    # + g_e, mu v', + g_e, * lr, x -)
    work = {"elastic_update": ((3 * n + 1) * m * 4 + 2 * n * m * 4, 9 * n * m,
                               lambda: pu.elastic_worker_update_cuda(
                                   x, v, g, ref, sc),
                               lambda: pu.elastic_worker_update_plain(
                                   x, v, g, ref, sc))}
    out = _time_flat_kernels(work, device, n, m)
    del work, x, v, g, ref
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------
# K3 (flash attention) and K9 (SSD scan)
# ------------------------------------------------------------------

FLASH_CASES = {            # name: (B, T, H, hd, window, dtype)
    "causal_hd32": (2, 128, 3, 32, 0, torch.float32),
    "causal_hd64": (2, 128, 3, 64, 0, torch.float32),
    "window32": (1, 128, 2, 32, 32, torch.float32),
    "bf16": (1, 128, 2, 64, 0, torch.bfloat16),
    "ragged_T200": (2, 200, 4, 128, 0, torch.float32),
    "ragged_T200_window50": (1, 200, 2, 64, 50, torch.float32),
    # one row past, one short of and one past two 64-row tiles at hd 128
    "ragged_T65_hd128": (1, 65, 2, 128, 0, torch.float32),
    "ragged_T127_hd128": (2, 127, 2, 128, 0, torch.float32),
    "ragged_T129_hd128": (1, 129, 3, 128, 0, torch.float32),
    "bf16_hd128": (2, 192, 2, 128, 0, torch.bfloat16),
    "prefill_shape": (2, 2048, 16, 128, 0, torch.float32),
}
FLASH_BF16_TOL = dict(rtol=5e-2, atol=5e-2)
SSD_CASES = {              # name: (B, T, nh, P, N, chunk, dtype)
    "n16_p32": (2, 128, 3, 32, 16, 128, torch.float32),
    "n64_p64": (2, 128, 3, 64, 64, 128, torch.float32),
    "n16_p32_bf16": (2, 128, 3, 32, 16, 128, torch.bfloat16),
    "n64_p64_bf16": (2, 128, 3, 64, 64, 128, torch.bfloat16),
    # several chunks, so the state passes between them
    "multi_chunk_n16_p32": (2, 512, 3, 32, 16, 128, torch.float32),
    "multi_chunk_n64_p64": (2, 512, 3, 64, 64, 128, torch.float32),
    "multi_chunk_bf16": (2, 512, 3, 64, 64, 128, torch.bfloat16),
    # chunks that are no multiple of 16 (ragged tiles), the least state
    "q24": (2, 96, 3, 32, 16, 24, torch.float32),
    "q5_n8": (1, 20, 2, 32, 8, 5, torch.float32),
    # Zamba2-1.2B's geometry: 64 heads of 64, state 64
    "zamba2_shape": (2, 2048, 64, 64, 64, 128, torch.float32),
    # x, B and C as views of one xBC tensor, as models/mamba2.py hands them
    "strided_xbc": (2, 256, 4, 64, 128, 128, torch.float32),
    "mamba2_shape": (2, 2048, 64, 64, 128, 128, torch.float32),
}
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 y and h: both sides round their float32 result to bfloat16
SSD_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
FLASH_PREFILL = (2, 1024)  # full-width Qwen2.5-3B prompt batch (B, T)
MAMBA_FORWARD = (2, 2048)  # full-width Mamba2-1.3B forward (B, T)
# full-width logits after 36 / 48 layers, kernel path against plain path
PATH_LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)


def flash_inputs(seed, B, T, H, hd, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((B, T, H, hd), generator=gen, device=device).to(dtype)
            for _ in range(3)]


def ssd_inputs(seed, B, T, nh, P, N, dtype, device, strided=False):
    """The reference kernel test's distributions: x and B, C ~ 0.5 N(0,1),
    dt = softplus(N(0,1)), A = -exp(0.3 N(0,1)).  ``strided``: x, B and C
    are slices of one (B, T, nh P + 2 N) tensor, laid out as
    ``models/mamba2.py::_ssd_inputs`` takes them from xBC."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x, dt = r(B, T, nh, P) * 0.5, torch.nn.functional.softplus(r(B, T, nh))
    A = -torch.exp(r(nh) * 0.3)
    Bm, Cm = r(B, T, N) * 0.5, r(B, T, N) * 0.5
    x, dt, Bm, Cm = (t.to(dtype) for t in (x, dt, Bm, Cm))
    if strided:
        xbc = torch.cat([x.reshape(B, T, nh * P), Bm, Cm], dim=-1)
        di = nh * P
        x = xbc[..., :di].reshape(B, T, nh, P)
        Bm, Cm = xbc[..., di:di + N], xbc[..., di + N:]
    return x, dt, A, Bm, Cm


def flash_check_phase(device) -> float:
    """K3 against its plain version at every case (2e-5 in float32, 5e-2
    in bf16), each launched with host synchronisation forbidden; returns
    the largest float32 absolute error."""
    phase("3e. K3 (flash attention) against its plain version")
    max_err = 0.0
    for i, (name, (B, T, H, hd, window, dtype)) in enumerate(
            FLASH_CASES.items()):
        q, k, v = flash_inputs(30 + i, B, T, H, hd, dtype, device)
        got = without_sync(fa.flash_attention_cuda, q, k, v, window=window)
        torch.cuda.synchronize(device)
        want = fa.flash_attention_plain(q, k, v, window=window)
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_BF16_TOL if dtype == torch.bfloat16 else TOL
        if dtype == torch.float32:
            max_err = max(max_err, err)
        print(f"{name}: (B, T, H, hd) {(B, T, H, hd)} window {window} "
              f"{str(dtype)[6:]} max_abs_err {err:.3e}", flush=True)
        check(torch.allclose(got.float(), want.float(), **tol),
              f"K3 disagrees with its plain version on {name} ({err:.3e})")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return max_err


def ssd_check_phase(device) -> float:
    """K9 against its plain version (the naive recurrence) at every case:
    y and the final state within 1e-4 in float32 (1e-2 for bf16 outputs);
    each case launched twice (bitwise equal), once with host
    synchronisation forbidden; returns the largest float32 absolute
    error."""
    phase("3f. K9 (SSD scan) against its plain version")
    max_err = 0.0
    for i, (name, (B, T, nh, P, N, chunk, dtype)) in enumerate(
            SSD_CASES.items()):
        args = ssd_inputs(50 + i, B, T, nh, P, N, dtype, device,
                          strided=name.startswith("strided"))
        got = without_sync(ssd.ssd_scan_cuda, *args, chunk)
        again = ssd.ssd_scan_cuda(*args, chunk)
        torch.cuda.synchronize(device)
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"two K9 launches on {name} differ")
        want = ssd.ssd_scan_plain(*args)
        tol = SSD_BF16_TOL if dtype == torch.bfloat16 else SSD_TOL
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)]
        if dtype == torch.float32:
            max_err = max(max_err, *errs)
        print(f"{name}: (B, T, nh, P, N, Q) {(B, T, nh, P, N, chunk)} "
              f"{str(dtype)[6:]} max_abs_err y {errs[0]:.3e} h_final "
              f"{errs[1]:.3e}", flush=True)
        for g, w, what in zip(got, want, ("y", "h_final")):
            check(torch.allclose(g.float(), w.float(), **tol),
                  f"K9 {what} disagrees with its plain version on {name}")
        del args, got, again, want
    torch.cuda.empty_cache()
    return max_err


def flash_timing_phase(device) -> dict:
    """K3, its plain version and SDPA (is_causal; timed here only, the
    port never calls it) at the Qwen2.5-3B prefill shape, beside the
    bound: the 2 B H T^2 hd causal FLOP, each a float32 product that K3
    computes as three TF32 tensor-core products (3xTF32), at the TF32
    rate, against q, k, v and o once each; the same FLOP at the SIMT
    float32 rate beside it (``simt_bound_ms``)."""
    phase("4e. K3 timing at the Qwen2.5-3B prefill shape")
    B, T, H, hd, window, dtype = FLASH_CASES["prefill_shape"]
    q, k, v = flash_inputs(99, B, T, H, hd, dtype, device)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)

    lib_err = (library().transpose(1, 2) - fa.flash_attention_plain(q, k, v)
               ).abs().max().item()
    n_flops = 2 * B * H * T * T * hd
    n_bytes = 4 * q.numel() * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n_flops / TF32_FLOP_PER_S * 1e3
    t = {}
    for key, fn, iters in (
            ("ms", lambda: fa.flash_attention_cuda(q, k, v), 30),
            ("plain_ms", lambda: fa.flash_attention_plain(q, k, v), 10),
            ("library_ms", library, 30)):
        t[key], _ = time_ms(fn, device, iters=iters, warmup=3)
    t.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms > ops_ms else "operations",
             bound_rate="3xTF32: 3 TF32 products a float32 product at "
                        "495 TFLOP/s",
             simt_bound_ms=n_flops / F32_FLOP_PER_S * 1e3)
    print(json.dumps({"kernel": "flash_attention", **t,
                      "shape": [B, T, H, hd], "flops": n_flops,
                      "bytes": n_bytes,
                      "achieved_flop_per_s": n_flops / (t["ms"] / 1e3),
                      "share_of_bound": t["bound_ms"] / t["ms"],
                      "library_call": "F.scaled_dot_product_attention("
                                      "is_causal=True), (B, H, T, hd)",
                      "library_kernels": device_kernels(library, device),
                      "library_max_abs_err": lib_err}), flush=True)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return t


def ssd_bound(B, T, nh, P, N, Q, itemsize=4):
    """The least work of the scan on these inputs: C B^T depends on no
    head, so its causal half counts once per (b, chunk), Q (Q + 1) N;
    per (b, head, chunk) the causal half of the scores times x,
    Q (Q + 1) P, and the readout and the state update, 4 Q N P.  Bytes:
    x, dt, B, C, y and the final state once each (A in float32)."""
    nc = T // Q
    n_flops = B * nc * Q * (Q + 1) * N + B * nh * nc * (
        Q * (Q + 1) * P + 4 * Q * N * P)
    n_bytes = (itemsize * (2 * B * T * nh * P + B * T * nh + 2 * B * T * N
                           + B * nh * N * P) + 4 * nh)
    return n_flops, n_bytes


def ssd_timing_phase(device) -> dict:
    """K9 and its plain version (the naive recurrence) at the Mamba2-1.3B
    shape, beside the bound (``ssd_bound``): K9 computes each float32
    product as three TF32 tensor-core products (3xTF32), so the
    operations count three times at the TF32 rate; the same FLOP at the
    SIMT float32 rate beside it (``simt_bound_ms``).  K9 is also timed
    on bf16 inputs.  No single PyTorch call computes the scan."""
    phase("4f. K9 timing at the Mamba2-1.3B shape")
    B, T, nh, P, N, Q, dtype = SSD_CASES["mamba2_shape"]
    args = ssd_inputs(98, B, T, nh, P, N, dtype, device)
    bf16 = ssd_inputs(98, B, T, nh, P, N, torch.bfloat16, device)
    n_flops, n_bytes = ssd_bound(B, T, nh, P, N, Q)
    # the earlier count, with C B^T once per head as well
    n_flops_per_head = B * nh * (T // Q) * (
        Q * (Q + 1) * N + Q * (Q + 1) * P + 4 * Q * N * P)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n_flops / TF32_FLOP_PER_S * 1e3
    t = {}
    for key, fn, iters in (
            ("ms", lambda: ssd.ssd_scan_cuda(*args, Q), 20),
            ("bf16_ms", lambda: ssd.ssd_scan_cuda(*bf16, Q), 20),
            ("plain_ms", lambda: ssd.ssd_scan_plain(*args), 3)):
        t[key], _ = time_ms(fn, device, iters=iters, warmup=1)
    t.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms > ops_ms else "operations",
             bound_rate="3xTF32: 3 TF32 products a float32 product at "
                        "495 TFLOP/s",
             simt_bound_ms=n_flops / F32_FLOP_PER_S * 1e3,
             library_ms=None)
    print(json.dumps({"kernel": "ssd_scan", **t,
                      "shape": {"B": B, "T": T, "nh": nh, "P": P, "N": N,
                                "Q": Q},
                      "flops": n_flops, "bytes": n_bytes,
                      "bf16_bytes": ssd_bound(B, T, nh, P, N, Q, 2)[1],
                      "flops_counting_cb_per_head": n_flops_per_head,
                      "achieved_flop_per_s": n_flops / (t["ms"] / 1e3),
                      "share_of_bound": t["bound_ms"] / t["ms"],
                      "share_of_simt_bound": t["simt_bound_ms"] / t["ms"],
                      "passes_ms": device_kernels(
                          lambda: ssd.ssd_scan_cuda(*args, Q), device, 10),
                      "library_call": "none: no single PyTorch call "
                                      "computes the scan"}), flush=True)
    del args, bf16
    torch.cuda.empty_cache()
    return t


def flash_prefill_phase(device, cfg, params) -> dict:
    """K3's path: one prompt batch through ``steps.make_prefill_step(cfg,
    use_flash=True)`` at full width (K3 once per layer), then through
    ``use_flash=False`` on the same params: logits and KV caches within
    PATH_LOGIT_TOL, the same next token in every row."""
    B, T = FLASH_PREFILL
    phase(f"5c. K3's path: full-width {cfg.name} prefill of {B} x {T} "
          "tokens through steps.make_prefill_step(use_flash=True)")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, T)), dtype=torch.int32, device=device)
    model = build_model(cfg)
    out = {}
    for use_flash in (True, False):
        cache = model.init_cache(params, B, T)
        prefill = steps.make_prefill_step(cfg, use_flash=use_flash)
        reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = launch_counts(
            flash_attention=cfg.num_layers if use_flash else 0)
        out[use_flash] = (logits, cache, wall, launches)
    (lf, cf, wall_f, launches), (lp, cp, wall_p, _) = out[True], out[False]
    logit_err = (lf - lp).abs().max().item()
    kv_err = max((cf.k - cp.k).abs().max().item(),
                 (cf.v - cp.v).abs().max().item())
    next_f, next_p = lf[:, -1].argmax(-1), lp[:, -1].argmax(-1)
    agree = (lf.argmax(-1) == lp.argmax(-1)).float().mean().item()
    res = {"launches": launches["flash_attention"], "prompt": [B, T],
           "max_logit_err": logit_err, "max_kv_cache_err": kv_err,
           "next_tokens_flash": next_f.tolist(),
           "next_tokens_plain": next_p.tolist(),
           "argmax_agree_share_all_positions": agree,
           "prefill_wall_s": {"flash": wall_f, "plain": wall_p}}
    print(json.dumps(res), flush=True)
    check(bool(torch.isfinite(lf).all()) and lf.shape == (B, T,
                                                           cfg.vocab_size),
          "flash prefill logits not finite or of the wrong shape")
    check(torch.allclose(lf, lp, **PATH_LOGIT_TOL)
          and torch.allclose(cf.k, cp.k, **PATH_LOGIT_TOL)
          and torch.allclose(cf.v, cp.v, **PATH_LOGIT_TOL),
          f"flash prefill differs from the plain prefill: logits "
          f"{logit_err:.3e}, KV {kv_err:.3e}")
    check(torch.equal(next_f, next_p), "flash prefill's next tokens differ "
          "from the plain prefill's")
    del out, lf, lp, cf, cp
    torch.cuda.empty_cache()
    return res


MAMBA_SERVE_ARGV = ["--arch", "mamba2-1.3b", "--device", "cuda", "--slots",
                    "4", "--decode-chunk", "8", "--requests", "8",
                    "--prompt-len", "300", "--mixed-lens", "--arrive-every",
                    "2", "--gen", "32", "--seed", "0"]


def mamba2_phase(device) -> dict:
    """K9's path at full width: Mamba2-1.3B (48 layers, d_model 2048,
    float32, random params from torch.Generator seed 0) forward over
    2 x 2048 tokens with ``use_kernel=True`` (K9 once per layer) and
    without (``ssd_chunked``): logits within PATH_LOGIT_TOL.  Then the
    same params served through the engine, dense and paged: equal
    tokens (no port kernel on the serve path, as in the reference)."""
    cfg = get_config("mamba2-1.3b")
    B, T = MAMBA_FORWARD
    phase(f"5d. K9's path: full-width {cfg.name} forward of {B} x {T} "
          "tokens, use_kernel=True against ssd_chunked")
    args = serve.parse_args(MAMBA_SERVE_ARGV)
    t0 = time.perf_counter()
    params = serve.init_params(cfg, args, device)
    torch.cuda.synchronize(device)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"params: {n_params / 1e9:.3f} B f32 on {device}, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, T)), dtype=torch.int32, device=device)
    walls = {}
    with torch.no_grad():
        reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits_k, _ = mamba2.forward(params, cfg, toks, use_kernel=True)
        torch.cuda.synchronize(device)
        walls["kernel"] = time.perf_counter() - t0
        launches = launch_counts(ssd_scan=cfg.num_layers)
        t0 = time.perf_counter()
        logits_p, _ = mamba2.forward(params, cfg, toks)
        torch.cuda.synchronize(device)
        walls["plain"] = time.perf_counter() - t0
        launch_counts(ssd_scan=cfg.num_layers)   # ssd_chunked: no launch
    err = (logits_k - logits_p).abs().max().item()
    res = {"launches": launches["ssd_scan"], "tokens": [B, T],
           "max_logit_err": err,
           "logit_tolerance": PATH_LOGIT_TOL, "forward_wall_s": walls,
           "argmax_agree_share": (logits_k.argmax(-1) == logits_p.argmax(-1)
                                  ).float().mean().item()}
    print(json.dumps(res), flush=True)
    check(bool(torch.isfinite(logits_k).all())
          and logits_k.shape == (B, T, cfg.vocab_size),
          "mamba2 kernel-path logits not finite or of the wrong shape")
    check(torch.allclose(logits_k, logits_p, **PATH_LOGIT_TOL),
          f"mamba2 forward through K9 differs from ssd_chunked ({err:.3e})")
    del logits_k, logits_p
    torch.cuda.empty_cache()

    phase(f"5e. {cfg.name} serving: the engine, dense and paged, each "
          "prefilling and decoding through its CUDA graphs, and paged "
          "eagerly, on the same params")
    requests = serve.make_requests(cfg, args)
    print("prompt lengths:", [len(r["tokens"]) for r in requests])
    results, reports = {}, {}
    paged = ["--paged", "--prefill-chunk", "32"]
    for mode, extra, graphs in (("dense", [], True), ("paged", paged, True),
                                ("paged_eager", paged, False)):
        reset_launches()
        results[mode], engine, reports[mode] = serve.engine_serve(
            cfg, params, requests, serve.parse_args(MAMBA_SERVE_ARGV + extra),
            Obs(), device, graphs=graphs)
        launch_counts()                  # no port kernel serves the ssm
        captured(engine, requests, graphs)
        if mode == "dense":
            replay_prefills_without_sync(engine, device)
        check(sorted(results[mode]) == list(range(len(requests))),
              f"{mode}: requests missing")
        for uid, toks_out in results[mode].items():
            check(toks_out.shape == (args.gen,) and bool(
                ((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()),
                f"{mode}: request {uid} returned {toks_out}")
        if mode == "paged_eager":
            check(not engine.uses_pages
                  and engine.prefill_chunk_len % cfg.ssm_chunk == 0,
                  "the ssm engine reserved pages or did not round its "
                  "prefill chunk up to ssm_chunk")
            # every prompt is longer than one chunk, so each paged prefill
            # resumes from the previous chunk's state and conv ring
            chunks = sum(-(-len(r["tokens"]) // engine.prefill_chunk_len)
                         for r in requests)
            print(f"paged prefill: {engine.stats['prefill_chunks']} chunk "
                  f"calls of {engine.prefill_chunk_len} tokens", flush=True)
            check(engine.stats["prefill_chunks"] == chunks
                  and chunks >= 2 * len(requests),
                  f"paged prefill took {engine.stats['prefill_chunks']} "
                  f"chunk calls, expected {chunks} (at least two a prompt)")
        del engine
    for mode in ("dense", "paged"):
        for uid in results[mode]:
            check(bool((results[mode][uid]
                        == results["paged_eager"][uid]).all()),
                  f"request {uid}: {mode} tokens "
                  f"{results[mode][uid].tolist()} != eager paged tokens "
                  f"{results['paged_eager'][uid].tolist()}")
    print(f"dense == paged == eager paged tokens for all {len(requests)} "
          "requests", flush=True)
    keys = ("decode_tokens_per_s", "prefill_tokens_per_s", "itl_ms",
            "ttft_ms", "wall_s")
    res["serve"] = {mode: {k: reports[mode][k] for k in keys}
                    for mode in reports}
    del params
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------------
# K3 and K8 at the geometries of the moe, hybrid, vlm and audio families
# ------------------------------------------------------------------

# name: (B, T, H, hd): K3 takes GQA expanded, so a group shows only in H
GEOMETRY_FLASH = {
    "hd64_h32": (2, 1024, 32, 64),           # Zamba2-1.2B's sites
    "hd64_h32_cond": (2, 1088, 32, 64),      # MusicGen: 64 cond + 1024
    "hd64_h14": (2, 1024, 14, 64),           # InternVL2-1B, 14 over 2 KV
    "hd128_h16": (2, 1024, 16, 128),         # Qwen1.5-MoE, 16 over 16 KV
}
# name: (H, KV, hd) of the decode q and pools
GEOMETRY_PAGED = {
    "hd64_group1": (32, 32, 64),
    "hd64_group7": (14, 2, 64),
    "hd128_group1": (16, 16, 128),
}
GEOMETRY_SERVE_LENGTHS = [63, 80, 99, 116]   # the serve shape's rows
GEOMETRY_SPLIT_M = 64                        # pages a row, split edges


def geometry_check_phase(device) -> dict:
    """K3 and K8 against their plain versions at the new families'
    geometries: K3 at hd 64 with 32 heads (groups of 1), 14 heads (a
    group of 7, expanded) and hd 128 with 16 heads; K8 at hd 64 groups
    of 1, hd 64 a group of 7 and hd 128 groups of 1, at the serve rows'
    lengths and at lengths on the edges of its splits.  Each launched
    twice (bitwise equal) and once with host synchronisation forbidden.
    Returns the largest errors."""
    phase("3g. K3 and K8 at the moe, hybrid, vlm and audio geometries")
    errs = {"flash_attention": 0.0, "paged_attention": 0.0}
    for i, (name, (B, T, H, hd)) in enumerate(GEOMETRY_FLASH.items()):
        q, k, v = flash_inputs(70 + i, B, T, H, hd, torch.float32, device)
        got = without_sync(fa.flash_attention_cuda, q, k, v)
        again = fa.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize(device)
        check(torch.equal(got, again), f"two K3 launches on {name} differ")
        want = fa.flash_attention_plain(q, k, v)
        err = (got - want).abs().max().item()
        errs["flash_attention"] = max(errs["flash_attention"], err)
        print(f"K3 {name}: (B, T, H, hd) {(B, T, H, hd)} max_abs_err "
              f"{err:.3e}", flush=True)
        check(torch.allclose(got, want, **TOL),
              f"K3 disagrees with its plain version on {name} ({err:.3e})")
        del q, k, v, got, again, want
    for i, (name, (H, KV, hd)) in enumerate(GEOMETRY_PAGED.items()):
        M = GEOMETRY_SPLIT_M
        for case, B, lengths in (
                ("serve", 4, GEOMETRY_SERVE_LENGTHS),
                ("split_edges", 6, split_lengths(device, 6, KV, M, 16))):
            P = B * M + 1
            args = paged_inputs(80 + i, B=B, P=P, H=H, KV=KV, hd=hd, ps=16,
                                M=M, lengths=lengths, device=device)
            got = without_sync(pa.paged_attention_cuda, *args)
            again = pa.paged_attention_cuda(*args)
            torch.cuda.synchronize(device)
            check(torch.equal(got, again),
                  f"two K8 launches on {name} {case} differ")
            want = pa.paged_attention_plain(*args)
            err = (got - want).abs().max().item()
            errs["paged_attention"] = max(errs["paged_attention"], err)
            print(f"K8 {name} {case}: H {H} KV {KV} hd {hd} lengths "
                  f"{lengths} max_abs_err {err:.3e}", flush=True)
            check(torch.allclose(got, want, **TOL),
                  f"K8 disagrees with its plain version on {name} {case} "
                  f"({err:.3e})")
            del args, got, again, want
    torch.cuda.empty_cache()
    return errs


def geometry_timing_phase(device, smi) -> dict:
    """K3 and K8 at the new geometries, each beside its plain version,
    SDPA and its bound (K3: the 3xTF32 operations bound; K8: the bytes of
    the live K/V), the card's name and power limit beside each line."""
    phase("4h. K3 and K8 timing at the moe, hybrid, vlm and audio "
          "geometries")
    out = {}
    for name, (B, T, H, hd) in GEOMETRY_FLASH.items():
        q, k, v = flash_inputs(91, B, T, H, hd, torch.float32, device)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        n_flops = 2 * B * H * T * T * hd
        bytes_ms = 4 * q.numel() * 4 / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * n_flops / TF32_FLOP_PER_S * 1e3
        t = {}
        for key, fn, iters in (
                ("ms", lambda: fa.flash_attention_cuda(q, k, v), 30),
                ("plain_ms", lambda: fa.flash_attention_plain(q, k, v), 10),
                ("library_ms", lambda: torch.nn.functional
                 .scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                 30)):
            t[key], _ = time_ms(fn, device, iters=iters, warmup=3)
        t.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms > ops_ms else "operations",
                 simt_bound_ms=n_flops / F32_FLOP_PER_S * 1e3)
        out[f"flash_attention/{name}"] = t
        print(json.dumps({"kernel": "flash_attention", "geometry": name,
                          "shape": [B, T, H, hd], **t, "card": smi}),
              flush=True)
        del q, k, v, qt, kt, vt
    for name, (H, KV, hd) in GEOMETRY_PAGED.items():
        shape = dict(B=4, P=4 * 8 + 1, H=H, KV=KV, hd=hd, ps=16, M=8,
                     lengths=GEOMETRY_SERVE_LENGTHS)
        args = paged_inputs(92, device=device, **shape)
        q, _, _, table, lengths = args
        n_bytes, n_flops = paged_bytes_flops(shape, q, table, lengths)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_flops / F32_FLOP_PER_S * 1e3
        library = sdpa_over_extent(shape, args, device)
        t = {}
        for key, fn in (("ms", lambda: pa.paged_attention_cuda(*args)),
                        ("plain_ms", lambda: pa.paged_attention_plain(*args)),
                        ("library_ms", library)):
            t[key], _ = time_ms(fn, device)
        t.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        out[f"paged_attention/{name}"] = t
        print(json.dumps({"kernel": "paged_attention", "geometry": name,
                          "H": H, "KV": KV, "hd": hd,
                          "lengths": shape["lengths"], **t, "card": smi}),
              flush=True)
        del args, q, table, lengths, library
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------
# the moe, hybrid, vlm and audio families at full width
# ------------------------------------------------------------------

MARGIN = 1e-4              # router margin (k-th minus (k+1)-th probability)
FAMILY_FORWARD = (2, 1024)
FAMILY_SERVE_ARGV = ["--device", "cuda", "--paged", "--slots", "4",
                     "--page-size", "16", "--prefill-chunk", "32",
                     "--decode-chunk", "8", "--requests", "8",
                     "--mixed-lens", "--arrive-every", "2", "--gen", "32",
                     "--seed", "0"]
FAMILY_PROMPT_LEN = {"qwen2-moe-a2.7b": 64, "zamba2-1.2b": 300,
                     "internvl2-1b": 300, "musicgen-large": 64}


class RouteRecorder:
    """Records every MoE routing while active: ``moe.route`` is wrapped
    (the dispatch looks it up at each call) so each call appends the
    router margin of every token — its k-th minus its (k+1)-th
    probability — and its expert ids, as device tensors."""

    def __init__(self):
        self.records = []
        self._orig = None

    def __enter__(self):
        self._orig = moe.route
        orig = self._orig

        def recording_route(params, cfg, xf):
            probs, gates, ids = orig(params, cfg, xf)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            self.records.append((top[:, -2] - top[:, -1], ids))
            return probs, gates, ids

        moe.route = recording_route
        return self

    def __exit__(self, *exc):
        moe.route = self._orig


def _kept_sets(ids, cfg):
    """Each token's expert set and the subset its capacity kept (-1 for a
    dropped routing), both sorted: the dispatch's keep rule on ``ids``
    (T, K)."""
    T, K = ids.shape
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inv = torch.argsort(order)
    counts = torch.bincount(flat, minlength=cfg.num_experts)
    starts = torch.cumsum(counts, 0) - counts
    keep = (inv - starts[flat]) < moe._capacity(T, cfg)
    kept = torch.where(keep, flat, -1).reshape(T, K)
    return ids.sort(-1).values, kept.sort(-1).values


def routing_differences(rec_plain, rec_kernel, cfg, B, T):
    """Compare the two paths' routings of a (B, T) forward, layer by
    layer: (routing differs (L, B, T), root differences, margins (L, B,
    T)).  A token's routing differs when its expert set or the part of
    it the capacity kept differs.  A difference is explained by an
    earlier-layer difference at or before its position in its row
    (attention carries it there) or, for a changed kept set, by a
    changed expert set at an earlier token of the same layer (the
    bucket positions); the rest are roots."""
    id_diff, keep_diff, margins = [], [], []
    for (m_p, ids_p), (_, ids_k) in zip(rec_plain, rec_kernel):
        set_p, kept_p = _kept_sets(ids_p, cfg)
        set_k, kept_k = _kept_sets(ids_k, cfg)
        id_diff.append((set_p != set_k).any(-1).cpu())
        keep_diff.append((kept_p != kept_k).any(-1).cpu())
        margins.append(m_p.float().cpu())
    id_diff, keep_diff = torch.stack(id_diff), torch.stack(keep_diff)
    margins = torch.stack(margins).reshape(-1, B, T)
    diff = (id_diff | keep_diff).reshape(-1, B, T)
    earlier = torch.zeros_like(diff)                  # any layer < l
    earlier[1:] = diff.cumsum(0)[:-1] > 0
    earlier = earlier.int().cummax(-1).values > 0     # at or before t
    same_layer = torch.zeros_like(id_diff)            # earlier flat token
    same_layer[:, 1:] = id_diff.int().cumsum(-1)[:, :-1] > 0
    id_root = id_diff.reshape(diff.shape) & ~earlier
    keep_root = (keep_diff & ~id_diff & ~same_layer).reshape(
        diff.shape) & ~earlier
    return diff, id_root, keep_root, margins


def moe_prefill_phase(device, cfg, params) -> dict:
    """K3's path through the moe family: a 2 x 1024 prefill through
    ``steps.make_prefill_step(use_flash=True)`` (24 K3 launches) against
    ``use_flash=False``, the routings of both recorded.  Routings whose
    margin on the plain path is below MARGIN may flip; any other
    difference fails.  Logits and KV are held to PATH_LOGIT_TOL on every
    position whose routings all clear MARGIN and that no routing
    difference reaches (it and every position after it in its row)."""
    B, T = FAMILY_FORWARD
    phase(f"5f-2. K3's path: {cfg.name} prefill of {B} x {T} tokens, "
          "use_flash against plain, routing margins recorded")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(B, T)), dtype=torch.int32, device=device)
    model = build_model(cfg)
    out = {}
    for use_flash in (True, False):
        cache = model.init_cache(params, B, T)
        prefill = steps.make_prefill_step(cfg, use_flash=use_flash)
        reset_launches()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with torch.no_grad(), RouteRecorder() as rec:
            logits, cache = prefill(params, {"tokens": toks}, cache)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = launch_counts(
            flash_attention=cfg.num_layers if use_flash else 0)
        out[use_flash] = (logits, cache, wall, launches, rec.records)
    (lf, cf, wall_f, launches, rec_f), (lp, cp, wall_p, _, rec_p) = (
        out[True], out[False])
    check(len(rec_p) == len(rec_f) == cfg.num_layers,
          f"recorded {len(rec_p)} / {len(rec_f)} routings, expected one a "
          "layer")
    diff, id_root, keep_root, margins = routing_differences(
        rec_p, rec_f, cfg, B, T)
    low = margins < MARGIN
    bad = id_root & ~low
    check(not bool(bad.any()) and not bool(keep_root.any()),
          f"{int(bad.sum())} routings with margin >= {MARGIN} differ at "
          f"their root, {int(keep_root.sum())} kept sets differ "
          "unexplained")
    # a difference reaches its position and every later one of its row
    reached = diff.any(0).int().cummax(-1).values > 0        # (B, T)
    include = ~reached & ~low.any(0)
    inc = include.to(device)
    logit_err = (lf - lp).abs()[inc].max().item()
    kv_err = max((cf.k - cp.k).abs()[:, inc].max().item(),
                 (cf.v - cp.v).abs()[:, inc].max().item())
    next_f, next_p = lf[:, -1].argmax(-1), lp[:, -1].argmax(-1)
    low_margins = margins[low]
    res = {"launches": launches["flash_attention"], "prompt": [B, T],
           "routings": int(margins.numel()) * cfg.top_k,
           "routing_differences": int(diff.sum()),
           "root_differences": int(id_root.sum()),
           "root_margins": margins[id_root].tolist(),
           "positions_held": int(include.sum()),
           "positions_below_margin": int(low.any(0).sum()),
           "positions_reached_by_a_difference": int(reached.sum()),
           "routings_below_margin": int(low.sum()),
           "smallest_margins": low_margins.sort().values[:16].tolist(),
           "margin_quantiles_below": (torch.quantile(
               low_margins, torch.tensor([0.1, 0.5, 0.9])).tolist()
               if low_margins.numel() else []),
           "max_logit_err_held": logit_err, "max_kv_cache_err_held": kv_err,
           "next_tokens_flash": next_f.tolist(),
           "next_tokens_plain": next_p.tolist(),
           "last_position_held": include[:, -1].tolist(),
           "prefill_wall_s": {"flash": wall_f, "plain": wall_p}}
    print(json.dumps(res), flush=True)
    check(bool(torch.isfinite(lf).all())
          and lf.shape == (B, T, cfg.vocab_size),
          "moe flash prefill logits not finite or of the wrong shape")
    check(bool(inc.any()) and logit_err <= 1e-3 and kv_err <= 1e-3
          and torch.allclose(lf[inc], lp[inc], **PATH_LOGIT_TOL),
          f"moe flash prefill differs from the plain prefill on held "
          f"positions: logits {logit_err:.3e}, KV {kv_err:.3e}")
    for b in range(B):
        if bool(include[b, -1]):
            check(int(next_f[b]) == int(next_p[b]),
                  f"row {b}: flash next token {int(next_f[b])} != plain "
                  f"{int(next_p[b])}")
    del out, lf, lp, cf, cp
    _release()
    return res


# 14d: the grouped dispatch (moe_groups = 4) on one block of 5f's
# Qwen1.5-MoE params, against the flat one at a drop-free capacity (E /
# K: a bucket holds every token of its group) within the reference's
# contract (tests/test_models.py), then the routings each drops at the
# config's own capacity factor
GROUPED_GROUPS = 4
GROUPED_TOL = dict(rtol=1e-5, atol=1e-6)


def dropped_share(ids, cfg, groups: int) -> float:
    """The share of the routings ``ids`` (T, K) that a dispatch of
    ``groups`` groups drops at ``cfg``'s capacity (each expert of a group
    keeps its first ``_capacity(T / groups)``)."""
    T = ids.shape[0]
    C = moe._capacity(T // groups, cfg)
    counts = torch.stack([torch.bincount(g, minlength=cfg.num_experts)
                          for g in ids.reshape(groups, -1)])
    return float((counts - C).clamp(min=0).sum()) / ids.numel()


def grouped_dispatch_phase(device, cfg, params) -> dict:
    """14d (run here, reported in phase 14): one forward of layer 0's
    MoE block of the card's params on FAMILY_FORWARD tokens of N(0, 1)
    input, flat and with GROUPED_GROUPS groups, at the drop-free capacity
    factor E / K: within GROUPED_TOL; then the share of routings dropped
    at ``cfg.capacity_factor``, grouped against flat."""
    B, T = FAMILY_FORWARD
    layer = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[0]) for k, v in params["blocks"]["moe"].items()}
    x = torch.randn((B, T, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(3))
    free = dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                               / cfg.top_k)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        flat, aux_f = moe.moe_forward(layer, free, x)
        grouped, aux_g = moe.moe_forward(
            layer, dataclasses.replace(free, moe_groups=GROUPED_GROUPS), x)
        _, _, ids = moe.route(layer, cfg, x.reshape(B * T, -1))
    torch.cuda.synchronize(device)
    out = {"tokens": [B, T], "groups": GROUPED_GROUPS,
           "capacity_factor_free": free.capacity_factor,
           "max_abs_err": _max_err(grouped, flat),
           "aux_err": abs(float(aux_g) - float(aux_f)),
           "allclose": bool(torch.allclose(grouped, flat, **GROUPED_TOL)
                            and torch.allclose(aux_g, aux_f,
                                               **GROUPED_TOL)),
           "dropped_share": {"capacity_factor": cfg.capacity_factor,
                             "flat": dropped_share(ids, cfg, 1),
                             "grouped": dropped_share(ids, cfg,
                                                      GROUPED_GROUPS)},
           "wall_s": round(time.perf_counter() - t0, 3)}
    del flat, grouped, x
    print(json.dumps({"14d": out}), flush=True)
    return out


def _decode_margin_cuts(chunks, num_layers):
    """{uid: index of the first generated token whose decode step routed
    a token of that request below MARGIN} from the gather run's decode
    chunks: (slot -> (uid, tokens emitted before the chunk), routing
    records of the chunk, one a layer and step)."""
    cuts = {}
    for slots, records in chunks:
        if not records or not slots:
            continue
        m = torch.stack([r[0] for r in records]).float().cpu()
        m = m.reshape(-1, num_layers, m.shape[-1]).min(1).values  # (C, B)
        for slot, (uid, before) in slots.items():
            low = torch.nonzero(m[:, slot] < MARGIN)
            if low.numel():
                cuts[uid] = min(cuts.get(uid, 1 << 30),
                                before + int(low[0, 0]))
    return cuts


def _record_decode_chunks(engine_cls, recorder, chunks):
    """Wrap ``engine_cls._decode_chunk`` so each chunk appends (its
    decoding slots -> (uid, tokens emitted so far), the routings
    recorded during it); returns the original to restore.  The engine
    must run eagerly (``graphs=False``): a CUDA graph's replay runs no
    Python, so neither the wrapper nor the recorder would see a chunk."""
    orig = engine_cls._decode_chunk

    def wrapped(self, *args):
        slots = {s: (self.sched.slots[s].request.uid,
                     len(self.sched.slots[s].emitted))
                 for s in self.sched.decoding_slots()}
        start = len(recorder.records)
        result = orig(self, *args)
        chunks.append((slots, recorder.records[start:]))
        return result

    engine_cls._decode_chunk = wrapped
    return orig


def family_serve_phase(device, cfg, params, label) -> dict:
    """Serve 8 requests of ``cfg`` through the paged engine with K8,
    decoding through its CUDA graph (launches = attention layers or sites
    x (decode steps + the warm-up's)), then through the gather path (no
    kernel), eagerly: equal tokens; the hybrid also through the dense
    engine's graph.  For the moe family the gather run records every
    decode step's routing margins, and a request's tokens are compared
    up to the first one whose decode step routed below MARGIN."""
    from repro_torch.serving.engine import Engine
    argv = (["--arch", cfg.name, "--prompt-len",
             str(FAMILY_PROMPT_LEN[cfg.name])] + FAMILY_SERVE_ARGV)
    args_k = serve.parse_args(argv + ["--paged-kernel"])
    phase(f"{label}. {cfg.name} serving: paged engine through K8 as a CUDA "
          "graph, then the eager gather path" + (
              " and the dense engine" if cfg.family == "hybrid" else ""))
    requests = serve.make_requests(cfg, args_k)
    print("prompt lengths:", [r["tokens"].shape[-1] for r in requests],
          {k: list(v.shape) for k, v in requests[0].items() if k != "tokens"},
          flush=True)
    sites = (hybrid.num_attn_sites(cfg) if cfg.family == "hybrid"
             else cfg.num_layers)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    res_k, engine, rep_k = serve.engine_serve(cfg, params, requests, args_k,
                                              Obs(), device)
    steps_k = engine.stats["decode_steps"]
    warm = captured(engine, requests)
    k8 = launch_counts(paged_attention=sites * (steps_k + warm))[
        "paged_attention"]
    capture_s = engine.stats["compile_s"]
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    streams = cfg.num_codebooks if cfg.family == "audio" else 0
    want_shape = (streams, args_k.gen) if streams else (args_k.gen,)
    check(sorted(res_k) == list(range(len(requests))), "requests missing")
    for uid, toks in res_k.items():
        check(toks.shape == want_shape and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"request {uid} returned {toks.shape} / out-of-vocabulary "
            "tokens")
    print(f"K8 launches {k8} = {sites} x ({steps_k} decode steps + {warm} "
          f"warm-up steps); capture {capture_s:.3f} s; peak {peak:.3f} GiB",
          flush=True)
    del engine
    _release()

    chunks = []
    with RouteRecorder() as rec:
        orig = _record_decode_chunks(Engine, rec, chunks)
        try:
            res_g, engine, rep_g = serve.engine_serve(
                cfg, params, requests, serve.parse_args(argv), Obs(), device,
                graphs=False)
        finally:
            Engine._decode_chunk = orig
    launch_counts(paged_attention=k8)              # the gather path: none
    captured(engine, requests, False)
    cuts = (_decode_margin_cuts(chunks, cfg.num_layers)
            if cfg.family == "moe" else {})
    del engine, rec, chunks
    _release()
    for uid in res_k:
        n = cuts.get(uid, args_k.gen)
        check(bool((res_k[uid][..., :n] == res_g[uid][..., :n]).all()),
              f"request {uid}: kernel tokens {res_k[uid].tolist()} != "
              f"gather-path tokens {res_g[uid].tolist()} (compared up to "
              f"token {n})")
    whole = sum(bool((res_k[u] == res_g[u]).all()) for u in res_k)
    print(f"gather path: same tokens for all {len(res_g)} requests"
          + (f"; {len(cuts)} compared only up to a decode step routed "
             f"below {MARGIN}: {cuts}; all {args_k.gen} tokens equal in "
             f"{whole} of {len(res_k)}" if cfg.family == "moe" else ""),
          flush=True)

    # the same K8 path decoding eagerly: the same tokens (up to the same
    # margin cuts), and its ITL and busy share beside the captured one's
    reset_launches()
    res_e, engine, rep_e = serve.engine_serve(cfg, params, requests, args_k,
                                              Obs(), device, graphs=False)
    launch_counts(paged_attention=sites * engine.stats["decode_steps"])
    captured(engine, requests, False)
    del engine
    _release()
    for uid in res_k:
        n = cuts.get(uid, args_k.gen)
        check(bool((res_k[uid][..., :n] == res_e[uid][..., :n]).all()),
              f"request {uid}: captured tokens {res_k[uid].tolist()} != "
              f"eager tokens {res_e[uid].tolist()} (compared up to token "
              f"{n})")
    print(f"eager K8 path: the captured tokens for all {len(res_e)} "
          "requests", flush=True)
    busy = {name: busy_window(device, cfg, params, requests, args_k, graphs)
            for name, graphs in (("captured", True), ("eager", False))}
    reset_launches()
    keys = ("decode_tokens_per_s", "prefill_tokens_per_s", "itl_ms",
            "ttft_ms", "wall_s")
    out = {"k8_launches": k8, "decode_steps": steps_k,
           "warmup_steps": warm, "capture_s": capture_s,
           "peak_memory_gib": round(peak, 3),
           "paged_kernel": {k: rep_k[k] for k in keys},
           "paged_kernel_eager": {k: rep_e[k] for k in keys},
           "busy_window": busy,
           "gather": {k: rep_g[k] for k in keys},
           "requests_cut_by_margin": {str(u): c for u, c in cuts.items()},
           "requests_all_tokens_equal": whole}
    if cfg.family == "hybrid":
        dense_argv = [a for a in argv if a != "--paged"]
        res_d, engine, rep_d = serve.engine_serve(
            cfg, params, requests, serve.parse_args(dense_argv), Obs(),
            device)
        launch_counts()
        captured(engine, requests)
        for uid in res_k:
            check(bool((res_d[uid] == res_g[uid]).all()),
                  f"request {uid}: dense tokens {res_d[uid].tolist()} != "
                  f"paged tokens {res_g[uid].tolist()}")
        print(f"dense engine: same tokens for all {len(res_d)} requests",
              flush=True)
        out["dense"] = {k: rep_d[k] for k in keys}
        del engine
        _release()
    print(json.dumps(out), flush=True)
    return out


def family_forward_phase(device, cfg, params, label) -> dict:
    """The 2 x 1024 forward of the hybrid (K3 once a site, K9 once an SSM
    layer), vlm (256 patch embeddings a row; K3 once a layer) or audio
    (64 cond frames, 4 codebooks; K3 once a layer) family through the
    kernels against the plain forward: logits within PATH_LOGIT_TOL and
    the same next tokens."""
    B, T = FAMILY_FORWARD
    rng = np.random.default_rng(3)
    if cfg.family == "audio":
        tshape = (B, cfg.num_codebooks, T)
    else:
        tshape = (B, T)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=tshape),
                           dtype=torch.int32, device=device)
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model), dtype=np.float32),
            device=device)
    if cfg.family == "audio":
        batch["cond"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.cond_len, cfg.d_model), dtype=np.float32), device=device)
    if cfg.family == "hybrid":
        want = dict(flash_attention=hybrid.num_attn_sites(cfg),
                    ssd_scan=cfg.num_layers)
        run = {True: lambda: hybrid.forward(params, cfg, toks,
                                            use_flash=True, use_kernel=True),
               False: lambda: hybrid.forward(params, cfg, toks)}
    else:
        want = dict(flash_attention=cfg.num_layers)
        run = {f: (lambda f=f: build_model(cfg, use_flash=f).apply(params,
                                                                   batch))
               for f in (True, False)}
    phase(f"{label}. {cfg.name} forward of {B} x {T} tokens through "
          f"{', '.join(want)} against the plain forward")
    walls, logits = {}, {}
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        for kern in (True, False):
            reset_launches()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logits[kern], _ = run[kern]()
            torch.cuda.synchronize(device)
            walls["kernel" if kern else "plain"] = time.perf_counter() - t0
            launches = launch_counts(**(want if kern else {}))
            if kern:
                got_launches = {k: launches[k] for k in want}
    lk, lp = logits[True], logits[False]
    err = (lk - lp).abs().max().item()
    next_k, next_p = lk[:, -1].argmax(-1), lp[:, -1].argmax(-1)
    res = {"launches": got_launches, "tokens": list(tshape),
           "max_logit_err": err, "logit_tolerance": PATH_LOGIT_TOL,
           "forward_wall_s": walls,
           "peak_memory_gib": round(torch.cuda.max_memory_allocated(device)
                                    / 2 ** 30, 3),
           "next_tokens_kernel": next_k.tolist(),
           "argmax_agree_share": (lk.argmax(-1) == lp.argmax(-1)).float()
           .mean().item()}
    print(json.dumps(res), flush=True)
    shape = ((B, T, cfg.num_codebooks, cfg.vocab_size)
             if cfg.family == "audio" else (B, T, cfg.vocab_size))
    check(bool(torch.isfinite(lk).all()) and tuple(lk.shape) == shape,
          f"{cfg.name} kernel-path logits not finite or not {shape}")
    check(torch.allclose(lk, lp, **PATH_LOGIT_TOL),
          f"{cfg.name} forward through the kernels differs from the plain "
          f"forward ({err:.3e})")
    check(torch.equal(next_k, next_p),
          f"{cfg.name} next tokens differ: {next_k.tolist()} vs "
          f"{next_p.tolist()}")
    del logits, lk, lp
    _release()
    return res


# the served runs the summary gives: K8 captured and eager, gather eager
FAMILY_MODES = ("paged_kernel", "paged_kernel_eager", "gather")
FAMILY_ARCHS = (("qwen2-moe-a2.7b", "5f"), ("zamba2-1.2b", "5g"),
                ("internvl2-1b", "5h"), ("musicgen-large", "5i"))
# each family at full width and an eighth of its depth (of 24, 24 and 48
# layers), Zamba2 at 12 of its 38 (two sites of its shared block, as 6i
# trains it): the script's time limit
FAMILY_LAYERS = {"qwen2-moe-a2.7b": 3, "zamba2-1.2b": 12,
                 "internvl2-1b": 3, "musicgen-large": 6}


def families_phase(device) -> dict:
    """Each of the four families at full width and a cut depth
    (FAMILY_LAYERS), float32,
    random params from torch.Generator seed 0: served through K8 (and
    the gather path), then the 2 x 1024 prefill (moe) or forward through
    K3 (and K9 in the hybrid).  Each model is freed before the next is
    built; wall time and peak memory of each phase are printed."""
    out = {}
    for arch, label in FAMILY_ARCHS:
        _release()
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=FAMILY_LAYERS[arch])
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        args = serve.parse_args(["--arch", arch] + FAMILY_SERVE_ARGV)
        params = serve.init_params(cfg, args, device)
        torch.cuda.synchronize(device)
        n_params = sum(p.numel() for p in _leaves(params))
        print(f"== {label}. {arch}: {n_params / 1e9:.3f} B params f32 "
              f"({n_params * 4 / 1e9:.1f} GB) on {device}, init "
              f"{time.perf_counter() - t0:.2f} s; device memory in use "
              f"{torch.cuda.memory_allocated(device) / 2 ** 30:.3f} GiB",
              flush=True)
        res = {"params": n_params,
               "serve": family_serve_phase(device, cfg, params, label)}
        if cfg.family == "moe":
            res["prefill"] = moe_prefill_phase(device, cfg, params)
            res["grouped"] = grouped_dispatch_phase(device, cfg, params)
        else:
            res["forward"] = family_forward_phase(device, cfg, params,
                                                  f"{label}-2")
        res["peak_memory_gib"] = round(torch.cuda.max_memory_allocated(
            device) / 2 ** 30, 3)
        res["phase_wall_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"family_phase": arch, **{
            k: res[k] for k in ("params", "peak_memory_gib",
                                "phase_wall_s")}}), flush=True)
        out[arch] = res
        del params
        _release()
    return out


def train_family_phase(device, arch, layers, label) -> dict:
    """Full-width ``arch`` with its depth cut to ``layers`` through the
    train CLI: Parle n=2, L=4, 8 steps, --round-fused, through K1/K2 (8
    and 2 launches; no K3 or K9 on the training path, as in the
    reference) and without --use-kernel: the same losses and final x bit
    for bit (deterministic algorithms, set by the caller)."""
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    phase(f"{label}. {cfg.name} training: full width cut to {layers} "
          "layers, parle n=2 L=4, 8 steps, K1/K2 against the plain path")
    _release()
    losses_k, walls_k, state, eval_k, peak = _train_measured(
        device, train_argv(arch=arch), cfg)
    launches = launch_counts(parle_inner_update=8, parle_sync_update=2)
    m = state.x.shape[1]
    x_k = state.x.cpu()
    del state
    _release()
    print(f"{arch}: launches {launches}; M = {m} per replica; losses "
          f"{losses_k.tolist()}; round walls {walls_k}; peak {peak:.3f} GiB",
          flush=True)
    losses_p, walls_p, state, _, peak_p = _train_measured(
        device, train_argv(use_kernel=False, arch=arch), cfg)
    launch_counts()
    check(torch.equal(losses_k, losses_p) and torch.equal(x_k, state.x.cpu()),
          f"{arch}: kernel path {losses_k.tolist()} != plain path "
          f"{losses_p.tolist()} (or final x differs)")
    del state, x_k
    _release()
    out = {"layers": layers, "launches": {k: v for k, v in launches.items()
                                          if v},
           "elements_per_replica": m, "losses": losses_k.tolist(),
           "eval_loss": eval_k,
           "round_wall_s": {"kernel": walls_k, "plain": walls_p},
           "peak_memory_gib": round(peak, 3),
           "plain_peak_memory_gib": round(peak_p, 3)}
    print(f"{arch}: kernel path == plain path bit for bit (8 losses, final "
          "x)", flush=True)
    print(json.dumps(out), flush=True)
    return out


# each kernel's launch counter: (module, attribute)
COUNTERS = {"paged_attention": (pa, "launches"),
            "flash_attention": (fa, "launches"),
            "ssd_scan": (ssd, "launches"),
            "parle_inner_update": (pu, "inner_launches"),
            "parle_sync_update": (pu, "sync_launches"),
            "elastic_update": (pu, "elastic_launches"),
            "quantize_ef": (pu, "quantize_launches"),
            "parle_sync_dequant": (pu, "dequant_sync_launches"),
            "parle_apply_quantize": (pu, "apply_quantize_launches")}


def reset_launches() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def launch_counts(**want) -> dict:
    """Every kernel's launches since the last reset, checked: the kernels
    named in ``want`` launched that often and every other never (with no
    arguments: nothing launched)."""
    got = {name: getattr(mod, attr) for name, (mod, attr) in COUNTERS.items()}
    expected = {name: want.get(name, 0) for name in got}
    check(got == expected, f"launches {got}, expected {expected}")
    return got


TRAIN_LAYERS = 4
# train_phase's result key, arch: the families trained beside Qwen2.5-3B
TRAINED_FAMILIES = (("mamba2", "mamba2-1.3b"), ("moe", "qwen2-moe-a2.7b"),
                    ("hybrid", "zamba2-1.2b"))
# Qwen1.5-MoE-A2.7B: one layer plus the embedding and the untied head is
# 4.77 GB of float32 a copy; Parle keeps five a replica, 47.7 GB at n = 2
MOE_TRAIN_LAYERS = 1
# Elastic-SGD's steps in 6f and phase 10: one round (in a pod each step
# all-reduces the whole model over gloo)
ELASTIC_STEPS = 4
# Zamba2-1.2B: 12 Mamba2 layers (two sites of the shared block)
HYBRID_TRAIN_LAYERS = 12


def train_argv(steps=8, use_kernel=True, algo="parle", arch="qwen2.5-3b"):
    return (["--arch", arch, "--device", "cuda", "--algo", algo,
             "--replicas", "2", "--L", "4", "--steps", str(steps),
             "--batch", "2", "--seq", "256", "--round-fused",
             "--log-every", "4", "--seed", "0"]
            + (["--use-kernel"] if use_kernel else []))


def train_cfg():
    """Full-width Qwen2.5-3B with its depth cut to TRAIN_LAYERS (memory:
    the 36-layer Parle state at 2 replicas would need 177 GB)."""
    return dataclasses.replace(get_config("qwen2.5-3b"),
                               num_layers=TRAIN_LAYERS)


def _train_once(device, argv, profile=False, cfg=None, obs=None,
                flops=None, rounds=None):
    """One run of the train CLI's run() on ``cfg`` (default: train_cfg())
    with the telemetry ``obs`` (default: none armed); returns its
    per-step losses, the wall of each round (device-synchronized), the
    final state, the eval loss and, with ``profile``, the profiler over
    its first round.  ``flops``: a dict that gets the FLOPs
    ``FlopCounterMode`` counts over the first round (its wall includes
    the counter's host time); ``rounds``: a list that gets ``obs``'s
    collective counters by axis after each round."""
    args = train.parse_args(argv)
    obs = obs or Obs()
    losses, walls, marks = [], [], {}
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
        if profile else None)
    counter = FlopCounterMode(display=False) if flops is not None else None

    def pre_round(r):
        torch.cuda.synchronize(device)
        if prof is not None and r == 0:
            prof.start()
        if counter is not None and r == 0:
            counter.__enter__()
        marks[r] = time.perf_counter()

    def on_round(r, gstep, metrics):
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - marks[r])
        if prof is not None and r == 0:
            prof.stop()
        if counter is not None and r == 0:
            counter.__exit__(None, None, None)
            flops["round0"] = counter.get_total_flops()
        losses.append(metrics["losses"].detach().cpu())
        if rounds is not None:
            rounds.append(collective_counts_by_axis(obs.registry))

    state, _, eval_loss = train.run(args, cfg or train_cfg(), device,
                                    obs, pre_round=pre_round,
                                    on_round=on_round)
    return torch.cat(losses), walls, state, eval_loss, prof


def train_phase(device) -> dict:
    """The training path through K1 and K2, then without them, on the
    same params and batches (deterministic algorithms: the embedding and
    CE backward then accumulate in a fixed order), then one profiled
    round.  Returns the launch counts, the timings and the profile."""
    phase(f"6. training path: full-width qwen2.5-3b cut to {TRAIN_LAYERS} "
          "layers, parle n=2 L=4, 8 steps, through K1 and K2")
    torch.use_deterministic_algorithms(True)
    cfg = train_cfg()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    losses_k, walls_k, state, eval_k, _ = _train_once(device, train_argv())
    launches = launch_counts(parle_inner_update=8, parle_sync_update=2)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)
    n, m = state.x.shape
    x_k = state.x.cpu()
    # phase 14a's measures: what the card holds for one step
    held = {"state_bytes": dryrun.device_bytes(state, "cuda"),
            "batch_bytes": dryrun.device_bytes(replica_batches(
                TokenStream(vocab_size=cfg.vocab_size, seq_len=256,
                            batch_size=2, seed=0, device="cuda"), 0, 2, n),
                "cuda"),
            "peak_bytes": peak}
    pod_refs = {"none": {"losses": losses_k.tolist(), "eval_loss": eval_k,
                         "digests": {"x": row_digests(x_k)}}}
    print(f"layout: {len(state.layout.paths)} leaves, M = {m} per replica "
          f"({sum(state.layout.sizes)} params); launches {launches}; peak "
          f"memory {peak / 2 ** 30:.3f} GiB; run {run_s:.1f} s", flush=True)
    print("losses (K1/K2):", losses_k.tolist(), flush=True)
    check(losses_k.shape == (8,) and bool(torch.isfinite(losses_k).all())
          and torch.isfinite(torch.tensor(eval_k)),
          f"losses not finite: {losses_k.tolist()}, eval {eval_k}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    reset_launches()
    losses_p, walls_p, state, eval_p, _ = _train_once(
        device, train_argv(use_kernel=False), flops=held)
    launch_counts()                       # the plain path launches nothing
    print("losses (plain):", losses_p.tolist(), flush=True)
    check(torch.equal(losses_k, losses_p),
          f"per-step losses differ: {losses_k.tolist()} vs "
          f"{losses_p.tolist()}")
    check(torch.equal(x_k, state.x.cpu()), "final x differs between the "
          "kernel path and the plain path")
    print(f"kernel path == plain path bit for bit: 8 losses, final x "
          f"({n} x {m}); eval loss {eval_k} / {eval_p}", flush=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # the staleness-1 overlapped sync: K2 applies the carried consensus
    # at the second round's head (nothing is in flight at the first), the
    # flush is the plain apply; after it, the barrier run's result
    reset_launches()
    losses_o, walls_o, state, _, _ = _train_once(
        device, train_argv() + ["--sync-overlap"])
    overlap_launches = launch_counts(parle_inner_update=8,
                                     parle_sync_update=1)
    check(torch.equal(losses_k, losses_o) and torch.equal(x_k, state.x.cpu()),
          "overlap + flush differs from the barrier run (losses or final x)")
    print(f"overlap + flush == barrier bit for bit: 8 losses, final x; "
          f"launches {overlap_launches}", flush=True)
    del state, x_k
    gc.collect()
    torch.cuda.empty_cache()

    tokens_per_step = n * 2 * 256
    step_s = walls_k[1] / 4
    out = {"launches": launches, "replicas": n, "elements_per_replica": m,
           "losses": losses_k.tolist(), "eval_loss": eval_k,
           "peak_memory_gib": round(peak / 2 ** 30, 3),
           "round_wall_s": {"kernel": walls_k, "plain": walls_p},
           "step_wall_s": step_s, "tokens_per_s": tokens_per_step / step_s}
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}),
          flush=True)
    out["overlap_round_wall_s"] = walls_o
    out["dryrun"] = held
    out["profile"] = train_profile_phase(device, walls_k[1])
    out["bf16"] = train_bf16_phase(device)
    out["int8"] = train_int8_phase(device, pod_refs)
    out.update(train_baselines_phase(device, pod_refs))
    out["pod_refs"] = pod_refs
    out["mamba2"] = train_family_phase(device, "mamba2-1.3b", TRAIN_LAYERS,
                                       "6g")
    out["moe"] = train_family_phase(device, "qwen2-moe-a2.7b", MOE_TRAIN_LAYERS,
                                    "6h")
    out["hybrid"] = train_family_phase(device, "zamba2-1.2b",
                                       HYBRID_TRAIN_LAYERS, "6i")
    torch.use_deterministic_algorithms(False)
    return out


def train_bf16_phase(device) -> dict:
    """One round with ``--precision bf16`` (y, activations and grads in
    bf16; K1 takes bf16 y/g, K2 writes the bf16 y'), through the kernels
    and without them: same losses and final x and y bit for bit."""
    phase("6d. one bf16 training round, kernel path vs plain path")
    argv = ["--precision", "bf16"]
    reset_launches()
    losses_k, walls_k, state, _, _ = _train_once(
        device, train_argv(steps=4) + argv)
    launch_counts(parle_inner_update=4, parle_sync_update=1)
    check(state.y.dtype == torch.bfloat16 and state.x.dtype == torch.float32
          and torch.equal(state.y, state.x.to(torch.bfloat16)),
          "bf16 layout or the fused y' = bf16(x') does not hold")
    x_k, y_k = state.x.cpu(), state.y.cpu()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    losses_p, walls_p, state, _, _ = _train_once(
        device, train_argv(steps=4, use_kernel=False) + argv)
    check(bool(torch.isfinite(losses_k).all())
          and torch.equal(losses_k, losses_p)
          and torch.equal(x_k, state.x.cpu())
          and torch.equal(y_k, state.y.cpu()),
          f"bf16: kernel path {losses_k.tolist()} != plain path "
          f"{losses_p.tolist()} (or final x / y differ)")
    del state, x_k, y_k
    gc.collect()
    torch.cuda.empty_cache()
    out = {"losses": losses_k.tolist(), "round_wall_s": {
        "kernel": walls_k[0], "plain": walls_p[0]}}
    print(json.dumps(out), flush=True)
    return out


INT8_PATHS = {   # path: (extra flags, launches of the kernel path)
    "barrier": ([], dict(parle_inner_update=8, quantize_ef=2,
                         parle_sync_dequant=2)),
    "overlap": (["--sync-overlap"], dict(parle_inner_update=8,
                                         quantize_ef=1,
                                         parle_apply_quantize=1)),
}


def train_int8_phase(device, pod_refs) -> dict:
    """The int8 compressed sync at the training shape: the barrier path
    (each sync: x + e formed in place in e, K4, then K5) and the
    overlapped path (the first head K4, the second K6, then the plain
    flush), each through the kernels and then without them: the same
    losses, final x, residual e (and carried c) bit for bit.  Then the
    overlapped run against the barrier run: equal too (the head takes
    the same payload, and the mean is one function).  Peak and free
    device memory after every run.  ``pod_refs`` receives each kernel
    run's losses, eval loss and row digests (phase 10's references)."""
    phase("6e. int8 sync: barrier through K4 + K5, overlap through K4 + "
          "K6, each against its plain path")
    out, barrier = {}, None
    for name, (extra, want) in INT8_PATHS.items():
        argv = ["--sync-compress", "int8"] + extra
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        losses_k, walls_k, state, eval_k, _ = _train_once(
            device, train_argv() + argv)
        launches = launch_counts(**want)
        peak = torch.cuda.max_memory_allocated(device)
        check(bool(torch.isfinite(losses_k).all())
              and torch.isfinite(torch.tensor(eval_k)),
              f"int8 {name}: losses not finite {losses_k.tolist()}")
        kept = {f: getattr(state, f).cpu() for f in ("x", "e", "c")
                if getattr(state, f) is not None}
        pod_refs[f"int8_{name}"] = {
            "losses": losses_k.tolist(), "eval_loss": eval_k,
            "digests": {f: row_digests(t) for f, t in kept.items()}}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info(device)[0]
        print(f"int8 {name}: launches {launches}; losses "
              f"{losses_k.tolist()}; peak {peak / 2 ** 30:.3f} GiB, free "
              f"after {free / 2 ** 30:.3f} GiB", flush=True)

        reset_launches()
        losses_p, walls_p, state, _, _ = _train_once(
            device, train_argv(use_kernel=False) + argv)
        launch_counts()
        check(torch.equal(losses_k, losses_p)
              and all(torch.equal(t, getattr(state, f).cpu())
                      for f, t in kept.items()),
              f"int8 {name}: kernel path {losses_k.tolist()} != plain path "
              f"{losses_p.tolist()} (or final {sorted(kept)} differ)")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        print(f"int8 {name}: kernel path == plain path bit for bit "
              f"(8 losses, final {', '.join(sorted(kept))})", flush=True)
        if barrier is None:
            barrier = (losses_k, kept["x"], kept["e"])
        else:
            check(torch.equal(barrier[0], losses_k)
                  and torch.equal(barrier[1], kept["x"])
                  and torch.equal(barrier[2], kept["e"]),
                  "int8 overlap + flush differs from the int8 barrier run")
            print("int8 overlap + flush == int8 barrier bit for bit "
                  "(losses, x, e)", flush=True)
        out[name] = {"launches": {k: v for k, v in launches.items() if v},
                     "losses": losses_k.tolist(), "eval_loss": eval_k,
                     "round_wall_s": {"kernel": walls_k, "plain": walls_p},
                     "peak_memory_gib": round(peak / 2 ** 30, 3),
                     "free_after_gib": round(free / 2 ** 30, 3)}
        del kept
        gc.collect()
    del barrier
    print(json.dumps(out), flush=True)
    return out


def _train_measured(device, argv, cfg=None):
    """One run of the train CLI's run() from zeroed launch counters and
    peak-memory stats: (losses, round walls, final state, eval loss,
    peak GiB)."""
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    losses, walls, state, eval_loss, _ = _train_once(device, argv, cfg=cfg)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    check(bool(torch.isfinite(losses).all())
          and torch.isfinite(torch.tensor(eval_loss)),
          f"{argv}: losses not finite {losses.tolist()}, eval {eval_loss}")
    return losses, walls, state, eval_loss, peak


def _release():
    gc.collect()
    torch.cuda.empty_cache()


def train_baselines_phase(device, pod_refs) -> dict:
    """The paper's baselines on the same cell: Elastic-SGD for
    ELASTIC_STEPS steps through K7 (one launch a step; no other kernel),
    then without ``--use-kernel`` (the same losses and final x, v and ref
    bit for bit); then SGD for 8 (``--use-kernel`` is ignored: no port
    kernel; every loss finite).  Round walls and peak memory of each
    run."""
    phase("6f. Elastic-SGD through K7 and SGD: full-width qwen2.5-3b cut "
          f"to {TRAIN_LAYERS} layers, n=2, L=4, {ELASTIC_STEPS} and 8 steps")
    out = {}
    losses_k, walls_k, state, eval_k, peak = _train_measured(
        device, train_argv(steps=ELASTIC_STEPS, algo="elastic_sgd"))
    launches = launch_counts(elastic_update=ELASTIC_STEPS)
    kept = {f: getattr(state, f).cpu() for f in ("x", "v", "ref")}
    pod_refs["elastic_sgd"] = {
        "losses": losses_k.tolist(), "eval_loss": eval_k,
        "digests": {f: row_digests(t) for f, t in kept.items()}}
    del state
    _release()
    print(f"elastic_sgd: launches {launches}; losses {losses_k.tolist()}; "
          f"round walls {walls_k}; peak {peak:.3f} GiB", flush=True)
    losses_p, walls_p, state, _, peak_p = _train_measured(
        device, train_argv(steps=ELASTIC_STEPS, use_kernel=False,
                           algo="elastic_sgd"))
    launch_counts()
    check(torch.equal(losses_k, losses_p)
          and all(torch.equal(t, getattr(state, f).cpu())
                  for f, t in kept.items()),
          f"elastic_sgd: kernel path {losses_k.tolist()} != plain path "
          f"{losses_p.tolist()} (or final x / v / ref differ)")
    del state, kept
    _release()
    print(f"elastic_sgd: kernel path == plain path bit for bit (losses, "
          f"final x, v, ref); plain round walls {walls_p}", flush=True)
    out["elastic_sgd"] = {
        "launches": {k: v for k, v in launches.items() if v},
        "losses": losses_k.tolist(), "eval_loss": eval_k,
        "round_wall_s": {"kernel": walls_k, "plain": walls_p},
        "peak_memory_gib": round(peak, 3),
        "plain_peak_memory_gib": round(peak_p, 3)}

    losses_s, walls_s, state, eval_s, peak_s = _train_measured(
        device, train_argv(algo="sgd"))
    launch_counts()                       # SGD has no kernel
    del state
    _release()
    print(f"sgd: losses {losses_s.tolist()}; round walls {walls_s}; peak "
          f"{peak_s:.3f} GiB; no port kernel launched", flush=True)
    out["sgd"] = {"losses": losses_s.tolist(), "eval_loss": eval_s,
                  "round_wall_s": walls_s,
                  "peak_memory_gib": round(peak_s, 3)}
    print(json.dumps(out), flush=True)
    return out


def train_profile_phase(device, round_wall_s) -> dict:
    """One round of the kernel path under torch.profiler (CUDA activity
    only): device busy time against the round's wall, and the kernels
    that take it."""
    phase("6b. one training round under torch.profiler")
    t0 = time.perf_counter()
    _, walls, state, _, prof = _train_once(device, train_argv(steps=4),
                                           profile=True)
    del state
    rows = _device_rows(prof)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    share = {k: sum(us for us, key, _ in rows if k in key) / 1e6
             for k in ("parle_inner_kernel", "parle_sync_kernel")}
    check(busy_s > 0 and all(v > 0 for v in share.values()),
          "the profiler saw no device time, or no K1 / K2 launch")
    out = {"profiled_round_wall_s": walls[0], "device_busy_s": busy_s,
           "busy_share_of_profiled_round": busy_s / walls[0],
           "busy_share_of_unprofiled_round": busy_s / round_wall_s,
           "k1_device_s": share["parle_inner_kernel"],
           "k2_device_s": share["parle_sync_kernel"],
           "profile_phase_s": round(time.perf_counter() - t0, 1),
           "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                            "calls": c} for us, k, c in rows[:10]]}
    print(json.dumps(out), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------
# phase 10: the replica axis across processes, two ranks on the one card
# ------------------------------------------------------------------

POD_WORLD = 2
POD_TIMEOUT_S = 600
ROW_FIELDS = ("x", "e", "v")          # (n, M): a rank holds its own row
# job: (train_argv's algo, extra flags, kernel launches a rank, the
# fields held against phase 6's, the rank's collectives as {op: calls})
POD_JOBS = {
    "none": ("parle", [], dict(parle_inner_update=8, parle_sync_update=2),
             ("x",), {"all_reduce": 3, "all_gather": 2}),
    "int8_barrier": ("parle", ["--sync-compress", "int8"],
                     INT8_PATHS["barrier"][1], ("x", "e"),
                     {"all_reduce": 1, "all_gather": 4}),
    "int8_overlap": ("parle", ["--sync-compress", "int8", "--sync-overlap"],
                     INT8_PATHS["overlap"][1], ("x", "e", "c"),
                     {"all_reduce": 1, "all_gather": 4}),
    # 4 steps (phase 6f's): each a model-size all-reduce over gloo
    "elastic_sgd": ("elastic_sgd", ["--steps", str(ELASTIC_STEPS)],
                    dict(elastic_update=ELASTIC_STEPS), ("x", "v", "ref"),
                    {"all_reduce": ELASTIC_STEPS, "all_gather": 1}),
}


def row_digests(t) -> list:
    """The sha256 of each row of a tensor (of the whole tensor when it is
    1-D), hashed on the host in parallel threads: phase 10 holds the
    ranks' rows against phase 6's through them, bit for bit."""
    rows = [t] if t.dim() == 1 else list(t)
    digest = lambda r: hashlib.sha256(
        r.cpu().contiguous().view(torch.uint8).numpy()).hexdigest()
    with concurrent.futures.ThreadPoolExecutor(len(rows)) as ex:
        return list(ex.map(digest, rows))


def field_digests(state, fields) -> dict:
    """:func:`row_digests` of several fields of a state, all at once."""
    with concurrent.futures.ThreadPoolExecutor(len(fields)) as ex:
        return dict(zip(fields, ex.map(
            lambda f: row_digests(getattr(state, f)), fields)))


def _sync_records(events) -> list:
    """Each collective's d2h, gloo and h2d times from its three spans."""
    parts = [e for e in events
             if e["name"] in ("pod.d2h", "pod.collective", "pod.h2d")]
    return [{"op": c["args"]["op"], "axis": c["args"].get("axis", "pod"),
             "bytes": c["args"]["bytes"],
             "d2h_ms": round(d["dur"] / 1e3, 3),
             "collective_ms": round(c["dur"] / 1e3, 3),
             "h2d_ms": round(h["dur"] / 1e3, 3)}
            for d, c, h in zip(parts[0::3], parts[1::3], parts[2::3])]


def _pod_job(device, algo, extra, fields) -> dict:
    """One job of a rank: the train CLI's run() with ``--mesh pod:2``;
    what phase 10 compares and prints."""
    obs = Obs(trace_out=os.devnull)    # spans kept in memory, never saved
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    losses, walls, state, eval_loss, _ = _train_once(
        device, train_argv(algo=algo) + extra
        + ["--mesh", f"pod:{POD_WORLD}"], obs=obs)
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    digests = field_digests(state, fields)
    m = state.x.shape[-1]
    del state
    _release()
    return {"losses": losses.tolist(), "eval_loss": eval_loss,
            "round_wall_s": walls, "launches": launches,
            "digests": digests, "elements_per_replica": m,
            "collectives": collective_counts(obs.registry),
            "syncs": _sync_records(obs.tracer.events),
            "peak_memory_gib": round(peak / 2 ** 30, 3)}


def pod_rank_main(rank, world, port, out_q, ckpt_dir):
    """One rank of phase 10, a spawned process (a fresh interpreter that
    imported this file; the parent built the kernels): join the gloo
    world, run every POD_JOBS job on this rank's replica under
    deterministic algorithms, then phase 12a's checkpoint jobs (files in
    ``ckpt_dir``), and put the results on ``out_q``."""
    import traceback
    # two ranks of ~33 GB each share the card: no reserved-but-free blocks
    # (the allocator reads this at its first allocation, still ahead)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        torch.use_deterministic_algorithms(True)
        pin_float32()
        device = resolve_device("cuda")
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        res = {name: _pod_job(device, algo, extra, fields)
               for name, (algo, extra, _, fields, _) in POD_JOBS.items()}
        res["ckpt"] = ckpt_rank_jobs(device, rank, ckpt_dir)
        out_q.put((rank, res, None))
    except BaseException:            # reported to the parent, then raised
        out_q.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


_PORTS: list = []


def free_port() -> int:
    """A TCP port of 127.0.0.1 for a pod's rendezvous or coordinator:
    drawn outside the kernel's ephemeral range (``runtime/coordinator.py::
    free_ports``), where no outgoing connection can take it as its source
    port before its server binds it, and never handed out twice in a run,
    so that pods started side by side share none."""
    if not _PORTS:
        _PORTS.extend(free_ports(32))
    return _PORTS.pop()


def _run_ranks(target, world, timeout, *args, beside=None):
    """Spawn ``world`` ranks of ``target(rank, world, port, out_q,
    *args)`` (spawn, never fork: this process has a live CUDA context)
    and collect their results; a failing rank fails the phase, and no
    rank outlives it.  ``beside(procs)``, when given, runs in this
    process while the ranks run (it may watch them) and its result is
    returned beside theirs: (results, beside's)."""
    import queue
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(r, world, port, out_q, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, err, extra = {}, None, None
    try:
        if beside is not None:
            extra = beside(procs)
        for _ in range(world):           # drain before joining
            rank, res, tb = out_q.get(timeout=timeout)
            if tb is not None:
                err = f"rank {rank} failed:\n{tb}"
                break
            results[rank] = res
    except queue.Empty:
        err = f"ranks gave no result within {timeout} s"
    finally:
        for p in procs:
            p.join(timeout=5 if err else 120)
            if p.is_alive():
                p.kill()
                p.join()
    check(err is None, str(err))
    check(all(p.exitcode == 0 for p in procs),
          f"rank exit codes {[p.exitcode for p in procs]}")
    return results, extra


def _run_pod_ranks(ckpt_dir, beside=None) -> dict:
    """Phase 10's POD_WORLD ranks (:func:`pod_rank_main`)."""
    return _run_ranks(pod_rank_main, POD_WORLD, POD_TIMEOUT_S, ckpt_dir,
                      beside=beside)


def pod_phase(device, refs, smi) -> dict:
    """Phase 10: Parle's replica axis over two ranks of a gloo world on
    the one card (each rank a spawned process holding one of the two
    replicas; every collective staged through pinned host memory): the
    f32 barrier run through K1 / K2, the int8 barrier (K4 / K5) and
    overlap (K4 / K6 + the flush) runs, and Elastic-SGD through K7, each
    phase 6's argv plus ``--mesh pod:2``.  Every rank's losses and eval
    loss equal phase 6's run and its final rows (and c, ref) hash to
    phase 6's rows bit for bit; each rank launches each kernel as
    counted, and makes exactly its collectives.  Beside the ranks, the
    pod launcher's CLI at smoke size on the card (bitwise_equal) and,
    once the ranks have written 12a's checkpoint, 12a's one-process
    resume.  Times: two ranks time-slicing one card over loopback gloo,
    not a multi-card figure."""
    phase("10. the replica axis across processes: two ranks on the one "
          "card over gloo (pinned host staging), parle n=2 L=4 8 steps "
          "through K1/K2, int8 through K4/K5 and K4/K6, elastic_sgd "
          "through K7, then 12a's checkpoint jobs; dist_run --device "
          "cuda beside them")
    t0 = time.perf_counter()
    _release()
    free = torch.cuda.mem_get_info(device)[0]
    print(f"pod: free device memory before the ranks "
          f"{free / 2 ** 30:.3f} GiB", flush=True)
    ckpt_dir, where = ckpt_directory()
    beside = {}
    try:
        results, _ = _run_pod_ranks(ckpt_dir, beside=lambda procs: (
            pod_beside(device, ckpt_dir, procs, beside)))
        files = ckpt_files(ckpt_dir)
    finally:
        launcher = beside.get("launcher")
        if launcher is not None and launcher.poll() is None:
            launcher.kill()
            launcher.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = {}
    for name, (_, _, want, fields, calls) in POD_JOBS.items():
        ref = refs[name]
        expected = {k: want.get(k, 0) for k in COUNTERS}
        for rank in range(POD_WORLD):
            r = results[rank][name]
            m = r["elements_per_replica"]
            check(r["losses"] == ref["losses"]
                  and r["eval_loss"] == ref["eval_loss"],
                  f"pod {name} rank {rank}: losses {r['losses']} / eval "
                  f"{r['eval_loss']} != phase 6's {ref['losses']} / "
                  f"{ref['eval_loss']}")
            for f in fields:
                d = ref["digests"][f]
                check(r["digests"][f] == (d[rank:rank + 1]
                                          if f in ROW_FIELDS else d),
                      f"pod {name} rank {rank}: final {f} differs from "
                      "phase 6's bit for bit")
            check(r["launches"] == expected,
                  f"pod {name} rank {rank}: launches {r['launches']}, "
                  f"expected {expected}")
            got_calls = {op: c[0] for op, c in r["collectives"].items()}
            check(got_calls == calls, f"pod {name} rank {rank}: "
                  f"collectives {r['collectives']}, expected calls {calls}")
            model_size = [s for s in r["syncs"] if s["bytes"] == 4 * m]
            if name in ("none", "elastic_sgd"):
                check(len(model_size) == calls["all_reduce"],
                      f"pod {name}: {len(model_size)} model-size "
                      "all-reduces")
            print(json.dumps({"pod_job": name, "rank": rank,
                              "round_wall_s": r["round_wall_s"],
                              "collectives": r["collectives"],
                              "syncs": r["syncs"],
                              "peak_memory_gib": r["peak_memory_gib"],
                              "card": smi}), flush=True)
        out[name] = {
            "launches_per_rank": {k: v for k, v in
                                  results[0][name]["launches"].items() if v},
            "round_wall_s": [results[r][name]["round_wall_s"]
                             for r in range(POD_WORLD)],
            "collectives": results[0][name]["collectives"],
            "syncs": results[0][name]["syncs"],
            "peak_memory_gib": [results[r][name]["peak_memory_gib"]
                                for r in range(POD_WORLD)]}
        print(f"pod {name}: both ranks == phase 6 bit for bit (losses, "
              f"eval, final {', '.join(fields)}); launches a rank "
              f"{out[name]['launches_per_rank']}", flush=True)
    ranks_s = time.perf_counter() - t0
    out["ckpt"] = ckpt_phase_report(results, beside.get("pod1"), files,
                                    where, smi)

    check("rc" in beside, "dist_run did not run beside the ranks")
    stdout, stderr = beside["stdout"], beside["stderr"]
    check(beside["rc"] == 0, f"dist_run exited {beside['rc']}:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    verdict = json.loads(stdout.strip().splitlines()[-1])
    check(verdict["bitwise_equal"] is True
          and verdict["compared_steps"] == 6, f"dist_run: {verdict}")
    print(f"dist_run --nproc 2 --smoke --device cuda: {json.dumps(verdict)}",
          flush=True)
    out["dist_run"] = {"verdict": verdict, "wall_s": beside["wall_s"]}
    out["ranks_wall_s"] = round(ranks_s, 1)
    out["phase_wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"pod_phase_wall_s": out["phase_wall_s"],
                      "ranks_wall_s": out["ranks_wall_s"],
                      "dist_run_wall_s": out["dist_run"]["wall_s"],
                      "card": smi}), flush=True)
    return out


# ------------------------------------------------------------------
# phase 11: the async / elastic pod
# ------------------------------------------------------------------

ASYNC_POD_TIMEOUT_S = 420
# the pod parent, run as `python -c`: dist_run's own entry point, then
# the parent's peak RSS (the coordinator's host memory; its workers are
# processes of their own), sampled every 0.1 s from /proc/self/statm
# (getrusage's ru_maxrss survives the exec, so a process forked from
# this one reports this one's RSS when it is larger; the card machine's
# /proc has no VmHWM); null where there is no statm
ASYNC_POD_MAIN = (
    "import json, os, sys, threading, time\n"
    "peak = [None]\n"
    "def sample():\n"
    "    page = os.sysconf('SC_PAGE_SIZE')\n"
    "    while True:\n"
    "        with open('/proc/self/statm') as f:\n"
    "            rss = int(f.read().split()[1]) * page\n"
    "        peak[0] = max(peak[0] or 0, rss)\n"
    "        time.sleep(0.1)\n"
    "threading.Thread(target=sample, daemon=True).start()\n"
    "from repro_torch.launch import dist_run\n"
    "rc = dist_run.main(sys.argv[1:])\n"
    "print(json.dumps({'parent_peak_rss_gib':\n"
    "                  peak[0] and peak[0] / 2 ** 30}), flush=True)\n"
    "sys.exit(rc)\n")
# 11c: the reference's chaos acceptance plan (tests/test_faults.py)
CHAOS_PLAN = {"seed": 11, "faults": [
    {"kind": "crash", "worker": 3, "round": 3},
    {"kind": "hang", "worker": 2, "round": 2, "ms": 2500},
    {"kind": "poison", "worker": 1, "round": 2},
    {"kind": "corrupt_frame", "worker": 0, "round": 4},
    {"kind": "coordinator_kill", "round": 5, "down_ms": 300},
]}


def async_single_phase(device, ref) -> dict:
    """11a: the async policy with one worker, in this process, at phase
    6's cell (its ParleConfig, params and batches): each round's L inner
    steps through K1 (``AsyncElasticPolicy.make_round_fn(use_kernel=
    True)``), then the coordinator's math on the host with no socket
    (a (2, M) f32 payload is above the frame's 4 GiB): the contribution,
    its dequantized mean and the staleness-weighted mean (one worker:
    its own mean), the consensus row and the plain apply.  The 8 losses
    and the sha256 of each final row of x equal phase 6's barrier run
    bit for bit; K1 launched 8 times, K2 never."""
    phase(f"11a. async policy, one worker in process: full-width "
          f"qwen2.5-3b cut to {TRAIN_LAYERS} layers, parle n=2 L=4, 8 "
          "steps, inner rounds through K1, the consensus on the host")
    _release()
    torch.use_deterministic_algorithms(True)
    t_phase = time.perf_counter()
    args = train.parse_args(train_argv())
    cfg = train_cfg()
    model = build_model(cfg)
    algo = registry.get(args.algo)
    pcfg = train.parle_config(args, algo)
    n, L = pcfg.n_replicas, pcfg.L
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, seed=args.seed,
                         device=str(device))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = parle.dealias_state(algo.init(model.init(gen), pcfg))
    stage = make_round_batch_fn(stream, L, args.batch, n)
    round_fn = AsyncElasticPolicy(None, pcfg, Obs(), worker=0).make_round_fn(
        algo, model.loss, pcfg, use_kernel=True)
    apply_fn = parle.make_async_apply_fn(pcfg)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    losses, host_s = [], []
    for r in range(args.steps // L):
        state, metrics = round_fn(state, stage(r * L))
        losses.append(metrics["losses"].detach().cpu())
        t0 = time.perf_counter()
        payload, _ = parle.async_contribution(state, pcfg)
        t1 = time.perf_counter()
        means = [_np_dequant(p["q"], p["scales"], "none").mean(axis=0)
                 for p in payload]
        del payload
        xbar = parle.staleness_weighted_mean([means], [n], [r])
        t2 = time.perf_counter()
        state = apply_fn(state, parle.consensus_from_flat(xbar, state))
        torch.cuda.synchronize(device)
        t3 = time.perf_counter()
        del means, xbar
        host_s.append({"contribution_s": round(t1 - t0, 3),
                       "mean_s": round(t2 - t1, 3),
                       "apply_s": round(t3 - t2, 3)})
    launches = launch_counts(parle_inner_update=8)
    peak = torch.cuda.max_memory_allocated(device)
    losses = torch.cat(losses).tolist()
    check(losses == ref["losses"], f"async (one worker) losses {losses} "
          f"!= phase 6's {ref['losses']}")
    check(row_digests(state.x) == ref["digests"]["x"],
          "async (one worker): final x differs from phase 6's bit for bit")
    del state
    _release()
    torch.use_deterministic_algorithms(False)
    out = {"launches": launches, "host_s": host_s,
           "peak_memory_gib": round(peak / 2 ** 30, 3),
           "phase_wall_s": round(time.perf_counter() - t_phase, 1)}
    print(f"async one worker == phase 6's barrier run bit for bit (8 "
          f"losses, final x); launches {launches}", flush=True)
    print(json.dumps({"async_single": out}), flush=True)
    return out


def _frame_bytes(obj) -> int:
    """The bytes of the coordinator's frame for ``obj`` (header + the
    pickle), counted without holding the pickle."""
    import pickle

    class Count:
        n = 8                                  # the !II header

        def write(self, b):
            self.n += memoryview(b).nbytes

    sink = Count()
    pickle.dump(obj, sink, protocol=pickle.HIGHEST_PROTOCOL)
    return sink.n


def _start_async_pod(argv, env):
    """One async pod through dist_run's entry point in a process of its
    own (this one holds a CUDA context; the pod's parent never touches
    the card)."""
    return (subprocess.Popen([sys.executable, "-c", ASYNC_POD_MAIN, *argv],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            time.time())


def _finish_async_pod(started, tag) -> dict:
    """Wait for a pod of :func:`_start_async_pod`: its JSON lines,
    DISTLOSS records, stderr, start (epoch s), wall until collected and
    the parent's peak RSS."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=ASYNC_POD_TIMEOUT_S)
    except subprocess.TimeoutExpired:   # no pod outlives the phase
        proc.kill()
        stdout, stderr = proc.communicate()
        check(False, f"async pod {tag} ran past {ASYNC_POD_TIMEOUT_S} s:\n"
              f"{stdout[-3000:]}\n{stderr[-3000:]}")
    wall = time.time() - t0
    check(proc.returncode == 0,
          f"async pod {tag} exited {proc.returncode}:\n"
          f"{stdout[-3000:]}\n{stderr[-3000:]}")
    out = {"stderr": stderr, "wall_s": round(wall, 1), "started": t0,
           "losses": [json.loads(line[len("DISTLOSS "):])
                      for line in stdout.splitlines()
                      if line.startswith("DISTLOSS ")]}
    for line in stdout.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    return out


def _run_async_pod(argv, env, tag) -> dict:
    return _finish_async_pod(_start_async_pod(argv, env), tag)


def _pod_metrics(mpath, nproc) -> dict:
    """The pod's merged record, its counters, and each worker's final
    snapshot summaries and pod_step losses."""
    merged = [e for e in read_events(mpath, tolerate_torn_tail=True)
              if e["kind"] == "pod_merged"][-1]
    workers = {}
    for i in range(nproc):
        path = f"{mpath}.worker{i}"
        if not os.path.exists(path):
            continue
        evs = read_events(path, tolerate_torn_tail=True)
        snap = [e for e in evs if e["kind"] == "metrics_snapshot"]
        workers[i] = {
            "losses": [e["loss"] for e in evs if e["kind"] == "pod_step"],
            "faults": [(e["fault"], e["worker"]) for e in evs
                       if e["kind"] == "fault_injected"],
            "series": snapshot_summaries(snap[-1]["snapshot"])
            if snap else {}}
    return {"merged": merged, "workers": workers,
            "counters": {c["name"]: c["total"]
                         for c in merged["snapshot"]["counters"]}}


def _pod_report(run, metrics, smi) -> dict:
    """What 11b prints of one pod: each worker's exchange walls, round
    wall, staleness and peak device memory, the parent's peak RSS."""
    rss = run.get("parent_peak_rss_gib")
    rep = {"wall_s": run["wall_s"],
           "parent_peak_rss_gib": None if rss is None else round(rss, 3)}
    for i, w in metrics["workers"].items():
        s = w["series"]
        wait = s.get(f"pod.sync_wait_ms{{worker={i}}}", {})
        rnd = s.get(f"pod.round_wall_ms{{worker={i}}}", {})
        rep[f"worker{i}"] = {
            "exchanges": wait.get("count"),
            "sync_wait_ms": {k: wait.get(k) for k in ("min", "max", "mean")},
            "round_wall_ms": {k: rnd.get(k) for k in ("count", "min",
                                                       "max")},
            "round_ms": {k: s.get("pod.round_ms", {}).get(k)
                         for k in ("min", "max")},
            "staleness_last": s.get("pod.staleness", {}).get("value"),
            "peak_device_memory_gib": round(s.get(
                f"pod.peak_device_memory_bytes{{worker={i}}}",
                {}).get("value", 0) / 2 ** 30, 3)}
    rep["card"] = smi
    return rep


def _pod_env(**extra) -> dict:
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _start_chaos_pods(tmp) -> dict:
    """11c's two pods, started side by side: the reference's chaos plan
    and its fault-free twin (each fault is on the host, and the twin's
    30 s liveness window is not the chaos pod's 0.5 s)."""
    started = {}
    for tag, plan in (("clean", None), ("chaos", CHAOS_PLAN)):
        argv = ["--sync-policy", "async", "--device", "cuda", "--smoke",
                "--nproc", "4", "--replicas", "8", "--steps", "15",
                "--L", "3", "--checkpoint-out",
                os.path.join(tmp, f"ck_{tag}.npz"), "--metrics-out",
                os.path.join(tmp, f"{tag}.jsonl"), "--port",
                str(free_port()), "--coord-port", str(free_port())]
        if plan is not None:
            argv += ["--fault-plan", json.dumps(plan), "--liveness-s", "0.5"]
        started[tag] = _start_async_pod(argv, _pod_env())
    return started


def _finish_chaos_pods(started, tmp, smi) -> dict:
    """11c's gates (the reference's tests/test_faults.py acceptance pod):
    both pods end at round 5, the chaos pod's final consensus L2 within
    1e-3 of the twin's, every fault class counted and announced, the
    twin clean."""
    res = {}
    for tag in ("clean", "chaos"):
        mpath = os.path.join(tmp, f"{tag}.jsonl")
        run = _finish_async_pod(started.pop(tag), tag)
        vectors, rnd, _ = load_consensus(os.path.join(tmp, f"ck_{tag}.npz"))
        res[tag] = {"run": run, "metrics": _pod_metrics(mpath, 4),
                    "round": rnd, "l2": parle.contribution_norm(vectors),
                    "events": [e["kind"] for e in read_events(
                        mpath, tolerate_torn_tail=True)]}
    clean, chaos = res["clean"], res["chaos"]
    c = chaos["metrics"]["counters"]
    check(chaos["round"] == clean["round"] == 5,
          f"rounds: chaos {chaos['round']}, clean {clean['round']}")
    check(abs(chaos["l2"] - clean["l2"]) <= 1e-3 * clean["l2"],
          f"chaos consensus L2 {chaos['l2']} vs the twin's {clean['l2']}")
    check(c.get("pod.quarantined_updates", 0) >= 1
          and c["pod.evicted_workers"] >= 1
          and c["pod.coordinator_restarts"] == 1
          and c["pod.worker_crashes"] == 1 and c["pod.corrupt_frames"] >= 1,
          f"chaos counters {c}")
    check(chaos["metrics"]["merged"]["missing_workers"] == 1
          and chaos["metrics"]["merged"]["evicted_workers"] >= 1,
          "chaos merged record: missing "
          f"{chaos['metrics']['merged']['missing_workers']}, evicted "
          f"{chaos['metrics']['merged']['evicted_workers']}")
    fired = {tuple(f) for w in chaos["metrics"]["workers"].values()
             for f in w["faults"]}
    check({("crash", 3), ("hang", 2), ("poison", 1),
           ("corrupt_frame", 0)} <= fired, f"fault_injected records {fired}")
    for kind in ("coordinator_restart", "worker_quarantined",
                 "worker_evicted"):
        check(kind in chaos["events"], f"no {kind} event")
    check("worker 3 crashed per fault plan (rc=57)" in chaos["run"]["stderr"]
          and "coordinator restarted" in chaos["run"]["stderr"],
          "the parent's stderr lacks the crash / restart lines")
    cc = clean["metrics"]["counters"]
    check(cc["pod.coordinator_restarts"] == 0
          and cc.get("pod.quarantined_updates", 0) == 0
          and clean["metrics"]["merged"]["missing_workers"] == 0,
          f"the fault-free twin: {cc}")
    out = {"rounds": {"clean": clean["round"], "chaos": chaos["round"]},
           "l2": {"clean": clean["l2"], "chaos": chaos["l2"]},
           "rel_l2": abs(chaos["l2"] - clean["l2"]) / clean["l2"],
           "counters": {k: v for k, v in c.items()
                        if k not in ("pod.steps", "pod.tokens")},
           # each pod's own wall: start to its merged record (they are
           # collected after 11b's resumed pod)
           "wall_s": {t: round(res[t]["metrics"]["merged"]["ts"]
                               - res[t]["run"]["started"], 1) for t in res},
           "card": smi}
    print(json.dumps({"async_chaos": out}), flush=True)
    return out


def async_pods_phase(device, smi) -> dict:
    """11b: the async pod at full width through the wire, two workers
    of one replica each on the card (``dist_run --sync-policy async
    --device cuda``, 12a's model: Mamba2-1.3B cut to 2 layers, 1.03 GB a
    f32 copy — an exchange is host work over the consensus's bytes),
    int8 contributions, 2 rounds of L = 4, its consensus checkpointed; then
    the pod resumed from that checkpoint as ONE worker for one round
    (its gates read the first consensus; the pod shrinks,
    f32 contributions: its first consensus is the checkpoint's, so its
    L2 is held at rtol 1e-5 — an int8 contribution would move it by the
    codec's error).  Gates: the reference's elastic-resume contract
    (tests/test_runtime_async.py::test_async_elastic_resume_grow_and_
    shrink).

    11c, started beside the resumed pod (one full-width worker leaves
    the card room): the reference's chaos acceptance pod
    (tests/test_faults.py) at smoke width — four workers of two
    replicas, 5 rounds of L = 3; worker 3 crashes at round 3, worker 2
    hangs 2.5 s past a 0.5 s liveness deadline at round 2, worker 1 is
    NaN-poisoned at round 2, worker 0 sends a corrupt frame at round 4,
    and the coordinator is killed at round 5 (300 ms down) — and its
    fault-free twin.  Smoke width: four workers of two full-width
    replicas would exceed 80 GB, and every fault is on the host."""
    phase(f"11b. the async pod at full width: dist_run --sync-policy async "
          f"--device cuda, {CKPT_ARCH} cut to {CKPT_LAYERS} layers, 2 "
          "workers x 1 replica, int8, 8 steps L=4, checkpoint; resumed as "
          "1 worker for one round")
    _release()
    t_phase = time.perf_counter()
    print(f"async pod: free device memory before the workers "
          f"{torch.cuda.mem_get_info(device)[0] / 2 ** 30:.3f} GiB",
          flush=True)
    cfg = ckpt_cfg()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_async_")
    env = _pod_env(PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    base = ["--sync-policy", "async", "--device", "cuda", "--arch",
            CKPT_ARCH, "--steps", "8", "--L", "4", "--batch", "2",
            "--seq", "256", "--seed", "0",
            "--_config", json.dumps(dataclasses.asdict(cfg))]
    base_b = [("4" if i and base[i - 1] == "--steps" else a)
              for i, a in enumerate(base)]
    ck = os.path.join(tmp, "ck.npz")
    started = {}
    try:
        m_a = os.path.join(tmp, "a.jsonl")
        a = _run_async_pod(base + [
            "--nproc", "2", "--replicas", "2", "--sync-compress", "int8",
            "--checkpoint-out", ck, "--metrics-out", m_a,
            "--port", str(free_port()), "--coord-port", str(free_port())],
            env, "a")
        m_b = os.path.join(tmp, "b.jsonl")
        # one round resumed: the gates read its first consensus
        started["b"] = _start_async_pod(base_b + [
            "--nproc", "1", "--replicas", "1", "--sync-compress", "none",
            "--resume", ck, "--metrics-out", m_b,
            "--port", str(free_port()), "--coord-port", str(free_port())],
            env)
        phase("11c. the chaos pod on the card (smoke width): 4 workers, "
              "crash + hang + poison + corrupt frame + coordinator kill, "
              "beside its fault-free twin (and 11b's resumed pod)")
        t_chaos = time.perf_counter()
        started.update(_start_chaos_pods(tmp))

        # the first pod's checks while the others run
        pa = _pod_metrics(m_a, 2)
        t0 = time.perf_counter()
        vectors, rnd, meta = load_consensus(ck)
        load_s = time.perf_counter() - t0
        ck_l2 = parle.contribution_norm(vectors)
        reply_bytes = _frame_bytes({"consensus": vectors, "staleness": 0,
                                    "n_active": 2})
        digest = consensus_digest(vectors)
        del vectors
        gc.collect()
        check(a["round"] == rnd == 2, f"checkpoint round {rnd} / "
              f"{a['round']}, expected 2")
        check(digest == meta["digest"] == a["consensus_digest"],
              f"checkpoint digest {digest} != {meta['digest']} / "
              f"{a['consensus_digest']}")
        check(reply_bytes < 2 ** 32, f"a reply frame of {reply_bytes} B")
        check(pa["counters"]["pod.steps"] == 2 * 8
              and pa["merged"]["missing_workers"] == 0,
              f"pod a: counters {pa['counters']}, merged "
              f"{ {k: v for k, v in pa['merged'].items() if k != 'snapshot'} }")
        losses_a = [v for w in pa["workers"].values() for v in w["losses"]]
        check(len(losses_a) == 16 and all(np.isfinite(losses_a)),
              f"pod a losses {losses_a}")

        b = _finish_async_pod(started.pop("b"), "b")
        pb = _pod_metrics(m_b, 1)
        check(b["consensus_digest"] == digest and b["base_round"] == 2,
              f"resumed pod: echo {b['consensus_digest']} / base round "
              f"{b['base_round']}")
        check(abs(b["first_consensus_l2"] - ck_l2) <= 1e-5 * ck_l2,
              f"resumed pod's first consensus L2 {b['first_consensus_l2']}"
              f" vs the checkpoint's {ck_l2}")
        check(pb["counters"]["pod.steps"] == 2 * 8 + 4
              and pb["merged"]["missing_workers"] == 0,
              f"pod b: counters {pb['counters']}")
        losses_b = pb["workers"][0]["losses"]
        check(len(losses_b) == 4 and all(np.isfinite(losses_b)),
              f"pod b losses {losses_b}")
        pod = {"grow_shrink": "2 -> 1 workers", "checkpoint_round": rnd,
               "checkpoint_l2": ck_l2,
               "resumed_first_l2": b["first_consensus_l2"],
               "reply_frame_bytes": reply_bytes,
               "checkpoint_load_s": round(load_s, 1),
               "a": _pod_report(a, pa, smi), "b": _pod_report(b, pb, smi),
               "losses": {"a_worker0": [r["loss"] for r in a["losses"]],
                          "b": [r["loss"] for r in b["losses"]]},
               "phase_wall_s": round(time.perf_counter() - t_phase, 1)}
        print(json.dumps({"async_pod": pod}), flush=True)
        chaos = _finish_chaos_pods(started, tmp, smi)
        chaos["phase_wall_s"] = round(time.perf_counter() - t_chaos, 1)
    finally:
        for proc, _ in started.values():     # a pod left by a failure
            proc.kill()
            proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return {"pod": pod, "chaos": chaos}


def async_phase(device, ref, smi) -> dict:
    """Phase 11: the async / elastic pod (11a, then 11b with 11c beside
    its resumed pod)."""
    t0 = time.perf_counter()
    out = {"single": async_single_phase(device, ref),
           **async_pods_phase(device, smi)}
    out["phase_wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"async_phase_wall_s": out["phase_wall_s"],
                      "card": smi}), flush=True)
    return out


# ------------------------------------------------------------------
# phase 12: checkpoint across ranks, remat, the reference's stream
# ------------------------------------------------------------------

# 12a: full-width Mamba2-1.3B cut to 2 layers (1.03 GB of float32 a
# copy), Parle n = 2 over two ranks, int8 + overlap through K1 / K4 / K6,
# L = 2, 6 steps, one checkpoint (step 4).  The train CLI's scoping
# schedule takes its epoch from --steps (batches_per_epoch = steps // 4,
# as the reference's), so the resumed run (2 steps) continues the
# uninterrupted one bit for bit only where steps // 4 agree: 6 and 2 do,
# 8 and 4 would not
CKPT_ARCH, CKPT_LAYERS, CKPT_STEPS, CKPT_EVERY = "mamba2-1.3b", 2, 6, 4
CKPT_FIELDS = ("x", "e", "c")
CKPT_STARTED = "12a_started"     # rank 0's mark: the ranks reached 12a
# a file holds six (n, M) row fields and c: 13 copies
CKPT_COPIES, SHM_SPARE = 13, 4 * 2 ** 30
CKPT_LAUNCHES = {     # run: K1, K4 (the first head), K6 (every later head)
    "full": dict(parle_inner_update=6, quantize_ef=1,
                 parle_apply_quantize=2),
    "resumed": dict(parle_inner_update=2, parle_apply_quantize=1)}


def ckpt_cfg():
    return dataclasses.replace(get_config(CKPT_ARCH), num_layers=CKPT_LAYERS)


def ckpt_argv(steps, mesh, extra=()) -> list:
    return ["--arch", CKPT_ARCH, "--device", "cuda", "--replicas", "2",
            "--L", "2", "--steps", str(steps), "--batch", "2", "--seq",
            "256", "--round-fused", "--use-kernel", "--sync-compress",
            "int8", "--sync-overlap", "--log-every", "2", "--seed", "0",
            "--mesh", mesh, *extra]


def ckpt_directory(copies=CKPT_STEPS // CKPT_EVERY * CKPT_COPIES):
    """(a new directory for checkpoints of ``copies`` f32 copies of
    ckpt_cfg()'s model in all — 12a's by default —, "shm" or "tmp"):
    under /dev/shm when it has room for them and 4 GiB more, else in the
    default temporary directory."""
    cfg = ckpt_cfg()
    per_copy = 4 * (2 * cfg.vocab_size * cfg.d_model + CKPT_LAYERS * (
        cfg.d_model * (2 * cfg.ssm_inner + 2 * cfg.ssm_state
                       + cfg.ssm_num_heads) + cfg.ssm_inner * cfg.d_model))
    need = copies * per_copy + SHM_SPARE
    if os.path.isdir("/dev/shm"):
        st = os.statvfs("/dev/shm")
        if st.f_bavail * st.f_frsize >= need:
            return tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                    dir="/dev/shm"), "shm"
    return tempfile.mkdtemp(prefix="chip_smoke_ckpt_"), "tmp"


def _span_s(events, name) -> list:
    return [round(e["dur"] / 1e6, 3) for e in events if e["name"] == name]


def _ckpt_job(device, argv, obs, fields=CKPT_FIELDS, against=None) -> dict:
    """One run of the train CLI's run() on ckpt_cfg() (12a's, 13c's): its
    losses, eval loss, the row digests of ``fields``, launches, peak
    memory and the seconds of its checkpoints (each gather stage with
    its axis and bytes, whole save, rank 0's writes) and of its
    restore; ``against``: a checkpoint its final state is held to
    (:func:`leaves_against_file`)."""
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    t0 = time.perf_counter()
    losses, walls, state, eval_loss, _ = _train_once(device, argv,
                                                     cfg=ckpt_cfg(), obs=obs)
    wall = time.perf_counter() - t0
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    digests = field_digests(state, fields) if fields else {}
    held = leaves_against_file(state, against) if against else None
    del state
    _release()
    ev = obs.tracer.events
    gathers = [e["args"] for e in ev if e["name"] == "pod.gather"]
    return {"losses": losses.tolist(), "eval_loss": eval_loss,
            "digests": digests, "launches": launches, "round_wall_s": walls,
            "wall_s": round(wall, 3),
            "peak_memory_gib": round(peak / 2 ** 30, 3),
            "checkpoint_s": _span_s(ev, "checkpoint"),
            "write_s": [e["args"]["write_s"] for e in ev
                        if e["name"] == "checkpoint"
                        and "write_s" in e["args"]],
            "gather_s": [g["gather_s"] for g in gathers],
            "gather_bytes": [g["bytes"] for g in gathers],
            "gathers": [{k: g[k] for k in ("axis", "bytes", "gather_s")}
                        for g in gathers],
            "restore_s": _span_s(ev, "restore"), "against_file": held}


def ckpt_rank_jobs(device, rank, ckpt_dir) -> dict:
    """12a on one rank of phase 10's world: the uninterrupted pod:2 run
    (a checkpoint at step 4; rank 0 writes its metrics and trace for
    12c's report), then the pod:2 run resumed from step 4."""
    t0 = time.perf_counter()
    if rank == 0:           # the parent starts what runs beside 12a
        open(os.path.join(ckpt_dir, CKPT_STARTED), "w").close()
    files = (dict(metrics_out=os.path.join(ckpt_dir, "m.jsonl"),
                  trace_out=os.path.join(ckpt_dir, "t.json"))
             if rank == 0 else dict(trace_out=os.devnull))
    obs = Obs(**files, pid=rank, process_name="train")
    out = {"full": _ckpt_job(device, ckpt_argv(
        CKPT_STEPS, f"pod:{POD_WORLD}", ["--checkpoint-dir", ckpt_dir,
                                          "--checkpoint-every",
                                          str(CKPT_EVERY)]), obs)}
    obs.finalize()
    out["pod2"] = _ckpt_job(device, ckpt_argv(
        CKPT_STEPS - CKPT_EVERY, f"pod:{POD_WORLD}",
        ["--resume", ckpt_path(ckpt_dir)]), Obs(trace_out=os.devnull))
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    return out


def ckpt_path(ckpt_dir) -> str:
    return os.path.join(ckpt_dir, f"step{CKPT_EVERY:06d}.npz")


def _wait_for(path, procs) -> bool:
    """Poll for ``path`` while every rank lives; False when a rank ended
    first or POD_TIMEOUT_S passed (the ranks' results say why)."""
    deadline = time.perf_counter() + POD_TIMEOUT_S
    while not os.path.exists(path):
        if (time.perf_counter() > deadline
                or not all(p.is_alive() for p in procs)):
            return False
        time.sleep(0.5)
    return True


def pod_beside(device, ckpt_dir, procs, out) -> None:
    """What this process runs while phase 10's ranks run, once they
    reach 12a (their full-width jobs done, the card has room): the pod
    launcher's CLI at smoke size (``dist_run --nproc 2 --smoke --device
    cuda``) and, once the ranks' checkpoint is written, 12a's one-process
    resume.  Fills ``out``: the launcher's rc, output and wall, and
    "pod1"."""
    if not _wait_for(os.path.join(ckpt_dir, CKPT_STARTED), procs):
        return
    t0 = time.perf_counter()
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    out["launcher"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dist_run", "--nproc", "2",
         "--smoke", "--steps", "6", "--L", "3", "--device", "cuda",
         "--port", str(free_port())],
        env=_pod_env(), stdout=logs[0], stderr=logs[1], text=True)
    out["pod1"] = ckpt_resume_beside(device, ckpt_dir, procs)
    out["rc"] = out["launcher"].wait(timeout=300)
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    for key, f in zip(("stdout", "stderr"), logs):
        f.seek(0)
        out[key] = f.read()
        f.close()


def ckpt_resume_beside(device, ckpt_dir, procs) -> dict:
    """12a's one-process resume (pod:1, both replicas), in this process
    beside the ranks' pod:2 resume: it waits for the ranks' checkpoint
    (its sidecar is written last), then runs under deterministic
    algorithms.  None when a rank ends first (its failure is reported)."""
    if not _wait_for(ckpt_path(ckpt_dir) + ".json", procs):
        return None
    _release()
    torch.use_deterministic_algorithms(True)
    try:
        return _ckpt_job(device, ckpt_argv(
            CKPT_STEPS - CKPT_EVERY, "pod:1",
            ["--resume", ckpt_path(ckpt_dir)]), Obs(trace_out=os.devnull))
    finally:
        torch.use_deterministic_algorithms(False)


def ckpt_files(ckpt_dir) -> dict:
    """The checkpoints' bytes, and 12a's metrics and trace moved to a
    directory of their own (12c reads them; the checkpoints go)."""
    keep = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    moved = {}
    for name in ("m.jsonl", "t.json"):
        moved[name] = shutil.move(os.path.join(ckpt_dir, name), keep)
    return {"bytes": {f: os.path.getsize(os.path.join(ckpt_dir, f))
                      for f in sorted(os.listdir(ckpt_dir))
                      if f.endswith(".npz")},
            "metrics": moved["m.jsonl"], "trace": moved["t.json"],
            "keep": keep}


def ckpt_phase_report(results, pod1, files, where, smi) -> dict:
    """12a's gates: resumed from step 4 under pod:2 (each rank) and in
    one process (pod:1), the run equals the uninterrupted pod:2 run bit
    for bit — the losses of steps 5-6, the eval loss and the sha256 of
    each final row of x, e and of c — and each run launched K1, K4 and K6
    as counted (the flush is plain); one gather a rank a checkpoint."""
    phase(f"12a. checkpoint across ranks: full-width {CKPT_ARCH} cut to "
          f"{CKPT_LAYERS} layers, parle n=2 --mesh pod:{POD_WORLD}, int8 "
          f"+ overlap, L=2, {CKPT_STEPS} steps, checkpoints every "
          f"{CKPT_EVERY}; resumed from step {CKPT_EVERY} under pod:2 and "
          "pod:1 (in phase 10's world; pod:1 beside the ranks)")
    check(pod1 is not None, "12a: the one-process resume did not run")
    ranks = [results[r]["ckpt"] for r in range(POD_WORLD)]
    full = [r["full"] for r in ranks]
    for rank, r in enumerate(ranks):
        for run in ("pod2",) + (("pod1",) if rank == 0 else ()):
            got = r[run] if run == "pod2" else pod1
            check(got["losses"] == full[0]["losses"][CKPT_EVERY:]
                  and got["eval_loss"] == full[0]["eval_loss"],
                  f"12a {run} rank {rank}: losses {got['losses']} / eval "
                  f"{got['eval_loss']} != the uninterrupted run's "
                  f"{full[0]['losses'][CKPT_EVERY:]} / "
                  f"{full[0]['eval_loss']}")
            want = (full[rank]["digests"] if run == "pod2" else {
                f: (sum((fr["digests"][f] for fr in full), [])
                    if f != "c" else full[0]["digests"][f])
                for f in CKPT_FIELDS})
            check(got["digests"] == want, f"12a {run} rank {rank}: final "
                  "rows differ from the uninterrupted run's")
            expected = {k: CKPT_LAUNCHES["resumed"].get(k, 0)
                        for k in COUNTERS}
            check(got["launches"] == expected, f"12a {run} rank {rank}: "
                  f"launches {got['launches']}, expected {expected}")
        expected = {k: CKPT_LAUNCHES["full"].get(k, 0) for k in COUNTERS}
        check(r["full"]["launches"] == expected, f"12a full rank {rank}: "
              f"launches {r['full']['launches']}, expected {expected}")
        check(r["full"]["losses"] == full[0]["losses"],
              f"12a: rank {rank}'s losses differ from rank 0's")
        check(len(r["full"]["gather_s"]) == CKPT_STEPS // CKPT_EVERY,
              f"12a rank {rank}: {len(r['full']['gather_s'])} gathers")
    out = {"where": where, "file_bytes": files["bytes"],
           "gather_s": [r["full"]["gather_s"] for r in ranks],
           "gather_bytes_per_rank": full[0]["gather_bytes"],
           "checkpoint_s": [r["full"]["checkpoint_s"] for r in ranks],
           # rank 0: the whole save less its gather (its own copies and
           # gloo calls): the write, digest and sidecar
           "write_s": [round(c - g, 3) for c, g in zip(
               full[0]["checkpoint_s"], full[0]["gather_s"])],
           "restore_s": {"pod2": [r["pod2"]["restore_s"] for r in ranks],
                         "pod1": pod1["restore_s"]},
           "run_wall_s": {**{k: [r[k]["wall_s"] for r in ranks]
                             for k in ("full", "pod2")},
                          "pod1": pod1["wall_s"]},
           "peak_memory_gib": {**{k: [r[k]["peak_memory_gib"]
                                      for r in ranks]
                                  for k in ("full", "pod2")},
                               "pod1": pod1["peak_memory_gib"]},
           "launches": {k: {n: v for n, v in run["launches"].items() if v}
                        for k, run in (("full", ranks[0]["full"]),
                                       ("pod2", ranks[0]["pod2"]),
                                       ("pod1", pod1))},
           "wall_s": [r["wall_s"] for r in ranks], "card": smi}
    print(json.dumps({"ckpt_across_ranks": out}), flush=True)
    print(f"12a: resumed under pod:2 and pod:1 == the uninterrupted run bit "
          f"for bit (losses of steps {CKPT_EVERY + 1}-{CKPT_STEPS}, eval, "
          "final x, e, c)", flush=True)
    out["obs"] = {k: files[k] for k in ("metrics", "trace", "keep")}
    return out


# 12b: full-width Qwen2.5-3B cut to 4 layers, n = 2, batch 1 x 2048
REMAT_LAYERS, REMAT_SEQ = 4, 2048
REMAT_MODES = (False, True, "dots")


def remat_phase(device, smi) -> dict:
    """12b: one Parle round (L = 2) from ``steps.make_algorithm_round(...,
    use_kernel=True, remat=r)`` through K1 / K2 for r in (False, True,
    "dots"), under deterministic algorithms, from the same params and
    batches: losses and the sha256 of each final x row equal bit for bit
    across the three; peak device memory and round wall of each."""
    phase(f"12b. remat: full-width qwen2.5-3b cut to {REMAT_LAYERS} "
          f"layers, parle n=2, batch 1 x {REMAT_SEQ}, one round L=2 "
          "through K1/K2, remat False / True / dots")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=REMAT_LAYERS)
    algo = registry.get("parle")
    pcfg = algo.canonicalize_cfg(ParleConfig(
        n_replicas=2, L=2, lr=0.1, lr_inner=0.1, batches_per_epoch=1))
    params = build_model(cfg).init(torch.Generator(device=device)
                                   .manual_seed(0))
    batches = make_round_batch_fn(TokenStream(
        cfg.vocab_size, REMAT_SEQ, 1, seed=0, device=str(device)),
        pcfg.L, 1, pcfg.n_replicas)(0)
    torch.use_deterministic_algorithms(True)
    runs = {}
    for r in REMAT_MODES:
        state = parle.dealias_state(algo.init(params, pcfg))
        rnd = steps.make_algorithm_round("parle", cfg, pcfg, remat=r,
                                         use_kernel=True)
        _release()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        t = time.perf_counter()
        state, m = rnd(state, batches)
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
        runs[str(r)] = {
            "losses": m["losses"].cpu().tolist(),
            "digests": row_digests(state.x),
            "round_wall_s": round(wall, 3),
            "peak_memory_gib": round(torch.cuda.max_memory_allocated(device)
                                     / 2 ** 30, 3),
            "launches": {k: v for k, v in launch_counts(
                parle_inner_update=pcfg.L, parle_sync_update=1).items()
                if v}}
        del state, m, rnd
    torch.use_deterministic_algorithms(False)
    del params, batches
    _release()
    base = runs["False"]
    for r, got in runs.items():
        check(got["losses"] == base["losses"]
              and got["digests"] == base["digests"],
              f"12b remat={r}: losses {got['losses']} / final x differ from "
              f"remat=False's {base['losses']}")
    out = {"runs": {r: {k: v for k, v in got.items() if k != "digests"}
                    for r, got in runs.items()},
           "phase_wall_s": round(time.perf_counter() - t0, 1), "card": smi}
    print(json.dumps({"remat": out}), flush=True)
    print("12b: remat True / dots == False bit for bit (losses, final x)",
          flush=True)
    return out


def stream_report_phase(device, obs_files, smi) -> dict:
    """12c: the token stream drawn on the card equals the same stream on
    the CPU bit for bit at the training cell's shapes (interleaved and
    split replica batches, a staged round; the CPU stream is held to the
    reference's in tests/test_torch_stream.py), and the port's telemetry
    report exits 0 on 12a's rank-0 metrics and trace."""
    phase("12c. the reference's token stream on the card == on the CPU; "
          "obs_report on 12a's artifacts")
    t0 = time.perf_counter()
    shapes = {"vocab": 151936, "seq": 256, "batch": 2, "n": 2, "L": 4}
    draws = 0
    for split in (False, True):
        on = [TokenStream(shapes["vocab"], shapes["seq"], shapes["batch"],
                          seed=0, device=dev) for dev in ("cpu", str(device))]
        pairs = [[replica_batches(st, s, shapes["batch"], shapes["n"],
                                  split=split) for st in on]
                 for s in (0, 1, 2 ** 20 + 3)]
        pairs.append([make_round_batch_fn(st, shapes["L"], shapes["batch"],
                                          shapes["n"], split=split)(8)
                      for st in on])
        for cpu, gpu in pairs:
            for k in cpu:
                check(gpu[k].device.type == "cuda"
                      and torch.equal(gpu[k].cpu(), cpu[k]),
                      f"12c: the stream's {k} on the card != on the CPU "
                      f"(split={split})")
                draws += cpu[k].numel()
    stream_s = time.perf_counter() - t0
    try:
        rc = obs_report.main(["--metrics", obs_files["metrics"],
                              "--trace", obs_files["trace"]])
    finally:
        shutil.rmtree(obs_files["keep"], ignore_errors=True)
    check(rc == 0, f"12c: obs_report exited {rc}")
    out = {"stream_tokens_compared": draws, "stream_bytes": 4 * draws,
           "stream_s": round(stream_s, 3),
           "obs_report_rc": rc,
           "phase_wall_s": round(time.perf_counter() - t0, 1), "card": smi}
    print(json.dumps({"stream_report": out}), flush=True)
    return out


# ------------------------------------------------------------------
# phase 13: axes inside a replica, four ranks on the one card
# ------------------------------------------------------------------

# 12a's model, full-width Mamba2-1.3B cut to 2 layers (257.6 M params,
# 1.03 GB of float32 a copy; full-width Qwen2.5-3B cut to 2 layers, 776.6
# M params, moves three times the bytes over loopback gloo, past the
# script's time limit with 13c and the launcher); Parle n = 2, L = 2,
# 4 steps of 2 x 256 through the kernels, over four gloo ranks: a rank
# holds half a replica's fields.  13a runs through the pod launcher
# (dist_run: step by step, its own one-process run the reference), 13b
# on the spawned ranks
SHARD_WORLD, SHARD_TIMEOUT_S = 4, 600
# job: (mesh, extra flags, K launches a rank)
SHARD_JOBS = {
    "13a": ("replica:2,model:2", [],
            dict(parle_inner_update=4, parle_sync_update=2)),
    "13b": ("replica:2,data:2", ["--sync-compress", "int8"],
            dict(parle_inner_update=2, quantize_ef=1,
                 parle_sync_dequant=1)),
}
# 13b's steps: one round, for the script's time limit
SHARD_13B_STEPS = 2
# 13b against the one-process int8 run: the data split sums each grad as
# two halves of the batch (the reference's composed-mesh loss bound)
SHARD_RTOL = 2e-5
# 13c: 12a's model (full-width Mamba2-1.3B cut to 2 layers, 1.03 GB of
# float32 a copy), Parle n = 2, L = 2, f32 through K1 / K2, split over
# "model" (each rank its SSD heads): saved at step 2 by four ranks under
# SHARD_CKPT_SAVE (its every leaf within DEPLOY_TOL of the one-process
# state at step 2), the file read back there (= the ranks' state bit for
# bit), resumed for 2 steps under SHARD_CKPT_RESUME (= the uninterrupted
# split run, 4 steps on the same ranks, bit for bit), under
# SHARD_CKPT_RESUME_DATA (a layout sharded over "data", no split) and in
# this process with no mesh (both within SHARD_RTOL of the uninterrupted
# runs).  Each 2-step run launches K1 2 / K2 1 (a rank)
SHARD_CKPT_SAVE = SHARD_CKPT_RESUME = "replica:2,model:2"
SHARD_CKPT_RESUME_DATA = "replica:2,data:2"
SHARD_CKPT_LAUNCHES = dict(parle_inner_update=2, parle_sync_update=1)
SHARD_CKPT_COPIES = 10              # the file: five (n, M) fields, n = 2
SHARD_CKPT_FIELDS = ("x", "y", "z", "v_y", "v_x")
# 13a before the split (Mamba2-1.3B at 2 layers, every model rank on the
# gathered row; PR 26's runs, NVIDIA H100 80GB HBM3, 700.00 W)
GATHERED_ROW_13A_PEAK_GIB = (4.9, 5.4)


# 13d / 13e: the Megatron split over "model" and the MoE on a "data"
# axis, on phase 13's ranks after 13c.  job: (arch, layers, mesh,
# replicas, steps, K launches a rank); L = 2 (1 for a one-step job,
# split_L), 2 x 256 tokens a replica, f32, deterministic algorithms
MEGATRON_JOBS = {
    "13d": ("qwen2.5-3b", 2, "replica:2,model:2", 2, 4,
            dict(parle_inner_update=4, parle_sync_update=2)),
    # one step (L = 1) since PR 29, for the script's time limit
    "13e": ("qwen2-moe-a2.7b", 1, "replica:1,data:2,model:2", 1, 1,
            dict(parle_inner_update=1, parle_sync_update=1)),
    # 13f: Zamba2-1.2B's SSM layers (its SSD heads) and its shared
    # attention block split over "model", one round
    "13f": ("zamba2-1.2b", 2, "replica:2,model:2", 2, 2,
            dict(parle_inner_update=2, parle_sync_update=1)),
}
# 13f's one-step cases of the vlm and audio families, through the
# Algorithm API (the train CLI draws no patch_embeds / cond; L = 1, so
# the step syncs): the same tuple as MEGATRON_JOBS
FAMILY_STEP_JOBS = {
    "13f-vlm": ("internvl2-1b", 2, "replica:2,model:2", 2, 1,
                dict(parle_inner_update=1, parle_sync_update=1)),
    "13f-audio": ("musicgen-large", 1, "replica:2,model:2", 2, 1,
                  dict(parle_inner_update=1, parle_sync_update=1)),
}
SPLIT_JOBS = {**MEGATRON_JOBS, **FAMILY_STEP_JOBS}
# a step under replica:2,model:2 before the split (Qwen2.5-3B at 2 layers,
# every model rank on the gathered row; NVIDIA H100 80GB HBM3, 700.00 W)
GATHERED_ROW_STEP_S = (5.42, 6.10)
# 13d / 13e's deployable (Parle's mean row) against one process's: the
# reference's composed-mesh bound on the deployable
DEPLOY_TOL = dict(rtol=2e-5, atol=2e-6)


def deploy_path(deploy_dir, job) -> str:
    """The raw float32 file of ``job``'s one-process deployable row."""
    return os.path.join(deploy_dir, f"{job}_deployable.f32")


def deployable_err(spec, n, state, path) -> tuple:
    """(max abs err, whether within DEPLOY_TOL) of this rank's blocks of
    the deployable under ``--mesh spec`` (``n`` replicas; the mean over
    the replica axis, one all-reduce on groups made anew) against the
    one-process row at ``path``, leaf by leaf (a block row's gaps left
    out)."""
    group = mesh_mod.groups_from_spec(spec, n)
    got = registry.get("parle").deployable_row(state, group)
    lay = state.layout
    ref = torch.from_numpy(np.memmap(path, np.float32, "c")).to(got.device)
    want = lay.blocks_of(ref, lay.index, torch.zeros_like(got))
    del ref
    err, ok = 0.0, True
    for o, size in zip(lay.offsets, lay.sizes):
        a, b = got[o:o + size], want[o:o + size]
        err = max(err, float((a - b).abs().max()))
        ok = ok and bool(torch.allclose(a, b, **DEPLOY_TOL))
    return err, ok


def leaves_against_file(state, path) -> dict:
    """Every leaf of ``state`` against the checkpoint at ``path``'s, on the
    leaf's device: whether the file holds the same keys, the max abs
    err, and whether every float32 leaf is within DEPLOY_TOL (any other
    leaf equal)."""
    members, leaves = ckpt._members(path), ckpt._flat_leaves(state)
    err, ok = 0.0, set(members) == set(leaves)
    for key, leaf in leaves.items():
        if key not in members:
            continue
        off, shape, dtype = members[key]
        got = np.memmap(path, dtype, "c", off, tuple(shape))
        if not (isinstance(leaf, torch.Tensor)
                and leaf.dtype == torch.float32):
            ok = ok and bool(np.array_equal(got, ckpt.to_numpy(leaf)))
            continue
        if leaf.numel() == 0:
            continue
        got = torch.from_numpy(got).to(leaf.device)
        err = max(err, float((got - leaf).abs().max()))
        ok = ok and bool(torch.allclose(got, leaf, **DEPLOY_TOL))
        del got
    return {"keys": len(leaves), "max_abs_err": err, "ok": ok}


def megatron_cfg(job):
    arch, layers = SPLIT_JOBS[job][:2]
    return dataclasses.replace(get_config(arch), num_layers=layers)


def split_L(job) -> int:
    """The job's L: 2, or 1 for a one-step job."""
    return min(SPLIT_JOBS[job][4], 2)


def family_batch(cfg, stream, step, n, rows, device) -> dict:
    """The token stream's replica batches with the conditioning the vlm
    and audio families read: each replica's ``patch_embeds`` / ``cond``
    drawn on the card from a generator seeded with the step, the same on
    every rank (``rows``: this rank's replicas)."""
    batch = replica_batches(stream, step, stream.batch_size, n, rows=rows)
    extra = {"vlm": ("patch_embeds", cfg.num_patches),
             "audio": ("cond", cfg.cond_len)}.get(cfg.family)
    if extra is not None:
        name, length = extra
        gen = torch.Generator(device=device).manual_seed(1000 + step)
        batch[name] = torch.randn((n, stream.batch_size, length,
                                   cfg.d_model), generator=gen,
                                  device=device)[rows]
    return batch


def family_step_run(device, job, group=None) -> tuple:
    """A FAMILY_STEP_JOBS job through the Algorithm API (``group``: this
    rank's ``MeshGroups``; None: all n replicas in this process), params
    from seed 0 on the card, 2 x 256 tokens a replica a step, through
    K1 / K2: (losses, step walls, final state, eval loss of the
    deployable, peak GiB, the group's counters by axis after the
    steps)."""
    _, _, _, n, steps, _ = SPLIT_JOBS[job]
    cfg = megatron_cfg(job)
    model = build_model(cfg)
    algo = registry.get("parle")
    pcfg = algo.canonicalize_cfg(ParleConfig(n_replicas=n, L=split_L(job),
                                             lr=0.1, lr_inner=0.1))
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    gen = torch.Generator(device=device).manual_seed(0)
    state = parle.dealias_state(algo.init(model.init(gen), pcfg, group))
    step = (algo.make_step(model.loss, pcfg, use_kernel=True)
            if group is None else
            algo.make_sharded_step(model.loss, pcfg, group, use_kernel=True))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=256,
                         batch_size=2, seed=0, device=str(device),
                         num_codebooks=cfg.num_codebooks
                         if cfg.family == "audio" else 0)
    rows = group.rows if group is not None else slice(None)
    losses, walls = [], []
    for i in range(steps):
        batch = family_batch(cfg, stream, i, n, rows, device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(device)
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    by_axis = (collective_counts_by_axis(group.obs.registry)
               if group is not None else {})
    held = {k: v[0] for k, v in family_batch(
        cfg, stream, 10_000_019, 1, slice(None), device).items()}
    eval_loss = float(parle.evaluate(
        model.loss, algo.deployable_row(state, group), state.layout, group,
        held))
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    check(all(np.isfinite(losses)) and np.isfinite(eval_loss),
          f"{job}: losses {losses}, eval {eval_loss}")
    return losses, walls, state, eval_loss, peak, by_axis


def _family_step_job(device, rank, job, deploy) -> dict:
    """:func:`family_step_run` on this rank's ``MeshGroups``: what
    :func:`_shard_job` returns for the train CLI's jobs."""
    _, _, spec, n, *_ = SPLIT_JOBS[job]
    obs = Obs(trace_out=os.devnull)
    group = mesh_mod.groups_from_spec(spec, n, obs)
    losses, walls, state, eval_loss, peak, by_axis = family_step_run(
        device, job, group)
    lay = state.layout
    out = {"losses": losses, "eval_loss": eval_loss, "round_wall_s": walls,
           "launches": {name: getattr(mod, attr)
                        for name, (mod, attr) in COUNTERS.items()},
           "coords": partition.mesh_coords(mesh_mod.parse_mesh_spec(spec),
                                           rank),
           "numel": lay.numel, "live": sum(lay.sizes),
           "full_numel": lay.full.numel,
           "by_axis": collective_counts_by_axis(obs.registry),
           "train_by_axis": {a: {op: list(v) for op, v in ops.items()}
                             for a, ops in by_axis.items()},
           "syncs": _sync_records(obs.tracer.events),
           "peak_memory_gib": round(peak, 3)}
    t0 = time.perf_counter()
    out["deploy_err"] = deployable_err(spec, n, state, deploy)
    out["deploy_check_s"] = round(time.perf_counter() - t0, 2)
    del state
    _release()
    return out


def megatron_argv(job, mesh=None) -> list:
    arch, _, _, n, steps, _ = MEGATRON_JOBS[job]
    return (["--arch", arch, "--device", "cuda", "--replicas", str(n),
             "--L", str(split_L(job)), "--steps", str(steps), "--batch",
             "2", "--seq",
             "256", "--round-fused", "--use-kernel", "--log-every", "2",
             "--seed", "0"] + (["--mesh", mesh] if mesh else []))


def shard_argv(steps=4, extra=()) -> list:
    """Phase 13's run of ``steps`` steps (13c's scoping epoch, steps //
    4, is 1 for 2 and 4 steps alike: a resume continues bit for bit)."""
    return ["--arch", CKPT_ARCH, "--device", "cuda", "--replicas", "2",
            "--L", "2", "--steps", str(steps), "--batch", "2", "--seq",
            "256", "--round-fused", "--use-kernel", "--log-every", "2",
            "--seed", "0", *extra]


def shard_ckpt_path(ckpt_dir) -> str:
    return os.path.join(ckpt_dir, "step000002.npz")


def shard_reference_phase(device, deploy_dir) -> dict:
    """13's one-process references, under deterministic algorithms: 13b's
    int8 barrier run (through the kernels) — its losses and eval loss;
    13c's uninterrupted 4-step run (f32, K1 / K2) — its losses and eval
    loss; 13d's, 13e's and 13f's runs — their losses, eval loss, and
    their deployable rows written under ``deploy_dir``."""
    phase(f"13. one-process references: full-width {CKPT_ARCH} cut to "
          f"{CKPT_LAYERS} layers, parle n=2 L=2, {SHARD_13B_STEPS} steps, "
          f"int8 (13b); f32, 4 steps (13c); full-width "
          f"qwen2.5-3b cut to "
          f"2 layers, n=2, 4 steps (13d), qwen2-moe-a2.7b cut to 1 "
          f"layer, n=1, 1 step (13e), zamba2-1.2b cut to 2 layers, n=2, 2 "
          f"steps, and one step of internvl2-1b (2 layers) and "
          f"musicgen-large (1 layer) (13f), f32")
    torch.use_deterministic_algorithms(True)
    spec, extra, want = SHARD_JOBS["13b"]
    losses, walls, state, eval_loss, peak = _train_measured(
        device, shard_argv(SHARD_13B_STEPS, extra), cfg=ckpt_cfg())
    launch_counts(**want)
    refs = {"13b": {"losses": losses.tolist(), "eval_loss": eval_loss,
                    "round_wall_s": walls, "peak_memory_gib": round(peak, 3)}}
    del state
    _release()
    t0 = time.perf_counter()
    full = _ckpt_job(device, shard_argv(4), Obs(), fields=("x",))
    launch_counts(**{k: 2 * v for k, v in SHARD_CKPT_LAUNCHES.items()})
    refs["13c"] = {"full": full,
                   "wall_s": round(time.perf_counter() - t0, 1)}
    for job, (*_, want) in SPLIT_JOBS.items():
        _release()
        if job in FAMILY_STEP_JOBS:
            losses, walls, state, eval_loss, peak, _ = family_step_run(
                device, job)
        else:
            losses, walls, state, eval_loss, peak = _train_measured(
                device, megatron_argv(job), cfg=megatron_cfg(job))
            losses = losses.tolist()
        launch_counts(**want)
        refs[job] = {"losses": losses, "eval_loss": eval_loss,
                     "round_wall_s": walls,
                     "peak_memory_gib": round(peak, 3)}
        t0 = time.perf_counter()
        parle.mean_row(state).cpu().numpy().tofile(deploy_path(deploy_dir,
                                                               job))
        refs[job]["deploy_write_s"] = round(time.perf_counter() - t0, 2)
        del state
    _release()
    torch.use_deterministic_algorithms(False)
    print(json.dumps({"shard_refs": {
        "13b": refs["13b"],
        "13c": {k: full[k] for k in ("losses", "eval_loss", "round_wall_s",
                                     "peak_memory_gib")},
        "13c_refs_wall_s": refs["13c"]["wall_s"],
        **{job: refs[job] for job in SPLIT_JOBS}}}), flush=True)
    return refs


def _shard_job(device, rank, spec, extra, argv=None, cfg=None,
               deploy=None) -> dict:
    """One job of a phase-13 rank: the train CLI's run() under ``--mesh
    spec`` (``argv``, ``cfg``: default phase 13's Mamba2 run with
    ``extra``); what the parent compares and prints, the counters by
    axis after the last round among it (``train_by_axis``), and with
    ``deploy`` (the one-process deployable's file, ``n`` replicas) the
    :func:`deployable_err` of the final state."""
    obs = Obs(trace_out=os.devnull)    # spans kept in memory, never saved
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    rounds = []
    losses, walls, state, eval_loss, _ = _train_once(
        device, argv or shard_argv(SHARD_13B_STEPS,
                                   [*extra, "--mesh", spec]),
        cfg=cfg or ckpt_cfg(), obs=obs, rounds=rounds)
    launches = {name: getattr(mod, attr)
                for name, (mod, attr) in COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated(device)
    lay = state.layout
    out = {"losses": losses.tolist(), "eval_loss": eval_loss,
           "round_wall_s": walls, "launches": launches,
           "coords": partition.mesh_coords(mesh_mod.parse_mesh_spec(spec),
                                           rank),
           "numel": lay.numel, "live": sum(lay.sizes),
           "full_numel": lay.full.numel,
           "by_axis": collective_counts_by_axis(obs.registry),
           "train_by_axis": {a: {op: list(v) for op, v in ops.items()}
                             for a, ops in rounds[-1].items()},
           "syncs": _sync_records(obs.tracer.events),
           "peak_memory_gib": round(peak / 2 ** 30, 3)}
    if deploy is not None:
        t0 = time.perf_counter()
        out["deploy_err"] = deployable_err(spec, deploy[1], state,
                                           deploy[0])
        out["deploy_check_s"] = round(time.perf_counter() - t0, 2)
    del state
    _release()
    return out


def digesting_restore(into: dict):
    """``ckpt.restore`` that also puts :func:`field_digests` of the rows it
    restored (SHARD_CKPT_FIELDS) in ``into``: a resume's state as read
    back, before its first step."""
    restore = ckpt.restore

    def wrapped(*args, **kwargs):
        state = restore(*args, **kwargs)
        into.update(field_digests(state, SHARD_CKPT_FIELDS))
        return state
    return wrapped


def shard_ckpt_rank_jobs(device, ckpt_dir) -> dict:
    """13c on one rank: 2 steps under SHARD_CKPT_SAVE, checkpointed at
    step 2 (every rank's blocks gathered, rank 0 writes the file), the
    rows of its state at step 2; that file read back under the same mesh
    (its rows, as the resume reads it), resumed for 2 steps under
    SHARD_CKPT_RESUME and under SHARD_CKPT_RESUME_DATA; and the
    uninterrupted 4-step run under SHARD_CKPT_SAVE."""
    out = {"save": _ckpt_job(device, shard_argv(2, [
        "--mesh", SHARD_CKPT_SAVE, "--checkpoint-dir", ckpt_dir,
        "--checkpoint-every", "2"]), Obs(trace_out=os.devnull),
        fields=SHARD_CKPT_FIELDS)}
    path = shard_ckpt_path(ckpt_dir)
    out["restored"] = {}
    with unittest.mock.patch.object(ckpt, "restore",
                                    digesting_restore(out["restored"])):
        out["resume"] = _ckpt_job(device, shard_argv(2, [
            "--mesh", SHARD_CKPT_RESUME, "--resume", path]),
            Obs(trace_out=os.devnull), fields=("x",))
    out["resume_data"] = _ckpt_job(device, shard_argv(2, [
        "--mesh", SHARD_CKPT_RESUME_DATA, "--resume", path]),
        Obs(trace_out=os.devnull), fields=())
    # done with the file: the parent may remove it (shard_ckpt_beside)
    open(os.path.join(ckpt_dir, f"read{dist.get_rank()}"), "w").close()
    out["uninterrupted"] = _ckpt_job(device, shard_argv(4, [
        "--mesh", SHARD_CKPT_SAVE]), Obs(trace_out=os.devnull),
        fields=("x",))
    return out


# 14e: one full-width Qwen1.5-MoE block split over the "model" pairs of
# phase 13's world (replica:2,model:2: ranks 0-1 and 2-3), a rank holding
# 30 of its 60 experts and half of its shared ff, on MOE_COLUMNS_TOKENS
MOE_COLUMNS_SPEC = "replica:2,model:2"
MOE_COLUMNS_TOKENS = (2, 256)


def moe_columns_rank_job(device, rank) -> dict:
    """14e on one rank of phase 13's world (reported in phase 14): the
    block (seed 0, the same on every rank) forward on N(0, 1) tokens
    (seed 1) through the expert-parallel dispatch, the rank's column of
    it summed over its "model" pair (``MeshGroups.model_sum_``), against
    its own flat forward of the whole block: in float32 (its counters by
    axis; its error printed), then in float64 (the routing stays float32,
    so both select the same slots), where the column split's summation
    order rounds below GROUPED_TOL (a split float32 contraction of 2816 +
    2816 shared-ff terms against one of 5632 rounds at ~1e-6 of O(1)
    outputs on the card: 3.1e-6 measured, beside 4.8e-7 on the CPU)."""
    t0 = time.perf_counter()
    cfg = get_config("qwen2-moe-a2.7b")
    axes = mesh_mod.parse_mesh_spec(MOE_COLUMNS_SPEC)
    mesh = partition.MeshGroups(axes, axes["replica"], rank)
    M, m = axes["model"], mesh.coords["model"]
    block = moe.init_moe_params(torch.Generator(device=device).manual_seed(0),
                                cfg)
    lo, hi = megatron.split(cfg.num_experts, M, m)
    flo, fhi = megatron.split(cfg.shared_expert_d_ff, M, m)
    B, T = MOE_COLUMNS_TOKENS
    x = torch.randn((B, T, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    ep_cfg = dataclasses.replace(cfg, moe_impl="shard_map")
    tp = megatron.TensorParallel(M, m, mesh)

    def forward(block, x):
        sp = block["shared"]
        own = {"router": block["router"],
               **{k: block[k][lo:hi] for k in ("w_gate", "w_up", "w_down")},
               "shared": {"w_gate": sp["w_gate"][:, flo:fhi],
                          "w_up": sp["w_up"][:, flo:fhi],
                          "w_down": sp["w_down"][flo:fhi]}}
        with torch.no_grad():
            flat, _ = moe.moe_forward(block, cfg, x)
            with megatron.tensor_parallel(tp):
                got, _ = moe.moe_forward(own, ep_cfg, x)
        torch.cuda.synchronize(device)
        return _max_err(got, flat), bool(torch.allclose(got, flat,
                                                         **GROUPED_TOL))

    def grads(block, x):
        """The grads of sum(y * w) / (B T) + aux (w N(0, 1), seed 2)
        through the flat forward and through the column sum: the
        largest difference of x's, the router's, and the rank's experts'
        and shared ff's; whether each is within GROUPED_TOL."""
        w = torch.randn(x.shape, device=device, dtype=x.dtype,
                        generator=torch.Generator(device=device)
                        .manual_seed(2)) / (B * T)
        # leaves sharing the block's storage: only the grads are new
        leaf = lambda t: t.detach().requires_grad_(True)  # noqa: E731
        full, xf = tree_map(leaf, block), leaf(x)
        y, aux = moe.moe_forward(full, cfg, xf)
        (torch.sum(y * w) + aux).backward()
        sp = full["shared"]
        own = {"router": leaf(block["router"]),
               **{k: leaf(block[k][lo:hi])
                  for k in ("w_gate", "w_up", "w_down")},
               "shared": {"w_gate": leaf(block["shared"]["w_gate"]
                                         [:, flo:fhi]),
                          "w_up": leaf(block["shared"]["w_up"][:, flo:fhi]),
                          "w_down": leaf(block["shared"]["w_down"]
                                         [flo:fhi])}}
        xo = leaf(x)
        with megatron.tensor_parallel(tp):
            y, aux = moe.moe_forward(own, ep_cfg, xo)
        (torch.sum(y * w) + aux).backward()
        pairs = [(xo.grad, xf.grad), (own["router"].grad,
                                      full["router"].grad)]
        pairs += [(own[k].grad, full[k].grad[lo:hi])
                  for k in ("w_gate", "w_up", "w_down")]
        pairs += [(own["shared"]["w_gate"].grad, sp["w_gate"].grad[:, flo:fhi]),
                  (own["shared"]["w_up"].grad, sp["w_up"].grad[:, flo:fhi]),
                  (own["shared"]["w_down"].grad, sp["w_down"].grad[flo:fhi])]
        torch.cuda.synchronize(device)
        return (max(_max_err(a, b) for a, b in pairs),
                all(bool(torch.allclose(a, b, **GROUPED_TOL))
                    for a, b in pairs))

    err32, close32 = forward(block, x)
    by_axis = {a: {op: list(v) for op, v in ops.items()} for a, ops in
               collective_counts_by_axis(mesh.obs.registry).items()}
    block = tree_map(lambda t: t.double(), block)
    err64, close64 = forward(block, x.double())
    gerr64, gclose64 = grads(block, x.double())
    out = {"rank": rank, "model": m, "experts": [lo, hi],
           "shared_ff": [flo, fhi], "max_abs_err_f32": err32,
           "allclose_f32": close32, "max_abs_err_f64": err64,
           "allclose_f64": close64, "grad_max_abs_err_f64": gerr64,
           "grads_allclose_f64": gclose64, "by_axis": by_axis,
           "wall_s": round(time.perf_counter() - t0, 2)}
    del block, x
    _release()
    return out


def shard_rank_main(rank, world, port, out_q, ckpt_dir, deploy_dir):
    """One rank of phase 13, a spawned process: join the gloo world of
    four, run 13b, 13c, 13d, 13e, 13f (held to the deployable rows under
    ``deploy_dir``) and 14e's jobs under deterministic algorithms, and
    put the results on ``out_q``."""
    import traceback
    # four ranks of ~16-19 GB each share the card
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        torch.use_deterministic_algorithms(True)
        pin_float32()
        device = resolve_device("cuda")
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        spec, extra, _ = SHARD_JOBS["13b"]
        res = {"13b": _shard_job(device, rank, spec, extra),
               "13c": shard_ckpt_rank_jobs(device, ckpt_dir)}
        # after 13c: by then 13a's launcher (beside) has left the card
        for job, (_, _, mesh, n, *_) in SPLIT_JOBS.items():
            if job in FAMILY_STEP_JOBS:
                res[job] = _family_step_job(device, rank, job,
                                            deploy_path(deploy_dir, job))
                continue
            res[job] = _shard_job(device, rank, mesh, (),
                                  argv=megatron_argv(job, mesh),
                                  cfg=megatron_cfg(job),
                                  deploy=(deploy_path(deploy_dir, job), n))
        res["14e"] = moe_columns_rank_job(device, rank)
        out_q.put((rank, res, None))
    except BaseException:            # reported to the parent, then raised
        out_q.put((rank, None, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def shard_ckpt_beside(device, ckpt_dir, procs) -> dict:
    """While the ranks resume 13c: once their file is complete (its
    sidecar is written last), under deterministic algorithms, the
    one-process 2-step run, its state at step 2 held to the file leaf by
    leaf (:func:`leaves_against_file`), then the file's one-process
    resume (no mesh, 2 steps).  None when a rank ends first (its failure
    is reported)."""
    path = shard_ckpt_path(ckpt_dir)
    if not _wait_for(path + ".json", procs):
        return None
    _release()
    torch.use_deterministic_algorithms(True)
    try:
        half = _ckpt_job(device, shard_argv(2), Obs(trace_out=os.devnull),
                         fields=(), against=path)
        one = _ckpt_job(device, shard_argv(2, ["--resume", path]),
                        Obs(trace_out=os.devnull), fields=("x",))
    finally:
        torch.use_deterministic_algorithms(False)
    nbytes = os.path.getsize(path)
    # once every rank has read it back: its 10.3 GB may sit in the host's
    # /dev/shm while they run 13d-13f
    if all(_wait_for(os.path.join(ckpt_dir, f"read{r}"), procs)
           for r in range(SHARD_WORLD)):
        os.remove(path)
    return {"bytes": nbytes, "half": half, "one": one}


def _kill_workers(port) -> None:
    """SIGKILL any pod worker whose command line names ``port`` (a
    launcher killed at its time limit leaves its workers, each in a
    session of its own)."""
    import signal
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if b"--_worker" in argv and str(port).encode() in argv:
            try:
                os.kill(int(pid), signal.SIGKILL)
            except OSError:
                pass


def start_shard_launcher() -> dict:
    """13a's pod launcher, started: ``python -m
    repro_torch.launch.dist_run --nproc 4 --mesh replica:2,model:2
    --device cuda --use-kernel`` at 13's cell, step by step, its output in
    temporary files (it runs beside the spawned ranks)."""
    spec, _, _ = SHARD_JOBS["13a"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_13a_")
    port = free_port()
    argv = ["--nproc", str(SHARD_WORLD), "--mesh", spec, "--device",
            "cuda", "--use-kernel", "--arch", CKPT_ARCH, "--replicas",
            "2", "--L", "2", "--steps", "4", "--batch", "2", "--seq",
            "256", "--seed", "0", "--metrics-out",
            os.path.join(tmp, "m.jsonl"), "--port", str(port),
            "--tol", str(SHARD_RTOL),
            "--_config", json.dumps(dataclasses.asdict(ckpt_cfg()))]
    logs = [open(os.path.join(tmp, f), "w+") for f in ("out", "err")]
    epoch0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dist_run", *argv],
        env=_pod_env(PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"),
        stdout=logs[0], stderr=logs[1], text=True)
    return {"proc": proc, "tmp": tmp, "port": port, "logs": logs,
            "epoch0": epoch0}


def finish_shard_launcher(run, smi) -> dict:
    """13a's gates, once its launcher (:func:`start_shard_launcher`)
    ends: its verdict (each of rank 0's 4 losses within SHARD_RTOL of
    its own one-process run's: each rank computes its SSD heads); from
    each worker's ``--metrics-out`` file, its
    kernel launches (K1 4 / K2 2), its bytes by axis (the replica axis: 2
    syncs of its blocks' bytes), its peak device memory and its
    timeline."""
    spec, _, want = SHARD_JOBS["13a"]
    phase(f"13a. the pod launcher over a composed mesh (beside the ranks): "
          f"dist_run --nproc {SHARD_WORLD} --mesh {spec} --device cuda "
          f"--use-kernel --tol {SHARD_RTOL}, full-width {CKPT_ARCH} cut "
          f"to {CKPT_LAYERS} layers split over 'model', parle n=2 L=2, 4 "
          "steps, f32 through K1/K2, against its own one-process run")
    proc, tmp, epoch0 = run["proc"], run["tmp"], run["epoch0"]
    m = os.path.join(tmp, "m.jsonl")
    try:
        try:
            proc.wait(timeout=SHARD_TIMEOUT_S)
        finally:
            if proc.poll() is None:  # timed out: no worker outlives it
                proc.kill()
                proc.wait()
                _kill_workers(run["port"])
        # the launcher's own wall: its verdict is its last write (it is
        # collected only after the ranks end)
        wall = os.path.getmtime(run["logs"][0].name) - epoch0
        stdout, stderr = [(f.seek(0), f.read())[1] for f in run["logs"]]
        check(proc.returncode == 0, f"13a: dist_run exited "
              f"{proc.returncode}:\n{stdout[-3000:]}\n{stderr[-3000:]}")
        verdict = json.loads(stdout.strip().splitlines()[-1])
        check(verdict["compared_steps"] == 4
              and verdict["max_rel_diff"] <= SHARD_RTOL,
              f"13a: dist_run {verdict}")
        axes = mesh_mod.parse_mesh_spec(spec)
        inner = mesh_mod.inner_axes(spec)
        params = planner.meta_params(build_model(ckpt_cfg()))
        ctx = planner.ShardContext(inner)
        coords = [dict(zip(inner, idx)) for idx in
                  np.ndindex(*inner.values())]
        expected = {k: want.get(k, 0) for k in pu.launch_counts()}
        ranks = []
        for i in range(SHARD_WORLD):
            evs = read_events(f"{m}.worker{i}")
            snap = [e for e in evs
                    if e["kind"] == "metrics_snapshot"][-1]["snapshot"]
            # the worker's timeline from the launcher's start: its first
            # record (joined, model and state made), each step, its end
            at = lambda e: round(e["ts"] - epoch0, 1)
            timeline = {"ready_s": at(evs[0]),
                        "step_s": [at(e) for e in evs
                                   if e["kind"] == "pod_step"],
                        "end_s": at(evs[-1])}
            gauges = {(g["name"], g["labels"].get("kernel")): g["value"]
                      for g in snap["gauges"]}
            launches = {k: gauges[("pod.kernel_launches", k)]
                        for k in expected}
            check(launches == expected, f"13a worker {i}: launches "
                  f"{launches}, expected {expected}")
            by_axis = {}
            for c in snap["counters"]:
                if c["name"] in ("pod.collectives", "pod.collective_bytes"):
                    lab = c["labels"]
                    by_axis.setdefault(lab["axis"], {}).setdefault(
                        lab["op"], [0, 0])[
                        c["name"] == "pod.collective_bytes"] += c["total"]
            c = partition.mesh_coords(axes, i)
            index = coords.index({a: c[a] for a in inner})
            live = sum(ShardedLayout(params, ctx, coords, index).sizes)
            got = by_axis.get("replica", {}).get("all_reduce")
            check(got == [2, 2 * 4 * live], f"13a worker {i}: replica "
                  f"all-reduces {got}, expected 2 syncs of {4 * live} B")
            peak = gauges[("pod.peak_device_memory_bytes", None)]
            ranks.append({"coords": c, "launches": launches,
                          "by_axis": by_axis, "live": live,
                          "peak_memory_gib": round(peak / 2 ** 30, 3),
                          "timeline": timeline})
            print(json.dumps({"shard_job": "13a", "rank": i, **ranks[-1],
                              "card": smi}), flush=True)
    finally:
        for f in run["logs"]:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"verdict": verdict, "wall_s": round(wall, 1),
           # after the pod: the launcher's own one-process run
           "reference_s": round(wall - max(r["timeline"]["end_s"]
                                           for r in ranks), 1),
           "launches_per_rank": {k: v for k, v in
                                 ranks[0]["launches"].items() if v},
           "peak_memory_gib": [r["peak_memory_gib"] for r in ranks],
           "by_axis": ranks[0]["by_axis"]}
    steps = [np.diff(r["timeline"]["step_s"]).tolist() for r in ranks]
    out["step_wall_s"] = steps
    print(f"13a: dist_run --nproc {SHARD_WORLD} --mesh {spec}: "
          f"{json.dumps(verdict)}; launches a rank "
          f"{out['launches_per_rank']}; launcher wall {out['wall_s']} s "
          f"(its one-process run {out['reference_s']} s); peak "
          f"{max(out['peak_memory_gib'])} GiB a rank (on the gathered row, "
          f"PR 26: {GATHERED_ROW_13A_PEAK_GIB[0]}-"
          f"{GATHERED_ROW_13A_PEAK_GIB[1]}); steps 2-4 a rank "
          f"{steps} s ({smi})", flush=True)
    return out


def _seconds_by_axis(syncs) -> dict:
    out = {}
    for s in syncs:
        a = out.setdefault(s["axis"], {"d2h_s": 0.0, "collective_s": 0.0,
                                       "h2d_s": 0.0, "calls": 0})
        a["calls"] += 1
        for k in ("d2h", "collective", "h2d"):
            a[f"{k}_s"] = round(a[f"{k}_s"] + s[f"{k}_ms"] / 1e3, 3)
    return out


def shard_13b_report(results, ref, smi) -> dict:
    """13b's gates: each rank's losses within SHARD_RTOL of the
    one-process int8 run, K1 / K4 / K5 launched as counted, the replica
    axis moving a shard's int8 payload and its scales a sync."""
    spec, _, want = SHARD_JOBS["13b"]
    expected = {k: want.get(k, 0) for k in COUNTERS}
    errs = []
    for rank in range(SHARD_WORLD):
        r = results[rank]["13b"]
        check(r["launches"] == expected, f"13b rank {rank}: "
              f"launches {r['launches']}, expected {expected}")
        err = max(abs(a / b - 1) for a, b in zip(r["losses"], ref["losses"]))
        errs.append(err)
        check(err <= SHARD_RTOL, f"13b rank {rank}: losses {r['losses']} "
              f"vs one process's {ref['losses']}: max rel err {err:.3e} > "
              f"{SHARD_RTOL}")
        want_bytes = r["numel"] + r["numel"] // 256
        syncs = [s for s in r["syncs"] if s["axis"] == "replica"
                 and s["bytes"] > 64 and s["op"] == "all_gather"]
        rounds = SHARD_13B_STEPS // 2
        check(len(syncs) >= rounds and all(s["bytes"] == want_bytes
                                          for s in syncs[:rounds]),
              f"13b rank {rank}: replica-axis syncs "
              f"{[s['bytes'] for s in syncs]}, expected {want_bytes}")
        print(json.dumps({
            "shard_job": "13b", "rank": rank, "coords": r["coords"],
            "round_wall_s": r["round_wall_s"],
            "step_wall_s": [w / 2 for w in r["round_wall_s"]],
            "collective_bytes_by_axis": r["by_axis"],
            "seconds_by_axis": _seconds_by_axis(r["syncs"]),
            "shard_numel": r["numel"], "full_numel": r["full_numel"],
            "peak_memory_gib": r["peak_memory_gib"], "card": smi}),
            flush=True)
    r0 = results[0]["13b"]
    out = {"launches_per_rank": {k: v for k, v in r0["launches"].items()
                                 if v},
           "round_wall_s": [results[r]["13b"]["round_wall_s"]
                            for r in range(SHARD_WORLD)],
           "peak_memory_gib": [results[r]["13b"]["peak_memory_gib"]
                               for r in range(SHARD_WORLD)],
           "by_axis": r0["by_axis"],
           "seconds_by_axis": _seconds_by_axis(r0["syncs"]),
           "max_rel_loss_err": max(errs)}
    print(f"shard 13b ({spec}): every rank within {max(errs):.3e} of one "
          f"process's losses; launches a rank {out['launches_per_rank']}",
          flush=True)
    return out


def shard_megatron_report(results, refs, smi) -> dict:
    """13d / 13e / 13f's gates: each rank's losses and eval loss (the split
    ``parle.evaluate`` of the deployable) within SHARD_RTOL of the
    one-process run, its blocks of the deployable within DEPLOY_TOL of
    the one-process row, K1 / K2 launched as counted; each rank's bytes
    by axis and op over its training rounds, step wall and peak memory
    printed, 13d's step beside the gathered row's."""
    out = {}
    for job, (arch, layers, mesh, n, steps, want) in SPLIT_JOBS.items():
        expected = {k: want.get(k, 0) for k in COUNTERS}
        ref, errs = refs[job], []
        L = split_L(job)                    # steps a timed wall
        for rank in range(SHARD_WORLD):
            r = results[rank][job]
            check(r["launches"] == expected, f"{job} rank {rank}: "
                  f"launches {r['launches']}, expected {expected}")
            err = max(abs(a / b - 1)
                      for a, b in zip(r["losses"], ref["losses"]))
            errs.append(err)
            check(len(r["losses"]) == steps and err <= SHARD_RTOL,
                  f"{job} rank {rank}: losses {r['losses']} vs one "
                  f"process's {ref['losses']}: max rel err {err:.3e} > "
                  f"{SHARD_RTOL}")
            eval_err = abs(r["eval_loss"] / ref["eval_loss"] - 1)
            check(eval_err <= SHARD_RTOL, f"{job} rank {rank}: eval loss "
                  f"{r['eval_loss']} vs one process's {ref['eval_loss']}: "
                  f"rel err {eval_err:.3e} > {SHARD_RTOL}")
            dep_err, dep_ok = r["deploy_err"]
            check(dep_ok, f"{job} rank {rank}: its blocks of the "
                  f"deployable off one process's by {dep_err:.3e}, beyond "
                  f"{DEPLOY_TOL}")
            print(json.dumps({
                "shard_job": job, "rank": rank, "coords": r["coords"],
                "losses": r["losses"], "eval_loss": r["eval_loss"],
                "eval_rel_err": eval_err, "deployable_max_abs_err": dep_err,
                "deploy_check_s": r["deploy_check_s"],
                "round_wall_s": r["round_wall_s"],
                "step_wall_s": [w / L for w in r["round_wall_s"]],
                "collective_bytes_by_axis": r["train_by_axis"],
                "seconds_by_axis": _seconds_by_axis(r["syncs"]),
                "shard_numel": r["numel"], "full_numel": r["full_numel"],
                "peak_memory_gib": r["peak_memory_gib"], "card": smi}),
                flush=True)
        r0 = results[0][job]
        out[job] = {
            "mesh": mesh, "losses": r0["losses"], "ref_losses": ref["losses"],
            "max_rel_loss_err": max(errs),
            "eval_loss": [results[r][job]["eval_loss"]
                          for r in range(SHARD_WORLD)],
            "ref_eval_loss": ref["eval_loss"],
            "deployable_max_abs_err": max(
                results[r][job]["deploy_err"][0] for r in range(SHARD_WORLD)),
            "step_wall_s": [[w / L for w in results[r][job]["round_wall_s"]]
                            for r in range(SHARD_WORLD)],
            "ref_step_wall_s": [w / L for w in ref["round_wall_s"]],
            "peak_memory_gib": [results[r][job]["peak_memory_gib"]
                                for r in range(SHARD_WORLD)],
            "ref_peak_memory_gib": ref["peak_memory_gib"],
            "train_by_axis": r0["train_by_axis"],
            "seconds_by_axis": _seconds_by_axis(r0["syncs"])}
        steady = min(w for ws in out[job]["step_wall_s"] for w in ws)
        print(f"shard {job} ({arch} at {layers} layers, {mesh}): every rank "
              f"within {max(errs):.3e} of one process's losses; steady "
              f"step {steady:.3f} s (one process "
              f"{min(out[job]['ref_step_wall_s']):.3f} s"
              + (f"; on the gathered row {GATHERED_ROW_STEP_S[0]}-"
                 f"{GATHERED_ROW_STEP_S[1]} s" if job == "13d" else "")
              + f"); peak {max(out[job]['peak_memory_gib'])} GiB a rank",
              flush=True)
    return out


def _resume_err(run, losses, eval_loss) -> float:
    """The max rel err of a 2-step resume's losses and eval loss against
    an uninterrupted run's steps 3-4 and eval loss."""
    return max([abs(a / b - 1) for a, b in zip(run["losses"], losses[2:])]
               + [abs(run["eval_loss"] / eval_loss - 1)])


def shard_13c_report(results, beside, ref, where, smi) -> dict:
    """13c's gates, the replica split over "model" (so held to one process
    within the reference's composed-mesh bounds, and to the split run
    itself bit for bit): the file the four ranks wrote under
    SHARD_CKPT_SAVE holds every leaf of the one-process state at step 2
    within DEPLOY_TOL (that run's losses the uninterrupted one-process
    run's first two); read back there, it holds each rank's rows of its
    state at step 2 bit for bit (sha256 of every row of
    SHARD_CKPT_FIELDS); resumed there it continues the uninterrupted
    split run bit for bit (losses of steps 3-4, eval loss, sha256 of each
    final x row), whose first two losses are the save run's; the split
    run's losses within SHARD_RTOL of one process's; resumed under
    SHARD_CKPT_RESUME_DATA its losses and eval loss within SHARD_RTOL of
    the uninterrupted split and one-process runs'; resumed in this
    process (no mesh) within SHARD_RTOL of the uninterrupted one-process
    run's; each 2-step run launched K1 2 / K2 1 (a rank); each rank made
    one in-replica gather, and the replica's first rank one replica-axis
    gather."""
    phase(f"13c. checkpoint under a composed mesh: full-width {CKPT_ARCH} "
          f"cut to {CKPT_LAYERS} layers, parle n=2 L=2 f32 through K1/K2, "
          f"split over 'model', saved at step 2 by four ranks under "
          f"{SHARD_CKPT_SAVE} and held to the one-process state, read back "
          f"and resumed there against the uninterrupted split run, resumed "
          f"under {SHARD_CKPT_RESUME_DATA} and in one process")
    check(beside is not None, "13c: the one-process resume did not run")
    full = ref["full"]
    half, one = beside["half"], beside["one"]
    expected = {k: SHARD_CKPT_LAUNCHES.get(k, 0) for k in COUNTERS}
    held = half["against_file"]
    check(half["losses"] == full["losses"][:2]
          and half["launches"] == expected,
          f"13c one-process 2-step run: losses {half['losses']} != the "
          f"4-step run's first two {full['losses'][:2]}, or launches "
          f"{half['launches']} != {expected}")
    check(held["ok"], f"13c: the four ranks' file against the one-process "
          f"state at step 2: {held} (DEPLOY_TOL {DEPLOY_TOL})")
    one_err = _resume_err(one, full["losses"], full["eval_loss"])
    check(len(one["losses"]) == 2 and one_err <= SHARD_RTOL,
          f"13c one-process resume: losses {one['losses']} / eval "
          f"{one['eval_loss']} vs the uninterrupted run's "
          f"{full['losses'][2:]} / {full['eval_loss']}: max rel err "
          f"{one_err:.3e} > {SHARD_RTOL}")
    check(one["launches"] == expected, f"13c one-process resume: launches "
          f"{one['launches']}, expected {expected}")
    errs, data_errs, axes = [], [], mesh_mod.parse_mesh_spec(SHARD_CKPT_SAVE)
    inner = ",".join(mesh_mod.inner_axes(SHARD_CKPT_SAVE))
    for rank in range(SHARD_WORLD):
        save, res, data, unint = (
            results[rank]["13c"][k] for k in
            ("save", "resume", "resume_data", "uninterrupted"))
        for name, run in (("save", save), ("resume", res),
                          (SHARD_CKPT_RESUME_DATA, data)):
            check(run["launches"] == expected, f"13c {name} rank {rank}: "
                  f"launches {run['launches']}, expected {expected}")
        err = max(_resume_err(data, unint["losses"], unint["eval_loss"]),
                  _resume_err(data, full["losses"], full["eval_loss"]))
        data_errs.append(err)
        check(len(data["losses"]) == 2 and err <= SHARD_RTOL,
              f"13c {SHARD_CKPT_RESUME_DATA} resume rank {rank}: losses "
              f"{data['losses']} / eval {data['eval_loss']} vs the "
              f"uninterrupted split run's {unint['losses'][2:]} / "
              f"{unint['eval_loss']} and one process's "
              f"{full['losses'][2:]} / {full['eval_loss']}: max rel err "
              f"{err:.3e} > {SHARD_RTOL}")
        check(results[rank]["13c"]["restored"] == save["digests"],
              f"13c rank {rank}: the file read back under "
              f"{SHARD_CKPT_SAVE} differs from the rank's state at step 2: "
              + str(sorted(f for f in SHARD_CKPT_FIELDS
                           if results[rank]["13c"]["restored"][f]
                           != save["digests"][f])))
        check(save["losses"] == unint["losses"][:2]
              and res["losses"] == unint["losses"][2:]
              and res["eval_loss"] == unint["eval_loss"]
              and res["digests"]["x"] == unint["digests"]["x"],
              f"13c rank {rank}: save {save['losses']} + resume "
              f"{res['losses']} / eval {res['eval_loss']} != the "
              f"uninterrupted split run's {unint['losses']} / "
              f"{unint['eval_loss']} (or its final x)")
        err = max(abs(a / b - 1)
                  for a, b in zip(unint["losses"], full["losses"]))
        errs.append(err)
        check(err <= SHARD_RTOL, f"13c rank {rank}: the split run's losses "
              f"{unint['losses']} vs one process's {full['losses']}: max "
              f"rel err {err:.3e} > {SHARD_RTOL}")
        first = all(v == 0 for a, v in partition.mesh_coords(
            axes, rank).items() if a != "replica")
        got = sorted(g["axis"] for g in save["gathers"])
        check(got == sorted([inner] + (["replica"] if first else [])),
              f"13c save rank {rank}: gathers over {got}")
    by_rank = lambda run, key: [results[r]["13c"][run][key]
                                for r in range(SHARD_WORLD)]
    save0 = results[0]["13c"]["save"]
    gather_s = {g["axis"]: g["gather_s"] for g in save0["gathers"]}
    out = {"where": where, "file_bytes": beside["bytes"],
           "save_s": {"checkpoint_s": save0["checkpoint_s"],
                      "in_replica_gather_s": gather_s[inner],
                      "replica_gather_s": gather_s["replica"],
                      "write_s": save0["write_s"]},
           "gathers_by_rank": by_rank("save", "gathers"),
           "checkpoint_s_by_rank": by_rank("save", "checkpoint_s"),
           "restore_s": {SHARD_CKPT_RESUME: by_rank("resume", "restore_s"),
                         SHARD_CKPT_RESUME_DATA: by_rank("resume_data",
                                                         "restore_s"),
                         "one_process": one["restore_s"]},
           "file_vs_one_process": held,
           "max_rel_loss_err": max(errs), "one_process_rel_err": one_err,
           "resume_data_rel_err": max(data_errs),
           "peak_memory_gib": {"save": by_rank("save", "peak_memory_gib"),
                               "resume": by_rank("resume",
                                                 "peak_memory_gib"),
                               "resume_data": by_rank("resume_data",
                                                      "peak_memory_gib"),
                               "one_process": one["peak_memory_gib"]},
           "round_wall_s": {"save": by_rank("save", "round_wall_s"),
                            "resume": by_rank("resume", "round_wall_s"),
                            "resume_data": by_rank("resume_data",
                                                   "round_wall_s"),
                            "uninterrupted": by_rank("uninterrupted",
                                                     "round_wall_s")},
           "run_wall_s": {"save": by_rank("save", "wall_s"),
                          "resume": by_rank("resume", "wall_s"),
                          "resume_data": by_rank("resume_data", "wall_s"),
                          "uninterrupted": by_rank("uninterrupted",
                                                   "wall_s"),
                          "one_process_2_steps": half["wall_s"],
                          "one_process": one["wall_s"]},
           "launches_per_rank": {k: v for k, v in
                                 save0["launches"].items() if v},
           "card": smi}
    print(json.dumps({"ckpt_composed_mesh": out}), flush=True)
    print(f"13c: the {SHARD_CKPT_SAVE} file within {held['max_abs_err']:.3e} "
          f"(abs) of the one-process state at step 2, read back = each "
          f"rank's state at step 2 (sha256 of its rows); resumed there = the "
          f"uninterrupted split run bit for bit; the split run within "
          f"{max(errs):.3e} of one process, the {SHARD_CKPT_RESUME_DATA} "
          f"resume within {max(data_errs):.3e}, the one-process resume "
          f"within {one_err:.3e}", flush=True)
    return out


def shard_phase(device, smi) -> dict:
    """Phase 13: Parle with axes inside a replica over four gloo ranks on
    the one card (each rank a spawned process holding half of one
    replica's state as the sharding planner assigns it; its replica's
    weights gathered for the forward, its grads reduce-scattered, every
    collective staged through pinned host memory), all on full-width
    Mamba2-1.3B cut to 2 layers.  13b (replica:2, data:2, int8, K1 / K4
    / K5): the losses within SHARD_RTOL of the one-process int8 run; the
    replica axis moves a shard's int8 payload plus its scales a sync.
    13c, on the same ranks after 13b: a checkpoint written under
    replica:2,model:2 (the replica split over "model"), held to the
    one-process state, read back and resumed there, resumed under
    replica:2,data:2 and, beside the ranks, in this process
    (:func:`shard_13c_report`).  Then the Megatron split of every
    family: 13d (dense), 13e (moe on a data axis), 13f (hybrid, vlm,
    audio; :func:`shard_megatron_report`).  Beside the ranks, 13a
    (replica:2,model:2, f32, K1 / K2) through the pod launcher
    (:func:`start_shard_launcher`: its workers' start and its own
    one-process run hide under the ranks' work).  Times: four ranks
    time-slicing one card over loopback gloo, not a multi-card figure."""
    t0 = time.perf_counter()
    _release()
    # 13d-13f's one-process deployables (1.2-3.4 GB each), on disk
    deploy_dir = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        return _shard_phase(device, smi, t0, deploy_dir)
    finally:
        shutil.rmtree(deploy_dir, ignore_errors=True)


def _shard_phase(device, smi, t0, deploy_dir) -> dict:
    refs = shard_reference_phase(device, deploy_dir)
    phase(f"13. axes inside a replica: four gloo ranks on the one card, "
          f"13b {SHARD_JOBS['13b'][0]} int8 through K1/K4/K5, then 13c's "
          f"checkpoint under {SHARD_CKPT_SAVE} read back and resumed "
          f"there, under {SHARD_CKPT_RESUME_DATA} and (beside) in one "
          f"process, then the Megatron split: "
          f"13d {MEGATRON_JOBS['13d'][2]}, 13e {MEGATRON_JOBS['13e'][2]} "
          f"and 13f {MEGATRON_JOBS['13f'][2]} (zamba2, internvl2, "
          f"musicgen) through K1/K2; 13a's pod launcher beside them")
    free = torch.cuda.mem_get_info(device)[0]
    print(f"shard: free device memory before the ranks "
          f"{free / 2 ** 30:.3f} GiB", flush=True)
    ckpt_dir, where = ckpt_directory(SHARD_CKPT_COPIES)
    t_ranks = time.perf_counter()
    launcher = start_shard_launcher()
    try:
        results, beside = _run_ranks(
            shard_rank_main, SHARD_WORLD, SHARD_TIMEOUT_S, ckpt_dir,
            deploy_dir,
            beside=lambda procs: shard_ckpt_beside(device, ckpt_dir, procs))
    except BaseException:               # a rank failed: no pod outlives it
        launcher["proc"].kill()
        _kill_workers(launcher["port"])
        raise
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ranks_s = time.perf_counter() - t_ranks
    out = {"13b": shard_13b_report(results, refs["13b"], smi),
           "13c": shard_13c_report(results, beside, refs["13c"], where,
                                   smi),
           "13a": finish_shard_launcher(launcher, smi)}
    out.update(shard_megatron_report(results, refs, smi))
    out["14e"] = [results[r]["14e"] for r in range(SHARD_WORLD)]
    out["ranks_wall_s"] = round(ranks_s, 1)
    out["phase_wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"shard_phase_wall_s": out["phase_wall_s"],
                      "ranks_wall_s": out["ranks_wall_s"],
                      "launcher_wall_s": out["13a"]["wall_s"],
                      "note": "four ranks time-slicing one card over "
                              "loopback gloo, not a multi-card figure",
                      "card": smi}), flush=True)
    return out


# ------------------------------------------------------------------
# phase 14: the dry run against the card
# ------------------------------------------------------------------

# 14a: phase 6's cell as the dry run's shape (n = 2 in one process, a
# replica's batch 2 x 256, f32, the train CLI's remat=False)
DRY_TRAIN = dict(kind="train", seq_len=256, global_batch=4)
DRY_L = 4
# 14c: the dry-run CLI at full size
DRYRUN_CLI = (
    ["--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh", "both"],
    ["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k", "--moe-impl",
     "shard_map"],
    ["--arch", "qwen2-moe-a2.7b", "--shape", "prefill_32k", "--moe-groups",
     "16"])


def _dry_records(cfg, mesh, shape, **kw) -> dict:
    """{tag: record} of the dry run's programs, the train CLI's remat
    (False) set while they run."""
    remat = dryrun.OPTIONS["remat"]
    dryrun.OPTIONS["remat"] = False
    try:
        return {p.tag: dryrun.analyze_one(p, 1) for p in
                dryrun.build_programs(cfg, mesh, shape, **kw)}
    finally:
        dryrun.OPTIONS["remat"] = remat


def _by_axis(times) -> dict:
    """{axis: {op: [calls, bytes]}} of ``times`` [(record, repeats)]."""
    out: dict = {}
    for rec, k in times:
        c = rec["collectives"]
        for key in c["bytes"]:
            axis, op = key.split("/")
            cur = out.setdefault(axis, {}).setdefault(op, [0, 0])
            cur[0] += k * c["counts"][key]
            cur[1] += k * c["bytes"][key]
    return out


def dryrun_train_check(trained, smi) -> dict:
    """14a: the dry run at phase 6's cell (Qwen2.5-3B, 4 layers, n = 2,
    2 x 256 a replica, f32) against phase 6: a round of L train_inner and
    one parle_sync = the FLOPs ``FlopCounterMode`` counted over the plain
    run's first round on the card, as integers; the arguments = the
    card's state plus one step's batch, in bytes; arguments + temp
    beside the kernel run's peak (printed, not a gate)."""
    held = trained["dryrun"]
    recs = _dry_records(train_cfg(), {}, DRY_TRAIN, n_replicas=2,
                        precision="f32")
    inner, sync = recs["train_inner"], recs["parle_sync"]
    step = inner["flops_per_device"]
    predicted = DRY_L * step + sync["flops_per_device"]
    check(predicted == held["round0"],
          f"14a: predicted round FLOPs {predicted} ({DRY_L} x {step} + "
          f"{sync['flops_per_device']}) != counted on the card "
          f"{held['round0']}")
    args = inner["memory"]["argument_size_bytes"]
    card = held["state_bytes"] + held["batch_bytes"]
    check(args == card, f"14a: predicted argument bytes {args} != the "
          f"card's state {held['state_bytes']} + batch "
          f"{held['batch_bytes']}")
    peak = args + inner["memory"]["temp_size_bytes"]
    out = {"flops_per_step": step, "round_flops": held["round0"],
           "argument_bytes": args, "predicted_peak_bytes": peak,
           "card_peak_bytes": held["peak_bytes"],
           "peak_rel_err": (peak - held["peak_bytes"]) / held["peak_bytes"],
           "bytes_accessed_per_step": inner["bytes_accessed_per_device"],
           "roofline": inner["roofline"], "trace_s": inner["trace_s"]}
    print(f"14a: FLOPs a step {step} (round {held['round0']} counted on the "
          f"card = {DRY_L} x {step}); arguments {args} B = the card's state "
          f"+ batch; predicted peak (arguments + temp) {peak} B beside the "
          f"card's {held['peak_bytes']} B ({out['peak_rel_err']:+.4f})",
          flush=True)
    print(json.dumps({"14a": out, "card": smi}), flush=True)
    return out


def dryrun_mesh_check(shard, smi) -> dict:
    """14b: the dry run at 13a's mesh (replica:2,model:2, Mamba2-1.3B at 2
    layers split over "model", f32): 4 train_inner and 2 parle_sync =
    13a's counters by axis and op (rank 0's, read from its metrics); the
    "model" gathers are the split's activations (no leaf), their grads
    reduce-scattered, the blocks the sync all-reduce's bytes.
    At 13d's mesh (Qwen2.5-3B at 2 layers split over "model"), the
    same programs = 13d's "model" collectives and sync all-reduces."""
    spec = SHARD_JOBS["13a"][0]
    recs = _dry_records(ckpt_cfg(), spec, DRY_TRAIN, precision="f32")
    predicted = _by_axis([(recs["train_inner"], 4), (recs["parle_sync"], 2)])
    got = shard["13a"]["by_axis"]
    check(predicted == got, f"14b: predicted collectives {predicted} != "
          f"13a's {got}")
    layout = ShardedLayout(
        planner.meta_params(build_model(ckpt_cfg())),
        planner.ShardContext(mesh_mod.inner_axes(spec)),
        [{"model": m} for m in range(2)], 0)
    # "model" gathers activations, no leaf: a step gathers the rank's half
    # of the embedding of its 2 x 256 tokens and, in each layer, of the
    # packed projection's and the conv's outputs
    cfg = ckpt_cfg()
    di, N, nh = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_num_heads
    per_token = cfg.d_model + cfg.num_layers * (3 * di + 4 * N + nh)
    tokens = DRY_TRAIN["global_batch"] // 2 * DRY_TRAIN["seq_len"]
    calls, nbytes = got["model"]["all_gather"]
    check(calls == 4 * (1 + 2 * cfg.num_layers)
          and nbytes == 4 * tokens * per_token // 2 * 4,
          f"14b: 13a's 'model' gathers {calls} / {nbytes} B, expected "
          f"{4 * (1 + 2 * cfg.num_layers)} / "
          f"{4 * tokens * per_token // 2 * 4} B of activations")
    # the backward reduce-scatters the grads of a layer's two gathered
    # outputs (counted at the rank's whole input: both at full width)
    calls, nbytes = got["model"]["reduce_scatter"]
    wide = cfg.num_layers * (3 * di + 4 * N + nh)
    check(calls == 4 * 2 * cfg.num_layers
          and nbytes == 4 * tokens * wide * 4,
          f"14b: 13a's 'model' reduce-scatters {calls} / {nbytes} B, "
          f"expected {4 * 2 * cfg.num_layers} / {4 * tokens * wide * 4} B")
    live = sum(layout.sizes)
    calls, nbytes = got["replica"]["all_reduce"]
    check(live * 4 * calls == nbytes, f"14b: predicted blocks {live} x 4 B "
          f"x {calls} != 13a's all-reduces {nbytes} B")
    # 13d: the split's collectives, rank 0's over its training rounds
    # (the round-fused CLI gathers its losses once a round, the dry run's
    # train_inner once a step: the replica axis is held by its sync)
    spec = MEGATRON_JOBS["13d"][2]
    recs = _dry_records(megatron_cfg("13d"), spec, DRY_TRAIN,
                        precision="f32")
    split = _by_axis([(recs["train_inner"], 4), (recs["parle_sync"], 2)])
    got = shard["13d"]["train_by_axis"]
    check(split["model"] == got["model"]
          and split["replica"]["all_reduce"] == got["replica"]["all_reduce"],
          f"14b: predicted at 13d's mesh {split} != 13d's {got}")
    out = {"by_axis": predicted, "shard_numel": layout.numel,
           "block_elements": live, "13d_by_axis": split}
    print(f"14b: predicted = 13a's counters by axis and op {predicted}; a "
          f"rank's row (K1's) {layout.numel} elements, {live} of them its "
          f"blocks; 'model' gathers activations only; at 13d's mesh the "
          f"predicted 'model' collectives "
          f"{split['model']} and the sync's = 13d's", flush=True)
    print(json.dumps({"14b": out, "card": smi}), flush=True)
    return out


def dryrun_cli_phase(device, smi) -> dict:
    """14c: the dry run's CLI at full size (DRYRUN_CLI), each record's
    roofline line printed; the card's allocator counts no allocation and
    no port kernel launches while it runs.  The shard_map decode's
    collectives: one all-reduce over "model" a MoE layer of the rank's
    rows' bf16 activations."""
    gc.collect()
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_stats(device)
    reset_launches()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for argv in DRYRUN_CLI:
            t0 = time.perf_counter()
            dryrun.main(argv + ["--out", tmp])
            out[" ".join(argv)] = round(time.perf_counter() - t0, 1)
        recs = {}
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name)) as f:
                recs[name[:-len(".json")]] = json.load(f)
    launch_counts()
    torch.cuda.synchronize(device)
    after = torch.cuda.memory_stats(device)
    # cumulative counts: a free of an earlier phase's tensor moves neither
    keys = ("allocation.all.allocated", "allocated_bytes.all.allocated")
    check(all(after.get(k, 0) == before.get(k, 0) for k in keys),
          f"14c: the dry run touched the card's allocator: "
          f"{ {k: (before.get(k), after.get(k)) for k in keys} }")
    check(len(recs) == 4 and all(r["programs"] and "refused" not in r
                                 for r in recs.values()),
          f"14c: records {sorted(recs)}")
    moe_cfg = get_config("qwen2-moe-a2.7b")
    dec = recs["qwen2-moe-a2.7b__decode_32k__sp"]["programs"][0]
    rows = specs.INPUT_SHAPES["decode_32k"]["global_batch"] // 16
    want = {"model/all_reduce": moe_cfg.num_layers * rows * moe_cfg.d_model
            * 2}
    check(dec["collectives"]["bytes"] == want
          and dec["collectives"]["counts"] == {
              "model/all_reduce": moe_cfg.num_layers},
          f"14c: shard_map decode collectives {dec['collectives']}, "
          f"expected {want} in {moe_cfg.num_layers} calls")
    print(f"14c: {len(recs)} records; the card's allocator counted no "
          f"allocation ({before.get(keys[0])} allocations before and "
          f"after) and no port kernel launched; shard_map decode: "
          f"{moe_cfg.num_layers} all-reduces over 'model' of {rows} "
          f"rows x {moe_cfg.d_model} bf16", flush=True)
    summary = {name: [{k: p[k] for k in ("program", "flops_per_device",
                                          "bytes_accessed_per_device",
                                          "dominant", "trace_s")}
                      | {"memory": p["memory"],
                         "collective_bytes": p["collectives"]["total_bytes"]}
                      for p in r["programs"]]
               for name, r in recs.items()}
    print(json.dumps({"14c": summary, "walls_s": out, "card": smi}),
          flush=True)
    return {"walls_s": out, "records": summary}


def dryrun_moe_ranks_check(shard, smi) -> dict:
    """14e (run on phase 13's ranks): each rank's column sum = its own flat
    forward within GROUPED_TOL, and its counters = one all-reduce over
    "model" of B T d float32 = the dry run's prediction for that forward
    (a meta program on rank 0 of MOE_COLUMNS_SPEC)."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              moe_impl="shard_map")
    B, T = MOE_COLUMNS_TOKENS
    rec = dryrun.analyze_one(dryrun.moe_block_program(
        cfg, B, T, MOE_COLUMNS_SPEC), 4)
    coll = rec["collectives"]
    predicted = {"model": {"all_reduce": [coll["counts"]["model/all_reduce"],
                                          coll["bytes"]["model/all_reduce"]]}}
    check(predicted == {"model": {"all_reduce": [1, B * T * cfg.d_model * 4]}},
          f"14e: the dry run predicts {predicted}")
    for r in shard["14e"]:
        check(r["allclose_f64"], f"14e rank {r['rank']}: the float64 column "
              f"sum is {r['max_abs_err_f64']} from its flat forward")
        check(r["grads_allclose_f64"], f"14e rank {r['rank']}: the float64 "
              f"grads through the column sum are "
              f"{r['grad_max_abs_err_f64']} from the flat dispatch's")
        check(r["by_axis"] == predicted, f"14e rank {r['rank']}: counters "
              f"{r['by_axis']} != the dry run's {predicted}")
    out = {"predicted": predicted, "ranks": shard["14e"]}
    errs = {k: max(r[k] for r in shard["14e"])
            for k in ("max_abs_err_f32", "max_abs_err_f64",
                      "grad_max_abs_err_f64", "wall_s")}
    print(f"14e: 4 ranks, each model pair's column sum = its flat forward "
          f"within {GROUPED_TOL} in float64 (max abs err "
          f"{errs['max_abs_err_f64']:.3e}; float32 "
          f"{errs['max_abs_err_f32']:.3e}, within the tolerance on "
          f"{sum(r['allclose_f32'] for r in shard['14e'])} of 4 ranks); one "
          f"float32 all-reduce of {B * T * cfg.d_model * 4} B over 'model' a "
          f"rank = the dry run's prediction; the float64 grads through the "
          f"sum = the flat dispatch's (max abs err "
          f"{errs['grad_max_abs_err_f64']:.3e}); {errs['wall_s']} s a rank",
          flush=True)
    print(json.dumps({"14e": out, "card": smi}), flush=True)
    return out


def dryrun_phase(device, smi, trained, families, shard) -> dict:
    """Phase 14: the port's dry run (``launch/dryrun.py``, meta tensors)
    held against what the card measured: 14a at phase 6's cell, 14b at
    13a's mesh, 14c the CLI at full size (no allocation on the card),
    14d (run in 5f) the grouped dispatch, 14e (run on phase 13's ranks)
    the expert-parallel dispatch over "model" pairs."""
    phase("14. the dry run against the card: 14a phase 6's FLOPs and bytes, "
          "14b 13a's collectives, 14c the CLI at full size, 14d the grouped "
          "dispatch (5f), 14e the expert-parallel dispatch (phase 13's "
          "ranks)")
    t0 = time.perf_counter()
    walls = {}
    out = {}
    for key, fn in (("14a", lambda: dryrun_train_check(trained, smi)),
                    ("14b", lambda: dryrun_mesh_check(shard, smi)),
                    ("14c", lambda: dryrun_cli_phase(device, smi)),
                    ("14e", lambda: dryrun_moe_ranks_check(shard, smi))):
        t = time.perf_counter()
        out[key] = fn()
        walls[key] = round(time.perf_counter() - t, 1)
    grouped = families["qwen2-moe-a2.7b"]["grouped"]
    check(grouped["allclose"], f"14d: grouped dispatch {grouped['max_abs_err']}"
          f" from the flat one at a drop-free capacity")
    out["14d"] = grouped
    walls["14d_in_5f"] = grouped["wall_s"]
    out["walls_s"] = walls
    out["phase_wall_s"] = round(time.perf_counter() - t0, 1)
    print(f"14d: grouped = flat within {GROUPED_TOL} (max abs err "
          f"{grouped['max_abs_err']:.3e}); dropped at capacity factor "
          f"{grouped['dropped_share']['capacity_factor']}: flat "
          f"{grouped['dropped_share']['flat']:.4f}, grouped "
          f"{grouped['dropped_share']['grouped']:.4f}", flush=True)
    print(json.dumps({"phase14_wall_s": out["phase_wall_s"],
                      "walls_s": walls, "card": smi}), flush=True)
    return out


def main_path_phase(device) -> dict:
    """Serve the main path through K8, decoding through the engine's CUDA
    graph, then the gather path on the same params, captured and eager;
    profile both K8 runs (5b) and hold the captured chunk against the
    eager one (5j).  Returns the K8 launch count and the reports."""
    phase("5. main path: full-width qwen2.5-3b, paged engine through K8, "
          "the decode chunk as a CUDA graph")
    args_k = serve.parse_args(SERVE_ARGV + ["--paged-kernel"])
    cfg = get_config(args_k.arch)
    t0 = time.perf_counter()
    params = serve.init_params(cfg, args_k, device)
    torch.cuda.synchronize(device)
    print(f"params: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B "
          f"f32 on {device}, init {time.perf_counter() - t0:.2f} s",
          flush=True)
    requests = serve.make_requests(cfg, args_k)
    print("prompt lengths:", [len(r["tokens"]) for r in requests])

    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    res_k, engine, rep_k = serve.engine_serve(cfg, params, requests, args_k,
                                              Obs(), device)
    peak = torch.cuda.max_memory_allocated(device)
    steps = engine.stats["decode_steps"]
    k8_launches = launch_counts(paged_attention=cfg.num_layers * (
        steps + captured(engine, requests)))["paged_attention"]
    print(f"K8 launches {k8_launches} = {cfg.num_layers} layers x ({steps} "
          f"decode steps + {engine.stats['warmup_steps']} warm-up steps); "
          f"capture {engine.stats['compile_s']:.3f} s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    check(sorted(res_k) == list(range(len(requests))), "requests missing")
    for uid, toks in res_k.items():
        check(toks.shape == (args_k.gen,),
              f"request {uid} returned {toks.shape} tokens")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"request {uid} returned token ids outside the vocabulary")
    del engine
    torch.cuda.empty_cache()

    # reference on the card: the gather path (no kernel), same params,
    # through its own graph and eagerly
    rep_g = {}
    for graphs in (True, False):
        res_g, engine, rep_g[graphs] = serve.engine_serve(
            cfg, params, requests, serve.parse_args(SERVE_ARGV), Obs(),
            device, graphs=graphs)
        captured(engine, requests, graphs)
        check(pa.launches == k8_launches, "the gather path launched K8")
        for uid in res_k:
            check(bool((res_k[uid] == res_g[uid]).all()),
                  f"request {uid}: kernel tokens {res_k[uid].tolist()} != "
                  f"gather-path tokens {res_g[uid].tolist()} (graphs "
                  f"{graphs})")
        del engine
        torch.cuda.empty_cache()
    print(f"gather path, captured and eager: same tokens for all "
          f"{len(res_g)} requests", flush=True)
    # the first token of request 0 is the argmax of a plain full forward
    prompt = torch.as_tensor(requests[0]["tokens"], device=device)[None]
    logits, _ = tfm.forward(params, cfg, prompt)
    check(logits.shape == (1, prompt.shape[1], cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "forward logits not finite")
    check(int(logits[0, -1].argmax()) == int(res_k[0][0]),
          "request 0's first token is not the argmax of the forward logits")
    del logits
    torch.cuda.empty_cache()
    profile = profile_phase(device, cfg, params, requests, args_k)
    graph = graph_phase(device, cfg, params, requests, args_k, res_k, rep_k,
                        profile)
    prefill = prefill_graph_phase(device, cfg, params, requests, args_k,
                                  res_k, profile, graph)
    flash = flash_prefill_phase(device, cfg, params)
    del params
    torch.cuda.empty_cache()
    return {"launches": k8_launches, "decode_steps": steps,
            "peak_memory_gib": round(peak / 2 ** 30, 3),
            "paged_kernel": rep_k, "gather": rep_g[False],
            "gather_captured": rep_g[True], "profile": profile,
            "graph": graph, "prefill_graphs": prefill,
            "flash_prefill": flash}


def prompt_buckets(engine, requests) -> set:
    """The dense engine's prompt buckets of ``requests``."""
    return {_bucket_len(r["tokens"].shape[-1], 8, engine.max_len - (
        r["cond"].shape[0] if "cond" in r else 0)) for r in requests}


def captured(engine, requests, graphs=True) -> int:
    """Check that ``engine`` captured the programs the reference compiles
    — one decode chunk, and one prefill a prompt bucket of ``requests``
    (dense) or one prefill chunk (paged) — and took time to (none, and
    no time, when it ran eagerly); returns its warm-up steps, whose K8
    launches count beside the decode steps'."""
    want = 1 + (1 if engine.paged else len(prompt_buckets(engine,
                                                          requests)))
    want = want if graphs else 0
    compiles = engine.obs.counter("serve.compiles").total
    check(compiles == want and (engine.stats["compile_s"] > 0) == graphs,
          f"{compiles} programs captured (want {want}) in "
          f"{engine.stats['compile_s']} s, graphs {graphs}")
    return engine.stats["warmup_steps"]


def replay_prefills_without_sync(engine, device) -> None:
    """One more replay of each of ``engine``'s prefill graphs (on its
    last request's inputs), with host synchronisation forbidden."""
    torch.cuda.synchronize(device)
    for prog in engine._prefills.values():
        without_sync(prog.run)
    torch.cuda.synchronize(device)
    print(f"{len(engine._prefills)} prefill graph(s) replayed with host "
          "synchronisation forbidden", flush=True)


def _device_rows(prof):
    """(device us, name, calls) of every kernel row the profiler saw,
    largest first: the device events' durations summed by name, read
    from the profiler's raw events (``key_averages`` builds a Python
    object for each event of the trace first, a minute for the eager
    serve run's)."""
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        us, n = rows.get(e.name(), (0.0, 0))
        rows[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, k, n) for k, (us, n) in rows.items()), reverse=True)


BUSY_STEPS = 2             # engine steps a busy-share window profiles


def submit_pass(engine, requests, args) -> list:
    """Queue ``requests`` on ``engine`` as ``serve.submit_requests`` does,
    each slot-sized wave ``--arrive-every`` steps after the one before,
    from the engine's current step; returns their uids."""
    now = engine.sched.step_count
    return [engine.submit(r["tokens"], max_new_tokens=args.gen,
                          eos_id=args.eos_id if args.eos_id >= 0 else None,
                          arrival=now + (i // args.slots) * args.arrive_every,
                          cond=r.get("cond"),
                          patch_embeds=r.get("patch_embeds"))
            for i, r in enumerate(requests)]


def busy_window(device, cfg, params, requests, args, graphs,
                engine=None) -> dict:
    """The device's busy share over a short steady window: one engine (a
    new one, or ``engine``, which served before) serves ``requests``
    until its first decode chunk of them is done (a new engine's captures
    included, with ``graphs``), then BUSY_STEPS engine steps (decode
    chunks, with any prefill chunks interleaved) run under torch.profiler
    (device activity only): every kernel's device time over the window's
    wall.  A window keeps the trace short: a whole run's took a minute
    to process."""
    if engine is None:
        engine = serve.make_engine(cfg, params, requests, args, Obs(),
                                   device, graphs)
    submit_pass(engine, requests, args)
    chunks = engine.stats["chunks"]
    while engine.stats["chunks"] == chunks:
        engine.step()
    chunks = engine.stats["chunks"]
    torch.cuda.synchronize(device)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(BUSY_STEPS):
            engine.step()
        torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    chunks = engine.stats["chunks"] - chunks
    del engine
    _release()
    busy = sum(us for us, _, _ in _device_rows(prof)) / 1e6
    check(busy > 0 and chunks >= 1,
          f"busy window: {busy} s of device time, {chunks} decode chunks")
    return {"steps": BUSY_STEPS, "decode_chunks": chunks,
            "wall_s": round(wall, 4),
            "device_busy_s": round(busy, 4),
            "busy_share": round(busy / wall, 4)}


def _profile_run(device, cfg, params, requests, args, graphs):
    """One serve run under torch.profiler (device activity only: with
    host-op events too, processing the trace of this run took minutes,
    and busy time needs none of them)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        _, engine, rep = serve.engine_serve(cfg, params, requests, args,
                                            Obs(), device, graphs=graphs)
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    rows = _device_rows(prof)
    busy_s = sum(us for us, _, _ in rows) / 1e6
    return {"profiled_wall_s": rep["wall_s"], "device_busy_s": busy_s,
            "profile_phase_s": round(time.perf_counter() - t0, 1),
            "trace_stop_s": round(t2 - t1, 1),
            "rows_s": round(time.perf_counter() - t2, 1),
            "decode_steps": engine.stats["decode_steps"],
            "names_k8": any("paged_attention" in k for _, k, _ in rows),
            "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                             "calls": n} for us, k, n in rows[:8]]}


def profile_phase(device, cfg, params, requests, args) -> dict:
    """Where the time goes: the K8 main path once more under
    torch.profiler, decoding through its CUDA graph, then eagerly —
    device busy time against the wall clock, and the kernels that take
    it.  The profiler slows the host side, so the idle share is also
    given against an unprofiled run's wall."""
    phase("5b. main path under torch.profiler, captured and eager")
    out = {}
    for name, graphs in (("captured", True), ("eager", False)):
        out[name] = _profile_run(device, cfg, params, requests, args, graphs)
        check(out[name]["device_busy_s"] > 0,
              f"the profiler saw no device time in the {name} run")
        print(json.dumps({"profile": name, **out[name]}), flush=True)
    # K8 inside the graph: a replay's kernels are named where the
    # profiler sees into the graph; the eager run names them in any case
    check(out["eager"]["names_k8"], "the profiler saw no K8 launch in the "
          "eager run")
    print(f"K8 named by the profiler: captured run "
          f"{out['captured']['names_k8']}, eager run "
          f"{out['eager']['names_k8']}", flush=True)
    return out


def graph_phase(device, cfg, params, requests, args_k, res_k, rep_k,
                profile) -> dict:
    """The decode chunk as a CUDA graph against the eager chunk on the
    main path (paged engine through K8): the same tokens greedy (phase
    5's captured run) and sampled (temperature 0.8, top-k 50, one seed);
    one replay with host synchronisation forbidden; one decode program a
    captured engine; K8 launches = layers x decode steps through the
    replays (+ the warm-up's); ITL and device-busy share of both."""
    phase("5j. the decode chunk as a CUDA graph: captured against eager, "
          "greedy and sampled")
    sampled = serve.parse_args(SERVE_ARGV + ["--paged-kernel",
                                             "--temperature", "0.8",
                                             "--top-k", "50"])
    out = {}
    for label, args, graphs in (("greedy_eager", args_k, False),
                                ("sampled_captured", sampled, True),
                                ("sampled_eager", sampled, False)):
        reset_launches()
        res, engine, rep = serve.engine_serve(cfg, params, requests, args,
                                              Obs(), device, graphs=graphs)
        steps = engine.stats["decode_steps"]
        k8 = launch_counts(paged_attention=cfg.num_layers * (
            steps + captured(engine, requests, graphs)))["paged_attention"]
        want = res_k if label == "greedy_eager" else out.get(
            "sampled_captured", {}).get("tokens")
        if want is not None:
            for uid in res:
                check(bool((res[uid] == want[uid]).all()),
                      f"{label} request {uid}: {res[uid].tolist()} != "
                      f"captured {want[uid].tolist()}")
        if label == "sampled_captured":
            greedy_equal = sum(bool((res[u] == res_k[u]).all())
                               for u in res)
            print(f"sampled tokens equal the greedy ones in {greedy_equal} "
                  f"of {len(res)} requests", flush=True)
            # one more replay, with host synchronisation forbidden
            reset_launches()
            without_sync(engine._decode_program())
            torch.cuda.synchronize(device)
            launch_counts(paged_attention=cfg.num_layers
                          * engine.decode_chunk)
            reset_launches()
            replay_prefills_without_sync(engine, device)
            launch_counts()                    # a prefill launches no K8
        out[label] = {"tokens": res, "k8_launches": k8,
                      "decode_steps": steps, "report": rep,
                      "compile_s": engine.stats["compile_s"]}
        del engine
        torch.cuda.empty_cache()
    wall = {"captured": rep_k["wall_s"],
            "eager": out["greedy_eager"]["report"]["wall_s"]}
    summary = {
        "itl_ms": {"captured": rep_k["itl_ms"],
                   "eager": out["greedy_eager"]["report"]["itl_ms"],
                   "sampled_captured": out["sampled_captured"]["report"][
                       "itl_ms"],
                   "sampled_eager": out["sampled_eager"]["report"][
                       "itl_ms"]},
        "decode_tokens_per_s": {
            "captured": rep_k["decode_tokens_per_s"],
            "eager": out["greedy_eager"]["report"]["decode_tokens_per_s"]},
        "wall_s": wall,
        "device_busy_share": {
            k: round(profile[k]["device_busy_s"] / wall[k], 4)
            for k in wall},
        "busy_window": {
            name: busy_window(device, cfg, params, requests, args_k, graphs)
            for name, graphs in (("captured", True), ("eager", False))},
        "capture_s": {"greedy": rep_k["compile_s"],
                      "sampled": out["sampled_captured"]["compile_s"]},
        "k8_launches": {k: v["k8_launches"] for k, v in out.items()},
        "prefill_tokens_per_s": {
            "captured": rep_k["prefill_tokens_per_s"],
            "eager": out["greedy_eager"]["report"]["prefill_tokens_per_s"]},
        "ttft_ms": {"captured": rep_k["ttft_ms"],
                    "eager": out["greedy_eager"]["report"]["ttft_ms"]},
        "replay_without_sync": True}
    print("captured == eager tokens for all "
          f"{len(res_k)} requests, greedy and sampled", flush=True)
    print(json.dumps(summary), flush=True)
    return summary


def _serve_pass(engine, requests, args, device) -> tuple:
    """Serve ``requests`` once more on ``engine`` (``submit_pass``), with
    a fresh registry and zeroed stats, so that the pass's numbers are its
    own: (tokens by request, the pass's ``throughput()`` with its wall
    and its captures)."""
    engine.obs = Registry()
    engine.stats = dict.fromkeys(engine.stats, 0)
    uids = submit_pass(engine, requests, args)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    rep = engine.throughput()
    rep.update(wall_s=round(wall, 3),
               compiles=engine.obs.counter("serve.compiles").total)
    return [results[u] for u in uids], rep


PASS_KEYS = ("prefill_tokens_per_s", "ttft_ms", "itl_ms",
             "decode_tokens_per_s", "wall_s", "compile_s", "compiles")


def prefill_graph_phase(device, cfg, params, requests, args_k, res_k,
                        profile, graph) -> dict:
    """The prefills as CUDA graphs on the main path (paged, through K8):
    one captured engine serves the 8 requests twice — a cold pass, which
    captures the prefill-chunk and the decode graph (each capture
    timed), and a warm pass, which captures nothing — both with phase
    5's tokens; then a third warm pass under torch.profiler (its device
    time over the warm pass's wall: the busy share of the whole run) and
    a two-step busy window on the same engine.  Beside them the eager
    engine once (with its peak memory), its whole-run busy share from
    5b's eager profile and its window from 5j; the cold pass's busy
    share from 5b's captured profile (a cold engine too)."""
    phase("5k. the prefills as CUDA graphs: one engine serves the main "
          "path's requests twice (cold: captures included; warm), beside "
          "the eager engine")
    engine = serve.make_engine(cfg, params, requests, args_k, Obs(), device,
                               True)
    capture_s = {}
    capture = engine._capture

    def timed_capture(name, *args, **kwargs):
        t0 = time.perf_counter()
        program = capture(name, *args, **kwargs)
        capture_s[name] = round(time.perf_counter() - t0, 4)
        return program
    engine._capture = timed_capture
    torch.cuda.reset_peak_memory_stats(device)
    out = {}
    for name in ("cold", "warm"):
        toks, rep = _serve_pass(engine, requests, args_k, device)
        for i, t in enumerate(toks):
            check(bool((t == res_k[i]).all()),
                  f"{name} pass, request {i}: {t.tolist()} != phase 5's "
                  f"{res_k[i].tolist()}")
        out[name] = {k: rep[k] for k in PASS_KEYS}
    out["cold"]["peak_memory_gib"] = out["warm"]["peak_memory_gib"] = round(
        torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    check(sorted(capture_s) == ["decode_chunk", "prefill_chunk"]
          and out["cold"]["compiles"] == 2 and out["warm"]["compiles"] == 0
          and out["warm"]["compile_s"] == 0,
          f"captures {capture_s}; compiles cold {out['cold']['compiles']}, "
          f"warm {out['warm']['compiles']}")
    out["capture_s"] = capture_s
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        toks, _ = _serve_pass(engine, requests, args_k, device)
    warm_busy_s = sum(us for us, _, _ in _device_rows(prof)) / 1e6
    del prof
    out["warm"]["device_busy_s"] = round(warm_busy_s, 4)
    out["warm"]["busy_share"] = round(warm_busy_s / out["warm"]["wall_s"], 4)
    out["warm"]["busy_window"] = busy_window(device, cfg, params, requests,
                                             args_k, True, engine)
    out["cold"]["busy_share"] = round(profile["captured"]["device_busy_s"]
                                      / out["cold"]["wall_s"], 4)
    out["cold"]["busy_window"] = graph["busy_window"]["captured"]
    del engine
    _release()

    torch.cuda.reset_peak_memory_stats(device)
    engine = serve.make_engine(cfg, params, requests, args_k, Obs(), device,
                               False)
    toks, rep = _serve_pass(engine, requests, args_k, device)
    for i, t in enumerate(toks):
        check(bool((t == res_k[i]).all()),
              f"eager pass, request {i}: {t.tolist()} != phase 5's "
              f"{res_k[i].tolist()}")
    eager = {k: rep[k] for k in PASS_KEYS}
    eager["peak_memory_gib"] = round(
        torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    eager["busy_share"] = round(profile["eager"]["device_busy_s"]
                                / eager["wall_s"], 4)
    eager["busy_window"] = graph["busy_window"]["eager"]
    out["eager"] = eager
    del engine
    _release()
    print(json.dumps({"prefill_graphs": out}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    pin_float32()
    t_start = time.perf_counter()

    device, kind, smi = device_phase()
    build_phase()
    max_abs_err = check_phase(device)
    parle_errs = parle_check_phase(device)
    parle_errs.update(compress_check_phase(device))
    parle_errs.update(elastic_check_phase(device))
    flash_err = flash_check_phase(device)
    ssd_err = ssd_check_phase(device)
    geometry_errs = geometry_check_phase(device)
    timing = timing_phase(device)
    long_context = long_context_phase(device)
    parle_timing = parle_timing_phase(device)
    parle_timing.update(compress_timing_phase(device))
    parle_timing.update(elastic_timing_phase(device))
    flash_timing = flash_timing_phase(device)
    ssd_timing = ssd_timing_phase(device)
    geometry_timing = geometry_timing_phase(device, smi)
    run = main_path_phase(device)
    mamba = mamba2_phase(device)
    families = families_phase(device)
    trained = train_phase(device)
    refs = trained.pop("pod_refs")
    pod = pod_phase(device, refs, smi)
    async_res = async_phase(device, refs["none"], smi)
    remat = remat_phase(device, smi)
    stream = stream_report_phase(device, pod["ckpt"]["obs"], smi)
    shard = shard_phase(device, smi)
    dry = dryrun_phase(device, smi, trained, families, shard)
    main_errs = parle_main_shape_phase(device, trained["replicas"],
                                       trained["elements_per_replica"])

    phase("7. summary")
    keys = ("decode_tokens_per_s", "prefill_tokens_per_s", "slot_utilization",
            "itl_ms", "ttft_ms", "wall_s")
    prof = trained["profile"]
    print(json.dumps({
        "throughput": {mode: {k: run[mode][k] for k in keys}
                       for mode in ("paged_kernel", "gather",
                                    "gather_captured")},
        "peak_memory_gib": run["peak_memory_gib"],
        "decode_steps": run["decode_steps"],
        "device_busy_share": run["graph"]["device_busy_share"],
        "graph": {k: run["graph"][k] for k in (
            "itl_ms", "capture_s", "busy_window")},
        "prefill_graphs": run["prefill_graphs"],
        "train": {"step_wall_s": trained["step_wall_s"],
                  "tokens_per_s": trained["tokens_per_s"],
                  "peak_memory_gib": trained["peak_memory_gib"],
                  "device_busy_share": prof["busy_share_of_unprofiled_round"],
                  "k1_k2_device_share": (prof["k1_device_s"]
                                         + prof["k2_device_s"])
                  / prof["device_busy_s"],
                  "round_wall_s": {
                      "none_barrier": trained["round_wall_s"]["kernel"],
                      "none_overlap": trained["overlap_round_wall_s"],
                      "int8_barrier": trained["int8"]["barrier"][
                          "round_wall_s"]["kernel"],
                      "int8_overlap": trained["int8"]["overlap"][
                          "round_wall_s"]["kernel"]},
                  "int8_peak_memory_gib": {
                      k: trained["int8"][k]["peak_memory_gib"]
                      for k in INT8_PATHS},
                  "elastic_sgd": {
                      "round_wall_s": trained["elastic_sgd"]["round_wall_s"],
                      "peak_memory_gib": trained["elastic_sgd"][
                          "peak_memory_gib"]},
                  "sgd": {"round_wall_s": trained["sgd"]["round_wall_s"],
                          "peak_memory_gib": trained["sgd"][
                              "peak_memory_gib"]},
                  **{key: {k: trained[key][k] for k in (
                      "layers", "round_wall_s", "peak_memory_gib")}
                     for key, _ in TRAINED_FAMILIES}},
        "pod": {k: (pod[k] if k.endswith("_s") else {
            kk: pod[k][kk] for kk in ("round_wall_s", "peak_memory_gib")})
            for k in (*POD_JOBS, "phase_wall_s", "ranks_wall_s")},
        "async": {"single_host_s": async_res["single"]["host_s"],
                  "pod": {k: async_res["pod"][k] for k in (
                      "a", "b", "reply_frame_bytes", "phase_wall_s")},
                  "chaos": {k: async_res["chaos"][k] for k in (
                      "rel_l2", "wall_s", "phase_wall_s")},
                  "phase_wall_s": async_res["phase_wall_s"]},
        "phase12": {
            "ckpt": {k: pod["ckpt"][k] for k in (
                "where", "file_bytes", "gather_s", "checkpoint_s",
                "write_s", "restore_s", "peak_memory_gib", "wall_s")},
            "remat": {r: {k: v[k] for k in ("round_wall_s",
                                            "peak_memory_gib")}
                      for r, v in remat["runs"].items()},
            "remat_phase_wall_s": remat["phase_wall_s"],
            "stream_report_phase_wall_s": stream["phase_wall_s"]},
        "phase13": {
            "13a": {k: shard["13a"][k] for k in (
                "verdict", "wall_s", "peak_memory_gib", "by_axis")},
            "13b": {k: shard["13b"][k] for k in (
                "round_wall_s", "peak_memory_gib", "by_axis")},
            "13c": {k: shard["13c"][k] for k in (
                "file_bytes", "save_s", "restore_s", "peak_memory_gib")},
            **{k: shard[k] for k in ("phase_wall_s", "ranks_wall_s")}},
        "phase14": {k: dry[k] for k in ("phase_wall_s", "walls_s")},
        "flash_prefill": {k: run["flash_prefill"][k] for k in (
            "max_logit_err", "max_kv_cache_err", "prefill_wall_s")},
        "mamba2": {"max_logit_err": mamba["max_logit_err"],
                   "forward_wall_s": mamba["forward_wall_s"],
                   "serve": mamba["serve"]},
        "families": {arch: {
            "params": f["params"], "peak_memory_gib": f["peak_memory_gib"],
            "phase_wall_s": f["phase_wall_s"],
            "itl_ms_p50": {mode: f["serve"][mode]["itl_ms"]["p50"]
                           for mode in FAMILY_MODES},
            "itl_ms_mean": {mode: f["serve"][mode]["itl_ms"]["mean"]
                            for mode in FAMILY_MODES},
            "prefill_tokens_per_s": {
                mode: f["serve"][mode]["prefill_tokens_per_s"]
                for mode in FAMILY_MODES},
            "ttft_ms_mean": {mode: f["serve"][mode]["ttft_ms"]["mean"]
                             for mode in FAMILY_MODES},
            "capture_s": f["serve"]["capture_s"],
            "busy_share": {k: v["busy_share"] for k, v in
                           f["serve"]["busy_window"].items()},
            "forward_wall_s": (f["forward"]["forward_wall_s"]
                               if "forward" in f
                               else f["prefill"]["prefill_wall_s"])}
            for arch, f in families.items()},
        "total_s": round(time.perf_counter() - t_start, 1)}), flush=True)
    kernels = [{
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:81",
        "launches": run["launches"],
        "launches_by_path": {"qwen2.5-3b": run["launches"], **{
            arch: f["serve"]["k8_launches"] for arch, f in families.items()}},
        "max_abs_err": max(max_abs_err, geometry_errs["paged_attention"]),
        "ms": timing["ms"], "kernel_ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "library_ms": timing["library_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "empty_launch_ms": timing["empty_launch_ms"],
        "long_context": {k: long_context[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")},
        "geometries": {k.split("/")[1]: v for k, v in geometry_timing.items()
                       if k.startswith("paged_attention/")}}]
    # each kernel's launches on its own path: K1/K2 on the f32 barrier
    # run, K4/K5 on the int8 barrier run, K6 on the int8 overlap run, K7
    # on the Elastic-SGD run
    int8 = trained["int8"]
    for name, line, launches in (
            ("parle_inner_update", 52, trained["launches"]),
            ("parle_sync_update", 175, trained["launches"]),
            ("elastic_update", 299, trained["elastic_sgd"]["launches"]),
            ("quantize_ef", 365, int8["barrier"]["launches"]),
            ("parle_sync_dequant", 412, int8["barrier"]["launches"]),
            ("parle_apply_quantize", 479, int8["overlap"]["launches"])):
        t = parle_timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/parle_update.cu",
            "replaces": f"src/repro/kernels/parle_update.py:{line}",
            "launches": launches[name],
            **({"launches_by_path": {
                "qwen2.5-3b": launches[name], **{
                    get_config(arch).name: trained[key]["launches"][name]
                    for key, arch in TRAINED_FAMILIES}}}
               if name in ("parle_inner_update", "parle_sync_update")
               else {}),
            "pod_launches_per_rank": {
                job: pod[job]["launches_per_rank"][name] for job in POD_JOBS
                if name in pod[job]["launches_per_rank"]},
            # the async policy's inner rounds (11a); its apply is plain
            **({"async_launches": async_res["single"]["launches"][name]}
               if name in ("parle_inner_update", "parle_sync_update")
               else {}),
            # phase 12: 12a's uninterrupted pod:2 run (a rank), 12b's
            # remat=False round
            **({"phase12_launches": {
                "ckpt_pod2_per_rank": pod["ckpt"]["launches"]["full"].get(
                    name, 0),
                "remat_round": remat["runs"]["False"]["launches"].get(
                    name, 0)}}
               if name in ("parle_inner_update", "parle_sync_update",
                           "quantize_ef", "parle_apply_quantize")
               else {}),
            # phase 13: 13a's f32 pod (replica:2,model:2, dist_run),
            # 13b's int8 run (replica:2,data:2) and 13c's save run
            # (replica:2,model:2), a rank
            **({"phase13_launches_per_rank": {
                job: shard[job]["launches_per_rank"].get(name, 0)
                for job in (*SHARD_JOBS, "13c")}}
               if name in ("parle_inner_update", "parle_sync_update",
                           "quantize_ef", "parle_sync_dequant")
               else {}),
            "max_abs_err": max(parle_errs[name], main_errs[name]),
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"]})
    fam_k3 = {arch: (f.get("forward") or f["prefill"])["launches"]
              for arch, f in families.items()}
    by_path = {
        "flash_attention": {"qwen2.5-3b": run["flash_prefill"]["launches"],
                            **{arch: (v["flash_attention"]
                                      if isinstance(v, dict) else v)
                               for arch, v in fam_k3.items()}},
        "ssd_scan": {"mamba2-1.3b": mamba["launches"],
                     "zamba2-1.2b": fam_k3["zamba2-1.2b"]["ssd_scan"]}}
    for name, src, line, launches, err, t in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:79",
             run["flash_prefill"]["launches"],
             max(flash_err, geometry_errs["flash_attention"]), flash_timing),
            ("ssd_scan", "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:75",
             mamba["launches"], ssd_err, ssd_timing)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": line,
            "launches": launches, "launches_by_path": by_path[name],
            **({"geometries": {
                k.split("/")[1]: v for k, v in geometry_timing.items()
                if k.startswith("flash_attention/")}}
               if name == "flash_attention" else {}),
            "max_abs_err": err, "ms": t["ms"],
            "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            **{k: t[k] for k in ("bound_rate", "simt_bound_ms") if k in t}})
    print(json.dumps({"kernels": kernels}), flush=True)
    quickstart_phase(t_start)
    paper_phase(device, smi, t_start)
    print(smi, flush=True)                 # the card and its power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def quickstart_phase(t_start) -> dict:
    """The paper's headline claim on the card: the port's quickstart at
    its default 400 steps (its assert fails the run)."""
    phase("8. quickstart on the card: MLP on the teacher task, SGD vs "
          "Parle n=3, 400 steps")
    out = quickstart.run(steps=400, replicas=3, device="cuda")
    print(json.dumps({"quickstart": out, "total_s": round(
        time.perf_counter() - t_start, 1)}), flush=True)
    return out


# half the reference's default steps of Table 1 (n = 3, seed 0 here),
# Table 2 and Fig. 1, for the script's time limit; the Parle family's L
TABLE1_STEPS, TABLE2_STEPS, FIG1_STEPS, PAPER_L = 300, 200, 200, 25


def _parle_launches(steps, runs=1) -> dict:
    """K1 once a step and K2 once every L steps, for all replicas."""
    return {"parle_inner_update": runs * steps,
            "parle_sync_update": runs * (steps // PAPER_L)}


# the kernel launches of one algorithm's run in Table 1
TABLE1_LAUNCHES = {"sgd": {}, "entropy_sgd": _parle_launches(TABLE1_STEPS),
                   "elastic_sgd": {"elastic_update": TABLE1_STEPS},
                   "parle": _parle_launches(TABLE1_STEPS)}


def _print_rows(script, lines, smi) -> None:
    for line in lines:
        print(json.dumps({"paper": script, "row": line, "card": smi}),
              flush=True)


def _table1_bitwise(device) -> dict:
    """Table 1's seed 0 at TABLE1_STEPS twice, through K1 / K2 / K7
    and through their plain versions, under deterministic algorithms: the
    four deployables and their errors equal bit for bit, each kernel
    launched once a step (K2 once every L) and the plain run launching
    none.  Returns the kernel run's rows: [(name, test err, train err,
    wall_s)]."""
    torch.use_deterministic_algorithms(True)
    runs = {}
    for use_kernel in (True, False):
        got = {}
        reset_launches()
        for name, params, wall, task in table1_baselines.trained(
                TABLE1_STEPS, 3, 0, device, use_kernel):
            launches = launch_counts(
                **(TABLE1_LAUNCHES[name] if use_kernel else {}))
            reset_launches()
            got[name] = (params, paper.errors(params, task), wall,
                         {k: v for k, v in launches.items() if v})
        runs[use_kernel] = got
    torch.use_deterministic_algorithms(False)
    for name, (params, errs, _, _) in runs[True].items():
        plain_params, plain_errs, _, _ = runs[False][name]
        for k in params:
            check(torch.equal(params[k], plain_params[k]),
                  f"table 1 {name}: kernel deployable {k} != plain")
        check(errs == plain_errs, f"table 1 {name}: errors {errs} != "
              f"{plain_errs}")
    print(json.dumps({"paper_bitwise": {
        name: {"test_err": errs[0], "train_err": errs[1],
               "kernel_wall_s": round(wall, 3),
               "plain_wall_s": round(runs[False][name][2], 3),
               "launches": launches}
        for name, (_, errs, wall, launches) in runs[True].items()}}),
        flush=True)
    print("table 1 seed 0: kernel path == plain path bit for bit (four "
          "deployables, their errors)", flush=True)
    return [(name,) + errs + (wall,)
            for name, (_, errs, wall, _) in runs[True].items()]


def _llm_resume_check(res, path) -> None:
    """The checkpoint at ``path`` restores into a fresh state that takes
    the same next step as the trained one, bit for bit (deterministic
    algorithms)."""
    state, pcfg = res["state"], res["pcfg"]
    like = parle.init(tree_map(torch.zeros_like,
                               parle.replica_model(state, 0)), pcfg)
    restored = ckpt.restore(path, like)
    step = train_llm_parle.make_step(res["model"], pcfg)
    batch = replica_batches(res["stream"], len(res["losses"]),
                            res["stream"].batch_size, pcfg.n_replicas)
    torch.use_deterministic_algorithms(True)
    s2, m2 = step(restored, batch)
    s1, m1 = step(state, batch)
    torch.use_deterministic_algorithms(False)
    check(torch.equal(m1["loss"], m2["loss"]) and torch.equal(s1.x, s2.x),
          f"restored state's next step differs: loss {float(m2['loss'])} "
          f"vs {float(m1['loss'])}")


def paper_phase(device, smi, t_start) -> dict:
    """Phase 9: the paper's experiments and the examples on the card.
    Table 1 (seed 0 bitwise against the plain path; its seeds 1 and 2
    are left out for the script's time),
    Table 2 and Fig. 1 at half the reference's default steps through K1, K2
    and K7 (launches checked, every row printed beside the card), then
    split_data (its assert), train_llm_parle at its defaults (the mean
    loss of the last tenth of the steps is below the first tenth's; the
    checkpoint restores to the same next step) and
    serve_batched on mamba2-1.3b and windowed llama3-8b (no port kernel
    on either path: launches checked)."""
    phase(f"9. the paper on the card: Table 1 ({TABLE1_STEPS} steps, n=3, "
          f"seed 0), Table 2 ({TABLE2_STEPS}), Fig. 1 ({FIG1_STEPS}) "
          "through K1, K2, K7; split_data, train_llm_parle, serve_batched")
    t0 = time.perf_counter()
    walls = {}
    per_seed = [_table1_bitwise(device)]
    table1 = table1_baselines.report(table1_baselines.summarize(per_seed),
                                     TABLE1_STEPS)
    _print_rows("table1", table1, smi)
    walls["table1"] = time.perf_counter() - t0

    t = time.perf_counter()
    reset_launches()
    table2 = table2_split_data.report(table2_split_data.run(
        TABLE2_STEPS, 0, device, use_kernel=True), TABLE2_STEPS)
    launch_counts(**_parle_launches(TABLE2_STEPS, runs=2),
                  elastic_update=2 * TABLE2_STEPS)
    _print_rows("table2", table2, smi)
    walls["table2"] = time.perf_counter() - t

    t = time.perf_counter()
    reset_launches()
    fig1 = fig1_overlap.report(fig1_overlap.run(FIG1_STEPS, 0, device,
                                                use_kernel=True))
    launch_counts(**_parle_launches(FIG1_STEPS))
    _print_rows("fig1", fig1, smi)
    walls["fig1"] = time.perf_counter() - t

    t = time.perf_counter()
    reset_launches()
    split = split_data.main(["--device", "cuda"])
    launch_counts()
    walls["split_data"] = time.perf_counter() - t

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "e2e_parle.npz")
        reset_launches()
        llm = train_llm_parle.run(checkpoint=path, device="cuda")
        launch_counts()
        tenth = len(llm["losses"]) // 10
        first = float(llm["losses"][:tenth].mean())
        last = float(llm["losses"][-tenth:].mean())
        check(last < first, f"train_llm_parle: loss did not fall (mean of "
              f"the first tenth of the steps {first}, of the last {last})")
        _llm_resume_check(llm, path)
    walls["train_llm_parle"] = time.perf_counter() - t
    print("train_llm_parle: loss fell, checkpoint restored, next step "
          "equal bit for bit", flush=True)

    served = {}
    for argv in (["--arch", "mamba2-1.3b"],
                 ["--arch", "llama3-8b", "--window", "64"]):
        t = time.perf_counter()
        reset_launches()
        served[" ".join(argv)] = serve_batched.main(argv + ["--device",
                                                            "cuda"])
        launch_counts()
        walls["serve_batched " + " ".join(argv)] = time.perf_counter() - t

    out = {"split_data": split,
           "train_llm_parle": {
               "loss_first_tenth": first, "loss_last_tenth": last,
               **{k: llm[k] for k in (
                   "params", "progress", "final_avg_model_eval_loss")}},
           "serve_batched": {k: {f: v[f] for f in (
               "tokens_per_s", "warm_s", "compile_s", "family")}
               for k, v in served.items()},
           "walls_s": {k: round(v, 3) for k, v in walls.items()},
           "phase_wall_s": round(time.perf_counter() - t0, 1),
           "total_s": round(time.perf_counter() - t_start, 1),
           "card": smi}
    print(json.dumps({"paper_phase": out}), flush=True)
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
