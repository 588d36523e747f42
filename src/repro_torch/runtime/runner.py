"""RoundRunner: the one step/round execution loop behind the train
entry point.  Port of ``repro/runtime/runner.py`` (the single-process loops).

It owns batch staging, spans, obs counters/histograms, progress
emission and checkpointing, namespaced per entry point (``train.*`` metric
series); the caller injects what differs through small hooks
(``batch_fn`` / ``stage_fn``, ``progress``, ``pre_round`` /
``on_round``, ``pre_step`` / ``on_step``), the async policy's
``post_round`` (its coordinator exchange) and the overlap policy's
``flush_fn``.  Under a ``ReplicaGroup`` of ranks (``group=``) every rank
runs the loop and counts the tokens of its own replicas, only rank 0
prints progress, and a checkpoint gathers the ranks' rows into the one
file rank 0 writes.  Under a ``MeshGroups`` (axes inside a replica) only
the world's rank 0 prints, and a checkpoint gathers each leaf's blocks
inside the replicas, then the replicas' rows, into that same file.

Spans end on ``torch.cuda.synchronize`` (``Span.block``), the
counterpart of the reference's ``block_until_ready``.  There is no AOT
compile and no HLO to count bytes in: eager PyTorch compiles nothing,
and the CUDA kernels are built at their first launch.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, NamedTuple, Optional

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.sharding.partition import distributed


class CheckpointSpec(NamedTuple):
    """Where/when the runner checkpoints, and how the sidecar is
    stamped.  ``every`` <= 0 or an empty ``dir`` disables saving.
    ``pspecs``: the algorithm's ``state_pspecs`` (which fields carry the
    replica axis), needed under a group of several ranks."""
    dir: str = ""
    every: int = 0
    algo: str = ""
    arch: str = ""
    pspecs: Optional[dict] = None


class RoundRunner:
    """Owns the step/round loop for one process; ``ns`` prefixes
    every metric series."""

    def __init__(self, obs, ns: str = "train",
                 checkpoint: Optional[CheckpointSpec] = None, group=None):
        self.obs = obs
        self.ns = ns
        self.checkpoint = checkpoint
        self.group = group if distributed(group) else None
        self.prints = group is None or group.rank == 0   # the world's rank

    def _report(self, progress, *args, history):
        rec = progress(*args)
        if self.prints:
            print(json.dumps(rec), flush=True)
        history.append(rec)

    # -- checkpointing --------------------------------------------
    def _save(self, state, gstep: int):
        """One checkpoint, in a ``checkpoint`` span.  Under a group of
        several ranks every rank takes part (its rows, or its blocks, are
        gathered), rank 0 writes the file with its counter stamp (the
        span's ``write_s``: its writes, digest and sidecar), and every
        rank leaves once it is written."""
        ck = self.checkpoint
        path = f"{ck.dir}/step{gstep:06d}.npz"
        reg = self.obs.registry
        with self.obs.tracer.span("checkpoint", cat="io", step=gstep) as sp:
            if self.group is None:
                ckpt.save(path, state, step=gstep, meta={"arch": ck.arch},
                          algo=ck.algo, metrics=reg.counter_stamp())
            else:
                sp.set(**ckpt.save_rows(
                    path, state, self.group, ck.pspecs, step=gstep,
                    meta={"arch": ck.arch}, algo=ck.algo,
                    metrics=reg.counter_stamp))
        self.obs.emit("checkpoint", step=gstep, path=path)

    def _ckpt_enabled(self) -> bool:
        ck = self.checkpoint
        return bool(ck and ck.every and ck.dir)

    # -- per-step loop --------------------------------------------
    def run_steps(self, state, step_fn, batch_fn: Callable[[int], Any], *,
                  start: int, steps: int, L: int, tokens_per_step: int,
                  span_cat: str = "", progress_every: int = 0, progress=None,
                  on_step=None, pre_step=None):
        """The per-step loop.  ``progress(step, round, state, metrics)``
        -> record is invoked every ``progress_every`` steps and on the
        first step, printed, and collected into the returned history.
        ``pre_step(i)`` runs before step i; ``on_step(i, metrics, sp)``
        inside its span, before the span blocks on the metrics."""
        obs, ns = self.obs, self.ns
        history = []
        for i in range(start, start + steps):
            if pre_step is not None:
                pre_step(i)
            with obs.tracer.span("step", cat=span_cat, step=i + 1) as sp:
                batch = batch_fn(i)
                state, metrics = step_fn(state, batch)
                if on_step is not None:
                    on_step(i, metrics, sp)
                sp.block(metrics)
            obs.registry.counter(f"{ns}.steps").inc()
            obs.registry.counter(f"{ns}.tokens").inc(tokens_per_step)
            if (i + 1) % L == 0:
                obs.registry.counter(f"{ns}.rounds").inc()
            if obs.enabled:
                obs.registry.histogram(f"{ns}.step_ms").observe(
                    sp.dur_s * 1e3)
            if progress is not None and ((i + 1) % progress_every == 0
                                         or i == start):
                self._report(progress, i + 1, (i + 1) // L, state, metrics,
                             history=history)
            if self._ckpt_enabled() and (i + 1) % self.checkpoint.every == 0:
                self._save(state, i + 1)
        return state, history

    # -- round loop -----------------------------------------------
    def run_rounds(self, state, round_fn, stage_fn: Callable[[int], Any], *,
                   start: int, rounds: int, L: int, tokens_per_round: int,
                   progress_every: int = 1, progress=None, on_round=None,
                   pre_round=None, post_round=None, flush_fn=None):
        """One ``round_fn`` call per L steps; the next round's batches
        are staged right after the round is enqueued, before the round
        span blocks on its results.  ``pre_round(r)`` runs before round
        r is enqueued; ``post_round(state, r, gstep, metrics) -> state``
        after its span (the async policy's coordinator exchange), then
        ``on_round(r, gstep, metrics)``.
        ``flush_fn(state) -> state`` (the overlap policy's) runs once
        after the last round, as a ``sync_flush`` span with a
        ``staleness_flush`` event."""
        obs, ns = self.obs, self.ns
        history = []
        nxt = stage_fn(start) if rounds else None
        for r in range(rounds):
            if pre_round is not None:
                pre_round(r)
            cur, nxt = nxt, None
            gstep = start + (r + 1) * L
            with obs.tracer.span("round", round=r + 1, step=gstep) as sp:
                state, metrics = round_fn(state, cur)
                if r + 1 < rounds:
                    nxt = stage_fn(start + (r + 1) * L)
                sp.block(metrics)
            obs.registry.counter(f"{ns}.steps").inc(L)
            obs.registry.counter(f"{ns}.rounds").inc()
            obs.registry.counter(f"{ns}.tokens").inc(tokens_per_round)
            if obs.enabled:
                obs.registry.histogram(f"{ns}.round_ms").observe(
                    sp.dur_s * 1e3)
            if post_round is not None:
                state = post_round(state, r, gstep, metrics)
            if on_round is not None:
                on_round(r, gstep, metrics)
            if progress is not None and ((r + 1) % progress_every == 0
                                         or r == 0):
                self._report(progress, gstep, r + 1, state, metrics,
                             history=history)
            # a round advances L steps at once: checkpoint whenever it
            # CROSSES a checkpoint_every boundary
            if (self._ckpt_enabled()
                    and gstep // self.checkpoint.every
                    > (gstep - L) // self.checkpoint.every):
                self._save(state, gstep)
        # the overlap policy leaves the last round's consensus in
        # flight: apply it once before eval/deploy.  Checkpoints above
        # stay pre-flush — a resumed run re-enters the overlap loop,
        # which applies the carried consensus itself (flushing a
        # checkpointed state would apply it twice on resume)
        if flush_fn is not None:
            with obs.tracer.span("sync_flush", cat="sync") as sp:
                state = flush_fn(state)
                sp.block(state.x)
            obs.registry.counter(f"{ns}.staleness_flushes").inc()
            obs.emit("staleness_flush", step=start + rounds * L,
                     flush_ms=round(sp.dur_s * 1e3, 3))
        return state, history


def emit_progress(obs, algo, state, metrics, step, rnd, t0, group=None):
    """ONE schema for every progress emit site: kind=train_progress
    with the same key set — ``round`` is the number of completed Eq. 8
    rounds.  Per-replica losses (when the step emits them) land as
    labeled gauges.  ``group``: the ranks' ReplicaGroup (the diagnostics
    then leave out what would gather the model)."""
    diag = {k: round(v, 4)
            for k, v in algo.diagnostics(state, group=group).items()}
    rec = obs.emit("train_progress", step=step, round=rnd,
                   loss=round(float(metrics["loss"]), 4),
                   wall_s=round(time.time() - t0, 1), diag=diag)
    if obs.enabled:
        obs.registry.gauge("train.loss").set(rec["loss"])
        for k, v in diag.items():
            obs.registry.gauge(f"train.diag.{k}").set(v)
        per = metrics.get("loss_per_replica", metrics.get("losses"))
        if per is not None:
            for j, lv in enumerate(per.detach().cpu().reshape(-1).tolist()):
                obs.registry.gauge("train.replica_loss",
                                   replica=j).set(round(lv, 6))
    return rec
