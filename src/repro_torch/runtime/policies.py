"""SyncPolicy: how replicas reach consensus.  Port of
``repro/runtime/policies.py``:

* ``barrier`` — every replica runs L inner steps, then the whole fleet
  takes the Eq. 8d sync inside the step/round;
* ``overlap`` — staleness-1: round k's payload is taken at the round's
  start and its consensus applied at the start of round k+1, and an
  end-of-training flush applies the last one;
* ``async`` — asynchronous/elastic: each ``launch/dist_run.py`` worker
  pushes its (quantized) x+e contribution to the host-side coordinator
  when ITS round ends and pulls the latest staleness-weighted consensus,
  with no barrier; workers may join and leave mid-run.

Barrier and overlap delegate to the Algorithm object
(``algo.make_round_fn`` keys off ``pcfg.sync_overlap``), in one process
or, with ``mesh=`` (a ``ReplicaGroup``, ``sharding/partition.py``), with
the replica axis over the ranks of a ``torch.distributed`` group, or (a
``MeshGroups``) with axes inside a replica too.  The
async policy's round is consensus-free (inner steps only) and its
exchange runs after the round as a ``RoundRunner.post_round`` hook.
"""
from __future__ import annotations

import time

from repro_torch.core import parle
from repro_torch.runtime import faults as faults_mod
from repro_torch.sharding.partition import in_replica

ASYNC_IN_REPLICA = (
    "--sync-policy async with an axis inside a replica ({axes}) is refused "
    "(ROADMAP.md queue 1, item 6d), as the reference refuses the async "
    "policy on any mesh: its workers are single-process (the pod "
    "launcher's) and build no mesh; use --sync-policy barrier or overlap "
    "on this mesh")

POLICY_NAMES = ("barrier", "overlap", "async")


class SyncPolicy:
    """Step/round program factories for one consensus schedule; they
    delegate to the registered Algorithm object."""

    name = "barrier"

    def make_step_fn(self, algo, loss_fn, pcfg, *, mesh=None,
                     weight_decay=0.0, use_kernel=False, lr_schedule=None):
        """The per-step program; with ``mesh`` the algorithm's sharded
        step."""
        kw = dict(weight_decay=weight_decay, use_kernel=use_kernel,
                  lr_schedule=lr_schedule)
        if mesh is not None:
            return algo.make_sharded_step(loss_fn, pcfg, mesh, **kw)
        return algo.make_step(loss_fn, pcfg, **kw)

    def make_round_fn(self, algo, loss_fn, pcfg, *, mesh=None,
                      weight_decay=0.0, use_kernel=False, lr_schedule=None):
        """The fused L-step round program."""
        return algo.make_round_fn(loss_fn, pcfg, mesh=mesh,
                                  weight_decay=weight_decay,
                                  use_kernel=use_kernel,
                                  lr_schedule=lr_schedule)

    def make_flush_fn(self, algo, pcfg, lr_schedule=None):
        """End-of-training flush, or None when nothing is in flight."""
        return algo.make_round_flush_fn(pcfg, lr_schedule=lr_schedule)


class BarrierPolicy(SyncPolicy):
    """Consensus inside the step/round, fleet-wide block at every sync
    point."""
    name = "barrier"


class OverlapPolicy(SyncPolicy):
    """Staleness-1 overlapped consensus (requires ``pcfg.sync_overlap``:
    the algorithm builds the overlapped round and a non-None flush from
    the same flag)."""
    name = "overlap"


class AsyncElasticPolicy(SyncPolicy):
    """Asynchronous / elastic consensus for dist_run workers.

    The round is ``parle.make_inner_round_fn`` (8a-8b only, no
    collective; K1 each step with ``use_kernel``).  After each round the
    worker:

    1. builds its contribution (``parle.async_contribution``: per-leaf
       flat vectors of x+e under the active ``--sync-compress`` codec,
       refreshing the error-feedback residual),
    2. exchanges it with the host-side coordinator — the only wait is
       the RPC round trip, the measured ``pod.sync_wait_ms``,
    3. applies the staleness-weighted consensus it got back
       (``parle.make_async_apply_fn``).

    :meth:`exchange` is ``RoundRunner.run_rounds``'s ``post_round``
    hook."""

    name = "async"

    def __init__(self, client, pcfg, obs, worker: int,
                 lr_schedule=None, faults=None):
        self.client = client
        self.pcfg = pcfg
        self.obs = obs
        self.worker = worker
        self.lr_schedule = lr_schedule
        self.faults = faults            # WorkerFaults | None (chaos)
        self._apply = None
        self.exchanges = 0
        self.quarantined = 0
        self.last_reply = None

    def make_step_fn(self, algo, loss_fn, pcfg, *, mesh=None,
                     weight_decay=0.0, use_kernel=False, lr_schedule=None):
        raise SystemExit("--sync-policy async is round-fused only: the "
                         "consensus exchange happens at round boundaries "
                         "(there is no per-step program to build)")

    def make_round_fn(self, algo, loss_fn, pcfg, *, mesh=None,
                      weight_decay=0.0, use_kernel=False, lr_schedule=None):
        if in_replica(mesh) is not None:
            raise SystemExit(ASYNC_IN_REPLICA.format(
                axes=",".join(mesh.inner_axes)))
        if mesh is not None:
            raise SystemExit("--sync-policy async runs each worker on its "
                             "local devices (no global mesh); drop --mesh")
        return parle.make_inner_round_fn(
            loss_fn, pcfg, weight_decay=weight_decay,
            use_kernel=use_kernel, lr_schedule=lr_schedule)

    def make_flush_fn(self, algo, pcfg, lr_schedule=None):
        return None     # consensus is applied eagerly after every round

    def exchange(self, state, r, gstep, metrics):
        """``post_round`` hook: push x+e, pull the consensus, apply it.
        The RPC's duration is the whole synchronization cost, recorded
        per worker so the merged pod snapshot carries the straggler
        evidence."""
        obs = self.obs
        rnd = r + 1
        # the residual e is refreshed in place (a quarantine zeroes it)
        payload, _ = parle.async_contribution(state, self.pcfg)
        corrupt = bool(self.faults is not None
                       and self.faults.corrupt(rnd, obs))
        if self.faults is not None and self.faults.poison(rnd, obs):
            faults_mod.poison_payload(payload)
        t0 = time.perf_counter()
        reply = self.client.exchange(payload, round_idx=rnd,
                                     corrupt_first=corrupt)
        wait_ms = (time.perf_counter() - t0) * 1e3
        del payload
        self.exchanges += 1
        self.last_reply = reply
        if obs.enabled:
            obs.registry.histogram(
                "pod.sync_wait_ms", worker=self.worker).observe(wait_ms)
            obs.registry.gauge("pod.staleness").set(reply["staleness"])
            obs.registry.gauge("pod.n_active").set(reply["n_active"])
        if reply.get("quarantined"):
            # the coordinator refused this contribution (NaN/Inf or a
            # norm outlier) and told us to restart from consensus: drop
            # the (poisoned) residual and re-seed y/x/z
            self.quarantined += 1
            obs.registry.counter("pod.quarantined_updates",
                                 worker=self.worker).inc()
            obs.emit("worker_quarantined", worker=str(self.worker),
                     reason=reply.get("reason", ""))
            if reply["consensus"] is None:
                return state        # nothing to re-seed from yet
            xbar = parle.consensus_from_flat(reply["consensus"], state)
            return parle.reseed_from_consensus(state, xbar)
        if self._apply is None:
            self._apply = parle.make_async_apply_fn(
                self.pcfg, lr_schedule=self.lr_schedule)
        xbar = parle.consensus_from_flat(reply["consensus"], state)
        return self._apply(state, xbar)


def policy_for(pcfg=None, name: str = ""):
    """Resolve a STANDALONE policy (one that needs no coordinator) by
    explicit name, or from a config's ``sync_overlap`` flag — the
    selection rule the algorithm objects themselves key off, so a
    factory caller holding only a pcfg gets the matching policy."""
    n = name or ("overlap" if getattr(pcfg, "sync_overlap", False)
                 else "barrier")
    if n == "barrier":
        return BarrierPolicy()
    if n == "overlap":
        return OverlapPolicy()
    raise ValueError(f"no standalone sync policy {n!r} (async needs a "
                     "CoordinatorClient — construct AsyncElasticPolicy "
                     "directly)")


def resolve_train_policy(args):
    """Map the trainer CLI onto a policy (``--sync-policy``, or the
    historical ``--sync-overlap`` flag), with the reference's guards and
    messages."""
    name = args.sync_policy or ("overlap" if args.sync_overlap
                                else "barrier")
    if name == "async":
        raise SystemExit("--sync-policy async is a multi-process pod mode; "
                         "run it through repro_torch.launch.dist_run (each "
                         "worker needs its own process + the host-side "
                         "coordinator)")
    if name == "overlap":
        args.sync_overlap = True     # downstream cfg plumbing keys off it
        if not args.round_fused:
            raise SystemExit("--sync-overlap requires --round-fused (the "
                             "overlapped collective is issued at fused-round "
                             "boundaries; the per-step path always barriers)")
        if args.algo not in ("parle", "entropy_sgd"):
            raise SystemExit(f"--sync-overlap is a Parle Eq. 8d feature; "
                             f"--algo {args.algo} has no round-level sync to "
                             f"overlap")
    return policy_for(name=name)
