"""SyncPolicy: how replicas reach consensus.  Port of
``repro/runtime/policies.py`` for the two single-process policies:

* ``barrier`` — every replica runs L inner steps, then the whole fleet
  takes the Eq. 8d sync inside the step/round;
* ``overlap`` — staleness-1: round k's payload is taken at the round's
  start and its consensus applied at the start of round k+1, and an
  end-of-training flush applies the last one.

Both delegate to the Algorithm object (``algo.make_round_fn`` keys off
``pcfg.sync_overlap``), in one process or, with ``mesh=`` (a
``ReplicaGroup``, ``sharding/partition.py``), with the replica axis over
the ranks of a ``torch.distributed`` group.  ``async`` (elastic pods,
ROADMAP.md queue 1 item 7) exits naming the item that ports it.
"""
from __future__ import annotations

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


def policy_for(pcfg=None, name: str = ""):
    """Resolve a standalone policy by explicit name, or from a config's
    ``sync_overlap`` flag — the selection rule the algorithm objects
    themselves key off, so a factory caller holding only a pcfg gets the
    matching policy."""
    n = name or ("overlap" if getattr(pcfg, "sync_overlap", False)
                 else "barrier")
    if n == "barrier":
        return BarrierPolicy()
    if n == "overlap":
        return OverlapPolicy()
    if n == "async":
        raise NotImplementedError("the async sync policy (elastic "
                                  "multi-process pods) is not ported yet "
                                  "(ROADMAP.md queue 1, item 7)")
    raise ValueError(f"no sync policy {n!r} (one of {POLICY_NAMES})")


def resolve_train_policy(args):
    """Map the trainer CLI onto a policy (``--sync-policy``, or the
    historical ``--sync-overlap`` flag), with the reference's guards and
    messages."""
    name = args.sync_policy or ("overlap" if args.sync_overlap
                                else "barrier")
    if name == "async":
        raise SystemExit("--sync-policy async (elastic multi-process pods) "
                         "is not ported yet (ROADMAP.md queue 1, item 7)")
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
