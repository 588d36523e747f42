"""SyncPolicy: how replicas reach consensus.  Port of
``repro/runtime/policies.py`` for the ``barrier`` policy, the only one
ported: every replica runs L inner steps, then the whole fleet takes the
Eq. 8d sync inside the step/round.  ``overlap`` (staleness-1, ROADMAP.md
queue 1 item 4) and ``async`` (elastic pods, item 7) exit naming the
item that ports them.
"""
from __future__ import annotations

POLICY_NAMES = ("barrier", "overlap", "async")


class BarrierPolicy:
    """Consensus inside the step/round, fleet-wide block at every sync
    point.  The program factories delegate to the Algorithm object."""

    name = "barrier"

    def make_step_fn(self, algo, loss_fn, pcfg, *, weight_decay=0.0,
                     use_kernel=False, lr_schedule=None):
        return algo.make_step(loss_fn, pcfg, weight_decay=weight_decay,
                              use_kernel=use_kernel, lr_schedule=lr_schedule)

    def make_round_fn(self, algo, loss_fn, pcfg, *, weight_decay=0.0,
                      use_kernel=False, lr_schedule=None):
        return algo.make_round_fn(loss_fn, pcfg, weight_decay=weight_decay,
                                  use_kernel=use_kernel,
                                  lr_schedule=lr_schedule)


def resolve_train_policy(args):
    """Map the trainer CLI onto a policy (``--sync-policy``, or the
    historical ``--sync-overlap`` flag)."""
    name = args.sync_policy or ("overlap" if args.sync_overlap
                                else "barrier")
    if name == "async":
        raise SystemExit("--sync-policy async (elastic multi-process pods) "
                         "is not ported yet (ROADMAP.md queue 1, item 7)")
    if name == "overlap":
        raise SystemExit("--sync-overlap / --sync-policy overlap is not "
                         "ported yet (ROADMAP.md queue 1, item 4: the "
                         "overlapped sync with kernels K4-K6)")
    return BarrierPolicy()
