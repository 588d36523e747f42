"""The numbers that decide ``correct``, each held to its limit.

Training, from the readings of the program's first rounds and of the
plain reference over the same weights and batches (``reference/
parle.py::run_rounds`` says what each reading is):

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  sync's g_x (Eq. 8c, as the outer optimizer gets it), against the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change_gap``: the same of each leaf's change over the checked
  rounds, leaving out the leaves whose reference gradient is nought to
  rounding (under a thousandth of the median leaf's: a key's bias under
  the softmax moves by round-off alone).

Serving, from a sample of the finished requests: ``served_gap``, the
widest gap by which a served token's logit lies below the reference's
best at its position (greedy decoding serves the best); ``wrong_length``,
the answers whose length is not the requested one; ``missing``, the
requests due in the window that never finished.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3          # a leaf's gradient under this share of the median's


def _leaf_gaps(prog, ref, keep=None):
    """|‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖) of every (replica, leaf)."""
    pairs = [(p, r) for pa, ra, ka in zip(prog, ref, keep or [None] * len(ref))
             for j, (p, r) in enumerate(zip(pa, ra))
             if ka is None or ka[j]]
    med = statistics.median(r for _, r in pairs)
    return [abs(p - r) / max(r, med) if math.isfinite(p) else math.inf
            for p, r in pairs]


def _loss_gap(prog, ref):
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    return max(gaps) if all(map(math.isfinite, gaps)) else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training numbers; each cell's limits file names the ones it
    compares.  ``change_gap_median`` is the median leaf's change gap,
    which stays steady where one small leaf's noise swings the worst
    leaf's from seed to seed (PERF.md §6)."""
    med = statistics.median(r for row in ref["grad"] for r in row)
    keep = [[r >= NOUGHT * med for r in row] for row in ref["grad"]]
    change = _leaf_gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": _loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"])),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}


def worst(prog: dict, ref: dict) -> dict:
    """Where each training number reads its worst: the step of the loss
    gap, and (replica, leaf) of the two norm gaps, with each step's gap
    (for ``calibrate.py``)."""
    steps = [abs(p - r) / abs(r)
             for p, r in zip(prog["losses"], ref["losses"])]

    med_g = statistics.median(r for row in ref["grad"] for r in row)

    def arg(p_rows, r_rows, keep=lambda a, j: True):
        med = statistics.median(r for a, row in enumerate(r_rows)
                                for j, r in enumerate(row) if keep(a, j))
        return max(((abs(p - r) / max(r, med), a, j)
                    for a, (pa, ra) in enumerate(zip(p_rows, r_rows))
                    for j, (p, r) in enumerate(zip(pa, ra))
                    if keep(a, j)))[1:]

    return {"loss_steps": steps, "grad_at": arg(prog["grad"], ref["grad"]),
            "change_at": arg(prog["change"], ref["change"],
                             lambda a, j: ref["grad"][a][j]
                             >= NOUGHT * med_g)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; the checks
    as {name: {"value", "limit"}} in the limits' order."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def lines(checks: dict) -> list:
    """The checks as the lines a run prints last on standard error."""
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]
