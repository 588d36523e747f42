"""The statistics the benchmark reports and the arithmetic of intervals."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0 < q < 100) by nearest rank over every
    value, missing ones (``math.inf``) included: the value at rank
    ceil(q/100 · n) of the sorted list."""
    vals = sorted(values)
    if not vals:
        return math.inf
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
