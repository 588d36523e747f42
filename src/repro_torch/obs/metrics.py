"""Process-local metrics registry: counters, gauges, histograms.

The registry is plain host-side Python — no jax, no locks on the hot
path beyond series creation — so instrumenting a fused round costs a
few dict operations, not a device sync.  Three series kinds:

* ``Counter`` — monotonically increasing total (steps, tokens,
  admissions).  Counters can be *seeded* from a checkpoint stamp so
  totals resume monotonically across ``--resume`` (see
  :meth:`Registry.restore_counters`).
* ``Gauge`` — last-written value plus an update sequence number (page
  occupancy, per-replica loss).  The sequence number makes the merge
  deterministic and associative: the series with more updates wins,
  ties break on the larger value.
* ``Histogram`` — exact-bucket distribution over fixed upper bounds
  (``value <= bounds[i]`` lands in bucket ``i``; one overflow bucket).
  ``percentile(q)`` returns the upper bound of the bucket holding the
  q-quantile rank — EXACT whenever observations sit on bucket
  boundaries — and the overflow bucket reports the observed max.

Every series is labeled: ``registry.counter("serve.admitted")`` and
``registry.gauge("train.replica_loss", replica=3)`` are distinct
series keyed by ``(name, sorted(labels))``.

Snapshot / merge: :meth:`Registry.snapshot` renders the whole registry
as a JSON-plain dict; :func:`merge_snapshots` folds any number of
snapshots (e.g. one per pod process) into one view.  The merge is
associative and commutative — counters and histogram buckets add,
gauges take the (updates, value)-max — so the coordinator can fold
worker snapshots in any order or grouping and get the same pod view.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Tuple

# 1-2-5 decades from 1 µs-scale to 10^5: a generic latency ladder (ms)
# that is also fine for byte counts at smoke scale.  Callers with a
# known range pass their own bounds.
DEFAULT_BOUNDS = tuple(m * 10.0 ** e for e in range(-3, 6)
                       for m in (1.0, 2.0, 5.0))


def series_key(name: str, labels: dict) -> str:
    """Stable flat key: ``name`` or ``name{a=1,b=x}`` (sorted labels)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("name", "labels", "total")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.total = 0

    def inc(self, n=1) -> None:
        self.total += n

    def to_snapshot(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "total": self.total}


class Gauge:
    __slots__ = ("name", "labels", "value", "updates")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.value = None
        self.updates = 0

    def set(self, value) -> None:
        self.value = value
        self.updates += 1

    def to_snapshot(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "value": self.value, "updates": self.updates}


class Histogram:
    __slots__ = ("name", "labels", "bounds", "bucket_counts", "count",
                 "sum", "min", "max")

    def __init__(self, name: str, labels: dict,
                 bounds: Tuple[float, ...] = DEFAULT_BOUNDS):
        bounds = tuple(float(b) for b in bounds)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.name, self.labels = name, labels
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)   # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value, n: int = 1) -> None:
        """Record ``n`` observations of ``value`` (n > 1: e.g. one
        per-token latency shared by every token of a decode chunk)."""
        if n < 1:
            return
        value = float(value)
        self.bucket_counts[bisect.bisect_left(self.bounds, value)] += n
        self.count += n
        self.sum += value * n
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def percentile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the q-quantile rank
        (q in [0, 100]); exact when observations sit on bounds."""
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            cum += c
            if cum >= rank:
                return self.max if i == len(self.bounds) else self.bounds[i]
        return self.max

    def summary(self) -> dict:
        return {"count": self.count,
                "mean": (self.sum / self.count) if self.count else None,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}

    def to_snapshot(self) -> dict:
        return {"name": self.name, "labels": self.labels,
                "bounds": list(self.bounds),
                "bucket_counts": list(self.bucket_counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "Histogram":
        h = cls(snap["name"], dict(snap.get("labels", {})),
                tuple(snap["bounds"]))
        h.bucket_counts = list(snap["bucket_counts"])
        h.count = snap["count"]
        h.sum = snap["sum"]
        h.min, h.max = snap["min"], snap["max"]
        return h


class Registry:
    """Process-local get-or-create home of every labeled series."""

    def __init__(self):
        self._series: Dict[Tuple[str, str], object] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, cls, name: str, labels: dict, *extra):
        key = (kind, series_key(name, labels))
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, cls(name, labels, *extra))
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", Gauge, name, labels)

    def histogram(self, name: str, bounds: Tuple[float, ...] = DEFAULT_BOUNDS,
                  **labels) -> Histogram:
        return self._get("hist", Histogram, name, labels, bounds)

    def snapshot(self) -> dict:
        """JSON-plain view of every series (deterministic ordering)."""
        out = {"counters": [], "gauges": [], "hists": []}
        for (kind, _), s in sorted(self._series.items(),
                                   key=lambda kv: kv[0]):
            dest = {"counter": "counters", "gauge": "gauges",
                    "hist": "hists"}[kind]
            out[dest].append(s.to_snapshot())
        return out

    def counter_stamp(self) -> List[dict]:
        """The counters alone, as a checkpoint-sidecar stamp."""
        return self.snapshot()["counters"]

    def restore_counters(self, stamp: List[dict]) -> None:
        """Seed counters from a checkpoint stamp so totals continue
        monotonically across ``--resume`` instead of restarting at 0."""
        for e in stamp or []:
            self.counter(e["name"], **e.get("labels", {})).inc(e["total"])


def _merge2(a: dict, b: dict) -> dict:
    by_key = {}
    for snap in (a, b):
        for kind in ("counters", "gauges", "hists"):
            for e in snap.get(kind, []):
                key = (kind, series_key(e["name"], e.get("labels", {})))
                cur = by_key.get(key)
                if cur is None:
                    by_key[key] = _copy_entry(kind, e)
                else:
                    _fold(kind, cur, e)
    out = {"counters": [], "gauges": [], "hists": []}
    for (kind, _), e in sorted(by_key.items(), key=lambda kv: kv[0]):
        out[kind].append(e)
    return out


def _copy_entry(kind: str, e: dict) -> dict:
    e = dict(e)
    if kind == "hists":
        e["bounds"] = list(e["bounds"])
        e["bucket_counts"] = list(e["bucket_counts"])
    return e


def _fold(kind: str, cur: dict, e: dict) -> None:
    if kind == "counters":
        cur["total"] += e["total"]
    elif kind == "gauges":
        # (updates, value)-max: a total order, so folding is associative
        ck = (cur["updates"], _ordkey(cur["value"]))
        ek = (e["updates"], _ordkey(e["value"]))
        if ek > ck:
            cur["value"], cur["updates"] = e["value"], e["updates"]
    else:
        if list(cur["bounds"]) != list(e["bounds"]):
            raise ValueError(
                f"histogram {series_key(e['name'], e.get('labels', {}))!r} "
                f"merged with mismatched bounds")
        cur["bucket_counts"] = [x + y for x, y in
                                zip(cur["bucket_counts"],
                                    e["bucket_counts"])]
        cur["count"] += e["count"]
        cur["sum"] += e["sum"]
        cur["min"] = _opt(min, cur["min"], e["min"])
        cur["max"] = _opt(max, cur["max"], e["max"])


def _ordkey(v):
    return -math.inf if v is None else float(v)


def _opt(fn, a, b):
    if a is None:
        return b
    if b is None:
        return a
    return fn(a, b)


def merge_snapshots(*snaps: dict) -> dict:
    """Fold any number of registry snapshots into one (associative)."""
    out = {"counters": [], "gauges": [], "hists": []}
    for s in snaps:
        out = _merge2(out, s)
    return out


def snapshot_summaries(snap: dict) -> dict:
    """Human/report view of a snapshot: flat series key -> summary."""
    out = {}
    for e in snap.get("counters", []):
        out[series_key(e["name"], e.get("labels", {}))] = {
            "kind": "counter", "total": e["total"]}
    for e in snap.get("gauges", []):
        out[series_key(e["name"], e.get("labels", {}))] = {
            "kind": "gauge", "value": e["value"]}
    for e in snap.get("hists", []):
        out[series_key(e["name"], e.get("labels", {}))] = dict(
            kind="hist", **Histogram.from_snapshot(e).summary())
    return out
