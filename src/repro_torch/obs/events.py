"""Versioned JSONL event sink — THE structured-record surface of the
train / serve / dist_run entry points.

Before this module each entry point printed its own loose ``json.dumps``
dicts with drifting key sets (launch/train.py's two progress sites
disagreed on keys for the same concept).  Every record now goes
through :meth:`EventSink.emit`, which stamps the common envelope —
``v`` (schema version), ``kind``, ``ts`` (unix seconds) — validates
the kind's required fields, and appends one JSON line to the
``--metrics-out`` file.  Drivers that also print to stdout print the
*returned* record, so the console line and the file line are the same
object.

The schema is intentionally open: unknown EXTRA fields are allowed
(forward compatibility), unknown KINDS and missing/ill-typed required
fields are not.  :func:`read_events` re-validates on load, so a file
that round-trips is schema-valid by construction.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import IO, List, Optional

SCHEMA_VERSION = 1

_NUM = (int, float)

# kind -> {required field: type-or-tuple}.  The envelope (v/kind/ts) is
# required everywhere.  ``None`` in a tuple marks a nullable field.
KINDS = {
    # free-form one-off records (run config echo, human notes)
    "run_config": {},
    "note": {"msg": str},
    "mesh": {"mesh": dict},
    # training: ONE schema for both progress emit sites (per-step and
    # fused-round loops) — same key set, same types
    "train_progress": {"step": int, "round": int, "loss": _NUM,
                       "wall_s": _NUM, "diag": dict},
    "train_final": {"final_eval_loss": _NUM, "algo": str, "arch": str,
                    "total_wall_s": _NUM},
    "staleness_flush": {"step": int},
    "checkpoint": {"step": int, "path": str},
    "hlo_sync_bytes": {"codec": str, "bytes_by_axis": dict},
    # serving
    "serve_summary": {"phase": str},
    # multi-process pod launcher
    "pod_step": {"step": int, "loss": _NUM, "proc": int},
    "pod_merged": {"processes": int, "snapshot": dict,
                   "missing_workers": int},
    # async/elastic pod membership (coordinator-side)
    "worker_join": {"worker": str, "n_active": int},
    "worker_leave": {"worker": str, "n_active": int},
    # fault tolerance: liveness eviction of a hung worker, quarantine of
    # a poisoned contribution, chaos-harness injections, and a
    # supervisor-driven coordinator restart
    "worker_evicted": {"worker": str, "n_active": int},
    "worker_quarantined": {"worker": str, "reason": str},
    "fault_injected": {"fault": str, "round": int},
    "coordinator_restart": {"round": int, "restarts": int},
    # registry dump (train/serve final state, or per-worker)
    "metrics_snapshot": {"snapshot": dict},
}


def validate_event(rec: dict) -> dict:
    """Validate one record against the schema; returns it unchanged."""
    if not isinstance(rec, dict):
        raise ValueError(f"event must be an object, got {type(rec)}")
    if rec.get("v") != SCHEMA_VERSION:
        raise ValueError(f"unsupported schema version {rec.get('v')!r} "
                         f"(expected {SCHEMA_VERSION})")
    kind = rec.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unknown event kind {kind!r}")
    if not isinstance(rec.get("ts"), _NUM):
        raise ValueError(f"event {kind!r} missing numeric 'ts'")
    for field, typ in KINDS[kind].items():
        if field not in rec:
            raise ValueError(f"event {kind!r} missing required field "
                             f"{field!r}")
        if not isinstance(rec[field], typ):
            raise ValueError(
                f"event {kind!r} field {field!r} has type "
                f"{type(rec[field]).__name__}, expected {typ}")
        # bool passes isinstance(..., int); reject it for numeric fields
        if isinstance(rec[field], bool) and typ in (int, _NUM):
            raise ValueError(f"event {kind!r} field {field!r} is a bool")
    return rec


class EventSink:
    """Append-only JSONL writer (``path=None``: validate-only, no file).

    Thread-safe and flushed per event: the async coordinator emits from
    its per-connection serve threads, the liveness reaper, AND the
    kill/restart supervisor concurrently, and a crashed process must
    leave every line it ever emitted on disk for the post-mortem — a
    buffered tail would be exactly the evidence a crash destroys."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f: Optional[IO] = None
        self._lock = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "w")

    def emit(self, kind: str, **fields) -> dict:
        rec = {"v": SCHEMA_VERSION, "kind": kind,
               "ts": round(time.time(), 3), **fields}
        validate_event(rec)
        with self._lock:
            if self._f is not None:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
        return rec

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def read_events(path: str, tolerate_torn_tail: bool = False) -> List[dict]:
    """Load + re-validate a metrics JSONL file.

    ``tolerate_torn_tail=True`` forgives ONE torn final line — a
    process that died mid-``write`` leaves a truncated last record,
    and the post-mortem reader wants the surviving events, not a parse
    error.  Only the LAST line gets this grace, and only for broken
    JSON: an earlier bad line, or a complete-but-invalid record, is
    still corruption worth raising on."""
    with open(path) as f:
        lines = [(i, ln.strip()) for i, ln in enumerate(f)]
    lines = [(i, ln) for i, ln in lines if ln]
    out = []
    for pos, (i, line) in enumerate(lines):
        try:
            rec = json.loads(line)
        except ValueError as e:
            if tolerate_torn_tail and pos == len(lines) - 1:
                warnings.warn(f"{path}:{i + 1}: dropping torn final "
                              f"line ({e})")
                continue
            raise ValueError(f"{path}:{i + 1}: {e}") from e
        try:
            out.append(validate_event(rec))
        except ValueError as e:
            raise ValueError(f"{path}:{i + 1}: {e}") from e
    return out
