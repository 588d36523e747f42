"""Deterministic chaos harness for the async/elastic pod.  A copy of
``repro/runtime/faults.py`` (the port imports nothing of the JAX
package): the same plan gives the same schedule in either package.

A :class:`FaultPlan` is a seeded script of failures injected into
dist_run workers and the consensus coordinator via ``--fault-plan``
(inline JSON or ``@file``).  Everything a plan does is a pure function
of ``(seed, fault spec)`` — sampled values (delay jitter) come from a
per-(worker, round, kind) RNG derived with version-2 string seeding, so
the same plan replays bit-for-bit across processes and reruns, and
:meth:`FaultPlan.schedule` renders the exact event sequence a worker
will experience without running anything.

Fault kinds (``round`` is the 1-based global consensus round — the
``round_idx`` the worker's exchange for that round carries):

* ``crash``            — the worker emits a ``fault_injected`` event and
  dies with ``os._exit(CRASH_RC)`` at the start of round ``round``
  (no finalize, no leave: the coordinator sees a dead socket and the
  pod parent a nonzero exit it TOLERATES because the plan names it).
* ``hang``             — full-process freeze for ``ms`` at round start:
  the client's heartbeats stop too (a sleeping main thread with live
  heartbeats would be a healthy-slow worker, not a hung one), so a
  hang past the coordinator's liveness deadline gets the worker
  evicted from the consensus table.
* ``drop_conn``        — sever the client socket before the round's
  exchange, exercising reconnect + transparent rejoin + idempotent
  retry.
* ``corrupt_frame``    — the round's FIRST exchange frame is sent with
  payload bytes flipped after the CRC was computed; the coordinator
  rejects it (``bad_frame``) and the client re-sends clean.
* ``poison``           — the round's contribution is NaN-poisoned
  before the push (first leaf), exercising the coordinator's
  quarantine + the worker's reseed-from-consensus recovery.
* ``delay_jitter``     — sleep ``uniform(0, ms)`` at round start,
  sampled deterministically from the plan seed.
* ``coordinator_kill`` — the pod parent's supervisor severs every
  coordinator socket and discards its in-memory state when the
  consensus reaches ``round``, waits ``down_ms``, and restarts it from
  the newest valid periodic checkpoint (workers rejoin transparently).
"""
from __future__ import annotations

import json
import os
import random
import sys
import time
from typing import List, Optional

import numpy as np

#: exit code of a plan-scripted worker crash — the pod parent tolerates
#: exactly the workers the plan names, at exactly this code
CRASH_RC = 57

WORKER_KINDS = ("crash", "hang", "drop_conn", "corrupt_frame", "poison",
                "delay_jitter")
COORD_KINDS = ("coordinator_kill",)
KINDS = WORKER_KINDS + COORD_KINDS


def _rng(seed, *parts) -> random.Random:
    """Deterministic per-event RNG: version-2 string seeding hashes via
    sha512, so it is stable across processes (unlike ``hash()``)."""
    return random.Random(":".join(str(p) for p in (seed,) + parts))


def _validate(fault: dict) -> dict:
    kind = fault.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unknown fault kind {kind!r} (one of {KINDS})")
    if not isinstance(fault.get("round"), int) or fault["round"] < 1:
        raise ValueError(f"fault {kind!r} needs a 1-based integer 'round'")
    if kind in WORKER_KINDS and not isinstance(fault.get("worker"), int):
        raise ValueError(f"fault {kind!r} needs an integer 'worker'")
    if kind in ("hang", "delay_jitter") and fault.get("ms", 0) <= 0:
        raise ValueError(f"fault {kind!r} needs a positive 'ms'")
    return fault


class FaultPlan:
    """A validated, seeded fault script (see module docstring)."""

    def __init__(self, seed: int = 0, faults: Optional[list] = None):
        self.seed = int(seed)
        self.faults = [_validate(dict(f)) for f in (faults or [])]

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse ``--fault-plan``: inline JSON, or ``@path`` to a JSON
        file.  The object form is ``{"seed": 0, "faults": [...]}``; a
        bare list is shorthand for seed-0 faults."""
        text = spec.strip()
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        obj = json.loads(text)
        if isinstance(obj, list):
            return cls(0, obj)
        return cls(obj.get("seed", 0), obj.get("faults", []))

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "faults": self.faults})

    # -- resolution ------------------------------------------------
    def _worker_faults(self, worker: int, kind: str) -> dict:
        return {f["round"]: f for f in self.faults
                if f["kind"] == kind and f.get("worker") == worker}

    def jitter_ms(self, worker: int, rnd: int, ms: float) -> float:
        return _rng(self.seed, worker, rnd, "delay_jitter").uniform(0.0, ms)

    def schedule(self, worker: int, rounds: int) -> List[dict]:
        """The exact per-round event sequence worker ``worker`` will
        experience over global rounds 1..rounds — sampled values
        included.  Pure: two plans with the same (seed, faults) return
        identical schedules; this is what the determinism test pins."""
        out = []
        for f in self.faults:
            if f.get("worker") != worker or f["round"] > rounds:
                continue
            ev = {"round": f["round"], "kind": f["kind"]}
            if f["kind"] == "delay_jitter":
                ev["sleep_ms"] = round(
                    self.jitter_ms(worker, f["round"], f["ms"]), 6)
            elif f["kind"] == "hang":
                ev["sleep_ms"] = float(f["ms"])
            out.append(ev)
        return sorted(out, key=lambda e: (e["round"], e["kind"]))

    def worker_faults(self, worker: int) -> "WorkerFaults":
        return WorkerFaults(self, worker)

    def coordinator_kills(self) -> List[dict]:
        return sorted((f for f in self.faults
                       if f["kind"] == "coordinator_kill"),
                      key=lambda f: f["round"])

    def crash_workers(self) -> set:
        """Worker indices the plan crashes — the pod parent tolerates
        exactly these exiting with :data:`CRASH_RC`."""
        return {f["worker"] for f in self.faults if f["kind"] == "crash"}


class WorkerFaults:
    """One worker's injection surface, driven by the dist_run worker
    loop: :meth:`pre_round` fires round-start faults (crash / hang /
    drop_conn / delay_jitter), :meth:`poison` / :meth:`corrupt` are
    checked by the exchange path."""

    def __init__(self, plan: FaultPlan, worker: int):
        self.plan = plan
        self.worker = worker
        self._crash = plan._worker_faults(worker, "crash")
        self._hang = plan._worker_faults(worker, "hang")
        self._drop = plan._worker_faults(worker, "drop_conn")
        self._jitter = plan._worker_faults(worker, "delay_jitter")
        self._corrupt = plan._worker_faults(worker, "corrupt_frame")
        self._poison = plan._worker_faults(worker, "poison")
        self.events: List[dict] = []     # fired faults, in firing order

    def _fire(self, obs, rnd: int, kind: str, **extra) -> dict:
        ev = {"round": rnd, "kind": kind, **extra}
        self.events.append(ev)
        if obs is not None:
            obs.emit("fault_injected", fault=kind, round=rnd,
                     worker=self.worker, **extra)
        return ev

    def pre_round(self, rnd: int, client=None, obs=None) -> None:
        """Round-start injection for global round ``rnd`` (1-based).
        Order: jitter, drop, hang, crash — so a crash is always the
        last thing a round's script does."""
        f = self._jitter.get(rnd)
        if f is not None:
            ms = self.plan.jitter_ms(self.worker, rnd, f["ms"])
            self._fire(obs, rnd, "delay_jitter", sleep_ms=round(ms, 3))
            time.sleep(ms / 1e3)
        if rnd in self._drop:
            self._fire(obs, rnd, "drop_conn")
            if client is not None:
                client.drop_connection()
        f = self._hang.get(rnd)
        if f is not None:
            self._fire(obs, rnd, "hang", sleep_ms=float(f["ms"]))
            if client is not None:
                client.freeze(f["ms"])       # beats stop + main sleeps
            else:
                time.sleep(f["ms"] / 1e3)
        if rnd in self._crash:
            self._fire(obs, rnd, "crash")
            sys.stderr.write(f"worker {self.worker}: injected crash at "
                             f"round {rnd}\n")
            sys.stderr.flush()
            # abrupt: no finalize, no leave — the event line above is on
            # disk (per-event flush) and everything else is lost, which
            # is the post-mortem contract the chaos lane asserts
            os._exit(CRASH_RC)

    def poison(self, rnd: int, obs=None) -> bool:
        if rnd in self._poison:
            self._fire(obs, rnd, "poison")
            return True
        return False

    def corrupt(self, rnd: int, obs=None) -> bool:
        if rnd in self._corrupt:
            self._fire(obs, rnd, "corrupt_frame")
            return True
        return False


def poison_payload(payload: list) -> list:
    """NaN-poison a contribution in place (the first leaf's quantized
    block — scales when the codec has them, so int8 payloads poison
    too).  Returns the payload for chaining."""
    leaf = payload[0]
    if leaf.get("scales") is not None:
        leaf["scales"] = np.full_like(np.asarray(leaf["scales"]), np.nan)
    else:
        leaf["q"] = np.full_like(np.asarray(leaf["q"], np.float32), np.nan)
    return payload
