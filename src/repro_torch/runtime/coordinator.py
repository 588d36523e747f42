"""Host-side consensus coordinator for the ``async`` sync policy.  Port
of ``repro/runtime/coordinator.py``: numpy and sockets only (the parent
process of a pod never touches the card), its consensus checkpoints in
the reference's format, so a pod of either package resumes from the
other's.

One parent-process ``Coordinator`` holds the latest staleness-weighted
consensus as flat per-leaf f32 vectors (the reference's tree_flatten
order of the model x, which is the port's ``FlatLayout`` order —
structure-agnostic, so workers of any local layout interoperate).
Each ``dist_run`` worker connects a ``CoordinatorClient`` over a local
``multiprocessing.connection`` socket and speaks five ops:

* ``join``      — announce itself (+ its local replica count); gets the
  current consensus (None on a fresh start), the consensus round, and
  the active-worker count back.  Emits a ``worker_join`` event.
* ``exchange``  — push the worker's dequantize-ready contribution for
  ITS just-finished round, pull the refreshed consensus.  No barrier:
  the reply is computed from whatever the OTHER workers last pushed,
  weighted down by how many rounds behind they are.
* ``leave``     — deregister; the worker's contribution leaves the table
  so the consensus rebalances over the survivors (elastic shrink).
  Emits ``worker_leave``.  A dead connection (EOF) is an implicit
  leave — a crashed worker cannot wedge the consensus.
* ``heartbeat`` — liveness ping from a client-side daemon thread (its
  reply carries the active-worker count, which a pod's workers poll
  at start-up until all of them have joined).  A
  worker whose heartbeats (and exchanges) stop for longer than
  ``liveness_s`` is EVICTED from the consensus table by the reaper —
  the hung-but-not-dead case a socket EOF never catches.  Emits
  ``worker_evicted``.
* ``stop``      — shut the serving loop down.  Clients that reach a
  stopped coordinator get a ``stopped`` error reply and raise
  :class:`CoordinatorStopped` instead of spinning their retry loop.

The consensus math itself — ``staleness_weighted_mean`` with weights
``w_a = count_a * decay ** (r_max - r_a)`` — lives in
``repro_torch.core.parle`` next to the rest of the Eq. 8 math; this
module is only the wire/coordination half.

Fault tolerance:

* Every message travels as a length+CRC32-framed pickle inside the
  ``multiprocessing.connection`` transport; a frame whose checksum
  does not match is rejected with a retryable ``bad_frame`` reply and
  the client re-sends it, so a flipped bit never reaches the table.
* ``exchange`` is idempotent: the reply for each (worker, round) is
  cached, and a duplicate push — the client re-sending after a lost
  reply — returns the cached reply without re-folding the table.
* Contributions carrying NaN/Inf, or a norm more than ``quarantine_k``×
  the trailing-median accepted norm, are quarantined at ingest: they
  never touch the table, the reply tells the worker to re-seed from
  consensus, and ``worker_quarantined`` is emitted (policy counts
  ``pod.quarantined_updates``).
* With ``ck_dir`` set the coordinator checkpoints the consensus on
  every global round advance (atomic, digest-verified — see
  ``repro_torch.checkpoint``); :class:`CoordinatorSupervisor` can kill the
  coordinator mid-run (abruptly severing every socket, discarding all
  in-memory state) and restart it from the newest valid checkpoint on
  the same port — clients transparently reconnect, re-join, and re-send
  the in-flight exchange.

Elastic checkpointing: :meth:`Coordinator.save` writes the consensus
vectors + per-worker contribution stamps through the ordinary flat-npz
checkpoint writer, and :func:`load_consensus` restores them — a pod may
resume with a DIFFERENT worker count because the checkpoint carries the
model-shaped consensus, not any per-worker state layout.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
import random
import select
import socket
import struct
import sys
import threading
import time
import zlib
from collections import deque
from multiprocessing.connection import Client, Listener

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import parle

AUTHKEY = b"repro-async-consensus"
_CHUNK = 1024           # == core.compress.CHUNK (int8 scale granularity)
_HDR = struct.Struct("!II")    # (payload length, CRC32) frame header


class FrameError(RuntimeError):
    """A received frame failed its length or CRC32 check."""


class FrameTimeout(FrameError):
    """No reply frame arrived within the RPC timeout."""


class CoordinatorStopped(RuntimeError):
    """The coordinator was shut down on purpose — not a transient
    failure, so the client must NOT spin its retry loop against it."""


class CoordinatorUnavailable(ConnectionError):
    """The coordinator stayed unreachable past the retry deadline."""


def _send_frame(conn, obj, corrupt: bool = False) -> None:
    """Pickle ``obj`` into a CRC32-framed message.  ``corrupt=True``
    flips one payload byte AFTER the checksum is computed — the chaos
    harness's wire-corruption injection.  The pickle is written behind
    a reserved header in one buffer (no second copy of a model-size
    frame); its length must fit the header's u32."""
    buf = io.BytesIO()
    buf.write(bytes(_HDR.size))
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    with buf.getbuffer() as frame:
        payload = frame[_HDR.size:]
        _HDR.pack_into(frame, 0, len(payload),
                       zlib.crc32(payload) & 0xFFFFFFFF)
        if corrupt:
            payload[len(payload) // 2] ^= 0xFF
        payload.release()
        conn.send_bytes(frame)


def _read_into(fd, view) -> None:
    """Fill ``view`` from ``fd``; EOFError when the peer closed before
    the first byte, OSError when it closed mid-message."""
    pos = 0
    while pos < len(view):
        n = os.readv(fd, [view[pos:]])
        if n == 0:
            if pos == 0:
                raise EOFError
            raise OSError("got end of file during message")
        pos += n


def _recv_message(conn) -> memoryview:
    """One message of a ``multiprocessing.connection`` Connection (its
    framing: a ``!i`` length, or -1 and a ``!Q`` length, then the bytes)
    read straight into one buffer: ``recv_bytes`` reads a model-size
    message in socket-sized chunks through a BytesIO and copies it once
    more."""
    fd = conn.fileno()
    head = bytearray(4)
    _read_into(fd, memoryview(head))
    size, = struct.unpack("!i", head)
    if size == -1:
        head = bytearray(8)
        _read_into(fd, memoryview(head))
        size, = struct.unpack("!Q", head)
    buf = memoryview(bytearray(size))
    _read_into(fd, buf)
    return buf


def _recv_frame(conn, timeout=None):
    """Receive + verify one framed message.  Raises :class:`FrameError`
    on a short/mismatched frame and :class:`FrameTimeout` when nothing
    arrives within ``timeout`` seconds."""
    if timeout is not None and not conn.poll(timeout):
        raise FrameTimeout(f"no frame within {timeout:.1f}s")
    buf = _recv_message(conn)
    if len(buf) < _HDR.size:
        raise FrameError(f"short frame ({len(buf)} bytes)")
    length, crc = _HDR.unpack_from(buf)
    payload = buf[_HDR.size:]
    if len(payload) != length:
        raise FrameError(f"frame length mismatch: header says {length}, "
                         f"got {len(payload)}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise FrameError("frame CRC mismatch")
    return pickle.loads(payload)


def _np_dequant(q, scales, method: str):
    """Host-side (numpy) inverse of ``core.compress.quantize``: the
    coordinator never touches the card, so contributions are decoded
    with the same chunking arithmetic in plain numpy."""
    if method == "none":
        return np.asarray(q, dtype=np.float32)
    if method == "bf16":
        # uint16 bit patterns (numpy has no bfloat16): a bf16 is the top
        # half of its f32, so the shift is the exact dequantizer
        bits = np.asarray(q, np.uint16).astype(np.uint32)
        bits <<= 16
        return bits.view(np.float32)
    if method == "int8":
        q = np.asarray(q)
        r, m = q.shape
        chunked = q.reshape(r, m // _CHUNK, _CHUNK).astype(np.float32)
        # in place (the same products): one model-size buffer, not two
        chunked *= np.asarray(scales, dtype=np.float32)[..., None]
        return chunked.reshape(r, m)
    raise ValueError(f"unknown sync_compress method {method!r}")


def _replica_mean(rows):
    """``rows.mean(axis=0)`` of a worker's (r, M) dequantized rows; one
    row is its own mean (a sum of one value, divided by one), taken
    without a model-size copy."""
    return rows[0] if rows.shape[0] == 1 else rows.mean(axis=0)


def consensus_digest(vectors) -> str:
    """Stable short digest of a consensus (list of f32 vectors) — the
    continuity token the elastic-resume tests compare across pod
    reshapes."""
    h = hashlib.sha1()
    for v in vectors:
        h.update(np.ascontiguousarray(np.asarray(v, np.float32)).tobytes())
    return h.hexdigest()[:16]


class Coordinator:
    """The host-side consensus table + serving loop.  Thread-per-
    connection; all table/consensus mutation under one lock (exchanges
    are tiny next to a round's compute, so serialization here is not a
    bottleneck and keeps the fold deterministic)."""

    def __init__(self, port: int, method: str = "none", decay: float = 0.5,
                 sink=None, consensus=None, start_round: int = 0,
                 liveness_s: float = 30.0, quarantine_k: float = 10.0,
                 ck_dir: str = "", ck_keep: int = 4):
        self.method = method
        self.decay = decay
        self.sink = sink
        self.liveness_s = liveness_s
        self.quarantine_k = quarantine_k
        self.ck_dir = ck_dir
        self.ck_keep = ck_keep
        self._lock = threading.Lock()
        # worker -> {"mean": [f32 vec per leaf], "count", "round"}
        self._table: dict = {}
        self._active: set = set()
        self._last_seen: dict = {}          # worker -> monotonic stamp
        self._inflight: dict = {}           # worker -> requests in flight
        self._flight_lock = threading.Lock()
        self._replies: dict = {}            # worker -> (round, reply)
        self._norms = deque(maxlen=32)      # trailing ACCEPTED norms
        self.consensus = consensus      # list of flat f32 vectors | None
        self.round = start_round
        self.exchanges = 0
        self.evictions = 0
        self.quarantines = 0
        self.corrupt_frames = 0
        self.duplicates = 0
        if ck_dir:
            os.makedirs(ck_dir, exist_ok=True)
        self._listener = Listener(("127.0.0.1", port), authkey=AUTHKEY)
        self._stopping = threading.Event()
        self._crashed = False
        self._conns: list = []
        self._conn_threads: list = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)
        self._accept_thread.start()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True)
        self._reaper.start()

    # -- serving loop ---------------------------------------------
    def _accept_loop(self):
        # poll before accept: a thread BLOCKED in accept() pins the
        # closed listening socket alive in the kernel (the port stays
        # LISTEN after close()), which would make a supervisor restart
        # on the same port impossible
        lsock = self._listener._listener._socket
        while not self._stopping.is_set():
            try:
                ready, _, _ = select.select([lsock], [], [], 0.05)
            except (OSError, ValueError):      # listener closed
                return
            if not ready:
                continue
            try:
                conn = self._listener.accept()
            except (OSError, EOFError):        # listener closed
                return
            # accepted sockets must carry SO_REUSEADDR too: otherwise
            # their FIN_WAIT/TIME_WAIT corpses after a crash() block the
            # restarted coordinator's bind on this port
            try:
                s = socket.socket(fileno=os.dup(conn.fileno()))
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.close()
            except OSError:                    # pragma: no cover
                pass
            self._conns.append(conn)
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._conn_threads.append(t)

    def _serve(self, conn):
        worker = None
        linger = None
        try:
            while True:
                if self._crashed:
                    return
                if not conn.poll(0.05):
                    if self._stopping.is_set():
                        # polite stop: linger briefly so in-flight
                        # clients get a "stopped" reply, not a retry
                        # storm against a dead socket
                        if linger is None:
                            linger = time.monotonic()
                        elif time.monotonic() - linger > 1.0:
                            return
                    continue
                box = [worker]      # a join or exchange names the worker
                self._in_flight(worker, +1)
                try:
                    done = self._handle(conn, box)
                finally:
                    self._in_flight(worker, -1)
                    worker = box[0]
                if done:
                    return
        except (EOFError, OSError):
            # dead worker == implicit leave: its contribution must not
            # pin the consensus forever (crash() closes every socket —
            # that is NOT a leave, the restarted coordinator wants the
            # worker back)
            if (not self._stopping.is_set() and worker is not None
                    and worker in self._active):
                self._leave(worker)
        finally:
            try:
                conn.close()
            except OSError:                 # pragma: no cover
                pass

    def _handle(self, conn, worker_box) -> bool:
        """Receive, serve and answer one request of the connection whose
        worker is ``worker_box[0]`` (a join or exchange names it there).
        Returns True when the connection is done (leave, stop)."""
        worker = worker_box[0]
        try:
            msg = _recv_frame(conn)
        except FrameError as e:
            with self._lock:
                self.corrupt_frames += 1
            _send_frame(conn, {"error": "bad_frame", "retryable": True,
                               "detail": str(e)})
            return False
        op = msg.get("op")
        if self._stopping.is_set() and op not in ("leave", "stop"):
            _send_frame(conn, {"error": "stopped"})
            return False
        if op == "join":
            worker_box[0] = worker = msg["worker"]
            _send_frame(conn, self._join(worker, msg.get("count", 1)))
        elif op == "exchange":
            worker_box[0] = worker = msg["worker"]
            _send_frame(conn, self._exchange(
                worker, msg["payload"], msg["round"], msg.get("count", 1)))
        elif op == "heartbeat":
            worker_box[0] = worker = msg.get("worker", worker)
            with self._lock:
                if worker is not None:
                    self._last_seen[worker] = time.monotonic()
                n_active = len(self._active)
            _send_frame(conn, {"ok": True, "op": "heartbeat",
                               "n_active": n_active})
        elif op == "leave":
            self._leave(worker or msg.get("worker"))
            _send_frame(conn, {"ok": True})
            return True
        elif op == "stop":
            _send_frame(conn, {"ok": True})
            self._stopping.set()
            return True
        else:
            _send_frame(conn, {"error": f"unknown op {op!r}"})
        return False

    def _in_flight(self, worker, delta):
        """A request in flight proves its worker alive: the reaper skips a
        worker while one of its requests is received, served or answered
        (a model-size exchange takes longer than a liveness window, and
        its client sends no heartbeat meanwhile), and the end of one
        counts as a sign of life."""
        if worker is None:
            return
        with self._flight_lock:
            n = self._inflight.get(worker, 0) + delta
            if n:
                self._inflight[worker] = n
            else:
                self._inflight.pop(worker, None)
            if delta < 0 and worker in self._last_seen:
                self._last_seen[worker] = time.monotonic()

    def _reap_loop(self):
        period = max(min(self.liveness_s / 4.0, 1.0), 0.02)
        while not self._stopping.wait(period):
            now = time.monotonic()
            with self._lock:
                for w in list(self._table):
                    seen = self._last_seen.get(w)
                    if (seen is not None and now - seen > self.liveness_s
                            and not self._inflight.get(w)):
                        self._table.pop(w, None)
                        self._active.discard(w)
                        self._last_seen.pop(w, None)
                        self.evictions += 1
                        self._emit("worker_evicted", worker=str(w),
                                   n_active=len(self._active))

    # -- ops (all under the lock) ---------------------------------
    def _emit(self, kind, **fields):
        if self.sink is not None:
            self.sink.emit(kind, **fields)

    def _join(self, worker, count):
        with self._lock:
            self._active.add(worker)
            self._last_seen[worker] = time.monotonic()
            self._emit("worker_join", worker=str(worker),
                       n_active=len(self._active))
            return {"consensus": self.consensus, "round": self.round,
                    "n_active": len(self._active)}

    def _leave(self, worker):
        with self._lock:
            self._active.discard(worker)
            self._table.pop(worker, None)
            self._last_seen.pop(worker, None)
            self._emit("worker_leave", worker=str(worker),
                       n_active=len(self._active))

    def _exchange(self, worker, payload, round_idx, count):
        with self._lock:
            self._last_seen[worker] = time.monotonic()
            cached = self._replies.get(worker)
            if cached is not None and cached[0] == round_idx:
                # duplicate push (client re-sent after a lost reply):
                # idempotent — return the cached reply, don't re-fold
                self.duplicates += 1
                return cached[1]
        means = [_replica_mean(_np_dequant(leaf["q"], leaf["scales"],
                                           self.method))
                 for leaf in payload]
        norm = parle.contribution_norm(means)
        with self._lock:
            self._active.add(worker)
            bad, reason = parle.should_quarantine(
                norm, self._norms, k=self.quarantine_k)
            if bad:
                self.quarantines += 1
                self._emit("worker_quarantined", worker=str(worker),
                           reason=reason)
                reply = {"consensus": self.consensus,
                         "staleness": max(self.round - round_idx, 0),
                         "n_active": len(self._active),
                         "quarantined": True, "reason": reason}
                self._replies[worker] = (round_idx, reply)
                return reply
            self._norms.append(norm)
            self._table[worker] = {"mean": means, "count": count,
                                   "round": round_idx}
            # deterministic fold order: sorted worker names
            rows = [self._table[w] for w in sorted(self._table)]
            prev_round = self.round
            self.consensus = parle.staleness_weighted_mean(
                [r["mean"] for r in rows], [r["count"] for r in rows],
                [r["round"] for r in rows], decay=self.decay)
            self.round = max(r["round"] for r in rows)
            self.exchanges += 1
            reply = {"consensus": self.consensus,
                     "staleness": self.round - round_idx,
                     "n_active": len(self._active)}
            self._replies[worker] = (round_idx, reply)
            if self.ck_dir and self.round > prev_round:
                try:
                    self._ck_locked()
                except Exception as e:      # pragma: no cover
                    sys.stderr.write(f"coordinator: periodic checkpoint "
                                     f"failed: {e}\n")
            return reply

    # -- checkpointing --------------------------------------------
    def digest(self) -> str:
        return consensus_digest(self.consensus or [])

    def save(self, path: str, metrics=None):
        """Checkpoint the consensus + per-worker contribution stamps.
        The tree is {"consensus": {leaf index: flat f32 vec}} — layout-
        free, so ANY worker count can resume from it."""
        with self._lock:
            self._save_locked(path, metrics=metrics)

    def _save_locked(self, path: str, metrics=None):
        if self.consensus is None:
            raise ValueError("no consensus to checkpoint yet "
                             "(no worker has exchanged)")
        tree = {"consensus": {str(i): np.asarray(v, np.float32)
                              for i, v in enumerate(self.consensus)}}
        stamps = {w: {"round": r["round"], "count": r["count"]}
                  for w, r in sorted(self._table.items())}
        ckpt.save(path, tree, step=self.round,
                  meta={"kind": "async_consensus", "decay": self.decay,
                        "sync_compress": self.method,
                        "workers": stamps, "digest": self.digest()},
                  algo="parle", metrics=metrics)

    def _ck_locked(self):
        """Periodic crash-recovery checkpoint on a round advance:
        atomic write into ``ck_dir``, pruned to the newest ``ck_keep``
        (each survivor is a valid restart point for the supervisor)."""
        path = os.path.join(self.ck_dir,
                            f"consensus_r{self.round:06d}.npz")
        self._save_locked(path)
        kept = sorted(f for f in os.listdir(self.ck_dir)
                      if f.startswith("consensus_r")
                      and f.endswith(".npz"))
        for stale in kept[:-self.ck_keep]:
            for p in (os.path.join(self.ck_dir, stale),
                      os.path.join(self.ck_dir, stale) + ".json"):
                try:
                    os.remove(p)
                except OSError:             # pragma: no cover
                    pass

    # -- lifecycle ------------------------------------------------
    def crash(self):
        """Die the way SIGKILL kills a coordinator process: every
        socket severed mid-conversation, all in-memory state (table,
        reply cache, consensus) abandoned.  Clients observe connection
        resets / refused reconnects — nothing graceful.  Recovery goes
        through :class:`CoordinatorSupervisor`."""
        self._crashed = True
        self._stopping.set()
        try:
            self._listener.close()
        except OSError:                     # pragma: no cover
            pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:                 # pragma: no cover
                pass

    def close(self):
        self._stopping.set()
        try:
            self._listener.close()
        except OSError:                     # pragma: no cover
            pass
        for t in self._conn_threads:
            t.join(timeout=2)


class CoordinatorSupervisor:
    """Owns the coordinator's lifecycle inside the pod parent: fires
    scripted ``coordinator_kill`` faults (crash at a consensus round,
    down for ``down_ms``), then restarts the coordinator FROM THE
    NEWEST VALID periodic checkpoint on the same port — in-memory state
    is discarded exactly as a real SIGKILL would, and workers rejoin
    transparently through their retry loop.  Counters accumulate across
    incarnations so the merged pod snapshot sees pod-lifetime totals."""

    _COUNTERS = ("exchanges", "evictions", "quarantines",
                 "corrupt_frames", "duplicates")

    def __init__(self, port: int, kills=(), sink=None, **coord_kw):
        self.sink = sink
        self._kw = dict(coord_kw)
        # the first incarnation's seed state (a --resume checkpoint) is
        # kept OUT of the restart kwargs: scripted restarts load from
        # the newest valid periodic checkpoint, falling back to this
        # seed only when none was written yet
        self._seed = (self._kw.pop("consensus", None),
                      self._kw.pop("start_round", 0))
        self._kills = sorted((dict(k) for k in kills),
                             key=lambda k: k["round"])
        self.restarts = 0
        self._base = {c: 0 for c in self._COUNTERS}
        self._lock = threading.Lock()
        self.coord = Coordinator(port, sink=sink,
                                 consensus=self._seed[0],
                                 start_round=self._seed[1], **self._kw)
        self.port = self.coord._listener.address[1]   # resolved (port 0)
        self._stop = threading.Event()
        self._monitor = None
        if self._kills:
            self._monitor = threading.Thread(target=self._watch,
                                             daemon=True)
            self._monitor.start()

    # -- delegation -----------------------------------------------
    @property
    def round(self):
        return self.coord.round

    @property
    def consensus(self):
        return self.coord.consensus

    def digest(self):
        return self.coord.digest()

    def save(self, path, metrics=None):
        self.coord.save(path, metrics=metrics)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._base[name] + getattr(self.coord, name)

    # -- kill/restart ---------------------------------------------
    def _watch(self):
        while self._kills and not self._stop.is_set():
            kill = self._kills[0]
            if self.coord.round < kill["round"] \
                    or self.coord.consensus is None:
                self._stop.wait(0.02)
                continue
            self._kills.pop(0)
            self._fire(kill)

    def _fire(self, kill):
        coord = self.coord
        ck_dir = self._kw.get("ck_dir", "")
        with self._lock:
            for c in self._COUNTERS:
                self._base[c] += getattr(coord, c)
        sys.stderr.write(f"supervisor: killing coordinator at round "
                         f"{coord.round}\n")
        coord.crash()
        time.sleep(kill.get("down_ms", 200.0) / 1e3)
        consensus, start_round = self._seed
        path = None
        if ck_dir:
            path = ckpt.latest_valid(ck_dir)
        if path is not None:
            consensus, start_round, _ = load_consensus(path)
        else:                               # pragma: no cover
            sys.stderr.write("supervisor: no valid checkpoint to restart "
                             "from; restarting from the seed state\n")
        # the bind can transiently collide with the dead incarnation's
        # socket corpses — retry until the kernel releases the port
        deadline = time.monotonic() + 15.0
        while True:
            try:
                self.coord = Coordinator(self.port, sink=self.sink,
                                         consensus=consensus,
                                         start_round=start_round,
                                         **self._kw)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)
        self.restarts += 1
        sys.stderr.write(f"supervisor: coordinator restarted from round "
                         f"{start_round} ({path})\n")
        if self.sink is not None:
            self.sink.emit("coordinator_restart", round=start_round,
                           restarts=self.restarts)

    def close(self):
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=2)
        self.coord.close()


def load_consensus(path: str):
    """Restore a :meth:`Coordinator.save` checkpoint -> (vectors, round,
    meta).  Template-free (``checkpoint.load_flat``): the whole point of
    the elastic format is that no worker-count-shaped ``like`` exists at
    resume time."""
    flat = ckpt.load_flat(path)
    keys = sorted((k for k in flat if k.startswith("consensus/")),
                  key=lambda k: int(k.split("/", 1)[1]))
    vectors = [np.asarray(flat[k], np.float32) for k in keys]
    return vectors, ckpt.latest_step(path), ckpt.saved_meta(path)


class CoordinatorClient:
    """Worker-side connection.  ``exchange`` measures nothing itself —
    the caller times the call, which IS the worker's entire
    synchronization wait under the async policy.

    Hardened: every RPC runs a retry loop with capped exponential
    backoff + deterministic jitter — transport errors, CRC-rejected
    frames, and reply timeouts all close the socket, reconnect (the
    coordinator may be restarting), transparently RE-JOIN if this
    client had joined before, and re-send.  The coordinator's
    idempotent exchange makes the re-send safe.  A ``stopped`` reply
    raises :class:`CoordinatorStopped` immediately (intentional
    shutdown is not retried); exhausting the retry window raises
    :class:`CoordinatorUnavailable`.  A daemon thread heartbeats every
    ``heartbeat_s`` so the coordinator can tell hung from healthy-slow;
    :meth:`freeze` suspends beats AND the caller — a whole-process hang
    (what SIGSTOP does), which is exactly what gets a worker evicted.

    ``rpc_timeout_s`` bounds an RPC with its retries, ``recv_timeout_s``
    the wait for one reply; a model-size exchange needs both scaled to
    the coordinator's host work (``launch/dist_run.py`` does)."""

    def __init__(self, port: int, worker: str, count: int = 1,
                 retry_s: float = 30.0, rpc_timeout_s: float = 60.0,
                 recv_timeout_s: float = 30.0,
                 heartbeat_s: float = 1.0):
        self.port = port
        self.worker = worker
        self.count = count
        self.retry_s = retry_s
        self.rpc_timeout_s = rpc_timeout_s
        self.recv_timeout_s = recv_timeout_s
        self.heartbeat_s = heartbeat_s
        self.reconnects = 0
        self._joined = False
        self._frozen_until = 0.0
        self._io_lock = threading.RLock()
        self._rng = random.Random(f"client:{worker}")   # jitter (det.)
        self.conn = None
        self._ensure_connected(time.monotonic() + retry_s, op="join")
        self._beat_stop = threading.Event()
        self._beater = None
        if heartbeat_s and heartbeat_s > 0:
            self._beater = threading.Thread(target=self._beat_loop,
                                            daemon=True)
            self._beater.start()

    # -- connection management ------------------------------------
    def _close_conn(self):
        with self._io_lock:
            if self.conn is not None:
                try:
                    self.conn.close()
                except OSError:             # pragma: no cover
                    pass
                self.conn = None

    def _ensure_connected(self, deadline: float, op: str = ""):
        """(Re)connect within ``deadline``; after a reconnect of a
        joined client, transparently re-join so the (possibly freshly
        restarted) coordinator has this worker active again before the
        caller's op lands."""
        if self.conn is not None:
            return
        first = not self._joined and self.reconnects == 0
        while True:
            try:
                self.conn = Client(("127.0.0.1", self.port),
                                   authkey=AUTHKEY)
                if not first:
                    self.reconnects += 1
                break
            except (ConnectionRefusedError, FileNotFoundError, OSError):
                if time.monotonic() >= deadline:
                    raise CoordinatorUnavailable(
                        f"worker {self.worker}: coordinator on port "
                        f"{self.port} unreachable")
                time.sleep(0.1)
        if self._joined and op != "join":
            _send_frame(self.conn, {"op": "join", "worker": self.worker,
                                    "count": self.count, "rejoin": True})
            reply = _recv_frame(self.conn, timeout=max(
                min(self.recv_timeout_s, deadline - time.monotonic()), 0.1))
            if isinstance(reply, dict) and reply.get("error") == "stopped":
                raise CoordinatorStopped("coordinator is stopped")

    def drop_connection(self):
        """Chaos injection: sever the socket (the next RPC reconnects,
        re-joins, and re-sends)."""
        self._close_conn()

    def freeze(self, ms: float):
        """Chaos injection: whole-process hang for ``ms`` — heartbeats
        stop AND the calling thread sleeps, so the coordinator sees
        true silence (a sleeping worker with live heartbeats would be
        healthy-slow, not hung)."""
        self._frozen_until = time.monotonic() + ms / 1e3
        time.sleep(ms / 1e3)

    def _beat_loop(self):
        while not self._beat_stop.wait(self.heartbeat_s):
            if time.monotonic() < self._frozen_until:
                continue
            if not self._io_lock.acquire(blocking=False):
                continue        # an RPC is in flight — it proves liveness
            try:
                if self.conn is None \
                        or time.monotonic() < self._frozen_until:
                    continue
                _send_frame(self.conn, {"op": "heartbeat",
                                        "worker": self.worker})
                reply = _recv_frame(self.conn, timeout=5.0)
                if isinstance(reply, dict) and reply.get("error"):
                    continue    # stopped/bad_frame: main thread decides
            except (OSError, EOFError, FrameError):
                # a timed-out beat leaves its reply queued — drop the
                # socket so a stale reply can never cross with an RPC
                self._close_conn()
            finally:
                self._io_lock.release()

    # -- RPC ------------------------------------------------------
    def _rpc(self, msg, corrupt_first: bool = False, timeout_s=None):
        total = self.rpc_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + total
        attempt = 0
        corrupt = corrupt_first
        while True:
            try:
                with self._io_lock:
                    self._ensure_connected(deadline, op=msg.get("op", ""))
                    _send_frame(self.conn, msg, corrupt=corrupt)
                    corrupt = False
                    reply = _recv_frame(self.conn, timeout=max(
                        min(self.recv_timeout_s, deadline - time.monotonic()), 0.1))
                err = reply.get("error") if isinstance(reply, dict) \
                    else None
                if err == "bad_frame":
                    continue    # checksum caught it — re-send clean
                if err == "stopped":
                    raise CoordinatorStopped("coordinator is stopped")
                if err:
                    raise RuntimeError(f"coordinator error: {err}")
                return reply
            except (OSError, EOFError, FrameError) as e:
                self._close_conn()
                if time.monotonic() >= deadline:
                    raise CoordinatorUnavailable(
                        f"worker {self.worker}: coordinator unreachable "
                        f"after {total:.0f}s "
                        f"({type(e).__name__}: {e})") from e
                delay = min(2.0, 0.05 * (2 ** attempt))
                delay *= 1.0 + 0.25 * self._rng.random()
                attempt += 1
                time.sleep(min(delay,
                               max(deadline - time.monotonic(), 0.0)))

    def join(self):
        reply = self._rpc({"op": "join", "worker": self.worker,
                           "count": self.count})
        self._joined = True
        return reply

    def wait_for_peers(self, n: int, timeout_s: float) -> int:
        """Block until ``n`` workers are active (or ``timeout_s``
        passed); returns the last active count seen.  A pod's workers
        start a few seconds apart (interpreter, torch and the card's
        context), longer than a first round takes: a worker that went
        ahead would exchange before its peers joined, and they would
        join at a later round than the pod's."""
        deadline = time.monotonic() + timeout_s
        while True:
            active = self._rpc({"op": "heartbeat",
                                "worker": self.worker})["n_active"]
            if active >= n or time.monotonic() >= deadline:
                return active
            time.sleep(0.05)

    def exchange(self, payload, round_idx: int,
                 corrupt_first: bool = False):
        return self._rpc({"op": "exchange", "worker": self.worker,
                          "count": self.count, "round": round_idx,
                          "payload": payload},
                         corrupt_first=corrupt_first)

    def leave(self):
        self._beat_stop.set()
        try:
            self._rpc({"op": "leave", "worker": self.worker},
                      timeout_s=5.0)
        except (CoordinatorStopped, CoordinatorUnavailable):
            pass            # leaving a stopped/gone coordinator is a no-op
        finally:
            self._close_conn()
            self._joined = False
