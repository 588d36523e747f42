"""Fault tolerance of the port's async pod: the counterpart of
tests/test_faults.py.  The seeded chaos harness (the same plan gives the
reference's schedule), CRC frames, heartbeat eviction, idempotent
retry, the quarantine, the coordinator's kill / restart from its
newest valid checkpoint, the crash-consistent checkpoints that restart
leans on, torn-tail event reads, and the chaos acceptance pod on the
CPU against its fault-free twin (final consensus L2 within rtol 1e-3,
every fault class counted)."""
import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import time
import zlib
from multiprocessing.connection import Pipe

import numpy as np
import pytest
import torch

from repro.runtime import FaultPlan as RefFaultPlan
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ParleConfig
from repro_torch.core import parle, registry
from repro_torch.obs import EventSink, read_events
from repro_torch.runtime import (CRASH_RC, Coordinator, CoordinatorClient,
                                 CoordinatorSupervisor, FaultPlan,
                                 FrameError, load_consensus, poison_payload)
from repro_torch.runtime.coordinator import (FrameTimeout, _recv_frame,
                                             _send_frame)
from torch_parity import one_torch_thread  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

FAULTS = [
    {"kind": "crash", "worker": 3, "round": 3},
    {"kind": "hang", "worker": 2, "round": 2, "ms": 50},
    {"kind": "poison", "worker": 1, "round": 2},
    {"kind": "delay_jitter", "worker": 0, "round": 1, "ms": 20},
    {"kind": "corrupt_frame", "worker": 0, "round": 2},
    {"kind": "drop_conn", "worker": 1, "round": 3},
    {"kind": "coordinator_kill", "round": 4, "down_ms": 100},
]


# ------------------------------------------------------------------
# fault plan: parsing, validation, deterministic replay
# ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 11])
def test_fault_plan_schedule_matches_reference(seed):
    port, ref = FaultPlan(seed, FAULTS), RefFaultPlan(seed, FAULTS)
    for w in range(4):
        assert port.schedule(w, 10) == ref.schedule(w, 10)
        assert port.jitter_ms(w, 1, 20) == ref.jitter_ms(w, 1, 20)
    assert port.to_json() == ref.to_json()
    assert port.crash_workers() == ref.crash_workers()
    assert port.coordinator_kills() == ref.coordinator_kills()


def test_fault_plan_schedule_is_deterministic():
    a = FaultPlan(7, FAULTS)
    b = FaultPlan(7, FAULTS)
    for w in range(4):
        assert a.schedule(w, 10) == b.schedule(w, 10)
    c = FaultPlan.from_spec(a.to_json())      # the wire form replays too
    for w in range(4):
        assert c.schedule(w, 10) == a.schedule(w, 10)
    assert FaultPlan(8, FAULTS).schedule(0, 10) != a.schedule(0, 10)
    ev = [e for e in a.schedule(0, 10) if e["kind"] == "delay_jitter"][0]
    assert 0.0 <= ev["sleep_ms"] <= 20.0
    assert a.jitter_ms(0, 1, 20) == pytest.approx(ev["sleep_ms"], abs=1e-5)


def test_fault_plan_spec_forms(tmp_path):
    inline = FaultPlan.from_spec(json.dumps(
        {"seed": 3, "faults": FAULTS[:2]}))
    assert inline.seed == 3 and len(inline.faults) == 2
    bare = FaultPlan.from_spec(json.dumps(FAULTS[:1]))   # list shorthand
    assert bare.seed == 0 and bare.faults[0]["kind"] == "crash"
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"seed": 5, "faults": FAULTS}))
    from_file = FaultPlan.from_spec(f"@{p}")
    assert from_file.seed == 5 and len(from_file.faults) == len(FAULTS)
    assert from_file.crash_workers() == {3}
    assert [k["round"] for k in from_file.coordinator_kills()] == [4]


@pytest.mark.parametrize("bad", [
    {"kind": "meteor", "round": 1, "worker": 0},       # unknown kind
    {"kind": "crash", "round": 0, "worker": 0},        # rounds are 1-based
    {"kind": "crash", "round": 1},                     # worker required
    {"kind": "hang", "round": 1, "worker": 0},         # ms required
    {"kind": "delay_jitter", "round": 1, "worker": 0, "ms": -5},
])
def test_fault_plan_rejects_malformed(bad):
    with pytest.raises(ValueError):
        FaultPlan(0, [bad])


def test_worker_faults_fire_and_poison_payload():
    wf = FaultPlan(0, FAULTS).worker_faults(1)
    assert wf.poison(2) and not wf.poison(1)
    assert not wf.corrupt(2)
    assert [e["kind"] for e in wf.events] == ["poison"]
    payload = [{"q": np.ones((2, 8), np.float32), "scales": None}]
    assert np.isnan(poison_payload(payload)[0]["q"]).all()
    scaled = [{"q": np.ones((2, 8), np.int8),
               "scales": np.ones((2, 1), np.float32)}]
    assert np.isnan(poison_payload(scaled)[0]["scales"]).all()
    assert CRASH_RC == 57


# ------------------------------------------------------------------
# CRC frames, retry, idempotence
# ------------------------------------------------------------------

def test_frame_round_trip_and_corruption():
    a, b = Pipe()
    try:
        _send_frame(a, {"op": "x", "blob": np.arange(4).tolist()})
        assert _recv_frame(b)["blob"] == [0, 1, 2, 3]
        arr = np.arange(3000, dtype=np.float32)
        _send_frame(a, {"v": arr})
        np.testing.assert_array_equal(_recv_frame(b)["v"], arr)
        # the long form of the connection's length (-1, then 8 bytes),
        # which a message above 2 GiB takes
        body = pickle.dumps({"op": "long"}, protocol=5)
        frame = struct.pack("!II", len(body), zlib.crc32(body)) + body
        a._send(struct.pack("!i", -1) + struct.pack("!Q", len(frame)))
        a._send(frame)
        assert _recv_frame(b)["op"] == "long"
        _send_frame(a, {"op": "x"}, corrupt=True)
        with pytest.raises(FrameError):
            _recv_frame(b)
        with pytest.raises(FrameTimeout):
            _recv_frame(b, timeout=0.05)
    finally:
        a.close()
        b.close()


def _vec_payload(value, size=8):
    return [{"q": np.full((1, size), value, np.float32), "scales": None}]


def test_corrupt_frame_rejected_then_resent_clean():
    coord = Coordinator(0, method="none")
    try:
        c = CoordinatorClient(coord._listener.address[1], "w0",
                              heartbeat_s=0)
        c.join()
        r = c.exchange(_vec_payload(5.0), round_idx=1, corrupt_first=True)
        np.testing.assert_allclose(r["consensus"][0], 5.0)
        assert coord.corrupt_frames == 1
        assert coord.exchanges == 1       # the bad frame never folded
        c.leave()
    finally:
        coord.close()


def test_duplicate_exchange_is_idempotent():
    coord = Coordinator(0, method="none")
    try:
        c = CoordinatorClient(coord._listener.address[1], "w0",
                              heartbeat_s=0)
        c.join()
        r1 = c.exchange(_vec_payload(2.0), round_idx=1)
        r2 = c.exchange(_vec_payload(2.0), round_idx=1)   # a re-send
        np.testing.assert_allclose(r1["consensus"][0], r2["consensus"][0])
        assert coord.duplicates == 1 and coord.exchanges == 1
        c.leave()
    finally:
        coord.close()


def test_drop_connection_reconnects_and_rejoins():
    coord = Coordinator(0, method="none")
    try:
        c = CoordinatorClient(coord._listener.address[1], "w0",
                              heartbeat_s=0)
        c.join()
        c.exchange(_vec_payload(1.0), round_idx=1)
        c.drop_connection()
        r = c.exchange(_vec_payload(3.0), round_idx=2)
        np.testing.assert_allclose(r["consensus"][0], 3.0)
        assert c.reconnects >= 1
        assert "w0" in coord._active       # transparent re-join
        c.leave()
    finally:
        coord.close()


def test_hung_worker_evicted_from_consensus(tmp_path):
    mpath = str(tmp_path / "evict.jsonl")
    sink = EventSink(mpath)
    coord = Coordinator(0, method="none", liveness_s=0.25, sink=sink)
    port = coord._listener.address[1]
    try:
        c0 = CoordinatorClient(port, "w0", heartbeat_s=0.05)
        c1 = CoordinatorClient(port, "w1", heartbeat_s=0.05)
        c0.join()
        c1.join()
        c0.exchange(_vec_payload(2.0), round_idx=1)
        c1.exchange(_vec_payload(6.0), round_idx=1)
        # hang w1 without blocking the test thread: silence its beats
        c1._frozen_until = time.monotonic() + 30.0
        deadline = time.monotonic() + 5.0
        while "w1" in coord._table and time.monotonic() < deadline:
            time.sleep(0.02)
        assert "w1" not in coord._table and coord.evictions >= 1
        assert "w0" in coord._table        # the live worker untouched
        r = c0.exchange(_vec_payload(2.0), round_idx=2)
        np.testing.assert_allclose(r["consensus"][0], 2.0)
        c1._frozen_until = 0.0
        c0.leave()
        c1.leave()
    finally:
        coord.close()
        sink.close()
    assert any(e["kind"] == "worker_evicted" and e["worker"] == "w1"
               for e in read_events(mpath))


def test_exchange_in_flight_is_not_a_hang(monkeypatch):
    """An exchange that takes longer than the liveness window (a
    model-size one does; its client sends no heartbeat meanwhile) keeps
    its worker in the table: only silence with nothing in flight is a
    hang."""
    from repro_torch.runtime import coordinator as coord_mod
    slow = coord_mod._np_dequant

    def dequant(*a):
        time.sleep(0.6)
        return slow(*a)

    coord = Coordinator(0, method="none", liveness_s=0.2)
    try:
        c = CoordinatorClient(coord._listener.address[1], "w0",
                              heartbeat_s=0)
        c.join()
        c.exchange(_vec_payload(1.0), round_idx=1)
        monkeypatch.setattr(coord_mod, "_np_dequant", dequant)
        r = c.exchange(_vec_payload(3.0), round_idx=2)
        np.testing.assert_allclose(r["consensus"][0], 3.0)
        assert coord.evictions == 0 and "w0" in coord._table
        c.leave()
    finally:
        coord.close()


# ------------------------------------------------------------------
# poisoned-update quarantine
# ------------------------------------------------------------------

def test_should_quarantine_gates():
    assert parle.should_quarantine(float("nan"), []) == (True, "nonfinite")
    assert parle.should_quarantine(float("inf"), []) == (True, "nonfinite")
    assert not parle.should_quarantine(1e9, [])[0]     # no baseline yet
    assert not parle.should_quarantine(1e9, [1.0, 1.0])[0]
    bad, reason = parle.should_quarantine(100.0, [1.0, 1.0, 1.0], k=10.0)
    assert bad and "10x trailing median" in reason
    assert not parle.should_quarantine(9.0, [1.0, 1.0, 1.0], k=10.0)[0]
    assert not np.isfinite(parle.contribution_norm(
        [np.array([1.0, np.nan], np.float32)]))


def test_coordinator_quarantines_nan_and_outlier(tmp_path):
    mpath = str(tmp_path / "quar.jsonl")
    sink = EventSink(mpath)
    coord = Coordinator(0, method="none", quarantine_k=10.0, sink=sink)
    try:
        c = CoordinatorClient(coord._listener.address[1], "w0",
                              heartbeat_s=0)
        c.join()
        r = c.exchange(_vec_payload(float("nan")), round_idx=1)
        assert r["quarantined"] and r["reason"] == "nonfinite"
        assert r["consensus"] is None      # never touched the table
        for rnd in range(2, 6):            # a baseline of accepted norms
            r = c.exchange(_vec_payload(2.0), round_idx=rnd)
            assert "quarantined" not in r
        r = c.exchange(_vec_payload(1e6), round_idx=6)
        assert r["quarantined"] and "trailing median" in r["reason"]
        np.testing.assert_allclose(r["consensus"][0], 2.0)   # unpolluted
        assert coord.quarantines == 2
        r = c.exchange(_vec_payload(2.5), round_idx=7)       # recovers
        assert "quarantined" not in r
        c.leave()
    finally:
        coord.close()
        sink.close()
    evs = read_events(mpath)
    assert sum(e["kind"] == "worker_quarantined" for e in evs) == 2


def test_reseed_from_consensus_restarts_replicas():
    cfg = registry.get("parle").canonicalize_cfg(ParleConfig(
        n_replicas=2, L=2, lr=0.05, lr_inner=0.05, batches_per_epoch=5,
        sync_compress="int8"))
    state = registry.get("parle").init({"w": torch.ones(4, 3)}, cfg)
    state.v_y.fill_(1.0)
    state.e.fill_(1.0)
    step = state.step
    xbar = torch.zeros(state.layout.numel)
    xbar[:12] = 7.0
    out = parle.reseed_from_consensus(state, xbar)
    for f in ("x", "y", "z"):
        torch.testing.assert_close(out.layout.tree(getattr(out, f))["w"],
                                   torch.full((2, 4, 3), 7.0))
    for f in ("v_y", "v_x", "e"):
        assert not bool(getattr(out, f).any())
    assert out.step is step
    assert len({getattr(out, f).data_ptr() for f in ("x", "y", "z")}) == 3


# ------------------------------------------------------------------
# coordinator kill + restart from checkpoint + transparent rejoin
# ------------------------------------------------------------------

def test_supervisor_kill_restart_rejoin_continuity(tmp_path):
    mpath = str(tmp_path / "sup.jsonl")
    sink = EventSink(mpath)
    # consensus / start_round as dist_run's --resume passes them: the
    # supervisor keeps these seed kwargs out of the restart call
    sup = CoordinatorSupervisor(
        0, kills=[{"round": 2, "down_ms": 100}], sink=sink,
        method="none", decay=0.5, ck_dir=str(tmp_path / "ck"),
        consensus=None, start_round=0)
    try:
        c = CoordinatorClient(sup.port, "w0", retry_s=15.0,
                              rpc_timeout_s=30.0, heartbeat_s=0.2)
        c.join()
        c.exchange(_vec_payload(2.0), round_idx=1)
        c.exchange(_vec_payload(4.0), round_idx=2)   # arms the kill
        deadline = time.monotonic() + 10.0
        while sup.restarts < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sup.restarts == 1
        r = c.exchange(_vec_payload(6.0), round_idx=3)
        np.testing.assert_allclose(r["consensus"][0], 6.0)
        assert sup.round == 3
        assert c.reconnects >= 1
        assert sup.counter("exchanges") >= 3   # across incarnations
        c.leave()
    finally:
        sup.close()
        sink.close()
    evs = read_events(mpath)
    restart = [e for e in evs if e["kind"] == "coordinator_restart"]
    assert len(restart) == 1 and restart[0]["restarts"] == 1
    assert restart[0]["round"] == 2        # recovered at the kill round
    assert [e["kind"] for e in evs].count("worker_join") >= 2


# ------------------------------------------------------------------
# crash-consistent checkpoints and torn-tail reads
# ------------------------------------------------------------------

def _save_ck(dirpath, name, value, step):
    path = os.path.join(str(dirpath), name)
    ckpt.save(path, {"w": torch.full((4,), value)}, step=step)
    return path + ".npz"


def _tear(path):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])


def test_checkpoint_digest_catches_torn_write(tmp_path):
    path = _save_ck(tmp_path, "ck", 3.0, step=5)
    ckpt.verify(path)                      # a fresh write verifies
    assert json.load(open(path + ".json"))["digest"]
    np.testing.assert_array_equal(ckpt.load_flat(path)["w"],
                                  np.full((4,), 3.0, np.float32))
    _tear(path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.verify(path)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.load_flat(path)
    # no temp droppings: the write path is tmp -> fsync -> rename
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_resolve_falls_back_to_newest_valid(tmp_path):
    old = _save_ck(tmp_path, "ck_a", 1.0, step=3)
    new = _save_ck(tmp_path, "ck_b", 2.0, step=7)
    assert ckpt.resolve(str(tmp_path)) == new      # dir -> newest valid
    _tear(new)
    assert ckpt.resolve(str(tmp_path)) == old
    with pytest.warns(UserWarning, match="falling back"):
        assert ckpt.resolve(new) == old
    with pytest.raises(FileNotFoundError):         # a typo, not a tear
        ckpt.resolve(str(tmp_path / "nope.npz"))
    _tear(old)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.resolve(str(tmp_path))


def test_restore_through_resolve_directory(tmp_path):
    _save_ck(tmp_path, "ck_a", 1.0, step=3)
    _save_ck(tmp_path, "ck_b", 2.0, step=7)
    out = ckpt.restore(str(tmp_path), {"w": torch.zeros(4)})
    torch.testing.assert_close(out["w"], torch.full((4,), 2.0))


def test_read_events_tolerates_torn_final_line(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    s = EventSink(path)
    s.emit("note", msg="pre-crash")
    s.emit("note", msg="also landed")
    s.close()
    with open(path, "a") as f:
        f.write('{"v": 1, "kind": "note", "ts": 1.0, "msg": "die')  # torn
    with pytest.raises(ValueError):
        read_events(path)                  # strict by default
    with pytest.warns(UserWarning, match="torn final line"):
        evs = read_events(path, tolerate_torn_tail=True)
    assert [e["msg"] for e in evs] == ["pre-crash", "also landed"]
    with open(path, "a") as f:            # only the LAST line gets grace
        f.write('\n{"v": 1, "kind": "note", "ts": 2.0, "msg": "ok"}\n')
    with pytest.raises(ValueError):
        read_events(path, tolerate_torn_tail=True)


# ------------------------------------------------------------------
# the chaos acceptance pod
# ------------------------------------------------------------------

CHAOS_PLAN = {"seed": 11, "faults": [
    {"kind": "crash", "worker": 3, "round": 3},
    {"kind": "hang", "worker": 2, "round": 2, "ms": 2500},
    {"kind": "poison", "worker": 1, "round": 2},
    {"kind": "corrupt_frame", "worker": 0, "round": 4},
    {"kind": "coordinator_kill", "round": 5, "down_ms": 300},
]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _consensus_l2(vectors):
    return float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(v, np.float64))))
        for v in vectors)))


def _chaos_pod(tmp_path, tag, fault_plan=None):
    ck = str(tmp_path / f"ck_{tag}.npz")
    mpath = str(tmp_path / f"pod_{tag}.jsonl")
    extra = ["--metrics-out", mpath, "--checkpoint-out", ck]
    if fault_plan is not None:
        extra += ["--fault-plan", json.dumps(fault_plan),
                  "--liveness-s", "0.5"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_run", "--smoke",
         "--device", "cpu", "--sync-policy", "async", "--nproc", "4",
         "--replicas", "8", "--steps", "15", "--L", "3",
         "--port", str(_free_port()), "--coord-port", str(_free_port()),
         *extra],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    merged = [e for e in read_events(mpath, tolerate_torn_tail=True)
              if e["kind"] == "pod_merged"][-1]
    vectors, rnd, _ = load_consensus(ck)
    return {"merged": merged, "round": rnd, "l2": _consensus_l2(vectors),
            "counters": {c["name"]: c["total"]
                         for c in merged["snapshot"]["counters"]},
            "stderr": res.stderr, "mpath": mpath}


def test_chaos_pod_survives_scripted_faults(tmp_path):
    """Four async workers through the scripted plan — one crash, one hang
    past the liveness deadline, one NaN-poisoned round, one corrupt
    frame, one coordinator kill + restart — complete with a consensus
    close to the fault-free twin's, and the merged snapshot counts every
    fault class."""
    clean = _chaos_pod(tmp_path, "clean")
    chaos = _chaos_pod(tmp_path, "chaos", CHAOS_PLAN)

    assert chaos["round"] == clean["round"] == 5
    assert chaos["l2"] == pytest.approx(clean["l2"], rel=1e-3)
    c = chaos["counters"]
    assert c["pod.quarantined_updates"] >= 1       # poison quarantined
    assert c["pod.evicted_workers"] >= 1           # hang evicted
    assert c["pod.coordinator_restarts"] == 1      # kill + restart
    assert c["pod.worker_crashes"] == 1            # the scripted crash
    assert c["pod.corrupt_frames"] >= 1            # CRC caught the flip
    assert chaos["merged"]["evicted_workers"] >= 1
    assert chaos["merged"]["missing_workers"] == 1
    assert "worker 3 crashed per fault plan (rc=57)" in chaos["stderr"]
    assert "supervisor: killing coordinator" in chaos["stderr"]
    assert "coordinator restarted" in chaos["stderr"]
    fired = set()
    for i in range(4):
        wfile = f"{chaos['mpath']}.worker{i}"
        if os.path.exists(wfile):
            fired |= {(e["fault"], e["worker"])
                      for e in read_events(wfile, tolerate_torn_tail=True)
                      if e["kind"] == "fault_injected"}
    assert {("crash", 3), ("hang", 2), ("poison", 1),
            ("corrupt_frame", 0)} <= fired
    evs = read_events(chaos["mpath"], tolerate_torn_tail=True)
    for kind in ("coordinator_restart", "worker_quarantined",
                 "worker_evicted"):
        assert any(e["kind"] == kind for e in evs), kind

    assert clean["counters"]["pod.coordinator_restarts"] == 0
    assert clean["counters"].get("pod.quarantined_updates", 0) == 0
    assert clean["merged"]["missing_workers"] == 0
