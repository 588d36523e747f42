"""The port's async/elastic runtime (``repro_torch/runtime/``, the async
half of ``repro_torch/core/parle.py``, ``launch/dist_run.py --sync-policy
async``): the counterpart of tests/test_runtime_async.py.

First the port against the reference on the same numpy inputs:
the staleness-weighted mean, the contribution norm, the quarantine gate
and the host dequantizer bit for bit; the async payloads (none / bf16 /
int8) bit for bit from a state converted from the reference's; the
consensus row, the re-seed and one inner-only round (losses, x, y, z
within 1e-4, the training parity bound); a port and a reference
coordinator fed the same payloads end on the same consensus digest; and
each package reads the other's consensus checkpoint.  Then the
reference's own contracts inside the port, and the elastic pod on the
CPU: 2 workers checkpoint, then resume as 1 and as 3 (tier-1); the
reference's 12-replica reshape stays ``slow``.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import parle as ref_parle
from repro.core import registry as ref_registry
from repro.runtime import Coordinator as RefCoordinator
from repro.runtime import CoordinatorClient as RefClient
from repro.runtime import load_consensus as ref_load_consensus
from repro.runtime.coordinator import _np_dequant as ref_np_dequant
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ParleConfig
from repro_torch.core import parle, registry
from repro_torch.models.convert import state_from_numpy, state_to_numpy
from repro_torch.models.model import build_model
from repro_torch.obs import EventSink, Registry, read_events
from repro_torch.runtime import (AsyncElasticPolicy, BarrierPolicy,
                                 Coordinator, CoordinatorClient,
                                 OverlapPolicy, RoundRunner,
                                 consensus_digest, load_consensus,
                                 policy_for)
from repro_torch.runtime.coordinator import _np_dequant
from torch_parity import (MODEL_TOL, assert_close, leaf_pairs,  # noqa: F401
                          numpy_params, one_torch_thread, port_config)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
METHODS = ("none", "bf16", "int8")


def _loss(p, b):
    return ((p["w"] @ p["m"] - b["t"]) ** 2).mean(), ()


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(
                (rng.standard_normal((8, 16)) * 0.1).astype(np.float32)),
            "m": torch.from_numpy(
                (rng.standard_normal((16, 4)) * 0.1).astype(np.float32))}


def _round_batches(seed, L, n):
    rng = np.random.default_rng(seed)
    return {"t": torch.from_numpy(
        rng.standard_normal((L, n, 8, 4)).astype(np.float32))}


def _cfg(n=2, L=3, sync_compress="none"):
    return registry.get("parle").canonicalize_cfg(ParleConfig(
        n_replicas=n, L=L, lr=0.05, lr_inner=0.05, batches_per_epoch=5,
        sync_compress=sync_compress))


def _rand_means(rng, sizes, scale=1.0):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in sizes]


# ------------------------------------------------------------------
# the coordinator's host math, port against reference
# ------------------------------------------------------------------

@pytest.mark.parametrize("workers", [2, 3])
def test_staleness_mean_and_norm_match_reference_bitwise(workers):
    rng = np.random.default_rng(workers)
    sizes = (37, 8192, 5)
    means = [_rand_means(rng, sizes) for _ in range(workers)]
    counts = [int(c) for c in rng.integers(1, 4, workers)]
    rounds = [int(r) for r in rng.integers(3, 7, workers)]
    for decay in (0.5, 0.3, 1.0):
        got = parle.staleness_weighted_mean(means, counts, rounds, decay)
        want = ref_parle.staleness_weighted_mean(means, counts, rounds,
                                                 decay)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))
    for m in means:
        assert parle.contribution_norm(m) == ref_parle.contribution_norm(m)
    one = parle.staleness_weighted_mean(means[:1], [2], [4])
    assert one is means[0]


@pytest.mark.parametrize("norm,trail,k", [
    (float("nan"), [], 10.0), (float("inf"), [1.0], 10.0), (1e9, [], 10.0),
    (1e9, [1.0, 1.0], 10.0), (100.0, [1.0, 1.0, 1.0], 10.0),
    (9.0, [1.0, 1.0, 1.0], 10.0), (31.0, [3.0, 1.0, 2.0, 9.0], 4.0),
    (5.0, [0.0, 0.0, 0.0], 10.0)])
def test_should_quarantine_matches_reference(norm, trail, k):
    assert parle.should_quarantine(norm, trail, k=k) \
        == ref_parle.should_quarantine(norm, trail, k=k)


@pytest.mark.parametrize("method", METHODS)
def test_np_dequant_matches_reference_bitwise(method):
    rng = np.random.default_rng(7)
    c = rng.standard_normal((3, 2048)).astype(np.float32)
    if method == "none":
        q_port = q_ref = c
        s = None
    elif method == "bf16":
        q_ref = np.asarray(jnp.asarray(c).astype(jnp.bfloat16))
        q_port = q_ref.view(np.uint16)
        s = None
    else:
        q_port = q_ref = rng.integers(-127, 128, (3, 2048)).astype(np.int8)
        s = rng.random((3, 2)).astype(np.float32)
    got = _np_dequant(q_port, s, method)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref_np_dequant(q_ref, s, method))


# ------------------------------------------------------------------
# the worker's half, port against reference
# ------------------------------------------------------------------

def _both_states(method, n=2, seed=0):
    """(reference ParleState, the port's state converted from it): a
    smoke dense model's params, x spread per replica, and a random
    residual under compression."""
    ref_cfg = FAMILY_CONFIGS["dense"]
    rcfg = ref_registry.get("parle").canonicalize_cfg(RefParleConfig(
        n_replicas=n, L=2, lr=0.05, lr_inner=0.05, batches_per_epoch=5,
        sync_compress=method))
    rng = np.random.default_rng(seed)
    params = numpy_params(ref_cfg, seed)
    st = ref_registry.get("parle").init(jax.tree.map(jnp.asarray, params),
                                        rcfg)
    spread = lambda l: l + jnp.asarray(  # noqa: E731
        rng.standard_normal(l.shape).astype(np.float32) * 0.01)
    st = st._replace(x=jax.tree.map(spread, st.x))
    if method != "none":
        st = st._replace(e=jax.tree.map(lambda l: jnp.asarray(
            rng.standard_normal(l.shape).astype(np.float32) * 1e-3), st.x))
    port = state_from_numpy(jax.tree.map(np.asarray, st), "cpu")
    return st, port, rcfg, _cfg(n, 2, method)


@pytest.mark.parametrize("method", METHODS)
def test_async_contribution_matches_reference_bitwise(method):
    ref_st, st, rcfg, pcfg = _both_states(method)
    want, want_e = ref_parle.async_contribution(ref_st, rcfg)
    got, got_e = parle.async_contribution(st, pcfg)
    assert len(got) == len(want) == len(st.layout.paths)
    for g, w in zip(got, want):
        wq = np.asarray(w["q"])
        if method == "bf16":
            wq = wq.view(np.uint16)
        assert g["q"].dtype == wq.dtype and g["q"].shape == wq.shape
        np.testing.assert_array_equal(g["q"], wq)
        if method == "int8":
            np.testing.assert_array_equal(g["scales"],
                                          np.asarray(w["scales"]))
        else:
            assert g["scales"] is None and w["scales"] is None
    if method == "none":
        assert got_e is None and want_e is None
    else:
        assert got_e is st.e                  # the residual, in place
        port_e = state_to_numpy(st)["e"]
        for path, p, r in leaf_pairs(port_e, want_e):
            np.testing.assert_array_equal(p, np.asarray(r), err_msg=path)


@pytest.mark.parametrize("method", ["none", "int8"])
def test_consensus_row_and_reseed_match_reference(method):
    ref_st, st, rcfg, pcfg = _both_states(method, seed=3)
    payload, _ = ref_parle.async_contribution(ref_st, rcfg)
    means = [ref_np_dequant(p["q"], p["scales"], method).mean(axis=0)
             for p in payload]
    want = ref_parle.consensus_from_flat(means, ref_st.x)
    row = parle.consensus_from_flat(means, st)
    assert row.shape == (st.layout.numel,) and row.dtype == torch.float32
    views = st.layout.tree(row)
    for path, p, r in leaf_pairs(jax.tree.map(lambda t: t.numpy(), views),
                                 want):
        np.testing.assert_array_equal(p, np.asarray(r), err_msg=path)
    gaps = torch.ones(st.layout.numel, dtype=torch.bool)
    for o, n in zip(st.layout.offsets, st.layout.sizes):
        gaps[o:o + n] = False
    assert not bool(row[gaps].any())          # zeros in the layout's gaps

    ref_out = ref_parle.reseed_from_consensus(ref_st, want)
    out = parle.reseed_from_consensus(st, row)
    got = state_to_numpy(out)
    fields = ("x", "y", "z", "v_y", "v_x") + (("e",) if method != "none"
                                              else ())
    for f in fields:
        for path, p, r in leaf_pairs(got[f], getattr(ref_out, f)):
            np.testing.assert_array_equal(p, np.asarray(r),
                                          err_msg=f"{f}{path}")
    assert int(out.step) == int(ref_out.step)
    ptrs = {getattr(out, f).data_ptr() for f in ("x", "y", "z")}
    assert len(ptrs) == 3                     # still distinct buffers


def test_inner_round_matches_reference():
    """One inner-only round of a smoke dense model, both packages: the
    per-step losses and x, y, z within the training parity bound; no
    sync ran (step L, scopes untouched, x unchanged)."""
    ref_cfg = FAMILY_CONFIGS["dense"]
    ref_st, st, rcfg, pcfg = _both_states("none", seed=5)
    x0 = st.x.clone()
    rng = np.random.default_rng(9)
    toks = rng.integers(0, ref_cfg.vocab_size, (2, 2, 2, 16)).astype(
        np.int32)
    batches = {"tokens": toks, "labels": toks}
    from repro.models.model import build_model as ref_build_model
    ref_round = ref_parle.make_inner_round_fn(
        ref_build_model(ref_cfg).loss, rcfg)
    ref_st, ref_m = ref_round(ref_parle.dealias_state(ref_st),
                              jax.tree.map(jnp.asarray, batches))
    rnd = parle.make_inner_round_fn(
        build_model(port_config(ref_cfg)).loss, pcfg)
    st, m = rnd(st, {k: torch.from_numpy(v) for k, v in batches.items()})
    assert_close(m["losses"], np.asarray(ref_m["losses"]), MODEL_TOL,
                 "inner round losses")
    got = state_to_numpy(st)
    for f in ("x", "y", "z"):
        for path, p, r in leaf_pairs(got[f], getattr(ref_st, f)):
            assert_close(p, np.asarray(r), MODEL_TOL, f"{f}{path}")
    assert int(st.step) == int(ref_st.step) == 2
    assert torch.equal(st.x, x0)
    assert float(st.scopes.gamma) == float(ref_st.scopes.gamma)


# ------------------------------------------------------------------
# the coordinators of both packages, and their checkpoints
# ------------------------------------------------------------------

def _payload_pair(rng, method, rows=2):
    """(port payload, reference payload) of one worker: two leaves, the
    second padded to a chunk edge under compression."""
    sizes = (24, 3000) if method == "none" else (8192, 8192)
    port, ref = [], []
    for m in sizes:
        c = rng.standard_normal((rows, m)).astype(np.float32)
        if method == "none":
            port.append({"q": c, "scales": None})
            ref.append({"q": c, "scales": None})
        elif method == "bf16":
            q = np.asarray(jnp.asarray(c).astype(jnp.bfloat16))
            port.append({"q": q.view(np.uint16), "scales": None})
            ref.append({"q": q, "scales": None})
        else:
            q = rng.integers(-127, 128, (rows, m)).astype(np.int8)
            s = rng.random((rows, m // 1024)).astype(np.float32)
            port.append({"q": q, "scales": s})
            ref.append({"q": q, "scales": s})
    return port, ref


@pytest.mark.parametrize("method", METHODS)
def test_port_and_reference_coordinators_agree(method, tmp_path):
    """Three workers (1-3 replica rows) push at staggered rounds into a
    port and a reference coordinator: after every exchange both hold the
    same consensus digest; then each package reads the other's
    checkpoint."""
    rng = np.random.default_rng(11)
    port = Coordinator(0, method=method, decay=0.5)
    ref = RefCoordinator(0, method=method, decay=0.5)
    try:
        clients = [(CoordinatorClient(port._listener.address[1], f"w{i}",
                                      count=i + 1, heartbeat_s=0),
                    RefClient(ref._listener.address[1], f"w{i}",
                              count=i + 1, heartbeat_s=0))
                   for i in range(3)]
        for cp, cr in clients:
            cp.join()
            cr.join()
        for i, rnd in [(0, 1), (1, 1), (2, 2), (0, 2), (1, 4), (2, 3)]:
            pp, pr = _payload_pair(rng, method, rows=i + 1)
            clients[i][0].exchange(pp, round_idx=rnd)
            clients[i][1].exchange(pr, round_idx=rnd)
            assert port.digest() == ref.digest()
        port.save(str(tmp_path / "port.npz"))
        ref.save(str(tmp_path / "ref.npz"))
        for cp, cr in clients:
            cp.leave()
            cr.leave()
    finally:
        port.close()
        ref.close()
    for path in ("port.npz", "ref.npz"):
        p = str(tmp_path / path)
        got, want = load_consensus(p), ref_load_consensus(p)
        assert got[1] == want[1] == 4
        assert consensus_digest(got[0]) == consensus_digest(want[0]) \
            == got[2]["digest"] == want[2]["digest"] == port.digest()
        assert got[2]["kind"] == want[2]["kind"] == "async_consensus"


# ------------------------------------------------------------------
# the reference's contracts inside the port
# ------------------------------------------------------------------

def test_staleness_single_contribution_is_identity():
    means = [np.arange(6, dtype=np.float32)]
    assert parle.staleness_weighted_mean(means, [3], [7]) is means[0]


def test_staleness_equal_rounds_is_count_weighted_mean():
    a = [np.ones(4, np.float32) * 2.0]
    b = [np.ones(4, np.float32) * 8.0]
    out = parle.staleness_weighted_mean([a, b], [3, 1], [5, 5])
    np.testing.assert_allclose(out[0], (3 * 2.0 + 1 * 8.0) / 4, rtol=1e-6)


def test_staleness_decay_downweights_lagging_worker():
    fresh = [np.zeros(4, np.float32)]
    stale = [np.ones(4, np.float32)]
    out = parle.staleness_weighted_mean([fresh, stale], [1, 1], [10, 8],
                                        decay=0.5)
    np.testing.assert_allclose(out[0], 0.2, rtol=1e-6)
    out = parle.staleness_weighted_mean([fresh, stale], [1, 1], [10, 8],
                                        decay=1.0)
    np.testing.assert_allclose(out[0], 0.5, rtol=1e-6)


def test_staleness_zero_contributions_raises():
    with pytest.raises(ValueError):
        parle.staleness_weighted_mean([], [], [])


@pytest.mark.parametrize("method", METHODS)
def test_async_contribution_round_trip(method):
    cfg = _cfg(sync_compress=method)
    state = registry.get("parle").init(_params(), cfg)
    state.x[1].mul_(1.5)                       # replicas apart
    payload, e_new = parle.async_contribution(state, cfg)
    assert len(payload) == len(state.layout.paths)
    means = [_np_dequant(p["q"], p["scales"], method).mean(axis=0)
             for p in payload]
    xbar = parle.consensus_from_flat(means, state)
    want = parle.replica_mean(state.x)
    if method == "none":
        assert torch.equal(xbar, want)
        assert e_new is None
    else:
        torch.testing.assert_close(xbar, want, rtol=0, atol=2e-2)
        assert e_new is state.e and e_new.shape == state.x.shape


def test_consensus_from_flat_trims_codec_padding():
    cfg = _cfg(sync_compress="int8")
    state = registry.get("parle").init(_params(1), cfg)
    payload, _ = parle.async_contribution(state, cfg)
    for p, n in zip(payload, state.layout.sizes):
        assert p["q"].shape[1] >= n and p["q"].shape[1] % 8192 == 0
    means = [_np_dequant(p["q"], p["scales"], "int8").mean(axis=0)
             for p in payload]
    assert parle.consensus_from_flat(means, state).shape \
        == (state.layout.numel,)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_single_worker_async_matches_barrier_bitwise(use_kernel):
    """The n-of-1 anchor: the coordinator path with ONE worker (its own
    mean as the consensus) equals the barrier round bit for bit."""
    cfg = _cfg(n=2, L=3)
    algo = registry.get("parle")
    barrier_round = algo.make_round_fn(_loss, cfg, use_kernel=use_kernel)
    inner_round = AsyncElasticPolicy(None, cfg, None, 0).make_round_fn(
        algo, _loss, cfg, use_kernel=use_kernel)
    apply_fn = parle.make_async_apply_fn(cfg)
    s_bar = parle.dealias_state(algo.init(_params(), cfg))
    s_async = parle.dealias_state(algo.init(_params(), cfg))
    for r in range(2):
        rb = _round_batches(20 + r, cfg.L, cfg.n_replicas)
        s_bar, m_bar = barrier_round(s_bar, rb)
        s_async, m_async = inner_round(s_async, rb)
        payload, _ = parle.async_contribution(s_async, cfg)
        means = parle.staleness_weighted_mean(
            [[_np_dequant(p["q"], p["scales"], "none").mean(axis=0)
              for p in payload]], [cfg.n_replicas], [r])
        s_async = apply_fn(s_async,
                           parle.consensus_from_flat(means, s_async))
        assert torch.equal(m_bar["losses"], m_async["losses"])
    for f in ("x", "y", "z", "v_y", "v_x"):
        assert torch.equal(getattr(s_bar, f), getattr(s_async, f)), f
    assert int(s_bar.step) == int(s_async.step) == 6
    assert float(s_bar.scopes.gamma) == float(s_async.scopes.gamma)


def test_runner_post_round_runs_after_each_round_before_on_round():
    cfg = _cfg()
    algo = registry.get("parle")
    calls = []

    def post_round(state, r, gstep, metrics):
        calls.append(("post", r, gstep, int(state.step)))
        return state._replace(step=state.step + cfg.L)   # the one used

    def on_round(r, gstep, metrics):
        calls.append(("on", r, gstep))

    from repro_torch.obs import Obs
    state, _ = RoundRunner(Obs()).run_rounds(
        algo.init(_params(), cfg), parle.make_inner_round_fn(_loss, cfg),
        lambda s: _round_batches(s, cfg.L, cfg.n_replicas), start=0,
        rounds=2, L=cfg.L, tokens_per_round=1, on_round=on_round,
        post_round=post_round, progress_every=0)
    assert calls == [("post", 0, 3, 3), ("on", 0, 3),
                     ("post", 1, 6, 9), ("on", 1, 6)]
    assert int(state.step) == 12


def test_policy_for_resolution():
    assert isinstance(policy_for(_cfg()), BarrierPolicy)
    assert isinstance(policy_for(None, "overlap"), OverlapPolicy)
    ov = dataclasses.replace(_cfg(), sync_overlap=True)
    assert isinstance(policy_for(ov), OverlapPolicy)
    with pytest.raises(ValueError, match="async needs a CoordinatorClient"):
        policy_for(None, "async")


def test_async_policy_rejects_step_and_mesh_programs():
    pol = AsyncElasticPolicy(client=None, pcfg=_cfg(), obs=None, worker=0)
    with pytest.raises(SystemExit):
        pol.make_step_fn(registry.get("parle"), _loss, _cfg())
    with pytest.raises(SystemExit):
        pol.make_round_fn(registry.get("parle"), _loss, _cfg(),
                          mesh=object())
    assert pol.make_flush_fn(registry.get("parle"), _cfg()) is None


def _vec_payload(value, size=8):
    return [{"q": np.full((1, size), value, np.float32), "scales": None}]


def test_coordinator_join_exchange_leave_elastic(tmp_path):
    sink = EventSink(str(tmp_path / "coord.jsonl"))
    coord = Coordinator(0, method="none", decay=0.5, sink=sink)
    port = coord._listener.address[1]
    try:
        c0 = CoordinatorClient(port, "worker0", count=1)
        c1 = CoordinatorClient(port, "worker1", count=1)
        hello = c0.join()
        assert hello["consensus"] is None and hello["round"] == 0
        assert c1.join()["n_active"] == 2
        r = c0.exchange(_vec_payload(2.0), round_idx=1)
        np.testing.assert_allclose(r["consensus"][0], 2.0)
        assert r["staleness"] == 0
        r = c1.exchange(_vec_payload(6.0), round_idx=1)
        np.testing.assert_allclose(r["consensus"][0], 4.0)
        c1.leave()                 # its contribution leaves the table
        r = c0.exchange(_vec_payload(3.0), round_idx=2)
        np.testing.assert_allclose(r["consensus"][0], 3.0)
        assert r["n_active"] == 1
        c0.leave()
    finally:
        coord.close()
        sink.close()
    kinds = [e["kind"] for e in read_events(str(tmp_path / "coord.jsonl"))]
    assert kinds.count("worker_join") == 2
    assert kinds.count("worker_leave") == 2


def test_coordinator_dead_connection_is_implicit_leave():
    coord = Coordinator(0, method="none")
    port = coord._listener.address[1]
    try:
        c0 = CoordinatorClient(port, "worker0")
        c1 = CoordinatorClient(port, "worker1")
        c0.join()
        c1.join()
        c1.exchange(_vec_payload(10.0), round_idx=1)
        c1.conn.close()                   # a crash, not a polite leave
        deadline = time.monotonic() + 5
        while "worker1" in coord._active and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "worker1" not in coord._active
        r = c0.exchange(_vec_payload(2.0), round_idx=1)
        np.testing.assert_allclose(r["consensus"][0], 2.0)
        c0.leave()
    finally:
        coord.close()


def test_workers_wait_for_their_peers_before_the_first_round():
    """A pod's workers start at its round: a worker polls the active
    count until all have joined (bounded by its timeout)."""
    coord = Coordinator(0, method="none")
    port = coord._listener.address[1]
    try:
        c0 = CoordinatorClient(port, "worker0", heartbeat_s=0)
        c0.join()
        t0 = time.monotonic()
        assert c0.wait_for_peers(2, timeout_s=0.3) == 1     # times out
        assert time.monotonic() - t0 >= 0.3
        c1 = CoordinatorClient(port, "worker1", heartbeat_s=0)
        c1.join()
        assert c0.wait_for_peers(2, timeout_s=5.0) == 2
        c0.leave()
        c1.leave()
    finally:
        coord.close()


def test_coordinator_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "consensus.npz")
    coord = Coordinator(0, method="none", decay=0.25)
    port = coord._listener.address[1]
    try:
        with pytest.raises(ValueError):
            coord.save(path)              # nothing exchanged yet
        c = CoordinatorClient(port, "worker0", count=2)
        c.join()
        c.exchange(_vec_payload(5.0), round_idx=3)
        coord.save(path, metrics=[{"name": "pod.steps", "labels": {},
                                   "total": 9}])
        digest = coord.digest()
        c.leave()
    finally:
        coord.close()
    vectors, rnd, meta = load_consensus(path)
    assert rnd == 3
    assert consensus_digest(vectors) == digest == meta["digest"]
    assert meta["kind"] == "async_consensus" and meta["decay"] == 0.25
    assert meta["workers"]["worker0"] == {"round": 3, "count": 2}
    np.testing.assert_allclose(vectors[0], 5.0)
    assert ckpt.saved_metrics(path)[0]["total"] == 9
    assert list(ckpt.load_flat(path)) == ["consensus/0"]


def test_merge_pod_obs_counts_missing_workers(tmp_path):
    from repro_torch.launch.dist_run import _merge_pod_obs, build_argparser
    mpath = str(tmp_path / "pod.jsonl")
    args = build_argparser().parse_args(
        ["--nproc", "3", "--metrics-out", mpath])
    # worker 0: full snapshot; worker 1: crashed before the final
    # snapshot; worker 2: no file at all
    reg = Registry()
    reg.counter("pod.steps").inc(4)
    s = EventSink(f"{mpath}.worker0")
    s.emit("metrics_snapshot", snapshot=reg.snapshot())
    s.close()
    s = EventSink(f"{mpath}.worker1")
    s.emit("note", msg="crashed before finalize")
    s.close()
    merged = _merge_pod_obs(args, extra_counters=[
        {"name": "pod.steps", "labels": {}, "total": 6}], evicted_workers=2)
    assert merged["counters"][0]["total"] == 10
    evs = read_events(mpath)
    assert [e["kind"] for e in evs] == ["note", "note", "pod_merged"]
    assert evs[-1]["processes"] == 1
    assert evs[-1]["missing_workers"] == 2
    assert evs[-1]["evicted_workers"] == 2
    assert "worker 1" in evs[0]["msg"] and "worker 2" in evs[1]["msg"]


# ------------------------------------------------------------------
# the elastic pod on the CPU
# ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _consensus_l2(vectors):
    return float(np.sqrt(sum(
        float(np.sum(np.square(np.asarray(v, np.float64))))
        for v in vectors)))


def run_pod(tmp_path, tag, nproc, replicas, extra=(), steps=6, L=3,
            timeout=300):
    """One async pod of the smoke model on the CPU: its JSON lines, the
    merged snapshot's counters, the pod_merged record, and stderr."""
    mpath = str(tmp_path / f"pod_{tag}.jsonl")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([SRC, env.get("PYTHONPATH", "")])
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dist_run", "--smoke",
         "--device", "cpu", "--sync-policy", "async", "--nproc", str(nproc),
         "--replicas", str(replicas), "--steps", str(steps), "--L", str(L),
         "--port", str(_free_port()), "--coord-port", str(_free_port()),
         "--metrics-out", mpath, *extra],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout + res.stderr
    out = {}
    for line in res.stdout.splitlines():
        if line.startswith("{"):
            out.update(json.loads(line))
    merged = [e for e in read_events(mpath, tolerate_torn_tail=True)
              if e["kind"] == "pod_merged"][-1]
    out["counters"] = {c["name"]: c["total"]
                       for c in merged["snapshot"]["counters"]}
    out["merged"] = merged
    out["stderr"] = res.stderr
    out["metrics_path"] = mpath
    return out


def _check_resume(tmp_path, start_nproc, replicas, shapes):
    """Checkpoint a ``start_nproc``-worker pod, resume it with each of
    ``shapes`` worker counts: consensus continuity (the resumed pod
    starts AT the checkpoint) and monotonic counters."""
    ck = str(tmp_path / "async_ck.npz")
    a = run_pod(tmp_path, "a", start_nproc, replicas,
                ["--checkpoint-out", ck])
    assert a["counters"]["pod.steps"] == start_nproc * 6
    assert a["async_checkpoint"] == ck and a["round"] == 2
    assert a["merged"]["missing_workers"] == 0
    vectors, rnd, meta = load_consensus(ck)
    assert rnd == 2 and consensus_digest(vectors) == a["consensus_digest"]
    ck_l2 = _consensus_l2(vectors)
    for nproc in shapes:
        r = run_pod(tmp_path, f"r{nproc}", nproc, replicas,
                    ["--resume", ck])
        assert r["merged"]["missing_workers"] == 0
        assert r["consensus_digest"] == a["consensus_digest"]   # the echo
        # every replica starts at the checkpoint and x moves only at a
        # consensus apply, so the first pulled consensus IS it (up to the
        # arrival order of the fold: the norm, not the digest)
        np.testing.assert_allclose(r["first_consensus_l2"], ck_l2,
                                   rtol=1e-5)
        assert r["base_round"] == 2
        assert r["counters"]["pod.steps"] == start_nproc * 6 + nproc * 6
        assert r["counters"]["pod.rounds"] == start_nproc * 2 + nproc * 2


def test_async_pod_checkpoints_and_resumes_shrunk_and_grown(tmp_path):
    _check_resume(tmp_path, 2, 6, (1, 3))


@pytest.mark.slow
def test_async_elastic_resume_grow_and_shrink(tmp_path):
    """The reference's reshape: a 4-worker pod of 12 replicas resumes
    as 2 and as 6 workers."""
    _check_resume(tmp_path, 4, 12, (2, 6))
