"""The staleness-1 overlapped sync of the port (``--sync-overlap``): the
plain version of K6 (apply the carried consensus + int8 quantize) against
the reference oracle and the Pallas kernel in interpret mode, the
contracts of tests/test_sync_overlap.py inside the port (R overlapped
rounds + one flush = R barrier rounds, round-boundary resume), two smoke
rounds against the reference's overlapped rounds, the policy and the
runner's flush, and K6 against its plain version on the card (``gpu``).

Tolerances: K6 as the reference's own kernel test (codes within one,
floats rtol 1e-5 / atol 1e-6); trajectories at 1e-4 with flipped codes
bounded as in tests/test_torch_sync_compress.py."""
import dataclasses
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import parle_update as ref_pu
from repro.kernels import ref as ref_oracle
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ParleConfig
from repro_torch.core import compress, parle, registry
from repro_torch.kernels import ops
from repro_torch.kernels import parle_update as pu
from repro_torch.models.convert import state_to_numpy
from repro_torch.obs import Obs, read_events
from repro_torch.runtime import (BarrierPolicy, OverlapPolicy, RoundRunner,
                                 resolve_train_policy)
from test_torch_sync_compress import (CFG, RCFG, TRAJ_TOL,
                                      assert_trajectories_close,
                                      smoke_inputs)  # noqa: F401 (fixture)
from torch_parity import assert_close, leaf_pairs, port_rounds, ref_rounds

TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(gamma_scale=0.9, inv_rho=0.5, lr=0.05, mu=0.9)


def _loss(p, b):
    return ((p["w"] @ p["m"] - b["t"]) ** 2).mean(), ()


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 16))
                                  .astype(np.float32) * 0.1),
            "m": torch.from_numpy(rng.standard_normal((16, 4))
                                  .astype(np.float32) * 0.1)}


def _round_batches(r, L, n):
    rng = np.random.default_rng(10 + r)
    return {"t": torch.from_numpy(rng.standard_normal((L, n, 8, 4))
                                  .astype(np.float32))}


def _cfg(**kw):
    return ParleConfig(n_replicas=2, L=3, lr=0.05, lr_inner=0.05,
                       batches_per_epoch=5, lr_drop_steps=(4,),
                       lr_drop_factor=0.5, **kw)   # schedule crosses round 2


def _run(cfg, rounds=3, use_kernel=False, flush=False):
    algo = registry.get("parle")
    state = algo.init(_params(), cfg)
    round_fn = algo.make_round_fn(_loss, cfg, use_kernel=use_kernel)
    losses = []
    for r in range(rounds):
        state, m = round_fn(state, _round_batches(r, cfg.L, cfg.n_replicas))
        losses.append(m["losses"])
    if flush:
        state = algo.make_round_flush_fn(cfg)(state)
    return state, torch.cat(losses)


def _assert_states_equal(sa, sb, fields=("x", "y", "z", "v_x", "v_y")):
    for f in fields:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert int(sa.step) == int(sb.step)
    assert float(sa.scopes.gamma) == float(sb.scopes.gamma)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_overlap_plus_flush_bit_identical_f32(use_kernel):
    s_bar, l_bar = _run(_cfg(), use_kernel=use_kernel)
    s_ovl, l_ovl = _run(_cfg(sync_overlap=True), use_kernel=use_kernel,
                        flush=True)
    assert torch.equal(l_bar, l_ovl)                 # per-step losses too
    _assert_states_equal(s_bar, s_ovl)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_overlap_int8_error_feedback(use_kernel):
    """int8 EF sync under overlap against the barrier int8 path: the
    overlapped head quantizes the SAME payload x + e the barrier sync
    would, and the reduction is the same function.  The reference holds
    this to 2e-5; in the port it is in fact bit for bit (losses, state
    and residual), with the kernels' plain versions (K4 + K6 against
    K4 + K5) as without them."""
    s_bar, l_bar = _run(_cfg(sync_compress="int8"), use_kernel=use_kernel)
    s_ovl, l_ovl = _run(_cfg(sync_compress="int8", sync_overlap=True),
                        use_kernel=use_kernel, flush=True)
    for f in ("x", "y", "z", "v_x", "v_y", "e"):
        np.testing.assert_allclose(getattr(s_ovl, f).numpy(),
                                   getattr(s_bar, f).numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=f)
    assert torch.equal(l_bar, l_ovl)
    _assert_states_equal(s_bar, s_ovl, ("x", "y", "z", "v_x", "v_y", "e"))


def test_overlap_round_boundary_resume(tmp_path):
    """Checkpoints are written PRE-flush; a resumed run re-enters the
    overlap loop, which applies the carried consensus itself."""
    cfg = _cfg(sync_overlap=True, sync_compress="int8")
    algo = registry.get("parle")
    round_fn = algo.make_round_fn(_loss, cfg)
    state = algo.init(_params(), cfg)
    for r in range(2):
        state, _ = round_fn(state, _round_batches(r, cfg.L, cfg.n_replicas))
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, state, step=int(state.step), algo="parle")
    with open(path + ".json") as f:
        keys = json.load(f)["keys"]
    assert "c/w" in keys and "e/w" in keys

    resumed = ckpt.restore(path, algo.init(_params(), cfg), algo="parle")
    assert torch.equal(resumed.c, state.c) and torch.equal(resumed.e, state.e)
    resumed, _ = algo.make_round_fn(_loss, cfg)(
        parle.dealias_state(resumed), _round_batches(2, cfg.L,
                                                     cfg.n_replicas))
    resumed = algo.make_round_flush_fn(cfg)(resumed)
    uninterrupted, _ = _run(cfg, rounds=3, flush=True)
    _assert_states_equal(uninterrupted, resumed,
                         ("x", "y", "z", "v_x", "v_y", "e", "c"))


def test_flush_of_a_fresh_state_is_itself_and_barrier_has_none():
    algo = registry.get("parle")
    cfg = _cfg(sync_overlap=True)
    st = algo.init(_params(), cfg)
    x = st.x.clone()
    assert algo.make_round_flush_fn(cfg)(st) is st and torch.equal(st.x, x)
    assert algo.make_round_flush_fn(_cfg()) is None
    assert registry.get("entropy_sgd").make_round_flush_fn(cfg) is not None


@pytest.mark.parametrize("emit_y", [False, True])
def test_apply_quantize_kernel_matches_oracle(emit_y):
    """K6's plain version against the oracle (``ref.parle_apply_quantize``)
    and the Pallas kernel: the fused arithmetic may differ by an ulp in
    x', so codes may flip by at most one where a rounding edge sits in
    that ulp; floats at 1e-5 / 1e-6.  The fused bf16 y' is bf16(x')."""
    rng = np.random.default_rng(5)
    R, M = 2, compress.PAD_MULTIPLE
    x = rng.standard_normal((R, M)).astype(np.float32)
    z = (x + 0.1 * rng.standard_normal((R, M))).astype(np.float32)
    v = (0.01 * rng.standard_normal((R, M))).astype(np.float32)
    c = rng.standard_normal(M).astype(np.float32)
    e = (0.005 * rng.standard_normal((R, M))).astype(np.float32)
    want = ref_oracle.parle_apply_quantize(*map(jnp.asarray, (x, z, v, c, e)),
                                           **KW)
    scal = np.array(list(KW.values()), np.float32)
    pallas = ref_pu.parle_apply_quantize_flat(
        *map(jnp.asarray, (x, z, v, c, e, scal)), interpret=True,
        y_dtype=jnp.bfloat16 if emit_y else None)
    got = pu.parle_apply_quantize_plain(
        *(torch.from_numpy(a) for a in (x, z, v, c, e)),
        torch.from_numpy(scal), y_dtype=torch.bfloat16 if emit_y else None)
    assert len(got) == len(pallas) == (6 if emit_y else 5)
    for ref_out in (want, pallas):
        for name, a, b in zip(("x", "v", "q", "s", "e"), got, ref_out):
            b = np.asarray(b).reshape(a.shape)
            if name == "q":
                assert np.abs(a.numpy().astype(np.int32)
                              - b.astype(np.int32)).max() <= 1
            else:
                assert_close(a, b, TOL, f"K6 plain {name}")
    if emit_y:
        assert torch.equal(got[5], got[0].to(torch.bfloat16))


def test_apply_consensus_quantize_wrapper_on_cpu_runs_in_place():
    rng = np.random.default_rng(6)
    shape = (2, compress.PAD_MULTIPLE)
    x, z, v, e = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for _ in range(4))
    c = x.mean(0)
    want = pu.parle_apply_quantize_plain(
        x, z, v, c, e, pu.pack_scalars(*KW.values()), y_dtype=torch.bfloat16)
    y16 = torch.zeros(shape, dtype=torch.bfloat16)
    out = ops.parle_apply_consensus_quantize(x, z, v, c, e, y_out=y16, **KW)
    assert out[0] is x and out[1] is v and out[2] is y16 and out[5] is e
    for a, b in zip((x, v, out[3], out[4], e, y16), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method,use_kernel", [("int8", False),
                                               ("int8", True),
                                               ("none", False)])
def test_two_overlapped_rounds_match_reference(smoke_inputs, method,
                                               use_kernel):
    """Two overlapped smoke Qwen2.5-3B rounds plus the flush, against the
    reference's on the same params and batches."""
    np_params, batches = smoke_inputs
    kw = dict(n_replicas=2, L=3, batches_per_epoch=1, sync_compress=method,
              sync_overlap=True)
    ref, ref_losses = ref_rounds(RCFG, np_params, batches, use_kernel, **kw)
    port, port_losses = port_rounds(CFG, np_params, batches, use_kernel,
                                    **kw)
    what = f"{method} overlap use_kernel={use_kernel}"
    if method == "int8":
        assert_trajectories_close(port, port_losses, ref, ref_losses,
                                  method, what)
    else:
        assert_close(port_losses, ref_losses, TRAJ_TOL, f"{what} losses")
        for path, p, r in leaf_pairs(state_to_numpy(port)["x"], ref.x):
            assert_close(p, r, TRAJ_TOL, f"{what} final x{path}")
    # the last round's consensus, still carried after the flush
    for path, p, r in leaf_pairs(state_to_numpy(port)["c"], ref.c):
        assert_close(p, r, TRAJ_TOL, f"{what} c{path}")
    assert float(port.scopes.gamma) == float(ref.scopes.gamma)


# ------------------------------------------------------------------
# the policy and the runner's flush
# ------------------------------------------------------------------

def _args(**kw):
    base = dict(sync_policy="", sync_overlap=False, round_fused=True,
                algo="parle")
    return SimpleNamespace(**{**base, **kw})


def test_policy_resolution_and_guards():
    assert isinstance(resolve_train_policy(_args()), BarrierPolicy)
    args = _args(sync_policy="overlap")
    assert isinstance(resolve_train_policy(args), OverlapPolicy)
    assert args.sync_overlap                 # the cfg plumbing keys off it
    assert isinstance(resolve_train_policy(_args(sync_overlap=True,
                                                 algo="entropy_sgd")),
                      OverlapPolicy)
    with pytest.raises(SystemExit, match="requires --round-fused"):
        resolve_train_policy(_args(sync_overlap=True, round_fused=False))
    with pytest.raises(SystemExit, match="no round-level sync"):
        resolve_train_policy(_args(sync_overlap=True, algo="elastic_sgd"))
    with pytest.raises(SystemExit, match="item 7"):
        resolve_train_policy(_args(sync_policy="async"))


def test_runner_flushes_once_after_the_last_round(tmp_path):
    cfg = _cfg(sync_overlap=True)
    algo = registry.get("parle")
    policy = OverlapPolicy()
    metrics = tmp_path / "m.jsonl"
    obs = Obs(str(metrics))
    state, _ = RoundRunner(obs).run_rounds(
        algo.init(_params(), cfg),
        policy.make_round_fn(algo, _loss, cfg),
        lambda step: _round_batches(step // cfg.L, cfg.L, cfg.n_replicas),
        start=0, rounds=3, L=cfg.L, tokens_per_round=1,
        flush_fn=policy.make_flush_fn(algo, cfg))
    obs.finalize()
    barrier, _ = _run(dataclasses.replace(cfg, sync_overlap=False))
    _assert_states_equal(barrier, state)
    events = read_events(str(metrics))
    flushes = [e for e in events if e["kind"] == "staleness_flush"]
    assert len(flushes) == 1 and flushes[0]["step"] == 9
    snap = [e for e in events if e["kind"] == "metrics_snapshot"][0]
    assert "train.staleness_flushes" in str(snap["snapshot"])


# ------------------------------------------------------------------
# on the card: K6 against its plain version, bit for bit
# ------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("emit_y", [False, True])
def test_cuda_k6_equals_plain_version(emit_y):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    R, M = 2, 2 * compress.PAD_MULTIPLE
    gen = torch.Generator(device=dev).manual_seed(6)
    x, z, v, e = (torch.randn((R, M), generator=gen, device=dev)
                  for _ in range(4))
    c = torch.randn(M, generator=gen, device=dev)
    scal = pu.pack_scalars(*KW.values(), device=dev)
    want = pu.parle_apply_quantize_plain(
        x, z, v, c, e, scal, y_dtype=torch.bfloat16 if emit_y else None)
    q = torch.empty((R, M), dtype=torch.int8, device=dev)
    s = torch.empty((R, M // compress.CHUNK), device=dev)
    y_out = torch.empty_like(x, dtype=torch.bfloat16) if emit_y else None
    got = pu.parle_apply_quantize_cuda(x, z, v, c, e, q, s, scal,
                                       y_out=y_out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
