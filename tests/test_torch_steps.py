"""The port's step factories (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``) on the dense smoke model, the same
numpy params and batches given to both: Parle's decomposed inner, sync
and fused steps (losses and the x / y buffers), the fused round of the
overlapped sync with its flush (per-step losses and the final x), the
barrier round's absent flush, and the serving decode step (tokens and KV
caches after a prefill).  Tolerance: 1e-4, as every model-level parity
test of the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import parle as ref_parle
from repro.launch import steps as ref_steps
from repro_torch.configs import ParleConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import parle
from repro_torch.launch import steps
from repro_torch.models.convert import state_to_numpy
from torch_parity import MODEL_TOL, assert_close, both_params, leaf_pairs

REF_CFG = FAMILY_CONFIGS["dense"]
CFG = ModelConfig(**dataclasses.asdict(REF_CFG))
N, L, B, T = 2, 2, 2, 16
PCFG = dict(n_replicas=N, L=L, lr=0.05, lr_inner=0.05, batches_per_epoch=5)


@pytest.fixture(scope="module")
def params():
    return both_params(REF_CFG, seed=0)


def _tokens(lead, seed):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=lead + (B, T)).astype(np.int32)


def _batches(lead, seed):
    toks = _tokens(lead, seed)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


def _assert_fields_close(port, ref, fields, what):
    got = state_to_numpy(port)
    for f in fields:
        for path, p, r in leaf_pairs(got[f], getattr(ref, f)):
            assert_close(p, r, MODEL_TOL, f"{what} {f}{path}")
    assert int(got["step"]) == int(ref.step)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_parle_steps_match_reference(params, use_kernel):
    """Two inner steps, the sync, then two fused steps (the second
    syncs), with weight decay: on the CPU the kernel flag takes the
    kernels' plain versions, whose results equal the reference's."""
    rp, pp = params
    kw = dict(weight_decay=0.05, use_kernel=use_kernel)
    r_inner, r_sync, r_fused = (jax.jit(f) for f in ref_steps.make_parle_steps(
        REF_CFG, RefParleConfig(**PCFG), **kw))
    inner, sync, fused = steps.make_parle_steps(CFG, ParleConfig(**PCFG),
                                                **kw)
    rs = ref_parle.init(rp, RefParleConfig(**PCFG))
    ps = parle.init(pp, ParleConfig(**PCFG))
    for i in range(2):
        rb, pb = _batches((N,), seed=i)
        rs, rm = r_inner(rs, rb)
        ps, pm = inner(ps, pb)
        assert_close(pm["loss"], rm["loss"], MODEL_TOL, f"inner {i} loss")
    _assert_fields_close(ps, rs, ("x", "y", "z"), "inner")
    rs, ps = r_sync(rs), sync(ps)
    _assert_fields_close(ps, rs, ("x", "y", "z"), "sync")
    for i in range(2):
        rb, pb = _batches((N,), seed=10 + i)
        rs, rm = r_fused(rs, rb)
        ps, pm = fused(ps, pb)
        assert_close(pm["loss"], rm["loss"], MODEL_TOL, f"fused {i} loss")
        assert np.float32(pm["gamma"]) == np.float32(rm["gamma"])
        assert np.float32(pm["rho"]) == np.float32(rm["rho"])
    _assert_fields_close(ps, rs, ("x", "y", "z"), "fused")


def test_algorithm_round_and_flush_match_reference(params):
    """Two rounds of the overlapped sync through ``make_algorithm_round``,
    then ``make_algorithm_round_flush`` on the final state."""
    rp, pp = params
    kw = dict(PCFG, sync_overlap=True)
    rcfg, pcfg = RefParleConfig(**kw), ParleConfig(**kw)
    r_round = ref_steps.make_algorithm_round("parle", REF_CFG, rcfg)
    p_round = steps.make_algorithm_round("parle", CFG, pcfg)
    rs = ref_parle.dealias_state(ref_parle.init(rp, rcfg))
    ps = parle.init(pp, pcfg)
    for r in range(2):
        rb, pb = _batches((L, N), seed=20 + r)
        rs, rm = r_round(rs, rb)
        ps, pm = p_round(ps, pb)
        assert_close(pm["losses"], rm["losses"], MODEL_TOL, f"round {r}")
    rs = ref_steps.make_algorithm_round_flush("parle", rcfg)(rs)
    ps = steps.make_algorithm_round_flush("parle", pcfg)(ps)
    _assert_fields_close(ps, rs, ("x",), "flushed")


@pytest.mark.parametrize("algo", ["parle", "elastic_sgd", "sgd"])
def test_barrier_rounds_have_no_flush(algo):
    """Nothing is in flight without the overlapped sync, on both sides."""
    assert ref_steps.make_algorithm_round_flush(
        algo, RefParleConfig(**PCFG)) is None
    assert steps.make_algorithm_round_flush(algo, ParleConfig(**PCFG)) is None


def test_decode_step_matches_reference(params):
    """Greedy tokens and KV caches of four decode steps after a prefill."""
    rp, pp = params
    toks = _tokens((), seed=30)
    r_cache = ref_steps.make_prefill_step(REF_CFG)(
        rp, {"tokens": jnp.asarray(toks)},
        ref_steps.build_model(REF_CFG).init_cache(rp, B, T + 8))[1]
    p_cache = steps.make_prefill_step(CFG)(
        pp, {"tokens": torch.from_numpy(toks)},
        steps.build_model(CFG).init_cache(pp, B, T + 8))[1]
    r_decode = jax.jit(ref_steps.make_decode_step(REF_CFG))
    p_decode = steps.make_decode_step(CFG)
    r_tok = jnp.asarray(toks[:, -1:])
    p_tok = torch.from_numpy(toks[:, -1:])
    for g in range(4):
        r_tok, r_cache = r_decode(rp, {"tokens": r_tok}, r_cache)
        p_tok, p_cache = p_decode(pp, {"tokens": p_tok}, p_cache)
        np.testing.assert_array_equal(p_tok.numpy(), np.asarray(r_tok),
                                      err_msg=f"decode {g} tokens")
    assert_close(p_cache.k, r_cache.k, MODEL_TOL, "decode k cache")
    assert_close(p_cache.v, r_cache.v, MODEL_TOL, "decode v cache")
    assert int(p_cache.pos) == int(r_cache.pos) == T + 4
