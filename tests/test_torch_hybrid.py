"""The port's hybrid family (``models/hybrid.py``: Mamba2 layers and one
shared attention block, Zamba2-style) against the JAX reference on the
same numpy inputs: forward logits on the plain path and with
``use_flash`` and ``use_kernel`` (K3's and K9's plain versions on the
CPU; the reference's Pallas kernels in interpret mode), loss and grads,
SGD lowering the loss, prefill + decode (unpadded and bucket-padded),
the paged entry points with and without the paged-attention kernel flag,
the ``HybridCache`` slot write and positions, the engine's tokens
(dense, paged, paged through K8) against the reference engine's and the
port's naive loop, and the
sites' geometry; the Zamba2-1.2B smoke variant's forward, decode and
Parle step are in test_torch_arch_smoke.py.

The params are numpy draws with ``A_log`` and ``dt_bias`` from the
Mamba2 init (``torch_parity.ssm_init_draws``).  Tolerance: f32 logits,
loss and grads within rtol = atol = 1e-5 (``TOL``);
the largest error measured is printed (``pytest -s``).  Tokens are
compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models import hybrid as ref_hybrid
from repro.serving import Engine as RefEngine
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import hybrid
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import (build_model, cache_positions,
                                      with_cache_positions)
from repro_torch.serving import Engine, make_naive_fns, naive_generate
from repro_torch.serving import cache as cache_lib
from torch_parity import (assert_close, assert_same_tokens, check_forward,
                          check_loss_and_grads, check_loss_decreases,
                          check_paged_entry_points,
                          check_prefill_decode, family_batch,
                          family_requests, numpy_params, port_config,
                          run_engine, ssm_init_draws, to_torch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
REF_CFG = FAMILY_CONFIGS["hybrid"]
CFG = port_config(REF_CFG)
SMOKE = ref_smoke_variant(REF_ARCHS["zamba2-1.2b"])
LENS = (5, 9, 12, 7)


def _tree(rcfg):
    return ssm_init_draws(numpy_params(rcfg, seed=0))


def _both(rcfg):
    tree = _tree(rcfg)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def params():
    return _both(REF_CFG)


def test_sites_follow_the_reference():
    for rcfg in (REF_CFG, SMOKE, REF_ARCHS["zamba2-1.2b"]):
        assert hybrid._group_sizes(rcfg) == ref_hybrid._group_sizes(rcfg)
        assert hybrid.num_attn_sites(rcfg) == ref_hybrid.num_attn_sites(rcfg)
    assert hybrid.num_attn_sites(REF_ARCHS["zamba2-1.2b"]) == 7


def test_forward_matches_reference(params):
    check_forward(REF_CFG, params, TOL, family_batch(REF_CFG))


def test_kernel_paths_match_reference(params):
    """``use_flash`` and ``use_kernel`` together: K3 once per site and K9
    once per SSM layer on the card; here both take their plain versions
    (no launch), the reference its Pallas kernels in interpret mode."""
    rp, pp = params
    toks = family_batch(REF_CFG)["tokens"]
    want, _ = ref_hybrid.forward(rp, REF_CFG, jnp.asarray(toks),
                                 use_flash=True, use_kernel=True)
    before = (fa.launches, ssd.launches)
    got, _ = hybrid.forward(pp, CFG, torch.from_numpy(toks), use_flash=True,
                            use_kernel=True)
    assert (fa.launches, ssd.launches) == before
    assert_close(got, want, TOL, "hybrid use_flash + use_kernel logits")


def test_loss_and_grads_match_reference():
    check_loss_and_grads(REF_CFG, _tree(REF_CFG), TOL,
                         family_batch(REF_CFG, seed=2))


def test_loss_decreases_under_sgd():
    check_loss_decreases(REF_CFG, _tree(REF_CFG),
                         family_batch(REF_CFG, seed=2))


def test_prefill_then_decode_match_reference(params):
    check_prefill_decode(REF_CFG, params, TOL, family_batch(REF_CFG, T=12))


def test_bucketed_prefill_matches_reference(params):
    """A zero-padded prompt with ``valid`` live tokens, as the dense
    engine prefills: logits of the live rows and every cache field."""
    rp, pp = params
    toks = family_batch(REF_CFG, T=16)["tokens"]
    toks[:, 11:] = 0
    rc = ref_hybrid.prefill(rp, REF_CFG, jnp.asarray(toks),
                            ref_hybrid.init_cache(REF_CFG, 2, 32),
                            valid=jnp.int32(11))
    pc = hybrid.prefill(pp, CFG, torch.from_numpy(toks),
                        hybrid.init_cache(CFG, 2, 32), valid=11)
    assert_close(pc[0][:, :11], rc[0][:, :11], TOL, "bucketed logits")
    for what in ("conv", "state"):
        assert_close(getattr(pc[1].ssm, what), getattr(rc[1].ssm, what),
                     TOL, f"bucketed ssm {what}")
    assert_close(pc[1].kv.k[:, :, :11], rc[1].kv.k[:, :, :11], TOL,
                 "bucketed site k")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_entry_points_match_reference(params, use_kernel):
    req = family_requests(REF_CFG, (27,), seed=5)[0]
    check_paged_entry_points(REF_CFG, params, TOL, req, use_kernel)


def test_hybrid_cache_positions_and_slot_write(params):
    """Its three pos fields get a buffer each; ``write_slot`` copies a
    one-request cache (sites / layers leading) into one slot row and
    sets that row of every pos field, leaving the other rows alone."""
    _, pp = params
    model = build_model(CFG)
    batch_cache = cache_lib.init_slot_cache(model, pp, 3, 32)
    ptrs = {c.pos.data_ptr() for c in (batch_cache, batch_cache.ssm,
                                       batch_cache.kv)}
    assert len(ptrs) == 3
    toks = family_batch(REF_CFG, B=1, T=10)["tokens"]
    _, one = model.prefill(pp, {"tokens": torch.from_numpy(toks)},
                           model.init_cache(pp, 1, 32))
    before = [t.clone() for t in (batch_cache.ssm.state, batch_cache.kv.k)]
    cache_lib.write_slot(batch_cache, one, 1, 10)
    for got, want in ((batch_cache.ssm.conv, one.ssm.conv),
                      (batch_cache.ssm.state, one.ssm.state),
                      (batch_cache.kv.k, one.kv.k),
                      (batch_cache.kv.v, one.kv.v)):
        assert torch.equal(got[:, 1], want[:, 0])
    for got, old in zip((batch_cache.ssm.state, batch_cache.kv.k), before):
        assert torch.equal(got[:, 0], old[:, 0])
        assert torch.equal(got[:, 2], old[:, 2])
    for c in (batch_cache, batch_cache.ssm, batch_cache.kv):
        assert c.pos.tolist() == [0, 10, 0]
    assert cache_positions(batch_cache).tolist() == [0, 10, 0]
    moved = with_cache_positions(batch_cache, torch.tensor([1, 2, 3]))
    assert len({c.pos.data_ptr() for c in (moved, moved.ssm, moved.kv)}) == 3


@pytest.fixture(scope="module")
def ref_tokens(params):
    rp, _ = params
    return run_engine(RefEngine, REF_CFG, rp,
                      family_requests(REF_CFG, LENS))[0]


@pytest.mark.parametrize("mode", [
    dict(), dict(paged=True, page_size=16, prefill_chunk=8),
    dict(paged=True, page_size=16, prefill_chunk=8, use_paged_kernel=True)],
    ids=["dense", "paged", "paged_kernel"])
def test_engine_tokens_match_reference_engine(params, ref_tokens, mode):
    """The reference's engine == naive and paged == dense contracts,
    held across packages; the paged engine rounds its prefill chunk up
    to ``ssm_chunk`` and reserves pages for the sites' KV."""
    _, pp = params
    got, eng = run_engine(Engine, CFG, pp, family_requests(REF_CFG, LENS),
                          device="cpu", **mode)
    assert_same_tokens(got, ref_tokens)
    if mode:
        assert eng.uses_pages and eng.prefill_chunk_len == CFG.ssm_chunk


def test_engine_matches_naive_exactly(params, ref_tokens):
    _, pp = params
    fns = make_naive_fns(CFG)
    model = build_model(CFG)
    for i, r in enumerate(family_requests(REF_CFG, LENS)):
        toks, _ = naive_generate(fns, pp, to_torch({"tokens": r["tokens"]
                                                    [None]}),
                                 model.init_cache(pp, 1, 32), 8)
        np.testing.assert_array_equal(toks[0].numpy(), ref_tokens[i])

