"""The port's moe family (``models/moe.py``'s flat top-k dispatch inside
``transformer.py``'s block) against the JAX reference on the same numpy
inputs: forward logits and the load-balance loss, the dispatch under
capacity drops, loss and grads, SGD lowering the loss, prefill + decode,
the paged entry points (with and without the paged-attention kernel
flag: K8's plain version on the CPU), the engine's tokens (dense, paged,
paged through K8; the reference engine's and the port's naive loop's),
and prefix sharing; the forward of the Qwen1.5-MoE-A2.7B and
Llama-4-Scout smoke variants too (their decode and Parle step are in
test_torch_arch_smoke.py).  The grouped and shard_map
dispatches equal the flat one where nothing drops (held to the
reference's own in test_torch_moe_dispatch.py).

Tolerance: f32 logits, loss and grads within
rtol = atol = 1e-5 (``TOL``); the largest error measured is printed
(``pytest -s``).  Tokens are compared exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models import moe as ref_moe
from repro.serving import Engine as RefEngine
from repro_torch.models import megatron, moe
from repro_torch.models.model import build_model
from repro_torch.serving import Engine, make_naive_fns, naive_generate
from torch_parity import (assert_close, assert_same_tokens, both_params,
                          check_forward, check_loss_and_grads,
                          check_loss_decreases, check_paged_entry_points,
                          check_prefill_decode,
                          family_batch, family_requests, numpy_params,
                          port_config, run_engine, to_torch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
REF_CFG = FAMILY_CONFIGS["moe"]
CFG = port_config(REF_CFG)
SMOKE = {name: ref_smoke_variant(REF_ARCHS[name])
         for name in ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")}
LENS = (5, 9, 12, 7)


@pytest.fixture(scope="module")
def params():
    return both_params(REF_CFG, seed=0)


@pytest.mark.parametrize("name", ["t-moe"] + sorted(SMOKE))
def test_forward_and_aux_match_reference(name):
    rcfg = SMOKE.get(name, REF_CFG)
    check_forward(rcfg, both_params(rcfg, seed=0), TOL, family_batch(rcfg))


def test_dispatch_with_capacity_drops_matches_reference():
    """A capacity small enough that the busiest experts drop routings:
    the same tokens are kept (stable order) and the output matches."""
    rcfg = dataclasses.replace(REF_CFG, capacity_factor=0.5,
                               num_shared_experts=0)
    tree = numpy_params(rcfg, seed=3)["blocks"]["moe"]
    layer = {k: v[0] for k, v in tree.items()}
    x = np.random.default_rng(4).standard_normal(
        (2, 32, rcfg.d_model)).astype(np.float32)
    want, r_aux = ref_moe.moe_forward(jax.tree.map(jnp.asarray, layer), rcfg,
                                      jnp.asarray(x))
    pl = {k: torch.from_numpy(v) for k, v in layer.items()}
    got, aux = moe.moe_forward(pl, port_config(rcfg), torch.from_numpy(x))
    _, _, ids = moe.route(pl, rcfg, torch.from_numpy(x).reshape(64, -1))
    counts = torch.bincount(ids.reshape(-1), minlength=rcfg.num_experts)
    assert int(counts.max()) > moe._capacity(64, rcfg)     # drops happen
    assert_close(got, want, TOL, "moe output under drops")
    assert_close(aux, r_aux, TOL, "moe aux under drops")


def test_loss_and_grads_match_reference():
    check_loss_and_grads(REF_CFG, numpy_params(REF_CFG, seed=0), TOL,
                         family_batch(REF_CFG, seed=2))


def test_moe_routing_load_balance(params):
    """The reference's contract: the aux loss is >= 0 (and equals the
    reference's, checked in the forward test)."""
    _, pp = params
    _, metrics = build_model(CFG).loss(pp, to_torch(family_batch(REF_CFG)))
    assert float(metrics["aux"]) >= 0.0


def test_loss_decreases_under_sgd():
    check_loss_decreases(REF_CFG, numpy_params(REF_CFG, seed=0),
                         family_batch(REF_CFG, seed=2))


@pytest.mark.parametrize("change", [dict(moe_groups=4),
                                    dict(moe_impl="shard_map")])
def test_expert_parallel_dispatch_raises(params, change):
    """Both dispatches run (they once raised, naming "queue 1, item 7"):
    at this drop-free capacity the grouped dispatch and two
    expert-parallel columns summed equal the flat dispatch (the reference
    contract's rtol 1e-5 / atol 1e-6), and the shard_map setting without
    a context is the flat dispatch itself
    (``tests/test_torch_moe_dispatch.py`` holds both to the reference)."""
    _, pp = params
    cfg = dataclasses.replace(CFG, **change)
    layer = {k: ({kk: vv[0] for kk, vv in v.items()} if k == "shared"
                 else v[0]) for k, v in pp["blocks"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    flat, flat_aux = moe.moe_forward(layer, CFG, x)
    got, aux = moe.moe_forward(layer, cfg, x)
    if cfg.moe_impl == "shard_map":
        assert torch.equal(got, flat)
        parts = []
        for m in range(2):
            with megatron.tensor_parallel(megatron.TensorParallel(2, m)):
                parts.append(moe.moe_forward(layer, cfg, x)[0])
        got = parts[0] + parts[1]
    assert_close(got, flat, dict(rtol=1e-5, atol=1e-6), f"{change} vs flat")
    assert_close(aux, flat_aux, dict(rtol=1e-5, atol=1e-6), "aux")


def test_prefill_then_decode_match_reference(params):
    check_prefill_decode(REF_CFG, params, TOL, family_batch(REF_CFG, T=12))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_entry_points_match_reference(params, use_kernel):
    req = family_requests(REF_CFG, (27,), seed=5)[0]
    check_paged_entry_points(REF_CFG, params, TOL, req, use_kernel)


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
    held across packages: every mode of the port's engine emits the
    reference engine's greedy tokens."""
    _, pp = params
    got, _ = run_engine(Engine, CFG, pp, family_requests(REF_CFG, LENS),
                        device="cpu", **mode)
    assert_same_tokens(got, ref_tokens)


def test_engine_matches_naive_exactly(params, ref_tokens):
    _, pp = params
    fns = make_naive_fns(CFG)
    model = build_model(CFG)
    for i, r in enumerate(family_requests(REF_CFG, LENS)):
        toks, _ = naive_generate(fns, pp, to_torch({"tokens": r["tokens"]
                                                    [None]}),
                                 model.init_cache(pp, 1, 32), 8)
        np.testing.assert_array_equal(toks[0].numpy(), ref_tokens[i])


def test_prefix_sharing_hits_without_changing_tokens(params):
    """Staggered moe requests sharing a 32-token prefix: the later ones
    resume prefill past the shared pages and emit the dense engine's
    tokens."""
    _, pp = params
    rng = np.random.default_rng(11)
    shared = rng.integers(0, CFG.vocab_size, size=32).astype(np.int32)
    reqs = [{"tokens": np.concatenate([shared, rng.integers(
        0, CFG.vocab_size, size=4).astype(np.int32)])} for _ in range(4)]
    kw = dict(max_len=64, arrivals=[0, 6, 6, 6], num_slots=4, device="cpu")
    dense, _ = run_engine(Engine, CFG, pp, reqs, **kw)
    paged, eng = run_engine(Engine, CFG, pp, reqs, paged=True, page_size=16,
                            prefill_chunk=16, **kw)
    assert_same_tokens(paged, dense)
    assert eng.pool.stats["prefix_hit_tokens"] == 3 * 32  # 2 pages x 3 reqs
    assert eng.throughput()["prefix_hit_rate"] > 0

