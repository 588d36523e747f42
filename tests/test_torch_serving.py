"""The port's serving engine: greedy tokens equal the JAX reference
engine's token for token (dense, paged, paged through the paged-attention
kernel), then the reference's own serving contracts checked inside the
port, and the device rule."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.serving import Engine as RefEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model, cache_positions
from repro_torch.serving import (Engine, SamplingParams, make_naive_fns,
                                 naive_generate)
from torch_parity import both_params

GEN = 8
MAX_LEN = 32
MIXED_LENS = (5, 9, 12, 7)
MODES = {"dense": dict(paged=False),
         "paged": dict(paged=True, page_size=16, prefill_chunk=8),
         "paged_kernel": dict(paged=True, page_size=16, prefill_chunk=8,
                              use_paged_kernel=True)}

REF_CFG = FAMILY_CONFIGS["dense"]
CFG = ModelConfig(**dataclasses.asdict(REF_CFG))


@pytest.fixture(scope="module")
def params():
    return both_params(REF_CFG, seed=0)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG.vocab_size, size=T).astype(np.int32)
            for T in MIXED_LENS]


def _run(engine_cls, cfg, p, reqs, *, gen=GEN, arrivals=None, eos_id=None,
         num_slots=2, max_len=MAX_LEN, **kw):
    eng = engine_cls(cfg, p, num_slots=num_slots, max_len=max_len,
                     decode_chunk=3, **kw)
    for i, r in enumerate(reqs):
        eng.submit(r, max_new_tokens=gen, eos_id=eos_id,
                   arrival=0 if arrivals is None else arrivals[i])
    return eng.run(), eng


def _port(p, reqs, **kw):
    return _run(Engine, CFG, p, reqs, device="cpu", **kw)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"req {uid}")


# ------------------------------------------------------------------
# across packages: the port's engine emits the reference's tokens
# ------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_tokens_match_reference_engine(mode, params, prompts):
    ref_p, port_p = params
    want, _ = _run(RefEngine, REF_CFG, ref_p, prompts, **MODES[mode])
    got, _ = _port(port_p, prompts, **MODES[mode])
    _assert_same(got, want)


# ------------------------------------------------------------------
# the reference's serving contracts, inside the port
# ------------------------------------------------------------------

def _naive(port_p, reqs, gen=GEN):
    fns = make_naive_fns(CFG)
    model = build_model(CFG)
    outs = {}
    for i, r in enumerate(reqs):
        cache = model.init_cache(port_p, 1, MAX_LEN)
        toks, _ = naive_generate(fns, port_p,
                                 {"tokens": torch.from_numpy(r)[None]},
                                 cache, gen)
        outs[i] = toks[0].numpy()
    return outs


def test_first_token_is_prefill_argmax_and_positions_exact(params):
    """The first emitted token is the argmax of the PREFILL logits' last
    row, and prefill(T) + G decodes leave the cache at exactly T + G."""
    _, port_p = params
    model = build_model(CFG)
    T = 12
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, CFG.vocab_size, size=(2, T)).astype(np.int32))
    logits, cache = model.prefill(port_p, {"tokens": toks},
                                  model.init_cache(port_p, 2, MAX_LEN))
    assert int(cache_positions(cache)) == T
    first = torch.argmax(logits[:, -1], dim=-1)
    out, cache = naive_generate(make_naive_fns(CFG), port_p,
                                {"tokens": toks},
                                model.init_cache(port_p, 2, MAX_LEN), GEN)
    np.testing.assert_array_equal(out[:, 0].numpy(), first.numpy())
    assert int(cache_positions(cache)) == T + GEN - 1
    tok = out[:, -1:]
    for g in range(1, 4):
        logits, cache = model.decode(port_p, {"tokens": tok}, cache)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        assert int(cache_positions(cache)) == T + GEN - 1 + g


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_naive(mode, params, prompts):
    """Engine tokens (fewer slots than requests, so slots are reused)
    equal the one-request-at-a-time loop's, in every layout."""
    _, port_p = params
    got, eng = _port(port_p, prompts, **MODES[mode])
    _assert_same(got, _naive(port_p, prompts))
    tp = eng.throughput()
    assert 0.0 < tp["slot_utilization"] <= 1.0
    assert tp["wasted_decode_tokens"] >= 0


def test_eos_truncation(params, prompts):
    _, port_p = params
    naive = _naive(port_p, prompts)
    eos = int(naive[0][GEN // 2])      # occurs mid-sequence in request 0

    def truncate(seq):
        hits = np.flatnonzero(seq == eos)
        return seq[:hits[0] + 1] if hits.size else seq

    for mode in ("dense", "paged"):
        got, _ = _port(port_p, prompts, eos_id=eos, **MODES[mode])
        _assert_same(got, {i: truncate(s) for i, s in naive.items()})


def test_staggered_arrivals(params, prompts):
    _, port_p = params
    naive = _naive(port_p, prompts)
    for mode in ("dense", "paged"):
        got, _ = _port(port_p, prompts, arrivals=list(range(len(prompts))),
                       **MODES[mode])
        _assert_same(got, naive)


def test_prefix_sharing_hits_without_changing_tokens(params):
    _, port_p = params
    rng = np.random.default_rng(11)
    shared = rng.integers(0, CFG.vocab_size, size=32).astype(np.int32)
    reqs = [np.concatenate([shared, rng.integers(
        0, CFG.vocab_size, size=4).astype(np.int32)]) for _ in range(4)]
    arrivals = [0, 6, 6, 6]     # request 0 publishes its pages first
    dense, _ = _port(port_p, reqs, max_len=64, arrivals=arrivals,
                     num_slots=4)
    paged, eng = _port(port_p, reqs, max_len=64, arrivals=arrivals,
                       num_slots=4, paged=True, page_size=16,
                       prefill_chunk=16)
    _assert_same(paged, dense)
    assert eng.pool.stats["prefix_hit_tokens"] == 3 * 32  # 2 pages x 3 reqs
    assert eng.throughput()["prefix_hit_rate"] > 0


def test_identical_prompt_copy_on_extend(params):
    _, port_p = params
    prompt = np.random.default_rng(12).integers(
        0, CFG.vocab_size, size=32).astype(np.int32)
    reqs = [prompt, prompt.copy()]
    dense, _ = _port(port_p, reqs, max_len=64, arrivals=[0, 6])
    paged, eng = _port(port_p, reqs, max_len=64, arrivals=[0, 6],
                       paged=True, page_size=16, prefill_chunk=16)
    _assert_same(paged, dense)
    assert eng.pool.stats["cow_copies"] == 1
    assert eng.pool.stats["prefix_hit_tokens"] == 31   # prompt_len - 1


def test_page_exhaustion_backpressures_not_crashes(params, prompts):
    _, port_p = params
    dense, _ = _port(port_p, prompts)
    paged, eng = _port(port_p, prompts, num_slots=4, paged=True,
                       page_size=16, prefill_chunk=8, num_pages=4,
                       prefix_share=False)
    _assert_same(paged, dense)
    assert eng.throughput()["counters"]["backpressure"] > 0
    assert eng.pool.alloc.num_free == eng.pool.alloc.usable  # all returned


def test_topk1_equals_greedy(params, prompts):
    _, port_p = params
    sp = SamplingParams(temperature=0.8, top_k=1)
    for mode in ("dense", "paged"):
        got, _ = _port(port_p, prompts[:2], sampling=sp, **MODES[mode])
        greedy, _ = _port(port_p, prompts[:2], **MODES[mode])
        _assert_same(got, greedy)


def test_sampling_temperature_is_seeded(params, prompts):
    _, port_p = params
    sp = SamplingParams(temperature=1.0, top_k=8)
    a, _ = _port(port_p, prompts[:2], sampling=sp, seed=3)
    b, _ = _port(port_p, prompts[:2], sampling=sp, seed=3)
    _assert_same(a, b)
    for toks in a.values():
        assert toks.shape == (GEN,)
        assert ((toks >= 0) & (toks < CFG.vocab_size)).all()


def test_deadline_sheds_queued_and_running_requests(params, prompts):
    """An expired deadline sheds a queued request with zero tokens and
    evicts a running one keeping its partial output; paged slots give
    their pages back."""
    _, port_p = params
    eng = Engine(CFG, port_p, num_slots=1, max_len=MAX_LEN, decode_chunk=1,
                 paged=True, page_size=16, prefill_chunk=8, device="cpu")
    running = eng.submit(prompts[0], max_new_tokens=GEN, deadline_ms=1e4)
    queued = eng.submit(prompts[1], max_new_tokens=GEN, deadline_ms=1e-3)
    eng.step()                          # prefill + 1 decode of `running`
    eng._deadline[running] = 0.0        # expire it now
    res = eng.run()
    assert res[queued].shape == (0,)
    assert 0 < res[running].shape[0] < GEN
    assert eng.throughput()["counters"]["deadline_exceeded"] == 2
    assert eng.pool.alloc.num_free == eng.pool.alloc.usable


# ------------------------------------------------------------------
# the device rule
# ------------------------------------------------------------------

def test_engine_defaults_to_cuda_and_never_falls_back(params, monkeypatch):
    _, port_p = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(CFG, port_p, num_slots=2, max_len=MAX_LEN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(CFG, port_p, num_slots=2, max_len=MAX_LEN, device="cuda")
    eng = Engine(CFG, port_p, num_slots=2, max_len=MAX_LEN, device="cpu")
    assert eng.cache.k.device.type == "cpu"
