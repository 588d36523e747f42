"""The port's dense model against the JAX reference on the same numpy
inputs: the building blocks, then the logits of ``forward``, of
``prefill`` + ``decode_step`` (dense cache), and of ``prefill_chunk`` +
``decode_step_paged`` (paged cache, with and without the paged-attention
kernel), for the tier-1 dense config and the Qwen2.5-3B smoke variant
(QKV bias, rope_theta 1e6).  f32 throughout, atol = rtol = 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from torch_parity import MODEL_TOL, assert_close, both_params

REF_CONFIGS = {
    "dense": FAMILY_CONFIGS["dense"],
    "qwen2.5-3b-smoke": ref_smoke_variant(REF_ARCHS["qwen2.5-3b"]),
}


def test_configs_are_copies_of_the_reference():
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        assert (dataclasses.asdict(smoke_variant(cfg))
                == dataclasses.asdict(ref_smoke_variant(REF_ARCHS[name])))


@pytest.fixture(scope="module", params=sorted(REF_CONFIGS))
def setup(request):
    name = request.param
    rcfg = REF_CONFIGS[name]
    pcfg = ModelConfig(**dataclasses.asdict(rcfg))   # the port's own type
    ref_params, port_params = both_params(rcfg, seed=0)
    return name, pcfg, rcfg, ref_params, port_params


# ------------------------------------------------------------------
# building blocks
# ------------------------------------------------------------------

def test_rms_norm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    assert_close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
                 ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w)),
                 MODEL_TOL, "rms_norm")
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        assert_close(layers.apply_rope(torch.from_numpy(x),
                                       torch.from_numpy(pos), theta),
                     ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           theta),
                     MODEL_TOL, f"apply_rope theta={theta}")
    h = rng.standard_normal((3, 16)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) / 4
          for s in ((16, 24), (16, 24), (24, 16))]
    assert_close(layers.swiglu(torch.from_numpy(h),
                               *[torch.from_numpy(m) for m in ws]),
                 ref_layers.swiglu(jnp.asarray(h),
                                   *[jnp.asarray(m) for m in ws]),
                 MODEL_TOL, "swiglu")


# ------------------------------------------------------------------
# whole-model logits
# ------------------------------------------------------------------

def test_forward_logits_match(setup):
    name, pcfg, rcfg, rp, pp = setup
    toks = np.random.default_rng(1).integers(
        0, pcfg.vocab_size, size=(2, 11)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: ref_tfm.forward(p, rcfg, t))(
        rp, jnp.asarray(toks))
    got, _ = tfm.forward(pp, pcfg, torch.from_numpy(toks))
    assert_close(got, want, MODEL_TOL, name)


def test_prefill_then_decode_logits_match(setup):
    name, pcfg, rcfg, rp, pp = setup
    rng = np.random.default_rng(2)
    B, T, S, G = 2, 9, 16, 3
    toks = rng.integers(0, pcfg.vocab_size, size=(B, T)).astype(np.int32)
    feed = rng.integers(0, pcfg.vocab_size, size=(G, B, 1)).astype(np.int32)

    r_prefill = jax.jit(lambda p, t, c: ref_tfm.prefill(p, rcfg, t, c))
    r_decode = jax.jit(lambda p, t, c: ref_tfm.decode_step(p, rcfg, t, c))
    r_lg, r_cache = r_prefill(rp, jnp.asarray(toks),
                              ref_tfm.init_cache(rp, rcfg, B, S))
    p_lg, p_cache = tfm.prefill(pp, pcfg, torch.from_numpy(toks),
                                tfm.init_cache(pp, pcfg, B, S))
    assert_close(p_lg, r_lg, MODEL_TOL, f"{name} prefill")
    for g in range(G):
        r_lg, r_cache = r_decode(rp, jnp.asarray(feed[g]), r_cache)
        p_lg, p_cache = tfm.decode_step(pp, pcfg, torch.from_numpy(feed[g]),
                                        p_cache)
        assert_close(p_lg, r_lg, MODEL_TOL, f"{name} decode {g}")
    assert int(p_cache.pos) == int(r_cache.pos) == T + G


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_chunk_then_paged_decode_logits_match(setup, use_kernel):
    """Two slots through page tables: chunked prefill (one prompt spans
    two chunks), then decode steps with an inactive row in the middle
    one (its writes go to the trash page)."""
    name, pcfg, rcfg, rp, pp = setup
    rng = np.random.default_rng(3)
    slots, P, ps, M, C = 2, 9, 8, 4, 8
    lens = (11, 6)
    prompts = [rng.integers(0, pcfg.vocab_size, size=T).astype(np.int32)
               for T in lens]
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
    actives = np.array([[True, True], [True, False], [True, True]])
    feed = rng.integers(0, pcfg.vocab_size,
                        size=(len(actives), slots, 1)).astype(np.int32)

    r_chunk = jax.jit(lambda p, t, c, s, f: ref_tfm.prefill_chunk(
        p, rcfg, t, c, s, f, 0))
    r_decode = jax.jit(lambda p, t, c, a: ref_tfm.decode_step_paged(
        p, rcfg, t, c, a, use_kernel=use_kernel))
    r_cache = ref_tfm.init_paged_cache(rp, rcfg, slots, P, ps, M)
    r_cache = r_cache._replace(table=jnp.asarray(table))
    p_cache = tfm.init_paged_cache(pp, pcfg, slots, P, ps, M)
    p_cache.table.copy_(torch.from_numpy(table))

    for s, prompt in enumerate(prompts):
        for f in range(0, len(prompt), C):
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :len(prompt[f:f + C])] = prompt[f:f + C]
            r_lg, r_cache = r_chunk(rp, jnp.asarray(chunk), r_cache,
                                    jnp.int32(s), jnp.int32(f))
            p_lg, p_cache = tfm.prefill_chunk(pp, pcfg,
                                              torch.from_numpy(chunk),
                                              p_cache, s, f, 0)
            valid = min(C, len(prompt) - f)
            assert_close(p_lg[:, :valid], r_lg[:, :valid], MODEL_TOL,
                         f"{name} slot {s} chunk at {f}")
    pos = np.array(lens, np.int32)
    r_cache = r_cache._replace(pos=jnp.asarray(pos))
    p_cache = p_cache._replace(pos=torch.from_numpy(pos.copy()))
    for g, active in enumerate(actives):
        r_lg, r_cache = r_decode(rp, jnp.asarray(feed[g]), r_cache,
                                 jnp.asarray(active))
        p_lg, p_cache = tfm.decode_step_paged(
            pp, pcfg, torch.from_numpy(feed[g]), p_cache,
            torch.from_numpy(active), use_kernel=use_kernel)
        rows = np.flatnonzero(active)       # inactive rows' logits are
        assert_close(p_lg[rows], np.asarray(r_lg)[rows], MODEL_TOL,
                     f"{name} paged decode {g}")  # garbage by contract
    np.testing.assert_array_equal(p_cache.pos.numpy(), np.asarray(r_cache.pos))
    # every live page position holds the reference's K (trash page 0 and
    # never-written tails excluded)
    for s in range(slots):
        n = int(p_cache.pos[s])
        for p in range(n):
            page, off = table[s, p // ps], p % ps
            assert_close(p_cache.k[:, page, off],
                         np.asarray(r_cache.k)[:, page, off], MODEL_TOL,
                         f"{name} pool k slot {s} pos {p}")
