"""Shared fixtures.  NOTE: no XLA_FLAGS device-count override here —
smoke tests and benches must see the single real CPU device (the 512
placeholder devices belong ONLY to launch/dryrun.py)."""
import jax
import jax.numpy as jnp
import pytest

from repro.configs.base import ModelConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running coverage, excluded from the tier-1 default "
        "run (pytest.ini addopts); select with -m slow")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; skips (inside a fixture) where there is "
        "none; select with -m gpu")


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


FAMILY_CONFIGS = {
    "dense": ModelConfig(name="t-dense", family="dense", num_layers=2,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=512, head_dim=32),
    "moe": ModelConfig(name="t-moe", family="moe", num_layers=2, d_model=128,
                       num_heads=4, num_kv_heads=2, d_ff=0, vocab_size=512,
                       head_dim=32, num_experts=4, top_k=2, expert_d_ff=128,
                       num_shared_experts=1, shared_expert_d_ff=128,
                       # generous capacity: decode-vs-forward tests need
                       # drop-free routing (capacity drops are exercised
                       # separately in test_models)
                       capacity_factor=8.0),
    "ssm": ModelConfig(name="t-ssm", family="ssm", num_layers=2, d_model=128,
                       num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=512,
                       ssm_state=16, ssm_head_dim=32, ssm_chunk=16),
    "hybrid": ModelConfig(name="t-hybrid", family="hybrid", num_layers=3,
                          d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                          vocab_size=512, head_dim=32, ssm_state=16,
                          ssm_head_dim=32, ssm_chunk=16, attn_every=2),
    "vlm": ModelConfig(name="t-vlm", family="vlm", num_layers=2, d_model=128,
                       num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
                       head_dim=32, num_patches=8, qkv_bias=True),
    "audio": ModelConfig(name="t-audio", family="audio", num_layers=2,
                         d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                         vocab_size=64, head_dim=32, num_codebooks=4,
                         cond_len=4),
}


# tier-1 family sweeps run "dense" only; the other five families ride
# the slow lane (-m slow).  Family coverage stays in tier-1 through the
# two TIER1_ARCHS end-to-end smokes (dense + ssm) — the per-family
# sweeps here cost 5-25 s of XLA compile each on this CPU container.
TIER1_FAMILIES = ("dense",)


def family_params():
    return [f if f in TIER1_FAMILIES else
            pytest.param(f, marks=pytest.mark.slow)
            for f in sorted(FAMILY_CONFIGS)]


def make_batch(cfg, key, batch=2, seq=32):
    kt, kp, kc = jax.random.split(key, 3)
    if cfg.family == "audio":
        toks = jax.random.randint(kt, (batch, cfg.num_codebooks, seq), 0,
                                  cfg.vocab_size)
        return {"tokens": toks, "labels": toks,
                "cond": jax.random.normal(kc, (batch, cfg.cond_len, cfg.d_model))}
    toks = jax.random.randint(kt, (batch, seq), 0, cfg.vocab_size)
    b = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        b["patch_embeds"] = jax.random.normal(
            kp, (batch, cfg.num_patches, cfg.d_model))
    return b
