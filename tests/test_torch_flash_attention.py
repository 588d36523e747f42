"""The port's flash attention (K3) against the JAX reference on the same
numpy inputs: its plain version against the reference oracle
(``repro.kernels.ref.flash_attention``) and the Pallas kernel in
interpret mode at the reference kernel test's cases (causal hd 32 / 64,
window 32, bf16) with its tolerances (2e-5 f32, 5e-2 bf16) and at a
ragged T; ``attention_core(use_flash=True)``; the dense model's
``apply`` and ``launch/steps.py::make_prefill_step(use_flash=True)``
logits and KV caches (1e-4); the forward-only contract (the reference's
K3 has no VJP, so training with it fails on both sides); a torch model of
the kernel's float32 arithmetic on TF32 tensor cores (the 3xTF32 split,
TF32 rounding by bit masking) against the plain version and the oracle;
and the kernel against its plain version on a card (``gpu``, skipped
without one)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import registry as ref_registry
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.launch import steps as ref_steps
from repro.models import attention as ref_attn
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import ParleConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.core import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import attention as attn
from repro_torch.models.model import build_model
from torch_parity import (MODEL_TOL, KERNEL_TOL, _product_1xtf32,
                          _product_3xtf32, _split, _tf32, assert_close,
                          both_params)

BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# name: (B, T, H, hd, window, dtype, Pallas block_q, block_k) — the
# reference kernel test's tier-1 cases
CASES = {
    "causal_hd32": (2, 128, 3, 32, 0, np.float32, 128, 64),
    "causal_hd64": (2, 128, 3, 64, 0, np.float32, 128, 64),
    "window32": (1, 128, 2, 32, 32, np.float32, 64, 64),
    "bf16": (1, 128, 2, 64, 0, "bfloat16", 64, 64),
}
REF_CFG = FAMILY_CONFIGS["dense"]
CFG = ModelConfig(**dataclasses.asdict(REF_CFG))


def _qkv(B, T, H, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, hd)).astype(np.float32)
            for _ in range(3)]


def _torch(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_oracle_and_pallas(case):
    B, T, H, hd, window, dtype, bq, bk = CASES[case]
    arrays = _qkv(B, T, H, hd, seed=len(case))
    bf16 = dtype == "bfloat16"
    tol = BF16_TOL if bf16 else KERNEL_TOL
    got = fa.flash_attention_plain(
        *_torch(arrays, torch.bfloat16 if bf16 else torch.float32),
        window=window).float()
    qkv = _jax(arrays, jnp.bfloat16 if bf16 else jnp.float32)
    oracle = ref_kernels.flash_attention(*qkv, window=window)
    pallas = ref_ops.flash_attention(*qkv, window=window, block_q=bq,
                                     block_k=bk)
    assert_close(got, np.asarray(oracle, np.float32), tol, f"{case} oracle")
    assert_close(got, np.asarray(pallas, np.float32), tol, f"{case} pallas")


@pytest.mark.parametrize("window", [0, 32])
def test_plain_at_a_ragged_length_matches_oracle(window):
    """Prompts of any length reach the prefill step; the Pallas kernel
    asserts T % block == 0, its oracle does not."""
    arrays = _qkv(1, 200, 2, 32, seed=5)
    assert_close(fa.flash_attention_plain(*_torch(arrays), window=window),
                 ref_kernels.flash_attention(*_jax(arrays), window=window),
                 KERNEL_TOL, f"T=200 window={window}")


def test_ops_cpu_takes_the_plain_version_and_launches_nothing():
    q, k, v = _torch(_qkv(1, 64, 2, 32, seed=3))
    before = fa.launches
    out = ops.flash_attention(q, k, v, window=16)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, window=16))
    assert fa.launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    before = fa.launches
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_cuda(*_torch(_qkv(1, 64, 2, 32)))
    assert fa.launches == before


def test_ops_is_forward_only():
    q, k, v = _torch(_qkv(1, 64, 2, 32))
    with pytest.raises(RuntimeError, match="no VJP"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():                 # the same call under no_grad runs
        ops.flash_attention(q, k, v)


def test_attention_core_flash_branch_matches_reference():
    B, T, H, hd = 1, 64, 2, 32
    arrays = _qkv(B, T, H, hd, seed=11)
    mask = np.tril(np.ones((T, T), bool))[None, None]
    for window in (0, 16):
        got = attn.attention_core(*_torch(arrays), torch.from_numpy(mask),
                                  use_flash=True, window=window)
        want = ref_attn.attention_core(*_jax(arrays), jnp.asarray(mask),
                                       use_flash=True, window=window)
        assert_close(got, want, KERNEL_TOL, f"attention_core window={window}")
    # Tq != Tk (a chunk-resumed prefill) takes the plain path, as in the
    # reference
    q = torch.from_numpy(arrays[0][:, :16])
    k, v = _torch(arrays[1:])
    m = torch.ones((1, 1, 16, T), dtype=torch.bool)
    before = fa.launches
    assert torch.equal(attn.attention_core(q, k, v, m, use_flash=True),
                       attn.attention_core(q, k, v, m))
    assert fa.launches == before


def _attention_model(q, k, v, window, product):
    """K3's float32 forward with both products through ``product``:
    scores in log2 units, exp2, the output over max(l, 1e-30)."""
    T, hd = q.shape[1], q.shape[-1]
    s = product("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5 * np.log2(np.e))
    pos = torch.arange(T)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = product("bhqk,bkhd->bqhd", p, v)
    return out / p.sum(-1).clamp_min(1e-30).transpose(1, 2)[..., None]


def test_tf32_split_parts():
    """big keeps 10 mantissa bits (rounded to nearest, ties away), and
    big + small is x to within 2^-21 of x."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        4096).astype(np.float32) * 100)
    big, small = _split(x)
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    assert (x - big).abs().le(big.abs() * 2.0 ** -11).all()
    assert ((big + small) - x).abs().le(x.abs() * 2.0 ** -21).all()
    # 1 + 2^-11 lies halfway between two TF32 values: ties go away
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("case", ["causal_hd32", "causal_hd64", "window32",
                                  "ragged_hd128"])
def test_3xtf32_model_matches_plain_and_oracle(case):
    """The split keeps float32 accuracy: within 2e-5 of the plain
    version and of the JAX oracle, where one TF32 product per float32
    product (TF32 alone) is two orders of magnitude further off."""
    B, T, H, hd, window, _, _, _ = CASES.get(
        case, (1, 129, 2, 128, 0, np.float32, 0, 0))
    arrays = _qkv(B, T, H, hd, seed=21)
    q, k, v = _torch(arrays)
    got = _attention_model(q, k, v, window, _product_3xtf32)
    plain = fa.flash_attention_plain(q, k, v, window=window)
    oracle = ref_kernels.flash_attention(*_jax(arrays), window=window)
    assert_close(got, plain.numpy(), KERNEL_TOL, f"{case} vs plain")
    assert_close(got, oracle, KERNEL_TOL, f"{case} vs oracle")
    tf32_only = _attention_model(q, k, v, window, _product_1xtf32)
    err_3x = (got - plain).abs().max().item()
    err_1x = (tf32_only - plain).abs().max().item()
    assert err_1x > 100 * err_3x, (err_1x, err_3x)


@pytest.fixture(scope="module")
def dense_params():
    return both_params(REF_CFG, seed=0)


def _tokens(B=2, T=32, seed=4):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(B, T)).astype(np.int32)


def test_apply_and_prefill_step_with_flash_match_reference(dense_params):
    rp, pp = dense_params
    toks = _tokens()
    B, T = toks.shape
    r_logits, _ = ref_build_model(REF_CFG, use_flash=True).apply(
        rp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        p_logits, _ = build_model(CFG, use_flash=True).apply(
            pp, {"tokens": torch.from_numpy(toks)})
        p_plain, _ = build_model(CFG).apply(
            pp, {"tokens": torch.from_numpy(toks)})
    assert_close(p_logits, r_logits, MODEL_TOL, "apply(use_flash=True)")
    assert_close(p_logits, p_plain.numpy(), MODEL_TOL, "flash vs plain")

    r_cache = ref_build_model(REF_CFG).init_cache(rp, B, 48)
    r_out, r_cache = ref_steps.make_prefill_step(REF_CFG, use_flash=True)(
        rp, {"tokens": jnp.asarray(toks)}, r_cache)
    p_cache = build_model(CFG).init_cache(pp, B, 48)
    p_out, p_cache = steps.make_prefill_step(CFG, use_flash=True)(
        pp, {"tokens": torch.from_numpy(toks)}, p_cache)
    assert_close(p_out, r_out, MODEL_TOL, "prefill step logits")
    assert_close(p_cache.k, r_cache.k, MODEL_TOL, "prefill step k cache")
    assert_close(p_cache.v, r_cache.v, MODEL_TOL, "prefill step v cache")
    assert int(p_cache.pos) == int(r_cache.pos) == T


def test_training_step_with_flash_fails_as_the_reference_does(dense_params):
    rp, pp = dense_params
    toks = _tokens(B=2, T=32)[None].repeat(2, axis=0)   # (n, B, T)
    batch = {"tokens": toks, "labels": toks}
    pcfg_kw = dict(n_replicas=2, L=2)
    ref_state = ref_registry.get("parle").init(rp, RefParleConfig(
        **pcfg_kw))
    ref_step = ref_steps.make_algorithm_step(
        "parle", REF_CFG, RefParleConfig(**pcfg_kw), use_flash=True)
    with pytest.raises(AssertionError):
        ref_step(ref_state, jax.tree.map(jnp.asarray, batch))
    pc = ParleConfig(**pcfg_kw)
    step = steps.make_algorithm_step("parle", CFG, pc, use_flash=True)
    state = registry.get("parle").init(pp, pc)
    with pytest.raises(RuntimeError, match="forward only"):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()})


def test_mesh_factories_name_their_roadmap_item():
    """The sharded factories take a ReplicaGroup (the replica axis across
    processes is ported) and a MeshGroups; a mesh with an axis inside a
    replica asks for a world of its ranks."""
    from repro_torch.launch.mesh import groups_from_spec
    from repro_torch.sharding.partition import ReplicaGroup
    pc = ParleConfig(n_replicas=2)
    assert callable(steps.make_algorithm_sharded_step("parle", CFG, pc,
                                                      ReplicaGroup(2)))
    assert callable(steps.make_algorithm_round("parle", CFG, pc,
                                               mesh=ReplicaGroup(2)))
    with pytest.raises(RuntimeError, match="spans 2 ranks"):
        groups_from_spec("pod:1,model:2")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


# cases of the card test beyond the reference's: ragged T around the
# kernel's 64-row tiles at hd 128, and bf16 at hd 128
CARD_CASES = {
    "ragged_hd128": (2, 200, 4, 128, 0, np.float32, 0, 0),
    "ragged_T65_hd128": (1, 65, 2, 128, 0, np.float32, 0, 0),
    "ragged_T127_hd128": (2, 127, 2, 128, 0, np.float32, 0, 0),
    "ragged_T129_hd128": (1, 129, 3, 128, 0, np.float32, 0, 0),
    "bf16_hd128": (2, 192, 2, 128, 0, "bfloat16", 0, 0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["causal_hd32", "causal_hd64", "window32",
                                  "bf16", *CARD_CASES])
def test_kernel_matches_plain_on_card(case, cuda_device):
    B, T, H, hd, window, dtype, _, _ = {**CASES, **CARD_CASES}[case]
    bf16 = dtype == "bfloat16"
    q, k, v = [t.to(cuda_device) for t in _torch(
        _qkv(B, T, H, hd, seed=7), torch.bfloat16 if bf16 else torch.float32)]
    before = fa.launches
    got = fa.flash_attention_cuda(q, k, v, window=window)
    torch.cuda.synchronize(cuda_device)
    assert fa.launches == before + 1
    assert_close(got.float().cpu(),
                 fa.flash_attention_plain(q, k, v, window).float().cpu()
                 .numpy(), BF16_TOL if bf16 else KERNEL_TOL, case)
