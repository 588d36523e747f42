"""The port's vlm family (``models/vlm.py``: normed patch embeddings
merged over the first ``num_patches`` positions of the dense decoder)
against the JAX reference on the same numpy inputs: forward logits
(also with a prompt shorter than the image region, and through
``use_flash``: K3's plain version on the CPU), loss and grads, SGD
lowering the loss, prefill + decode, the paged entry points (the chunked
merge with ``total``) with and without the paged-attention kernel flag,
the engine's tokens (dense, paged, paged through K8) against the
reference engine's and the port's naive loop, the engine's refusal of a
request without patch embeddings; the InternVL2-1B smoke variant's
forward, decode and Parle step are in test_torch_arch_smoke.py.

Tolerance: f32 logits, loss and grads within
rtol = atol = 1e-5 (``TOL``); the largest error measured is printed
(``pytest -s``).  Tokens are compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.models import vlm as ref_vlm
from repro.serving import Engine as RefEngine
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import vlm
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
REF_CFG = FAMILY_CONFIGS["vlm"]
CFG = port_config(REF_CFG)
LENS = (5, 9, 12, 7)          # 5 and 7 are shorter than the 8 patches


@pytest.fixture(scope="module")
def params():
    return both_params(REF_CFG, seed=0)


@pytest.mark.parametrize("T", [32, 5], ids=["long", "shorter_than_image"])
def test_forward_matches_reference(params, T):
    check_forward(REF_CFG, params, TOL, family_batch(REF_CFG, T=T))


def test_flash_path_matches_reference(params):
    rp, pp = params
    b = family_batch(REF_CFG)
    want, _ = ref_vlm.forward(rp, REF_CFG, jnp.asarray(b["tokens"]),
                              jnp.asarray(b["patch_embeds"]), use_flash=True)
    before = fa.launches
    got, _ = vlm.forward(pp, CFG, torch.from_numpy(b["tokens"]),
                         torch.from_numpy(b["patch_embeds"]), use_flash=True)
    assert fa.launches == before            # the CPU takes the plain K3
    assert_close(got, want, TOL, "vlm use_flash logits")


def test_loss_and_grads_match_reference():
    check_loss_and_grads(REF_CFG, numpy_params(REF_CFG, seed=0), TOL,
                         family_batch(REF_CFG, seed=2))


def test_loss_decreases_under_sgd():
    check_loss_decreases(REF_CFG, numpy_params(REF_CFG, seed=0),
                         family_batch(REF_CFG, seed=2))


@pytest.mark.parametrize("T", [12, 6], ids=["long", "shorter_than_image"])
def test_prefill_then_decode_match_reference(params, T):
    check_prefill_decode(REF_CFG, params, TOL, family_batch(REF_CFG, T=T))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_entry_points_match_reference(params, use_kernel):
    req = family_requests(REF_CFG, (27,), seed=5)[0]
    check_paged_entry_points(REF_CFG, params, TOL, req, use_kernel, chunk=4)


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
    held across packages (the patches of a prompt shorter than the
    image region are cut, in the bucketed and in the chunked prefill)."""
    _, pp = params
    got, _ = run_engine(Engine, CFG, pp, family_requests(REF_CFG, LENS),
                        device="cpu", **mode)
    assert_same_tokens(got, ref_tokens)


def test_engine_matches_naive_exactly(params, ref_tokens):
    _, pp = params
    fns = make_naive_fns(CFG)
    model = build_model(CFG)
    for i, r in enumerate(family_requests(REF_CFG, LENS)):
        batch = to_torch({k: v[None] for k, v in r.items()})
        toks, _ = naive_generate(fns, pp, batch, model.init_cache(pp, 1, 32),
                                 8)
        np.testing.assert_array_equal(toks[0].numpy(), ref_tokens[i])


def test_submit_refuses_a_request_without_patches(params):
    _, pp = params
    eng = Engine(CFG, pp, num_slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="patch_embeds"):
        eng.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)



def test_serve_cli_requests_carry_patch_embeddings():
    """The serve CLI's vlm requests carry (num_patches, d) embeddings
    from their own generator; the engine serves every request."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", "internvl2-1b", "--smoke", "--device",
                             "cpu", "--requests", "2", "--slots", "2",
                             "--prompt-len", "12", "--gen", "4"])
    cfg = smoke_variant(get_config("internvl2-1b"))
    reqs = serve.make_requests(cfg, args)
    assert reqs[0]["patch_embeds"].shape == (cfg.num_patches, cfg.d_model)
    assert not np.array_equal(reqs[0]["patch_embeds"],
                              reqs[1]["patch_embeds"])
    params = serve.init_params(cfg, args, torch.device("cpu"))
    res, _, _ = serve.engine_serve(cfg, params, reqs, args, serve.Obs(),
                                   torch.device("cpu"))
    assert [res[u].shape for u in sorted(res)] == [(4,)] * 2
