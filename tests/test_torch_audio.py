"""The port's audio family (``models/audio.py``: K codebook streams,
(K, V, d) embeddings summed, a (d, K·V) head, prepended conditioning
frames) against the JAX reference on the same numpy inputs: forward
logits (also through ``use_flash``: K3's plain version on the CPU), the
multi-stream chunked cross-entropy, loss and grads, SGD lowering the
loss, prefill + decode, the paged entry points in merged (cond + token)
positions with and without the paged-attention kernel flag, the token
stream's (B, K, T) batches, the engine's (K,)-token steps (dense, paged,
paged through K8) against the reference engine's and the port's naive
loop; the MusicGen-large smoke variant's forward, decode and Parle
step are in test_torch_arch_smoke.py.

Tolerance: f32 logits, loss and grads within
rtol = atol = 1e-5 (``TOL``); the largest error measured is printed
(``pytest -s``).  Tokens are compared exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.models import audio as ref_audio
from repro.models import layers as ref_layers
from repro.serving import Engine as RefEngine
from repro_torch.data.synthetic import TokenStream, replica_batches
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import audio, layers
from repro_torch.models.model import build_model, cache_positions
from repro_torch.serving import Engine, make_naive_fns, naive_generate
from torch_parity import (assert_close, assert_same_tokens, both_params,
                          check_forward, check_loss_and_grads,
                          check_loss_decreases, check_paged_entry_points,
                          check_prefill_decode,
                          family_batch, family_requests, numpy_params,
                          port_config, run_engine, to_torch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
REF_CFG = FAMILY_CONFIGS["audio"]
CFG = port_config(REF_CFG)
LENS = (5, 9, 12, 7)


@pytest.fixture(scope="module")
def params():
    return both_params(REF_CFG, seed=0)


def test_forward_matches_reference(params):
    check_forward(REF_CFG, params, TOL, family_batch(REF_CFG))


def test_flash_path_matches_reference(params):
    rp, pp = params
    b = family_batch(REF_CFG)
    want, _ = ref_audio.forward(rp, REF_CFG, jnp.asarray(b["tokens"]),
                                jnp.asarray(b["cond"]), use_flash=True)
    before = fa.launches
    got, _ = audio.forward(pp, CFG, torch.from_numpy(b["tokens"]),
                           torch.from_numpy(b["cond"]), use_flash=True)
    assert fa.launches == before            # the CPU takes the plain K3
    assert_close(got, want, TOL, "audio use_flash logits")


@pytest.mark.parametrize("T", [1024, 48], ids=["two_chunks", "one_chunk"])
def test_multi_stream_cross_entropy_matches_reference(T):
    rng = np.random.default_rng(3)
    K, V, d = 4, 64, 16
    h = rng.standard_normal((2, T, d)).astype(np.float32)
    head = (rng.standard_normal((d, K * V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, size=(2, T, K)).astype(np.int32)
    want = ref_layers.chunked_cross_entropy(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(labels),
        num_streams=K)
    got = layers.chunked_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(head),
        torch.from_numpy(labels), num_streams=K)
    assert_close(got, want, TOL, f"chunked CE, {K} streams, T {T}")


def test_token_stream_emits_codebook_batches():
    """(B, K, T) tokens and labels, labels the next tokens, every id in
    the vocabulary; K = 0 keeps the text stream's draws unchanged."""
    s = TokenStream(vocab_size=64, seq_len=16, batch_size=2, seed=3,
                    num_codebooks=4)
    b = s.batch(5)
    assert b["tokens"].shape == b["labels"].shape == (2, 4, 16)
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 64
    assert replica_batches(s, 0, 2, 3)["tokens"].shape == (3, 2, 4, 16)
    text = TokenStream(vocab_size=64, seq_len=16, batch_size=2, seed=3)
    assert text.batch(5)["tokens"].shape == (2, 16)


def test_loss_and_grads_match_reference():
    check_loss_and_grads(REF_CFG, numpy_params(REF_CFG, seed=0), TOL,
                         family_batch(REF_CFG, seed=2))


def test_loss_decreases_under_sgd():
    check_loss_decreases(REF_CFG, numpy_params(REF_CFG, seed=0),
                         family_batch(REF_CFG, seed=2))


def test_prefill_then_decode_match_reference(params):
    """The cache positions (the reference's: cond_len + T + 3) too."""
    check_prefill_decode(REF_CFG, params, TOL, family_batch(REF_CFG, T=12))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_paged_entry_points_match_reference(params, use_kernel):
    """Chunks of 8 over 4 cond frames and 27 tokens: the first chunk
    straddles the cond region."""
    req = family_requests(REF_CFG, (27,), seed=5)[0]
    check_paged_entry_points(REF_CFG, params, TOL, req, use_kernel, chunk=8)


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
    """(K, G) tokens a request, the reference's engine == naive and paged
    == dense contracts held across packages; throughput counts token
    positions (the K codebooks of a step collapse into one)."""
    _, pp = params
    got, eng = run_engine(Engine, CFG, pp, family_requests(REF_CFG, LENS),
                          device="cpu", **mode)
    assert_same_tokens(got, ref_tokens)
    assert got[0].shape == (CFG.num_codebooks, 8)
    assert tuple(eng.cur_tok.shape) == (2, CFG.num_codebooks, 1)
    assert 0.0 < eng.throughput()["slot_utilization"] <= 1.0


def test_engine_matches_naive_exactly(params, ref_tokens):
    _, pp = params
    fns = make_naive_fns(CFG)
    model = build_model(CFG)
    for i, r in enumerate(family_requests(REF_CFG, LENS)):
        batch = to_torch({k: v[None] for k, v in r.items()})
        toks, cache = naive_generate(fns, pp, batch,
                                     model.init_cache(pp, 1, 32), 8)
        np.testing.assert_array_equal(toks[0].numpy(), ref_tokens[i])
        assert int(cache_positions(cache)) == (CFG.cond_len + LENS[i] + 7)



def test_serve_cli_sizes_the_cache_with_the_cond_frames():
    """The serve CLI's requests carry (K, T) prompts and cond frames from
    their own generator, and its engine's ``max_len`` counts the cond
    frames (the reference's CLI leaves them out: ROADMAP.md, reference
    behaviour): every request then gets its (K, gen) tokens."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import serve
    args = serve.parse_args(["--arch", "musicgen-large", "--smoke",
                             "--device", "cpu", "--requests", "2",
                             "--slots", "2", "--prompt-len", "12",
                             "--gen", "4", "--paged", "--paged-kernel"])
    cfg = smoke_variant(get_config("musicgen-large"))
    reqs = serve.make_requests(cfg, args)
    assert reqs[0]["tokens"].shape == (cfg.num_codebooks, 12)
    assert reqs[0]["cond"].shape == (cfg.cond_len, cfg.d_model)
    assert not np.array_equal(reqs[0]["cond"], reqs[1]["cond"])
    assert serve._max_len(reqs, args) == cfg.cond_len + 12 + 4
    params = serve.init_params(cfg, args, torch.device("cpu"))
    res, eng, _ = serve.engine_serve(cfg, params, reqs, args,
                                     serve.Obs(), torch.device("cpu"))
    assert [res[u].shape for u in sorted(res)] == [
        (cfg.num_codebooks, 4)] * 2
    assert eng.max_len == cfg.cond_len + 12 + 4
