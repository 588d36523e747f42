"""The port's Mamba2 (ssm) family against the JAX reference on the same
numpy inputs: forward logits with and without the SSD-scan kernel path
(``use_kernel``; the plain version of K9 on the CPU, the Pallas kernel in
interpret mode on the reference's side), loss and grads, prefill
(unpadded and bucket-padded) + decode caches, the paged entry points,
the engine's tokens (dense and paged) against the reference engine's,
two Parle smoke rounds of ``--arch mamba2-1.3b --smoke`` against the
reference's per-step losses, checkpoints that cross-load both ways, and
the train / serve CLIs.  f32 throughout, atol = rtol = 1e-4 (XLA and
PyTorch sum in different orders)."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FAMILY_CONFIGS
from repro.checkpoint import checkpoint as ref_ckpt
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.configs.base import ParleConfig as RefParleConfig
from repro.core import parle as ref_parle
from repro.core import registry as ref_registry
from repro.data.synthetic import TokenStream as RefTokenStream
from repro.data.synthetic import make_round_batch_fn as ref_round_batches
from repro.models import mamba2 as ref_mamba2
from repro.models.model import build_model as ref_build_model
from repro.serving import Engine as RefEngine
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCHS, ParleConfig, smoke_variant
from repro_torch.configs.base import ModelConfig
from repro_torch.core import registry
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import serve, train
from repro_torch.models import mamba2
from repro_torch.models.convert import (params_from_numpy, state_from_numpy,
                                        state_to_numpy)
from repro_torch.models.model import (build_model, cache_positions,
                                      with_cache_positions)
from repro_torch.serving import Engine
from torch_parity import (MODEL_TOL, assert_close, both_params, leaf_pairs,
                          numpy_params, port_rounds, ref_rounds)

REF_CFG = FAMILY_CONFIGS["ssm"]
CFG = ModelConfig(**dataclasses.asdict(REF_CFG))
RSMOKE = ref_smoke_variant(REF_ARCHS["mamba2-1.3b"])
SMOKE = smoke_variant(ARCHS["mamba2-1.3b"])
B, T = 2, 32


@pytest.fixture(scope="module")
def params():
    return both_params(REF_CFG, seed=0)


def _tokens(b=B, t=T, seed=1):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, size=(b, t)).astype(np.int32)


def _cache_close(port, ref, what):
    assert_close(port.conv, ref.conv, MODEL_TOL, f"{what} conv")
    assert_close(port.state, ref.state, MODEL_TOL, f"{what} state")
    np.testing.assert_array_equal(port.pos.numpy(), np.asarray(ref.pos))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_forward_logits_match_reference(params, use_kernel):
    rp, pp = params
    toks = _tokens()
    want, _ = ref_mamba2.forward(rp, REF_CFG, jnp.asarray(toks),
                                 use_kernel=use_kernel)
    before = ssd.launches
    got, aux = mamba2.forward(pp, CFG, torch.from_numpy(toks),
                              use_kernel=use_kernel)
    assert ssd.launches == before           # the CPU takes the plain K9
    assert_close(got, want, MODEL_TOL, f"logits use_kernel={use_kernel}")
    assert float(aux) == 0.0
    assert_close(build_model(CFG).apply(pp, {"tokens": torch.from_numpy(
        toks)})[0], want, MODEL_TOL, "Model.apply")


def test_loss_and_grads_match_reference(params):
    rp, _ = params
    np_p = numpy_params(REF_CFG, seed=0)
    toks = _tokens(t=T + 1, seed=2)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (r_loss, _), r_grads = jax.value_and_grad(
        ref_build_model(REF_CFG).loss, has_aux=True)(
        rp, jax.tree.map(jnp.asarray, batch))
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(
        True), np_p)
    loss, _ = build_model(CFG).loss(
        pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert_close(loss, r_loss, MODEL_TOL, "loss")
    for path, r in jax.tree_util.tree_leaves_with_path(r_grads):
        p = pp
        for k in path:
            p = p[k.key]
        assert_close(p.grad, r, MODEL_TOL, f"grad{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("valid", [None, 20])
def test_prefill_and_decode_match_reference(params, valid):
    """Prefill (unpadded, or bucket-padded with ``valid`` live tokens),
    then three greedy decodes: logits and the conv / state cache."""
    rp, pp = params
    toks = _tokens()
    rm, pm = ref_build_model(REF_CFG), build_model(CFG)
    r_cache = rm.init_cache(rp, B, 64)
    p_cache = pm.init_cache(pp, B, 64)
    kw = {} if valid is None else {"valid": valid}
    r_logits, r_cache = rm.prefill(rp, {"tokens": jnp.asarray(toks)}, r_cache,
                                   **({} if valid is None
                                      else {"valid": jnp.int32(valid)}))
    p_logits, p_cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                                   p_cache, **kw)
    assert_close(p_logits, r_logits, MODEL_TOL, "prefill logits")
    _cache_close(p_cache, r_cache, "prefill")
    last = T - 1 if valid is None else valid - 1
    tok = np.asarray(jnp.argmax(r_logits[:, last], -1))[:, None].astype(
        np.int32)
    for i in range(3):
        r_logits, r_cache = rm.decode(rp, {"tokens": jnp.asarray(tok)},
                                      r_cache)
        p_logits, p_cache = pm.decode(pp, {"tokens": torch.from_numpy(tok)},
                                      p_cache)
        assert_close(p_logits, r_logits, MODEL_TOL, f"decode {i} logits")
        _cache_close(p_cache, r_cache, f"decode {i}")
        tok = np.asarray(jnp.argmax(r_logits[:, -1], -1))[:, None].astype(
            np.int32)


def test_cache_positions_take_ssm_caches(params):
    _, pp = params
    cache = build_model(CFG).init_cache(pp, 3, 16)
    assert int(cache_positions(cache)) == 0
    moved = with_cache_positions(cache, torch.tensor([1, 2, 3]))
    assert cache_positions(moved).tolist() == [1, 2, 3]
    assert moved.state.data_ptr() == cache.state.data_ptr()


def test_paged_entry_points_match_reference(params):
    """Chunked prefill of one slot (two chunks of 16, the second padded),
    then a masked decode over the slot batch, the paged-to-dense view and
    its restore."""
    rp, pp = params
    toks = _tokens(b=1, t=24, seed=3)
    rm, pm = ref_build_model(REF_CFG), build_model(CFG)
    r_cache = rm.init_paged_cache(rp, 3, 1, 16, 4)
    p_cache = pm.init_paged_cache(pp, 3, 1, 16, 4)
    slot = 1
    for f in (0, 16):
        chunk = np.zeros((1, 16), np.int32)
        valid = min(16, 24 - f)
        chunk[:, :valid] = toks[:, f:f + valid]
        r_logits, r_cache = rm.prefill_chunk(
            rp, {"tokens": jnp.asarray(chunk)}, r_cache, jnp.int32(slot),
            jnp.int32(f), jnp.int32(valid), jnp.int32(24))
        p_logits, p_cache = pm.prefill_chunk(
            pp, {"tokens": torch.from_numpy(chunk)}, p_cache, slot, f, valid,
            24)
        assert_close(p_logits[:, :valid], r_logits[:, :valid], MODEL_TOL,
                     f"prefill_chunk {f}")
        _cache_close(p_cache, r_cache, f"prefill_chunk {f}")
    active = np.array([False, True, False])
    tok = np.array([[3], [7], [5]], np.int32)
    r_logits, r_cache = rm.decode_paged(rp, {"tokens": jnp.asarray(tok)},
                                        r_cache, jnp.asarray(active))
    p_logits, p_cache = pm.decode_paged(pp, {"tokens": torch.from_numpy(tok)},
                                        p_cache, torch.from_numpy(active))
    assert_close(p_logits[1], r_logits[1], MODEL_TOL, "decode_paged")
    _cache_close(p_cache, r_cache, "decode_paged")
    # a decode chunk of 2 through the dense view, inactive rows frozen
    dense = pm.paged_to_dense(p_cache)
    r_dense = rm.paged_to_dense(r_cache)
    for _ in range(2):
        _, dense = pm.decode(pp, {"tokens": torch.from_numpy(tok)}, dense)
        _, r_dense = rm.decode(rp, {"tokens": jnp.asarray(tok)}, r_dense)
    p_cache = pm.paged_restore(p_cache, dense, torch.from_numpy(active), 2)
    r_cache = rm.paged_restore(r_cache, r_dense, jnp.asarray(active), 2)
    _cache_close(p_cache, r_cache, "paged_restore")


@pytest.mark.parametrize("paged", [False, True])
def test_engine_tokens_match_reference_engine(params, paged):
    rp, pp = params
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
               for n in (5, 19, 12, 7)]
    kw = dict(num_slots=2, max_len=48, decode_chunk=3, paged=paged,
              page_size=16, prefill_chunk=8)
    out = []
    for cls, p, extra in ((RefEngine, rp, {}), (Engine, pp,
                                                {"device": "cpu"})):
        eng = cls(REF_CFG if cls is RefEngine else CFG, p, **kw, **extra)
        for r in prompts:
            eng.submit(r, max_new_tokens=6)
        out.append(eng.run())
        if paged:   # no pages for the ssm family; chunk rounded to Q
            assert not eng.uses_pages and eng.prefill_chunk_len == 16
    want, got = out
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid],
                                      err_msg=f"req {uid}")


@pytest.fixture(scope="module")
def smoke_params():
    """numpy_params with A_log and dt_bias from the Mamba2 init's own
    distribution (A = -[1 .. 16], dt around 1e-3 .. 1e-1).  With the
    generic draws (dt near 0.7) the masked decays of a 32-token chunk
    overflow and the reference's backward turns NaN from the second
    step on — the reference fault of ROADMAP.md §3, pinned by
    test_torch_ssd_scan.py; the port's trajectory stays finite there."""
    tree = numpy_params(RSMOKE, seed=0)
    rng = np.random.default_rng(1)
    lay = tree["layers"]
    L, nh = lay["A_log"].shape
    lay["A_log"] = np.broadcast_to(np.log(np.linspace(
        1.0, 16.0, nh, dtype=np.float32)), (L, nh)).copy()
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (L, nh)))
    lay["dt_bias"] = np.log(np.expm1(dt0)).astype(np.float32)
    return tree


def _ref_batches(n=2, L=2, b=2, t=32):
    stage = ref_round_batches(RefTokenStream(RSMOKE.vocab_size, t, b, seed=0),
                              L, b, n)
    return [jax.tree.map(np.asarray, stage(r * L)) for r in range(2)]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_two_parle_rounds_match_reference(smoke_params, use_kernel):
    kw = dict(n_replicas=2, L=2, batches_per_epoch=1)
    batches = _ref_batches()
    ref_state, ref_losses = ref_rounds(RSMOKE, smoke_params, batches,
                                       use_kernel, **kw)
    st, losses = port_rounds(SMOKE, smoke_params, batches, use_kernel, **kw)
    assert_close(losses, ref_losses, dict(rtol=1e-4, atol=1e-4),
                 f"per-step losses use_kernel={use_kernel}")
    for path, p, r in leaf_pairs(state_to_numpy(st)["x"], ref_state.x):
        assert_close(p, r, dict(rtol=1e-4, atol=1e-4), f"final x{path}")


def test_checkpoints_cross_load_both_ways(smoke_params, tmp_path):
    kw = dict(n_replicas=2, L=2)
    rng = np.random.default_rng(5)
    ref = ref_registry.get("parle").init(
        jax.tree.map(jnp.asarray, smoke_params), RefParleConfig(**kw))
    ref = ref._replace(y=jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), ref.y),
        step=jnp.asarray(4, jnp.int32))
    ref_path = str(tmp_path / "ref" / "step000004.npz")
    ref_ckpt.save(ref_path, ref, step=4, algo="parle")
    algo = registry.get("parle")
    port = ckpt.restore(ref_path, algo.init(
        params_from_numpy(smoke_params, "cpu"), ParleConfig(**kw)),
        algo="parle")
    want = state_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    for f in ("x", "y", "z", "v_y", "v_x"):
        assert torch.equal(getattr(port, f), getattr(want, f)), f
    assert ("layers", "A_log") in port.layout.paths

    port_path = str(tmp_path / "port" / "step000004.npz")
    ckpt.save(port_path, port, step=4, algo="parle")
    assert sorted(np.load(port_path).files) == sorted(np.load(ref_path).files)
    like = ref_parle.dealias_state(ref_registry.get("parle").init(
        jax.tree.map(jnp.asarray, smoke_params), RefParleConfig(**kw)))
    back = ref_ckpt.restore(port_path, like, algo="parle")
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_and_serve_clis_run_mamba2(capsys, tmp_path):
    ck = tmp_path / "ck"
    train.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                "--replicas", "2", "--L", "2", "--steps", "4", "--batch",
                "2", "--seq", "32", "--use-kernel", "--round-fused",
                "--log-every", "2", "--checkpoint-dir", str(ck),
                "--checkpoint-every", "4"])
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]
    final = [r for r in recs if r["kind"] == "train_final"]
    assert [r["step"] for r in recs if r["kind"] == "train_progress"] == [2, 4]
    assert final[0]["arch"] == "mamba2-1.3b-smoke"
    assert np.isfinite(final[0]["final_eval_loss"])
    for extra in ([], ["--paged"]):
        serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                    "--replicas", "2", "--resume", str(ck), "--requests",
                    "3", "--slots", "2", "--prompt-len", "12",
                    "--mixed-lens", "--gen", "4"] + extra)
        recs = [json.loads(l) for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")]
        summary = [r for r in recs if r.get("kind") == "serve_summary"][0]
        assert summary["new_tokens"] == 12
        assert recs[0]["restored"] is True
