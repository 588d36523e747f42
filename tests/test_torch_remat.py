"""Recompute in the backward: the chunked cross-entropy's per-chunk
checkpoint, and ``remat=`` (True / "dots") through every family's
``build_model`` and the step factories.

* ``test_chunked_ce_saves_one_chunk`` counts the bytes autograd saves for
  the backward while the forward of ``chunked_cross_entropy`` runs
  (``saved_tensors_hooks``, each storage once): below two chunks' f32
  logits, where keeping every chunk's logits saves the whole (B, T, V);
  the loss and grads equal the keep-everything body's bit for bit.
* Each family's smoke variant, cut to 2 layers: the loss and every grad
  under ``remat=True`` and ``remat="dots"`` equal ``remat=False`` bit for
  bit (the recompute runs the same ops), and the reference's
  ``build_model(cfg, remat=...)`` on the same numpy params and batch
  within rtol = atol = 1e-5 (the families' parity tolerance).
* One Parle round of ``steps.make_algorithm_round(..., remat=True)``
  equals the ``remat=False`` round bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import ParleConfig
from repro_torch.core import registry
from repro_torch.launch import steps
from repro_torch.models import layers, transformer
from repro_torch.models.model import build_model
from torch_parity import (assert_close, family_batch, numpy_params,
                          params_from_numpy, port_config, ssm_init_draws,
                          to_jax, to_torch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)
FAMILY_ARCH = {"dense": "qwen2.5-3b", "moe": "qwen2-moe-a2.7b",
               "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b",
               "vlm": "internvl2-1b", "audio": "musicgen-large"}


# ------------------------------------------------------------------
# the chunked cross-entropy
# ------------------------------------------------------------------

def _ce_keeping_every_chunk(h, head_w, labels, chunk=512, num_streams=0):
    """The body before the per-chunk checkpoint: autograd keeps every
    chunk's logits for the backward."""
    B, T, d = h.shape
    if T % chunk:
        chunk = T
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, chunk):
        logits = (h[:, i:i + chunk] @ head_w).float()
        if num_streams:
            logits = logits.reshape(*logits.shape[:2], num_streams, -1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, i:i + chunk, ..., None].long())[
            ..., 0]
        total = total + (lse - gold).sum()
    return total / (B * T * (num_streams or 1))


def _saved_bytes(fn):
    """(fn's result, bytes autograd saved for its backward while it ran,
    each storage counted once)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


def test_chunked_ce_saves_one_chunk():
    B, T, d, chunk, V = 2, 2048, 64, 512, 4096
    rng = np.random.default_rng(0)
    h0 = torch.from_numpy(rng.standard_normal((B, T, d), np.float32))
    w0 = torch.from_numpy(rng.standard_normal((d, V), np.float32) * 0.1)
    labels = torch.from_numpy(rng.integers(0, V, (B, T)).astype(np.int32))
    outs = {}
    for name, fn in (("fixed", layers.chunked_cross_entropy),
                     ("oracle", _ce_keeping_every_chunk)):
        h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
        loss, saved = _saved_bytes(lambda: fn(h, w, labels, chunk=chunk))
        outs[name] = (loss, saved, *torch.autograd.grad(loss, (h, w)))
    one_chunk = B * chunk * V * 4
    print(f"[remat] CE saved bytes: fixed {outs['fixed'][1]}, keeping "
          f"every chunk {outs['oracle'][1]}, one chunk {one_chunk}")
    assert outs["fixed"][1] < 2 * one_chunk
    assert outs["oracle"][1] >= B * T * V * 4       # what it repairs
    for a, b in zip(outs["fixed"][2:] + outs["fixed"][:1],
                    outs["oracle"][2:] + outs["oracle"][:1]):
        assert torch.equal(a, b)


def test_chunked_ce_single_chunk_and_streams_unchanged():
    """T not a multiple of the chunk (one chunk, recomputed too) and a
    multi-codebook head: the same values and grads as the keep-everything
    body, bit for bit."""
    rng = np.random.default_rng(1)
    for T, K in ((100, 0), (64, 4)):
        h0 = torch.from_numpy(rng.standard_normal((2, T, 16), np.float32))
        w0 = torch.from_numpy(rng.standard_normal((16, 40 * (K or 1)),
                                                  np.float32))
        lab = torch.from_numpy(rng.integers(
            0, 40, (2, T) + ((K,) if K else ())).astype(np.int32))
        got = []
        for fn in (layers.chunked_cross_entropy, _ce_keeping_every_chunk):
            h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
            loss = fn(h, w, lab, chunk=32, num_streams=K)
            got.append((loss, *torch.autograd.grad(loss, (h, w))))
        for a, b in zip(*got):
            assert torch.equal(a, b)


# ------------------------------------------------------------------
# remat through every family
# ------------------------------------------------------------------

def _family_inputs(family):
    rcfg = dataclasses.replace(ref_smoke_variant(REF_ARCHS[FAMILY_ARCH[
        family]]), num_layers=2)
    tree = numpy_params(rcfg, seed=0)
    if family in ("ssm", "hybrid"):
        tree = ssm_init_draws(tree)
    return rcfg, tree, family_batch(rcfg, B=2, T=32)


def _port_loss_and_grads(rcfg, tree, batch, remat):
    """(loss, ce, {path: grad}) of the port's ``build_model(cfg,
    remat=remat).loss``."""
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), tree)
    leaves = jax.tree_util.tree_leaves_with_path(pp)
    loss, aux = build_model(port_config(rcfg), remat=remat).loss(
        pp, to_torch(batch))
    grads = torch.autograd.grad(loss, [t for _, t in leaves])
    return loss.detach(), aux["ce"].detach(), {
        jax.tree_util.keystr(p): g for (p, _), g in zip(leaves, grads)}


_PLAIN = {}


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_remat_equals_plain_and_reference(family, remat):
    rcfg, tree, batch = _family_inputs(family)
    if family not in _PLAIN:
        _PLAIN[family] = _port_loss_and_grads(rcfg, tree, batch, False)
    plain = _PLAIN[family]
    got = _port_loss_and_grads(rcfg, tree, batch, remat)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    assert got[2].keys() == plain[2].keys()
    for k, g in got[2].items():
        assert torch.equal(g, plain[2][k]), f"{family} grad{k}"
    (r_loss, r_aux), r_grads = jax.value_and_grad(
        ref_build_model(rcfg, remat=remat).loss, has_aux=True)(
        jax.tree.map(jnp.asarray, tree), to_jax(batch))
    assert_close(got[0], r_loss, TOL, f"{family} remat={remat} loss")
    assert_close(got[1], r_aux["ce"], TOL, f"{family} remat={remat} ce")
    for path, r in jax.tree_util.tree_leaves_with_path(r_grads):
        key = jax.tree_util.keystr(path)
        assert_close(got[2][key], r, TOL,
                     f"{family} remat={remat} grad{key}")


def test_remat_keeps_less_for_the_backward():
    """remat=True saves a fraction of what the plain forward saves for
    its backward (each block's activations are recomputed)."""
    rcfg, tree, batch = _family_inputs("dense")
    rcfg = dataclasses.replace(rcfg, num_layers=4)
    tree = numpy_params(rcfg, seed=0)
    saved = {}
    for remat in (False, True):
        pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                          .requires_grad_(True), tree)
        model = build_model(port_config(rcfg), remat=remat)
        _, saved[remat] = _saved_bytes(lambda: model.loss(
            pp, to_torch(batch)))
    print(f"[remat] dense forward saved bytes: plain {saved[False]}, "
          f"remat {saved[True]}")
    assert saved[True] < saved[False] / 2


def test_dots_policy_saves_unbatched_products_only():
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    from torch.utils.checkpoint import CheckpointPolicy
    assert transformer._dots_policy(None, mm) is CheckpointPolicy.MUST_SAVE
    assert (transformer._dots_policy(None, bmm)
            is CheckpointPolicy.PREFER_RECOMPUTE)


def test_parle_round_with_remat_equals_plain():
    rcfg, tree, _ = _family_inputs("dense")
    cfg = port_config(rcfg)
    pcfg = ParleConfig(n_replicas=2, L=2, lr=0.05, lr_inner=0.05,
                       batches_per_epoch=1)
    batch = to_torch(family_batch(rcfg, B=2, T=32, lead=(2, 2)))
    out = {}
    for remat in (False, True):
        state = registry.get("parle").init(params_from_numpy(tree, "cpu"),
                                           pcfg)
        rnd = steps.make_algorithm_round("parle", cfg, pcfg, remat=remat,
                                         use_kernel=False)
        state, m = rnd(state, batch)
        out[remat] = (m["losses"], state.x, state.y)
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a, b)
