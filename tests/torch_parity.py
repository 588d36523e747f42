"""Shared helpers of the PyTorch-port parity tests (not a test module).

Every input is drawn with numpy from a seed and handed to both
packages: the JAX reference (``repro``) gets ``jnp`` arrays, the port
(``repro_torch``) gets CPU tensors through ``params_from_numpy``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models.model import build_model as ref_build_model
from repro_torch.models.convert import params_from_numpy

torch.set_float32_matmul_precision("highest")

aten = torch.ops.aten
# ops a CUDA graph cannot capture: each makes the host wait on the device
# (a value read back, a shape that depends on the data, a copy between
# host and device)
HOST_SYNC_OPS = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
                 aten._unique, aten._unique2, aten.unique_dim,
                 aten.unique_consecutive, aten.lift_fresh,
                 aten.lift_fresh_copy}
INDEX_OPS = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


class NoHostSync(TorchDispatchMode):
    """Raises on every op in ``HOST_SYNC_OPS``, on a copy to another
    device, on indexing by a boolean mask and on ``repeat_interleave``
    by a tensor of counts (both size their output from the data)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in HOST_SYNC_OPS:
            raise AssertionError(f"{func} would make the host wait")
        if packet is aten._to_copy and "device" in kwargs:
            raise AssertionError(f"{func} copies to {kwargs['device']}")
        if packet in INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            raise AssertionError(f"{func} indexes by a boolean mask")
        if func in (aten.repeat_interleave.Tensor,
                    aten.repeat_interleave.self_Tensor):
            raise AssertionError(f"{func} sizes its output from the data")
        return func(*args, **kwargs)


# f32 logits after a few layers: different summation orders in XLA's
# and PyTorch's CPU matmuls leave ~1e-6 relative differences
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# one attention op on small inputs, the reference kernel test's bound
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


# float32 products on TF32 tensor cores, modelled on the CPU: TF32 rounding
# by bit masking (csrc/tf32x3.cuh)
def _tf32(x, round_to_nearest=True):
    """``x`` (float32) to TF32, 10 mantissa bits: to nearest with ties
    away (the kernel's big part: add half a TF32 ulp to the magnitude
    bits, clear the 13 low ones) or by truncation (how the tensor core
    reads the small part)."""
    bits = x.contiguous().view(torch.int32)
    if round_to_nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big, round_to_nearest=False)


def _product_3xtf32(eq, a, b):
    """einsum ``eq`` of float32 a and b as the 3xTF32 kernels (K3, K9)
    compute it: three products of TF32 parts, the small terms first; each
    product of two TF32 values is exact in float32, as on the tensor
    core."""
    (a_big, a_small), (b_big, b_small) = _split(a), _split(b)
    return (torch.einsum(eq, a_small, b_big)
            + torch.einsum(eq, a_big, b_small)
            + torch.einsum(eq, a_big, b_big))


def _product_1xtf32(eq, a, b):
    """One TF32 product per float32 product: what the split avoids."""
    return torch.einsum(eq, _tf32(a), _tf32(b))


def numpy_params(cfg, seed: int = 0):
    """A param tree with the reference's names and shapes, drawn with
    numpy: fan-in scaled projections, small embeddings, norm weights
    and QKV biases away from their trivial 1 / 0 so both are exercised."""
    shapes = jax.eval_shape(ref_build_model(cfg).init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(sd.shape).astype(np.float32)
        if "embed" in name:
            return z * np.float32(0.02)
        if name.endswith("['bq']") or name.endswith("['bk']") \
                or name.endswith("['bv']"):
            return z * np.float32(0.1)
        if "ln" in name:
            return np.float32(1.0) + np.float32(0.1) * z
        return z / np.float32(np.sqrt(sd.shape[-2]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def both_params(cfg, seed: int = 0):
    """(reference params as jnp, port params as CPU tensors), equal."""
    tree = numpy_params(cfg, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def assert_close(port, ref, tol, what=""):
    """``port`` (torch) against ``ref`` (jax or numpy); prints and
    returns the max absolute error measured (``pytest -s`` shows it)."""
    p = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else port
    r = np.asarray(ref)
    np.testing.assert_allclose(p, r, err_msg=what, **tol)
    err = max_err(p, r)
    print(f"[parity] {what}: max_abs_err {err:.3e}")
    return err


def ref_rounds(model_cfg, np_params, batches, use_kernel, algo="parle",
               **pcfg_kw):
    """The reference's rounds of ``algo`` (Parle by default) on numpy
    params and round batches (then its flush, under ``sync_overlap``):
    (final state, per-step losses as one numpy vector)."""
    from repro.configs.base import ParleConfig
    from repro.core import parle, registry
    pcfg = ParleConfig(**pcfg_kw)
    algo = registry.get(algo)
    st = parle.dealias_state(algo.init(jax.tree.map(jnp.asarray, np_params),
                                       pcfg))
    rnd = algo.make_round_fn(ref_build_model(model_cfg).loss, pcfg,
                             use_kernel=use_kernel)
    losses = []
    for b in batches:
        st, m = rnd(st, jax.tree.map(jnp.asarray, b))
        losses.append(np.asarray(m["losses"]))
    flush = algo.make_round_flush_fn(pcfg)
    if flush is not None:
        st = flush(st)
    return st, np.concatenate(losses)


def port_rounds(model_cfg, np_params, batches, use_kernel, **pcfg_kw):
    """The port's counterpart of :func:`ref_rounds`, on the CPU: (final
    state, per-step losses as one tensor)."""
    from repro_torch.configs import ParleConfig
    from repro_torch.core import registry
    from repro_torch.models.model import build_model
    pcfg = ParleConfig(**pcfg_kw)
    algo = registry.get("parle")
    st = algo.init(params_from_numpy(np_params, "cpu"), pcfg)
    rnd = algo.make_round_fn(build_model(model_cfg).loss, pcfg,
                             use_kernel=use_kernel)
    losses = []
    for b in batches:
        st, m = rnd(st, {k: torch.from_numpy(np.array(v))
                         for k, v in b.items()})
        losses.append(m["losses"])
    flush = algo.make_round_flush_fn(pcfg)
    if flush is not None:
        st = flush(st)
    return st, torch.cat(losses)


def leaf_pairs(port_tree, ref_tree):
    """[(path string, port numpy leaf, reference leaf)] over the
    reference tree's leaves; ``port_tree`` is ``state_to_numpy(...)[f]``."""
    out = []
    for path, r in jax.tree_util.tree_leaves_with_path(ref_tree):
        p = port_tree
        for k in path:
            p = p[k.key]
        out.append((jax.tree_util.keystr(path), p, r))
    return out


# ------------------------------------------------------------------
# model families: one numpy input, both packages
# ------------------------------------------------------------------

def port_config(ref_cfg):
    """The port's own ``ModelConfig`` with the reference config's values."""
    import dataclasses
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def ssm_init_draws(tree, seed: int = 1):
    """``tree`` (a ``numpy_params`` tree of the ssm or hybrid family) with
    ``A_log`` and ``dt_bias`` drawn from the Mamba2 init's own
    distribution (A = -[1 .. 16], dt around 1e-3 .. 1e-1).  With the
    generic draws (dt near 0.7) the masked decays of a 32-token chunk
    overflow and the reference's backward turns NaN — the reference
    fault of ROADMAP.md §3; the port's stays finite there."""
    rng = np.random.default_rng(seed)
    lay = tree["layers"]
    L, nh = lay["A_log"].shape
    lay["A_log"] = np.broadcast_to(np.log(np.linspace(
        1.0, 16.0, nh, dtype=np.float32)), (L, nh)).copy()
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (L, nh)))
    lay["dt_bias"] = np.log(np.expm1(dt0)).astype(np.float32)
    return tree


def family_batch(cfg, B: int = 2, T: int = 32, seed: int = 1, lead=()):
    """A numpy batch of the family's keys: tokens and labels ((B, K, T)
    for audio), plus ``patch_embeds`` (vlm) or ``cond`` (audio)."""
    rng = np.random.default_rng(seed)
    lead = tuple(lead)
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size, size=lead + (
            B, cfg.num_codebooks, T)).astype(np.int32)
        return {"tokens": toks, "labels": toks,
                "cond": rng.standard_normal(lead + (
                    B, cfg.cond_len, cfg.d_model)).astype(np.float32)}
    toks = rng.integers(0, cfg.vocab_size,
                        size=lead + (B, T)).astype(np.int32)
    b = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(lead + (
            B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def family_requests(cfg, lens, seed: int = 7):
    """Engine requests as numpy dicts: (T,) prompts ((K, T) for audio)
    with the family's conditioning (``patch_embeds`` / ``cond``)."""
    rng = np.random.default_rng(seed)
    out = []
    for T in lens:
        shape = (cfg.num_codebooks, T) if cfg.family == "audio" else (T,)
        req = {"tokens": rng.integers(0, cfg.vocab_size,
                                      size=shape).astype(np.int32)}
        if cfg.family == "vlm":
            req["patch_embeds"] = rng.standard_normal(
                (cfg.num_patches, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            req["cond"] = rng.standard_normal(
                (cfg.cond_len, cfg.d_model)).astype(np.float32)
        out.append(req)
    return out


def run_engine(engine_cls, cfg, params, reqs, gen: int = 8, max_len: int = 32,
               num_slots: int = 2, arrivals=None, **kw):
    """Serve ``reqs`` through one engine of either package: (results,
    engine)."""
    eng = engine_cls(cfg, params, num_slots=num_slots, max_len=max_len,
                     decode_chunk=3, **kw)
    for i, r in enumerate(reqs):
        eng.submit(r["tokens"], max_new_tokens=gen, cond=r.get("cond"),
                   patch_embeds=r.get("patch_embeds"),
                   arrival=0 if arrivals is None else arrivals[i])
    return eng.run(), eng


def assert_same_tokens(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(np.asarray(got[uid]),
                                      np.asarray(want[uid]),
                                      err_msg=f"req {uid}")


def check_forward(ref_cfg, params, tol, batch):
    """``Model.apply`` of both packages on one batch: the shapes of the
    reference's contract, finite logits within ``tol``, and the aux
    loss."""
    from repro_torch.models.model import build_model
    rp, pp = params
    want, r_aux = ref_build_model(ref_cfg).apply(rp, to_jax(batch))
    got, aux = build_model(port_config(ref_cfg)).apply(pp, to_torch(batch))
    B, T = batch["tokens"].shape[0], batch["tokens"].shape[-1]
    shape = ((B, T, ref_cfg.num_codebooks, ref_cfg.vocab_size)
             if ref_cfg.family == "audio" else (B, T, ref_cfg.vocab_size))
    assert tuple(got.shape) == shape
    assert bool(torch.isfinite(got).all())
    assert_close(aux, r_aux, tol, f"{ref_cfg.name} aux")
    return assert_close(got, want, tol, f"{ref_cfg.name} logits")


def check_loss_and_grads(ref_cfg, np_params, tol, batch):
    """The loss (ce + aux) and the grad of every leaf, both packages."""
    from repro_torch.models.model import build_model
    (r_loss, r_aux), r_grads = jax.value_and_grad(
        ref_build_model(ref_cfg).loss, has_aux=True)(
        jax.tree.map(jnp.asarray, np_params), to_jax(batch))
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), np_params)
    loss, aux = build_model(port_config(ref_cfg)).loss(pp, to_torch(batch))
    loss.backward()
    assert_close(loss, r_loss, tol, f"{ref_cfg.name} loss")
    assert_close(aux["ce"], r_aux["ce"], tol, f"{ref_cfg.name} ce")
    for path, r in jax.tree_util.tree_leaves_with_path(r_grads):
        p = pp
        for k in path:
            p = p[k.key]
        assert_close(p.grad, r, tol,
                     f"{ref_cfg.name} grad{jax.tree_util.keystr(path)}")
    return float(loss.detach())


def _argmax_tokens(logits):
    """Greedy next tokens of the last position: (B, 1) or (B, K, 1)."""
    return np.asarray(jnp.argmax(logits[:, -1], -1))[..., None].astype(
        np.int32)


def check_prefill_decode(ref_cfg, params, tol, batch, steps: int = 3,
                         max_len: int = 64):
    """Prefill the batch, then ``steps`` greedy decodes fed the
    reference's tokens: logits within ``tol`` and the cache position."""
    from repro_torch.models.model import build_model, cache_positions
    rp, pp = params
    rm, pm = ref_build_model(ref_cfg), build_model(port_config(ref_cfg))
    B = batch["tokens"].shape[0]
    r_logits, r_cache = rm.prefill(rp, to_jax(batch),
                                   rm.init_cache(rp, B, max_len))
    p_logits, p_cache = pm.prefill(pp, to_torch(batch),
                                   pm.init_cache(pp, B, max_len))
    err = assert_close(p_logits, r_logits, tol, f"{ref_cfg.name} prefill")
    for i in range(steps):
        tok = _argmax_tokens(r_logits)
        r_logits, r_cache = rm.decode(rp, {"tokens": jnp.asarray(tok)},
                                      r_cache)
        p_logits, p_cache = pm.decode(pp, {"tokens": torch.from_numpy(tok)},
                                      p_cache)
        err = max(err, assert_close(p_logits, r_logits, tol,
                                    f"{ref_cfg.name} decode {i}"))
    np.testing.assert_array_equal(np.asarray(cache_positions(p_cache)),
                                  np.asarray(_ref_positions(r_cache)))
    return err


def _ref_positions(cache):
    from repro.models.model import cache_positions
    return cache_positions(cache)


def check_paged_entry_points(ref_cfg, params, tol, req, use_kernel: bool,
                             chunk: int = 16, slots: int = 3, slot: int = 1):
    """One slot's chunked prefill through the page table (the last chunk
    padded), then two masked decode steps over the slot batch
    (``decode_paged``, the kernel flag as given: K8's plain version on
    the CPU), then two through the dense view and its restore: every
    active row's logits within ``tol``, and the cache positions."""
    from repro_torch.models.model import build_model, cache_positions
    rp, pp = params
    rm = ref_build_model(ref_cfg, use_paged_kernel=use_kernel)
    pm = build_model(port_config(ref_cfg), use_paged_kernel=use_kernel)
    ps, mp = 16, 6
    r_cache = rm.init_paged_cache(rp, slots, slots * mp + 1, ps, mp)
    p_cache = pm.init_paged_cache(pp, slots, slots * mp + 1, ps, mp)
    table = np.zeros((slots, mp), np.int32)
    table[slot] = 1 + np.arange(mp)
    r_cache = r_cache._replace(**_with_table(r_cache, jnp.asarray(table)))
    p_cache = p_cache._replace(**_with_table(p_cache,
                                             torch.from_numpy(table)))
    cond = {k: v[None] for k, v in req.items() if k != "tokens"}
    toks = req["tokens"]
    ce = len(req["cond"]) if "cond" in req else 0
    total = ce + toks.shape[-1]
    err = 0.0
    for f in range(0, total, chunk):
        valid = min(chunk, total - f)
        c = np.zeros(toks.shape[:-1] + (chunk,), np.int32)
        lo = max(f - ce, 0)
        span = toks[..., lo:max(f + chunk - ce, lo)]
        c[..., lo + ce - f:lo + ce - f + span.shape[-1]] = span
        b = dict(cond, tokens=c[None])
        r_logits, r_cache = rm.prefill_chunk(
            rp, to_jax(b), r_cache, jnp.int32(slot), jnp.int32(f),
            jnp.int32(valid), jnp.int32(total))
        p_logits, p_cache = pm.prefill_chunk(pp, to_torch(b), p_cache, slot,
                                             f, valid, total)
        if f + chunk > ce:          # some rows of the token region
            err = max(err, assert_close(
                p_logits[:, :valid], r_logits[:, :valid], tol,
                f"{ref_cfg.name} prefill_chunk {f}"))
    pos = np.zeros((slots,), np.int32)
    pos[slot] = total
    r_cache = _set_positions_ref(r_cache, jnp.asarray(pos))
    p_cache = _set_positions_port(p_cache, torch.from_numpy(pos))
    active = np.zeros((slots,), bool)
    active[slot] = True
    tok = np.broadcast_to(_argmax_tokens(r_logits[:, valid - 1:valid]),
                          (slots,) + _argmax_tokens(r_logits).shape[1:]).copy()
    for i in range(2):
        r_logits, r_cache = rm.decode_paged(rp, {"tokens": jnp.asarray(tok)},
                                            r_cache, jnp.asarray(active))
        p_logits, p_cache = pm.decode_paged(pp, {"tokens": torch.from_numpy(
            tok)}, p_cache, torch.from_numpy(active))
        err = max(err, assert_close(p_logits[slot], r_logits[slot], tol,
                                    f"{ref_cfg.name} decode_paged {i}"))
        tok = np.broadcast_to(_argmax_tokens(r_logits[slot:slot + 1]),
                              tok.shape).copy()
    r_dense, p_dense = rm.paged_to_dense(r_cache), pm.paged_to_dense(p_cache)
    for i in range(2):
        r_logits, r_dense = rm.decode(rp, {"tokens": jnp.asarray(tok)},
                                      r_dense)
        p_logits, p_dense = pm.decode(pp, {"tokens": torch.from_numpy(tok)},
                                      p_dense)
        err = max(err, assert_close(p_logits[slot], r_logits[slot], tol,
                                    f"{ref_cfg.name} dense view {i}"))
        tok = np.broadcast_to(_argmax_tokens(r_logits[slot:slot + 1]),
                              tok.shape).copy()
    r_cache = rm.paged_restore(r_cache, r_dense, jnp.asarray(active), 2)
    p_cache = pm.paged_restore(p_cache, p_dense, torch.from_numpy(active), 2)
    np.testing.assert_array_equal(np.asarray(cache_positions(p_cache)),
                                  np.asarray(_ref_positions(r_cache)))
    assert int(cache_positions(p_cache)[slot]) == total + 4
    return err


def _with_table(cache, table):
    """{field: value} replacing the page table of a (nested) paged cache."""
    if hasattr(cache, "table"):
        return {"table": table}
    return {"kv": cache.kv._replace(table=table)}


def _set_positions_ref(cache, pos):
    from repro.models.model import with_cache_positions
    return with_cache_positions(cache, pos)


def _set_positions_port(cache, pos):
    from repro_torch.models.model import with_cache_positions
    return with_cache_positions(cache, pos)


def check_parle_step(ref_cfg, np_params, tol, batch):
    """One Parle (n = 2, L = 2) step of both packages' step factories on
    the same params and per-replica batches (``batch`` leaves lead with
    the replica axis): the loss and the state's x and y within ``tol``,
    the step counter advanced."""
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.launch import steps as ref_steps
    from repro_torch.configs import ParleConfig
    from repro_torch.launch import steps
    from repro_torch.models.convert import state_to_numpy
    from repro_torch.core import registry
    kw = dict(n_replicas=2, L=2, lr=0.05, lr_inner=0.05)
    r_step = jax.jit(ref_steps.make_algorithm_step(
        "parle", ref_cfg, RefParleConfig(**kw)))
    from repro.core import registry as ref_registry
    rs = ref_registry.get("parle").init(jax.tree.map(jnp.asarray, np_params),
                                        RefParleConfig(**kw))
    rs, rm = r_step(rs, to_jax(batch))
    pcfg = ParleConfig(**kw)
    step = steps.make_algorithm_step("parle", port_config(ref_cfg), pcfg)
    ps = registry.get("parle").init(params_from_numpy(np_params, "cpu"),
                                    pcfg)
    ps, pm = step(ps, to_torch(batch))
    assert bool(torch.isfinite(pm["loss"]).all())
    err = assert_close(pm["loss"], rm["loss"], tol,
                       f"{ref_cfg.name} parle loss")
    got = state_to_numpy(ps)
    for f in ("x", "y"):
        for path, p, r in leaf_pairs(got[f], getattr(rs, f)):
            err = max(err, assert_close(p, r, tol,
                                        f"{ref_cfg.name} parle {f}{path}"))
    assert int(got["step"]) == int(rs.step) == 1
    return err


def check_loss_decreases(ref_cfg, np_params, batch, steps: int = 10):
    """The reference's ``test_loss_decreases_under_sgd`` contract on the
    port: ten SGD steps (lr 0.1) on one batch lower the loss."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import sgd
    model = build_model(port_config(ref_cfg))
    st = sgd.init(params_from_numpy(np_params, "cpu"))
    step = sgd.make_train_step(model.loss, 0.1)
    losses = []
    for _ in range(steps):
        st, m = step(st, to_torch(batch))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], (ref_cfg.name, losses)
    return losses


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the module that imports this
    fixture: the tier-1 run puts six test workers on the machine's
    cores, and one torch thread pool each oversubscribes them (the hybrid
    family's 0.3 s SGD test took 38 s under that load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
