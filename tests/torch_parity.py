"""Shared helpers of the PyTorch-port parity tests (not a test module).

Every input is drawn with numpy from a seed and handed to both
packages: the JAX reference (``repro``) gets ``jnp`` arrays, the port
(``repro_torch``) gets CPU tensors through ``params_from_numpy``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model import build_model as ref_build_model
from repro_torch.models.convert import params_from_numpy

torch.set_float32_matmul_precision("highest")

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


def ref_rounds(model_cfg, np_params, batches, use_kernel, **pcfg_kw):
    """The reference's Parle rounds on numpy params and round batches
    (then its flush, under ``sync_overlap``): (final state, per-step
    losses as one numpy vector)."""
    from repro.configs.base import ParleConfig
    from repro.core import parle, registry
    pcfg = ParleConfig(**pcfg_kw)
    algo = registry.get("parle")
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
