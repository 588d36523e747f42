"""Input specs and partition-spec trees for every (architecture x input
shape) pair — the dry run's contract.  Port of ``repro/launch/specs.py``.

Nothing is allocated here: parameters come from
``sharding/planner.py::meta_params``, batches and caches are tensors on
the ``meta`` device (shapes and dtypes, no storage), the counterpart of
the reference's ShapeDtypeStructs.  Partition specs are trees of
``sharding/rules.py::Spec``; a mesh is the axis-size dict of
``launch/mesh.py::parse_mesh_spec``.  The reference's ``to_shardings``
has no counterpart: the bytes a rank holds come from
``utils/pytree.py::ShardedLayout`` over the plan (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.attention import KVCache
from repro_torch.models.hybrid import HybridCache
from repro_torch.models.mamba2 import SSMCache
from repro_torch.models.model import build_model
from repro_torch.sharding import planner
from repro_torch.sharding.rules import DATA, MODEL, Spec
from repro_torch.utils.pytree import tree_map

# the four assigned input shapes
INPUT_SHAPES = {
    "train_4k":    dict(kind="train",   seq_len=4_096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32_768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq_len=32_768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq_len=524_288, global_batch=1),
}

LONG_CONTEXT_WINDOW = 8_192     # sliding window for attention archs @ 500k

# the token batches' dtype (``data/synthetic.py``)
TOKEN_DTYPE = torch.int32


def adapt_for_shape(cfg, shape_name: str):
    """long_500k requires sub-quadratic attention: attention-bearing
    families switch to the sliding-window variant; ssm needs nothing
    (constant-state decode)."""
    if shape_name == "long_500k" and cfg.family != "ssm" and cfg.num_heads > 0:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


# ------------------------------------------------------------------
# Batches (meta tensors)
# ------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg, seq_len: int, per_replica_batch: int,
                      n_replicas: int, dtype=torch.bfloat16):
    """Batch leaves carry a leading replica axis (even for n=1)."""
    n, B, T = n_replicas, per_replica_batch, seq_len
    if cfg.family == "audio":
        K = cfg.num_codebooks
        return {"tokens": _meta((n, B, K, T), TOKEN_DTYPE),
                "labels": _meta((n, B, K, T), TOKEN_DTYPE),
                "cond": _meta((n, B, cfg.cond_len, cfg.d_model), dtype)}
    b = {"tokens": _meta((n, B, T), TOKEN_DTYPE),
         "labels": _meta((n, B, T), TOKEN_DTYPE)}
    if cfg.family == "vlm":
        b["patch_embeds"] = _meta((n, B, cfg.num_patches, cfg.d_model), dtype)
    return b


def prefill_batch_specs(cfg, seq_len: int, batch: int, dtype=torch.bfloat16):
    if cfg.family == "audio":
        return {"tokens": _meta((batch, cfg.num_codebooks, seq_len),
                                TOKEN_DTYPE),
                "cond": _meta((batch, cfg.cond_len, cfg.d_model), dtype)}
    if cfg.family == "vlm":
        return {"tokens": _meta((batch, seq_len), TOKEN_DTYPE),
                "patch_embeds": _meta((batch, cfg.num_patches, cfg.d_model),
                                      dtype)}
    return {"tokens": _meta((batch, seq_len), TOKEN_DTYPE)}


def decode_batch_specs(cfg, batch: int):
    if cfg.family == "audio":
        return {"tokens": _meta((batch, cfg.num_codebooks, 1), TOKEN_DTYPE)}
    return {"tokens": _meta((batch, 1), TOKEN_DTYPE)}


def batch_rows(b: int, size: int) -> Optional[int]:
    """The rows of a batch of ``b`` each of ``size`` ranks holds when the
    batch splits evenly over them, else None (every rank holds all)."""
    return b // size if (b % size == 0 and b >= size) else None


def batch_pspec_tree(batch, axis_sizes: dict, replica_axis: Optional[str],
                     has_replica_axis: bool, batch_axes=(DATA,)):
    """batch_axes=("data", "model") shards the batch over BOTH mesh axes
    (the dp_only policy — no tensor parallelism)."""
    size = 1
    for a in batch_axes:
        size *= axis_sizes.get(a, 1)
    baxes = tuple(batch_axes) if len(batch_axes) > 1 else batch_axes[0]

    def spec(leaf):
        shape = leaf.shape
        lead, off = ([], 0)
        if has_replica_axis:
            lead, off = [replica_axis], 1
        bspec = baxes if batch_rows(shape[off], size) else None
        return Spec(*lead, bspec, *([None] * (len(shape) - off - 1)))

    return tree_map(spec, batch)


# ------------------------------------------------------------------
# Parameter / Parle-state / cache specs
# ------------------------------------------------------------------

def param_shapes(cfg, dtype=torch.bfloat16) -> dict:
    """The param tree of ``cfg`` on the ``meta`` device."""
    return planner.meta_params(build_model(cfg), dtype)


PARLE_ROW_FIELDS = ("x", "y", "z", "v_y", "v_x")


def parle_state_shapes(cfg, pcfg, dtype=torch.bfloat16) -> dict:
    return _parle_state_tree(param_shapes(cfg, dtype), pcfg)


def _parle_state_tree(params, pcfg) -> dict:
    """The tree view of a ParleState (``ParleState.tree()``'s keys): the
    five (n, ...) fields, the step and the scopes."""
    n = pcfg.n_replicas
    rep = tree_map(lambda t: _meta((n,) + tuple(t.shape), t.dtype), params)
    out = {f: rep for f in PARLE_ROW_FIELDS}
    out["step"] = _meta((), torch.int32)
    out["scopes"] = {"gamma": _meta((), torch.float32),
                     "rho": _meta((), torch.float32)}
    return out


def parle_state_pspecs(cfg, params, replica_axis: Optional[str],
                       policy: str = "fsdp_tp") -> dict:
    """The replica axis composed with the planner's spec of every leaf
    (``Plan.pspecs_with_leading``); the step and the scopes replicated."""
    rep = planner.plan_tree(params, policy=policy).pspecs_with_leading(
        replica_axis)
    out = {f: rep for f in PARLE_ROW_FIELDS}
    out.update(step=Spec(), scopes={"gamma": Spec(), "rho": Spec()})
    return out


def cache_shapes(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    """``model.init_cache`` on meta params: the cache on ``meta``."""
    model = build_model(cfg)
    return model.init_cache(param_shapes(cfg, dtype), batch, max_len, dtype)


def cache_pspecs(cfg, cache, axis_sizes: dict):
    """Explicit per-family cache partition specs, as the cache's own
    NamedTuples of ``Spec``.

    A rank's block must divide evenly, so the model-parallel axis lands
    on the first of {kv_heads, head_dim} that the mesh size divides (GQA
    kv counts like 8 or 2 don't divide a 16-wide model axis; head_dim
    64/128 always does)."""
    data_size = axis_sizes.get(DATA, 1)
    model_size = axis_sizes.get(MODEL, 1)

    def bspec(b):
        return DATA if batch_rows(b, data_size) else None

    def mspec(n):
        return MODEL if (n % model_size == 0 and n >= model_size) else None

    def kv_spec(c):      # KVCache with leading layer/site axis
        _, b, _, kv, hd = c.k.shape
        if mspec(kv):
            spec = Spec(None, bspec(b), None, MODEL, None)
        elif mspec(hd):
            spec = Spec(None, bspec(b), None, None, MODEL)
        else:
            spec = Spec(None, bspec(b), None, None, None)
        return KVCache(k=spec, v=spec, pos=Spec())

    def ssm_spec(c):     # SSMCache
        _, b, nh, N, Pdim = c.state.shape
        if mspec(nh):
            sspec = Spec(None, bspec(b), MODEL, None, None)
        elif mspec(Pdim):
            sspec = Spec(None, bspec(b), None, None, MODEL)
        else:
            sspec = Spec(None, bspec(b), None, None, None)
        conv_c = c.conv.shape[-1]
        cspec = Spec(None, bspec(c.conv.shape[1]), None, mspec(conv_c))
        return SSMCache(conv=cspec, state=sspec, pos=Spec())

    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return kv_spec(cache)
    if cfg.family == "ssm":
        return ssm_spec(cache)
    if cfg.family == "hybrid":
        return HybridCache(ssm=ssm_spec(cache.ssm), kv=kv_spec(cache.kv),
                           pos=Spec())
    raise ValueError(cfg.family)
