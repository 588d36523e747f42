"""The port's dry-run contract (``launch/specs.py``) against the
reference's ``launch/specs.py``: the input-shape table, the batch specs
of all six families (shapes and dtypes: meta tensors against
ShapeDtypeStructs), and the partition specs of the Parle state, the
caches and the batches, as tuples, for the ten archs at full size on
both production meshes (the reference is handed a stub with the mesh's
``.shape``, not 512 host devices)."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import ParleConfig as RefParleConfig
from repro.launch import specs as ref_specs
from repro.sharding import partition as ref_partition
from repro_torch.configs import ARCHS, ParleConfig, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.sharding import partition
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
          torch.float32: jnp.float32}
FAMILY_ARCHS = {"dense": "llama3-8b", "moe": "qwen2-moe-a2.7b",
                "ssm": "mamba2-1.3b", "hybrid": "zamba2-1.2b",
                "vlm": "internvl2-1b", "audio": "musicgen-large"}


class MeshStub:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, axes):
        self.shape = dict(axes)


MESHES = {name: mesh_lib.parse_mesh_spec(spec)
          for name, spec in mesh_lib.PRODUCTION_MESHES.items()}


def _ref_leaves(tree):
    """[(path, leaf)] of a reference tree whose leaves are
    PartitionSpecs or ShapeDtypeStructs, dict keys and fields by name."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out.append((tuple(getattr(k, "key", getattr(k, "name", None))
                          for k in path), leaf))
    return out


def _port_leaves(tree):
    """The same for a port tree: nested dicts and NamedTuples of Specs or
    tensors."""
    if hasattr(tree, "_fields"):
        tree = {f: getattr(tree, f) for f in tree._fields}
    if isinstance(tree, dict):
        return [((k,) + p, l) for k in sorted(tree)
                for p, l in _port_leaves(tree[k])]
    return [((), tree)]


def _same_specs(port_tree, ref_tree):
    got = sorted((p, tuple(s)) for p, s in _port_leaves(port_tree))
    want = sorted((p, tuple(s)) for p, s in _ref_leaves(ref_tree))
    assert got == want


def test_input_shapes_table():
    assert set(specs.INPUT_SHAPES) == {"train_4k", "prefill_32k",
                                       "decode_32k", "long_500k"}
    assert specs.INPUT_SHAPES == ref_specs.INPUT_SHAPES
    assert specs.INPUT_SHAPES["long_500k"]["seq_len"] == 524_288
    # long_500k forces sub-quadratic attention for attention archs
    cfg = specs.adapt_for_shape(get_config("llama3-8b"), "long_500k")
    assert cfg.sliding_window == specs.LONG_CONTEXT_WINDOW == \
        ref_specs.LONG_CONTEXT_WINDOW
    cfg = specs.adapt_for_shape(get_config("mamba2-1.3b"), "long_500k")
    assert cfg.sliding_window == 0
    for shape in specs.INPUT_SHAPES:
        for arch in ARCHS:
            assert specs.adapt_for_shape(ARCHS[arch], shape).sliding_window \
                == ref_specs.adapt_for_shape(REF_ARCHS[arch],
                                             shape).sliding_window


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_batch_specs_match_reference(family):
    arch = FAMILY_ARCHS[family]
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    pairs = [(specs.train_batch_specs(cfg, 64, 4, 2),
              ref_specs.train_batch_specs(rcfg, 64, 4, 2)),
             (specs.prefill_batch_specs(cfg, 64, 3),
              ref_specs.prefill_batch_specs(rcfg, 64, 3)),
             (specs.decode_batch_specs(cfg, 5),
              ref_specs.decode_batch_specs(rcfg, 5))]
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape, k
            assert DTYPES[t.dtype] == want[k].dtype, k


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(port params, reference params, port cache, reference cache) of
    ``arch`` at full size; the caches at decode_32k."""
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    info = specs.INPUT_SHAPES["decode_32k"]
    return (specs.param_shapes(cfg), ref_specs.param_shapes(rcfg),
            specs.cache_shapes(cfg, info["global_batch"], info["seq_len"]),
            ref_specs.cache_shapes(rcfg, info["global_batch"],
                                   info["seq_len"]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_partition_specs_match_reference(arch, mesh):
    """Parle state, cache (decode_32k) and batch (train and decode)
    partition specs, raw and sanitized against the mesh."""
    axes, stub = MESHES[mesh], MeshStub(MESHES[mesh])
    raxis = mesh_lib.replica_axis_of(axes)
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    n = axes.get(raxis, 1) if raxis else 1
    params, ref_params, cache, ref_cache = _shapes(arch)

    got = specs.parle_state_pspecs(cfg, params, raxis)
    want = ref_specs.parle_state_pspecs(rcfg, ref_params, raxis)
    _same_specs(got, want._asdict() | {"scopes": want.scopes._asdict()})
    shapes = specs._parle_state_tree(params, ParleConfig(n_replicas=n))
    ref_shapes = ref_specs._parle_state_sds(ref_params,
                                            RefParleConfig(n_replicas=n))
    got = partition.sanitize_pspecs(got, shapes, axes)
    want = ref_partition.sanitize_pspecs(want, ref_shapes, stub)
    _same_specs(got, want._asdict() | {"scopes": want.scopes._asdict()})

    assert {p: tuple(t.shape) for p, t in _port_leaves(cache)} == {
        p: s.shape for p, s in _ref_leaves(ref_cache)}
    _same_specs(specs.cache_pspecs(cfg, cache, axes),
                ref_specs.cache_pspecs(rcfg, ref_cache, stub))

    for kw in (dict(batch_axes=("data",)),
               dict(batch_axes=("data", "model"))):
        batch = specs.train_batch_specs(cfg, 4096, 256 // n, n)
        ref_batch = ref_specs.train_batch_specs(rcfg, 4096, 256 // n, n)
        _same_specs(specs.batch_pspec_tree(batch, axes, raxis, True, **kw),
                    ref_specs.batch_pspec_tree(ref_batch, stub, raxis, True,
                                               **kw))
        dec = specs.decode_batch_specs(cfg, 128)
        _same_specs(specs.batch_pspec_tree(dec, axes, None, False, **kw),
                    ref_specs.batch_pspec_tree(
                        ref_specs.decode_batch_specs(rcfg, 128), stub, None,
                        False, **kw))
