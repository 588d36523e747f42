"""The Megatron split of a replica over "model" and the MoE on a "data"
axis (``models/megatron.py``, ``models/moe.py::moe_forward_split``,
``core/parle.py::ShardGrads``, the collectives of
``sharding/partition.py::MeshGroups``).

One world of four gloo ranks is spawned (``torch_ranks.spawn``) once for
the module and runs:

  * a small moe model (2 layers, 4 experts top-2 with a shared expert,
    QKV bias; batch 4 x 16) under ``replica:2,data:2`` and
    ``replica:1,data:2,model:2``, through ``ShardGrads``: the loss, the
    aux loss and every leaf's grad against the reference's flat dispatch
    on the global batch in one process (``jax.value_and_grad`` of its
    loss), at a drop-free capacity and at one where tokens drop (where a
    dispatch of each rank's own rows would give another loss);
  * the vocab-parallel CE (an untied head) and a tied head (read whole
    on every rank) on "model" pairs against ``chunked_cross_entropy`` in
    one process: values and grads, one chunk's logits held for the
    backward, and the collectives of each chunk and of its recompute
    counted;
  * the reference's ``t-dense`` under ``replica:2,model:2`` (as in
    ``tests/test_torch_fsdp_tp.py``): losses and the deployable against
    one process and the reference's local path, no leaf gathered over
    "model", a rank's compute row about half the row.

Without ranks: the mean of each data half's own dispatch is not the
batch's at the dropping capacity, and every architecture is on one path
(split, or whole on every "model" rank).

Tolerances are the reference's composed-mesh bounds: rtol 2e-5 on losses,
rtol 2e-5 / atol 2e-6 on the deployable and the grads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import ARCHS
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import build_model
from torch_parity import (family_batch, numpy_params,  # noqa: F401
                          one_torch_thread, port_config)

TOL = dict(rtol=2e-5)
GRAD_TOL = dict(rtol=2e-5, atol=2e-6)

RCFG = RefModelConfig(name="t-moe", family="moe", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=256,
                      head_dim=16, qkv_bias=True, num_experts=4, top_k=2,
                      expert_d_ff=32, num_shared_experts=1,
                      shared_expert_d_ff=64)
# capacity factors: 2.0 gives a bucket of all 64 tokens (nothing drops);
# 0.5 a bucket of 16 of the 128 routed slots' 32 an expert on average
CAPACITIES = {"drop_free": 2.0, "drops": 0.5}
MESHES = {"data2": "replica:2,data:2", "data2model2":
          "replica:1,data:2,model:2"}

DENSE = RefModelConfig(name="t-dense", family="dense", num_layers=2,
                       d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                       vocab_size=512, head_dim=32)
STREAM = dict(vocab_size=512, seq_len=16, batch_size=2, seed=0)
DENSE_CASE = dict(algo="parle", n=2, L=3, mesh="replica:2,model:2",
                  steps=7, mode="step")


def _rcfg(capacity):
    return dataclasses.replace(RCFG, capacity_factor=CAPACITIES[capacity])


@pytest.fixture(scope="module")
def moe_params():
    return jax.tree.map(np.asarray, numpy_params(RCFG))


@pytest.fixture(scope="module")
def batch():
    return family_batch(RCFG, B=4, T=16, seed=1)


@pytest.fixture(scope="module")
def dense_params():
    return jax.tree.map(np.asarray, numpy_params(DENSE))


@pytest.fixture(scope="module")
def world(moe_params, batch, dense_params, tmp_path_factory):
    """Every job on four spawned ranks: [each rank's results]."""
    cases = {f"{m}-{c}": (spec, dataclasses.asdict(port_config(_rcfg(c))),
                          moe_params, batch)
             for m, spec in MESHES.items() for c in CAPACITIES}
    store = str(tmp_path_factory.mktemp("megatron") / "store")
    return torch_ranks.spawn(
        torch_ranks.megatron_world, 4, store, cases, DENSE_CASE,
        {"dense": (dataclasses.asdict(port_config(DENSE)), dense_params)},
        STREAM)


@pytest.fixture(scope="module")
def reference(moe_params, batch):
    """{capacity: (loss, aux, grads by path)} of the reference's flat
    dispatch on the global batch, in one process."""
    out = {}
    for c in CAPACITIES:
        (loss, info), grads = jax.value_and_grad(
            ref_build_model(_rcfg(c)).loss, has_aux=True)(
            jax.tree.map(jnp.asarray, moe_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
        out[c] = (float(loss), float(info["aux"]), {
            "/".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(grads)})
    return out


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_on_a_data_axis_is_the_global_flat_dispatch(world, reference,
                                                        mesh, capacity):
    """Every rank's loss and aux (the data ranks' mean of each rank's)
    and the grads gathered from its shard equal the reference's flat
    dispatch on the whole batch, drops included; each step gathers the
    blocks over "data" once and, in each of the 2 layers, the (2, E)
    expert and top-1 counts once."""
    loss, aux, grads = reference[capacity]
    for r in world:
        got = r[f"{mesh}-{capacity}"]
        err = max(np.abs(got["grads"][k] - g).max()
                  for k, g in grads.items())
        print(f"[megatron] {MESHES[mesh]} {capacity}: loss rel err "
              f"{abs(got['loss'] / loss - 1):.3e}, aux rel err "
              f"{abs(got['aux'] / aux - 1):.3e}, grads max abs err "
              f"{err:.3e}")
        np.testing.assert_allclose(got["loss"], loss, **TOL)
        np.testing.assert_allclose(got["aux"], aux, **TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads"][k], g, err_msg=k,
                                       **GRAD_TOL)
        data = got["counts"]["data"]
        assert data["all_gather"][0] == 1 + RCFG.num_layers
        assert data["reduce_scatter"][0] == 1


def test_a_dispatch_of_each_ranks_rows_would_differ(moe_params, batch):
    """At the dropping capacity, the mean of the two data halves' own flat
    dispatches (each at its own capacity, with its own aux) is not the
    whole batch's loss: the global dispatch above is what the test
    holds."""
    cfg = port_config(_rcfg("drops"))
    loss = build_model(cfg).loss
    params = params_from_numpy(moe_params, "cpu")
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    whole = float(loss(params, t)[0])
    halves = np.mean([float(loss(params, {k: v[h:h + 2]
                                          for k, v in t.items()})[0])
                      for h in (0, 2)])
    print(f"[megatron] per-rank dispatch: {halves:.6f} vs {whole:.6f}")
    assert abs(halves / whole - 1) > 100 * TOL["rtol"]


@pytest.mark.parametrize("kind", ["vocab", "tied"])
def test_split_head_cross_entropy(world, kind):
    """On each "model" pair: the value and the grads of h and of the
    rank's column of the head equal ``chunked_cross_entropy``'s in one
    process.  The vocab-parallel CE: autograd holds one chunk's logits
    (not the four chunks'), and it all-reduces each chunk's max and
    (sum, target) once in the forward and once in the recompute, and h's
    grad once.  A tied head (``lm_cross_entropy`` under the context):
    read whole, no "model" collective, its one chunk's logits held."""
    B, T, d, V, chunk = 2, 32, 32, 64, 8
    for r in world:
        got = r["ce"][kind]
        np.testing.assert_allclose(*got["value"], **TOL)
        np.testing.assert_allclose(*got["gh"], **GRAD_TOL)
        np.testing.assert_allclose(*got["gw"], **GRAD_TOL)
        logits = (B * chunk * V // 2 if kind == "vocab" else B * T * V) * 4
        inputs = (B * T * d + d * V) * 4 + B * T * 4
        assert got["saved"] - inputs < 2 * logits, got["saved"]
        calls = T // chunk * 4 + 1 if kind == "vocab" else 0
        assert got["model"].get("all_reduce", (0, 0))[0] == calls


def test_dense_replica_split_over_model_pairs(world, dense_params):
    """t-dense under replica:2,model:2, 7 steps across two L = 3 syncs:
    the losses within rtol 2e-5 of one process and of the reference's
    local path, the deployable within rtol 2e-5 / atol 2e-6 of one
    process; "model" gathers only the embedding's columns (a step: its 2
    rows x 16 positions x 64 columns) and a rank computes on half the
    row (the norms, 640 elements, whole)."""
    from repro.configs.base import ParleConfig as RefParleConfig
    from repro.core import registry as ref_registry
    from repro.data.synthetic import TokenStream, replica_batches
    one = torch_ranks.run_mesh_case(
        DENSE_CASE, None, dataclasses.asdict(port_config(DENSE)),
        dense_params, STREAM)
    algo = ref_registry.get("parle")
    cfg = algo.canonicalize_cfg(RefParleConfig(
        n_replicas=2, L=3, lr=0.1, lr_inner=0.1, batches_per_epoch=5))
    st = algo.init(jax.tree.map(jnp.asarray, dense_params), cfg)
    step = jax.jit(algo.make_step(ref_build_model(DENSE).loss, cfg))
    stream = TokenStream(**STREAM)
    ref = []
    for i in range(7):
        st, m = step(st, replica_batches(stream, i, 2, 2))
        ref.append(float(m["loss"]))
    for rank in world:
        r = rank["dense"]
        rel = np.abs(r["losses"] / one["losses"] - 1).max()
        dep = max(np.abs(r["deploy"][k] - v).max()
                  for k, v in one["deploy"].items())
        print(f"[megatron] dense replica:2,model:2: losses max rel err "
              f"{rel:.3e}, deployable max abs err {dep:.3e}")
        np.testing.assert_allclose(r["losses"], one["losses"], **TOL)
        np.testing.assert_allclose(r["losses"], ref, **TOL)
        for k, v in one["deploy"].items():
            np.testing.assert_allclose(r["deploy"][k], v, err_msg=k,
                                       **GRAD_TOL)
        gathered = [c["model"]["all_gather"][1] for c in r["counts"]]
        assert list(np.diff([0] + gathered)) == [2 * 16 * 64 * 4] * 7
        assert set(r["counts"][-1]) == {"replica", "model"}
        assert r["column"] == (r["row"] - 640) // 2 + 640


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_each_family_is_on_one_path(arch):
    """Each architecture's leaves under model:2 (its smoke variant, a dry
    rank): a dense or moe replica holds its heads', ff's, experts',
    embedding's and head's columns (the split), every other family every
    leaf whole or gathered over "model" (ROADMAP.md item 6f), so no leaf
    of theirs is read in part."""
    from repro_torch.configs import smoke_variant
    from repro_torch.models import megatron
    from repro_torch.sharding.partition import MeshGroups
    from repro_torch.sharding.planner import meta_params
    cfg = smoke_variant(ARCHS[arch])
    mesh = MeshGroups({"replica": 1, "model": 2}, 1, 0, dry=True)
    lay = mesh.layout(meta_params(build_model(cfg)))
    modes = dict(zip(lay.paths, mesh.column_layout(lay, cfg).modes))
    if megatron.splits_family(cfg):
        for path in (("embed",), ("blocks", "attn", "wq"),
                     ("blocks", "attn", "wo")):
            assert modes[path] == "col", (path, modes[path])
        assert modes[("blocks", "ln1")] == "whole"
    else:
        assert set(modes.values()) <= {"whole", "gather"}
        assert "gather" in modes.values()
