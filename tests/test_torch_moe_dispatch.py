"""The port's grouped and expert-parallel (shard_map) MoE dispatches
(``models/moe.py``) against the reference's own ``moe_forward_grouped``
and ``moe_forward_shard_map``, run under a (1, 1) mesh of Auto axes on
the CPU (under jax 0.9's default Explicit axes the reference's
``with_sharding_constraint`` asserts): outputs, the aux loss and, for
the grouped dispatch, the grads, at a drop-free capacity and at one that
drops.  Then the port's own contracts: grouped = flat where nothing is
dropped, two gloo ranks summing their columns over "model" = the
one-process column sum (the all-reduce counted as B·T·d·4 bytes on
axis "model"), and a backward through that sum raising with the
Megatron half of ROADMAP.md item 6a.

Tolerance: rtol 1e-5 (atol 1e-6 against the flat dispatch, the
reference's contract, 1e-5 against the reference's dispatches)."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_variant as ref_smoke_variant
from repro.models import moe as ref_moe
from repro.utils.compat import use_mesh
from repro_torch.models import moe
from torch_parity import assert_close, numpy_params, port_config
from torch_parity import one_torch_thread  # noqa: F401 (autouse)
import torch_ranks

TOL = dict(rtol=1e-5, atol=1e-5)
FLAT_TOL = dict(rtol=1e-5, atol=1e-6)
REF_CFG = ref_smoke_variant(REF_ARCHS["qwen2-moe-a2.7b"])
# drop-free (the smoke variant's) and a capacity under which the busiest
# experts drop routings
CAPACITIES = {"drop_free": 8.0, "drops": 0.5}
B, T, GROUPS = 2, 64, 4


def _cfgs(capacity_factor, **kw):
    rcfg = dataclasses.replace(REF_CFG, capacity_factor=capacity_factor,
                               **kw)
    return rcfg, port_config(rcfg)


def _layer(rcfg, seed=0):
    tree = numpy_params(rcfg, seed)["blocks"]["moe"]
    return jax.tree.map(lambda v: v[0], tree)


def _inputs(rcfg, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, rcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, T, rcfg.d_model)).astype(np.float32)
    return x, r


def _torch_tree(tree, grad=False):
    return jax.tree.map(
        lambda v: torch.tensor(np.asarray(v)).requires_grad_(grad), tree)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _drops(pcfg, layer, x, groups=1):
    """Whether some expert of some group gets more routings than the
    group's capacity."""
    _, _, ids = moe.route(_torch_tree(layer), pcfg,
                          torch.from_numpy(x).reshape(-1, pcfg.d_model))
    cap = moe._capacity(B * T // groups, pcfg)
    return any(int(torch.bincount(g, minlength=pcfg.num_experts).max()) > cap
               for g in ids.reshape(groups, -1))


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
def test_grouped_dispatch_matches_reference(capacity):
    """Outputs, aux and the grads of sum(y * r) / (B T) + aux (a loss
    averaged over the tokens, as the LM loss is) w.r.t. x and every param
    against ``jax.grad`` of the reference's grouped dispatch."""
    rcfg, pcfg = _cfgs(CAPACITIES[capacity], moe_groups=GROUPS)
    layer, (x, r) = _layer(rcfg), _inputs(rcfg)
    assert _drops(pcfg, layer, x, GROUPS) == (capacity == "drops")

    def ref_obj(p, xx):
        y, aux = ref_moe.moe_forward_grouped(p, rcfg, xx)
        return jnp.sum(y * r) / (B * T) + aux, (y, aux)

    with use_mesh(_auto_mesh()):
        (_, (want, r_aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            ref_obj, argnums=(0, 1), has_aux=True))(
                jax.tree.map(jnp.asarray, layer), jnp.asarray(x))
    pl, xt = _torch_tree(layer, grad=True), torch.tensor(x,
                                                         requires_grad=True)
    got, aux = moe.moe_forward(pl, pcfg, xt)
    (torch.sum(got * torch.from_numpy(r)) / (B * T) + aux).backward()
    assert_close(got, want, TOL, "grouped output")
    assert_close(aux, r_aux, TOL, "grouped aux")
    assert_close(xt.grad, gx, TOL, "grad x")
    for path, g in jax.tree_util.tree_flatten_with_path(gp)[0]:
        node = pl
        for k in path:
            node = node[k.key]
        assert_close(node.grad, g, TOL, f"grad {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("capacity", sorted(CAPACITIES))
def test_two_columns_sum_to_reference_shard_map(capacity):
    """The reference's shard_map dispatch on a (1, 1) mesh is one column
    of every expert; the port's two columns (each half the experts and
    half the shared ff, no group) sum to it, drops included."""
    rcfg, _ = _cfgs(CAPACITIES[capacity])
    pcfg = port_config(dataclasses.replace(rcfg, moe_impl="shard_map"))
    layer, (x, _) = _layer(rcfg), _inputs(rcfg)
    assert _drops(pcfg, layer, x) == (capacity == "drops")
    with use_mesh(_auto_mesh()) as mesh:
        want, r_aux = jax.jit(lambda p, xx: ref_moe.moe_forward_shard_map(
            p, rcfg, xx, mesh))(jax.tree.map(jnp.asarray, layer),
                                jnp.asarray(x))
    pl, xt = _torch_tree(layer), torch.from_numpy(x)
    cols = []
    for m in range(2):
        with moe.expert_parallel(moe.ExpertParallel(2, m)):
            y, aux = moe.moe_forward(pl, pcfg, xt)
        assert_close(aux, r_aux, TOL, f"column {m} aux")
        cols.append(y)
    assert_close(cols[0] + cols[1], want, TOL, "two columns summed")
    # no context: the shard_map setting takes the flat dispatch
    flat, _ = moe.moe_forward(pl, dataclasses.replace(pcfg,
                                                      moe_impl="pjit"), xt)
    assert torch.equal(moe.moe_forward(pl, pcfg, xt)[0], flat)


def test_grouped_equals_flat_where_nothing_drops():
    _, pcfg = _cfgs(CAPACITIES["drop_free"])
    layer, (x, _) = _layer(REF_CFG), _inputs(REF_CFG)
    pl, xt = _torch_tree(layer), torch.from_numpy(x)
    flat, flat_aux = moe.moe_forward(pl, pcfg, xt)
    for groups in (2, 4, 8):
        got, aux = moe.moe_forward(
            pl, dataclasses.replace(pcfg, moe_groups=groups), xt)
        assert_close(got, flat, FLAT_TOL, f"{groups} groups")
        assert_close(aux, flat_aux, FLAT_TOL, f"{groups} groups aux")


def test_two_ranks_equal_the_column_sum(tmp_path):
    rcfg, _ = _cfgs(CAPACITIES["drops"])
    pcfg = port_config(dataclasses.replace(rcfg, moe_impl="shard_map"))
    layer = jax.tree.map(np.asarray, _layer(rcfg))
    x, _ = _inputs(rcfg)
    got = torch_ranks.spawn(torch_ranks.moe_columns, 2,
                            os.path.join(tmp_path, "store"), layer, pcfg, x)
    pl, xt = _torch_tree(layer), torch.from_numpy(x)
    cols = []
    for m in range(2):
        with moe.expert_parallel(moe.ExpertParallel(2, m)):
            cols.append(moe.moe_forward(pl, pcfg, xt)[0])
    want = cols[0] + cols[1]
    for rank in got:
        assert_close(torch.from_numpy(rank["y"]), want, FLAT_TOL,
                     "the ranks' sum over model")
        # two forwards, each one all-reduce of B T d float32
        assert rank["counts"] == {"model": {"all_reduce": (
            2, 2 * B * T * rcfg.d_model * 4)}}
        assert "item 6a" in rank["raised"] and "Megatron" in rank["raised"]
