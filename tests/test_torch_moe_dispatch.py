"""The port's grouped and expert-parallel (shard_map) MoE dispatches
(``models/moe.py``) against the reference's own ``moe_forward_grouped``
and ``moe_forward_shard_map``, run under a (1, 1) mesh of Auto axes on
the CPU (under jax 0.9's default Explicit axes the reference's
``with_sharding_constraint`` asserts): outputs, the aux loss and, for
the grouped dispatch, the grads, at a drop-free capacity and at one that
drops.  Then the port's own contracts: grouped = flat where nothing is
dropped, and two gloo ranks summing their columns over "model" = the
one-process column sum (the all-reduce counted as B·T·d·4 bytes on
axis "model"), with a backward through that sum = the flat dispatch's
grads (the tokens' and gates' grads summed over "model" once each).

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
from repro_torch.models import megatron, moe
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
        with megatron.tensor_parallel(megatron.TensorParallel(2, m)):
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
    """Two gloo ranks, each one column of the shard_map dispatch summed
    over "model": the forward = the one-process column sum; the grads of
    sum(y * w) / (B T) + aux through the sum = the flat dispatch's: x's
    and the router's whole on each rank, each expert's and the shared
    ff's on the rank whose column holds them (zero on the other)."""
    rcfg, _ = _cfgs(CAPACITIES["drops"])
    pcfg = port_config(dataclasses.replace(rcfg, moe_impl="shard_map"))
    layer = jax.tree.map(np.asarray, _layer(rcfg))
    x, r = _inputs(rcfg)
    w = r / np.float32(B * T)
    got = torch_ranks.spawn(torch_ranks.moe_columns, 2,
                            os.path.join(tmp_path, "store"), layer, pcfg, x,
                            w)
    pl, xt = _torch_tree(layer), torch.from_numpy(x)
    cols = []
    for m in range(2):
        with megatron.tensor_parallel(megatron.TensorParallel(2, m)):
            cols.append(moe.moe_forward(pl, pcfg, xt)[0])
    want = cols[0] + cols[1]
    pg, xg = _torch_tree(layer, grad=True), torch.tensor(x,
                                                         requires_grad=True)
    flat, aux = moe.moe_forward(pg, dataclasses.replace(pcfg,
                                                        moe_impl="pjit"), xg)
    (torch.sum(flat * torch.from_numpy(w)) + aux).backward()
    E, sff = pcfg.num_experts, pcfg.shared_expert_d_ff
    for m, rank in enumerate(got):
        assert_close(torch.from_numpy(rank["y"]), want, FLAT_TOL,
                     "the ranks' sum over model")
        assert_close(torch.from_numpy(rank["gx"]), xg.grad, FLAT_TOL,
                     "grad x")
        g = rank["grads"]
        assert_close(torch.from_numpy(g["router"]), pg["router"].grad,
                     FLAT_TOL, "grad router")
        lo, hi = megatron.split(E, 2, m)
        flo, fhi = megatron.split(sff, 2, m)
        for k in ("w_gate", "w_up", "w_down"):
            assert_close(torch.from_numpy(g[k][lo:hi]),
                         pg[k].grad[lo:hi], FLAT_TOL, f"grad {k}")
            assert not np.any(np.delete(g[k], np.s_[lo:hi], 0))
            dim = 0 if k == "w_down" else 1
            sl = [slice(None)] * 2
            sl[dim] = slice(flo, fhi)
            assert_close(torch.from_numpy(g["shared"][k][tuple(sl)]),
                         pg["shared"][k].grad[tuple(sl)], FLAT_TOL,
                         f"grad shared {k}")
        # three forwards' sums, and in the backward the sums of the
        # tokens' and the gates' grads (B T d and B T K float32)
        d, K = rcfg.d_model, rcfg.top_k
        assert rank["counts"] == {"model": {"all_reduce": (
            4, 3 * B * T * d * 4 + B * T * K * 4)}}
