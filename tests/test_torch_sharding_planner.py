"""The port's sharding planner (``repro_torch/sharding/planner.py`` +
``rules.py``) against the reference's (``repro/sharding/planner.py``),
and the contracts of tests/test_sharding_planner.py carried over.

Every leaf of each of the ten architectures at full size — the port's
params on the ``meta`` device (``planner.meta_params``), the reference's
``jax.eval_shape`` of ``model.init`` — gets the same rule, the same raw
spec, and the same spec after each of the three policies and the
sanitizer under ``{replica: 2, data: 2, model: 2}`` and ``{data: 16,
model: 16}``.  The port's param tree has the reference's names and
shapes (``models/convert.py``), so paths compare as they are.
"""
import logging

import jax
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke
from repro.models.model import build_model as ref_build_model
from repro.sharding import planner as ref_planner
from repro_torch.configs import ParleConfig, get_config, smoke_variant
from repro_torch.core import registry
from repro_torch.models.model import build_model
from repro_torch.sharding import planner, rules
from repro_torch.sharding.partition import (batch_pspecs, param_pspecs,
                                            prepend_axis, sanitize_pspecs)
from repro_torch.sharding.rules import Spec
from repro_torch.utils.pytree import tree_leaves_with_paths

MESHES = ({"replica": 2, "data": 2, "model": 2}, {"data": 16, "model": 16})
POLICIES = ("fsdp_tp", "tp_only", "dp_only")


def _ref_leaves(cfg):
    shapes = jax.eval_shape(ref_build_model(cfg).init,
                            jax.random.PRNGKey(0))
    return [(ref_planner.path_names(p), tuple(l.shape))
            for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_plan_equals_the_reference_at_full_size(arch):
    """Rule, raw spec, and the spec after every policy and the sanitizer
    under both meshes, leaf by leaf, at the architecture's full size."""
    ref = _ref_leaves(ref_get_config(arch))
    params = planner.meta_params(build_model(get_config(arch)))
    plan = planner.plan_tree(params)
    assert [(l.path, l.shape) for l in plan.leaves] == ref
    assert {l.device.type for _, l in tree_leaves_with_paths(params)} \
        == {"meta"}
    for leaf, (names, shape) in zip(plan.leaves, ref):
        rname, rspec = ref_planner.match_rule(names, shape)
        assert (leaf.rule, tuple(leaf.raw_spec)) == (rname, tuple(rspec)), \
            names
        for policy in POLICIES:
            mine = planner._apply_policy(leaf.raw_spec, policy)
            theirs = ref_planner._apply_policy(rspec, policy)
            assert tuple(mine) == tuple(theirs), (names, policy)
            for sizes in MESHES:
                got = planner._sanitize(mine, shape, sizes, names,
                                        warn=False)
                want = ref_planner._sanitize(theirs, shape, sizes, names,
                                             warn=False)
                assert (tuple(got[0]), got[1]) == (tuple(want[0]),
                                                   want[1]), \
                    (names, policy, sizes)


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_every_smoke_leaf_matches_a_named_rule(arch):
    cfg = smoke_variant(get_config(arch))
    plan = planner.plan_tree(planner.meta_params(build_model(cfg)))
    assert "fallback" not in plan.by_rule(), plan.by_rule().get("fallback")
    ref = ref_planner.plan_tree(jax.eval_shape(
        ref_build_model(ref_smoke(ref_get_config(arch))).init,
        jax.random.PRNGKey(0)))
    assert plan.by_rule() == ref.by_rule()


def test_rule_table_fallback_is_last_and_total():
    assert rules.RULE_TABLE[-1][0] == "fallback"
    assert [n for n, _ in rules.RULE_TABLE] == [
        n for n, _ in ref_planner.rules.RULE_TABLE]
    assert rules.fallback_rule(("anything",), (3, 5, 7)) == \
        Spec(None, None, None)
    assert rules.REPLICATED_LEAVES == ref_planner.rules.REPLICATED_LEAVES
    assert rules.STACK_PATH_NAMES == ref_planner.rules.STACK_PATH_NAMES


def test_family_assignments():
    assert rules.attention_rule(("wq",), (64, 64)) == Spec("data", "model")
    assert rules.attention_rule(("wo",), (64, 64)) == Spec("model", "data")
    assert planner.match_rule(("blocks", "attn", "wq"), (4, 64, 64)) == \
        ("attention", Spec(None, "data", "model"))
    assert rules.moe_rule(("moe", "w_down"), (8, 256, 64)) == \
        Spec("model", None, "data")
    assert rules.moe_rule(("shared", "w_gate"), (64, 256)) is None
    assert planner.match_rule(("embed",), (4, 512, 128)) == \
        ("embedding", Spec(None, "data", "model"))
    assert planner.match_rule(("c1", "w"), (3, 3, 32, 64)) == \
        ("conv", Spec(None, None, "data", "model"))
    assert planner.match_rule(("blocks", "A_log"), (4, 16))[0] == \
        "replicated"


def test_policies_through_param_pspecs():
    params = {"wq": _Shape(8, 8), "ln": _Shape(8)}
    fsdp = param_pspecs(params)
    tp = param_pspecs(params, policy="tp_only")
    dp = param_pspecs(params, policy="dp_only")
    assert fsdp["wq"] == Spec("data", "model")
    assert tp["wq"] == Spec(None, "model")
    assert dp["wq"] == Spec(("data", "model"), None)
    assert fsdp["ln"] == tp["ln"] == dp["ln"] == Spec(None)
    with pytest.raises(ValueError, match="policy"):
        param_pspecs(params, policy="nope")


class _Shape:
    def __init__(self, *shape):
        self.shape = shape


def test_sanitizer_demotes_and_logs_once(caplog):
    params = {"odd": _Shape(7, 4)}
    planner._WARNED.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.sharding"):
        plan = planner.plan_tree(params, axis_sizes={"data": 2, "model": 2})
    leaf = plan.leaves[0]
    assert (leaf.spec, leaf.demoted, leaf.raw_spec) == (
        Spec(None, "model"), (0,), Spec("data", "model"))
    msgs = [r for r in caplog.records if "demoted" in r.message]
    assert len(msgs) == 1 and "odd" in msgs[0].message
    assert plan.demotions() == [leaf]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.sharding"):
        planner.plan_tree(params, axis_sizes={"data": 2, "model": 2})
    assert not [r for r in caplog.records if "demoted" in r.message]


def test_absent_axes_are_demoted_silently(caplog):
    planner._WARNED.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.sharding"):
        plan = planner.plan_tree({"wq": _Shape(8, 8)},
                                 axis_sizes={"replica": 2})
    assert plan.leaves[0].spec == Spec(None, None)
    assert not caplog.records


def test_sanitize_pspecs_tree_surface(caplog):
    shapes = {"w": _Shape(6, 6), "v": _Shape(5, 6)}
    specs = {"w": Spec("data", "model"), "v": Spec("data", "model")}
    planner._WARNED.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.sharding"):
        out = sanitize_pspecs(specs, shapes, {"data": 2, "model": 2})
    assert out == {"w": Spec("data", "model"), "v": Spec(None, "model")}
    assert any("demoted" in r.message for r in caplog.records)


def test_pspecs_with_leading_composes_replica_axis():
    plan = planner.plan_tree({"wq": _Shape(8, 8), "ln": _Shape(8)})
    lead = plan.pspecs_with_leading("replica")
    assert lead == {"wq": Spec("replica", "data", "model"),
                    "ln": Spec("replica", None)}
    assert prepend_axis(plan.pspecs(), "pod")["wq"] == \
        Spec("pod", "data", "model")


def test_state_pspecs_planner_form_all_algorithms():
    sizes = {"replica": 2, "data": 2, "model": 2}
    params = {"wq": _Shape(8, 8)}
    cfg = ParleConfig(n_replicas=2, batches_per_epoch=5,
                      sync_compress="int8", sync_overlap=True)
    rep, flat = Spec("replica", "data", "model"), Spec("data", "model")
    for name in ("parle", "entropy_sgd"):
        sp = registry.get(name).state_pspecs("replica", cfg, params=params,
                                             axis_sizes=sizes)
        assert {f: sp[f]["wq"] for f in ("x", "y", "z", "v_y", "v_x",
                                         "e")} == dict.fromkeys(
            ("x", "y", "z", "v_y", "v_x", "e"), rep)
        assert sp["c"]["wq"] == flat and sp["step"] == Spec()
    se = registry.get("elastic_sgd").state_pspecs(
        "replica", params=params, axis_sizes=sizes)
    assert se["x"]["wq"] == se["v"]["wq"] == rep and se["ref"]["wq"] == flat
    ss = registry.get("sgd").state_pspecs("replica", params=params,
                                          axis_sizes=sizes)
    assert ss["params"]["wq"] == ss["v"]["wq"] == flat
    # the prefix form is unchanged without params
    assert registry.get("parle").state_pspecs("replica")["x"] == "replica"


def test_in_replica_axes_and_shard_context():
    sizes = {"replica": 2, "data": 2, "model": 2}
    assert planner.in_replica_axes(sizes, "replica") == ("data", "model")
    assert planner.in_replica_axes({"replica": 2, "data": 1, "model": 1},
                                   "replica") == ()
    ctx = planner.ShardContext({"data": 2, "model": 2})
    spec = ctx.leaf_spec(("blocks", "attn", "wq"), (4, 8, 8))
    assert spec == Spec(None, "data", "model")
    assert ctx.block(spec, (4, 8, 8), {"data": 1, "model": 0}) == (
        (slice(None), slice(4, 8), slice(0, 4)), (4, 4, 4))
    dp = planner._apply_policy(Spec("data", "model"), "dp_only")
    assert ctx.block(dp, (8, 8), {"data": 1, "model": 1}) == (
        (slice(6, 8), slice(None)), (2, 8))


def test_batch_pspecs_split_over_data_when_divisible():
    out = batch_pspecs({"tokens": _Shape(2, 4, 16), "odd": _Shape(2, 3, 16)},
                       {"replica": 2, "data": 2}, "replica")
    assert out == {"tokens": Spec("replica", "data", None),
                   "odd": Spec("replica", None, None)}


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_layout_round_trip(policy):
    """Every rank's ShardedLayout of a small tree (stacked, 2-D, 1-D and
    odd leaves) under {data: 2, model: 2}: blocks at multiples of ALIGN,
    the planner's slices, and the four ranks' flat buffers gathered back
    into the FlatLayout row of the whole tree, bit for bit."""
    import numpy as np
    import torch

    from repro_torch.utils.pytree import ALIGN, FlatLayout, ShardedLayout
    g = torch.Generator().manual_seed(0)
    tree = {"blocks": {"attn": {"wq": torch.randn(2, 8, 8, generator=g),
                                "wo": torch.randn(2, 8, 8, generator=g)},
                       "ln1": torch.randn(2, 8, generator=g)},
            "embed": torch.randn(12, 8, generator=g),
            "odd": torch.randn(7, 4, generator=g)}
    ctx = planner.ShardContext({"data": 2, "model": 2}, policy)
    coords = [{"data": d, "model": m} for d in range(2) for m in range(2)]
    lays = [ShardedLayout(tree, ctx, coords, i) for i in range(4)]
    bufs = torch.stack([lay.flatten(tree) for lay in lays])
    full = FlatLayout(tree)
    for lay in lays:
        assert lay.numel % ALIGN == 0 and lay.numel == lays[0].numel
        assert all(o % ALIGN == 0 for o in lay.offsets)
        for i, (spec, shape) in enumerate(zip(lay.specs, full.shapes)):
            sl, block = ctx.block(spec, shape, coords[lay.index])
            assert lay.shapes[i] == block
            np.testing.assert_array_equal(
                lay.views(bufs[lay.index])[i].numpy(),
                dict(tree_leaves_with_paths(tree))[lay.paths[i]][sl]
                .numpy())
    row = lays[0].gather_into(bufs, torch.zeros(full.numel))
    assert torch.equal(row, full.flatten(tree))
    for lay in lays:
        out = torch.zeros(lay.numel)
        assert torch.equal(lay.blocks_of(row, lay.index, out),
                           bufs[lay.index])
    # gaps stay zero: only the blocks are live
    live = torch.zeros(lays[0].numel, dtype=torch.bool)
    for o, s in lays[0].segments:
        live[o:o + s] = True
    assert not bufs[:, ~live].any()
