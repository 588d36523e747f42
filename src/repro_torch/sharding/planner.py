"""The sharding planner: walk a param tree, assign every leaf a
:class:`~repro_torch.sharding.rules.Spec` from the per-family rule table
(:mod:`repro_torch.sharding.rules`), sanitize it against the mesh's axis
sizes, and compose it with the Parle replica axis.  Port of
``repro/sharding/planner.py``.

This is the subsystem behind ``--mesh replica:R,data:D,model:M``:

  * FSDP rides the ``data`` axis, tensor parallelism the ``model`` axis —
    both *inside* a replica, so their collectives (the gathers of a
    replica's weights, the reduce-scatter of its grads) never cross the
    replica boundary;
  * the ``replica`` / ``pod`` axis is prepended to optimizer-state specs
    (``("replica", *plan(leaf))``), so the Eq. (8d) sync moves shard-size
    bytes a rank, once every L steps.

The planner is transparent: every :class:`LeafPlan` records which rule
fired and which dims the divisibility sanitizer demoted, and each
demotion is logged exactly once per process on logger
``repro_torch.sharding`` (no silent replication).

It works on shapes: any tree whose leaves have a ``.shape`` — tensors,
or the ``meta`` tensors of :func:`meta_params`, which plan a full-size
architecture without allocating it.

Entry points:
  plan_tree(tree, axis_sizes=None, policy=...)  -> Plan (specs + provenance)
  ShardContext                                  -> a rank's slice of each
      leaf (the port's counterpart of the reference's nested shard_map
      over the in-replica axes: ``utils/pytree.py::ShardedLayout`` holds
      those slices in its flat buffers, and the kernels run on them)
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.sharding import rules
from repro_torch.sharding.rules import Spec
from repro_torch.utils.pytree import tree_from_paths, tree_leaves_with_paths

log = logging.getLogger("repro_torch.sharding")

# (path, dim, axis) triples already warned about — each planner demotion
# is surfaced exactly once per process
_WARNED: set = set()


def path_names(path) -> Tuple[str, ...]:
    """A key path of :func:`~repro_torch.utils.pytree.tree_leaves_with_paths`
    -> its name tuple (the ONE place path entries are stringified)."""
    return tuple(str(p) for p in path)


def match_rule(names: Sequence[str], shape: Tuple[int, ...]):
    """Walk the rule table; returns (rule_name, spec).  Leaves under a
    layer-stack path ("blocks" / "layers") match on their per-layer shape
    and get a leading None for the stacked axis."""
    if any(n in rules.STACK_PATH_NAMES for n in names) and len(shape) >= 1:
        name, spec = match_rule_flat(names, shape[1:])
        return name, Spec(None, *spec)
    return match_rule_flat(names, shape)


def match_rule_flat(names, shape):
    for rule_name, fn in rules.RULE_TABLE:
        spec = fn(tuple(names), tuple(shape))
        if spec is not None:
            return rule_name, spec
    raise AssertionError("fallback rule must match")     # pragma: no cover


def _apply_policy(spec: Spec, policy: str) -> Spec:
    """Policy transforms over the fsdp_tp base assignment (see
    ``partition.param_pspecs`` for the trade-offs)."""
    if policy == "fsdp_tp":
        return spec
    if policy == "tp_only":
        return Spec(*[None if ax == rules.DATA else ax for ax in spec])
    if policy == "dp_only":
        out, used = [], False
        for ax in spec:
            if ax == rules.DATA and not used:
                out.append((rules.DATA, rules.MODEL))
                used = True
            elif ax in (rules.MODEL, rules.DATA):
                out.append(None)
            else:
                out.append(ax)
        return Spec(*out)
    raise ValueError(f"unknown sharding policy {policy!r}")


def _sanitize(spec: Spec, shape, axis_sizes: dict, path_names=(),
              warn: bool = True):
    """Demote mesh axes that do not evenly divide the dim (a rank's block
    must be a whole slice).  Returns (spec, demoted_dims)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out, demoted = [], []
    for i, (dim_size, axis) in enumerate(zip(shape, dims)):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        if any(nm not in axis_sizes for nm in names):
            # axis absent from this mesh (e.g. a replica-only mesh): not a
            # planner gap, just a smaller mesh — demote silently
            out.append(None)
            demoted.append(i)
            continue
        total = 1
        for nm in names:
            total *= axis_sizes[nm]
        if dim_size % total == 0 and dim_size >= total:
            out.append(axis)
        else:
            out.append(None)
            demoted.append(i)
            if warn:
                key = (tuple(path_names), i, axis)
                if key not in _WARNED:
                    _WARNED.add(key)
                    log.warning(
                        "sharding planner: %s dim %d (size %d) not "
                        "divisible by mesh axis %r (size %d) — demoted "
                        "to replicated",
                        "/".join(path_names) or "<leaf>", i, dim_size,
                        axis, total)
    return Spec(*out), tuple(demoted)


@dataclass(frozen=True)
class LeafPlan:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    rule: str                 # which rules.RULE_TABLE entry fired
    spec: Spec                # final (policy-applied, sanitized) spec
    raw_spec: Spec            # rule output before the policy and sanitizing
    demoted: Tuple[int, ...]  # dim indices the sanitizer replicated


@dataclass(frozen=True)
class Plan:
    leaves: Tuple[LeafPlan, ...]
    axis_sizes: Optional[dict]      # None = no mesh given (no sanitize)

    def pspecs(self) -> dict:
        """Per-leaf Spec tree (same structure as the input)."""
        return tree_from_paths((l.path, l.spec) for l in self.leaves)

    def pspecs_with_leading(self, *axes) -> dict:
        """Per-leaf specs with leading axes prepended (the Parle replica
        axis composition: ``("replica", *plan(leaf))``)."""
        return tree_from_paths((l.path, Spec(*axes, *l.spec))
                               for l in self.leaves)

    def by_rule(self) -> dict:
        out: dict = {}
        for l in self.leaves:
            out.setdefault(l.rule, []).append("/".join(l.path))
        return out

    def demotions(self) -> list:
        return [l for l in self.leaves if l.demoted]


def plan_tree(tree, axis_sizes: Optional[dict] = None,
              policy: str = "fsdp_tp", warn: bool = True) -> Plan:
    """Plan a parameter tree (nested dicts of anything with a
    ``.shape``), leaves in sorted key order.

    With ``axis_sizes`` ({axis: size} of the mesh), specs are sanitized
    against them and every demotion is logged once; without, the raw
    policy-applied rule specs are returned."""
    leaves = []
    for path, leaf in tree_leaves_with_paths(tree):
        names = path_names(path)
        shape = tuple(leaf.shape)
        rule_name, raw = match_rule(names, shape)
        spec = _apply_policy(raw, policy)
        demoted: Tuple[int, ...] = ()
        if axis_sizes is not None:
            spec, demoted = _sanitize(spec, shape, axis_sizes, names, warn)
        leaves.append(LeafPlan(path=names, shape=shape, rule=rule_name,
                               spec=spec, raw_spec=raw, demoted=demoted))
    return Plan(leaves=tuple(leaves), axis_sizes=axis_sizes)


def in_replica_axes(axis_sizes: dict,
                    replica_axis: Optional[str]) -> Tuple[str, ...]:
    """Mesh axes that do real work INSIDE a replica: everything except
    the replica axis, with size > 1 (in the mesh's axis order)."""
    return tuple(a for a, s in axis_sizes.items()
                 if a != replica_axis and s > 1)


@dataclass(frozen=True)
class ShardContext:
    """Where a rank's shard of each leaf lies: the in-replica axis sizes
    ({"data": D, "model": M}) and the planner policy.  For a leaf and a
    rank's in-replica coordinate ({"data": d, "model": m}) it gives the
    slices of the leaf's per-replica dims that the rank holds — the
    port's counterpart of the reference's nested shard_map over the
    in-replica axes."""

    axis_sizes: dict
    policy: str = "fsdp_tp"

    def leaf_spec(self, path_names: Sequence[str],
                  shape: Tuple[int, ...]) -> Spec:
        """Spec of a leaf's per-replica dims (no replica axis)."""
        _, raw = match_rule(tuple(path_names), tuple(shape))
        spec = _apply_policy(raw, self.policy)
        spec, _ = _sanitize(spec, tuple(shape), self.axis_sizes,
                            path_names, warn=False)
        return spec

    def block(self, spec: Spec, shape: Tuple[int, ...],
              coord: dict) -> Tuple[tuple, Tuple[int, ...]]:
        """(slices, block shape) of the block of a leaf of ``shape`` under
        ``spec`` that the rank at ``coord`` holds.  A dim split over a
        tuple of axes is split over their product, the first axis the
        major one."""
        slices, block = [], []
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for size, axis in zip(shape, dims):
            if axis is None:
                slices.append(slice(None))
                block.append(size)
                continue
            parts, idx = 1, 0
            for nm in (axis if isinstance(axis, tuple) else (axis,)):
                idx = idx * self.axis_sizes[nm] + coord.get(nm, 0)
                parts *= self.axis_sizes[nm]
            n = size // parts
            slices.append(slice(idx * n, (idx + 1) * n))
            block.append(n)
        return tuple(slices), tuple(block)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device: params of any
    size with shapes and dtypes and no storage."""

    @property
    def device(self):
        return torch.device("meta")


def meta_params(model, dtype=torch.float32) -> dict:
    """``model.init``'s param tree on the ``meta`` device (shapes only),
    for planning a full-size architecture without allocating it."""
    return model.init(_MetaGenerator(), dtype)
