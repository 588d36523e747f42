"""Param trees (nested dicts of tensors) and the flat state layout.

The reference keeps Parle's state as pytrees and calls its update
kernels once per leaf, padding each leaf to a multiple of 8192 elements
(``repro/kernels/parle_update.py::_leaf_call``).  The port keeps each
state field as ONE contiguous buffer whose last axis holds every leaf,
each starting at a multiple of :data:`ALIGN` elements, with zeros in the
gaps.  An elementwise update is then one launch over the whole state,
and the zeros stay zero under Parle's updates (every term of Eq. 8 is a
product or difference of zeros there).  Leaves are laid out in sorted
key order, the order ``jax.tree_util`` flattens a dict in.

Under axes inside a replica (``--mesh replica:R,data:D,model:M``) a rank
holds only its shard of each leaf: :class:`ShardedLayout` lays those
blocks out the same way (each at a multiple of :data:`ALIGN`, zeros in
the gaps), so the same kernels run on a rank's shard-local buffers, and
it assembles the D·M ranks' blocks into a :class:`FlatLayout` row for
the forward.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

ALIGN = 8192      # the reference kernels' per-leaf padding (BLOCK_ELEMS)


def tree_leaves_with_paths(tree, prefix=()) -> List[Tuple[tuple, object]]:
    """[(path, leaf)] of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves_with_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_from_paths(items) -> dict:
    """Inverse of :func:`tree_leaves_with_paths`."""
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class FlatLayout:
    """Where each leaf of a single-model param tree lives in a flat
    buffer of ``numel`` elements (a multiple of :data:`ALIGN`)."""

    segments = None     # a reduction moves the whole buffer

    def __init__(self, tree):
        self.paths, self.shapes, self.offsets, self.sizes = [], [], [], []
        off = 0
        for path, leaf in tree_leaves_with_paths(tree):
            shape = tuple(leaf.shape)
            size = 1
            for s in shape:
                size *= s
            self.paths.append(path)
            self.shapes.append(shape)
            self.offsets.append(off)
            self.sizes.append(size)
            off += -(-size // ALIGN) * ALIGN
        self.numel = off
        # torch.split sizes: each leaf's chunk, then its gap
        self._chunks = []
        for size in self.sizes:
            pad = -(-size // ALIGN) * ALIGN
            self._chunks += [size, pad - size]

    def flatten(self, tree, lead=(), dtype=torch.float32, device=None):
        """A new ``(*lead, numel)`` buffer holding ``tree``'s leaves (each
        of shape ``lead + leaf shape``), zeros in the gaps."""
        leaves = dict(tree_leaves_with_paths(tree))
        if device is None:
            device = leaves[self.paths[0]].device
        buf = torch.zeros(tuple(lead) + (self.numel,), dtype=dtype,
                          device=device)
        for path, leaf in zip(self.paths, self.views(buf)):
            leaf.copy_(leaves[path])
        return buf

    def views(self, buf) -> list:
        """Views of each leaf in ``buf`` (``(..., numel)``), leaf order."""
        lead = tuple(buf.shape[:-1])
        return [buf[..., o:o + s].view(lead + shape)
                for o, s, shape in zip(self.offsets, self.sizes, self.shapes)]

    def tree(self, buf) -> dict:
        """``buf`` as a nested dict of leaf views (shared storage)."""
        return tree_from_paths(zip(self.paths, self.views(buf)))

    def split(self, row) -> dict:
        """Param tree of one ``(numel,)`` row through ``torch.split`` —
        the form to differentiate through: its backward is ONE ``cat``
        into a row-shaped grad, where per-leaf slicing would write a
        zero-filled full row per leaf."""
        return self.split_leaves(row)[0]

    def split_leaves(self, row):
        """(:meth:`split`'s tree, its leaves in layout order): asking
        autograd for the grads of those leaves gives each leaf's grad
        with no row-shaped ``cat`` (the caller writes them into its own
        row, whose gaps stay zero)."""
        pieces = torch.split(row, self._chunks)
        leaves = [pieces[2 * i].view(shape)
                  for i, shape in enumerate(self.shapes)]
        return tree_from_paths(zip(self.paths, leaves)), leaves


def _padded(size: int) -> int:
    return -(-size // ALIGN) * ALIGN


class ShardedLayout:
    """Where a rank's block of each leaf of a single-model param tree
    lives in its flat buffer of ``numel`` elements: the blocks the
    sharding planner assigns it (``sharding/planner.py::ShardContext``),
    in the full tree's leaf order, each at a multiple of :data:`ALIGN`
    elements with zeros in the gaps (the kernels need a multiple of 8192
    and 16-byte aligned streams, so a block never straddles a leaf).

    ``ctx``: the ShardContext (in-replica axis sizes and policy);
    ``coords``: the in-replica coordinate ({axis: index}) of every rank of
    the in-replica group, in that group's rank order; ``index``: this
    rank's place in it.  Every rank's blocks of a leaf have one shape
    (the planner only splits a dim its axes divide), so every rank's
    buffer has the same ``numel``.

    Attributes as :class:`FlatLayout`'s (``paths``, ``shapes`` — the
    block shapes — ``offsets``, ``sizes``, ``numel``), plus ``full``, the
    FlatLayout of the whole tree (the forward splits a gathered row
    through ``full.split_leaves``), and ``segments``, the (offset, size)
    spans of the blocks (what a reduction over the replica axis moves)."""

    def __init__(self, tree, ctx, coords: Sequence[dict], index: int):
        self.full = FlatLayout(tree)
        self.ctx, self.coords, self.index = ctx, list(coords), index
        self.paths = self.full.paths
        self.specs = [ctx.leaf_spec(p, s)
                      for p, s in zip(self.paths, self.full.shapes)]
        # slices[c][i]: rank c's block of leaf i in the full leaf
        self.slices = []
        for coord in self.coords:
            self.slices.append([ctx.block(spec, shape, coord)[0]
                                for spec, shape in zip(self.specs,
                                                       self.full.shapes)])
        self.shapes = [ctx.block(spec, shape, self.coords[index])[1]
                       for spec, shape in zip(self.specs, self.full.shapes)]
        self.offsets, self.sizes = [], []
        off = 0
        for shape in self.shapes:
            size = 1
            for s in shape:
                size *= s
            self.offsets.append(off)
            self.sizes.append(size)
            off += _padded(size)
        self.numel = off
        self.segments = list(zip(self.offsets, self.sizes))
        # the first rank holding each distinct block of a leaf: a gather
        # reads a replicated block from one rank only
        self._sources = []
        for i in range(len(self.paths)):
            seen, src = set(), []
            for c, sl in enumerate(self.slices):
                key = tuple((s.start, s.stop) for s in sl[i])
                if key not in seen:
                    seen.add(key)
                    src.append(c)
            self._sources.append(src)

    def flatten(self, tree, lead=(), dtype=torch.float32, device=None):
        """A new ``(*lead, numel)`` buffer holding this rank's blocks of
        ``tree``'s FULL leaves (each of shape ``lead + leaf shape``),
        zeros in the gaps."""
        leaves = dict(tree_leaves_with_paths(tree))
        if device is None:
            device = leaves[self.paths[0]].device
        buf = torch.zeros(tuple(lead) + (self.numel,), dtype=dtype,
                          device=device)
        nl = len(lead)
        for path, sl, view in zip(self.paths, self.slices[self.index],
                                  self.views(buf)):
            view.copy_(leaves[path][(slice(None),) * nl + sl])
        return buf

    def views(self, buf) -> list:
        """Views of each leaf's block in ``buf`` (``(..., numel)``)."""
        lead = tuple(buf.shape[:-1])
        return [buf[..., o:o + s].view(lead + shape)
                for o, s, shape in zip(self.offsets, self.sizes, self.shapes)]

    def tree(self, buf) -> dict:
        """``buf`` as a nested dict of block views (shared storage)."""
        return tree_from_paths(zip(self.paths, self.views(buf)))

    def gather_into(self, blocks, full_row):
        """Assemble the in-replica ranks' blocks into ``full_row`` (a
        ``full.numel`` row in the FlatLayout, gaps left as they are).
        ``blocks``: ``(len(coords), numel)``, row c the buffer of rank c
        (on any device).  A block that several ranks hold is read from
        the first of them."""
        full = self.full.views(full_row)
        for i, (o, s, shape) in enumerate(zip(self.offsets, self.sizes,
                                              self.shapes)):
            self.gather_leaf_into(i, [blocks[c, o:o + s].view(shape)
                                      for c in range(len(blocks))], full[i])
        return full_row

    def gather_leaf_into(self, i: int, blocks, full):
        """Leaf i's blocks (``blocks[c]``: rank c's, of shape ``lead +
        block``) assembled into ``full`` (``lead + leaf shape``), each
        block that several ranks hold read from the first of them."""
        lead = (slice(None),) * (full.dim() - len(self.full.shapes[i]))
        for c in self._sources[i]:
            full[lead + self.slices[c][i]].copy_(blocks[c])
        return full

    def block_of(self, i: int, full):
        """This rank's block of leaf i in ``full`` (``lead + leaf
        shape``): a view."""
        lead = (slice(None),) * (full.dim() - len(self.full.shapes[i]))
        return full[lead + self.slices[self.index][i]]

    def blocks_of(self, full, c: int, out):
        """Rank c's blocks of ``full`` — a FlatLayout row, or the list of
        its whole leaves in layout order — into ``out`` (an ``(numel,)``
        buffer whose gaps stay untouched)."""
        if isinstance(full, torch.Tensor):
            full = self.full.views(full)
        for i, (o, s, shape) in enumerate(zip(self.offsets, self.sizes,
                                              self.shapes)):
            out[o:o + s].view(shape).copy_(full[i][self.slices[c][i]])
        return out

    def scatter_grads(self, full_grads, out):
        """This rank's blocks of a full grad row (or of its list of leaf
        grads) into its shard grad row ``out`` (no reduction: the caller
        reduces over "data")."""
        return self.blocks_of(full_grads, self.index, out)


class ColumnLayout:
    """What a rank of a replica split over its M "model" ranks computes
    with: its model column of each leaf the Megatron split cuts
    (``models/megatron.py``), every other leaf whole, in one
    :class:`FlatLayout` row (``flat``, the row the forward splits).  Its
    blocks (a :class:`ShardedLayout`, ``sharded``) reach that row over
    "data" only, except for the leaves whose module the split does not
    reach while the planner splits them over "model".

    ``split_dims[i]``: the dim of leaf i that the split cuts (None: read
    whole).  Each leaf takes one of three modes:

    * ``"col"``: split over "model" by the planner and by the compute on
      the same dim: the rank's column (the full leaf with that dim cut to
      1/M; of a packed leaf, the Mamba2 ``in_proj`` and ``conv_w``, the
      planner's contiguous block, whose outputs the compute gathers over
      "model" as activations); its grads are the rank's own;
    * ``"whole"``: held whole on every "model" rank (the planner does not
      split it); when the compute reads only the column's part of it
      (``summed``: the 1-D biases, a K/V projection M does not divide,
      the Mamba2 per-head scalars, conv bias and gated-norm weight),
      its grads are partial and are summed over "model";
    * ``"gather"``: split over "model" by the planner, read whole by a
      module the split does not reach: its columns are gathered over
      "model", and every "model" rank's grads of it are the same.

    ``mine``: this rank's index in ``sharded.coords``; ``data_index[j]``:
    the index there of the rank at "data" coordinate j and this rank's
    other coordinates; ``cslices[j][i]``: where that rank's block of leaf
    i lies in the rank's compute leaf i."""

    def __init__(self, sharded: ShardedLayout, split_dims, model_axis: str,
                 data_axis: str):
        self.sharded, self.paths = sharded, sharded.paths
        sizes = sharded.ctx.axis_sizes
        self.M = sizes.get(model_axis, 1)
        coord = sharded.coords[sharded.index]
        self.column = coord.get(model_axis, 0)
        D = sizes.get(data_axis, 1)
        self.data_index = [sharded.coords.index({**coord, data_axis: j})
                           for j in range(D)] if data_axis in coord \
            else [sharded.index]
        self.modes, self.summed, self.kdims, shapes = [], [], [], []
        for spec, shape, k in zip(sharded.specs, sharded.full.shapes,
                                  split_dims):
            dims = list(spec) + [None] * (len(shape) - len(spec))
            if any(isinstance(a, tuple) and model_axis in a for a in dims):
                raise ValueError(f"spec {spec}: the Megatron split reads "
                                 f"one axis a dim")
            held = dims.index(model_axis) if model_axis in dims else None
            k = None if k is None else k % len(shape)
            if k is None:
                mode = "whole" if held is None else "gather"
            elif held is None:
                mode = "whole"
            elif held == k:
                mode = "col"
            else:
                raise ValueError(f"spec {spec} splits dim {held} over "
                                 f"{model_axis!r}, the compute dim {k}")
            self.modes.append(mode)
            self.summed.append(mode == "whole" and k is not None)
            self.kdims.append(held)
            shape = list(shape)
            if mode == "col":
                shape[held] //= self.M
            shapes.append(tuple(shape))
        self.flat = FlatLayout(tree_from_paths(
            (p, torch.empty(s, device="meta"))
            for p, s in zip(self.paths, shapes)))
        self.cslices = []
        for c in self.data_index:
            row = []
            for i, sl in enumerate(sharded.slices[c]):
                if self.modes[i] == "col":
                    sl = tuple(slice(None) if d == self.kdims[i] else s
                               for d, s in enumerate(sl))
                row.append(sl)
            self.cslices.append(row)
        # the first data rank holding each distinct block of a leaf
        self._sources = []
        for i in range(len(self.paths)):
            seen, src = set(), []
            for j, row in enumerate(self.cslices):
                key = tuple((s.start, s.stop) for s in row[i])
                if key not in seen:
                    seen.add(key)
                    src.append(j)
            self._sources.append(src)
        self.gathered = [i for i, m in enumerate(self.modes)
                         if m == "gather"]
        self.sums = [i for i in range(len(self.paths)) if self.summed[i]]

    @property
    def data_numel(self) -> int:
        """The elements of the compute row's leaves (its gaps left out)."""
        return sum(self.flat.sizes)

    def assemble(self, blocks, row):
        """The data ranks' block rows (``blocks[j]``: the
        ``sharded.numel`` row of the rank at "data" coordinate j) into the
        compute ``row``: every leaf but the gathered ones' other columns."""
        views = self.flat.views(row)
        sh = self.sharded
        for i, (o, s, shape) in enumerate(zip(sh.offsets, sh.sizes,
                                              sh.shapes)):
            for j in self._sources[i]:
                views[i][self.cslices[j][i]].copy_(
                    blocks[j][o:o + s].view(shape))
        return row

    def column_of(self, i: int, whole, column: int):
        """Column ``column`` of gathered leaf i in its whole view."""
        k = self.kdims[i]
        n = whole.shape[k] // self.M
        return whole.narrow(k, column * n, n)

    def blocks_of(self, grads, j: int, out):
        """The block of the rank at "data" coordinate j of each compute
        leaf grad in ``grads`` (layout order) into ``out`` (a
        ``sharded.numel`` buffer whose gaps stay untouched)."""
        sh = self.sharded
        for i, (o, s, shape) in enumerate(zip(sh.offsets, sh.sizes,
                                              sh.shapes)):
            out[o:o + s].view(shape).copy_(grads[i][self.cslices[j][i]])
        return out
