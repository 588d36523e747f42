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
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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
