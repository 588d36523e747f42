"""Weights and optimizer states carried across from the JAX reference.

The port keeps the reference's param tree: the same names, stacked
``blocks`` leaves of shape ``(L, ...)``, ``(d_in, d_out)`` projection
weights and ``bq``/``bk``/``bv`` biases.  So a reference param tree,
turned into numpy leaf by leaf (``jax.tree.map(np.asarray, params)``),
loads with no transposes.  A reference ``ParleState`` travels the same
way (its fields as numpy leaves with the leading replica axis); bf16
leaves are numpy arrays of a ``bfloat16`` dtype on the way in (read
through their bits) and uint16 bit patterns on the way out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import to_numpy
from repro_torch.core.parle import FIELDS, ParleState
from repro_torch.core.scoping import Scopes
from repro_torch.utils.pytree import (FlatLayout, tree_leaves_with_paths,
                                      tree_map)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(tree, device):
    """Nested dicts of numpy arrays -> the same nest of torch tensors on
    ``device`` (copies; the numpy arrays stay untouched)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree).to(device)


def state_from_numpy(state, device) -> ParleState:
    """A reference ParleState as numpy (``jax.tree.map(np.asarray,
    state)``: fields x, y, z, v_y, v_x as nested dicts of ``(n, ...)``
    leaves, ``step``, ``scopes``, and the optional ``e`` (n, ...) and
    ``c`` (...) of the compressed / overlapped sync) as the port's flat
    state on ``device``."""
    fields = {}
    for f in FIELDS:
        tree = getattr(state, f, None)
        if tree is None:
            continue
        leaves = params_from_numpy(tree, device)
        first = tree_leaves_with_paths(leaves)[0][1]
        if f == "x":
            layout = FlatLayout(tree_map(lambda l: l[0], leaves))
        lead = () if f == "c" else (first.shape[0],)
        fields[f] = layout.flatten(leaves, lead=lead, dtype=first.dtype,
                                   device=device)
    return ParleState(
        **fields,
        step=torch.tensor(int(state.step), dtype=torch.int32),
        scopes=Scopes(torch.tensor(np.float32(state.scopes.gamma)),
                      torch.tensor(np.float32(state.scopes.rho))),
        layout=layout)


def state_to_numpy(state: ParleState) -> dict:
    """The port's state as the reference ParleState's tree: fields x, y,
    z, v_y, v_x (and e, c when present) as nested dicts of numpy leaves
    (bf16 as uint16 bits), ``step`` int32 and ``scopes`` {gamma, rho}
    float32."""
    return tree_map(to_numpy, state.tree())
