"""Weights and optimizer states carried across from the JAX reference.

The port keeps the reference's param tree: the same names, stacked
``blocks`` leaves of shape ``(L, ...)`` (``layers`` for the ssm family),
``(d_in, d_out)`` projection weights and ``bq``/``bk``/``bv`` biases
(and, for the paper's convnets, HWIO conv weights).  So a reference param tree, turned into numpy leaf
by leaf (``jax.tree.map(np.asarray, params)``), loads with no
transposes.  A reference optimizer state — ``ParleState``,
``ElasticState`` or ``SGDState`` — travels the same way (its fields as
numpy leaves, with the leading replica axis where the reference has
one); bf16 leaves are numpy arrays of a ``bfloat16`` dtype on the way in
(read through their bits) and uint16 bit patterns on the way out.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import to_numpy
from repro_torch.core.elastic_sgd import ElasticState
from repro_torch.core.parle import FIELDS, ParleState
from repro_torch.core.scoping import Scopes
from repro_torch.optim.sgd import SGDState
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


def _flat(tree, device, layout=None, lead=True):
    """(flat buffer, layout) of a numpy field tree; ``lead``: the leaves
    carry a leading replica axis (the layout is taken from row 0)."""
    leaves = params_from_numpy(tree, device)
    first = tree_leaves_with_paths(leaves)[0][1]
    if layout is None:
        layout = FlatLayout(tree_map(lambda l: l[0], leaves) if lead
                            else leaves)
    buf = layout.flatten(leaves, lead=(first.shape[0],) if lead else (),
                         dtype=first.dtype, device=device)
    return buf, layout


def _step(state) -> torch.Tensor:
    return torch.tensor(int(state.step), dtype=torch.int32)


def _scopes(state) -> Scopes:
    return Scopes(torch.tensor(np.float32(state.scopes.gamma)),
                  torch.tensor(np.float32(state.scopes.rho)))


def state_from_numpy(state, device):
    """A reference optimizer state as numpy (``jax.tree.map(np.asarray,
    state)``) as the port's flat state on ``device``, keyed off the
    fields present:

    * ``params`` — an ``SGDState`` (params, v, step);
    * ``ref`` — an ``ElasticState`` (x, v with the replica axis, ref,
      step, scopes);
    * otherwise a ``ParleState`` (x, y, z, v_y, v_x, step, scopes, and
      the optional ``e`` (n, ...) and ``c`` (...) of the compressed /
      overlapped sync)."""
    if getattr(state, "params", None) is not None:
        params, layout = _flat(state.params, device, lead=False)
        v, _ = _flat(state.v, device, layout, lead=False)
        return SGDState(params=params, v=v, step=_step(state), layout=layout)
    if getattr(state, "ref", None) is not None:
        ref, layout = _flat(state.ref, device, lead=False)
        x, _ = _flat(state.x, device, layout)
        v, _ = _flat(state.v, device, layout)
        return ElasticState(x=x, ref=ref, v=v, step=_step(state),
                            scopes=_scopes(state), layout=layout)
    fields, layout = {}, None
    for f in FIELDS:
        tree = getattr(state, f, None)
        if tree is not None:
            fields[f], layout = _flat(tree, device, layout, lead=f != "c")
    return ParleState(**fields, step=_step(state), scopes=_scopes(state),
                      layout=layout)


def state_to_numpy(state) -> dict:
    """The port's state as the reference state's tree: each buffer field
    as a nested dict of numpy leaves (bf16 as uint16 bits), ``step``
    int32 and ``scopes`` {gamma, rho} float32 where the state has them."""
    return tree_map(to_numpy, state.tree())
