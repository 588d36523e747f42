"""Weights carried across from the JAX reference.

The port keeps the reference's param tree: the same names, stacked
``blocks`` leaves of shape ``(L, ...)``, ``(d_in, d_out)`` projection
weights and ``bq``/``bk``/``bv`` biases.  So a reference param tree,
turned into numpy leaf by leaf (``jax.tree.map(np.asarray, params)``),
loads with no transposes.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts of numpy arrays -> the same nest of torch tensors on
    ``device`` (copies; the numpy arrays stay untouched)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
