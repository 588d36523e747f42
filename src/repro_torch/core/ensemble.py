"""Replica-ensemble diagnostics from §1.2 of the paper.  Port of
``repro/core/ensemble.py``.

* ``replica_overlap`` / ``replica_spread`` (the trainer's diagnostics)
  take the replicas as the flat state, one ``(n, M)`` tensor (the zero
  gaps between leaves add nothing to a norm or a dot product).  Each
  works one replica row at a time and forms the pairwise products as an
  n x n Gram matrix, so at full width no ``(n, M)`` temporary is made;
  the cosines are the reference's up to the order of float roundings.
* ``one_shot_average`` — naive weight averaging of independent models
  (the paper shows this is catastrophic without the coupling), on a
  replica param tree.
* ``align_mlp`` / ``aligned_overlap`` — the greedy hidden-unit matching
  of the paper's Fig. 1 experiment, on MLP param trees
  (``models/convnet.py::init_mlp``); the matching runs in numpy on the
  host, as the reference's does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves_with_paths, tree_map


def replica_overlap(flat: torch.Tensor) -> torch.Tensor:
    """Mean pairwise cosine similarity across the replica axis."""
    n = flat.shape[0]
    if n == 1:
        return torch.tensor(1.0)
    gram = flat @ flat.T                                  # (n, n)
    norm = gram.diagonal().sqrt() + 1e-12
    sim = gram / (norm[:, None] * norm[None, :])
    return (sim.sum() - sim.trace()) / (n * (n - 1))


def replica_spread(flat: torch.Tensor) -> torch.Tensor:
    """RMS distance of replicas from their mean, normalized by the mean
    norm — goes to 0 as scoping collapses the ensemble."""
    n = flat.shape[0]
    mean = flat.sum(0) / n
    sq = torch.stack([(flat[a] - mean).square().sum() for a in range(n)])
    return sq.mean().sqrt() / (torch.linalg.vector_norm(mean) + 1e-12)


def one_shot_average(replica_tree):
    """The leafwise mean over the leading replica axis."""
    return tree_map(lambda l: l.mean(0), replica_tree)


# ------------------------------------------------------------------
# Permutation alignment for MLPs (Fig. 1 experiment)
# ------------------------------------------------------------------

def _greedy_match(cost: np.ndarray) -> np.ndarray:
    """Greedy assignment maximizing total similarity.  cost: (H, H)."""
    H = cost.shape[0]
    perm = np.zeros(H, dtype=np.int64)
    used_r, used_c = set(), set()
    for idx in np.argsort(-cost, axis=None):
        r, c = divmod(int(idx), H)
        if r in used_r or c in used_c:
            continue
        perm[r] = c
        used_r.add(r)
        used_c.add(c)
        if len(used_r) == H:
            break
    return perm


def _unit_columns(w: np.ndarray) -> np.ndarray:
    return w / (np.linalg.norm(w, axis=0, keepdims=True) + 1e-12)


def align_mlp(params_ref, params_other):
    """Permute the hidden units of ``params_other`` (the MLP layout of
    ``models/convnet.py::init_mlp``) to best match ``params_ref``: the
    columns of w1 (then of w2) by cosine similarity, with the matching
    rows of the next layer.  Returns the aligned copy, on
    ``params_other``'s device."""
    as_np = lambda t: t.detach().cpu().numpy()
    oth = {k: as_np(v) for k, v in params_other.items()}
    perm = _greedy_match(_unit_columns(as_np(params_ref["w1"])).T
                         @ _unit_columns(oth["w1"]))
    out = dict(oth)
    out["w1"] = oth["w1"][:, perm]
    out["b1"] = oth["b1"][perm]
    w2p = oth["w2"][perm]                           # permute rows of layer 2
    perm2 = _greedy_match(_unit_columns(as_np(params_ref["w2"])).T
                          @ _unit_columns(w2p))
    out["w2"] = w2p[:, perm2]
    out["b2"] = oth["b2"][perm2]
    out["w3"] = oth["w3"][perm2]
    device = params_other["w1"].device
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in out.items()}


def aligned_overlap(params_ref, params_other) -> float:
    """Permutation-invariant overlap between two MLPs (Fig. 1 metric)."""
    flat = lambda tree: torch.cat([l.reshape(-1) for _, l in
                                   tree_leaves_with_paths(tree)])
    ra = flat(params_ref)
    ob = flat(align_mlp(params_ref, params_other)).to(ra.device)
    return float(torch.dot(ra, ob) / (torch.linalg.vector_norm(ra)
                                      * torch.linalg.vector_norm(ob)
                                      + 1e-12))
