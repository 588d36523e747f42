"""Replica-ensemble diagnostics from §1.2 of the paper.  Port of
``repro/core/ensemble.py::replica_overlap`` / ``replica_spread`` (the
trainer's diagnostics).

They take the replicas as the flat Parle state, one ``(n, M)`` tensor
(the zero gaps between leaves add nothing to a norm or a dot product).
Each works one replica row at a time and forms the pairwise products as
an n x n Gram matrix, so at full width no ``(n, M)`` temporary is made;
the cosines are the reference's up to the order of float roundings.
"""
from __future__ import annotations

import torch


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
