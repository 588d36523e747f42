"""Scoping schedule, Eq. (9) of the paper.  Port of ``repro/core/scoping.py``.

    gamma_k = gamma0 * (1 - 1/(2B))^floor(k/L),  clipped at gamma_min
    rho_k   = rho0   * (1 - 1/(2B))^floor(k/L),  clipped at rho_min

The scopes are 0-dim float32 tensors on the host: the reference keeps
them as f32 scalars (an f32 times a Python float is an f32 product), and
the update rules derive from them in f32 (``1 / gamma`` too), so every
value here is the reference's bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Scopes(NamedTuple):
    gamma: torch.Tensor   # () f32, CPU
    rho: torch.Tensor     # () f32, CPU


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def init_scopes(cfg) -> Scopes:
    return Scopes(gamma=_f32(cfg.gamma0), rho=_f32(cfg.rho0))


def update_scopes(scopes: Scopes, cfg) -> Scopes:
    """One multiplicative decay step (called at every sync, i.e. when
    k/L increments)."""
    f = _f32(cfg.scoping_factor())
    return Scopes(
        gamma=torch.maximum(scopes.gamma * f, _f32(cfg.gamma_min)),
        rho=torch.maximum(scopes.rho * f, _f32(cfg.rho_min)),
    )


def scopes_at(cfg, num_syncs: int) -> Scopes:
    """Closed-form value after ``num_syncs`` decays (for tests/logging)."""
    f = cfg.scoping_factor() ** num_syncs
    return Scopes(
        gamma=torch.maximum(_f32(cfg.gamma0 * f), _f32(cfg.gamma_min)),
        rho=torch.maximum(_f32(cfg.rho0 * f), _f32(cfg.rho_min)),
    )
