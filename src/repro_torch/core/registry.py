"""Algorithm registry: one name -> one Algorithm object.  Port of
``repro/core/registry.py``.

``parle``, ``entropy_sgd``, ``elastic_sgd`` and ``sgd`` register at
``repro_torch.core.algorithm`` import time; ``get``/``names`` trigger
that import lazily so this module stays import-cycle-free.
"""
from __future__ import annotations

from typing import Dict

_ALGORITHMS: Dict[str, object] = {}


def register(algo):
    """Register an Algorithm instance under ``algo.name``.  Returns the
    instance."""
    _ALGORITHMS[algo.name] = algo
    return algo


def _ensure_builtins():
    from repro_torch.core import algorithm  # noqa: F401  (registers on import)


def get(name: str):
    _ensure_builtins()
    if name not in _ALGORITHMS:
        raise KeyError(f"unknown algorithm {name!r}; known: {names()}")
    return _ALGORITHMS[name]


def names() -> list[str]:
    _ensure_builtins()
    return sorted(_ALGORITHMS)
