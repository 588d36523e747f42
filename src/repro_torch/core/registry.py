"""Algorithm registry: one name -> one Algorithm object.  Port of
``repro/core/registry.py``.

``parle`` and ``entropy_sgd`` register at ``repro_torch.core.algorithm``
import time; ``get``/``names`` trigger that import lazily so this module
stays import-cycle-free.  ``elastic_sgd`` and ``sgd`` are known names
(the CLI offers them, as the reference's does) whose port is still to
come: ``get`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

from typing import Dict

_ALGORITHMS: Dict[str, object] = {}

NOT_PORTED = {
    name: (f"--algo {name} is not ported yet (ROADMAP.md queue 1, item 5: "
           "the remaining algorithms, with the Elastic-SGD kernel K7)")
    for name in ("elastic_sgd", "sgd")
}


def register(algo):
    """Register an Algorithm instance under ``algo.name``.  Returns the
    instance."""
    _ALGORITHMS[algo.name] = algo
    return algo


def _ensure_builtins():
    from repro_torch.core import algorithm  # noqa: F401  (registers on import)


def get(name: str):
    _ensure_builtins()
    if name in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[name])
    if name not in _ALGORITHMS:
        raise KeyError(f"unknown algorithm {name!r}; known: {names()}")
    return _ALGORITHMS[name]


def names() -> list[str]:
    _ensure_builtins()
    return sorted(set(_ALGORITHMS) | set(NOT_PORTED))
