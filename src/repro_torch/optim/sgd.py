"""Learning-rate schedules of the form the paper uses ("dropped by a
factor of 5-10 at epochs [...]").  Port of ``repro/optim/sgd.py::
step_decay_schedule``; the SGD baseline itself is not ported yet
(ROADMAP.md queue 1, item 5)."""
from __future__ import annotations

from typing import Sequence

import torch


def step_decay_schedule(base_lr: float, boundaries: Sequence[int],
                        factor: float):
    """step -> ``base_lr * factor ** (boundaries passed)`` as a 0-dim
    float32 tensor, computed in float32 as the reference does."""
    b = torch.tensor(list(boundaries), dtype=torch.int32)
    base = torch.tensor(base_lr, dtype=torch.float32)
    fac = torch.tensor(factor, dtype=torch.float32)

    def lr_at(step):
        drops = (torch.as_tensor(step) >= b).sum()
        return base * fac ** drops.float()

    return lr_at
