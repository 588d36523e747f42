"""PyTorch port of the ``repro`` package (Parle + its serving stack),
written for one NVIDIA H100.

The port mirrors ``src/repro/`` module by module and imports nothing
from it.  Entry points run on ``cuda`` unless the caller asks for the
CPU; hand-written CUDA kernels are built and loaded at their first CUDA
launch (``repro_torch/kernels/build.py``), so importing the package
needs neither ``nvcc`` nor a GPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device``
    names another.  A CUDA device that is not present raises — there is
    no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but no CUDA device is available; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        if dev.index is None:     # compare equal to the tensors' device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
