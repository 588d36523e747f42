"""Float32 means float32: the port's one switch for it.

PyTorch lets cuBLAS (``torch.backends.cuda.matmul.allow_tf32``, and the
``float32_matmul_precision`` setting) and cuDNN
(``torch.backends.cudnn.allow_tf32``, True by default) compute float32
products in TF32, which keeps ten bits of mantissa.  The reference
computes them in float32, so every entry point of the port calls
:func:`pin_float32` before it builds a model.
"""
from __future__ import annotations

import torch


def pin_float32() -> None:
    """Turn TF32 off for cuBLAS and cuDNN and ask for the highest float32
    matmul precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
