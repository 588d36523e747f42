"""The precision of the references' products.

``Products(tf32=False)`` computes every product in float32 with TF32 off
(the configurations' precision).  ``Products(tf32=True)`` is the control
of the correctness check, the nearest precision below the stated one:
every product's inputs carry TF32's 10-bit mantissa.  On a CUDA card that
is the card's own TF32 (``allow_tf32``, the switch a later change would
be tempted to flip); on the CPU, which has no TF32, the inputs are
rounded to it (round to nearest even) before a float32 product, which is
what a TF32 tensor core computes; there the backward's products stay
float32 (the rounding passes the gradient straight through).
"""
from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits."""
    i = x.contiguous().view(torch.int32)
    keep = (i >> 13) & 1
    i = (i + 0x0FFF + keep) & ~0x1FFF
    return i.view(torch.float32)


class Products:
    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        if self.tf32 and t.device.type == "cpu" and t.dtype == torch.float32:
            return t + (round_tf32(t.detach()) - t).detach()
        return t

    def mm(self, a, b):
        return self._in(a) @ self._in(b)

    def einsum(self, eq, *ops):
        return torch.einsum(eq, *(self._in(o) for o in ops))

    @contextlib.contextmanager
    def active(self):
        """Set the card's TF32 switches for the products inside, and put
        back what they were."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


F32 = Products(False)
