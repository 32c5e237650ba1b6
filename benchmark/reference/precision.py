"""The arithmetic the reference's products run in.

The only contractions of the reference are the lattice moments (sums over
the 19 populations) and the projections ``c . u`` and ``c . F``; they go
through ``Arith.tensordot``.
With ``tf32`` on, each operand is rounded to TF32's 10-bit mantissa and the
product accumulates in float32: what the tensor cores do in TF32.  The
rounding is explicit, because cuBLAS takes the tensor cores for none of
these products, whose inner dimension is 3 or 19, even with PyTorch's
``allow_tf32`` set (the card showed no difference), and because the CPU
has no TF32.  Everything else is elementwise in the reference's dtype.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (ties to even):
    the low 13 of float32's 23 mantissa bits cleared."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & -0x2000
    return i.view(torch.float32)


class Arith:
    """The dtype of the reference and whether its products run in TF32."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products take float32 operands")
        self.dtype = dtype
        self.tf32 = tf32

    def _operands(self, *xs):
        return tuple(round_tf32(x) for x in xs) if self.tf32 else xs

    def tensordot(self, a, b, dims):
        return torch.tensordot(*self._operands(a, b), dims=dims)
