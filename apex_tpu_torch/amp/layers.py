"""Dense — the flax-layout linear layer of the JAX package.

Counterpart of ``apex_tpu/amp/layers.py::Dense`` outside autocast (the
``amp`` policy tables are not ported yet): fp32 ``kernel`` stored
``(in, out)`` as flax stores it, fp32 ``bias``, and a ``dtype`` that
casts the input, kernel and bias before the product, as flax's
``dtype=`` does.  Without ``dtype`` the operands promote to the wider
type (``apex_tpu/amp/functional.py::dense``).  The product is a plain
``torch.matmul``: XLA computed it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Dense"]


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` of shape (in, out)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y + self.bias.to(y.dtype)
