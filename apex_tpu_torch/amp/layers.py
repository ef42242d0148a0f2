"""Dense, Conv and ConvTranspose — the policy-aware flax-layout layers of
the JAX package.

Counterpart of ``apex_tpu/amp/layers.py``.  They compute through
:mod:`apex_tpu_torch.amp.functional` (``dense``, ``conv_general_dilated``
and ``conv_transpose``), so one model definition serves every opt
level: while an autocast policy is live (O1) the cast tables own the
operand dtypes and the layer's ``dtype`` is ignored (a bf16 product over
fp32 parameters); otherwise (O0, O2, O3) a set ``dtype`` casts the
operands as flax's ``dtype=`` does.

- :class:`Dense`: fp32 ``kernel`` stored ``(in, out)`` as flax stores
  it, fp32 ``bias``, and a ``dtype`` that casts the input, kernel and
  bias before the product.  Without ``dtype`` the operands promote to
  the wider type (``apex_tpu/amp/functional.py::dense``).  The product is
  a plain ``torch.matmul``: XLA computed it outside any Pallas kernel.
- :class:`Conv`: NHWC activations and an HWIO ``kernel``, flax's layout;
  ``strides``, ``padding`` (``"SAME"`` — flax's split, the extra row or
  column at the high edge —, ``"VALID"`` or explicit (lo, hi) pairs) and
  ``use_bias``, with the same ``dtype`` cast.  The convolution runs
  ``F.conv2d`` on a channels-last NCHW view (cuDNN on the card: the JAX
  package left convolutions to XLA, outside any Pallas kernel).
- :class:`ConvTranspose`: flax ``nn.ConvTranspose`` in NHWC/HWIO
  (``kernel`` of shape ``kernel_size + (in, features)``, not flipped:
  ``lax.conv_transpose``'s ``transpose_kernel=False``), ``"SAME"``,
  ``"VALID"`` or explicit padding of the dilated input, through
  ``F.conv_transpose2d`` (:func:`~apex_tpu_torch.amp.functional.
  conv_transpose_nhwc` says how the layouts and paddings map).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.amp import functional as amp_F
from apex_tpu_torch.amp.functional import (  # noqa: F401
    Padding,
    conv_nhwc,
    same_padding,
)

__all__ = ["Conv", "ConvTranspose", "Dense", "conv_nhwc", "same_padding"]


def _apply_dtype(dtype: Optional[torch.dtype], *tensors):
    """flax's ``dtype=``: every operand cast to it, outside autocast
    only; None leaves them, and so does a live autocast policy, whose
    cast tables then own the operand dtypes."""
    pol = amp_F.current_policy()
    if dtype is None or (pol is not None and pol.enabled and pol.autocast):
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with ``kernel`` of shape (in, out);
    ``use_bias=False`` leaves the bias out, as flax's ``use_bias``."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return amp_F.dense(*_apply_dtype(self.dtype, x, self.kernel,
                                         self.bias))


class Conv(nn.Module):
    """flax ``nn.Conv`` in NHWC/HWIO: ``kernel`` of shape ``kernel_size +
    (in, features)``, optional fp32 ``bias`` (grouped convolutions are
    not ported)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ks = tuple(kernel_size)
        self.strides = ((strides,) * len(ks) if isinstance(strides, int)
                        else tuple(strides))
        self.padding = padding
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*ks, in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kernel = _apply_dtype(self.dtype, x, self.kernel)
        y = amp_F.conv_general_dilated(x, kernel, self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` in NHWC/HWIO: ``kernel`` of shape
    ``kernel_size + (in, features)``, optional fp32 ``bias``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int],
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Padding = "SAME", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ks = tuple(kernel_size)
        self.strides = ((strides,) * len(ks) if isinstance(strides, int)
                        else tuple(strides))
        self.padding = padding
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(*ks, in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, kernel = _apply_dtype(self.dtype, x, self.kernel)
        y = amp_F.conv_transpose(x, kernel, self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
