"""Dense and Conv — the flax-layout layers of the JAX package.

Counterpart of ``apex_tpu/amp/layers.py`` outside autocast (the ``amp``
policy tables are not ported yet):

- :class:`Dense`: fp32 ``kernel`` stored ``(in, out)`` as flax stores
  it, fp32 ``bias``, and a ``dtype`` that casts the input, kernel and
  bias before the product, as flax's ``dtype=`` does.  Without ``dtype``
  the operands promote to the wider type
  (``apex_tpu/amp/functional.py::dense``).  The product is a plain
  ``torch.matmul``: XLA computed it outside any Pallas kernel.
- :class:`Conv`: NHWC activations and an HWIO ``kernel``, flax's layout;
  ``strides``, ``padding`` (``"SAME"`` — flax's split, the extra row or
  column at the high edge —, ``"VALID"`` or explicit (lo, hi) pairs) and
  ``use_bias``, with the same ``dtype`` cast.  The convolution runs
  ``F.conv2d`` on a channels-last NCHW view (cuDNN on the card: the JAX
  package left convolutions to XLA, outside any Pallas kernel).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv", "Dense", "conv_nhwc", "same_padding"]

Padding = Union[str, Sequence[Tuple[int, int]]]


def _apply_dtype(dtype: Optional[torch.dtype], *tensors):
    """flax's ``dtype=``: every operand cast to it; None leaves them."""
    if dtype is None:
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
        dt = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(y.dtype)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial axis: the output keeps
    ceil(size / stride) positions, and an odd total puts the extra pad at
    the high edge (a stride-2 3x3 conv on an even input pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME"
              ) -> torch.Tensor:
    """``lax.conv_general_dilated`` with ("NHWC", "HWIO", "NHWC"): x (N, H,
    W, C), kernel (KH, KW, C, O) -> (N, H', W', O), operands promoted to
    one dtype.  Asymmetric padding is applied explicitly."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    x, kernel = x.to(dt), kernel.to(dt)
    kh, kw = kernel.shape[:2]
    if isinstance(padding, str):
        if padding == "SAME":
            pads = (same_padding(x.shape[1], kh, strides[0]),
                    same_padding(x.shape[2], kw, strides[1]))
        elif padding == "VALID":
            pads = ((0, 0), (0, 0))
        else:
            raise ValueError(f"padding must be 'SAME', 'VALID' or (lo, hi) "
                             f"pairs, got {padding!r}")
    else:
        pads = tuple((int(lo), int(hi)) for lo, hi in padding)
        if len(pads) != 2:
            raise ValueError(f"conv_nhwc takes two (lo, hi) pairs, got "
                             f"{padding!r}")
    xc = x.permute(0, 3, 1, 2)  # an NCHW view of NHWC memory: channels-last
    (ht, hb), (wl, wr) = pads
    if ht == hb and wl == wr:
        sym = (ht, wl)
    else:
        xc = F.pad(xc, (wl, wr, ht, hb))
        sym = (0, 0)
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1), stride=tuple(strides),
                 padding=sym)
    return y.permute(0, 2, 3, 1)


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
        y = conv_nhwc(x, kernel, self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
