"""Fused softmax cross-entropy — the contrib loss-module spelling.

Counterpart of ``apex_tpu/contrib/xentropy/__init__.py`` (ref
apex/contrib/xentropy/softmax_xentropy.py:4-30).  The kernels are
:mod:`apex_tpu_torch.ops.softmax_xentropy`'s (the fused forward and
backward on the card, their plain versions on the CPU); this module adds
``padding_idx``: the losses of rows whose label is ``padding_idx`` are 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.softmax_xentropy import (
    softmax_cross_entropy,
    softmax_cross_entropy_ref,
)

__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy",
           "softmax_cross_entropy_ref"]


def _losses(logits: torch.Tensor, labels: torch.Tensor, smoothing: float,
            padding_idx: Optional[int]) -> torch.Tensor:
    losses = softmax_cross_entropy(logits, labels, label_smoothing=smoothing)
    if padding_idx is not None:
        losses = torch.where(labels == padding_idx, 0.0, losses)
    return losses


class SoftmaxCrossEntropyLoss:
    """Per-row fp32 losses of ``(logits (..., V), labels (...))`` with
    label ``smoothing``.  ``half_to_float`` is accepted and does
    nothing: the loss is always computed in fp32 (the kernels upcast
    bf16 logits inside)."""

    def __init__(self, smoothing: float = 0.0, padding_idx: int = 0,
                 half_to_float: bool = False):
        self.smoothing = smoothing
        self.padding_idx = padding_idx

    def __call__(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        return _losses(logits, labels, self.smoothing, self.padding_idx)

    @staticmethod
    def apply(logits: torch.Tensor, labels: torch.Tensor,
              smoothing: float = 0.0, padding_idx: Optional[int] = None,
              half_to_float: bool = False) -> torch.Tensor:
        """ref ``SoftmaxCrossEntropyLoss.apply`` (no row zeroed unless
        ``padding_idx`` is given)."""
        return _losses(logits, labels, smoothing, padding_idx)
