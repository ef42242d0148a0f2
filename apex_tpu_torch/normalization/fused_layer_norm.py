"""FusedLayerNorm — an ``nn.Module`` over the LayerNorm kernels.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py`` as the
model uses it: differentiable LayerNorm over the last axis with
``weight`` and ``bias`` (the flax module's ``scale`` and ``bias``),
created in fp32.  The parameters follow the dtype an AMP cast gives
them: under O2 they are bf16 (the JAX policy's BatchNorm heuristic keeps
no LayerNorm in fp32), the kernels upcast them, and their gradients come
back in bf16.
"""
from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops.layer_norm import layer_norm

__all__ = ["FusedLayerNorm"]


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis of width ``normalized_shape``, with
    ``weight`` (init 1) and ``bias`` (init 0), fp32 until cast."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(self.normalized_shape))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.normalized_shape:
            raise ValueError(f"input width {x.shape[-1]} != normalized_shape "
                             f"{self.normalized_shape}")
        return layer_norm(x, self.weight, self.bias, self.eps)
