"""MLP module — the whole-MLP chain with apex's constructor.

Counterpart of ``apex_tpu/mlp/mlp.py`` (ref apex/mlp/mlp.py:26-79, the
``MLP(mlp_sizes, bias=True, relu=True)`` module over one fused call,
registered as an amp half function).  The chain is
:func:`apex_tpu_torch.ops.mlp.mlp`; the module runs it under the cast
tables' ``"mlp"`` rule, so under O1 autocast x, the kernels and the
biases are cast to bf16 together.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from apex_tpu_torch.amp.functional import apply_cast_policy
from apex_tpu_torch.ops.mlp import mlp as mlp_op

__all__ = ["MLP"]


class MLP(nn.Module):
    """``mlp_sizes = [in, hidden..., out]``; the activation (``none``,
    ``relu`` or ``sigmoid``) after every layer, the last one included.
    Parameters ``kernel_i`` (in_i, out_i) and, with ``bias``, ``bias_i``
    (flax's names and layout), fp32, initialised as flax's
    variance-scaling(1, fan_in, uniform) and zeros."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu",
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        sizes = list(mlp_sizes)
        if len(sizes) < 2:
            raise ValueError("mlp_sizes needs at least [in, out]")
        self.mlp_sizes, self.use_bias = sizes, bias
        self.activation = activation
        self.num_layers = len(sizes) - 1
        for i, (din, dout) in enumerate(zip(sizes[:-1], sizes[1:])):
            limit = math.sqrt(3.0 / din)
            self.register_parameter(f"kernel_{i}", nn.Parameter(
                torch.empty(din, dout, dtype=param_dtype).uniform_(-limit,
                                                                   limit)))
            if bias:
                self.register_parameter(f"bias_{i}", nn.Parameter(
                    torch.zeros(dout, dtype=param_dtype)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = [getattr(self, f"kernel_{i}") for i in range(self.num_layers)]
        bs = ([getattr(self, f"bias_{i}") for i in range(self.num_layers)]
              if self.use_bias else None)
        return apply_cast_policy(
            "mlp", lambda x, w, b: mlp_op(x, w, b, self.activation),
            x, ws, bs)
