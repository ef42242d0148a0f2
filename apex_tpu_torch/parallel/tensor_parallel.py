"""Tensor (model) parallelism: Megatron-style sharded dense layers.

Counterpart of ``apex_tpu/parallel/tensor_parallel.py``.  Weights are
sharded over a ``model`` :class:`~apex_tpu_torch.parallel.mesh.Axis`:

- column-parallel: ``W = [W_1 | W_2 | ...]`` split along the output;
  ``y_i = x W_i`` needs no collective, and the optional output gather is
  one ``all_gather``;
- row-parallel: ``W = [W_1 ; W_2 ; ...]`` split along the input, the
  input feature-sharded to match; ``y = psum_i(x_i W_i)`` is one
  all-reduce, the replicated bias added after it.

Gradients follow JAX's convention, not Megatron's f/g pair: the
row-parallel :func:`~apex_tpu_torch.parallel.mesh.psum` sums its
cotangent over the axis in the backward, as ``psum``'s transpose does
under ``shard_map``.  So a loss that is replicated over the axis is
divided by the axis size first (:func:`replicated_loss`); then the
sharded weights' gradients are exact with no collective, and the
gradients of replicated tensors that feed parallel regions (LayerNorm
parameters, the row-parallel biases) are per-rank partials that
:func:`sync_replicated_grads` sums.

The modules hold their local shard (``kernel`` (in, out / n) or (in / n,
out), flax's layout).  :func:`split_column` / :func:`split_row` slice a
full weight into this rank's shard, except the fused QKV of
:class:`TensorParallelSelfAttention`, whose local columns are laid out
(3, h_local, head_dim): the full weight of n ranks is partition-major,
(n, 3, h_local, head_dim) flattened, not (3, H, head_dim)
(:func:`apex_tpu_torch.weights.qkv_partition_major` converts).  An axis
of one member (``Axis.single``) runs the unsharded layer with no
collective.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.parallel.distributed import _tree_flatten
from apex_tpu_torch.parallel.mesh import Axis, all_gather, all_reduce, psum

__all__ = [
    "ColumnParallelDense",
    "RowParallelDense",
    "TensorParallelMLP",
    "TensorParallelSelfAttention",
    "column_parallel_dense",
    "replicated_loss",
    "row_parallel_dense",
    "split_column",
    "split_row",
    "sync_replicated_grads",
]


def _cast(dtype, *tensors):
    if dtype is None:
        return tensors
    return tuple(None if t is None else t.to(dtype) for t in tensors)


def column_parallel_dense(x: torch.Tensor, w_shard: torch.Tensor,
                          b_shard: Optional[torch.Tensor] = None, *,
                          axis: Axis, gather_output: bool = False
                          ) -> torch.Tensor:
    """x (..., IN) replicated, w_shard (IN, OUT / n): no collective;
    ``gather_output`` all-gathers the features back to OUT."""
    y = torch.matmul(x, w_shard)
    if b_shard is not None:
        y = y + b_shard
    if gather_output:
        y = all_gather(y, axis, dim=y.dim() - 1, tag="tp_gather")
    return y


def row_parallel_dense(x_shard: torch.Tensor, w_shard: torch.Tensor,
                       b: Optional[torch.Tensor] = None, *, axis: Axis,
                       _fault: bool = False) -> torch.Tensor:
    """x_shard (..., IN / n), w_shard (IN / n, OUT): one all-reduce, then
    the replicated bias.  ``_fault`` plants an error the checks must
    reject: a backward that passes the cotangent through without its sum
    over the axis (Megatron's g operator under JAX's loss convention)."""
    y = torch.matmul(x_shard, w_shard)
    y = _NoSumBackward.apply(y, axis) if _fault else psum(y, axis,
                                                             tag="tp_psum")
    if b is not None:
        y = y + b
    return y


class _NoSumBackward(torch.autograd.Function):
    """The planted fault of :func:`row_parallel_dense`."""

    @staticmethod
    def forward(ctx, y, axis):
        if axis.group is not None:
            y = y.clone()
            all_reduce(y, axis.group, tag="tp_psum")
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_loss(loss: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A loss replicated over ``axis``, divided by the axis size: the
    backward's psums sum the n copies' cotangents, so this makes every
    gradient exact (see the module docstring)."""
    return loss / axis.size


def sync_replicated_grads(tree: Any, axis: Axis, *,
                          tag: str = "tp_sync") -> Any:
    """The gradients of axis-replicated parameters summed over the axis,
    in place, the tree returned: one flat all-reduce a dtype (the
    reference's flat bucket; JAX's ``psum`` of each leaf, the same sums)."""
    if axis.group is None:
        return tree
    leaves, _ = _tree_flatten(tree)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        group = [t for t in leaves if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        all_reduce(flat, axis.group, tag=tag)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [f.view_as(t)
                                     for f, t in zip(parts, group)])
    return tree


def split_column(w: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's column shard (last dimension) of a full weight."""
    size = w.shape[-1] // axis.size
    return w[..., axis.index * size:(axis.index + 1) * size]


def split_row(w: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's row shard (dimension -2 of a matrix, 0 of a vector) of
    a full weight."""
    dim = max(w.dim() - 2, 0)
    size = w.shape[dim] // axis.size
    return w.narrow(dim, axis.index * size, size)


def _partitions(total: int, axis: Axis, what: str) -> int:
    if total % axis.size:
        raise ValueError(f"{what} ({total}) must be divisible by the "
                         f"'{axis.name}' axis size ({axis.size})")
    return total // axis.size


class ColumnParallelDense(nn.Module):
    """Dense with the output features sharded over ``axis``: ``kernel``
    (in, features / n), ``bias`` (features / n); ``features`` is the
    global width.  ``compute_dtype`` casts the operands as flax's
    ``dtype=``."""

    def __init__(self, in_features: int, features: int, axis: Axis, *,
                 use_bias: bool = True, gather_output: bool = False,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        local = _partitions(features, axis, "features")
        self.axis, self.gather_output = axis, gather_output
        self.compute_dtype = compute_dtype
        self.kernel = nn.Parameter(torch.empty(in_features, local))
        self.bias = nn.Parameter(torch.zeros(local)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x, self.kernel, self.bias)
        return column_parallel_dense(x, w, b, axis=self.axis,
                                     gather_output=self.gather_output)


class RowParallelDense(nn.Module):
    """Dense with the input features sharded over ``axis``: ``kernel``
    (in / n, features), a replicated ``bias`` (features)."""

    def __init__(self, in_features: int, features: int, axis: Axis, *,
                 use_bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        local = _partitions(in_features, axis, "in_features")
        self.axis, self.compute_dtype = axis, compute_dtype
        self.kernel = nn.Parameter(torch.empty(local, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self._fault = False

    def forward(self, x_shard: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self.compute_dtype, x_shard, self.kernel, self.bias)
        return row_parallel_dense(x, w, b, axis=self.axis,
                                  _fault=self._fault)


class TensorParallelMLP(nn.Module):
    """column -> activation -> row: one all-reduce forward, one
    backward.  ``wi`` and ``wo`` as in JAX; the activation is
    ``jax.nn.gelu``'s tanh form by default."""

    def __init__(self, d_model: int, d_ff: int, axis: Axis, *,
                 activation: Optional[Callable] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation = activation or (
            lambda t: F.gelu(t, approximate="tanh"))
        self.wi = ColumnParallelDense(d_model, d_ff, axis,
                                      compute_dtype=compute_dtype)
        self.wo = RowParallelDense(d_ff, d_model, axis,
                                   compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.activation(self.wi(x)))


class TensorParallelSelfAttention(nn.Module):
    """Self-attention with the heads sharded over ``axis``: the fused QKV
    is column-parallel (local columns (3, h_local, head_dim)), flash
    attention runs on the local heads, the output projection is
    row-parallel.  With ``dropout_rate`` > 0 and a seed, the mask is keyed
    on global heads (``dropout_heads=(H, r h_local)``), the unsharded
    mask bit for bit (a port addition; JAX's module has no dropout)."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int,
                 axis: Axis, *, causal: bool = False,
                 dropout_rate: float = 0.0,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.h_local = _partitions(num_heads, axis, "num_heads")
        self.num_heads, self.head_dim = num_heads, head_dim
        self.axis, self.causal = axis, causal
        self.dropout_rate = dropout_rate
        self.qkv = ColumnParallelDense(d_model, 3 * num_heads * head_dim,
                                       axis, compute_dtype=compute_dtype)
        self.proj = RowParallelDense(num_heads * head_dim, d_model, axis,
                                     compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, dropout_seed=None) -> torch.Tensor:
        b, s, _ = x.shape
        hl, hd = self.h_local, self.head_dim
        qkv = self.qkv(x).reshape(b, s, 3, hl, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rate = self.dropout_rate if dropout_seed is not None else 0.0
        out = flash_attention(
            q, k, v, causal=self.causal, dropout_rate=rate,
            dropout_seed=dropout_seed,
            dropout_heads=(self.num_heads, self.axis.index * hl))
        return self.proj(out.transpose(1, 2).reshape(b, s, hl * hd))
