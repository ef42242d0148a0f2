"""SyncBatchNorm over the batch of one process (channels last).

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` with
``axis_name=None``, the single-replica BatchNorm that the JAX ResNet uses
without ``sync_batchnorm``.  Same arithmetic:

- statistics in fp32 over every axis but the last: mean = sum / count and
  the biased variance E[x^2] - mean^2 (not Welford; ``F.batch_norm``
  computes otherwise), which normalises: ``(x - mean) * rsqrt(var + eps)``
  then the fp32 affine, rounded to x's dtype (kept fp32 into the fused
  residual add);
- the backward saves only x, mean, rstd, count, scale and bias and
  recomputes xhat from x (the JAX custom VJP); the (mean, var) outputs
  carry no gradient;
- running statistics: (1 - m) * running + m * batch with the unbiased
  variance (times count / (count - 1)); eval mode normalises with them;
- ``fuse_relu`` and the ``residual`` variant: relu(bn(x) + residual) with
  one rounding.

The running statistics are state the caller threads, not module buffers
(flax's ``batch_stats`` collection): :meth:`SyncBatchNorm.forward` takes
``(running_mean, running_var)`` and returns their update.  A cross-process
``axis_name`` (apex's process-group sync) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch.ops._common import resolve_device

__all__ = ["SyncBatchNorm"]

RunningStats = Tuple[torch.Tensor, torch.Tensor]

EPS = 1e-5       # the JAX module's defaults; no ported caller sets others
MOMENTUM = 0.1


def _bn_stats(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(mean, biased var, count) over every axis but the last, fp32."""
    c = x32.shape[-1]
    dims = tuple(range(x32.dim() - 1))
    s = x32.sum(dim=dims)
    ss = (x32 * x32).sum(dim=dims)
    count = float(x32.numel() // c)
    mean = s / count
    var = ss / count - mean * mean
    return mean, var, count


class _BnTrain(torch.autograd.Function):
    """Training-mode BN with the JAX package's lean backward: residuals are
    (x, mean, rstd, scale, bias) and the count; gradients flow through y
    only."""

    @staticmethod
    def forward(ctx, x, scale, bias, out_dtype):
        x32 = x.float()
        mean, var, count = _bn_stats(x32)
        rstd = torch.rsqrt(var + EPS)
        y = (x32 - mean) * rstd * scale.float() + bias.float()
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype or x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale, bias = ctx.saved_tensors
        dims = tuple(range(x.dim() - 1))
        dy32 = dy.float()
        xhat = (x.float() - mean) * rstd
        dbias = dy32.sum(dim=dims)
        dscale = (dy32 * xhat).sum(dim=dims)
        dxhat = dy32 * scale.float()
        m1 = dxhat.sum(dim=dims) / ctx.count
        m2 = (dxhat * xhat).sum(dim=dims) / ctx.count
        dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None


class SyncBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with flax's ``scale`` and
    ``bias`` parameters, eps :data:`EPS` and momentum :data:`MOMENTUM`
    (the JAX module's defaults, the only ones its ResNet uses)."""

    def __init__(self, num_features: int, axis_name: Optional[str] = None,
                 fuse_relu: bool = False):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "SyncBatchNorm across processes (axis_name) is not ported "
                "yet; axis_name=None is single-process BatchNorm")
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def init_stats(self, device=None) -> RunningStats:
        """Zero running mean, unit running var (flax's initialisers), on
        ``device``: the card unless the caller names another."""
        c = self.num_features
        device = resolve_device(device)
        return (torch.zeros(c, device=device), torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, stats: Optional[RunningStats] = None,
                residual: Optional[torch.Tensor] = None,
                use_running_average: bool = False
                ) -> Tuple[torch.Tensor, Optional[RunningStats]]:
        """``(y, new_stats)``: ``stats`` is (running_mean, running_var),
        fp32 (C,); ``new_stats`` is their update in training mode, else
        ``stats`` as given."""
        c = x.shape[-1]
        if c != self.num_features:
            raise ValueError(f"input channels {c} != num_features "
                             f"{self.num_features}")
        new_stats = stats
        if use_running_average:
            ra_mean, ra_var = stats
            y = (x.float() - ra_mean) * torch.rsqrt(ra_var + EPS)
            y = y * self.scale.float() + self.bias.float()
            if residual is None:
                y = y.to(x.dtype)
        else:
            # the residual variant keeps the normalised output fp32 into
            # the add: one rounding at the end
            y, mean, var = _BnTrain.apply(
                x, self.scale, self.bias,
                torch.float32 if residual is not None else None)
            if stats is not None:
                count = float(x.numel() // c)
                ra_mean, ra_var = stats
                one = torch.ones((), dtype=torch.float32, device=var.device)
                factor = (one * count) / torch.clamp_min(one * (count - 1.0),
                                                         1.0)
                unbiased = var * factor
                m = MOMENTUM
                new_stats = ((1 - m) * ra_mean + m * mean.detach(),
                             (1 - m) * ra_var + m * unbiased.detach())
        if residual is not None:
            y = y + residual.float()
        if self.fuse_relu or residual is not None:
            y = torch.relu(y)
        return y.to(x.dtype), new_stats
