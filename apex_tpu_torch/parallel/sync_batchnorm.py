"""SyncBatchNorm (channels last), within one process or across processes.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py``:

=================================  ==========================================
JAX package                        port
=================================  ==========================================
``axis_name=None``                 ``group=None``: statistics of this
                                     process's batch
``axis_name="data"``               ``group=``: a process group, e.g.
                                     :func:`~.mesh.data_parallel_group`
``axis_index_groups=``             ``groups=``: the :class:`~.mesh.Subgroups`
                                     of :func:`~.mesh.new_groups`
one ``psum`` of (sum, sqsum,       one SUM all-reduce of the same
  count) in the forward              ``cat[sum, sqsum, count]``
one ``psum`` of (sum_dxhat,        one SUM all-reduce of the same, inside
  sum_dxhat_xhat) in the custom      the ``autograd.Function``'s backward
  VJP's backward
``batch_stats`` collection         ``(running_mean, running_var)`` passed
                                     in and returned
``convert_syncbn_model`` (flax     :func:`convert_syncbn_model`: the port's
  ``nn.BatchNorm`` rebuilt)          SyncBatchNorms set to sync; a
                                     ``torch.nn`` BatchNorm raises
=================================  ==========================================

Arithmetic (the JAX module's):

- statistics in fp32 over every axis but the last: mean = sum / count and
  the biased variance E[x^2] - mean^2 (not Welford; ``F.batch_norm``
  computes otherwise), which normalises: ``(x - mean) * rsqrt(var + eps)``
  then the fp32 affine, rounded to x's dtype (kept fp32 into the fused
  residual add).  Across processes the sums and the count are summed
  over the group first, so unequal local batches normalise with the
  global count;
- the backward saves only x, mean, rstd, count, scale and bias and
  recomputes xhat from x (the JAX custom VJP); the (mean, var) outputs
  carry no gradient.  ``dscale`` and ``dbias`` stay per-rank partials:
  they ride DDP's gradient averaging, as in the reference;
- running statistics: (1 - m) * running + m * batch with the unbiased
  variance (times count / (count - 1), the global count), the same on
  every rank; eval mode normalises with them and makes no collective;
- ``fuse_relu`` and the ``residual`` variant: relu(bn(x) + residual) with
  one rounding.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.parallel import mesh as mesh_lib

__all__ = ["SyncBatchNorm", "convert_syncbn_model"]

RunningStats = Tuple[torch.Tensor, torch.Tensor]
#: ``sync(tensor, tag) -> tensor``: the in-place SUM all-reduce over the
#: module's group
Sync = Callable[[torch.Tensor, str], torch.Tensor]

EPS = 1e-5       # the JAX module's defaults
MOMENTUM = 0.1


def _div(a: torch.Tensor, count: Union[float, torch.Tensor]) -> torch.Tensor:
    """``a / count``.  A count summed over the group is a (1,) tensor;
    it is divided by as PyTorch divides by the same count held as a
    Python float (the single-process path): on CUDA that kernel
    multiplies by the fp32 reciprocal, on the CPU it divides.  So at
    world 1 the synced path is the single-process one bit for bit."""
    if isinstance(count, float):
        return a / count
    if a.is_cuda:
        return a * torch.reciprocal(count)
    return a / count


def _bn_stats(x32: torch.Tensor, sync: Optional[Sync]):
    """(mean, biased var, count) over every axis but the last, fp32, and
    over the group with ``sync``: the count is a float, or a (1,) tensor
    when summed over the group."""
    c = x32.shape[-1]
    dims = tuple(range(x32.dim() - 1))
    s = x32.sum(dim=dims)
    ss = (x32 * x32).sum(dim=dims)
    count = float(x32.numel() // c)
    if sync is not None:
        stacked = sync(torch.cat([s, ss, s.new_full((1,), count)]),
                       "sync_bn_fwd")
        s, ss, count = stacked[:c], stacked[c:2 * c], stacked[2 * c:]
    mean = _div(s, count)
    var = _div(ss, count) - mean * mean
    return mean, var, count


class _BnTrain(torch.autograd.Function):
    """Training-mode BN with the JAX package's lean backward: residuals are
    (x, mean, rstd, scale, bias) and the count; gradients flow through y
    only.  With ``sync`` the count (a (1,) tensor) is a fourth output."""

    @staticmethod
    def forward(ctx, x, scale, bias, out_dtype, sync, eps):
        x32 = x.float()
        mean, var, count = _bn_stats(x32, sync)
        rstd = torch.rsqrt(var + eps)
        y = (x32 - mean) * rstd * scale.float() + bias.float()
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.count = count
        ctx.sync = sync
        if sync is None:
            ctx.mark_non_differentiable(mean, var)
            return y.to(out_dtype or x.dtype), mean, var
        ctx.mark_non_differentiable(mean, var, count)
        return y.to(out_dtype or x.dtype), mean, var, count

    @staticmethod
    def backward(ctx, dy, *_stat_grads):
        x, mean, rstd, scale, bias = ctx.saved_tensors
        c = x.shape[-1]
        dims = tuple(range(x.dim() - 1))
        dy32 = dy.float()
        xhat = (x.float() - mean) * rstd
        dbias = dy32.sum(dim=dims)
        dscale = (dy32 * xhat).sum(dim=dims)
        dxhat = dy32 * scale.float()
        sum_dxhat = dxhat.sum(dim=dims)
        sum_dxhat_xhat = (dxhat * xhat).sum(dim=dims)
        if ctx.sync is not None:
            # the reference's one all-reduce of cat[sum_dy, sum_dy_xmu]
            # (optimized_sync_batchnorm_kernel.py:101-106)
            stacked = ctx.sync(torch.cat([sum_dxhat, sum_dxhat_xhat]),
                               "sync_bn_bwd")
            sum_dxhat, sum_dxhat_xhat = stacked[:c], stacked[c:]
        m1 = _div(sum_dxhat, ctx.count)
        m2 = _div(sum_dxhat_xhat, ctx.count)
        dx = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None,
                None)


class SyncBatchNorm(nn.Module):
    """BatchNorm over every axis but the last, with flax's ``scale`` and
    ``bias`` parameters, ``eps`` (default :data:`EPS`) and ``momentum``
    (default :data:`MOMENTUM`: the JAX module's defaults).

    ``group`` (a process group) sums the statistics over its ranks;
    ``groups`` (:class:`~.mesh.Subgroups`) over this rank's subgroup
    instead.  With neither the statistics are this process's batch's."""

    def __init__(self, num_features: int, group=None,
                 groups: Optional[mesh_lib.Subgroups] = None,
                 fuse_relu: bool = False, eps: float = EPS,
                 momentum: float = MOMENTUM):
        super().__init__()
        self.num_features = num_features
        self.eps, self.momentum = eps, momentum
        self.group = group
        self.groups = groups
        self.fuse_relu = fuse_relu
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def _sync(self) -> Optional[Sync]:
        if self.groups is not None:
            groups = self.groups
            return lambda t, tag: mesh_lib.grouped_all_reduce(t, groups,
                                                              tag=tag)
        if self.group is not None:
            group = self.group
            return lambda t, tag: mesh_lib.all_reduce(t, group, tag=tag)
        return None

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
            y = (x.float() - ra_mean) * torch.rsqrt(ra_var + self.eps)
            y = y * self.scale.float() + self.bias.float()
            if residual is None:
                y = y.to(x.dtype)
        else:
            # the residual variant keeps the normalised output fp32 into
            # the add: one rounding at the end
            sync = self._sync()
            y, mean, var, *synced = _BnTrain.apply(
                x, self.scale, self.bias,
                torch.float32 if residual is not None else None, sync,
                self.eps)
            if stats is not None:
                count = synced[0] if synced else float(x.numel() // c)
                ra_mean, ra_var = stats
                one = torch.ones((), dtype=torch.float32, device=var.device)
                factor = (one * count) / torch.clamp_min(one * (count - 1.0),
                                                         1.0)
                unbiased = var * factor
                m = self.momentum
                new_stats = ((1 - m) * ra_mean + m * mean.detach(),
                             (1 - m) * ra_var + m * unbiased.detach())
        if residual is not None:
            y = y + residual.float()
        if self.fuse_relu or residual is not None:
            y = torch.relu(y)
        return y.to(x.dtype), new_stats


def convert_syncbn_model(module: nn.Module, group,
                         groups: Optional[mesh_lib.Subgroups] = None
                         ) -> nn.Module:
    """``module`` with every :class:`SyncBatchNorm` in it set to sync
    over ``group`` (or ``groups``), in place (ref
    apex/parallel/__init__.py:21-56).  A ``torch.nn`` BatchNorm raises
    ``TypeError`` naming its path, before anything is changed: it is
    NCHW with buffers and has none of this module's channels-last layout
    or threaded running statistics, so swapping it in silently would
    change the model."""
    for name, m in module.named_modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            raise TypeError(
                f"convert_syncbn_model: {name or '(root)'} is a torch.nn "
                f"{type(m).__name__}; build the model with "
                "apex_tpu_torch.parallel.SyncBatchNorm instead")
    for m in module.modules():
        if isinstance(m, SyncBatchNorm):
            m.group, m.groups = group, groups
    return module
