"""Group BatchNorm — NHWC BatchNorm with statistics over groups of
``bn_group`` ranks and the fused add + ReLU.

Counterpart of ``apex_tpu/contrib/groupbn/__init__.py`` (ref
apex/contrib/groupbn/batch_norm.py:101-230, ``BatchNorm2d_NHWC`` over the
``bnp`` extension's NHWC kernels, whose ``bn_group`` statistics exchange
runs over CUDA IPC handles between ranks r ^ 1, r ^ 2, r ^ 4).  The
exchange pairs make exactly the aligned contiguous blocks of ``bn_group``
ranks, so here the module is a thin wrapper over the port's
:class:`~apex_tpu_torch.parallel.SyncBatchNorm` with those blocks as
process subgroups (:func:`~apex_tpu_torch.parallel.mesh.syncbn_groups`,
:func:`~apex_tpu_torch.parallel.mesh.new_groups`): one all-reduce of the
statistics a forward and one a backward, within the rank's block.
``bn_group=1`` makes no collective.  The reference's CUDA grid knobs
(``max_cta_per_sm``, ``cta_launch_margin``, ``multi_stream``) are
accepted and have no effect: SyncBatchNorm launches its own work.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from apex_tpu_torch.amp import warn_once
from apex_tpu_torch.parallel import mesh as mesh_lib
from apex_tpu_torch.parallel.sync_batchnorm import (
    EPS,
    MOMENTUM,
    RunningStats,
    SyncBatchNorm,
)

__all__ = ["BatchNorm2d_NHWC"]

# ref batch_norm.py:103's defaults: a knob left at its default needs no
# warning
_CUDA_KNOB_DEFAULTS = {"max_cta_per_sm": 2, "cta_launch_margin": 12,
                       "multi_stream": False}


class BatchNorm2d_NHWC(nn.Module):
    """NHWC BatchNorm with ``bn_group``-way statistics and fused add +
    ReLU (ref batch_norm.py:101-230).

    ``forward(x, z)`` computes ``relu(bn(x) + z)`` when the residual
    ``z`` is given, which needs ``fuse_relu=True``.  ``bn_group`` > 1
    splits the ``world_size`` ranks of the initialised process group
    into aligned blocks of that size and sums the statistics inside each
    (the subgroups are made here, on every rank, so every rank must
    build the module); ``world_size`` must then be given, as the JAX
    module needs it.  The parameters are ``bn.scale`` and ``bn.bias``
    (the JAX module's ``bn`` submodule)."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, eps: float = EPS,
                 momentum: float = MOMENTUM,
                 world_size: Optional[int] = None,
                 max_cta_per_sm: int = _CUDA_KNOB_DEFAULTS["max_cta_per_sm"],
                 cta_launch_margin: int = _CUDA_KNOB_DEFAULTS[
                     "cta_launch_margin"],
                 multi_stream: bool = _CUDA_KNOB_DEFAULTS["multi_stream"]):
        super().__init__()
        knobs = {"max_cta_per_sm": max_cta_per_sm,
                 "cta_launch_margin": cta_launch_margin,
                 "multi_stream": multi_stream}
        if knobs != _CUDA_KNOB_DEFAULTS:
            warn_once("groupbn.cuda_tuning",
                      "apex_tpu_torch groupbn: max_cta_per_sm / "
                      "cta_launch_margin / multi_stream are CUDA grid knobs "
                      "of the reference's kernels, accepted for constructor "
                      "parity only: they have no effect here.")
        groups = None
        if bn_group > 1:
            if world_size is None:
                raise ValueError("bn_group > 1 requires world_size")
            groups = mesh_lib.new_groups(
                mesh_lib.syncbn_groups(world_size, bn_group))
        self.fuse_relu = fuse_relu
        self.bn = SyncBatchNorm(num_features, groups=groups,
                                fuse_relu=fuse_relu, eps=eps,
                                momentum=momentum)

    def init_stats(self, device=None) -> RunningStats:
        """Zero running mean, unit running var on ``device`` (the card
        unless the caller names another)."""
        return self.bn.init_stats(device)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                stats: Optional[RunningStats] = None,
                use_running_average: bool = False):
        """``x`` (N, H, W, C), ``z`` the optional residual of x's shape;
        returns ``(y, new_stats)`` as :class:`SyncBatchNorm` does."""
        if z is not None and not self.fuse_relu:
            raise ValueError("residual add requires fuse_relu=True")
        return self.bn(x, stats, residual=z,
                       use_running_average=use_running_average)
