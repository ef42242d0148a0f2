"""ResNet-50 (and 101, 152) in NHWC — the ImageNet training model.

Counterpart of ``apex_tpu/models/resnet.py``, with the same parameters
(names, flax layouts: HWIO conv kernels, (in, out) classifier kernel) and
dtype discipline:

- the images are cast to the compute dtype before the stem; the stem is
  the 7x7/2 convolution as space-to-depth(2) + a 4x4/1 convolution of the
  zero-padded 8x8 kernel (exact; the parameter keeps its (7, 7, 3, 64)
  shape), or the plain 7x7/2 convolution on an odd input or with
  ``space_to_depth_stem=False`` (the same parameter);
- every convolution casts its input and kernel to the compute dtype;
  every BatchNorm is :class:`~apex_tpu_torch.parallel.SyncBatchNorm`
  (fp32 statistics, output in its input's dtype), with ``bn_eps`` and
  ``bn_momentum`` (1e-5 and 0.1, the reference's);
- max pool 3x3/2 with padding 1; bottlenecks 1x1 -> 3x3 (stride on the
  3x3, flax ``"SAME"`` padding) -> 1x1, a 1x1 strided projection where the
  shape changes, ``relu(y + residual)``;
- the global mean over H and W accumulates in fp32 and rounds to the
  compute dtype (``jnp.mean`` of a bf16 tensor), then the fp32 classifier
  ``Dense(num_classes, dtype=float32)`` over its fp32 cast: under O2 its
  kernel arrives bf16-rounded and the product is fp32;
- O1: built with an fp32 compute dtype and run inside
  ``amp_.autocast()``, every convolution (the stem's too) and the
  classifier go through the cast tables of
  :mod:`apex_tpu_torch.amp.functional` as bf16 products, so the
  activations and the logits are bf16 and BatchNorm computes its
  statistics in fp32.

The batch statistics are state the caller threads (flax's
``batch_stats``): ``forward(x, batch_stats, train)`` returns the logits
and the updated statistics.  The convolutions run in cuDNN on the card (as
XLA ran them in the JAX package); the ``conv_bn`` kernels are not wired
in, as they are not in the JAX model.  ``sync_batchnorm=True`` makes
every BatchNorm sum its statistics over a process group (the JAX model's
``sync_batchnorm`` over ``bn_axis_name``; see
:mod:`apex_tpu_torch.parallel.sync_batchnorm`).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp import functional as amp_F
from apex_tpu_torch.amp.layers import Conv, Dense, _apply_dtype
from apex_tpu_torch.parallel.mesh import Subgroups, data_parallel_group
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

__all__ = ["Bottleneck", "ResNet", "SpaceToDepthStem", "init_resnet_params",
           "resnet50", "resnet101", "resnet152"]

BatchStats = Dict[str, torch.Tensor]


class SpaceToDepthStem(nn.Module):
    """The 7x7/2 stem convolution through space-to-depth (exact)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(7, 7, in_features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        x, kernel = _apply_dtype(self.dtype, x, self.kernel)
        if h % 2 or w % 2:  # odd size: the plain stem convolution
            return amp_F.conv_general_dilated(x, kernel, (2, 2),
                                              ((3, 3), (3, 3)))
        # 7x7 -> 8x8 (a zero tap at the high edge matches pad (3, 4)),
        # regrouped to (4, 4, 4c, features) in (di, dj, c) order
        k8 = F.pad(kernel, (0, 0, 0, 0, 0, 1, 0, 1))
        k4 = (k8.reshape(4, 2, 4, 2, c, self.features)
              .permute(0, 2, 1, 3, 4, 5)
              .reshape(4, 4, 4 * c, self.features))
        xp = F.pad(x, (0, 0, 3, 3, 3, 3))
        hp, wp = h + 6, w + 6
        xs = (xp.reshape(n, hp // 2, 2, wp // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5)
              .reshape(n, hp // 2, wp // 2, 4 * c))
        return amp_F.conv_general_dilated(xs, k4, (1, 1), "VALID")


def _bn(module: SyncBatchNorm, prefix: str, x: torch.Tensor,
        stats: BatchStats, new: BatchStats, train: bool) -> torch.Tensor:
    """One BatchNorm with its running statistics read from ``stats`` and,
    in training, their update written into ``new``."""
    ra = (stats[f"{prefix}.running_mean"], stats[f"{prefix}.running_var"])
    y, upd = module(x, ra, use_running_average=not train)
    new[f"{prefix}.running_mean"], new[f"{prefix}.running_var"] = upd
    return y


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with expansion 4."""

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32,
                 norm: Callable[[int], SyncBatchNorm] = SyncBatchNorm):
        super().__init__()
        out = features * 4
        self.conv1 = Conv(in_features, features, (1, 1), use_bias=False,
                          dtype=dtype)
        self.bn1 = norm(features)
        self.conv2 = Conv(features, features, (3, 3), strides,
                          use_bias=False, dtype=dtype)
        self.bn2 = norm(features)
        self.conv3 = Conv(features, out, (1, 1), use_bias=False, dtype=dtype)
        self.bn3 = norm(out)
        # the JAX block projects when the residual's shape differs
        self.project = in_features != out or tuple(strides) != (1, 1)
        if self.project:
            self.downsample_conv = Conv(in_features, out, (1, 1), strides,
                                        use_bias=False, dtype=dtype)
            self.downsample_bn = norm(out)

    def forward(self, x: torch.Tensor, prefix: str, stats: BatchStats,
                new: BatchStats, train: bool = True) -> torch.Tensor:
        y = torch.relu(_bn(self.bn1, f"{prefix}.bn1", self.conv1(x), stats,
                           new, train))
        y = torch.relu(_bn(self.bn2, f"{prefix}.bn2", self.conv2(y), stats,
                           new, train))
        y = _bn(self.bn3, f"{prefix}.bn3", self.conv3(y), stats, new, train)
        residual = x
        if self.project:
            residual = _bn(self.downsample_bn, f"{prefix}.downsample_bn",
                           self.downsample_conv(x), stats, new, train)
        return torch.relu(y + residual.to(y.dtype))


class ResNet(nn.Module):
    """ResNet-v1 with bottleneck blocks, NHWC, over RGB images.

    Args:
      stage_sizes: blocks per stage (RN50: (3, 4, 6, 3)).
      num_classes: classifier width.
      width: the stem's features (64); stage i has width * 2**i.
      space_to_depth_stem: the 7x7/2 stem through space-to-depth (exact;
        False: the plain convolution, with the same parameter).
      compute_dtype: the convolutions' dtype (bf16 for O2/O3).
      sync_batchnorm: BatchNorm statistics summed over ``bn_group`` (None:
        the world group of the initialised process group, which must
        exist), or over this rank's subgroup of ``bn_groups`` (the JAX
        model's ``bn_axis_index_groups``).
      bn_momentum, bn_eps: every BatchNorm's running-statistics momentum
        and epsilon.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 num_classes: int = 1000, width: int = 64,
                 space_to_depth_stem: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 sync_batchnorm: bool = False, bn_group=None,
                 bn_groups: Optional[Subgroups] = None,
                 bn_momentum: float = 0.1, bn_eps: float = 1e-5):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.compute_dtype = compute_dtype
        norm = functools.partial(SyncBatchNorm, momentum=bn_momentum,
                                 eps=bn_eps)
        if sync_batchnorm:
            if bn_group is None and bn_groups is None:
                bn_group = data_parallel_group()
            norm = functools.partial(norm, group=bn_group, groups=bn_groups)
        if space_to_depth_stem:
            self.conv1 = SpaceToDepthStem(3, width, dtype=compute_dtype)
        else:
            self.conv1 = Conv(3, width, (7, 7), (2, 2),
                              padding=[(3, 3), (3, 3)], use_bias=False,
                              dtype=compute_dtype)
        self.bn1 = norm(width)
        self.block_names = []
        c = width
        for i, n_blocks in enumerate(self.stage_sizes):
            for j in range(n_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, Bottleneck(c, width * 2 ** i, strides,
                                                 dtype=compute_dtype,
                                                 norm=norm))
                self.block_names.append(name)
                c = width * 2 ** i * 4
        self.fc = Dense(c, num_classes, dtype=torch.float32)

    def init_batch_stats(self, device=None) -> BatchStats:
        """Zero running means and unit running variances, flax's names
        joined by '.' (``stage1_block1.bn1.running_mean``, ...), on
        ``device``: the card unless the caller names another."""
        out = {}
        for name, mod in self.named_modules():
            if isinstance(mod, SyncBatchNorm):
                mean, var = mod.init_stats(device)
                out[f"{name}.running_mean"] = mean
                out[f"{name}.running_var"] = var
        return out

    def forward(self, x: torch.Tensor, batch_stats: BatchStats,
                train: bool = True) -> Tuple[torch.Tensor, BatchStats]:
        """x: (N, H, W, C) images -> (fp32 (N, num_classes) logits, the
        batch statistics after this step: updated in training, as given
        in eval)."""
        new: BatchStats = {}
        x = x.to(self.compute_dtype)
        x = torch.relu(_bn(self.bn1, "bn1", self.conv1(x), batch_stats, new,
                           train))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name in self.block_names:
            x = getattr(self, name)(x, name, batch_stats, new, train)
        x = x.float().mean(dim=(1, 2)).to(x.dtype)
        logits = self.fc(x.float())
        return logits, (new if train else batch_stats)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def resnet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def resnet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kw)


def init_resnet_params(model: ResNet, generator: torch.Generator
                       ) -> Tuple[Dict[str, torch.Tensor], BatchStats]:
    """Seeded fp32 ``(params, batch_stats)`` for ``model`` on the
    generator's device, at flax's defaults: lecun-normal kernels (a normal
    truncated to 2 standard deviations, scaled to variance 1 / fan_in,
    fan_in = KH * KW * in), zero classifier bias, unit BN scale, zero BN
    bias, zero running means, unit running variances.  ``model`` may live
    on the meta device."""
    dev = generator.device
    params = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = math.prod(p.shape[:-1])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            t = torch.empty(p.shape, device=dev)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
            params[name] = t * std
        elif leaf == "scale":
            params[name] = torch.ones(p.shape, device=dev)
        else:
            params[name] = torch.zeros(p.shape, device=dev)
    return params, model.init_batch_stats(dev)
