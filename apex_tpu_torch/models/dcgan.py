"""DCGAN generator and discriminator (NHWC) — the multi-loss-scaler model.

Counterpart of ``apex_tpu/models/dcgan.py`` (the stock DCGAN of ref
examples/dcgan/main_amp.py, whose purpose there is to exercise
``amp.initialize(..., num_losses=3)``), with the same modules, names and
dtype discipline:

- :class:`Generator`: z (N, 1, 1, nz) -> image (N, 64, 64, nc) in [-1, 1]:
  a 4x4 ``"VALID"`` :class:`~apex_tpu_torch.amp.layers.ConvTranspose` to
  4x4, three 4x4/2 ``"SAME"`` ones (8, 16, 32), each with BatchNorm and
  ReLU, and a last 4x4/2 one to 64x64, then ``tanh`` in fp32;
- :class:`Discriminator`: image -> (N,) fp32 logits: 4x4/2 convolutions
  padded (1, 1) with leaky ReLU 0.2 (BatchNorm after all but the first),
  then a 4x4 ``"VALID"`` convolution to one channel;
- no biases; the convolutions cast their operands to ``compute_dtype``
  (bf16 under O1, whose compute dtype it is, or O2), the BatchNorms
  compute and return fp32.

The BatchNorm is flax's ``nn.BatchNorm`` (:class:`BatchNorm`), not
:class:`~apex_tpu_torch.parallel.SyncBatchNorm`: statistics ``E[x]`` and
``max(E[x^2] - E[x]^2, 0)`` in fp32, eps 1e-5, and running statistics
``0.99 * running + 0.01 * batch`` with the biased variance; autograd
differentiates the forward as JAX does.  The batch statistics are state
the caller threads (flax's ``batch_stats``): ``forward(x, stats, train)``
returns the output and the updated statistics, under flax's names
(``BatchNorm_0.mean``, ``BatchNorm_0.var``, ...).  The convolutions run
in cuDNN on the card: the JAX package computed them in XLA, outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.amp.layers import Conv, ConvTranspose
from apex_tpu_torch.models.resnet import init_resnet_params
from apex_tpu_torch.ops._common import resolve_device

__all__ = ["BatchNorm", "Discriminator", "Generator", "init_dcgan_params"]

BatchStats = Dict[str, torch.Tensor]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(dtype=float32)`` over every axis but the last:
    fp32 ``scale`` (init 1) and ``bias`` (init 0), ``momentum`` 0.99 and
    ``eps`` 1e-5 (flax's defaults)."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.num_features, self.momentum, self.eps = (num_features, momentum,
                                                      eps)
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def init_stats(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero mean, unit var (flax's initialisers) on ``device``: the
        card unless the caller names another."""
        device = resolve_device(device)
        c = self.num_features
        return torch.zeros(c, device=device), torch.ones(c, device=device)

    def forward(self, x: torch.Tensor, stats: Tuple[torch.Tensor, torch.Tensor],
                train: bool = True):
        """``(y, new_stats)``: y fp32; ``new_stats`` the updated (mean,
        var) in training, ``stats`` as given in eval."""
        x32 = x.float()
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x32.mean(dims)
            var = torch.clamp_min((x32 * x32).mean(dims) - mean * mean, 0.0)
            m = self.momentum
            stats = (m * stats[0] + (1.0 - m) * mean.detach(),
                     m * stats[1] + (1.0 - m) * var.detach())
        else:
            mean, var = stats
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return (x32 - mean) * mul + self.bias.float(), stats


def _bn(module: BatchNorm, name: str, x: torch.Tensor, stats: BatchStats,
        new: BatchStats, train: bool) -> torch.Tensor:
    y, (new[f"{name}.mean"], new[f"{name}.var"]) = module(
        x, (stats[f"{name}.mean"], stats[f"{name}.var"]), train)
    return y


class _Net(nn.Module):
    def init_batch_stats(self, device=None) -> BatchStats:
        """Zero means and unit variances under flax's names, on
        ``device``: the card unless the caller names another."""
        out = {}
        for name, mod in self.named_children():
            if isinstance(mod, BatchNorm):
                out[f"{name}.mean"], out[f"{name}.var"] = mod.init_stats(
                    device)
        return out


class Generator(_Net):
    """z (N, 1, 1, nz) -> image (N, 64, 64, nc) in [-1, 1], fp32."""

    def __init__(self, nz: int = 100, ngf: int = 64, nc: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dt = compute_dtype
        chans = [ngf * 8, ngf * 4, ngf * 2, ngf]
        c_in = nz
        for i, ch in enumerate(chans):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(
                c_in, ch, (4, 4), (1, 1) if i == 0 else (2, 2),
                padding="VALID" if i == 0 else "SAME", use_bias=False,
                dtype=dt))
            self.add_module(f"BatchNorm_{i}", BatchNorm(ch))
            c_in = ch
        self.ConvTranspose_4 = ConvTranspose(c_in, nc, (4, 4), (2, 2),
                                             padding="SAME", use_bias=False,
                                             dtype=dt)

    def forward(self, z: torch.Tensor, batch_stats: BatchStats,
                train: bool = True) -> Tuple[torch.Tensor, BatchStats]:
        new: BatchStats = {}
        x = z.to(self.compute_dtype)
        for i in range(4):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = torch.relu(_bn(getattr(self, f"BatchNorm_{i}"),
                               f"BatchNorm_{i}", x, batch_stats, new, train))
        x = self.ConvTranspose_4(x)
        return torch.tanh(x.float()), (new if train else batch_stats)


class Discriminator(_Net):
    """image (N, 64, 64, nc) -> fp32 logits (N,) (for
    ``binary_cross_entropy_with_logits``)."""

    def __init__(self, ndf: int = 64, nc: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dt = compute_dtype
        pad = ((1, 1), (1, 1))
        c_in = nc
        for i, ch in enumerate((ndf, ndf * 2, ndf * 4, ndf * 8)):
            self.add_module(f"Conv_{i}", Conv(c_in, ch, (4, 4), (2, 2),
                                               padding=pad, use_bias=False,
                                               dtype=dt))
            if i > 0:
                self.add_module(f"BatchNorm_{i - 1}", BatchNorm(ch))
            c_in = ch
        self.Conv_4 = Conv(c_in, 1, (4, 4), (1, 1), padding="VALID",
                           use_bias=False, dtype=dt)

    def forward(self, x: torch.Tensor, batch_stats: BatchStats,
                train: bool = True) -> Tuple[torch.Tensor, BatchStats]:
        new: BatchStats = {}
        x = F.leaky_relu(self.Conv_0(x.to(self.compute_dtype)), 0.2)
        for i in range(1, 4):
            x = getattr(self, f"Conv_{i}")(x)
            x = F.leaky_relu(_bn(getattr(self, f"BatchNorm_{i - 1}"),
                                 f"BatchNorm_{i - 1}", x, batch_stats, new,
                                 train), 0.2)
        x = self.Conv_4(x)
        return (x.reshape(x.shape[0]).float(),
                new if train else batch_stats)


def init_dcgan_params(model: _Net, generator: torch.Generator
                      ) -> Tuple[Dict[str, torch.Tensor], BatchStats]:
    """Seeded fp32 ``(params, batch_stats)`` for a :class:`Generator` or
    :class:`Discriminator` on the generator's device, at flax's defaults
    (:func:`~apex_tpu_torch.models.resnet.init_resnet_params`'s:
    lecun-normal kernels, unit BN scales, zero BN biases, zero means,
    unit variances).  ``model`` may live on the meta device."""
    return init_resnet_params(model, generator)
