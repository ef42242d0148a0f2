"""Dropout from an explicit generator, shared by the models and
:mod:`apex_tpu_torch.contrib.multihead_attn`.

Training with dropout draws from a ``torch.Generator`` on the model's
device that the caller passes in, never from the global RNG.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention_seed", "dropout", "require_generator"]


def require_generator(generator: Optional[torch.Generator]
                      ) -> torch.Generator:
    """``generator``, or a ``ValueError`` when there is none."""
    if generator is None:
        raise ValueError("training with dropout (deterministic=False) needs "
                         "a torch.Generator on the model's device")
    return generator


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate); the mask from ``generator``."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=require_generator(generator),
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def attention_seed(generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """The int32 seed in [0, 2^31 - 1) of the flash kernels' dropout hash,
    drawn from ``generator`` as a 0-d tensor on ``device`` (no host
    sync)."""
    return torch.randint(0, 2 ** 31 - 1, (), device=device, dtype=torch.int32,
                         generator=require_generator(generator))
