"""Shared plumbing for the hand-written Hopper kernels.

Counterpart of ``apex_tpu/ops/_common.py``.  The JAX package picks a
Pallas kernel or its jnp reference through a shape gate and a global
override; here the rule is fixed by where the data lies:

- a tensor on the CUDA device goes to the kernel, and a shape or dtype
  the kernel does not take raises (there is no silent fallback to the
  plain version on the card);
- a tensor on the CPU goes to the plain PyTorch version, which is what
  the CPU tests compare against the JAX package.

Every kernel wrapper carries a plain integer ``launches`` that it bumps
once per kernel launch, so a run can show that its main path went
through the kernels (see :func:`apex_tpu_torch.ops.launch_counts`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "use_kernel"]


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` -> the CUDA device; raises when CUDA is absent.

    Entry points run on the card unless the caller names another device
    (the CPU tests pass ``device="cpu"``); they never fall back to the
    CPU on their own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def use_kernel(*tensors: Optional[torch.Tensor]) -> bool:
    """The dispatch rule: True when every given tensor lies on a CUDA
    device, False when every one lies on the CPU; anything else (mixed
    devices, another backend) raises."""
    devices = {t.device for t in tensors if t is not None}
    kinds = {d.type for d in devices}
    if kinds == {"cuda"} and len(devices) == 1:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on devices {sorted(map(str, devices))}: "
                     f"expected all on one CUDA device or all on the CPU")
