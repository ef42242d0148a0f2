"""Carry weights and optimizer state from the JAX package to the port.

:func:`from_jax_params` maps a ``GPTLM`` params tree (nested dicts of
numpy arrays, or anything ``np.asarray`` takes) to a state dict of
:class:`apex_tpu_torch.models.GPTLM`, so both packages compute with the
same numbers.  Dense kernels keep their flax ``(in, out)`` layout, so
no transpose happens on the way.  :func:`from_jax_opt_state` maps an
``AmpOptState`` over such a tree (FusedAdam's step, m and v, and each
loss scaler's state) to the port's, so both packages can also continue
training from the same optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from apex_tpu_torch.amp import AmpOptState, LossScalerState
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.optimizers import FusedAdamState

__all__ = ["from_jax_opt_state", "from_jax_params"]

_DENSE = ("qkv", "proj", "ffn_in", "ffn_out")


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``GPTLM`` params -> the port's ``GPTLM`` state dict (fp32,
    CPU).  Raises on a tree with keys this mapping does not know (an
    untied head, for one), so nothing is silently dropped."""
    out = {
        "wte.weight": _t(tree["wte"]["embedding"]),
        "wpe.weight": _t(tree["wpe"]["embedding"]),
        "ln_f.weight": _t(tree["ln_f"]["scale"]),
        "ln_f.bias": _t(tree["ln_f"]["bias"]),
    }
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(layers):
        if name != f"layer_{i}":
            raise ValueError(f"layer keys not contiguous: {layers}")
        sub = tree[name]
        for ln in ("ln1", "ln2"):
            out[f"layers.{i}.{ln}.weight"] = _t(sub[ln]["scale"])
            out[f"layers.{i}.{ln}.bias"] = _t(sub[ln]["bias"])
        for dense in _DENSE:
            out[f"layers.{i}.{dense}.kernel"] = _t(sub[dense]["kernel"])
            out[f"layers.{i}.{dense}.bias"] = _t(sub[dense]["bias"])
        extra = set(sub) - {"ln1", "ln2", *_DENSE}
        if extra:
            raise ValueError(f"{name}: unmapped params {sorted(extra)}")
    extra = set(tree) - {"wte", "wpe", "ln_f", *layers}
    if extra:
        raise ValueError(f"unmapped params {sorted(extra)}")
    return out


def from_jax_opt_state(state: Any, device=None):
    """JAX ``AmpOptState(FusedAdamState(step, m, v), scalers, stash=None)``
    over a ``GPTLM`` params tree -> the port's
    :class:`apex_tpu_torch.amp.AmpOptState` on ``device`` (None: the CUDA
    device), m and v keyed like :func:`from_jax_params`."""
    dev = resolve_device(device)
    if state.stash is not None:
        raise ValueError("a stashed (accumulating) state is not ported")
    adam = state.opt_state

    def scalar(x, dtype):
        return torch.tensor(np.asarray(x).item(), dtype=dtype, device=dev)

    def moments(tree):
        return {k: v.to(dev) for k, v in from_jax_params(tree).items()}

    return AmpOptState(
        opt_state=FusedAdamState(step=scalar(adam.step, torch.int32),
                                 m=moments(adam.m), v=moments(adam.v)),
        scaler=tuple(LossScalerState(
            loss_scale=scalar(s.loss_scale, torch.float32),
            unskipped=scalar(s.unskipped, torch.int32),
            overflows=scalar(s.overflows, torch.int32))
            for s in state.scaler))
