"""Shared pieces of the port's optimizers.

Counterpart of ``apex_tpu/optimizers/_common.py``.  An optimizer here is
a transform with ``init(params)`` and ``update(grads, state, params)``
(``params`` and ``grads`` dicts of tensors keyed by parameter name),
returning ``(updates, new_state)`` with ``p_new = p + update``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["AmpFusedTransformation", "Transformation"]


@dataclasses.dataclass(frozen=True)
class Transformation:
    """A plain transform (optax's ``GradientTransformation``): ``update``
    takes fp32 master grads, already unscaled, and returns new state
    tensors, which :class:`apex_tpu_torch.amp.AmpOptimizer` gates on
    overflow (its unfused route)."""

    init: Callable
    update: Callable


@dataclasses.dataclass(frozen=True)
class AmpFusedTransformation:
    """A transform whose ``update`` also takes ``inv_scale`` and
    ``found_inf`` and then does the AMP unscale and the overflow gate
    itself, inside its own passes over the parameters.
    :class:`apex_tpu_torch.amp.AmpOptimizer` detects it and skips its own
    unscale pass and where-gates (ref capability: apex's monolithic
    fused optimizers, which own scaling and gating)."""

    init: Callable
    update: Callable
