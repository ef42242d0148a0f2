"""Shared pieces of the port's optimizers.

Counterpart of ``apex_tpu/optimizers/_common.py``.  An optimizer here is
a transform with ``init(params)`` and ``update(grads, state, params)``
(``params`` and ``grads`` dicts of tensors keyed by parameter name),
returning ``(updates, new_state)`` with ``p_new = p + update``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["AmpFusedTransformation", "Transformation", "gates_overflow"]


@dataclasses.dataclass(frozen=True)
class Transformation:
    """A plain transform (optax's ``GradientTransformation``): ``update``
    takes fp32 master grads, already unscaled, and returns new state
    tensors, which :class:`apex_tpu_torch.amp.AmpOptimizer` gates on
    overflow (its unfused route).  With ``gates_overflow``, ``update``
    also takes ``found_inf=`` and gates its state and updates itself (a
    wrapper around a transform that updates its state in place, as
    ``sparsify(fused_lamb(...))`` is)."""

    init: Callable
    update: Callable
    gates_overflow: bool = False


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


def gates_overflow(tx) -> bool:
    """True when ``tx.update`` takes ``found_inf=`` and gates its own
    state and updates on it: every :class:`AmpFusedTransformation`, and a
    :class:`Transformation` built with ``gates_overflow=True``.  The
    unfused routes hand such a transform ``found_inf`` instead of gating
    its new state after the update, which cannot undo an update made in
    place."""
    return isinstance(tx, AmpFusedTransformation) or getattr(
        tx, "gates_overflow", False)
