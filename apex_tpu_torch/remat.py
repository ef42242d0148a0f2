"""Rematerialization policies: the activation-memory knob.

Counterpart of ``apex_tpu/remat.py``.  One named policy per model
(``GPTConfig.remat_policy``, ``BertConfig.remat_policy``) says what each
block keeps for its backward:

- ``none``: every activation (the fastest backward, the most memory);
- ``dots_saveable``: the matmul outputs (``aten.mm``, ``addmm``, ``bmm``)
  and nothing else: LayerNorm, GELU, dropout, the residual adds and the
  hand-written kernels (flash attention, the LayerNorm kernels) run again
  in the backward, as ``jax.checkpoint_policies.dots_saveable`` recomputes
  the Pallas calls;
- ``full_block``: nothing inside the block; its whole forward runs again
  in the backward (the most memory saved, about 1.3x the step's compute).

Both recomputing policies are ``torch.utils.checkpoint.checkpoint`` with
``use_reentrant=False`` (``dots_saveable`` through selective
checkpointing).  Dropout draws from an explicit ``torch.Generator``, which
``preserve_rng_state`` does not cover, so :func:`remat_call` replays that
generator's state in the recompute, making it draw the masks and the
attention-dropout seed the forward drew, and puts the generator back
where it was, so that it ends where the unwrapped forward leaves it.
The recompute also runs under the forward's AMP policy stack
(:mod:`apex_tpu_torch.amp.functional`), which the backward, outside the
forward's ``autocast`` block, would otherwise not see.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from apex_tpu_torch.amp import functional as amp_F

__all__ = ["REMAT_POLICIES", "checkpoint_policy", "remat_call"]

REMAT_POLICIES = ("none", "dots_saveable", "full_block")

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint_policy(policy: Optional[str]) -> Optional[Callable]:
    """The ``context_fn`` of ``checkpoint`` for a policy name: None for
    ``none``/None (meaning do not wrap at all), else a callable; an
    unknown name raises ``ValueError``."""
    if policy is None or policy == "none":
        return None
    if policy == "dots_saveable":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _dots_saveable)
    if policy == "full_block":
        return noop_context_fn
    raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got "
                     f"{policy!r}")


class _Replay:
    """``fn`` whose second and later calls (the recomputes) run under the
    AMP policy stack of the first and with ``generator`` set to the state
    it had at the first, then restored."""

    def __init__(self, fn: Callable, generator: Optional[torch.Generator]):
        self.fn, self.generator = fn, generator
        self.state = None if generator is None else generator.get_state()
        self.policies = amp_F.policy_stack()
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        if self.calls == 1:
            return self.fn(*args)
        with amp_F.use_policy_stack(self.policies):
            if self.generator is None:
                return self.fn(*args)
            now = self.generator.get_state()
            self.generator.set_state(self.state)
            try:
                return self.fn(*args)
            finally:
                self.generator.set_state(now)


def remat_call(fn: Callable, policy: Optional[str], *args: Any,
               generator: Optional[torch.Generator] = None) -> Any:
    """``fn(*args)`` under ``policy``: called as it is for ``none``, else
    checkpointed, with ``generator`` (the one ``fn`` draws its dropout
    from, if any) replayed in the recompute."""
    context_fn = checkpoint_policy(policy)
    if context_fn is None:
        return fn(*args)
    return checkpoint(_Replay(fn, generator), *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=context_fn)
