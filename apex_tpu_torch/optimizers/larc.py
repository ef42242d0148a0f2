"""LARC: layer-wise adaptive rate clipping or scaling before an inner
optimizer.

Counterpart of ``apex_tpu/optimizers/larc.py`` (ref
``apex/parallel/LARC.py``, exported as ``apex.parallel.LARC``).  The
reference wraps a torch optimizer and rewrites ``p.grad`` before the
inner ``step()``; here, as in the JAX package, it is a gradient
transform composed before an inner transform, leaf by leaf in fp32::

    adaptive_lr = trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)
    clip mode : g <- (g + wd * p) * min(adaptive_lr / lr, 1)
    scale mode: g <- (g + wd * p) * adaptive_lr

and a leaf whose parameter or gradient norm is 0 keeps its gradient.
It is a plain :class:`~apex_tpu_torch.optimizers._common.Transformation`,
so :class:`~apex_tpu_torch.amp.AmpOptimizer` runs it on its unfused
route: the unscale, then LARC and the inner update, then the overflow
gate over the new state.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, NamedTuple, Union

import torch

from apex_tpu_torch.optimizers._common import Transformation

__all__ = ["LARC", "LARCState", "larc"]


class LARCState(NamedTuple):
    step: torch.Tensor  # i32 0-d
    inner: Any          # the inner transform's state


def larc(inner, learning_rate: Union[float, Callable] = 1e-3,
         trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Transformation:
    """Wrap the transform ``inner`` (``fused_sgd``, ...) with LARC.

    ``learning_rate`` bounds the per-leaf rate in clip mode (ref
    LARC.py:97): pass the inner optimizer's (a callable gets the new
    step count).  Weight decay belongs here, not in ``inner`` (the
    reference zeroes the inner group's during the step)."""

    def init_fn(params: Mapping[str, torch.Tensor]) -> LARCState:
        first = next(iter(params.values()))
        return LARCState(step=torch.zeros((), dtype=torch.int32,
                                          device=first.device),
                         inner=inner.init(params))

    def precondition(g: torch.Tensor, p: torch.Tensor, lr) -> torch.Tensor:
        g32, p32 = g.float(), p.float()
        param_norm = torch.sqrt((p32 * p32).sum())
        grad_norm = torch.sqrt((g32 * g32).sum())
        adaptive_lr = (trust_coefficient * param_norm
                       / (grad_norm + param_norm * weight_decay + eps))
        if clip:
            adaptive_lr = torch.clamp_max(adaptive_lr / lr, 1.0)
        ok = (param_norm != 0.0) & (grad_norm != 0.0)
        pre = (g32 + weight_decay * p32) * adaptive_lr
        return torch.where(ok, pre, g32).to(g.dtype)

    def update_fn(grads: Mapping[str, torch.Tensor], state: LARCState,
                  params: Mapping[str, torch.Tensor]):
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        pre = {k: precondition(grads[k], params[k], lr) for k in params}
        updates, new_inner = inner.update(pre, state.inner, params)
        return updates, LARCState(step=step, inner=new_inner)

    return Transformation(init_fn, update_fn)


class LARC:
    """Class parity with ref apex/parallel/LARC.py: ``step`` returns the
    new parameters and state."""

    def __init__(self, optimizer, learning_rate: Union[float, Callable],
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.tx = larc(optimizer, learning_rate=learning_rate,
                       trust_coefficient=trust_coefficient, clip=clip,
                       eps=eps, weight_decay=weight_decay)

    def init(self, params):
        return self.tx.init(params)

    def step(self, grads, state, params):
        updates, new_state = self.tx.update(grads, state, params)
        return {k: p + updates[k] for k, p in params.items()}, new_state
