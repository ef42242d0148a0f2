"""FusedSGD: SGD with momentum and nesterov over dicts of tensors, with
the AMP unscale and overflow gate fused into its update.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py`` (apex's
``multi_tensor_sgd``, torch.optim.SGD semantics).  Math, in fp32 on fp32
masters whatever the grad dtype:

    d_p = g [* inv_scale] + wd*p          (wd_after_momentum=False)
    buf <- momentum*buf + (1-dampening)*d_p   [first step: buf = d_p]
    d_p = d_p + momentum*buf  if nesterov  else  buf
    d_p = d_p + wd*p                       (wd_after_momentum=True)
    u = -lr * d_p

On ``found_inf`` the buffer keeps its value, the update is 0 and the step
count holds (so the next step is still the first).  The elementwise chain
runs as ``torch._foreach_*`` multi-tensor launches and per-tensor
``torch.where`` for the first-step and overflow gates; the state's buffers
are new tensors each step.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import torch

from apex_tpu_torch.optimizers._common import AmpFusedTransformation

__all__ = ["FusedSGD", "FusedSGDState", "fused_sgd"]


class FusedSGDState(NamedTuple):
    step: torch.Tensor                      # i32 0-d
    momentum_buf: Dict[str, torch.Tensor]   # fp32, like params


def fused_sgd(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
    momentum: float = 0.0,
    dampening: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    wd_after_momentum: bool = False,
) -> AmpFusedTransformation:
    """Build the transform; updates are deltas (``p_new = p + u``).  A
    callable ``learning_rate`` gets the new step count (a device tensor)."""
    if nesterov and (momentum <= 0 or dampening != 0):
        raise ValueError("Nesterov momentum requires a momentum and zero "
                         "dampening")

    def init_fn(params: Mapping[str, torch.Tensor]) -> FusedSGDState:
        first = next(iter(params.values()))
        return FusedSGDState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            momentum_buf={k: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
                          for k, p in params.items()})

    def update_fn(grads: Mapping[str, torch.Tensor], state: FusedSGDState,
                  params: Mapping[str, torch.Tensor], *,
                  inv_scale: Optional[torch.Tensor] = None,
                  found_inf: Optional[torch.Tensor] = None):
        names = list(params)
        step = state.step + 1
        first = state.step == 0
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        d_p = [grads[k].float() for k in names]
        if inv_scale is not None:
            d_p = torch._foreach_mul(d_p, inv_scale)
        p32 = [params[k].float() for k in names]
        if weight_decay != 0.0 and not wd_after_momentum:
            d_p = torch._foreach_add(d_p, torch._foreach_mul(p32,
                                                             weight_decay))
        buf_old = [state.momentum_buf[k] for k in names]
        if momentum != 0.0:
            buf_new = torch._foreach_mul(buf_old, momentum)
            torch._foreach_add_(buf_new,
                                torch._foreach_mul(d_p, 1.0 - dampening))
            buf_new = [torch.where(first, d, b) for d, b in zip(d_p, buf_new)]
            if found_inf is not None:
                buf_new = [torch.where(found_inf, o, b)
                           for o, b in zip(buf_old, buf_new)]
            if nesterov:
                d_p = torch._foreach_add(d_p,
                                         torch._foreach_mul(buf_new, momentum))
            else:
                d_p = buf_new
        else:
            buf_new = buf_old
        if weight_decay != 0.0 and wd_after_momentum:
            d_p = torch._foreach_add(d_p, torch._foreach_mul(p32,
                                                             weight_decay))
        upd = torch._foreach_mul(d_p, -lr)
        if found_inf is not None:
            upd = [torch.where(found_inf, 0.0, u) for u in upd]
            step = torch.where(found_inf, state.step, step)
        updates = {k: u.to(params[k].dtype) for k, u in zip(names, upd)}
        return updates, FusedSGDState(step=step.to(torch.int32),
                                      momentum_buf=dict(zip(names, buf_new)))

    return AmpFusedTransformation(init_fn, update_fn)


class FusedSGD:
    """ref apex/optimizers/fused_sgd.py constructor parity: ``step``
    returns the new parameters and state."""

    def __init__(self, lr=1e-3, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False, wd_after_momentum=False):
        self.tx = fused_sgd(learning_rate=lr, momentum=momentum,
                            dampening=dampening, weight_decay=weight_decay,
                            nesterov=nesterov,
                            wd_after_momentum=wd_after_momentum)

    def init(self, params):
        return self.tx.init(params)

    def step(self, grads, state, params):
        updates, new_state = self.tx.update(grads, state, params)
        return {k: p + updates[k] for k, p in params.items()}, new_state
