"""FusedAdagrad: Adagrad with L2 or decoupled weight decay over dicts of
tensors, with the AMP unscale and overflow gate fused into its update.

Counterpart of ``apex_tpu/optimizers/fused_adagrad.py`` (apex's
``multi_tensor_adagrad``, AdagradFunctor: MODE_0 L2, MODE_1 decoupled).
Math, in fp32 whatever the grad or parameter dtype:

    g <- g [* inv_scale] (+ wd*p          with adagrad_w_mode=False)
    h <- h + g*g
    u = -lr * (g / (sqrt(h) + eps)  (+ wd*p  with adagrad_w_mode=True))

``eps`` is added outside the square root.  On ``found_inf`` h keeps its
value, the update is 0 and the step count holds.  The passes are
``torch._foreach_*`` multi-tensor launches and per-tensor
``torch.where`` gates; the JAX package has no Pallas kernel for Adagrad,
and neither has the port.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Union

import torch

from apex_tpu_torch.optimizers._common import AmpFusedTransformation

__all__ = ["FusedAdagrad", "FusedAdagradState", "fused_adagrad"]


class FusedAdagradState(NamedTuple):
    step: torch.Tensor               # i32 0-d
    sum_sq: Dict[str, torch.Tensor]  # fp32, like params


def fused_adagrad(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-2,
    eps: float = 1e-10,
    weight_decay: float = 0.0,
    adagrad_w_mode: bool = False,
) -> AmpFusedTransformation:
    """Build the transform; updates are deltas (``p_new = p + u``).  A
    callable ``learning_rate`` gets the new step count (a device tensor)."""

    def init_fn(params: Mapping[str, torch.Tensor]) -> FusedAdagradState:
        first = next(iter(params.values()))
        return FusedAdagradState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            sum_sq={k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()})

    def update_fn(grads: Mapping[str, torch.Tensor], state: FusedAdagradState,
                  params: Mapping[str, torch.Tensor], *,
                  inv_scale: Optional[torch.Tensor] = None,
                  found_inf: Optional[torch.Tensor] = None):
        names = list(params)
        step = state.step + 1
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        g32 = [grads[k].float() for k in names]
        if inv_scale is not None:
            g32 = torch._foreach_mul(g32, inv_scale)
        p32 = [params[k].float() for k in names]
        if weight_decay != 0.0 and not adagrad_w_mode:
            g32 = torch._foreach_add(g32, p32, alpha=weight_decay)
        h_old = [state.sum_sq[k] for k in names]
        h_new = torch._foreach_add(h_old, torch._foreach_mul(g32, g32))
        if found_inf is not None:
            h_new = [torch.where(found_inf, o, n)
                     for o, n in zip(h_old, h_new)]
        denom = torch._foreach_add(torch._foreach_sqrt(h_new), eps)
        upd = torch._foreach_div(g32, denom)
        if weight_decay != 0.0 and adagrad_w_mode:
            torch._foreach_add_(upd, p32, alpha=weight_decay)
        torch._foreach_mul_(upd, -lr)
        if found_inf is not None:
            # an overflowing g makes upd non-finite: select, not multiply
            upd = [torch.where(found_inf, 0.0, u) for u in upd]
            step = torch.where(found_inf, state.step, step)
        updates = {k: u.to(params[k].dtype) for k, u in zip(names, upd)}
        return updates, FusedAdagradState(step=step.to(torch.int32),
                                          sum_sq=dict(zip(names, h_new)))

    return AmpFusedTransformation(init_fn, update_fn)


class FusedAdagrad:
    """ref apex/optimizers/fused_adagrad.py constructor parity: ``step``
    returns the new parameters and state."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, adagrad_w_mode=False):
        self.tx = fused_adagrad(learning_rate=lr, eps=eps,
                                weight_decay=weight_decay,
                                adagrad_w_mode=adagrad_w_mode)

    def init(self, params):
        return self.tx.init(params)

    def step(self, grads, state, params):
        updates, new_state = self.tx.update(grads, state, params)
        return {k: p + updates[k] for k, p in params.items()}, new_state
