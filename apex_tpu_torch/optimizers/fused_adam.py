"""FusedAdam: Adam/AdamW over dicts of tensors, with the AMP unscale and
overflow gate fused into its update.

Counterpart of ``apex_tpu/optimizers/fused_adam.py`` (apex's
``multi_tensor_adam``).  Math, all in fp32 whatever the grad or param
dtype:

    m <- b1*m + (1-b1)*g
    v <- b2*v + (1-b2)*g*g
    denom = sqrt(v)/sqrt(1-b2^t) + eps
    u = -lr * ((m/(1-b1^t)) / denom  [+ wd*p in adam_w mode])
    (L2 mode folds wd*p into g before the moments)

With ``inv_scale``/``found_inf`` (the AMP-fused path) grads arrive scaled
and are unscaled in the same pass; on overflow m and v keep their old
values, the update is 0 and the step count holds.  The elementwise chain
runs as ``torch._foreach_*`` multi-tensor launches where no gate is
needed and per-tensor ``torch.where`` for the m/v gate.  The state's m
and v are new tensors each step (the old ones are what the gate keeps).
``torch.optim.Adam``/``AdamW`` are not used: their step cannot carry the
found_inf gate and the held step count.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch.optimizers._common import AmpFusedTransformation

__all__ = ["FusedAdamState", "fused_adam"]


class FusedAdamState(NamedTuple):
    step: torch.Tensor             # i32 0-d
    m: Dict[str, torch.Tensor]     # fp32, like params
    v: Dict[str, torch.Tensor]     # fp32, like params


def fused_adam(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    adam_w_mode: bool = True,
    bias_correction: bool = True,
) -> AmpFusedTransformation:
    """Build the transform; updates are deltas (``p_new = p + u``).  A
    callable ``learning_rate`` gets the new step count (a device tensor)."""
    b1, b2 = betas

    def init_fn(params: Mapping[str, torch.Tensor]) -> FusedAdamState:
        first = next(iter(params.values()))
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return FusedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m={k: zeros(p) for k, p in params.items()},
            v={k: zeros(p) for k, p in params.items()})

    def update_fn(grads: Mapping[str, torch.Tensor], state: FusedAdamState,
                  params: Mapping[str, torch.Tensor], *,
                  inv_scale: Optional[torch.Tensor] = None,
                  found_inf: Optional[torch.Tensor] = None):
        names = list(params)
        step = state.step + 1
        t = step.float()
        if bias_correction:
            bc1 = 1.0 - torch.pow(b1, t)
            sqrt_bc2 = torch.sqrt(1.0 - torch.pow(b2, t))
        else:
            bc1 = sqrt_bc2 = torch.ones((), device=t.device)
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        g32 = [grads[k].float() for k in names]
        if inv_scale is not None:
            g32 = torch._foreach_mul(g32, inv_scale)
        p32 = [params[k].float() for k in names]
        if not adam_w_mode and weight_decay != 0.0:
            g32 = torch._foreach_add(g32, p32, alpha=weight_decay)
        m_old = [state.m[k] for k in names]
        v_old = [state.v[k] for k in names]
        m_new = torch._foreach_mul(m_old, b1)
        torch._foreach_add_(m_new, torch._foreach_mul(g32, 1.0 - b1))
        v_new = torch._foreach_mul(v_old, b2)
        torch._foreach_add_(
            v_new, torch._foreach_mul(torch._foreach_mul(g32, 1.0 - b2), g32))
        if found_inf is not None:
            m_new = [torch.where(found_inf, o, n) for o, n in zip(m_old, m_new)]
            v_new = [torch.where(found_inf, o, n) for o, n in zip(v_old, v_new)]
        denom = torch._foreach_sqrt(v_new)
        torch._foreach_div_(denom, sqrt_bc2)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m_new, bc1)
        torch._foreach_div_(upd, denom)
        if adam_w_mode and weight_decay != 0.0:
            torch._foreach_add_(upd, torch._foreach_mul(p32, weight_decay))
        torch._foreach_mul_(upd, -lr)
        if found_inf is not None:
            # m and v are gated above, so upd is finite: multiplying by
            # 0.0 or 1.0 is the where(found_inf, 0, upd) gate exactly
            torch._foreach_mul_(upd, torch.logical_not(found_inf).float())
            step = torch.where(found_inf, state.step, step)
        updates = {k: u.to(params[k].dtype) for k, u in zip(names, upd)}
        return updates, FusedAdamState(step=step.to(torch.int32),
                                       m=dict(zip(names, m_new)),
                                       v=dict(zip(names, v_new)))

    return AmpFusedTransformation(init_fn, update_fn)
