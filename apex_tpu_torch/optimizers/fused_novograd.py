"""FusedNovoGrad: NovoGrad with one second-moment scalar per tensor, over
dicts of tensors, with the AMP unscale and overflow gate fused into its
update.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py`` (apex's
``multi_tensor_novograd``).  The second moment of a tensor is the EMA of
its gradient's norm (the norm itself, not its square), blended per step
(multi_tensor_novograd.cu:160-166):

    L2:    v_t = sqrt(b2*v^2 + (1-b2)*n^2)
    L-inf: v_t = b2*v + (1-b2)*n

with v set to the first step's norm (so the first blend does nothing)
unless ``init_zero``.  With bias correction the norm is divided by
``sqrt(1 - b2^t)`` and the momentum by ``1 - b1^t``.  The two moment
modes, with b3 = (1-b1) if ``grad_averaging`` else 1:

    reg_inside_moment=True (the paper's):  g~ = g/(v_t/bc2 + eps) + wd*p
                                           m_t = b1*m + b3*g~
                                           u = -lr * m_t/bc1
    reg_inside_moment=False (the default): m_t = b1*m + b3*g
                                           u = -lr * ((m_t/bc1)/(v_t/bc2 + eps)
                                                      + wd*p)

All in fp32 whatever the grad or parameter dtype.  On ``found_inf`` m
and v keep their values, the update is 0 and the step count holds.  The
passes are ``torch._foreach_*`` multi-tensor launches (the L2 norms
per-tensor sums of squares, the inf norms one ``_foreach_norm``), the
gates per-tensor ``torch.where``; the JAX package
has no Pallas kernel for NovoGrad, and neither has the port.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch.optimizers._common import AmpFusedTransformation

__all__ = ["FusedNovoGrad", "FusedNovoGradState", "fused_novograd"]


class FusedNovoGradState(NamedTuple):
    step: torch.Tensor             # i32 0-d
    m: Dict[str, torch.Tensor]     # fp32, like params
    v: Dict[str, torch.Tensor]     # fp32 0-d per tensor: the norm EMA


def fused_novograd(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_averaging: bool = True,
    norm_type: float = 2,
    init_zero: bool = False,
    reg_inside_moment: bool = False,
    bias_correction: bool = False,
) -> AmpFusedTransformation:
    """Build the transform; updates are deltas (``p_new = p + u``).  A
    callable ``learning_rate`` gets the new step count (a device tensor).
    ``norm_type`` is 2 or ``float("inf")``."""
    if norm_type not in (2, math.inf):
        raise ValueError("norm_type must be 2 or inf")
    b1, b2 = betas
    b3 = (1.0 - b1) if grad_averaging else 1.0

    def init_fn(params: Mapping[str, torch.Tensor]) -> FusedNovoGradState:
        first = next(iter(params.values()))
        return FusedNovoGradState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            v={k: torch.zeros((), dtype=torch.float32, device=p.device)
               for k, p in params.items()})

    def update_fn(grads: Mapping[str, torch.Tensor],
                  state: FusedNovoGradState,
                  params: Mapping[str, torch.Tensor], *,
                  inv_scale: Optional[torch.Tensor] = None,
                  found_inf: Optional[torch.Tensor] = None):
        names = list(params)
        step = state.step + 1
        first = state.step == 0
        t = step.float()
        if bias_correction:
            bc1 = 1.0 - torch.pow(b1, t)
            bc2 = torch.sqrt(1.0 - torch.pow(b2, t))
        else:
            bc1 = bc2 = torch.ones((), device=t.device)
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        g32 = [grads[k].float() for k in names]
        if inv_scale is not None:
            g32 = torch._foreach_mul(g32, inv_scale)
        p32 = [params[k].float() for k in names]
        m_old = [state.m[k] for k in names]
        v_old = [state.v[k] for k in names]
        if norm_type == 2:
            # sqrt(sum(g * g)), JAX's formula: torch's CPU norm sums
            # naively, so its error grows with the tensor; the sum
            # cascades
            n = torch._foreach_sqrt([torch.sum(s) for s in
                                     torch._foreach_mul(g32, g32)])
            blended = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(v_old, v_old), b2),
                torch._foreach_mul(torch._foreach_mul(n, n), 1.0 - b2)))
        else:
            n = torch._foreach_norm(g32, math.inf)
            blended = torch._foreach_add(torch._foreach_mul(v_old, b2),
                                         torch._foreach_mul(n, 1.0 - b2))
        v_new = (blended if init_zero else
                 [torch.where(first, a, b) for a, b in zip(n, blended)])
        if found_inf is not None:
            v_new = [torch.where(found_inf, o, x)
                     for o, x in zip(v_old, v_new)]
        denom = torch._foreach_add(torch._foreach_div(v_new, bc2), eps)
        if reg_inside_moment:
            gn = [g / d for g, d in zip(g32, denom)]
            if weight_decay != 0.0:
                torch._foreach_add_(gn, p32, alpha=weight_decay)
            m_new = torch._foreach_mul(m_old, b1)
            torch._foreach_add_(m_new, torch._foreach_mul(gn, b3))
        else:
            m_new = torch._foreach_mul(m_old, b1)
            torch._foreach_add_(m_new, torch._foreach_mul(g32, b3))
        if found_inf is not None:
            m_new = [torch.where(found_inf, o, x)
                     for o, x in zip(m_old, m_new)]
        upd = torch._foreach_div(m_new, bc1)
        if not reg_inside_moment:
            upd = [u / d for u, d in zip(upd, denom)]
            if weight_decay != 0.0:
                torch._foreach_add_(upd, p32, alpha=weight_decay)
        torch._foreach_mul_(upd, -lr)
        if found_inf is not None:
            upd = [torch.where(found_inf, 0.0, u) for u in upd]
            step = torch.where(found_inf, state.step, step)
        updates = {k: u.to(params[k].dtype) for k, u in zip(names, upd)}
        return updates, FusedNovoGradState(step=step.to(torch.int32),
                                           m=dict(zip(names, m_new)),
                                           v=dict(zip(names, v_new)))

    return AmpFusedTransformation(init_fn, update_fn)


class FusedNovoGrad:
    """ref apex/optimizers/fused_novograd.py constructor parity (bias
    correction on by default, as there): ``step`` returns the new
    parameters and state."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, amsgrad=False,
                 reg_inside_moment=False, grad_averaging=True, norm_type=2,
                 init_zero=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support the AMSGrad "
                               "variant.")
        self.tx = fused_novograd(
            learning_rate=lr, betas=betas, eps=eps,
            weight_decay=weight_decay, grad_averaging=grad_averaging,
            norm_type=norm_type, init_zero=init_zero,
            reg_inside_moment=reg_inside_moment,
            bias_correction=bias_correction)

    def init(self, params):
        return self.tx.init(params)

    def step(self, grads, state, params):
        updates, new_state = self.tx.update(grads, state, params)
        return {k: p + updates[k] for k, p in params.items()}, new_state
