"""FusedLAMB: layer-wise adaptive moments with per-tensor trust ratios,
with the AMP unscale and overflow gate fused into its update.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py`` (apex's
``multi_tensor_lamb``).  Math, all in fp32 whatever the grad dtype:

    g~ = g / max(1, ||g||_global / max_grad_norm)
    m <- b1*m + (1-b1)*g~ ;  v <- b2*v + (1-b2)*g~^2
    u  = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p     (AdamW mode)
    r  = ||p|| / ||u|| if (wd != 0 or use_nvlamb) and both > 0, else 1
    p <- p - lr * r * u

With ``inv_scale``/``found_inf`` (the AMP-fused path) grads arrive
scaled: the global norm multiplies each grad by ``inv_scale`` before
squaring (a norm of the scaled grads could overflow fp32 where the
unscaled one does not), and ``inv_scale`` joins ``1/clip`` in the one
grad multiplier.  Stage 1 — the moments and the per-tensor sums of p^2
and u^2 — is :func:`apex_tpu_torch.ops.fused_optim.lamb_stage1`, the
CUDA kernel for every leaf on the card (its plain version on the CPU);
it updates m and v in place.  The apply recomputes u from (m, v, p) with
``torch._foreach_*`` passes, as the JAX package recomputes it rather
than store it.  On overflow the updates are 0, and m, v and the step
count keep their values; nothing is read on the host.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

import torch

from apex_tpu_torch.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.ops.fused_optim import lamb_stage1
from apex_tpu_torch.optimizers._common import AmpFusedTransformation

__all__ = ["FusedLAMB", "FusedLAMBState", "fused_lamb"]


class FusedLAMBState(NamedTuple):
    step: torch.Tensor             # i32 0-d
    m: Dict[str, torch.Tensor]     # fp32, like params
    v: Dict[str, torch.Tensor]     # fp32, like params


def fused_lamb(
    learning_rate: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3,
    betas: Tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-6,
    weight_decay: float = 0.01,
    bias_correction: bool = True,
    max_grad_norm: float = 1.0,
    use_nvlamb: bool = False,
    adam_w_mode: bool = True,
) -> AmpFusedTransformation:
    """Build the transform over fp32 params (the AMP masters); updates are
    deltas (``p_new = p + u``).  A callable ``learning_rate`` gets the new
    step count (a device tensor)."""
    b1, b2 = betas

    def init_fn(params: Mapping[str, torch.Tensor]) -> FusedLAMBState:
        first = next(iter(params.values()))
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return FusedLAMBState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m={k: zeros(p) for k, p in params.items()},
            v={k: zeros(p) for k, p in params.items()})

    def update_fn(grads: Mapping[str, torch.Tensor], state: FusedLAMBState,
                  params: Mapping[str, torch.Tensor], *,
                  inv_scale=None, found_inf=None):
        names = list(params)
        dev = state.step.device
        step = state.step + 1
        t = step.float()
        one = torch.ones((), device=dev)
        bc1 = 1.0 - torch.pow(b1, t) if bias_correction else one
        bc2 = 1.0 - torch.pow(b2, t) if bias_correction else one
        lr = learning_rate(step) if callable(learning_rate) else learning_rate
        # the global norm of the UNSCALED grads: an fp32 copy of each
        # grad is unscaled, then squared
        g32 = [grads[k].to(torch.float32, copy=True) for k in names]
        if inv_scale is not None:
            torch._foreach_mul_(g32, inv_scale)
        global_norm = multi_tensor_l2norm(g32)
        del g32
        clip = (torch.clamp_min(global_norm / max_grad_norm, 1.0)
                if max_grad_norm else one)
        g_scale = 1.0 / clip
        if inv_scale is not None:
            g_scale = g_scale * inv_scale
        skip = (torch.zeros((), device=dev) if found_inf is None
                else found_inf.float())
        scalars = torch.stack([g_scale, bc1, bc2, skip]).float().reshape(4)
        m_new, v_new, psq, usq = [], [], [], []
        for k in names:
            m, v, ps, us = lamb_stage1(
                grads[k].contiguous(), params[k], state.m[k], state.v[k],
                scalars, b1=b1, b2=b2, eps=eps, wd=weight_decay,
                adam_w=adam_w_mode)
            m_new.append(m)
            v_new.append(v)
            psq.append(ps)
            usq.append(us)
        # the apply: u again from (m, v, p), then -lr * ratio * u
        u = torch._foreach_div(m_new, bc1)
        denom = torch._foreach_div(v_new, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(u, denom)
        del denom
        p32 = [params[k].float() for k in names]
        if adam_w_mode and weight_decay != 0.0:
            torch._foreach_add_(u, torch._foreach_mul(p32, weight_decay))
        if weight_decay != 0.0 or use_nvlamb:
            r1, r2 = torch.sqrt(torch.stack(psq)), torch.sqrt(torch.stack(usq))
            ratio = torch.where((r1 > 0.0) & (r2 > 0.0), r1 / r2, 1.0)
        else:
            ratio = torch.ones(len(names), device=dev)
        factor = -lr * ratio
        if found_inf is not None:
            # m and v are gated in stage 1, so u is finite: multiplying by
            # 0.0 or 1.0 is the where(found_inf, 0, upd) gate exactly
            factor = factor * torch.logical_not(found_inf).float()
            step = torch.where(found_inf, state.step, step)
        torch._foreach_mul_(u, list(factor.unbind()))
        updates = {k: x.to(params[k].dtype) for k, x in zip(names, u)}
        return updates, FusedLAMBState(step=step.to(torch.int32),
                                       m=dict(zip(names, m_new)),
                                       v=dict(zip(names, v_new)))

    return AmpFusedTransformation(init_fn, update_fn)


class FusedLAMB:
    """Constructor parity with apex's ``FusedLAMB`` (ref
    apex/optimizers/fused_lamb.py:4-215) over dicts of fp32 params:
    ``state = opt.init(params)``, ``params, state = opt.step(grads,
    state, params)``."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, amsgrad=False,
                 adam_w_mode=True, grad_averaging=True, set_grad_none=True,
                 max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        del grad_averaging, set_grad_none  # parity: (1-b1) always applies
        self.tx = fused_lamb(lr, betas=betas, eps=eps,
                             weight_decay=weight_decay,
                             bias_correction=bias_correction,
                             max_grad_norm=max_grad_norm,
                             use_nvlamb=use_nvlamb, adam_w_mode=adam_w_mode)

    def init(self, params: Mapping[str, torch.Tensor]) -> FusedLAMBState:
        return self.tx.init(params)

    def step(self, grads, state: FusedLAMBState,
             params: Mapping[str, torch.Tensor]):
        updates, new_state = self.tx.update(grads, state, params)
        return {k: p + updates[k] for k, p in params.items()}, new_state
