"""apex_tpu_torch.amp — mixed precision for PyTorch training loops.

Counterpart of ``apex_tpu/amp/__init__.py``, in apex's own O2 design:
the model holds half-precision parameters that receive the scaled
gradients, and the optimizer holds the fp32 master weights, updates them
and copies them back into the model after each step::

    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_adam(6e-4, weight_decay=0.1), amp_)
    masters = opt.attach(model)       # fp32 masters; model cast to bf16
    state = opt.init(masters)         # Adam state + loss-scaler state

    _, loss = model(ids, labels)
    scaled = amp_.scale_loss(loss, state.scaler[0])
    grads = dict(zip(names, torch.autograd.grad(scaled, params)))
    masters, state, stats = opt.step(grads, state, masters, model=model)

Every piece of state is a tensor on the device and the overflow skip is
a where gate: a step reads nothing on the host.  Not ported yet: O1
autocast (``amp/functional.py``, ``lists.py``) and the accumulate/stash
path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch import multi_tensor
from apex_tpu_torch.amp.layers import Conv, Dense  # noqa: F401
from apex_tpu_torch.amp.policy import (  # noqa: F401
    O0,
    O2,
    O3,
    Policy,
    make_policy,
    opt_levels,
)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaler,
    LossScalerState,
    apply_if_finite,
)
from apex_tpu_torch.optimizers._common import AmpFusedTransformation

__all__ = [
    "Amp", "AmpOptState", "AmpOptimizer", "Conv", "Dense", "LossScaler",
    "LossScalerState", "O0", "O2", "O3", "Policy", "StepStats",
    "apply_if_finite", "default_is_batchnorm", "initialize", "make_policy",
    "opt_levels",
]


def default_is_batchnorm(path: Tuple[str, ...]) -> bool:
    """Does this parameter path (its dotted name split on '.') belong to a
    BatchNorm?  The JAX package's name heuristic: 'BatchNorm_0',
    'batch_norm', 'bn', 'bn1', 'downsample_bn', ...  GPT's names match
    none, so under O2 every GPT float parameter is cast, LayerNorm's
    included; BERT's match none either."""
    for name in path:
        low = str(name).lower()
        if "batchnorm" in low or "batch_norm" in low:
            return True
        if low.startswith("bn") or low.endswith("bn"):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class Amp:
    """An initialized AMP context: a policy and one scaler per loss."""

    policy: Policy
    scalers: Tuple[LossScaler, ...]

    def init_state(self, device=None) -> Tuple[LossScalerState, ...]:
        return tuple(s.init(device) for s in self.scalers)

    def scale_loss(self, loss: torch.Tensor, scaler_state: LossScalerState,
                   loss_id: int = 0) -> torch.Tensor:
        if not self.policy.enabled:
            return loss
        return self.scalers[loss_id].scale_loss(loss, scaler_state)

    def unscale(self, grads, scaler_state, loss_id: int = 0):
        return self.scalers[loss_id].unscale(grads, scaler_state)

    def update_scaler(self, scaler_state, found_inf, loss_id: int = 0):
        return self.scalers[loss_id].update(scaler_state, found_inf)

    def _cast_dtype(self, name: str, t: torch.Tensor,
                    is_batchnorm: Callable) -> torch.dtype:
        dtype = self.policy.cast_model_dtype
        if dtype is None or dtype == torch.float32 \
                or not t.is_floating_point():
            return t.dtype
        if self.policy.keep_batchnorm_fp32 and is_batchnorm(
                tuple(name.split("."))):
            return torch.float32
        return dtype

    def cast_model(self, params: Mapping[str, torch.Tensor],
                   is_batchnorm: Callable = default_is_batchnorm
                   ) -> Dict[str, torch.Tensor]:
        """Pure cast of fp32 parameters (name -> tensor) to the policy's
        model dtype; BatchNorm parameters stay fp32 under O2.  The
        identity under O0."""
        return {k: v.to(self._cast_dtype(k, v, is_batchnorm))
                for k, v in params.items()}

    def cast_module_(self, module: nn.Module,
                     is_batchnorm: Callable = default_is_batchnorm
                     ) -> nn.Module:
        """:meth:`cast_model` applied to a module's parameters in place
        (apex's ``model.half()`` with BatchNorm kept in fp32)."""
        for name, p in module.named_parameters():
            dt = self._cast_dtype(name, p, is_batchnorm)
            if dt != p.dtype:
                p.data = p.data.to(dt)
        return module

    def state_dict(self, states) -> dict:
        return {f"loss_scaler{i}": s.state_dict(st)
                for i, (s, st) in enumerate(zip(self.scalers, states))}

    def load_state_dict(self, d: Mapping, device=None):
        return tuple(s.load_state_dict(d[f"loss_scaler{i}"], device)
                     for i, s in enumerate(self.scalers))


def initialize(
    opt_level: str,
    num_losses: int = 1,
    enabled: bool = True,
    cast_model_dtype=None,
    keep_batchnorm_fp32: Optional[bool] = None,
    loss_scale=None,
    min_loss_scale: Optional[float] = None,
    max_loss_scale: float = 2.0 ** 24,
) -> Amp:
    """Build an :class:`Amp` context (ref apex/amp/frontend.py:195-358)
    for ``opt_level`` 'O0', 'O2' or 'O3' ('O1' raises: not ported yet).
    Pair it with :class:`AmpOptimizer`, which casts the model."""
    policy = make_policy(
        opt_level, cast_model_dtype=cast_model_dtype,
        keep_batchnorm_fp32=keep_batchnorm_fp32, loss_scale=loss_scale)
    if not enabled:
        policy = policy.replace(enabled=False, loss_scale=1.0)
    kw = dict(max_loss_scale=max_loss_scale, min_loss_scale=min_loss_scale)
    return Amp(policy=policy,
               scalers=tuple(policy.make_scaler(**kw)
                             for _ in range(num_losses)))


class AmpOptState(NamedTuple):
    opt_state: Any  # the inner optimizer's state, over the fp32 masters
    scaler: Tuple[LossScalerState, ...]
    stash: Optional[Any] = None  # the accumulate path: not ported yet


class StepStats(NamedTuple):
    found_inf: torch.Tensor   # bool 0-d: this step was skipped
    loss_scale: torch.Tensor  # f32 0-d: the scale after the update


class AmpOptimizer:
    """Master weights and loss scaling around an AMP-fused transform
    (ref apex/amp/_process_optimizer.py).  ``step`` is the whole hot
    path: the overflow check as one max-abs reduction over the scaled
    grads, the transform's fused unscale/update/gate, the in-place master
    update, the scaler update, and the copy of the masters into the
    model."""

    def __init__(self, tx: AmpFusedTransformation, amp_: Amp):
        if not isinstance(tx, AmpFusedTransformation):
            raise TypeError("AmpOptimizer takes an AMP-fused transform "
                            "(fused_sgd, fused_adam or fused_lamb); the "
                            "unfused path is not ported")
        self.tx = tx
        self.amp = amp_

    def attach(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """fp32 master copies of the model's float parameters (name ->
        tensor), then the model cast in place to the policy's dtype."""
        masters = {n: p.detach().float().clone()
                   for n, p in model.named_parameters()
                   if p.is_floating_point()}
        self.amp.cast_module_(model)
        return masters

    def init(self, master_params: Mapping[str, torch.Tensor]) -> AmpOptState:
        """Optimizer and scaler state on the masters' device."""
        dev = next(iter(master_params.values())).device
        return AmpOptState(opt_state=self.tx.init(master_params),
                           scaler=self.amp.init_state(dev))

    def model_params(self, master_params: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The half model copy (a pure cast; identity under O0)."""
        return self.amp.cast_model(master_params)

    def step(self, scaled_grads: Mapping[str, torch.Tensor],
             state: AmpOptState, master_params: Dict[str, torch.Tensor],
             loss_id: int = 0, model: Optional[nn.Module] = None
             ) -> Tuple[Dict[str, torch.Tensor], AmpOptState, StepStats]:
        """One optimizer step from scaled grads (name -> tensor).

        Returns ``(master_params, state, stats)``.  The masters are
        updated IN PLACE (the returned dict is the one passed in); on
        overflow they, the Adam moments and its step count keep their
        values and the scale backs off, with no host read.  With
        ``model``, the new masters are copied into its parameters (cast to
        their dtypes)."""
        if state.stash is not None:
            raise NotImplementedError("the accumulate/stash path is not "
                                      "ported yet")
        scaler = self.amp.scalers[loss_id]
        sstate = state.scaler[loss_id]
        inv_scale = 1.0 / sstate.loss_scale
        # the check sees the UNSCALED magnitudes: max|g| * inv_scale
        maxabs = multi_tensor.multi_tensor_l2norm(scaled_grads, max_norm=True)
        found_inf = torch.logical_not(torch.isfinite(maxabs * inv_scale))
        updates, new_opt_state = self.tx.update(
            scaled_grads, state.opt_state, master_params,
            inv_scale=inv_scale, found_inf=found_inf)
        names = list(master_params)
        torch._foreach_add_([master_params[k] for k in names],
                            [updates[k] for k in names])
        new_sstate = scaler.update(sstate, found_inf)
        scalers = tuple(new_sstate if i == loss_id else s
                        for i, s in enumerate(state.scaler))
        if model is not None:
            self.copy_to_model(model, master_params)
        return (master_params,
                AmpOptState(opt_state=new_opt_state, scaler=scalers),
                StepStats(found_inf=found_inf,
                          loss_scale=new_sstate.loss_scale))

    @staticmethod
    @torch.no_grad()
    def copy_to_model(model: nn.Module,
                      master_params: Mapping[str, torch.Tensor]) -> None:
        """Each master into the model parameter of the same name, cast
        to the parameter's dtype (round to nearest even)."""
        params = dict(model.named_parameters())
        names = [n for n in master_params if n in params]
        torch._foreach_copy_([params[n] for n in names],
                             [master_params[n] for n in names])
