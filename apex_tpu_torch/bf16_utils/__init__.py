"""apex_tpu_torch.bf16_utils — manual mixed precision (fp16_utils parity).

Counterpart of ``apex_tpu/bf16_utils/__init__.py`` (ref apex/fp16_utils/:
the pre-amp "manual" path of model conversion helpers, master-parameter
lists, ``FP16_Optimizer`` and the legacy loss scalers), with bf16 for
fp16, over the port's name -> tensor parameter maps (a ``state_dict`` or
``dict(model.named_parameters())``):

=====================================  =====================================
reference (fp16)                       port (bf16)
=====================================  =====================================
``tofp16``                             :func:`tobf16`
``BN_convert_float``                   :func:`bn_convert_float`
``network_to_half``                    :func:`network_to_bf16`
``convert_module``/``convert_network`` :func:`convert_network`
``prep_param_lists``                   same (``(model, master)``)
``model_grads_to_master_grads``        same
``master_params_to_model_params``      same (returns the new model map)
``clip_grad_norm``                     :func:`clip_grad_norm` (global L2)
``FP16Model``                          :func:`bf16_model` (wraps a callable)
``FP16_Optimizer``                     :class:`BF16_Optimizer`
``LossScaler``/``DynamicLossScaler``   same names, the legacy constants
``to_python_float``                    same
=====================================  =====================================

BatchNorm parameters are found by name
(:func:`apex_tpu_torch.amp.default_is_batchnorm` on the dotted name's
parts), as the JAX package finds them by path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Tuple, Union

import torch

from apex_tpu_torch import multi_tensor
from apex_tpu_torch.amp import default_is_batchnorm
from apex_tpu_torch.amp.scaler import LossScaler as _AmpScaler
from apex_tpu_torch.amp.scaler import LossScalerState, apply_if_finite
from apex_tpu_torch.optimizers._common import gates_overflow

__all__ = [
    "BF16OptState", "BF16_Optimizer", "DynamicLossScaler", "LossScaler",
    "bf16_model", "bn_convert_float", "clip_grad_norm", "convert_network",
    "master_params_to_model_params", "model_grads_to_master_grads",
    "network_to_bf16", "prep_param_lists", "to_python_float", "tobf16",
]

Params = Mapping[str, torch.Tensor]


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _path(name: str) -> Tuple[str, ...]:
    return tuple(name.split("."))


def tobf16(tree):
    """Every floating tensor of ``tree`` (a dict, list or tuple) cast to
    bf16 (ref fp16util.py:7-20 ``tofp16``)."""
    return multi_tensor.tree_map(
        lambda x: x.to(torch.bfloat16) if _is_float(x) else x, tree)


def bn_convert_float(params: Params, is_batchnorm=default_is_batchnorm
                     ) -> Dict[str, torch.Tensor]:
    """BatchNorm parameters back to fp32 (ref fp16util.py:22-33); apply
    after :func:`tobf16`."""
    return {k: v.float() if _is_float(v) and is_batchnorm(_path(k)) else v
            for k, v in params.items()}


def convert_network(params: Params, dtype: torch.dtype,
                    is_batchnorm=default_is_batchnorm
                    ) -> Dict[str, torch.Tensor]:
    """Floating parameters cast to ``dtype``, BatchNorm's kept as they
    are (ref fp16util.py:44-70)."""
    return {k: v.to(dtype) if _is_float(v) and not is_batchnorm(_path(k))
            else v for k, v in params.items()}


def network_to_bf16(params: Params) -> Dict[str, torch.Tensor]:
    """The BatchNorm-safe half conversion (ref fp16util.py:36-41)."""
    return convert_network(params, torch.bfloat16)


def bf16_model(fn: Callable) -> Callable:
    """``fn`` (a module or a forward function) with its floating tensor
    inputs cast to bf16 (ref fp16util.py:72-84 ``FP16Model.forward``)."""
    def wrapped(*inputs, **kwargs):
        return fn(*(x.to(torch.bfloat16) if _is_float(x) else x
                    for x in inputs), **kwargs)
    return wrapped


def _flat(tree: Params) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


def prep_param_lists(model_params: Params, flat_master: bool = False):
    """``(model_params, fp32 master copy)`` (ref fp16util.py:90-135); with
    ``flat_master`` the master is one flat fp32 vector, the leaves in the
    map's order."""
    master = {k: v.detach().float().clone() if _is_float(v) else v
              for k, v in model_params.items()}
    return model_params, (_flat(master) if flat_master else master)


def model_grads_to_master_grads(model_grads: Params, flat_master: bool = False):
    """bf16 model grads -> fp32 master grads (ref fp16util.py:136-157),
    flat with ``flat_master``."""
    master = {k: v.float() if _is_float(v) else v
              for k, v in model_grads.items()}
    return _flat(master) if flat_master else master


def master_params_to_model_params(model_params: Params, master_params,
                                  flat_master: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """The fp32 masters cast back to the model's dtypes (ref
    fp16util.py:158-175): a new map (the reference copies in place).
    With ``flat_master`` the masters are :func:`prep_param_lists`'s flat
    vector, split along the model's layout."""
    if flat_master:
        out, off = {}, 0
        for k, p in model_params.items():
            n = p.numel()
            out[k] = master_params[off:off + n].reshape(p.shape).to(p.dtype)
            off += n
        return out
    return {k: master_params[k].to(p.dtype) if _is_float(p) else
            master_params[k] for k, p in model_params.items()}


def clip_grad_norm(grads: Params, max_norm: float, eps: float = 1e-6):
    """Global L2 clip: every grad times ``min(max_norm / (norm + eps),
    1)``; returns ``(clipped, norm)``, the norm one multi-tensor
    reduction (:func:`~apex_tpu_torch.multi_tensor.multi_tensor_l2norm`)."""
    total = multi_tensor.multi_tensor_l2norm(grads)
    coef = torch.clamp_max(max_norm / (total + eps), 1.0)
    return multi_tensor.tree_map(lambda g: g * coef, grads), total


def to_python_float(t) -> float:
    """ref loss_scaler.py:4-8 (one host read)."""
    return float(t)


def LossScaler(scale: float = 1.0) -> _AmpScaler:
    """Static scaler (ref loss_scaler.py:10-45): the scale never changes."""
    return _AmpScaler(loss_scale=float(scale))


def DynamicLossScaler(init_scale: float = 2.0 ** 32,
                      scale_factor: float = 2.0,
                      scale_window: int = 1000) -> _AmpScaler:
    """Dynamic scaler with the legacy constants (ref loss_scaler.py:
    73-81): init 2^32, window 1000, no cap, floor 1 (``max(scale /
    factor, 1)``, loss_scaler.py:119)."""
    return _AmpScaler(loss_scale="dynamic", init_scale=init_scale,
                      scale_factor=scale_factor, scale_window=scale_window,
                      max_loss_scale=float("inf"), min_loss_scale=1.0)


class BF16OptState(NamedTuple):
    master: Dict[str, torch.Tensor]  # fp32 master params
    inner: Any                       # the wrapped optimizer's state
    scaler: LossScalerState


@dataclasses.dataclass(frozen=True)
class BF16_Optimizer:
    """Master weights and loss scaling around a transform (ref
    apex/fp16_utils/fp16_optimizer.py:13-550)::

        state = opt.init(model_params)            # fp32 master copies
        loss = opt.scale_loss(raw_loss, state)    # ref backward()'s scaling
        grads = ...                               # bf16 model grads by name
        model_params, state = opt.step(grads, state, model_params)

    ``inner`` is any port transform (:class:`~apex_tpu_torch.optimizers.
    Transformation` or :class:`~apex_tpu_torch.optimizers.
    AmpFusedTransformation`: ``init``, ``update``).  ``clip_master_grads``
    is the global L2 bound of the unscaled grads (0: off).  ``step`` reads
    nothing on the host: an overflow keeps the masters and the inner
    state and backs the scale off, as where gates."""

    inner: Any
    static_loss_scale: Union[str, float] = 1.0
    dynamic_loss_scale: bool = False
    clip_master_grads: float = 0.0

    def _scaler(self) -> _AmpScaler:
        if self.dynamic_loss_scale:
            return DynamicLossScaler()
        return LossScaler(float(self.static_loss_scale))

    def init(self, model_params: Params) -> BF16OptState:
        _, master = prep_param_lists(model_params)
        dev = next(iter(master.values())).device
        return BF16OptState(master=master, inner=self.inner.init(master),
                            scaler=self._scaler().init(dev))

    def scale_loss(self, loss: torch.Tensor,
                   state: BF16OptState) -> torch.Tensor:
        """ref fp16_optimizer.py:373-431 ``backward()``: fp32 loss x
        scale."""
        return loss.float() * state.scaler.loss_scale

    def step(self, model_grads: Params, state: BF16OptState,
             model_params: Params
             ) -> Tuple[Dict[str, torch.Tensor], BF16OptState]:
        """Unscale, check, (clip), update, gate; returns the new model
        params in ``model_params``' dtypes and the new state (ref
        fp16_optimizer.py:272-333)."""
        master_grads, found_inf = multi_tensor.multi_tensor_unscale(
            model_grads, 1.0 / state.scaler.loss_scale)
        if self.clip_master_grads:
            master_grads, _ = clip_grad_norm(master_grads,
                                             self.clip_master_grads)
        if gates_overflow(self.inner):
            # a fused transform may update its state in place (fused_lamb):
            # it gates itself
            updates, new_inner = self.inner.update(
                master_grads, state.inner, state.master, found_inf=found_inf)
        else:
            updates, new_inner = self.inner.update(master_grads, state.inner,
                                                   state.master)
            new_inner = apply_if_finite(found_inf, new_inner, state.inner)
        new_master = apply_if_finite(
            found_inf, {k: m + updates[k].to(m.dtype)
                        for k, m in state.master.items()}, state.master)
        new_scaler = self._scaler().update(state.scaler, found_inf)
        return (master_params_to_model_params(model_params, new_master),
                BF16OptState(new_master, new_inner, new_scaler))

    def state_dict(self, state: BF16OptState) -> dict:
        """Host copies for a checkpoint (ref fp16_optimizer.py:209-229)."""
        host = lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) \
            else t  # noqa: E731
        return {"loss_scaler": self._scaler().state_dict(state.scaler),
                "master": multi_tensor.tree_map(host, state.master),
                "inner": multi_tensor.tree_map(host, state.inner)}

    def load_state_dict(self, d: dict, state: BF16OptState) -> BF16OptState:
        """Restore into a freshly initialised state's dtypes and devices
        (ref fp16_optimizer.py:230-252)."""
        def restore(tmpl, val):
            return multi_tensor.tree_map(
                lambda t, v: torch.as_tensor(v).to(dtype=t.dtype,
                                                   device=t.device),
                tmpl, val)
        dev = state.scaler.loss_scale.device
        return BF16OptState(
            master=restore(state.master, d["master"]),
            inner=restore(state.inner, d["inner"]),
            scaler=self._scaler().load_state_dict(d["loss_scaler"], dev))
