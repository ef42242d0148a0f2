"""apex_tpu_torch.amp — mixed precision for PyTorch training loops.

Counterpart of ``apex_tpu/amp/__init__.py``.  Under O2 (apex's own
design) the model holds half-precision parameters that receive the
scaled gradients, and the optimizer holds the fp32 master weights,
updates them and copies them back into the model after each step::

    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_adam(6e-4, weight_decay=0.1), amp_)
    masters = opt.attach(model)       # fp32 masters; model cast to bf16
    state = opt.init(masters)         # Adam state + loss-scaler state

    with amp_.autocast():             # a no-op context under O0/O2/O3
        _, loss = model(ids, labels)
    scaled = amp_.scale_loss(loss, state.scaler[0])
    grads = dict(zip(names, torch.autograd.grad(scaled, params)))
    masters, state, stats = opt.step(grads, state, masters, model=model)

Under O1 (``amp.initialize()``'s default) the model keeps fp32
parameters and is built with an fp32 compute dtype; inside
``amp_.autocast()`` the cast tables (:mod:`amp.functional`,
:mod:`amp.lists`) run its products in bf16 and its softmax, norms and
losses in fp32.  ``accumulate`` adds a loss's unscaled grads to an fp32
stash without stepping (several losses, or microbatches with
``update_scaler=False``); the next ``step`` adds its own grads to the
stash and takes the unfused route.

Every piece of state is a tensor on the device and the overflow skip is
a where gate: a step reads nothing on the host.  After a checkpoint
restore under O2, call :meth:`AmpOptimizer.copy_to_model` before the
first step: the model's half copy is derived from the masters and is not
part of the saved state.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch import multi_tensor
from apex_tpu_torch.amp import functional as F  # noqa: F401
from apex_tpu_torch.amp import layers, lists  # noqa: F401
from apex_tpu_torch.amp.functional import (  # noqa: F401
    autocast,
    current_policy,
    disable_casts,
    float_function,
    half_function,
    promote_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.layers import Conv, ConvTranspose, Dense  # noqa: F401
from apex_tpu_torch.amp.policy import (  # noqa: F401
    O0,
    O1,
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
from apex_tpu_torch.optimizers._common import (AmpFusedTransformation,
                                               gates_overflow)

__all__ = [
    "Amp", "AmpOptState", "AmpOptimizer", "Conv", "ConvTranspose", "Dense",
    "F", "LossScaler", "LossScalerState", "O0", "O1", "O2", "O3", "Policy",
    "StepStats",
    "apply_if_finite", "autocast", "current_policy", "default_is_batchnorm",
    "disable_casts", "float_function", "half_function", "initialize",
    "make_policy", "master_params", "maybe_print", "opt_levels",
    "promote_function", "register_float_function", "register_half_function",
    "register_promote_function", "set_verbosity", "warn_once",
]

_amp_verbosity = 1
_warned_once: set = set()


def set_verbosity(v: int) -> None:
    """ref apex/amp/frontend.py's verbosity (0 silences
    :func:`maybe_print`)."""
    global _amp_verbosity
    _amp_verbosity = v


def _rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def maybe_print(msg: str, rank0: bool = True) -> None:
    """Print unless silenced; by default on rank 0 only (ref
    apex/amp/_amp_state.py:38-50)."""
    if _amp_verbosity <= 0:
        return
    if rank0 and _rank() != 0:
        return
    print(msg)


def warn_once(key: str, msg: str) -> None:
    """:func:`maybe_print` at most once per process per ``key``: for
    accepted knobs that do nothing here."""
    if key in _warned_once:
        return
    _warned_once.add(key)
    maybe_print(msg)


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

    def autocast(self):
        """The cast tables for everything run inside the block when the
        policy uses autocast (O1), else a no-op context, so training code
        can wrap its forward whatever the opt level::

            with amp_.autocast():
                _, loss = model(ids, labels)
        """
        if self.policy.enabled and self.policy.autocast:
            return autocast(self.policy)
        return contextlib.nullcontext()

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
        identity under O0 and O1."""
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

    def cast_output(self, out: Any) -> Any:
        """The model's float outputs cast to ``cast_model_outputs`` (ref
        apex/amp/_initialize.py:190-201); unchanged when it is None."""
        dtype = self.policy.cast_model_outputs
        if dtype is None:
            return out
        return multi_tensor.tree_map(
            lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
            and x.is_floating_point() else x, out)

    def state_dict(self, states) -> dict:
        return {f"loss_scaler{i}": s.state_dict(st)
                for i, (s, st) in enumerate(zip(self.scalers, states))}

    def load_state_dict(self, d: Mapping, device=None):
        return tuple(s.load_state_dict(d[f"loss_scaler{i}"], device)
                     for i, s in enumerate(self.scalers))


def initialize(
    opt_level: str = "O1",
    num_losses: int = 1,
    enabled: bool = True,
    cast_model_dtype=None,
    keep_batchnorm_fp32: Optional[bool] = None,
    loss_scale=None,
    cast_model_outputs=None,
    min_loss_scale: Optional[float] = None,
    max_loss_scale: float = 2.0 ** 24,
) -> Amp:
    """Build an :class:`Amp` context (ref apex/amp/frontend.py:195-358)
    for ``opt_level`` 'O0'-'O3'.  Pair it with :class:`AmpOptimizer`,
    which casts the model."""
    policy = make_policy(
        opt_level, cast_model_dtype=cast_model_dtype,
        keep_batchnorm_fp32=keep_batchnorm_fp32, loss_scale=loss_scale,
        cast_model_outputs=cast_model_outputs)
    if not enabled:
        policy = policy.replace(enabled=False, loss_scale=1.0)
    kw = dict(max_loss_scale=max_loss_scale, min_loss_scale=min_loss_scale)
    return Amp(policy=policy,
               scalers=tuple(policy.make_scaler(**kw)
                             for _ in range(num_losses)))


class AmpOptState(NamedTuple):
    opt_state: Any  # the inner optimizer's state, over the fp32 masters
    scaler: Tuple[LossScalerState, ...]
    # the accumulated fp32 master grads (name -> tensor) of accumulate(),
    # or None
    stash: Optional[Dict[str, torch.Tensor]] = None


class StepStats(NamedTuple):
    found_inf: torch.Tensor   # bool 0-d: this step was skipped
    loss_scale: torch.Tensor  # f32 0-d: the scale after the update
    # f32 0-d: the global L2 norm of the unscaled master grads, or None
    # unless the optimizer was built with track_grad_norm=True
    grad_norm: Optional[torch.Tensor] = None


def _replace(scalers, loss_id: int, new: LossScalerState):
    return tuple(new if i == loss_id else s for i, s in enumerate(scalers))


class AmpOptimizer:
    """Master weights and loss scaling around an optimizer transform (ref
    apex/amp/_process_optimizer.py).

    ``tx`` is any transform with ``init(params)`` and ``update(grads,
    state, params) -> (updates, state)`` (see
    :mod:`apex_tpu_torch.optimizers._common`).  ``step`` takes one of two
    routes:

    - AMP-fused (no stash, ``tx`` an :class:`AmpFusedTransformation`):
      the overflow check as one max-abs reduction over the scaled grads,
      then the transform's own fused unscale, update and gate;
    - unfused (a stash, or any other transform): the unscale (merged
      with the stash), ``tx.update`` on the fp32 master grads, the state
      and updates gated on found_inf, the stash cleared.  An AMP-fused
      transform, or one built with ``gates_overflow`` (``sparsify``),
      gets ``found_inf`` for its own gate here, because it (or the
      transform it wraps) updates state in place (``fused_lamb``'s m and
      v): a gate applied after such an update would choose between two
      names for one tensor.  Any other transform must return new state
      tensors, which :func:`apply_if_finite` gates.

    Either way the masters are updated in place, the scaler is updated,
    and nothing is read on the host.  ``track_grad_norm`` adds the
    unscaled grads' global L2 norm to :class:`StepStats` (one more
    reduction)."""

    def __init__(self, tx, amp_: Amp, *, track_grad_norm: bool = False):
        if not (callable(getattr(tx, "init", None))
                and callable(getattr(tx, "update", None))):
            raise TypeError("AmpOptimizer takes a transform with "
                            "init(params) and update(grads, state, params) "
                            f"(fused_sgd, fused_adam, fused_lamb, ...), got "
                            f"{type(tx).__name__}")
        self.tx = tx
        self.amp = amp_
        self.track_grad_norm = track_grad_norm

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
        """The half model copy (a pure cast; identity under O0 and O1)."""
        return self.amp.cast_model(master_params)

    def _fused(self, scaled_grads, state, master_params, sstate):
        inv_scale = 1.0 / sstate.loss_scale
        # the check sees the UNSCALED magnitudes: max|g| * inv_scale
        maxabs = multi_tensor.multi_tensor_l2norm(scaled_grads, max_norm=True)
        found_inf = torch.logical_not(torch.isfinite(maxabs * inv_scale))
        updates, new_opt_state = self.tx.update(
            scaled_grads, state.opt_state, master_params,
            inv_scale=inv_scale, found_inf=found_inf)
        grad_norm = (multi_tensor.multi_tensor_l2norm(scaled_grads)
                     * inv_scale if self.track_grad_norm else None)
        return updates, new_opt_state, found_inf, grad_norm

    def _unfused(self, scaled_grads, state, master_params, scaler, sstate):
        if state.stash is not None:
            master_grads, found_inf = scaler.unscale_with_stashed(
                scaled_grads, state.stash, sstate)
        else:
            master_grads, found_inf = scaler.unscale(scaled_grads, sstate)
        grad_norm = (multi_tensor.multi_tensor_l2norm(master_grads)
                     if self.track_grad_norm else None)
        if gates_overflow(self.tx):
            updates, new_opt_state = self.tx.update(
                master_grads, state.opt_state, master_params,
                found_inf=found_inf)
        else:
            updates, new_opt_state = self.tx.update(
                master_grads, state.opt_state, master_params)
            new_opt_state = apply_if_finite(found_inf, new_opt_state,
                                            state.opt_state)
            updates = apply_if_finite(
                found_inf, updates,
                multi_tensor.tree_map(torch.zeros_like, updates))
        return updates, new_opt_state, found_inf, grad_norm

    def step(self, scaled_grads: Mapping[str, torch.Tensor],
             state: AmpOptState, master_params: Dict[str, torch.Tensor],
             loss_id: int = 0, model: Optional[nn.Module] = None
             ) -> Tuple[Dict[str, torch.Tensor], AmpOptState, StepStats]:
        """One optimizer step from scaled grads (name -> tensor).

        Returns ``(master_params, state, stats)``.  The masters are
        updated IN PLACE (the returned dict is the one passed in); on
        overflow they and the optimizer state keep their values and the
        scale backs off, with no host read.  The stash, if any, is added
        in and cleared.  With ``model``, the new masters are copied into
        its parameters (cast to their dtypes)."""
        scaler = self.amp.scalers[loss_id]
        sstate = state.scaler[loss_id]
        if state.stash is None and isinstance(self.tx,
                                              AmpFusedTransformation):
            updates, new_opt_state, found_inf, grad_norm = self._fused(
                scaled_grads, state, master_params, sstate)
        else:
            updates, new_opt_state, found_inf, grad_norm = self._unfused(
                scaled_grads, state, master_params, scaler, sstate)
        names = list(master_params)
        torch._foreach_add_([master_params[k] for k in names],
                            [updates[k].to(master_params[k].dtype)
                             for k in names])
        new_sstate = scaler.update(sstate, found_inf)
        if model is not None:
            self.copy_to_model(model, master_params)
        return (master_params,
                AmpOptState(opt_state=new_opt_state,
                            scaler=_replace(state.scaler, loss_id,
                                            new_sstate)),
                StepStats(found_inf=found_inf,
                          loss_scale=new_sstate.loss_scale,
                          grad_norm=grad_norm))

    def accumulate(self, scaled_grads: Mapping[str, torch.Tensor],
                   state: AmpOptState, loss_id: int = 0,
                   update_scaler: bool = True) -> AmpOptState:
        """Add one loss's unscaled grads to the fp32 stash without
        stepping.  Two reference patterns share it:

        - several losses, one optimizer: each loss's ``scale_loss`` exit
          updates its own scaler (ref apex/amp/handle.py:119-127), the
          default ``update_scaler=True``;
        - microbatches of one loss with ``delay_unscale=True`` (ref
          handle.py:75-105), where the scaler waits for the real step:
          ``update_scaler=False``.

        An inf in the stash also trips the next ``step``'s check, so that
        step is skipped either way."""
        scaler = self.amp.scalers[loss_id]
        sstate = state.scaler[loss_id]
        if state.stash is None:
            stashed, found_inf = scaler.unscale(scaled_grads, sstate)
        else:
            stashed, found_inf = scaler.unscale_with_stashed(
                scaled_grads, state.stash, sstate)
        if not update_scaler:
            return state._replace(stash=stashed)
        return state._replace(
            stash=stashed,
            scaler=_replace(state.scaler, loss_id,
                            scaler.update(sstate, found_inf)))

    @staticmethod
    @torch.no_grad()
    def copy_to_model(model: nn.Module,
                      master_params: Mapping[str, torch.Tensor]) -> None:
        """Each master into the model parameter of the same name, cast
        to the parameter's dtype (round to nearest even).  Also the
        resume step after a restore: the model's copy is not saved."""
        params = dict(model.named_parameters())
        names = [n for n in master_params if n in params]
        torch._foreach_copy_([params[n] for n in names],
                             [master_params[n] for n in names])


def master_params(state_or_params):
    """ref apex/amp/_amp_state.py:59-68: the fp32 master tree.  The
    masters are the dict the caller holds; this returns its argument (or
    the ``params`` field of a train-state-like object)."""
    return getattr(state_or_params, "params", state_or_params)
