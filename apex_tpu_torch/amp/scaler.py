"""Loss scaling as device state.

Counterpart of ``apex_tpu/amp/scaler.py``.  The scale, the count of
clean steps and the count of overflows are 0-d tensors on the device,
and :meth:`LossScaler.update` is a where-gated function of them, so a
training step never reads the overflow flag on the host.  The policy
constants are the reference's: initial dynamic scale 2^16, x2 after
``scale_window=2000`` clean steps, x0.5 on overflow, capped at 2^24,
floored at ``min_loss_scale`` (1.0 when None).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Tuple, TypeVar, Union

import torch

from apex_tpu_torch import multi_tensor
from apex_tpu_torch.ops._common import resolve_device

__all__ = ["LossScaler", "LossScalerState", "apply_if_finite"]

Tree = TypeVar("Tree")


class LossScalerState(NamedTuple):
    """Checkpointable device state of one loss scaler (one per loss)."""

    loss_scale: torch.Tensor  # f32 0-d
    unskipped: torch.Tensor   # i32 0-d, clean steps since the last change
    overflows: torch.Tensor   # i32 0-d, total skipped steps


@dataclasses.dataclass(frozen=True)
class LossScaler:
    """Static scaler config plus pure functions over
    :class:`LossScalerState`.  ``loss_scale="dynamic"`` scales
    dynamically; a float is a static scale (overflow still skips the
    step, the scale never changes)."""

    loss_scale: Union[str, float] = "dynamic"
    init_scale: float = 2.0 ** 16
    scale_factor: float = 2.0
    scale_window: int = 2000
    max_loss_scale: float = 2.0 ** 24
    min_loss_scale: Optional[float] = None

    @property
    def dynamic(self) -> bool:
        return self.loss_scale == "dynamic"

    def init(self, device=None) -> LossScalerState:
        """Fresh state on ``device`` (None: the CUDA device)."""
        dev = resolve_device(device)
        scale = self.init_scale if self.dynamic else float(self.loss_scale)
        return LossScalerState(
            loss_scale=torch.tensor(scale, dtype=torch.float32, device=dev),
            unskipped=torch.zeros((), dtype=torch.int32, device=dev),
            overflows=torch.zeros((), dtype=torch.int32, device=dev))

    def scale_loss(self, loss: torch.Tensor,
                   state: LossScalerState) -> torch.Tensor:
        """``loss * scale`` in fp32."""
        return loss.float() * state.loss_scale

    def unscale(self, grads: Tree, state: LossScalerState
                ) -> Tuple[Tree, torch.Tensor]:
        """Scaled grads -> fp32 master grads and the found_inf flag."""
        return multi_tensor.multi_tensor_unscale(grads,
                                                 1.0 / state.loss_scale)

    def unscale_with_stashed(self, new_scaled_grads: Tree,
                             stashed_master_grads: Tree,
                             state: LossScalerState
                             ) -> Tuple[Tree, torch.Tensor]:
        """The accumulation merge ``new * (1 / scale) + stashed`` in fp32
        (ref apex/amp/scaler.py:152-189, ``multi_tensor_axpby`` with
        ``a = 1/scale``, ``b = 1``), with found_inf over the output."""
        return multi_tensor.multi_tensor_axpby(
            new_scaled_grads, stashed_master_grads, 1.0 / state.loss_scale,
            1.0, check="both")

    def update(self, state: LossScalerState,
               found_inf: torch.Tensor) -> LossScalerState:
        """The scale update, where-gated (ref apex/amp/scaler.py:197-217):
        overflow halves the scale (floored) and resets the clean-step
        count; a clean step counts, and at ``scale_window`` the scale
        doubles (capped) and the count resets."""
        overflows = state.overflows + found_inf.to(torch.int32)
        if not self.dynamic:
            return state._replace(overflows=overflows)
        min_scale = (self.min_loss_scale if self.min_loss_scale is not None
                     else 1.0)
        backed_off = torch.clamp_min(state.loss_scale / self.scale_factor,
                                     min_scale)
        unskipped = torch.where(found_inf, 0, state.unskipped + 1)
        grow = unskipped >= self.scale_window
        grown = torch.clamp_max(state.loss_scale * self.scale_factor,
                                self.max_loss_scale)
        new_scale = torch.where(found_inf, backed_off,
                                torch.where(grow, grown, state.loss_scale))
        return LossScalerState(
            loss_scale=new_scale,
            unskipped=torch.where(grow, 0, unskipped).to(torch.int32),
            overflows=overflows)

    def state_dict(self, state: LossScalerState) -> dict:
        """Host copy for a checkpoint (one device read)."""
        return {"loss_scale": float(state.loss_scale),
                "unskipped": int(state.unskipped),
                "overflows": int(state.overflows)}

    def load_state_dict(self, d: Mapping, device=None) -> LossScalerState:
        dev = resolve_device(device)
        return LossScalerState(
            loss_scale=torch.tensor(float(d["loss_scale"]),
                                    dtype=torch.float32, device=dev),
            unskipped=torch.tensor(int(d["unskipped"]), dtype=torch.int32,
                                   device=dev),
            overflows=torch.tensor(int(d.get("overflows", 0)),
                                   dtype=torch.int32, device=dev))


def apply_if_finite(found_inf: torch.Tensor, new_tree: Tree,
                    old_tree: Tree) -> Tree:
    """Select ``old`` wholesale on overflow: the skip step as a where
    gate over matching trees of tensors (nested dicts, lists, tuples,
    NamedTuples).  ``new`` must hold tensors of its own: a leaf that
    aliases its ``old`` counterpart (state updated in place) has already
    lost the old value."""
    return multi_tensor.tree_map(
        lambda n, o: torch.where(found_inf, o, n.to(o.dtype)),
        new_tree, old_tree)
