"""Weight-norm reparameterization over the port's parameter maps.

Counterpart of ``apex_tpu/reparameterization/__init__.py`` (ref
apex/reparameterization/: ``apply/remove_weight_norm`` and the
forward-pre-hook that recomputes ``w = g * v / ||v||`` before each call).
The reference rewrites modules; here, as in the JAX package, the same
factorisation is data, over a name -> tensor map (a ``state_dict`` or a
masters dict):

- :func:`apply_weight_norm` replaces each selected ``name`` with
  ``name_g`` and ``name_v`` (torch's naming);
- :func:`compute_weights` folds every ``_g``/``_v`` pair back into its
  weight, differentiably: call it at the top of the forward, and autograd
  gives g and v the reference's gradients;
- :func:`remove_weight_norm` folds the selected pairs for good.

The norm axis keeps the JAX package's meaning: ``dim`` is the axis the
norm is NOT taken over, and the default -1 is the output axis of a flax
``(in, out)`` kernel, one norm per output channel (torch's
``weight_norm`` defaults to ``dim=0`` on its ``(out, in)`` layout, the
same channels); ``dim=None`` takes one norm over the whole tensor.
Norms are computed in fp32 and the weight returned in v's dtype.
``name`` is a regular expression searched in the parameter's path with
``/`` between its parts (``"layer_0/kernel"`` for ``layer_0.kernel``),
the JAX package's rule; ``""`` selects every tensor of two or more
dimensions.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import torch

__all__ = ["apply_reparameterization", "apply_weight_norm",
           "compute_weights", "norm_except_axis", "remove_reparameterization",
           "remove_weight_norm", "weight_norm"]

_G_SUFFIX = "_g"
_V_SUFFIX = "_v"

Params = Mapping[str, torch.Tensor]


def norm_except_axis(v: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """fp32 L2 norm over every axis but ``axis`` (kept as size 1
    elsewhere); ``axis=None``: one norm, shaped (1,) * ndim (ref
    weight_norm.py:8-18)."""
    v32 = v.float()
    if axis is None:
        return torch.sqrt(torch.sum(v32 * v32)).reshape((1,) * v.dim())
    axis = axis % v.dim()
    dims = tuple(i for i in range(v.dim()) if i != axis)
    if not dims:  # a vector's own axis: torch.sum(dim=()) would take all
        return torch.sqrt(v32 * v32)
    return torch.sqrt(torch.sum(v32 * v32, dim=dims, keepdim=True))


def weight_norm(v: torch.Tensor, g: torch.Tensor,
                axis: Optional[int] = -1) -> torch.Tensor:
    """``g * v / ||v||`` in fp32, in v's dtype (ref weight_norm.py:39-60).
    A ``g`` whose shape is not the norm's for ``axis`` raises: it would
    broadcast into wrong weights."""
    n = norm_except_axis(v, axis)
    if tuple(g.shape) != tuple(n.shape):
        raise ValueError(
            f"weight_norm: g shape {tuple(g.shape)} does not match the norm "
            f"shape {tuple(n.shape)} for axis={axis}; was apply_weight_norm "
            "called with a different dim?")
    return (g.float() * (v.float() / n)).to(v.dtype)


def _matches(name: str, pattern: str) -> bool:
    return not pattern or re.search(pattern, name.replace(".", "/")) is not None


def apply_weight_norm(params: Params, name: str = "",
                      dim: Optional[int] = -1) -> Dict[str, torch.Tensor]:
    """A new map with each selected tensor ``k`` (two or more dimensions,
    ``name`` matching) replaced, in place in the order, by ``k_g`` (its
    norm, in its dtype) and ``k_v`` (the tensor).  Raises if a selected
    tensor already has its ``_g``/``_v`` pair (ref __init__.py:4-48)."""
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in params.items():
        if key.endswith(_V_SUFFIX):
            base = key[:-len(_V_SUFFIX)]
            if base + _G_SUFFIX in params and _matches(base, name):
                raise ValueError(f"weight norm already applied to {base}")
        if (key.endswith((_G_SUFFIX, _V_SUFFIX)) or leaf.dim() < 2
                or not _matches(key, name)):
            out[key] = leaf
            continue
        if key + _G_SUFFIX in params:
            raise ValueError(f"weight norm already applied to {key}")
        out[key + _G_SUFFIX] = norm_except_axis(leaf, dim).to(leaf.dtype)
        out[key + _V_SUFFIX] = leaf
    return out


def _fold(params: Params, name: str, dim: Optional[int]
          ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for key, leaf in params.items():
        base = key[:-len(_G_SUFFIX)]
        if key.endswith(_G_SUFFIX) and base + _V_SUFFIX in params \
                and _matches(base, name):
            out[base] = weight_norm(params[base + _V_SUFFIX], leaf, dim)
        elif not (key.endswith(_V_SUFFIX)
                  and key[:-len(_V_SUFFIX)] + _G_SUFFIX in params
                  and _matches(key[:-len(_V_SUFFIX)], name)):
            out[key] = leaf
    return out


def compute_weights(params: Params, dim: Optional[int] = -1
                    ) -> Dict[str, torch.Tensor]:
    """Every ``_g``/``_v`` pair folded back into its weight,
    differentiably (the reference's forward-pre-hook,
    reparameterization.py:119-128)::

        def forward(wn_params, x):
            return torch.func.functional_call(model, compute_weights(
                wn_params), (x,))
    """
    return _fold(params, "", dim)


def remove_weight_norm(params: Params, name: str = "",
                       dim: Optional[int] = -1) -> Dict[str, torch.Tensor]:
    """The selected pairs (all with ``name=""``) folded into plain
    weights for good (ref __init__.py:50-63); the inverse of
    :func:`apply_weight_norm` up to rounding."""
    return _fold(params, name, dim)


# the reference's generic entry points (weight norm is the one
# reparameterization it ships)
apply_reparameterization = apply_weight_norm
remove_reparameterization = remove_weight_norm
