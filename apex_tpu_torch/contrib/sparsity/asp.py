"""ASP — automatic 2:4 structured sparsity over the port's parameter
dicts.

Counterpart of ``apex_tpu/contrib/sparsity/asp.py`` (ref
apex/contrib/sparsity/asp.py).  The reference registers mask buffers on
torch modules and patches ``optimizer.step`` so grads are masked before
the step and params after it (asp.py:139-152).  The JAX package, and the
port after it, express the same contract as data:

- masks are a dict congruent with the params (name -> mask tensor, or
  ``None`` at a dense leaf),
- :func:`sparsify` wraps a transform; its state carries the masks, and
  its update masks the grads before and the updates after the inner
  transform, so a masked param stays masked,
- :meth:`ASP.compute_sparse_masks` / :meth:`ASP.restore_pruned_weights`
  mirror asp.py:155-188 and return new dicts instead of mutating.

Parameter names are ``named_parameters()`` keys, joined by ``.``
(``encoder.layers.0.ffn_in.kernel``), where the JAX package's paths are
joined by ``/``: eligibility reads the last component as the leaf name
and matches the allow and deny regexes against the rest, the layer path
(``encoder.layers.0.ffn_in``).  Eligible leaves mirror asp.py:91-124:
the weight matrices of Dense and Conv layers (leaf name ``kernel``, in
flax's (in, out) and HWIO layouts, which the port keeps), with the
tensor-core size gates (output dim % 8, reduction dim % 16).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch

from apex_tpu_torch.amp.scaler import apply_if_finite
from apex_tpu_torch.contrib.sparsity.sparse_masklib import create_mask
from apex_tpu_torch.optimizers._common import Transformation, gates_overflow

__all__ = ["ASP", "SparsityState", "sparsify"]

Masks = Dict[str, Optional[torch.Tensor]]


def _mask_tree(masks: Mapping[str, Optional[torch.Tensor]],
               tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """tree * mask at sparse leaves, the leaf itself at dense (None-mask)
    ones."""
    return {k: t if masks[k] is None else t * masks[k].to(t.dtype)
            for k, t in tree.items()}


class SparsityState(NamedTuple):
    """State of a :func:`sparsify`-wrapped transform: inner state + masks."""

    inner: Any
    masks: Masks


def sparsify(tx) -> Transformation:
    """Wrap the transform ``tx`` so masked params stay masked across
    updates (ref asp.py:139-152, ``__step``): grads are masked before the
    inner update and the updates after it.  Masks start disabled (all
    ``None``); install them with :meth:`ASP.enable`.

    The result is a plain :class:`Transformation`, so
    :class:`~apex_tpu_torch.amp.AmpOptimizer` takes its unfused route, as
    the JAX package's does for an optax wrapper.  It gates itself on
    ``found_inf``: an inner transform that gates itself (an AMP-fused
    one, which may update its state in place) gets ``found_inf``; any
    other has its new state and updates gated here."""

    def init_fn(params: Mapping[str, torch.Tensor]) -> SparsityState:
        return SparsityState(inner=tx.init(params),
                             masks={k: None for k in params})

    def update_fn(grads: Mapping[str, torch.Tensor], state: SparsityState,
                  params: Optional[Mapping[str, torch.Tensor]] = None, *,
                  found_inf: Optional[torch.Tensor] = None):
        grads = _mask_tree(state.masks, grads)
        if found_inf is not None and gates_overflow(tx):
            updates, inner = tx.update(grads, state.inner, params,
                                       found_inf=found_inf)
        else:
            updates, inner = tx.update(grads, state.inner, params)
            if found_inf is not None:
                inner = apply_if_finite(found_inf, inner, state.inner)
                updates = {k: torch.where(found_inf, 0.0, u).to(u.dtype)
                           for k, u in updates.items()}
        return (_mask_tree(state.masks, updates),
                SparsityState(inner=inner, masks=state.masks))

    return Transformation(init_fn, update_fn, gates_overflow=True)


class ASP:
    """Functional ASP manager.  ref asp.py:21-216 (a classmethod
    singleton there).

    Typical flow (ref asp.py:38-50)::

        asp = ASP()
        tx = sparsify(fused_adam(1e-3))
        masks, pruned = asp.compute_sparse_masks(params)
        params = asp.apply_masks(params, masks)
        state = asp.enable(tx.init(params), masks)
        # ... train; params remain 2:4 sparse through every step.

    ``custom_layout`` maps a regex over the parameter name to a
    ``create_mask`` layout (first match wins)."""

    def __init__(self, mask_calculator="m4n2_1d", verbosity: int = 0,
                 param_names: tuple = ("kernel",),
                 allowed_layer_names: Optional[list] = None,
                 disallowed_layer_names: tuple = (),
                 allow_recompute_mask: bool = False,
                 custom_layout: Optional[dict] = None):
        if callable(mask_calculator):
            self._calc = mask_calculator
        else:
            self._calc = lambda p, layout: create_mask(
                p, pattern=mask_calculator, layout=layout)
        self.verbosity = verbosity
        self.param_names = tuple(param_names)
        self.allowed = allowed_layer_names
        self.disallowed = tuple(disallowed_layer_names)
        self.allow_recompute_mask = allow_recompute_mask
        self.custom_layout = dict(custom_layout or {})

    # -- eligibility ------------------------------------------------------
    def _eligible(self, path: str, leaf: torch.Tensor) -> bool:
        name = path.rsplit(".", 1)[-1]
        if name not in self.param_names:
            return False
        layer = path.rsplit(".", 1)[0]
        if any(re.search(d, layer) for d in self.disallowed):
            return False
        if self.allowed is not None and not any(
                re.search(a, layer) for a in self.allowed):
            return False
        if leaf.dim() < 2:
            return False
        layout = self._layout(path, leaf)
        if leaf.dim() not in (2, 4) and layout is None:
            # ref asp.py:84-86 prunes only Linear/Conv weights (2d/4d); a
            # rank-3 kernel has ambiguous reduction axes: only through an
            # explicit custom_layout entry
            return False
        nin, nout = self._in_out_dims(leaf, layout)
        # ref asp.py:100-105 tensor-core size gate (torch (out,in) % (8,16))
        if nout % 8 != 0 or nin % 16 != 0:
            if self.verbosity >= 2:
                print(f"[ASP] auto-skipping {path} shape={tuple(leaf.shape)}")
            return False
        return True

    def _layout(self, path: str, leaf: torch.Tensor) -> Optional[str]:
        for pat, layout in self.custom_layout.items():
            if re.search(pat, path):
                return layout
        if leaf.dim() == 2:
            return "io"  # flax Dense (in, out)
        if leaf.dim() == 4:
            return "hwio"  # flax Conv
        return None

    @staticmethod
    def _in_out_dims(leaf: torch.Tensor, layout: Optional[str]):
        """(reduction_dim, output_dim) under the layout the mask will use."""
        if layout == "io":
            return leaf.shape[0], leaf.shape[1]
        if layout == "oi":
            return leaf.shape[1], leaf.shape[0]
        if layout == "hwio":
            return leaf.shape[2], leaf.shape[3]
        if layout == "oihw":
            return leaf.shape[1], leaf.shape[0]
        return leaf.shape[-2], leaf.shape[-1]

    # -- mask lifecycle ---------------------------------------------------
    def compute_sparse_masks(self, params: Mapping[str, torch.Tensor],
                             pruned: Optional[Masks] = None):
        """Fresh masks (and the pruned stash) for every eligible leaf.

        ref asp.py:155-173.  With ``pruned`` (an earlier stash) the dense
        values are restored first, the recompute path of asp.py:161-164.
        Returns ``(masks, pruned)``: masks hold a tensor at sparse leaves
        and ``None`` elsewhere; pruned holds the masked-out values iff
        ``allow_recompute_mask`` (else all ``None``)."""
        if pruned is not None:
            params = self.restore_pruned_weights(params, pruned)
        masks: Masks = {}
        stash: Masks = {}
        for path, leaf in params.items():
            if not self._eligible(path, leaf):
                masks[path] = stash[path] = None
                continue
            mask = self._calc(leaf, self._layout(path, leaf))
            masks[path] = mask
            stash[path] = (leaf * (1 - mask.to(leaf.dtype))
                           if self.allow_recompute_mask else None)
            if self.verbosity >= 2:
                frac = float(mask.float().mean())
                print(f"[ASP] {100 * frac:.1f}% density for {path} "
                      f"{tuple(leaf.shape)}")
        return masks, stash

    @staticmethod
    def apply_masks(params: Mapping[str, torch.Tensor], masks: Masks
                    ) -> Dict[str, torch.Tensor]:
        """Prune: params * mask at sparse leaves.  ref asp.py:171."""
        return _mask_tree(masks, params)

    @staticmethod
    def enable(state: SparsityState, masks: Masks) -> SparsityState:
        """Install masks into a :func:`sparsify` state (turn sparsity on)."""
        return state._replace(masks=masks)

    @staticmethod
    def restore_pruned_weights(params: Mapping[str, torch.Tensor],
                               pruned: Masks) -> Dict[str, torch.Tensor]:
        """params + stash: undo pruning.  ref asp.py:176-188."""
        return {k: p if pruned[k] is None else p + pruned[k].to(p.dtype)
                for k, p in params.items()}

    @staticmethod
    def is_sparsity_enabled(masks: Masks) -> bool:
        """True iff every mask is exactly half dense, False when there is
        no mask or every mask is all ones; any other mix raises.  ref
        asp.py:191-209."""
        leaves = [m for m in masks.values() if m is not None]
        if not leaves:
            return False
        sums = [float(m.float().sum()) for m in leaves]
        if all(s == m.numel() for s, m in zip(sums, leaves)):
            return False
        if all(s * 2 == m.numel() for s, m in zip(sums, leaves)):
            return True
        raise AssertionError("Inconsistent model sparsity")

    def prune_trained_model(self, params: Mapping[str, torch.Tensor], tx):
        """One-call recipe.  ref asp.py:212-216.

        Returns ``(pruned_params, wrapped_tx, state)`` with the masks
        installed in ``state``."""
        wrapped = sparsify(tx)
        masks, _ = self.compute_sparse_masks(params)
        params = self.apply_masks(params, masks)
        state = self.enable(wrapped.init(params), masks)
        return params, wrapped, state
