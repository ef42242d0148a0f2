"""Expert parallelism: a Mixture-of-Experts FFN with all-to-all dispatch.

Counterpart of ``apex_tpu/parallel/moe.py`` (no apex counterpart).  Each
rank of an ``expert`` :class:`~apex_tpu_torch.parallel.mesh.Axis` holds
``num_experts / n`` expert FFNs; tokens are routed by a top-k gate, and
two all-to-alls move each token to its expert's rank and back (the
Switch / GShard construction, in the Mesh-TensorFlow einsum form):

- router: ``gates = softmax(x @ wg)`` in fp32; the top k experts a
  token, their gates renormalised over the k;
- capacity: each expert takes at most ``C = ceil(k T cf / E)`` tokens of
  a rank's batch, claimed slot-major (every token's first choice before
  any second choice) in token order; the rest are dropped (their
  combine weight is 0: the caller's residual path carries them);
- dispatch ``(T, E, C)`` is 0/1 and combine holds the gate weights;
  ``expert_in = einsum("td,tec->ecd")``, an all-to-all ``(E, C, d) ->
  (E / n, n C, d)``, the experts' FFN, the inverse all-to-all, and the
  fp32 combine einsum back to ``(T, d)``;
- the Switch aux loss ``E sum_e f_e P_e`` (``f``: the share of first
  choices, ``P``: the mean gate) is this rank's; mean it over the data
  axis with the rest of the loss.

Ties: ``jax.lax.top_k`` keeps the lower expert index first among equal
gates, and ``torch.topk`` promises no order, so the port ranks the gates
by a stable descending sort, which keeps JAX's choice.  The dispatch
tensor is built by scattering each kept (token, slot) claim into its
(expert, position) cell, the same 0/1 tensor JAX's one-hot product
makes.  Everything is differentiable: the all-to-alls' backward is the
reverse all-to-all, and router and experts train together.  No Pallas
kernel runs here in JAX either; this is einsums and collectives.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel.mesh import Axis, all_to_all

__all__ = ["MoEMLP", "moe_mlp_ref", "top_k_routing"]


def _gelu(t: torch.Tensor) -> torch.Tensor:
    return F.gelu(t, approximate="tanh")  # flax nn.gelu's default


def _top_k(gates: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_routing(logits: torch.Tensor, k: int, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k gating with capacity.  ``logits`` (T, E); returns dispatch
    (T, E, C) 0/1, combine (T, E, C) gate weights and the aux loss, all
    fp32."""
    t, e = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    top_gates, top_idx = _top_k(gates, k)  # (T, k)
    top_gates = top_gates / top_gates.sum(dim=-1, keepdim=True)
    sel = F.one_hot(top_idx.T, e).float()  # (k, T, E), slot-major
    flat = sel.reshape(k * t, e)
    pos = torch.cumsum(flat, dim=0) - flat  # claims strictly before
    keep = flat * (pos < capacity)
    # each (slot, token) claims one expert: scatter its kept claim into
    # (token, expert, position)
    slot_pos = (pos * flat).sum(dim=-1).long()  # (k T,)
    kept = keep.sum(dim=-1)                     # (k T,) 0 or 1
    tok = torch.arange(t, device=logits.device).repeat(k)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=logits.device)
    dispatch.index_put_(
        (tok, top_idx.T.reshape(-1), slot_pos.clamp(max=capacity - 1)),
        kept, accumulate=True)
    weight = torch.einsum("kte,tk->te", sel, top_gates)
    combine = dispatch * weight[:, :, None]
    f = sel[0].mean(dim=0)
    p = gates.mean(dim=0)
    aux = e * torch.sum(f * p)
    return dispatch, combine, aux


class MoEMLP(nn.Module):
    """The expert-parallel MoE FFN.

    ``num_experts`` is the global count; over ``axis`` (an ``expert``
    :class:`Axis`, or None for one rank) this rank holds ``num_experts /
    n`` experts as ``wi`` (E_local, d, d_ff) and ``wo`` (E_local, d_ff,
    d) in ``param_dtype``, and the fp32 ``router`` (d, E) replicated.
    ``forward(x)`` takes this rank's (T, d) tokens and returns ``(y (T,
    d), aux)``.  With ``generator`` the weights are drawn as flax's
    ``lecun_normal`` scale (normal, std ``1 / sqrt(fan_in)``); else they
    are left for ``load_state_dict``
    (:func:`apex_tpu_torch.weights.from_jax_moe_params`)."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 axis: Optional[Axis] = None, *, k: int = 2,
                 capacity_factor: float = 2.0,
                 activation: Callable = _gelu,
                 param_dtype: torch.dtype = torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        n = 1 if axis is None else axis.size
        if num_experts % n:
            raise ValueError(f"num_experts ({num_experts}) must be "
                             f"divisible by num_partitions ({n})")
        self.num_experts, self.axis, self.k = num_experts, axis, int(k)
        self.capacity_factor = float(capacity_factor)
        self.activation, self.compute_dtype = activation, compute_dtype
        e_local = num_experts // n
        self.router = nn.Parameter(torch.empty(d_model, num_experts,
                                               device=device))
        self.wi = nn.Parameter(torch.empty(e_local, d_model, d_ff,
                                           dtype=param_dtype, device=device))
        self.wo = nn.Parameter(torch.empty(e_local, d_ff, d_model,
                                           dtype=param_dtype, device=device))
        if generator is not None:
            with torch.no_grad():
                for w, fan_in in ((self.router, d_model), (self.wi, d_model),
                                  (self.wo, d_ff)):
                    w.copy_(torch.empty(w.shape, device=generator.device)
                            .normal_(0.0, fan_in ** -0.5, generator=generator))

    def capacity(self, tokens: int) -> int:
        """Slots an expert takes of ``tokens``: ``ceil(k T cf / E)``."""
        return max(1, math.ceil(self.k * tokens * self.capacity_factor
                                / self.num_experts))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t, _ = x.shape
        # the router in fp32, whatever the compute dtype
        logits = x.float() @ self.router.float()
        dispatch, combine, aux = top_k_routing(logits, self.k,
                                               self.capacity(t))
        cdt = self.compute_dtype or x.dtype
        expert_in = torch.einsum("td,tec->ecd", x, dispatch.to(x.dtype))
        spread = self.axis is not None and self.axis.size > 1
        if spread:  # (E, C, d) -> (E_local, n C, d)
            expert_in = all_to_all(expert_in, self.axis, 0, 1,
                                   tag="moe_dispatch")
        h = torch.bmm(expert_in.to(cdt), self.wi.to(cdt))
        out = torch.bmm(self.activation(h), self.wo.to(cdt))
        if spread:  # (E_local, n C, d) -> (E, C, d)
            out = all_to_all(out, self.axis, 1, 0, tag="moe_combine")
        y = torch.einsum("ecd,tec->td", out.float(), combine)
        return y.to(x.dtype), aux


def moe_mlp_ref(x: torch.Tensor, params, num_experts: int, k: int,
                activation: Callable = _gelu) -> torch.Tensor:
    """Dense reference, no capacity and no drops: every token through
    every expert, weighted by its renormalised top-k gates.
    ``params``: ``router`` (d, E), ``wi`` (E, d, d_ff), ``wo`` (E, d_ff,
    d)."""
    wg, w1, w2 = params["router"], params["wi"], params["wo"]
    gates = torch.softmax(x.float() @ wg.float(), dim=-1)
    top_gates, top_idx = _top_k(gates, k)
    top_gates = top_gates / top_gates.sum(dim=-1, keepdim=True)
    h = torch.einsum("td,edf->tef", x, w1.to(x.dtype))
    y_all = torch.einsum("tef,efd->ted", activation(h), w2.to(x.dtype))
    w = torch.einsum("tke,tk->te", F.one_hot(top_idx, num_experts).float(),
                     top_gates)
    return torch.einsum("ted,te->td", y_all.float(), w).to(x.dtype)
