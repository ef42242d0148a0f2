"""Pipeline parallelism: the GPipe schedule over a ``pipe`` axis.

Counterpart of ``apex_tpu/parallel/pipeline.py``.  Each rank of the axis
holds one stage's parameters; activations move stage to stage with
:func:`~apex_tpu_torch.parallel.mesh.ring_shift`.  With n stages and m
microbatches the schedule runs ``m + n - 1`` ticks; at tick t

- stage 0 takes microbatch t (zeros once the input is drained),
- every stage applies its stage function to what it holds,
- the outputs shift one stage forward (after every tick but the last,
  whose shift JAX's scan makes and discards);

stage n - 1's outputs of ticks ``n - 1 .. n + m - 2`` are the m finished
microbatches, replicated to every stage by one masked
:func:`~apex_tpu_torch.parallel.mesh.psum`.

The backward is autograd through the same graph: each shift's backward
is the reverse shift and the psum's a psum.  Every stage builds the same
graph (every tick computes, the bubble's included, and stage 0's choice
between its feed and what it received is a ``torch.where`` over both, as
in JAX), so every rank meets the backward's collectives in one order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch

from apex_tpu_torch.parallel.mesh import Axis, psum, ring_shift

__all__ = ["pipeline_apply", "stack_stage_params"]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor,
                   axis: Axis) -> torch.Tensor:
    """Run ``stage_fn(stage_params, x)`` as an n-stage pipeline over
    ``axis``.  ``x_microbatches`` (m, mb, ...) is the full input, the
    same on every stage (only stage 0 reads it); every stage's
    activations have its shape.  Returns the (m, mb, ...) outputs of the
    last stage on every stage."""
    n, idx = axis.size, axis.index
    m = x_microbatches.shape[0]
    first = torch.tensor(idx == 0, device=x_microbatches.device)
    holding = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(m + n - 1):
        feed = (x_microbatches[t] if t < m
                else torch.zeros_like(x_microbatches[0]))
        out = stage_fn(stage_params, torch.where(first, feed, holding))
        outs.append(out)
        if t != m + n - 2:
            holding = ring_shift(out, axis, tag="pipe_shift")
    # microbatch j finished on the last stage at tick j + n - 1
    finished = torch.stack(outs[n - 1:])
    mask = float(idx == n - 1)
    return psum(finished * mask, axis, tag="pipe_psum")


def stack_stage_params(params_per_stage: Sequence[Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """Per-stage state dicts stacked along a leading stage axis (stage i
    of the stack is rank i's parameters)."""
    names = list(params_per_stage[0])
    for p in params_per_stage[1:]:
        if list(p) != names:
            raise ValueError("stages hold different parameter names")
    return {k: torch.stack([p[k] for p in params_per_stage])
            for k in names}
