"""Ulysses sequence parallelism: an all-to-all between sequence and head
shards around one flash attention call.

Counterpart of ``apex_tpu/parallel/ulysses.py`` (DeepSpeed-Ulysses):

1. q, k, v arrive sequence-sharded, (B, H, S/n, D) on each rank;
2. :func:`~apex_tpu_torch.parallel.mesh.all_to_all` splits the heads and
   gathers the sequence: (B, H/n, S, D), the full sequence of this rank's
   head group;
3. :func:`~apex_tpu_torch.ops.attention.flash_attention` runs on it, with
   ``dropout_heads=(H, r H/n)`` so the mask is keyed on global heads and
   equals the unsharded mask bit for bit;
4. the reverse all-to-all gives back (B, H, S/n, D).

Each all-to-all's backward is the reverse all-to-all.  H must divide by
the axis size.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.parallel.mesh import Axis, all_to_all

__all__ = ["ulysses_attention"]


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    causal: bool = False,
    scale: Optional[float] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    probs_bf16: bool = False,
    dq_acc: Optional[bool] = None,
    tag: str = "ulysses",
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``: q, k, v
    are this rank's (B, H, S_local, D) shards in ring order, H divisible
    by the axis size; returns this rank's (B, H, S_local, D) output
    shard.  The all-to-alls are counted under ``tag``."""
    n = axis.size
    b, h, s_local, d = q.shape
    if h % n:
        raise ValueError(
            f"num_heads ({h}) must be divisible by the '{axis.name}' axis "
            f"size ({n}) for Ulysses sequence parallelism; use "
            f"ring_attention otherwise")
    # (B, H, S/n, D) -> (B, H/n, S, D): split heads, gather the sequence
    qh, kh, vh = (all_to_all(t, axis, 1, 2, tag=tag) for t in (q, k, v))
    out = flash_attention(
        qh, kh, vh, causal=causal, scale=scale, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, dropout_heads=(h, axis.index * (h // n)),
        probs_bf16=probs_bf16, dq_acc=dq_acc)
    return all_to_all(out, axis, 2, 1, tag=tag)
