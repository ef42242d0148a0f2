"""Ring attention: exact attention over a sequence-sharded mesh axis.

Counterpart of ``apex_tpu/parallel/ring_attention.py``.  Q, K and V are
sharded along the sequence over an :class:`~apex_tpu_torch.parallel.mesh.
Axis` of n ranks (rank i holds positions ``[i S_local, (i + 1)
S_local)``); the K/V shards travel the ring with
:func:`~apex_tpu_torch.parallel.mesh.ring_shift`, so every rank sees every
key block while holding O(S/n) of the sequence.  Each block is one call
of the flash kernels (:func:`~apex_tpu_torch.ops.attention.
flash_attention_fwd` / ``flash_attention_bwd``, their plain versions on
CPU tensors):

- forward: at ring step i rank r holds the K/V shard of rank ``(r - i)
  mod n`` and runs the block with the seed pack's (row, col) offsets
  ``(r S_local, ((r - i) mod n) S_local)``, so the dropout hash is keyed
  on global positions and the mask is the unsharded one bit for bit.
  The partial outputs merge by the fp32 log-space combine; n - 1 shifts
  of K and V each.
- backward: the global lse makes each block's backward independent
  (``p = exp(s - lse_global)``); dK/dV accumulate in fp32 buffers
  that travel the ring with their K/V shard and land on their
  home rank with the last shift; dQ accumulates locally.  n shifts of
  dK and of dV, n - 1 of K and of V.
- causal: step 0 holds the diagonal block, where row offset == column
  offset makes the kernels' local causal mask the global one; later
  steps hold either a past shard (no mask) or a future one, which is
  skipped in both directions: rank r launches r + 1 of the n blocks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import attention as _attn
from apex_tpu_torch.parallel.mesh import Axis, ring_shift

__all__ = ["ring_attention", "ring_attention_fwd", "ring_attention_ref"]

_NEG_INF = -1e30


def _combine(out32, lse, o_i, lse_i):
    """Two normalised partials merged in log space; ``out32`` stays fp32
    across the ring steps (cast once at the end)."""
    lse_new = torch.logaddexp(lse, lse_i)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lse_i - lse_new)[..., None]
    return out32 * w_old + o_i.float() * w_new, lse_new


def _steps(axis: Axis, s_local: int, causal: bool):
    """``(i, row0, col0, block_causal, run)`` of each ring step on this
    rank: a future block of a causal ring is not run."""
    n, r = axis.size, axis.index
    for i in range(n):
        src = (r - i) % n
        yield (i, r * s_local, src * s_local, causal and i == 0,
               not (causal and i > r))


def _fwd(q3, k3, v3, seed, axis, causal, scale, rate, h_map, probs_bf16,
         tag, fault):
    bh, s_local, d = q3.shape
    out32 = torch.zeros(bh, s_local, d, dtype=torch.float32, device=q3.device)
    lse = torch.full((bh, s_local), _NEG_INF, dtype=torch.float32,
                     device=q3.device)
    kb, vb = k3, v3
    n = axis.size
    for i, row0, col0, blk_causal, run in _steps(axis, s_local, causal):
        if run:
            pack = _attn._pack_seed(seed, row0, col0 + fault.get("col", 0),
                                    h_map[2], device=q3.device)
            o_i, lse_i = _attn.flash_attention_fwd(
                q3, kb, vb, pack, scale,
                blk_causal or fault.get("mask_all", False), rate,
                h_map[:2], probs_bf16=probs_bf16)
            out32, lse = _combine(out32, lse, o_i, lse_i)
        if i != n - 1:
            kb = ring_shift(kb, axis, tag=tag)
            vb = ring_shift(vb, axis, tag=tag)
    return out32.to(q3.dtype), lse


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q3, k3, v3, seed, axis, causal, scale, rate, h_map,
                probs_bf16, dq_acc, tag, fault):
        out, lse = _fwd(q3, k3, v3, seed, axis, causal, scale, rate, h_map,
                        probs_bf16, tag, fault)
        ctx.save_for_backward(q3, k3, v3, seed, out, lse)
        ctx.cfg = (axis, causal, scale, rate, h_map, probs_bf16, dq_acc, tag,
                   fault)
        return out

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, seed, out, lse = ctx.saved_tensors
        (axis, causal, scale, rate, h_map, probs_bf16, dq_acc, tag,
         fault) = ctx.cfg
        n = axis.size
        s_local = q3.shape[1]
        do = do.contiguous()
        dq = torch.zeros_like(q3, dtype=torch.float32)
        kb, vb = k3, v3
        dkb = torch.zeros_like(k3, dtype=torch.float32)
        dvb = torch.zeros_like(v3, dtype=torch.float32)
        for i, row0, col0, blk_causal, run in _steps(axis, s_local, causal):
            if run:
                pack = _attn._pack_seed(seed, row0,
                                        col0 + fault.get("col", 0),
                                        h_map[2], device=q3.device)
                dq_i, dk_i, dv_i, _ = _attn.flash_attention_bwd(
                    q3, kb, vb, out, lse, do, pack, scale,
                    blk_causal or fault.get("mask_all", False), rate,
                    h_map[:2], probs_bf16=probs_bf16, dq_acc=dq_acc)
                dq += dq_i
                dkb += dk_i
                dvb += dv_i
            # K/V move with their accumulators; the last shift moves only
            # the accumulators, which lands them on their home rank
            if i != n - 1:
                kb = ring_shift(kb, axis, tag=tag)
                vb = ring_shift(vb, axis, tag=tag)
            dkb = ring_shift(dkb, axis, tag=tag)
            dvb = ring_shift(dvb, axis, tag=tag)
        return (dq.to(q3.dtype), dkb.to(k3.dtype), dvb.to(v3.dtype)) \
            + (None,) * 10


def _prepare(q, k, v, scale, dropout_rate, dropout_seed, dropout_heads):
    b, h, s_local, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention takes q, k, v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if scale is None:
        scale = d ** -0.5
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    h_total, head0 = (h, 0) if dropout_heads is None else dropout_heads
    if isinstance(dropout_seed, torch.Tensor):
        seed = dropout_seed.to(device=q.device, dtype=torch.int32).reshape(())
    else:
        seed = torch.tensor(0 if dropout_seed is None else int(dropout_seed),
                            dtype=torch.int32, device=q.device)
    flat = [t.reshape(b * h, s_local, d).contiguous() for t in (q, k, v)]
    return flat, seed, float(scale), (h, int(h_total), head0)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis: Axis,
    causal: bool = False,
    scale: Optional[float] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_heads=None,
    probs_bf16: bool = False,
    dq_acc: Optional[bool] = None,
    tag: str = "ring",
    _fault: Optional[dict] = None,
) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``: q, k, v
    are this rank's (B, H, S_local, D) shards in ring order; returns its
    (B, H, S_local, D) shard of the full-sequence attention.

    ``causal`` masks by global position and skips the future blocks.
    ``dropout_rate`` > 0 draws the flash kernels' counter-hash mask keyed
    on global (row, col), the unsharded :func:`~apex_tpu_torch.ops.
    attention.flash_attention` mask for the same ``dropout_seed`` bit for
    bit; ``dropout_heads=(h_total, head_offset)`` keys it on global
    batch*head indices as ``flash_attention``'s does (a port addition:
    a data-parallel rank passes its batch offset times H, so the sharded
    batch draws the unsharded batch's mask).  ``probs_bf16`` and
    ``dq_acc`` go to every block as in ``flash_attention``.  The shifts
    are counted under ``tag``.  ``_fault`` plants an error that the
    checks must reject: ``{"col": c}`` shifts every block's column offset
    by c, ``{"mask_all": True}`` applies the causal mask to every block,
    the diagonal's or not."""
    (q3, k3, v3), seed, scale, h_map = _prepare(
        q, k, v, scale, dropout_rate, dropout_seed, dropout_heads)
    out = _Ring.apply(q3, k3, v3, seed, axis, bool(causal), scale,
                      float(dropout_rate), h_map, bool(probs_bf16), dq_acc,
                      tag, dict(_fault or {}))
    return out.reshape(q.shape)


def ring_attention_fwd(q, k, v, axis: Axis, causal: bool = False,
                       scale: Optional[float] = None, *,
                       dropout_rate: float = 0.0, dropout_seed=None,
                       dropout_heads=None, probs_bf16: bool = False,
                       tag: str = "ring", _fault: Optional[dict] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward alone, no autograd: ``(out, lse)``, out (B, H,
    S_local, D) and the fp32 global logsumexp (B, H, S_local) of this
    rank's rows (JAX's ``_ring_fwd_impl``)."""
    (q3, k3, v3), seed, scale, h_map = _prepare(
        q, k, v, scale, dropout_rate, dropout_seed, dropout_heads)
    with torch.no_grad():
        out, lse = _fwd(q3, k3, v3, seed, axis, bool(causal), scale,
                        float(dropout_rate), h_map, bool(probs_bf16), tag,
                        dict(_fault or {}))
    return out.reshape(q.shape), lse.reshape(q.shape[:3])


def ring_attention_ref(q, k, v, causal: bool = False,
                       scale: Optional[float] = None,
                       dropout_rate: float = 0.0, dropout_seed=None):
    """One-device reference over the full sequence (for tests)."""
    return _attn.attention_ref(q, k, v, causal=causal, scale=scale,
                               dropout_rate=dropout_rate,
                               dropout_seed=dropout_seed)
