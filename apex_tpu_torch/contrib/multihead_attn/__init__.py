"""Fused multihead attention — ``SelfMultiheadAttn`` and
``EncdecMultiheadAttn``.

Counterpart of ``apex_tpu/contrib/multihead_attn/__init__.py`` (itself
apex's ``apex/contrib/multihead_attn``), with the JAX package's layout:
inputs are batch-first (B, S, H), the joint ``in_proj_weight`` is stored
(h, 3h) as flax stores a kernel, split into q | k | v on its last axis,
and ``forward`` returns the output tensor alone.

- ``impl="fast"`` runs the attention core through
  :func:`apex_tpu_torch.ops.attention.flash_attention` (the flash kernels
  on the card) with in-kernel probability dropout, its int32 seed drawn
  from the caller's ``torch.Generator`` on the device and fed to the
  kernel's murmur3 counter hash (the JAX package's mask, bit for bit, for
  the same seed);
- ``impl="default"`` is plain fp32 attention with the masked softmax and
  dropout of :func:`mask_softmax_dropout` (its dropout bits come from the
  generator and match neither flax's nor the kernel's, as the reference's
  two impls use different RNG streams).

Masks fold into one additive (B, Sq, Sk) fp32 bias (:func:`_masks_to_bias`),
a broadcast view that is never copied per query or per head.
``include_norm_add`` is the pre-LN variant: LN(query) feeds attention and
the module returns ``dropout(attn) + query``.  The projections go
through :func:`apex_tpu_torch.amp.functional.dense`, so O1's cast tables
run them in bf16.  ``EncdecMultiheadAttn`` is the cross-attention of an
encoder-decoder: Q from the decoder's query, K and V both from the
encoder's ``key`` through the joint (h, 2h) ``in_proj_weight_kv``, the
(B, Sq, Sk) bias from the encoder's key-padding mask.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from apex_tpu_torch._random import attention_seed, dropout
from apex_tpu_torch.amp import functional as amp_F
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import flash_attention

__all__ = ["EncdecMultiheadAttn", "SelfMultiheadAttn", "mask_softmax_dropout"]


def _masks_to_bias(key_padding_mask, attn_mask, mask_additive: bool, b: int,
                   sq: int, sk: int) -> Optional[torch.Tensor]:
    """The reference's two mask flavours as one additive (B, Sq, Sk) fp32
    bias, returned as a broadcast view (no copy).

    ``key_padding_mask``: (B, Sk), nonzero = pad, or already (B, Sq, Sk);
    with ``mask_additive`` it holds additive values.  ``attn_mask``:
    (Sq, Sk), nonzero = masked."""
    if key_padding_mask is not None and attn_mask is not None:
        raise ValueError(
            "attn_mask and key_padding_mask should not be both defined")
    if key_padding_mask is not None:
        kpm = (key_padding_mask[:, None, :] if key_padding_mask.dim() == 2
               else key_padding_mask)
        if mask_additive:
            bias = kpm.float()
        else:
            bias = torch.where(kpm != 0, -1e9, 0.0)
        return bias.expand(b, sq, sk)
    if attn_mask is not None:
        bias = torch.where(attn_mask != 0, -1e9, 0.0).float()
        return bias[None].expand(b, sq, sk)
    return None


def mask_softmax_dropout(scores: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         dropout_rate: float = 0.0,
                         deterministic: bool = True,
                         generator: Optional[torch.Generator] = None
                         ) -> torch.Tensor:
    """Masked softmax and probability dropout in fp32, returned in the
    scores' dtype.  ``scores``: (..., Sq, Sk); ``bias`` broadcastable and
    additive; dropout keeps with probability 1 - rate from ``generator``
    and scales kept values by 1 / (1 - rate)."""
    s = scores.float()
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    if not deterministic:
        p = dropout(p, dropout_rate, generator)
    return p.to(scores.dtype)


def _core_attention(q, k, v, bias, scale: float, dropout_rate: float,
                    is_training: bool, impl: str, probs_bf16: bool,
                    generator: Optional[torch.Generator],
                    dq_acc: Optional[bool] = None) -> torch.Tensor:
    """(B, H, S, D) attention: ``fast`` through the flash kernels,
    ``default`` plain fp32 (where ``probs_bf16`` and ``dq_acc`` do not
    apply)."""
    needs_dropout = dropout_rate > 0.0 and is_training
    if impl == "fast":
        seed = None
        if needs_dropout:
            seed = attention_seed(generator, q.device)
        return flash_attention(
            q, k, v, bias=bias, scale=scale,
            dropout_rate=dropout_rate if needs_dropout else 0.0,
            dropout_seed=seed, probs_bf16=probs_bf16, dq_acc=dq_acc)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = mask_softmax_dropout(
        s, bias=None if bias is None else bias[:, None],
        dropout_rate=dropout_rate, deterministic=not is_training,
        generator=generator)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


class SelfMultiheadAttn(nn.Module):
    """Self-attention (ref self_multihead_attn.py:26-178).

    ``bias`` adds the in/out projection biases, ``include_norm_add`` the
    pre-LN + residual variant, ``impl`` picks ``fast`` (flash kernels) or
    ``default`` (plain fp32), ``separate_qkv_params`` stores q/k/v
    weights as three parameters, ``mask_additive`` marks
    ``key_padding_mask`` as already additive.  ``dtype`` is the compute
    dtype the projections run in.  ``probs_bf16`` and ``dq_acc`` go to
    :func:`~apex_tpu_torch.ops.attention.flash_attention` (``fast``).
    Parameters are fp32 (until an AMP cast), initialised as the reference
    does: the joint (h, 3h) weight
    like an h x h matrix (variance scaling 2, fan average, uniform), the
    others Xavier-uniform, biases zero.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", separate_qkv_params: bool = False,
                 mask_additive: bool = False, probs_bf16: bool = False,
                 dtype: torch.dtype = torch.float32,
                 dq_acc: Optional[bool] = None):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"Unsupported impl: {impl}")
        if mask_additive and include_norm_add:
            raise ValueError("additive mask not supported with layer norm")
        h = embed_dim
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.use_bias = dropout, bias
        self.include_norm_add, self.impl = include_norm_add, impl
        self.separate_qkv_params = separate_qkv_params
        self.mask_additive, self.probs_bf16 = mask_additive, probs_bf16
        self.dtype, self.dq_acc = dtype, dq_acc

        def xavier(rows, cols):
            return nn.Parameter(nn.init.xavier_uniform_(torch.empty(rows,
                                                                    cols)))
        if separate_qkv_params:
            self.q_weight, self.k_weight, self.v_weight = (
                xavier(h, h) for _ in range(3))
        else:
            limit = math.sqrt(3.0 * 2.0 / ((h + 3 * h) / 2.0))
            self.in_proj_weight = nn.Parameter(
                torch.empty(h, 3 * h).uniform_(-limit, limit))
        self.out_proj_weight = xavier(h, h)
        if bias:
            if separate_qkv_params:
                self.q_bias, self.k_bias, self.v_bias = (
                    nn.Parameter(torch.zeros(h)) for _ in range(3))
            else:
                self.in_proj_bias = nn.Parameter(torch.zeros(3 * h))
            self.out_proj_bias = nn.Parameter(torch.zeros(h))
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(h)

    def forward(self, query: torch.Tensor, key=None, value=None,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``query`` (B, S, H).  Q, K and V are all projected from it;
        ``key``/``value`` exist for API parity and are ignored, as in the
        reference.  ``is_training`` with ``dropout`` > 0 draws the
        dropout randomness from ``generator``."""
        del key, value
        h, nh = self.embed_dim, self.num_heads
        d = h // nh
        b, s, _ = query.shape
        dt = self.dtype
        x = query
        if self.include_norm_add:
            x = self.lyr_nrm(x.float())
        x = x.to(dt)
        if self.separate_qkv_params:
            w = torch.cat([self.q_weight, self.k_weight, self.v_weight], -1)
        else:
            w = self.in_proj_weight
        bvec = None
        if self.use_bias:
            bvec = (torch.cat([self.q_bias, self.k_bias, self.v_bias])
                    if self.separate_qkv_params else self.in_proj_bias)
            bvec = bvec.to(dt)
        qkv = amp_F.dense(x, w.to(dt), bvec)
        split = lambda t: t.reshape(b, s, nh, d).transpose(1, 2)  # noqa: E731
        q, k, v = (split(t) for t in qkv.split(h, dim=-1))
        bias = _masks_to_bias(key_padding_mask, attn_mask,
                              self.mask_additive, b, s, s)
        attn = _core_attention(q, k, v, bias, d ** -0.5, self.dropout,
                               is_training, self.impl, self.probs_bf16,
                               generator, self.dq_acc)
        attn = attn.transpose(1, 2).reshape(b, s, h)
        out = amp_F.dense(attn, self.out_proj_weight.to(dt),
                          self.out_proj_bias.to(dt) if self.use_bias
                          else None)
        if self.include_norm_add:
            # residual dropout + add of the RAW query (ref :160-167)
            if is_training:
                out = dropout(out, self.dropout, generator)
            out = out + query.to(out.dtype)
        return out


class EncdecMultiheadAttn(nn.Module):
    """Encoder-decoder cross-attention (ref encdec_multihead_attn.py:27-159).

    Q is projected from the decoder ``query`` by ``in_proj_weight_q``
    (h, h); K and V both from the encoder ``key`` by the joint
    ``in_proj_weight_kv`` (h, 2h), split k | v on its last axis.
    ``bias``, ``include_norm_add``, ``impl``, ``probs_bf16`` and ``dtype``
    as in :class:`SelfMultiheadAttn` (``bias`` works on both impls).
    Initialised as the reference: the kv weight like an h x h matrix
    (variance scaling 1.5, fan average, uniform), the others
    Xavier-uniform, biases zero.
    """

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", probs_bf16: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if impl not in ("fast", "default"):
            raise ValueError(f"Unsupported impl: {impl}")
        h = embed_dim
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.dropout, self.use_bias = dropout, bias
        self.include_norm_add, self.impl = include_norm_add, impl
        self.probs_bf16, self.dtype = probs_bf16, dtype
        self.in_proj_weight_q = nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(h, h)))
        limit = math.sqrt(3.0 * 1.5 / ((h + 2 * h) / 2.0))
        self.in_proj_weight_kv = nn.Parameter(
            torch.empty(h, 2 * h).uniform_(-limit, limit))
        self.out_proj_weight = nn.Parameter(
            nn.init.xavier_uniform_(torch.empty(h, h)))
        if bias:
            self.in_proj_bias_q = nn.Parameter(torch.zeros(h))
            self.in_proj_bias_kv = nn.Parameter(torch.zeros(2 * h))
            self.out_proj_bias = nn.Parameter(torch.zeros(h))
        if include_norm_add:
            self.lyr_nrm = FusedLayerNorm(h)

    def _bias(self, name: str) -> Optional[torch.Tensor]:
        return getattr(self, name).to(self.dtype) if self.use_bias else None

    def forward(self, query: torch.Tensor, key: torch.Tensor, value=None,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                is_training: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``query`` (B, Sq, H) decoder side, ``key`` (B, Sk, H) encoder
        side; ``value`` exists for API parity and is ignored (K and V both
        come from ``key``, as in the reference).  ``key_padding_mask``
        (B, Sk), nonzero = pad; ``attn_mask`` (Sq, Sk), nonzero = masked."""
        del value
        h, nh = self.embed_dim, self.num_heads
        d = h // nh
        b, sq, _ = query.shape
        sk = key.shape[1]
        dt = self.dtype
        x = query
        if self.include_norm_add:
            x = self.lyr_nrm(x.float())
        q = amp_F.dense(x.to(dt), self.in_proj_weight_q.to(dt),
                        self._bias("in_proj_bias_q"))
        kv = amp_F.dense(key.to(dt), self.in_proj_weight_kv.to(dt),
                         self._bias("in_proj_bias_kv"))
        k, v = kv.split(h, dim=-1)
        q4 = q.reshape(b, sq, nh, d).transpose(1, 2)
        k4 = k.reshape(b, sk, nh, d).transpose(1, 2)
        v4 = v.reshape(b, sk, nh, d).transpose(1, 2)
        bias = _masks_to_bias(key_padding_mask, attn_mask, False, b, sq, sk)
        attn = _core_attention(q4, k4, v4, bias, d ** -0.5, self.dropout,
                               is_training, self.impl, self.probs_bf16,
                               generator)
        attn = attn.transpose(1, 2).reshape(b, sq, h)
        out = amp_F.dense(attn, self.out_proj_weight.to(dt),
                          self._bias("out_proj_bias"))
        if self.include_norm_add:
            if is_training:
                out = dropout(out, self.dropout, generator)
            out = out + query.to(out.dtype)
        return out
