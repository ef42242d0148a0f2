"""BERT encoder with the MLM head — the FusedLAMB pretraining model.

Counterpart of ``apex_tpu/models/bert.py``, with the same post-LN blocks,
decoder and dtype discipline:

- the embeddings are an fp32 lookup of the (possibly bf16) word and
  position tables, plus, when ``token_type_ids`` are given, of the
  token-type table (``type_vocab_size`` rows), summed, LayerNorm'd and
  cast to the compute dtype.  ``BertForMLM`` never passes
  ``token_type_ids`` (nor does the JAX model), so its encoder has no
  token-type table, as the flax tree has none; a standalone
  ``BertEncoder`` has one unless built with ``token_types=False``;
- a padding ``attention_mask`` (B, S), 1 = token, becomes the additive
  fp32 key bias ``(1 - mask) * -1e9``, which every layer's
  :class:`~apex_tpu_torch.contrib.multihead_attn.SelfMultiheadAttn`
  (``impl="fast"``: the flash kernels, with in-kernel attention dropout)
  reads as a broadcast (B, S, S) view;
- each block is post-LN with fp32 residual adds: ``LN(x + attn)``, then
  ``LN(x + ffn)``, the FFN with tanh GELU (``jax.nn.gelu``'s default) and
  residual dropout after the attention and the FFN;
- the MLM head: a dense transform, GELU and LayerNorm, then the decoder:
  tied to the word table (``tie_word_embeddings``, the default) — a
  compute-dtype product with fp32 output (an fp32 product of
  compute-dtype-rounded operands), plus the fp32 ``mlm_bias`` — or
  untied, ``Dense(vocab_size)`` in the compute dtype (``mlm_head``);
  the logits are cast to the compute dtype before the fused
  cross-entropy, and the loss is the mean over labels >= 0.

Dropout draws from an explicit ``torch.Generator`` on the model's device;
its bits cannot match flax's, except the attention-dropout mask, which is
the JAX package's counter hash.  Each encoder block runs under the
config's ``remat_policy`` (:mod:`apex_tpu_torch.remat`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._random import dropout
from apex_tpu_torch.amp import functional as amp_F
from apex_tpu_torch.amp.layers import Dense
from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.softmax_xentropy import softmax_cross_entropy
from apex_tpu_torch.remat import checkpoint_policy, remat_call

__all__ = ["BertConfig", "BertEncoder", "BertForMLM", "BertLayer",
           "init_bert_params"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30592  # BERT's 30522 padded to a multiple of 128
    hidden_size: int = 1024  # BERT-large
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    attn_dropout_rate: float = 0.1
    probs_bf16: bool = False
    # activation rematerialization per encoder block: none | dots_saveable
    # | full_block (apex_tpu_torch.remat)
    remat_policy: str = "none"
    compute_dtype: torch.dtype = torch.bfloat16
    # the flash backward: dq-accumulating (True), partials (False) or the
    # module default (None)
    dq_acc: Optional[bool] = None
    tie_word_embeddings: bool = True  # the MLPerf recipe ties the decoder

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)  # an unknown name raises

    @staticmethod
    def large(**kw) -> "BertConfig":
        return BertConfig(**kw)

    @staticmethod
    def base(**kw) -> "BertConfig":
        return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                          intermediate_size=3072, **kw)

    @staticmethod
    def tiny(**kw) -> "BertConfig":
        """For tests: 2 layers, 128 hidden."""
        return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                          num_heads=2, intermediate_size=512,
                          max_position=128, **kw)


class BertLayer(nn.Module):
    """Post-LN encoder block."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.cfg = cfg
        self.self_attn = SelfMultiheadAttn(
            h, cfg.num_heads, dropout=cfg.attn_dropout_rate, bias=True,
            mask_additive=True, impl="fast", probs_bf16=cfg.probs_bf16,
            dtype=dt, dq_acc=cfg.dq_acc)
        self.attn_ln = FusedLayerNorm(h)
        self.ffn_in = Dense(h, cfg.intermediate_size, dtype=dt)
        self.ffn_out = Dense(cfg.intermediate_size, h, dtype=dt)
        self.ffn_ln = FusedLayerNorm(h)

    def forward(self, x: torch.Tensor, mask_bias: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` (B, S, h); ``mask_bias`` (B, S) additive fp32 key bias or
        None.  Returns the block's output in the compute dtype."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        attn = self.self_attn(x.to(dt), key_padding_mask=mask_bias,
                              is_training=not deterministic,
                              generator=generator)
        if not deterministic:
            attn = dropout(attn, cfg.dropout_rate, generator)
        x = self.attn_ln(x.float() + attn.float())
        y = F.gelu(self.ffn_in(x.to(dt)), approximate="tanh")
        y = self.ffn_out(y)
        if not deterministic:
            y = dropout(y, cfg.dropout_rate, generator)
        x = self.ffn_ln(x.float() + y.float())
        return x.to(dt)


class BertEncoder(nn.Module):
    """Embeddings and the encoder stack; :meth:`attend` is the tied
    decoder over the word table.  ``token_types`` gives it the
    ``token_type_embeddings`` table that ``token_type_ids`` read (flax
    creates it at the first call with them; ``BertForMLM`` never makes
    one)."""

    def __init__(self, cfg: BertConfig, token_types: bool = True):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position, h)
        self.token_type_embeddings = (
            nn.Embedding(cfg.type_vocab_size, h) if token_types else None)
        self.embed_ln = FusedLayerNorm(h)
        self.layers = nn.ModuleList(BertLayer(cfg)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor, token_type_ids=None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, S) ids -> (B, S, h) hidden states in the compute dtype;
        ``token_type_ids`` (B, S) in [0, type_vocab_size) or None;
        ``attention_mask`` (B, S), 1 = token, 0 = padding."""
        if token_type_ids is not None and self.token_type_embeddings is None:
            raise ValueError("token_type_ids given to an encoder built "
                             "without a token-type table (token_types="
                             "False, as BertForMLM builds it)")
        cfg = self.cfg
        b, s = input_ids.shape
        if s > cfg.max_position:
            raise ValueError(f"sequence length {s} > max_position "
                             f"{cfg.max_position}")
        pos = torch.arange(s, device=input_ids.device)
        # flax nn.Embed(dtype=float32): the table is promoted, then looked up
        x = (F.embedding(input_ids, self.word_embeddings.weight.float())
             + F.embedding(pos, self.position_embeddings.weight.float())[None])
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids,
                                self.token_type_embeddings.weight.float())
        x = self.embed_ln(x)
        mask_bias = None
        if attention_mask is not None:
            mask_bias = (1.0 - attention_mask.float()) * -1e9
        x = x.to(cfg.compute_dtype)
        for layer in self.layers:
            x = remat_call(layer, cfg.remat_policy, x, mask_bias,
                           deterministic, generator, generator=generator)
        return x

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Hidden states -> fp32 vocab logits through the word table: a
        compute-dtype product (bf16 under O1's cast tables) with fp32
        accumulation and output, computed as an fp32 product of the
        rounded operands."""
        dt = self.cfg.compute_dtype
        return amp_F.matmul(x.to(dt), self.word_embeddings.weight.to(dt).T,
                            out_dtype=torch.float32)


class BertForMLM(nn.Module):
    """Encoder + MLM head (tied to the word table with ``mlm_bias``, or
    the untied ``mlm_head``) + fused cross-entropy.

    Parameter names follow the flax tree (see
    :func:`apex_tpu_torch.weights.from_jax_bert_params`)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.encoder = BertEncoder(cfg, token_types=False)
        self.mlm_transform = Dense(h, h, dtype=dt)
        self.mlm_ln = FusedLayerNorm(h)
        if cfg.tie_word_embeddings:
            self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        else:
            self.mlm_head = Dense(h, cfg.vocab_size, dtype=dt)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Without ``labels``: (B, S, V) logits, fp32 from the tied decoder,
        the compute dtype from ``mlm_head``.  With ``labels``
        (negative = ignore): ``(logits, loss)``, the logits in the compute
        dtype (the loss path's) and the fp32 mean loss over labels >= 0,
        ignored labels replaced by 0 before the fused cross-entropy.
        ``deterministic=False`` applies dropout from ``generator``."""
        cfg, dt = self.cfg, self.cfg.compute_dtype
        x = self.encoder(input_ids, attention_mask=attention_mask,
                         deterministic=deterministic, generator=generator)
        x = F.gelu(self.mlm_transform(x.to(dt)), approximate="tanh")
        x = self.mlm_ln(x.float())
        if cfg.tie_word_embeddings:
            logits = self.encoder.attend(x) + self.mlm_bias.float()
        else:
            logits = self.mlm_head(x)
        if labels is None:
            return logits
        logits = logits.to(dt)
        valid = labels >= 0
        per_tok = softmax_cross_entropy(logits, torch.where(valid, labels, 0))
        n = valid.sum().clamp_min(1)
        loss = torch.where(valid, per_tok, 0.0).sum() / n
        return logits, loss


def init_bert_params(cfg: BertConfig, generator: torch.Generator
                     ) -> Dict[str, torch.Tensor]:
    """Seeded fp32 weights for :class:`BertForMLM` (a state dict on the
    generator's device): BERT's normal(0, 0.02) for the embeddings and
    every projection, zero biases, unit LayerNorm scales."""
    with torch.device("meta"):
        shapes = BertForMLM(cfg).state_dict()
    dev = generator.device
    out = {}
    for name, t in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if "bias" in leaf:
            out[name] = torch.zeros(t.shape, device=dev)
        elif leaf == "weight" and "_ln" in name:
            out[name] = torch.ones(t.shape, device=dev)
        else:
            out[name] = torch.empty(t.shape, device=dev).normal_(
                0.0, 0.02, generator=generator)
    return out
