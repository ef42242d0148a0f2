"""GPT-2-style causal LM: the training forward and the serving forward
over the paged KV pool.

Counterpart of ``apex_tpu/models/gpt.py``, with the same pre-LN blocks,
tied head and dtype discipline:

- the residual stream is in the compute dtype, every LayerNorm input is
  fp32 (:class:`~apex_tpu_torch.normalization.FusedLayerNorm`, the
  LayerNorm kernels on the card);
- GELU is the tanh form (``jax.nn.gelu``'s default);
- training (``GPTLM.forward``): the embeddings are an fp32 lookup of the
  (possibly bf16) tables, summed and dropped out in fp32, then cast to
  the compute dtype; each block runs causal
  :func:`~apex_tpu_torch.ops.attention.flash_attention` (with the
  config's ``probs_bf16`` and ``dq_acc``) with its attention-dropout seed
  drawn from the caller's generator, and residual dropout after the
  projection and the MLP; each block runs under the config's
  ``remat_policy`` (:mod:`apex_tpu_torch.remat`), which leaves the
  parameters as they are; the loss is
  :func:`~apex_tpu_torch.ops.softmax_xentropy.softmax_cross_entropy` on
  compute-dtype logits (a compute-dtype head product with fp32
  accumulation: the JAX package rounds its fp32 logits to that dtype
  before the loss), the mean over labels >= 0;
- serving: the head is a compute-dtype product with fp32 accumulation
  and fp32 logits (``_logits``), and each layer's history is read
  through the page table by
  :func:`~apex_tpu_torch.ops.attention.paged_fused_attention`.

Where the JAX serving methods return updated (donated) pools, these write
the new tokens' K/V into the pool tensors IN PLACE and return the logits.
Dropout draws from an explicit ``torch.Generator`` on the model's device,
never the global RNG; its bits cannot match flax's, except the attention
dropout mask, which is the JAX package's counter hash.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._random import attention_seed, dropout
from apex_tpu_torch.amp.layers import Dense
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import attention as _attn
from apex_tpu_torch.ops.softmax_xentropy import softmax_cross_entropy
from apex_tpu_torch.remat import checkpoint_policy, remat_call

__all__ = ["GPTConfig", "GPTLayer", "GPTLM", "init_params"]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # GPT-2 50257 padded to a multiple of 128
    hidden_size: int = 768   # GPT-2 small
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 1024
    dropout_rate: float = 0.1
    attn_dropout_rate: float = 0.1
    compute_dtype: torch.dtype = torch.bfloat16
    # half-precision probabilities in the flash kernels (flash_attention's
    # probs_bf16)
    probs_bf16: bool = False
    # activation rematerialization per block: none | dots_saveable |
    # full_block (apex_tpu_torch.remat)
    remat_policy: str = "none"
    # the flash backward: the dq-accumulating one (True), the partials one
    # (False), or the module default (None: ops.attention.DQ_ACC_DEFAULT)
    dq_acc: Optional[bool] = None

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)  # an unknown name raises

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def small(**kw) -> "GPTConfig":
        return GPTConfig(**kw)

    @staticmethod
    def medium(**kw) -> "GPTConfig":
        return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        """For tests: 2 layers, 128 hidden."""
        return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                         num_heads=2, max_position=128, **kw)


class GPTLayer(nn.Module):
    """Pre-LN decoder block: x + attn(LN(x)); x + mlp(LN(x))."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.cfg = cfg
        self.ln1 = FusedLayerNorm(h)
        self.qkv = Dense(h, 3 * h, dtype=dt)
        self.proj = Dense(h, h, dtype=dt)
        self.ln2 = FusedLayerNorm(h)
        self.ffn_in = Dense(h, cfg.intermediate_size, dtype=dt)
        self.ffn_out = Dense(cfg.intermediate_size, h, dtype=dt)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The training branch: ``x`` (B, S, h) in the compute dtype.
        Without ``deterministic``, attention dropout takes a per-layer
        int32 seed in [0, 2^31 - 1) from ``generator`` (kept on the
        device) and residual dropout draws its masks from it."""
        cfg = self.cfg
        b, s, h = x.shape
        nh, d, dt = cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        y = self.ln1(x.float()).to(dt)
        q, k, v = self.qkv(y).split(h, dim=-1)
        split = lambda t: t.reshape(b, s, nh, d).transpose(1, 2)  # noqa: E731
        drop_attn = cfg.attn_dropout_rate > 0 and not deterministic
        seed = None
        if drop_attn:
            seed = attention_seed(generator, x.device)
        attn = _attn.flash_attention(
            split(q), split(k), split(v), causal=True,
            dropout_rate=cfg.attn_dropout_rate if drop_attn else 0.0,
            dropout_seed=seed, probs_bf16=cfg.probs_bf16, dq_acc=cfg.dq_acc)
        attn = self.proj(attn.transpose(1, 2).reshape(b, s, h))
        if not deterministic:
            attn = dropout(attn, cfg.dropout_rate, generator)
        x = x + attn.to(x.dtype)
        y = self.ln2(x.float()).to(dt)
        y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
        if not deterministic:
            y = dropout(y, cfg.dropout_rate, generator)
        return x + y.to(x.dtype)

    def decode(self, x, *, layer, positions, pool_k, pool_v, page_table,
               cache_lengths, pool_k_scale=None, pool_v_scale=None):
        """The cached-attention (serving) branch over the paged pool.

        ``x`` (B, T, h) in the compute dtype, ``positions`` (B, T) int32
        global positions of the T new tokens, ``pool_k``/``pool_v`` the
        full ``(num_pages, L, H, page_len, D)`` pools read at ``layer``
        through ``page_table`` (B, n_pages) up to ``cache_lengths`` (B,).
        Returns ``(x_out, k, v)`` with k/v the new tokens' (B, H, T, D)
        projections for the caller to write into the pool; with int8
        pools (scales given) they are quantized here and returned as
        ``(int8, scale)`` pairs, and the in-block keys the new tokens
        attend to are the round-tripped values every later read sees.
        """
        cfg = self.cfg
        b, s, h = x.shape
        nh, d, dt = cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        y = self.ln1(x.float()).to(dt)
        q, k, v = self.qkv(y).split(h, dim=-1)
        split = lambda t: t.reshape(b, s, nh, d).transpose(1, 2)  # noqa: E731
        q, k, v = split(q), split(k), split(v)  # (B, nh, T, d)
        quant = pool_k_scale is not None
        if quant:
            k, k_s = _attn.quantize_kv(k)
            v, v_s = _attn.quantize_kv(v)
            k_att = k.float() * k_s[..., None]
            v_att = v.float() * v_s[..., None]
        else:
            k_att, v_att = k, v
        attn = _attn.paged_fused_attention(
            q, k_att, v_att,
            positions=positions,
            pool_k=pool_k, pool_v=pool_v,
            page_table=page_table, cache_lengths=cache_lengths,
            pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale,
            layer=layer,
        )
        attn = attn.transpose(1, 2).reshape(b, s, h)
        x = x + self.proj(attn).to(x.dtype)
        y = self.ln2(x.float()).to(dt)
        y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
        x = x + y.to(x.dtype)
        if quant:
            return x, (k, k_s), (v, v_s)
        return x, k, v


def _paged_write(pool, scale_arr, li, phys, off, kv):
    """Write new-token K/V into the pool IN PLACE through the page
    table: ``kv`` is the layer's return — (B, H, T, D) floats, or a
    ``((B, H, T, D) int8, (B, H, T) scale)`` pair for int8 pools —
    written at physical pages ``phys`` and in-page offsets ``off`` (both
    (B, T)).  Inactive slots' writes all land on the trash page; which
    of those duplicate writes wins does not matter (plain assignment,
    never accumulation)."""
    if scale_arr is not None:
        kv, s = kv
        scale_arr[:, li][phys, :, off] = s.transpose(1, 2)
    pool[:, li][phys, :, off] = kv.transpose(1, 2).to(pool.dtype)


class GPTLM(nn.Module):
    """Decoder LM: embeddings + pre-LN stack + final LN + tied head.

    Parameter names follow the flax tree (see
    :func:`apex_tpu_torch.weights.from_jax_params`): ``wte``/``wpe``
    embeddings, ``layers.{i}`` blocks, ``ln_f``.
    """

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.layers = nn.ModuleList(GPTLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = FusedLayerNorm(cfg.hidden_size)
        self._head: Optional[torch.Tensor] = None

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """The training forward on (B, S) ``input_ids``.

        Without ``labels``, returns fp32 (B, S, V) logits (``_logits``).
        With ``labels`` (next-token ids, negative = ignore), returns
        ``(logits, loss)``: the logits in the compute dtype (the loss
        path's, so no fp32 copy of the largest activation is made) and
        the fp32 mean loss over labels >= 0, ignored labels replaced by 0
        before the fused cross-entropy.  ``deterministic=False`` applies
        dropout from ``generator``.  Each block runs under
        ``cfg.remat_policy``."""
        cfg = self.cfg
        b, s = input_ids.shape
        if s > cfg.max_position:
            raise ValueError(f"sequence length {s} > max_position "
                             f"{cfg.max_position}")
        pos = torch.arange(s, device=input_ids.device)
        # flax nn.Embed(dtype=float32): the table is promoted, then looked up
        x = (F.embedding(input_ids, self.wte.weight.float())
             + F.embedding(pos, self.wpe.weight.float())[None])
        if not deterministic:
            x = dropout(x, cfg.dropout_rate, generator)
        x = x.to(cfg.compute_dtype)
        for layer in self.layers:
            x = remat_call(layer, cfg.remat_policy, x, deterministic,
                           generator, generator=generator)
        x = self.ln_f(x.float())
        if labels is None:
            return self._logits(x)
        dt = cfg.compute_dtype
        logits = torch.matmul(x.to(dt), self.wte.weight.to(dt).T)
        valid = labels >= 0
        per_tok = softmax_cross_entropy(logits,
                                        torch.where(valid, labels, 0))
        n = valid.sum().clamp_min(1)
        loss = torch.where(valid, per_tok, 0.0).sum() / n
        return logits, loss

    @torch.no_grad()
    def cast_for_serving(self) -> None:
        """Make once the weight casts every serving step would repeat:
        each ``Dense`` kernel and bias goes to its compute dtype in place,
        and the tied head, rounded to the compute dtype, is kept in fp32
        for ``_logits``.  The results are the same numbers; embeddings and
        LayerNorm weights stay fp32.  Call it after loading the weights."""
        for m in self.modules():
            if isinstance(m, Dense) and m.dtype is not None:
                m.to(m.dtype)
        self._head = self.wte.weight.to(self.cfg.compute_dtype).float()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(..., h) fp32 post-``ln_f`` hidden -> (..., V) fp32 logits: a
        compute-dtype product with fp32 accumulation, computed as an
        fp32 product of compute-dtype-rounded operands."""
        dt = self.cfg.compute_dtype
        head = self._head
        if head is None:
            head = self.wte.weight.to(dt).float()
        return torch.matmul(x.to(dt).float(), head.T)

    def _embed(self, ids, posq):
        x = self.wte(ids) + self.wpe(posq)
        return x.to(self.cfg.compute_dtype)

    def paged_prefill_chunk(self, input_ids, base, valid, pool_k, pool_v,
                            page_tables, k_scale=None, v_scale=None):
        """One chunk of a chunked paged prefill.

        ``input_ids`` (B, C) right-padded chunk tokens at absolute
        positions ``base`` (B,) with ``valid`` (B,) real tokens per row;
        ``pool_k``/``pool_v`` the global pools ``(num_pages, L, H,
        page_len, D)``; ``page_tables`` (B, n_pages) int32.  Each layer
        attends the chunk to the history (masked at ``base``) plus
        in-chunk causal attention, then writes the chunk's K/V into the
        pools IN PLACE (int8 pools quantize on write and update
        ``k_scale``/``v_scale`` in place).  Returns fp32 (B, V) logits
        at each row's last valid chunk position.  The caller must have
        made ``[base, base + valid)`` exclusively writable
        (``PagePool.ensure_writable``)."""
        cfg = self.cfg
        b, c = input_ids.shape
        pl = pool_k.shape[3]
        smax = page_tables.shape[1] * pl
        dev = input_ids.device
        positions = base[:, None].to(torch.int32) + torch.arange(
            c, dtype=torch.int32, device=dev)
        posq = torch.clamp(positions, max=cfg.max_position - 1)
        x = self._embed(input_ids, posq)
        wpos = torch.clamp(positions, max=smax - 1).long()
        bidx = torch.arange(b, device=dev)
        phys = page_tables.long()[bidx[:, None], wpos // pl]  # (B, C)
        off = wpos % pl
        lens = base.to(torch.int32)
        for li, layer in enumerate(self.layers):
            x, k, v = layer.decode(
                x, layer=li, positions=posq, pool_k=pool_k, pool_v=pool_v,
                page_table=page_tables, cache_lengths=lens,
                pool_k_scale=k_scale, pool_v_scale=v_scale,
            )
            _paged_write(pool_k, k_scale, li, phys, off, k)
            _paged_write(pool_v, v_scale, li, phys, off, v)
        x = self.ln_f(x.float())
        last = torch.clamp(valid.long() - 1, 0, c - 1)
        return self._logits(x[bidx, last])

    def paged_decode_step(self, token_ids, pool_k, pool_v, page_tables,
                          lengths, k_scale=None, v_scale=None):
        """ONE cached decode token per slot over the paged pool.

        ``token_ids`` (B,) the last sampled tokens, ``lengths`` (B,) int32
        valid prefixes.  Each layer attends the new token to its history
        through ``page_tables`` and writes its K/V IN PLACE at physical
        ``(table[pos // page_len], pos % page_len)``; free slots' table
        rows point at the trash page, so their writes corrupt nothing.
        Writes clamp to the last column, so a slot at capacity decodes
        garbage the engine trims.  Returns fp32 (B, V) logits; the
        caller advances ``lengths``."""
        cfg = self.cfg
        b = token_ids.shape[0]
        pl = pool_k.shape[3]
        smax = page_tables.shape[1] * pl
        dev = token_ids.device
        pos = torch.clamp(lengths, max=smax - 1).to(torch.int32)
        posq = torch.clamp(pos, max=cfg.max_position - 1)
        x = self._embed(token_ids[:, None], posq[:, None])
        bidx = torch.arange(b, device=dev)
        phys = page_tables.long()[bidx, pos.long() // pl][:, None]  # (B, 1)
        off = (pos.long() % pl)[:, None]
        positions = posq[:, None].contiguous()
        for li, layer in enumerate(self.layers):
            x, k, v = layer.decode(
                x, layer=li, positions=positions, pool_k=pool_k,
                pool_v=pool_v, page_table=page_tables, cache_lengths=pos,
                pool_k_scale=k_scale, pool_v_scale=v_scale,
            )
            _paged_write(pool_k, k_scale, li, phys, off, k)
            _paged_write(pool_v, v_scale, li, phys, off, v)
        x = self.ln_f(x.float())
        return self._logits(x)[:, 0]


def init_params(cfg: GPTConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Seeded fp32 weights for :class:`GPTLM` (a state dict on the
    generator's device): GPT-2's normal(0, 0.02) for embeddings and
    dense kernels, zero biases, unit LayerNorm scales."""
    with torch.device("meta"):
        shapes = GPTLM(cfg).state_dict()
    dev = generator.device
    out = {}
    for name, t in shapes.items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(t.shape, device=dev)
        elif name.endswith(".weight") and (".ln" in name
                                           or name.startswith("ln_f")):
            out[name] = torch.ones(t.shape, device=dev)
        else:
            out[name] = torch.empty(t.shape, device=dev).normal_(
                0.0, 0.02, generator=generator)
    return out
