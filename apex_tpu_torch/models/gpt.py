"""GPT-2-style causal LM: the training forward and the serving forward
over the paged KV pool.

Counterpart of ``apex_tpu/models/gpt.py``, with the same pre-LN blocks,
head and dtype discipline:

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
- O1: built with an fp32 compute dtype and run inside
  ``amp_.autocast()``, every ``Dense`` and the tied head run as bf16
  products through :mod:`apex_tpu_torch.amp.functional` (the head with
  fp32 output), so flash attention takes bf16 q, k, v, the residual
  stream and LayerNorm stay fp32 and the loss takes fp32 logits;
- the head is tied to ``wte`` by default; ``tie_word_embeddings=False``
  gives an fp32 ``head`` ``Dense`` (no bias) whose fp32 product both
  the loss and ``_logits`` use;
- serving: the tied head is a compute-dtype product with fp32
  accumulation and fp32 logits (``_logits``); each layer's history is read either
  from the contiguous slot caches by
  :func:`~apex_tpu_torch.ops.attention.cached_attention` (``prefill``,
  ``decode_step``, ``decode_block``) or through the page table by
  :func:`~apex_tpu_torch.ops.attention.paged_fused_attention`
  (``paged_prefill_chunk``, ``paged_decode_step``,
  ``paged_decode_block``, ``paged_decode_tree_block``).  The step
  methods take ``n_layers`` (the shallow-exit draft of speculative
  decoding) and the block methods verify a current token plus its
  drafts in one forward: a chain, or W branches of a tree under a
  branch mask;
- tensor-parallel serving (``GPTConfig.decode_tp_axis``, an
  :class:`~apex_tpu_torch.parallel.mesh.Axis`): the serving branch keeps
  the replicated qkv product, attends only this rank's head group
  ``h0 = index * H / tp`` against its head shard of the cache, writes
  the group's output at ``h0 * head_dim`` into a zero (B, T, h) tensor
  and sums it over the axis before ``proj``: one counted all-reduce a
  layer (tag ``tp_heads``), so every rank carries the same residual
  stream.

Where the JAX serving methods return updated (donated) pools, these write
the new tokens' K/V into the pool tensors IN PLACE and return the logits.
Dropout draws from an explicit ``torch.Generator`` on the model's device,
never the global RNG; its bits cannot match flax's, except the attention
dropout mask, which is the JAX package's counter hash.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._random import attention_seed, dropout
from apex_tpu_torch.amp import functional as amp_F
from apex_tpu_torch.amp.layers import Dense
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops import attention as _attn
from apex_tpu_torch.ops.softmax_xentropy import softmax_cross_entropy
from apex_tpu_torch.parallel.mesh import psum
from apex_tpu_torch.remat import checkpoint_policy, remat_call

__all__ = ["GPTConfig", "GPTLayer", "GPTLM", "init_params", "tree_layout"]


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
    # False: an untied fp32 output head (``head``) instead of wte^T
    tie_word_embeddings: bool = True
    # serving: the parallel.mesh.Axis the decode path's heads and KV cache
    # are sharded over (None: one rank); set by GPTDecoder(mesh=)
    decode_tp_axis: Any = None

    def __post_init__(self):
        checkpoint_policy(self.remat_policy)  # an unknown name raises

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def local_heads(self) -> int:
        """The heads a rank serves: ``num_heads / tp`` over
        ``decode_tp_axis``, else all of them."""
        if self.decode_tp_axis is None:
            return self.num_heads
        return self.num_heads // self.decode_tp_axis.size

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
    """Pre-LN decoder block: x + attn(LN(x)); x + mlp(LN(x)).

    ``attention_fn(q, k, v, *, dropout_rate, dropout_seed) -> out`` (q, k,
    v and out (B, H, S, D)) replaces the causal flash attention of the
    training branch, as JAX's ``GPTLayer(attention_fn=)`` does: a
    sequence-parallel attention (``parallel.ring_attention``,
    ``parallel.ulysses_attention``) over sequence shards.  It owns its
    kernel options: the config's ``probs_bf16`` and ``dq_acc`` apply to
    the built-in attention only."""

    def __init__(self, cfg: GPTConfig, attention_fn=None):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.cfg = cfg
        self.attention_fn = attention_fn
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
        rate = cfg.attn_dropout_rate if drop_attn else 0.0
        if self.attention_fn is None:
            attn = _attn.flash_attention(
                split(q), split(k), split(v), causal=True,
                dropout_rate=rate, dropout_seed=seed,
                probs_bf16=cfg.probs_bf16, dq_acc=cfg.dq_acc)
        else:
            attn = self.attention_fn(split(q), split(k), split(v),
                                     dropout_rate=rate, dropout_seed=seed)
        attn = self.proj(attn.transpose(1, 2).reshape(b, s, h))
        if not deterministic:
            attn = dropout(attn, cfg.dropout_rate, generator)
        x = x + attn.to(x.dtype)
        y = self.ln2(x.float()).to(dt)
        y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
        if not deterministic:
            y = dropout(y, cfg.dropout_rate, generator)
        return x + y.to(x.dtype)

    def decode(self, x, *, positions, cache_lengths=None, cache_k=None,
               cache_v=None, layer=0, pool_k=None, pool_v=None,
               page_table=None, pool_k_scale=None, pool_v_scale=None,
               block_mask=None):
        """The cached-attention (serving) branch.

        ``x`` (B, T, h) in the compute dtype, ``positions`` (B, T) int32
        global positions of the T new tokens.  The history is one of:

        - contiguous: ``cache_k``/``cache_v`` (B, H, S, D), this layer's
          slot caches, valid up to ``cache_lengths`` (B,), read by
          :func:`~apex_tpu_torch.ops.attention.cached_attention`; with no
          cache the block attends to itself alone (causal by position:
          the prefill);
        - paged: ``pool_k``/``pool_v`` the full ``(num_pages, L, H,
          page_len, D)`` pools read at ``layer`` through ``page_table``
          (B, n_pages) up to ``cache_lengths`` (B,), by
          :func:`~apex_tpu_torch.ops.attention.paged_fused_attention`.

        ``block_mask`` (T, T) bool further restricts which new keys each
        new query sees (the tree block's branch mask).

        Returns ``(x_out, k, v)`` with k/v the new tokens' (B, H, T, D)
        projections for the caller to write into the cache; with int8
        pools (scales given) they are quantized here and returned as
        ``(int8, scale)`` pairs, and the in-block keys the new tokens
        attend to are the round-tripped values every later read sees.

        Over ``cfg.decode_tp_axis`` the caches and pools hold this rank's
        ``H / tp`` heads, k/v are those heads' projections, and the head
        groups are reassembled by one sum over the axis before ``proj``.
        """
        cfg = self.cfg
        b, s, h = x.shape
        nh, d, dt = cfg.num_heads, cfg.head_dim, cfg.compute_dtype
        y = self.ln1(x.float()).to(dt)
        q, k, v = self.qkv(y).split(h, dim=-1)
        split = lambda t: t.reshape(b, s, nh, d).transpose(1, 2)  # noqa: E731
        q, k, v = split(q), split(k), split(v)  # (B, nh, T, d)
        tp = cfg.decode_tp_axis
        if tp is not None:
            # the local head group; the qkv product stays replicated
            nh_loc = cfg.local_heads
            h0 = tp.index * nh_loc
            q, k, v = (t[:, h0:h0 + nh_loc] for t in (q, k, v))
        quant = pool_k_scale is not None
        if quant:
            k, k_s = _attn.quantize_kv(k)
            v, v_s = _attn.quantize_kv(v)
            k_att = k.float() * k_s[..., None]
            v_att = v.float() * v_s[..., None]
        else:
            k_att, v_att = k, v
        if page_table is not None:
            attn = _attn.paged_fused_attention(
                q, k_att, v_att,
                positions=positions,
                pool_k=pool_k, pool_v=pool_v,
                page_table=page_table, cache_lengths=cache_lengths,
                pool_k_scale=pool_k_scale, pool_v_scale=pool_v_scale,
                layer=layer, block_mask=block_mask,
            )
        else:
            attn = _attn.cached_attention(
                q, k_att, v_att, positions=positions, cache_k=cache_k,
                cache_v=cache_v, cache_lengths=cache_lengths,
                block_mask=block_mask)
        attn = attn.transpose(1, 2).reshape(b, s, -1)
        if tp is not None:
            # reassemble the head axis: the local block at h0 * d of a
            # zero (B, T, h) tensor, summed over the axis
            full = torch.zeros((b, s, h), dtype=attn.dtype,
                               device=attn.device)
            full[..., h0 * d:(h0 + nh_loc) * d] = attn
            attn = psum(full, tp, tag="tp_heads")
        x = x + self.proj(attn).to(x.dtype)
        y = self.ln2(x.float()).to(dt)
        y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
        x = x + y.to(x.dtype)
        if quant:
            return x, (k, k_s), (v, v_s)
        return x, k, v


def tree_layout(width: int, depth: int, device=None):
    """The tree verify block's static layout ``[root, branch 0's depth
    nodes, ..., branch width-1's]``: each node's depth, (1, T) int32 (0
    at the root, j + 1 at a branch's j-th node), and the contiguous (T,
    T) bool branch mask (a query sees the root and its own branch), T =
    1 + width * depth, on ``device``."""
    branch = torch.cat([torch.tensor([-1]),
                        torch.arange(width).repeat_interleave(depth)])
    depths = torch.cat([torch.zeros(1, dtype=torch.int64),
                        torch.arange(1, depth + 1).repeat(width)])
    mask = (branch[None, :] < 0) | (branch[None, :] == branch[:, None])
    return (depths[None].to(device=device, dtype=torch.int32),
            mask.contiguous().to(device))


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
    """Decoder LM: embeddings + pre-LN stack + final LN + head (tied to
    ``wte``, or an untied ``head`` when ``cfg.tie_word_embeddings`` is
    False).

    Parameter names follow the flax tree (see
    :func:`apex_tpu_torch.weights.from_jax_params`): ``wte``/``wpe``
    embeddings, ``layers.{i}`` blocks, ``ln_f``, ``head``.
    """

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.layers = nn.ModuleList(GPTLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.ln_f = FusedLayerNorm(cfg.hidden_size)
        if not cfg.tie_word_embeddings:
            self.head = Dense(cfg.hidden_size, cfg.vocab_size,
                              dtype=torch.float32, use_bias=False)
        self._head: Optional[torch.Tensor] = None
        # (width, depth) -> the tree block's node depths and branch mask
        self._trees: Dict[tuple, tuple] = {}

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
        if cfg.tie_word_embeddings:
            # through the cast tables (O1: a bf16 product with fp32 output,
            # computed as an fp32 product of bf16-rounded operands)
            logits = amp_F.matmul(x.to(dt), self.wte.weight.to(dt).T,
                                  out_dtype=dt)
        else:
            logits = self.head(x).to(dt)
        valid = labels >= 0
        per_tok = softmax_cross_entropy(logits,
                                        torch.where(valid, labels, 0))
        n = valid.sum().clamp_min(1)
        loss = torch.where(valid, per_tok, 0.0).sum() / n
        return logits, loss

    @torch.no_grad()
    def cast_for_serving(self) -> None:
        """Make once the weight casts every serving step would repeat:
        each ``Dense`` kernel and bias goes to its compute dtype in place
        (the untied head's is fp32), and the tied head, rounded to the
        compute dtype, is kept in fp32 for ``_logits``.  The results are
        the same numbers; embeddings and LayerNorm weights stay fp32.
        Call it after loading the weights."""
        for m in self.modules():
            if isinstance(m, Dense) and m.dtype is not None:
                m.to(m.dtype)
        if self.cfg.tie_word_embeddings:
            self._head = self.wte.weight.to(self.cfg.compute_dtype).float()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(..., h) fp32 post-``ln_f`` hidden -> (..., V) fp32 logits.
        Tied: a compute-dtype product with fp32 accumulation, computed
        as an fp32 product of compute-dtype-rounded operands.  Untied: the
        fp32 ``head`` product."""
        if not self.cfg.tie_word_embeddings:
            return self.head(x.float())
        dt = self.cfg.compute_dtype
        head = self._head
        if head is None:
            head = self.wte.weight.to(dt).float()
        return torch.matmul(x.to(dt).float(), head.T)

    def _embed(self, ids, posq):
        x = self.wte(ids) + self.wpe(posq)
        return x.to(self.cfg.compute_dtype)

    def _tree(self, width: int, depth: int, device) -> tuple:
        """:func:`tree_layout` on ``device``, made once per (W, D)."""
        key = (width, depth, str(device))
        if key not in self._trees:
            self._trees[key] = tree_layout(width, depth, device)
        return self._trees[key]

    def _block_positions(self, start, t, smax):
        """Positions ``start .. start + t - 1`` (B, t) int32, the write
        columns clamped to ``smax - 1`` and the position-embedding rows to
        ``max_position - 1`` (the JAX package's gathers clamp; torch's
        raise instead)."""
        positions = start[:, None].to(torch.int32) + torch.arange(
            t, dtype=torch.int32, device=start.device)
        posq = torch.clamp(positions, max=self.cfg.max_position - 1)
        return posq, torch.clamp(positions, max=smax - 1).long()

    # -- contiguous serving (KVCache) -----------------------------------

    def prefill(self, input_ids, lengths):
        """The prompt pass of the contiguous engine: ``input_ids`` (B, P)
        right-padded prompts with ``lengths`` (B,) valid tokens.  Each
        layer attends the block to itself, causal by position (no cache,
        no flash kernel: the JAX package's ``cached_attention`` path).
        Returns ``(logits, k, v)``: fp32 (B, V) logits at each prompt's
        last valid position and the (B, L, H, P, D) K/V for the caller to
        write into the slots (padding columns too: every reader masks
        them, and decoding overwrites them)."""
        b, p = input_ids.shape
        posq = torch.clamp(
            torch.arange(p, dtype=torch.int32, device=input_ids.device),
            max=self.cfg.max_position - 1).expand(b, p)
        x = self._embed(input_ids, posq)
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = layer.decode(x, positions=posq)
            ks.append(k)
            vs.append(v)
        x = self.ln_f(x.float())
        last = torch.clamp(lengths.long() - 1, 0, p - 1)
        logits = self._logits(x[torch.arange(b, device=x.device), last])
        return logits, torch.stack(ks, 1), torch.stack(vs, 1)

    def _cached_block(self, token_ids, start, cache_lengths, cache_k,
                      cache_v, n_layers=None):
        """T tokens a row at positions ``start .. start + T - 1`` over the
        contiguous slot caches (B, L, H, S, D): the first ``n_layers``
        layers (None: all) attend to the history below ``cache_lengths``
        plus the block (causal by position), and write the block's K/V
        IN PLACE at its positions, clamped to ``S - 1``.  Returns the
        fp32 post-``ln_f`` hidden (B, T, h)."""
        b, t = token_ids.shape
        posq, wpos = self._block_positions(start, t, cache_k.shape[3])
        x = self._embed(token_ids, posq)
        bidx = torch.arange(b, device=token_ids.device)[:, None]
        for li, layer in enumerate(self.layers[:n_layers]):
            x, k, v = layer.decode(
                x, positions=posq, cache_k=cache_k[:, li],
                cache_v=cache_v[:, li], cache_lengths=cache_lengths)
            # (B, H, T, D) -> (B, T, H, D): the broadcast dims come first
            cache_k[:, li][bidx, :, wpos] = k.transpose(1, 2).to(
                cache_k.dtype)
            cache_v[:, li][bidx, :, wpos] = v.transpose(1, 2).to(
                cache_v.dtype)
        return self.ln_f(x.float())

    def decode_step(self, token_ids, cache_k, cache_v, lengths,
                    n_layers=None):
        """ONE cached decode token per slot over the contiguous caches.

        ``token_ids`` (B,) the last sampled tokens, ``lengths`` (B,)
        int32 valid prefixes.  The new K/V is written IN PLACE at
        ``lengths``, clamped to the last column, so a slot at capacity
        decodes garbage the engine trims.  ``n_layers`` truncates the
        stack (the shallow-exit draft of speculative decoding): the first
        ``n_layers`` blocks run and write their own cache layers, then
        ``ln_f`` and the tied head.  Returns fp32 (B, V) logits; the
        caller advances ``lengths``."""
        pos = torch.clamp(lengths, max=cache_k.shape[3] - 1).to(torch.int32)
        x = self._cached_block(token_ids[:, None], pos, pos, cache_k,
                               cache_v, n_layers)
        return self._logits(x)[:, 0]

    def decode_block(self, token_ids, cache_k, cache_v, lengths):
        """T cached decode tokens per slot in ONE forward — the verify
        pass of speculative decoding.  ``token_ids`` (B, T) (the current
        token, then T - 1 drafts) take positions ``lengths .. lengths + T
        - 1``; each layer attends the block to the cache (below
        ``min(lengths, S - 1)``) plus itself, causal by position, and
        writes the block's K/V IN PLACE.  Returns fp32 (B, T, V) logits:
        position i's are those of i + 1 successive :meth:`decode_step`
        calls, up to float summation order."""
        ln = torch.clamp(lengths, max=cache_k.shape[3] - 1).to(torch.int32)
        x = self._cached_block(token_ids, lengths, ln, cache_k, cache_v)
        return self._logits(x)

    # -- paged serving (PagedKVCache) -----------------------------------

    def _paged_start(self, token_ids, start, pool_k, page_tables):
        """``(posq, wpos)`` of a block at positions ``start .. start + T
        - 1`` over the paged pools (:meth:`_block_positions` at the
        table's capacity)."""
        return self._block_positions(
            start, token_ids.shape[1], page_tables.shape[1] * pool_k.shape[3])

    def _paged_block(self, token_ids, posq, wpos, cache_lengths, pool_k,
                     pool_v, page_tables, k_scale=None, v_scale=None,
                     n_layers=None, block_mask=None):
        """T tokens a row at logical positions ``posq`` (B, T) int32 over
        the paged pools ``(num_pages, L, H, page_len, D)``: the first
        ``n_layers`` layers (None: all) attend to the history through
        ``page_tables`` (B, n_pages) below ``cache_lengths`` plus the
        block (causal by position and, when given, ``block_mask`` (T, T)),
        and write the block's K/V IN PLACE at the write slots ``wpos``
        (B, T), physical ``(table[wpos // page_len], wpos % page_len)``
        (int8 pools quantize on write and update ``k_scale``/``v_scale``
        in place).  Returns the fp32 post-``ln_f`` hidden (B, T, h)."""
        b = token_ids.shape[0]
        pl = pool_k.shape[3]
        x = self._embed(token_ids, posq)
        bidx = torch.arange(b, device=token_ids.device)
        phys = page_tables.long()[bidx[:, None], wpos // pl]  # (B, T)
        off = wpos % pl
        for li, layer in enumerate(self.layers[:n_layers]):
            x, k, v = layer.decode(
                x, layer=li, positions=posq, pool_k=pool_k, pool_v=pool_v,
                page_table=page_tables, cache_lengths=cache_lengths,
                pool_k_scale=k_scale, pool_v_scale=v_scale,
                block_mask=block_mask,
            )
            _paged_write(pool_k, k_scale, li, phys, off, k)
            _paged_write(pool_v, v_scale, li, phys, off, v)
        return self.ln_f(x.float())

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
        c = input_ids.shape[1]
        base = base.to(torch.int32)
        x = self._paged_block(
            input_ids, *self._paged_start(input_ids, base, pool_k, page_tables),
            base, pool_k, pool_v, page_tables, k_scale, v_scale)
        last = torch.clamp(valid.long() - 1, 0, c - 1)
        return self._logits(x[torch.arange(x.shape[0], device=x.device),
                              last])

    def paged_decode_step(self, token_ids, pool_k, pool_v, page_tables,
                          lengths, k_scale=None, v_scale=None,
                          n_layers=None):
        """ONE cached decode token per slot over the paged pool.

        ``token_ids`` (B,) the last sampled tokens, ``lengths`` (B,) int32
        valid prefixes.  Each layer attends the new token to its history
        through ``page_tables`` and writes its K/V IN PLACE at physical
        ``(table[pos // page_len], pos % page_len)``; free slots' table
        rows point at the trash page, so their writes corrupt nothing.
        Writes clamp to the last column, so a slot at capacity decodes
        garbage the engine trims.  ``n_layers`` truncates the stack, as
        in :meth:`decode_step`.  Returns fp32 (B, V) logits; the caller
        advances ``lengths``."""
        smax = page_tables.shape[1] * pool_k.shape[3]
        pos = torch.clamp(lengths, max=smax - 1).to(torch.int32)
        ids = token_ids[:, None]
        x = self._paged_block(
            ids, *self._paged_start(ids, pos, pool_k, page_tables), pos,
            pool_k, pool_v, page_tables, k_scale, v_scale, n_layers)
        return self._logits(x)[:, 0]

    def paged_decode_block(self, token_ids, pool_k, pool_v, page_tables,
                           lengths, k_scale=None, v_scale=None):
        """:meth:`decode_block` over the paged pool — the verify pass of
        speculative decoding.  ``token_ids`` (B, T) take positions
        ``lengths .. lengths + T - 1``, which the host must have made
        exclusively writable; the history is read below ``min(lengths,
        smax - 1)`` and the block is causal by position (no block mask).
        Returns fp32 (B, T, V) logits at every block position."""
        smax = page_tables.shape[1] * pool_k.shape[3]
        ln = torch.clamp(lengths, max=smax - 1).to(torch.int32)
        x = self._paged_block(
            token_ids, *self._paged_start(token_ids, lengths, pool_k,
                                          page_tables),
            ln, pool_k, pool_v, page_tables, k_scale, v_scale)
        return self._logits(x)

    def paged_decode_tree_block(self, token_ids, pool_k, pool_v, page_tables,
                                lengths, k_scale=None, v_scale=None,
                                width=2, depth=1):
        """The verify pass of tree speculation: ``width`` draft branches
        of ``depth`` tokens each in ONE forward over the paged pool.

        ``token_ids`` (B, T), T = 1 + width * depth, laid out ``[root,
        branch 0's tokens, ..., branch W-1's]``: every branch continues
        the root, so branch r's token j sits at LOGICAL position
        ``lengths + 1 + j`` whatever r (clamped to ``max_position - 1``
        for the embedding), and the static branch mask (:meth:`_tree`)
        keeps each query to its own branch and the root.  The K/V are
        PARKED in the sequential write slots ``lengths .. lengths + T -
        1`` (clamped to the table's last column), which the host must
        have made exclusively writable; the caller compacts the winning
        branch into the chain slots (``GPTDecoder._tree_compact``).  The
        history is read below ``min(lengths, smax - 1)``.  Returns fp32
        (B, T, V) logits at every node."""
        b, t = token_ids.shape
        if t != 1 + width * depth:
            raise ValueError(f"tree block of width {width} depth {depth} "
                             f"wants T={1 + width * depth}, got {t}")
        smax = page_tables.shape[1] * pool_k.shape[3]
        depths, mask = self._tree(width, depth, token_ids.device)
        ln32 = lengths.to(torch.int32)
        posq = torch.clamp(ln32[:, None] + depths,
                           max=self.cfg.max_position - 1)
        wslot = ln32[:, None] + torch.arange(t, dtype=torch.int32,
                                             device=token_ids.device)
        wpos = torch.clamp(wslot, max=smax - 1).long()
        ln = torch.clamp(ln32, max=smax - 1)
        x = self._paged_block(token_ids, posq, wpos, ln, pool_k, pool_v,
                              page_tables, k_scale, v_scale,
                              block_mask=mask)
        return self._logits(x)


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
