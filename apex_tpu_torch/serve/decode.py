"""Paged prefill chunks and K-token decode windows over the page pool.

Counterpart of the paged subset of ``apex_tpu/serve/decode.py``:

- :class:`SamplingParams`, :func:`sample_tokens` and the filtered
  sampling epilogue (greedy, temperature, top-k, top-p, min-p), drawing
  from a ``torch.Generator``;
- :class:`GPTDecoder`: ``init_paged_cache``, ``prefill_chunk``,
  ``paged_decode_window`` and ``copy_pages``.

The JAX decoder runs K decode steps inside one donated ``lax.scan``
dispatch.  Here the K steps are a Python loop over device tensors that
never leaves the device: sampling, the active mask and the length
advance all stay there, and the ``(K, slots)`` tokens come back with
one host sync, at the caller's fetch.  The cache is updated in place
(the JAX programs donate it instead).  Everything runs under
``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, GPTLM
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.serve.kv_cache import PagedKVCache, init_paged_cache

__all__ = [
    "DEFAULT_TOKENS_PER_DISPATCH",
    "GPTDecoder",
    "SamplingParams",
    "sample_tokens",
]

DEFAULT_TOKENS_PER_DISPATCH = 8


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampling knobs as device tensors, one entry per slot.

    ``temperature <= 0`` is greedy (the others are then ignored),
    ``top_k == 0`` / ``top_p >= 1`` / ``min_p <= 0`` turn that filter
    off.  ``all_greedy`` is the host-side fact that every slot is
    greedy, which lets a window skip the sort the filters need."""

    temperature: torch.Tensor  # (B,) fp32
    top_k: torch.Tensor        # (B,) int32
    top_p: torch.Tensor        # (B,) fp32
    min_p: torch.Tensor        # (B,) fp32
    all_greedy: bool

    @staticmethod
    def make(b: int, temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
             device: Optional[Union[str, torch.device]] = None
             ) -> "SamplingParams":
        """Broadcast scalars or per-slot sequences to (b,) tensors on
        ``device``: the CUDA device when None (raising without one, as
        every entry point of the port does); pass ``device="cpu"`` for
        CPU tensors."""
        device = resolve_device(device)

        def full(x, dt):
            return torch.tensor(np.broadcast_to(np.asarray(x, dt), (b,)).copy(),
                                device=device)

        t = full(temperature, np.float32)
        return SamplingParams(
            temperature=t, top_k=full(top_k, np.int32),
            top_p=full(top_p, np.float32), min_p=full(min_p, np.float32),
            all_greedy=bool(np.all(np.asarray(temperature) <= 0.0)),
        )


def _sample_filtered(logits, generator, temperature, top_k, top_p, min_p):
    """The sampling epilogue: ``logits`` (..., V), the four params
    broadcastable over the leading dims.  One descending sort per row
    finds the logit threshold of the INTERSECTION of the filters (each
    keeps a prefix of the sorted order), masking happens in the original
    order, and greedy rows (t <= 0) return the argmax exactly."""
    v = logits.shape[-1]
    l32 = logits.float()
    greedy = torch.argmax(l32, dim=-1)
    lt = l32 / torch.clamp_min(temperature, 1e-6)[..., None]
    srt = torch.sort(lt, dim=-1, descending=True).values
    keff = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v)
    idx = torch.arange(v, device=logits.device)
    keep_k = idx < keff[..., None]
    p = torch.softmax(torch.where(keep_k, srt, -torch.inf), dim=-1)
    cum = torch.cumsum(p, dim=-1)
    keep_p = ((cum - p) < top_p[..., None]) | (top_p >= 1.0)[..., None]
    keep_mp = p >= min_p[..., None] * p[..., :1]
    keep = keep_k & keep_p & keep_mp
    n_keep = torch.clamp_min(keep.sum(dim=-1), 1)
    thr = torch.gather(srt, -1, (n_keep - 1)[..., None])
    masked = torch.where(lt >= thr, lt, -torch.inf)
    probs = torch.softmax(masked, dim=-1).reshape(-1, v)
    sampled = torch.multinomial(probs, 1, generator=generator).reshape(
        greedy.shape)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def sample_tokens(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature=0.0,
    *,
    top_k=None,
    top_p=None,
    min_p=None,
) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens.

    A scalar ``temperature`` with no filters: ``<= 0`` is greedy argmax
    (``generator`` unused), else a draw from ``softmax(logits / T)``.
    Filters, or per-row arrays, engage the filtered epilogue
    (:class:`SamplingParams` semantics, rows independent)."""
    if (top_k is None and top_p is None and min_p is None
            and np.ndim(temperature) == 0
            and not isinstance(temperature, torch.Tensor)):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    b = logits.shape[0]
    samp = SamplingParams.make(
        b, temperature,
        0 if top_k is None else top_k,
        1.0 if top_p is None else top_p,
        0.0 if min_p is None else min_p,
        device=logits.device,
    )
    return _sample_params(logits, generator, samp)


def _sample_params(logits, generator, samp: SamplingParams):
    if samp.all_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return _sample_filtered(logits, generator, samp.temperature,
                            samp.top_k, samp.top_p, samp.min_p)


class GPTDecoder:
    """Paged prefill chunks and fused K-token decode windows.

    Args:
      cfg: the model config; ``compute_dtype`` overrides its compute
        dtype.
      params: a state dict of :class:`~apex_tpu_torch.models.GPTLM`
        (from :func:`~apex_tpu_torch.weights.from_jax_params` or
        :func:`~apex_tpu_torch.models.init_params`); the dense weights
        and the head are cast to the compute dtype once, at load.
      cache_dtype: pool dtype (None: the compute dtype);
        ``torch.int8`` selects int8 pages with per-token scales.
      tokens_per_dispatch: K, the decode steps per window.
      temperature: the default for requests that do not set one
        (0.0 = greedy).
      device: where the model and the cache live; None is the CUDA
        device, and raises when there is none.
    """

    def __init__(
        self,
        cfg: GPTConfig,
        params: Dict[str, torch.Tensor],
        *,
        cache_dtype: Optional[torch.dtype] = None,
        compute_dtype: Optional[torch.dtype] = None,
        tokens_per_dispatch: int = DEFAULT_TOKENS_PER_DISPATCH,
        temperature: float = 0.0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        self.cfg = cfg
        if int(tokens_per_dispatch) < 1:
            raise ValueError("tokens_per_dispatch must be >= 1")
        self.tokens_per_dispatch = int(tokens_per_dispatch)
        self.temperature = float(temperature)
        self.cache_dtype = cfg.compute_dtype if cache_dtype is None \
            else cache_dtype
        with torch.device(self.device):
            self.model = GPTLM(cfg)
        self.model.load_state_dict(params)
        self.model.requires_grad_(False)
        self.model.eval()
        self.model.cast_for_serving()

    def init_paged_cache(self, num_pages: int, slots: int,
                         page_len: int) -> PagedKVCache:
        return init_paged_cache(self.cfg, num_pages, slots, page_len,
                                dtype=self.cache_dtype, device=self.device)

    def _ints(self, x) -> torch.Tensor:
        """Host ints (numpy, lists) -> a contiguous int32 device tensor."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32).contiguous()
        a = np.ascontiguousarray(np.asarray(x, dtype=np.int32))
        return torch.from_numpy(a).to(self.device)

    @torch.no_grad()
    def prefill_chunk(self, cache: PagedKVCache, slot_tables, slots,
                      input_ids, base, valid) -> torch.Tensor:
        """Write ONE chunk of a paged prefill into ``cache`` in place and
        set the chunk slots' lengths to ``base + valid``.  Returns fp32
        (B, V) logits at each row's last valid chunk position.

        ``slot_tables`` (B, pages_per_slot): the chunk slots' page-table
        rows (every page in the written range already exclusively
        owned); ``input_ids`` (B, C) right-padded; ``base``/``valid``
        (B,) start positions and real token counts."""
        tables = self._ints(slot_tables)
        slots = self._ints(slots).long()
        ids = self._ints(input_ids).long()
        base = self._ints(base)
        valid = self._ints(valid)
        logits = self.model.paged_prefill_chunk(
            ids, base, valid, cache.k, cache.v, tables,
            k_scale=cache.k_scale, v_scale=cache.v_scale)
        cache.lengths[slots] = base + valid
        return logits

    @torch.no_grad()
    def paged_decode_window(
        self, cache: PagedKVCache, tables, tokens, active,
        generator: Optional[torch.Generator] = None,
        samp: Optional[SamplingParams] = None,
    ) -> torch.Tensor:
        """K decode steps over every slot, with no host sync inside.

        ``tables`` (slots, pages_per_slot), ``tokens`` (slots,) the last
        sampled token per slot, ``active`` (slots,) bool: inactive slots
        decode garbage that never advances their length or the token
        meter.  The host must have made each active slot's ``[len, len
        + K)`` range exclusively writable.  Updates ``cache`` in place
        and returns the (K, slots) int32 tokens as a device tensor."""
        k = self.tokens_per_dispatch
        tables = self._ints(tables)
        tok = self._ints(tokens)
        act = torch.as_tensor(np.asarray(active, bool) if not isinstance(
            active, torch.Tensor) else active).to(self.device)
        if samp is None:
            samp = SamplingParams.make(tok.shape[0], self.temperature,
                                       device=self.device)
        smax = tables.shape[1] * cache.page_len
        out = torch.empty((k, tok.shape[0]), dtype=torch.int32,
                          device=self.device)
        n_active = act.sum()
        for i in range(k):
            logits = self.model.paged_decode_step(
                tok, cache.k, cache.v, tables, cache.lengths,
                k_scale=cache.k_scale, v_scale=cache.v_scale)
            nxt = _sample_params(logits, generator, samp)
            tok = torch.where(act, nxt, tok)
            cache.lengths.copy_(torch.where(
                act, torch.clamp(cache.lengths + 1, max=smax),
                cache.lengths))
            cache.decoded += n_active
            out[i] = tok
        return out

    @torch.no_grad()
    def copy_pages(self, cache: PagedKVCache, src, dst) -> None:
        """Copy-on-write executor: physical pages ``src[i] -> dst[i]``
        (every layer, head and column; int8 pools copy their scale rows
        too), in place.  ``0 -> 0`` identity rows may pad the batch."""
        src = self._ints(src).long()
        dst = self._ints(dst).long()
        cache.k[dst] = cache.k[src]
        cache.v[dst] = cache.v[src]
        if cache.k_scale is not None:
            cache.k_scale[dst] = cache.k_scale[src]
            cache.v_scale[dst] = cache.v_scale[src]
