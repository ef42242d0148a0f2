"""Prefill and K-token decode windows over the contiguous cache and the
page pool, with chain and tree self-speculative decoding.

Counterpart of ``apex_tpu/serve/decode.py``:

- :class:`SamplingParams`, :func:`sample_tokens` and the filtered
  sampling epilogue (greedy, temperature, top-k, top-p, min-p), drawing
  from a ``torch.Generator``, over (B, V) step logits or (B, T, V)
  verify blocks (the per-slot params broadcast over T);
- :func:`propose_ngram`, the suffix-bigram draft proposer, and
  :func:`propose_ngram_tree`, its W-branch widening;
- :class:`GPTDecoder`: ``init_cache``, ``prefill`` and ``decode_window``
  (contiguous), ``init_paged_cache``, ``prefill_chunk``,
  ``paged_decode_window`` and ``copy_pages`` (paged), the speculative
  windows ``spec_decode_window``, ``paged_spec_decode_window`` and
  ``paged_tree_spec_decode_window``, the handoff's ``gather_pages`` and
  ``adopt_pages``, and ``with_params`` (a clone serving new weights);
- :func:`reference_generate`, the per-token full-recompute oracle.

Tensor-parallel serving (``GPTDecoder(mesh=serve_mesh(tp))``): JAX wraps
every decode program in ``shard_map``; the port runs SPMD instead.  Every
rank of the ``model`` axis builds the same decoder with the same
(replicated) weights and runs the same programs on the same arguments;
its caches hold its ``num_heads / tp`` heads, and each layer reassembles
the heads with one counted all-reduce (``models.gpt``).  The programs
below run unchanged on the head shard: the contiguous prefill and
window, the paged prefill chunk and window, the chain windows with
either proposer, the tree window (``_tree_compact`` moves only this
rank's heads) and ``copy_pages``; ``gather_pages`` all-gathers the head
blocks and ``adopt_pages`` takes this rank's, so a handoff carries
every head.  Every host decision and every
sampling draw must then agree across the ranks, which
``serve.ServeEngine`` gets by running the same request stream with the
same seed on each.

Speculative decoding (``spec_tokens`` D > 0): each window step proposes
D draft tokens (the n-gram proposer over the per-slot token history, or
a shallow-exit draft running the first ``spec_exit_layers`` blocks
autoregressively), verifies the current token and the D drafts in ONE
(1 + D)-position forward (``decode_block``/``paged_decode_block``),
samples a target at every position and accepts the longest draft
prefix equal to the targets, plus the target after it.  Accepting and
rolling back is arithmetic on the device: a slot's length advances by
the accepted count, and rejected positions hold K/V that every reader
masks and the next block overwrites.  Under greedy decoding the tokens
equal the non-speculative engine's.

Tree speculation (``spec_tree`` W >= 2, paged and n-gram only): each
step proposes W branches of D drafts (the W latest matches of the
trailing bigram), verifies them in ONE forward of 1 + W * D positions
under a branch mask (``paged_decode_tree_block``), takes the branch
with the longest accepted prefix (ties to branch 0, the chain's draft)
and moves its parked K/V into the chain slots (``_tree_compact``); the
carry arithmetic is then the chain's on the winner's D + 1 targets.

The JAX decoder runs a window inside one donated ``lax.scan`` dispatch.
Here its steps are a Python loop over device tensors that never leaves
the device: proposing, sampling, the active mask and the length advance
all stay there, and the window's tokens come back with one host sync,
at the caller's fetch.  The caches are updated in place (the JAX
programs donate them instead).  Everything runs under
``torch.no_grad()``.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig, GPTLM
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.parallel.mesh import all_gather
from apex_tpu_torch.serve.kv_cache import (
    KVCache,
    PagedKVCache,
    init_cache,
    init_paged_cache,
)

__all__ = [
    "DEFAULT_SPEC_HIST",
    "DEFAULT_TOKENS_PER_DISPATCH",
    "GPTDecoder",
    "SamplingParams",
    "propose_ngram",
    "propose_ngram_tree",
    "reference_generate",
    "sample_tokens",
]

DEFAULT_TOKENS_PER_DISPATCH = 8
# tokens of per-slot history the n-gram proposer matches over (the
# engine keeps it on the host and hands it to every spec window)
DEFAULT_SPEC_HIST = 32


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
    """The window epilogue: per-slot params (B,) over (B, V) step logits
    or (B, T, V) verify blocks, the params reshaped to (B, 1) so that
    they broadcast over T."""
    if samp.all_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    extra = logits.dim() - samp.temperature.dim() - 1
    exp = lambda x: x.reshape(x.shape + (1,) * extra)  # noqa: E731
    return _sample_filtered(logits, generator, exp(samp.temperature),
                            exp(samp.top_k), exp(samp.top_p),
                            exp(samp.min_p))


def _bigram_matches(hist: torch.Tensor) -> torch.Tensor:
    """(B, H - 2) int32: each earlier occurrence's start index where the
    trailing bigram of ``hist`` recurs, else -1 (-1 tokens never
    match)."""
    a, z = hist[:, -2], hist[:, -1]
    idx = torch.arange(hist.shape[1] - 2, dtype=torch.int32,
                       device=hist.device)
    m = (hist[:, :-2] == a[:, None]) & (hist[:, 1:-1] == z[:, None])
    m = m & ((a >= 0) & (z >= 0))[:, None]
    return torch.where(m, idx, -1)


def _ngram_readout(hist: torch.Tensor, j: torch.Tensor,
                   draft: int) -> torch.Tensor:
    """The drafts that follow each match ``j`` (B, W) of the trailing
    bigram, cycling with the implied period past the history's end;
    ``j < 0`` (no match) repeats the last token.  (B, W, draft) int32."""
    b, h = hist.shape
    w = j.shape[1]
    period = torch.clamp_min((h - 2) - j, 1)
    take = j[..., None] + 2 + (
        torch.arange(draft, dtype=torch.int32, device=hist.device)
        % period[..., None])
    cand = torch.gather(hist[:, None, :].expand(b, w, h), 2,
                        torch.clamp(take, 0, h - 1).long())
    fallback = torch.clamp_min(hist[:, -1], 0)[:, None, None].expand(
        b, w, draft)
    drafts = torch.where((j >= 0)[..., None], cand, fallback)
    return torch.clamp_min(drafts, 0).to(torch.int32)


def propose_ngram(hist: torch.Tensor, draft: int) -> torch.Tensor:
    """Suffix-bigram draft proposal over per-slot token history.

    ``hist`` (B, H) int32: each row the last H tokens of the slot's
    sequence, its current (not yet cached) token at ``[-1]``; ``-1``
    pads short histories and never matches.  Finds the latest earlier
    occurrence of the trailing bigram and proposes the tokens that
    followed it, cycling with the implied period past the history's end
    (a period-p repetition proposes its exact continuation).  No match
    repeats the last token.  Returns (B, draft) int32; device ops only,
    no host sync."""
    j = _bigram_matches(hist).amax(dim=1)  # the latest match
    return _ngram_readout(hist, j[:, None], draft)[:, 0]


def propose_ngram_tree(hist: torch.Tensor, draft: int,
                       width: int) -> torch.Tensor:
    """:func:`propose_ngram` widened to ``width`` branches: the W latest
    occurrences of the trailing bigram, in descending order, each seed
    a continuation with the same period-cycling readout; rows with fewer
    matches fill the spare branches with the no-match fallback (they tie
    and lose to the lower branch).  Branch 0 is :func:`propose_ngram`'s
    draft bit for bit.  Returns (B, width, draft) int32; device ops
    only, no host sync."""
    j = torch.sort(_bigram_matches(hist), dim=1,
                   descending=True).values[:, :width]
    return _ngram_readout(hist, j, draft)


class GPTDecoder:
    """Prefill and fused K-token decode windows over a contiguous
    :class:`~apex_tpu_torch.serve.KVCache` or a paged
    :class:`~apex_tpu_torch.serve.PagedKVCache`, with chain and tree
    self-speculative decoding.

    Args:
      cfg: the model config; ``compute_dtype`` overrides its compute
        dtype.
      params: a state dict of :class:`~apex_tpu_torch.models.GPTLM`
        (from :func:`~apex_tpu_torch.weights.from_jax_params` or
        :func:`~apex_tpu_torch.models.init_params`); the dense weights
        and the head are cast to the compute dtype once, at load.
      cache_dtype: cache dtype; None defers to ``policy.cache_dtype``
        and then to the compute dtype.  ``torch.int8`` selects int8
        pages with per-token scales (paged only).  An fp16 cache runs
        the plain versions on the CPU; the paged kernel does not take
        it yet (ROADMAP B.2).
      policy: an :class:`~apex_tpu_torch.amp.Policy` whose
        ``cache_dtype`` (its ``kv_cache_dtype``, else its compute
        dtype) is the cache dtype when ``cache_dtype`` is None.
      kv_int8: int8 paged pages whatever the cache dtype (also implied
        by an int8 cache dtype); the contiguous cache keeps the cache
        dtype.
      tokens_per_dispatch: K, the decode steps per window.
      temperature: the default for requests that do not set one
        (0.0 = greedy).
      spec_tokens: the draft length D of speculative decoding (0: off).
        A spec window runs ``ceil(K / (D + 1))`` verify forwards of
        ``D + 1`` positions, so it emits between that many and
        ``steps * (D + 1)`` tokens a slot.
      spec_proposer: ``"ngram"`` (suffix bigrams over the slot's
        history, no model compute) or ``"shallow"`` (the first
        ``spec_exit_layers`` blocks, ``ln_f`` and the head, run
        autoregressively for each draft token).
      spec_hist: history tokens the n-gram proposer matches over.
      spec_exit_layers: the shallow draft's depth (None: half the
        layers).
      spec_tree: tree speculation's branch width W (0 or 1: the chain).
        W >= 2 verifies W n-gram branches a step in one tree forward
        (:meth:`paged_tree_spec_decode_window`); it needs speculation
        on and the n-gram proposer, and only the paged engine runs it.
      device: where the model and the cache live; None is the CUDA
        device, and raises when there is none.
      mesh: a :class:`~apex_tpu_torch.parallel.mesh.Mesh` (``serve.
        serve_mesh(tp)``) whose ``tp_axis`` shards the heads and the
        cache; ``num_heads`` must divide by its size.  None: one rank.
      tp_axis: the mesh axis of the heads.
    """

    def __init__(
        self,
        cfg: GPTConfig,
        params: Dict[str, torch.Tensor],
        *,
        cache_dtype: Optional[torch.dtype] = None,
        policy=None,
        kv_int8: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        tokens_per_dispatch: int = DEFAULT_TOKENS_PER_DISPATCH,
        temperature: float = 0.0,
        spec_tokens: int = 0,
        spec_proposer: str = "ngram",
        spec_hist: int = DEFAULT_SPEC_HIST,
        spec_exit_layers: Optional[int] = None,
        spec_tree: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
        tp_axis: str = "model",
    ):
        self.device = resolve_device(device)
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        self.mesh = mesh
        self.tp_axis = tp_axis if mesh is not None else None
        if mesh is not None:
            axis = mesh[tp_axis]
            if cfg.num_heads % axis.size:
                raise ValueError(
                    f"num_heads {cfg.num_heads} not divisible by the "
                    f"{tp_axis!r} axis size {axis.size}")
            cfg = dataclasses.replace(cfg, decode_tp_axis=axis)
        self.cfg = cfg
        if int(tokens_per_dispatch) < 1:
            raise ValueError("tokens_per_dispatch must be >= 1")
        self.tokens_per_dispatch = int(tokens_per_dispatch)
        self.temperature = float(temperature)
        self.spec_tokens = int(spec_tokens)
        if self.spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0")
        if spec_proposer not in ("ngram", "shallow"):
            raise ValueError(f"spec_proposer must be 'ngram' or 'shallow', "
                             f"got {spec_proposer!r}")
        self.spec_proposer = spec_proposer
        self.spec_hist = int(spec_hist)
        if self.spec_enabled and self.spec_hist < 4:
            raise ValueError("spec_hist must be >= 4 (bigram + context)")
        self.spec_exit_layers = (max(1, cfg.num_layers // 2)
                                 if spec_exit_layers is None
                                 else int(spec_exit_layers))
        if not 1 <= self.spec_exit_layers <= cfg.num_layers:
            raise ValueError(f"spec_exit_layers {self.spec_exit_layers} "
                             f"outside [1, {cfg.num_layers}]")
        self.spec_tree = int(spec_tree)
        if self.spec_tree > 1:
            if not self.spec_enabled:
                raise ValueError(
                    "spec_tree needs speculation on (spec_tokens >= 1)")
            if self.spec_proposer != "ngram":
                raise ValueError(
                    "tree speculation only composes with the 'ngram' "
                    "proposer (the shallow draft is a single chain)")
        if cache_dtype is None:
            cache_dtype = (policy.cache_dtype if policy is not None
                           else cfg.compute_dtype)
        self.cache_dtype = cache_dtype
        self.kv_int8 = bool(kv_int8) or cache_dtype == torch.int8
        self.params = params
        self.model = self._serving_model(params)

    def _serving_model(self, params: Dict[str, torch.Tensor]) -> GPTLM:
        """A :class:`GPTLM` of ``self.cfg`` on the device holding
        ``params``, frozen and cast for serving."""
        with torch.device(self.device):
            model = GPTLM(self.cfg)
        model.load_state_dict(params)
        model.requires_grad_(False)
        model.eval()
        model.cast_for_serving()
        return model

    @property
    def tp_degree(self) -> int:
        """Ranks the heads are sharded over (1 without a mesh)."""
        axis = self.cfg.decode_tp_axis
        return 1 if axis is None else axis.size

    # -- speculative geometry -------------------------------------------

    @property
    def spec_enabled(self) -> bool:
        return self.spec_tokens > 0

    @property
    def spec_steps(self) -> int:
        """Verify forwards per spec window at the configured depth."""
        return self._spec_steps_for(self.spec_tokens)

    def _spec_steps_for(self, draft: int) -> int:
        """Verify forwards a window at depth ``draft`` runs to cover
        ``tokens_per_dispatch`` when every draft is accepted."""
        return max(1, math.ceil(self.tokens_per_dispatch / (draft + 1)))

    @property
    def spec_tree_width(self) -> int:
        """Tree branches a verify forward (1: the chain)."""
        return max(1, self.spec_tree)

    @property
    def max_tokens_per_dispatch(self) -> int:
        """The most positions one window may write past a slot's length
        (``tokens_per_dispatch`` without speculation)."""
        if not self.spec_enabled:
            return self.tokens_per_dispatch
        return self.spec_steps * (self.spec_tokens + 1)

    def write_horizon(self, draft: Optional[int] = None) -> int:
        """Positions one window at depth ``draft`` (None: the configured
        one) may write past a slot's length — the span the paged engine
        makes exclusively writable: ``steps * (draft + 1)`` for the
        chain, K without speculation; a tree window's last step also
        parks every branch node before compaction, so ``(steps - 1) *
        (draft + 1) + 1 + W * draft``."""
        if not self.spec_enabled:
            return self.tokens_per_dispatch
        d = self.spec_tokens if draft is None else int(draft)
        steps = self._spec_steps_for(d)
        w = self.spec_tree_width
        if w > 1:
            return (steps - 1) * (d + 1) + 1 + w * d
        return steps * (d + 1)

    @property
    def max_write_horizon(self) -> int:
        """:meth:`write_horizon` over every depth 1 .. ``spec_tokens``."""
        if not self.spec_enabled:
            return self.tokens_per_dispatch
        return max(self.write_horizon(d)
                   for d in range(1, self.spec_tokens + 1))

    def _draft(self, draft: Optional[int]) -> int:
        d = self.spec_tokens if draft is None else int(draft)
        if not 1 <= d <= self.spec_tokens:
            raise ValueError(
                f"draft override {d} outside [1, {self.spec_tokens}]")
        return d

    # -- caches ---------------------------------------------------------

    def init_cache(self, slots: int, max_len: int) -> KVCache:
        return init_cache(self.cfg, slots, max_len, dtype=self.cache_dtype,
                          device=self.device)

    def init_paged_cache(self, num_pages: int, slots: int,
                         page_len: int) -> PagedKVCache:
        dtype = torch.int8 if self.kv_int8 else self.cache_dtype
        return init_paged_cache(self.cfg, num_pages, slots, page_len,
                                dtype=dtype, device=self.device)

    def _ints(self, x) -> torch.Tensor:
        """Host ints (numpy, lists) -> a contiguous int32 device tensor."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.int32).contiguous()
        a = np.ascontiguousarray(np.asarray(x, dtype=np.int32))
        return torch.from_numpy(a).to(self.device)

    def _window_args(self, tokens, active, samp):
        tok = self._ints(tokens)
        act = torch.as_tensor(np.asarray(active, bool) if not isinstance(
            active, torch.Tensor) else active).to(self.device)
        if samp is None:
            samp = SamplingParams.make(tok.shape[0], self.temperature,
                                       device=self.device)
        return tok, act, samp

    # -- the window loops -----------------------------------------------

    def _window(self, cache, tok, act, generator, samp, smax: int,
                step: Callable) -> torch.Tensor:
        """K decode steps: ``step(tokens, lengths)`` -> (B, V) logits
        writes each new token's K/V; returns the (K, slots) tokens."""
        out = torch.empty((self.tokens_per_dispatch, tok.shape[0]),
                          dtype=torch.int32, device=self.device)
        n_active = act.sum()
        for i in range(self.tokens_per_dispatch):
            nxt = _sample_params(step(tok, cache.lengths), generator, samp)
            tok = torch.where(act, nxt, tok)
            cache.lengths.copy_(torch.where(
                act, torch.clamp(cache.lengths + 1, max=smax),
                cache.lengths))
            cache.decoded += n_active
            out[i] = tok
        return out

    def _spec_window(self, cache, tok, act, hist, generator, samp,
                     draft: int, smax: int, step: Callable,
                     block: Callable, tables=None) -> torch.Tensor:
        """``spec_steps`` propose -> verify -> accept steps.
        ``step(tokens, lengths, n_layers)`` -> (B, V) is the shallow
        draft's truncated step, ``block(tokens, lengths)`` -> (B, T, V)
        the verify forward (a tree block when ``tables`` is given: the
        paged tree window); both write their K/V in place.  Returns one
        (steps, slots, draft + 2) int32 buffer: the candidate tokens in
        ``[..., :draft + 1]``, the accepted counts in ``[..., draft +
        1]``; a tree window adds the winning branch in ``[..., -1]``."""
        steps = self._spec_steps_for(draft)
        tree = tables is not None
        hs = self._ints(hist)
        out = torch.empty((steps, tok.shape[0], draft + 2 + tree),
                          dtype=torch.int32, device=self.device)
        hrange = torch.arange(hs.shape[1], device=self.device)
        for i in range(steps):
            ln = cache.lengths
            if tree:
                targ, n_acc, rstar = self._tree_verify(
                    tok, ln, hs, generator, samp, draft, smax, block)
            else:
                if self.spec_proposer == "shallow":
                    # the first E layers draft token by token, writing
                    # their own K/V at the draft positions; the verify
                    # block below overwrites them before anything reads
                    # them
                    dtok, dln, ds = tok, ln, []
                    for _ in range(draft):
                        lgt = step(dtok, dln, self.spec_exit_layers)
                        dtok = torch.argmax(lgt, dim=-1).to(torch.int32)
                        ds.append(dtok)
                        dln = torch.clamp(dln + 1, max=smax - 1)
                    drafts = torch.stack(ds, dim=1)
                else:
                    drafts = propose_ngram(hs, draft)
                logits = block(torch.cat([tok[:, None], drafts], dim=1), ln)
                targ = _sample_params(logits, generator, samp)  # (B, 1 + D)
                ok = torch.cumprod((drafts == targ[:, :-1]).to(torch.int32),
                                   1)
                n_acc = 1 + ok.sum(dim=1, dtype=torch.int32)  # in [1, 1 + D]
            n_eff = torch.where(act, torch.minimum(n_acc, smax - ln), 0)
            new_tok = torch.gather(targ, 1, (n_acc - 1).long()[:, None])
            tok = torch.where(act, new_tok[:, 0], tok)
            hs = torch.gather(torch.cat([hs, targ], dim=1), 1,
                              n_eff.long()[:, None] + hrange)
            if tree:
                self._tree_compact(cache, tables, ln, rstar, n_eff, act,
                                   draft)
                out[i, :, -1] = rstar
            cache.lengths.copy_(ln + n_eff)
            cache.decoded += n_eff.sum()
            out[i, :, :draft + 1] = targ
            out[i, :, draft + 1] = n_acc
        return out

    def _tree_verify(self, tok, ln, hs, generator, samp, draft: int,
                     smax: int, block: Callable):
        """One tree step's propose, verify and branch choice: the W
        n-gram branches in one ``block`` forward, a target sampled at
        every node, each branch's longest accepted prefix (draft j is
        accepted iff every draft up to j equals the target sampled at
        its predecessor node: the root for j = 0), the first longest
        branch (ties to branch 0, the chain's draft; branch 0 also near
        the capacity limit, where the parked branches' writes clamp onto
        one slot).  Returns the winner's (B, draft + 1) targets, its
        accepted counts and the winning branch, (B,) int32."""
        w = self.spec_tree_width
        b, dev = tok.shape[0], tok.device
        drafts = propose_ngram_tree(hs, draft, w)  # (B, W, D)
        logits = block(torch.cat([tok[:, None], drafts.reshape(b, w * draft)],
                                 dim=1), ln)
        targ = _sample_params(logits, generator, samp)  # (B, 1 + W * D)
        jd = torch.arange(draft, dtype=torch.int32, device=dev)
        node = 1 + torch.arange(w, dtype=torch.int32, device=dev)[:, None] \
            * draft + jd  # (W, D): branch r's j-th node
        prev = torch.cat([torch.zeros((w, 1), dtype=torch.int32, device=dev),
                          node[:, :-1]], dim=1)
        ok = torch.cumprod((drafts == targ[:, prev.long()]).to(torch.int32),
                           dim=2)
        n_acc_r = 1 + ok.sum(dim=2, dtype=torch.int32)  # (B, W)
        rstar = torch.argmax(n_acc_r, dim=1).to(torch.int32)
        rstar = torch.where(ln + w * draft <= smax - 1, rstar, 0)
        n_acc = torch.gather(n_acc_r, 1, rstar.long()[:, None])[:, 0]
        sel = torch.cat([torch.zeros((b, 1), dtype=torch.int32, device=dev),
                         1 + rstar[:, None] * draft + jd], dim=1)
        return torch.gather(targ, 1, sel.long()), n_acc, rstar

    @staticmethod
    def _tree_compact(cache: PagedKVCache, tables: torch.Tensor,
                      ln: torch.Tensor, rstar: torch.Tensor,
                      n_eff: torch.Tensor, active: torch.Tensor,
                      draft: int) -> None:
        """Move the winning branch's parked K/V (and int8 scales) into
        the chain slots, IN PLACE.  The tree block parks branch r's node
        j at slot ``ln + 1 + r * draft + j``; acceptance commits nodes
        ``0 .. n_eff - 2`` of branch ``rstar`` to slots ``ln + 1 ..``.
        Rows that do not move (branch 0 is already in place, inactive
        rows, nodes past the accepted ones) copy a slot onto itself, so
        the index shapes are static and nothing syncs with the host.
        The gather happens before the scatter, and a moving row's
        sources lie strictly above its destinations: no aliasing.  Pages
        of the write horizon are a slot's own, so rows collide only on
        the trash page."""
        pl = cache.page_len
        smax = tables.shape[1] * pl
        dev = tables.device
        jd = torch.arange(draft, dtype=torch.int32, device=dev)
        dst = torch.clamp(ln[:, None] + 1 + jd, max=smax - 1)
        src = torch.clamp(ln[:, None] + 1 + rstar[:, None] * draft + jd,
                          max=smax - 1)
        move = (active[:, None] & (rstar > 0)[:, None]
                & (jd < (n_eff - 1)[:, None]))
        src = torch.where(move, src, dst).long()
        dst = dst.long()
        tl = tables.long()
        bidx = torch.arange(tables.shape[0], device=dev)[:, None]
        ps, os_ = tl[bidx, src // pl], src % pl
        pd, od = tl[bidx, dst // pl], dst % pl
        for arr in (cache.k, cache.v, cache.k_scale, cache.v_scale):
            if arr is not None:
                arr[pd, :, :, od] = arr[ps, :, :, os_]

    # -- contiguous execution -------------------------------------------

    @torch.no_grad()
    def prefill(self, cache: KVCache, slots, input_ids,
                lengths) -> torch.Tensor:
        """Write a right-padded prompt batch ``input_ids`` (B, P) with
        ``lengths`` (B,) into cache ``slots`` (B,) in place, and set their
        lengths.  Returns fp32 (B, V) logits at each prompt's last valid
        position."""
        slots = self._ints(slots).long()
        ids = self._ints(input_ids).long()
        lengths = self._ints(lengths)
        logits, ks, vs = self.model.prefill(ids, lengths)
        p = ids.shape[1]
        cache.k[slots, :, :, :p] = ks.to(cache.k.dtype)
        cache.v[slots, :, :, :p] = vs.to(cache.v.dtype)
        cache.lengths[slots] = lengths
        return logits

    @torch.no_grad()
    def decode_window(
        self, cache: KVCache, tokens, active,
        generator: Optional[torch.Generator] = None,
        samp: Optional[SamplingParams] = None,
    ) -> torch.Tensor:
        """K decode steps over every slot of the contiguous cache, with
        no host sync inside.  ``tokens`` (slots,) the last sampled token
        per slot, ``active`` (slots,) bool: inactive slots decode garbage
        that never advances their length or the token meter; lengths stop
        at ``cache.max_len``.  Returns the (K, slots) int32 tokens as a
        device tensor."""
        tok, act, samp = self._window_args(tokens, active, samp)
        return self._window(
            cache, tok, act, generator, samp, cache.max_len,
            lambda t, ln: self.model.decode_step(t, cache.k, cache.v, ln))

    @torch.no_grad()
    def spec_decode_window(
        self, cache: KVCache, tokens, active, hist,
        generator: Optional[torch.Generator] = None,
        samp: Optional[SamplingParams] = None,
        draft: Optional[int] = None,
    ) -> torch.Tensor:
        """One self-speculative window over the contiguous cache:
        ``spec_steps`` propose -> verify -> accept steps over every slot.

        ``hist`` (slots, spec_hist) int32, each slot's trailing tokens
        with its current token last (``-1`` padding; the engine keeps it
        on the host from the tokens it fetches); ``draft`` overrides the
        configured depth for this window (1 .. ``spec_tokens``).  Returns
        one (steps, slots, draft + 2) int32 device buffer, so that the
        host reads it with one copy: ``[..., :-1]`` the candidate tokens,
        ``[..., -1]`` the accepted counts; slot s emits ``buf[i, s,
        :buf[i, s, -1]]`` at step i."""
        d = self._draft(draft)
        tok, act, samp = self._window_args(tokens, active, samp)
        return self._spec_window(
            cache, tok, act, hist, generator, samp, d, cache.max_len,
            lambda t, ln, n: self.model.decode_step(
                t, cache.k, cache.v, ln, n_layers=n),
            lambda t, ln: self.model.decode_block(t, cache.k, cache.v, ln))

    # -- paged execution ------------------------------------------------

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
        tables = self._ints(tables)
        tok, act, samp = self._window_args(tokens, active, samp)
        return self._window(
            cache, tok, act, generator, samp,
            tables.shape[1] * cache.page_len,
            lambda t, ln: self.model.paged_decode_step(
                t, cache.k, cache.v, tables, ln, k_scale=cache.k_scale,
                v_scale=cache.v_scale))

    @torch.no_grad()
    def paged_spec_decode_window(
        self, cache: PagedKVCache, tables, tokens, active, hist,
        generator: Optional[torch.Generator] = None,
        samp: Optional[SamplingParams] = None,
        draft: Optional[int] = None,
    ) -> torch.Tensor:
        """:meth:`spec_decode_window` over the page pool: verify blocks
        and shallow drafts read and write through ``tables``.  The host
        must have made each active slot's ``[len, len +
        write_horizon(draft))`` range exclusively writable.  Returns the
        same one-buffer result."""
        d = self._draft(draft)
        tables = self._ints(tables)
        tok, act, samp = self._window_args(tokens, active, samp)
        kw = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
        return self._spec_window(
            cache, tok, act, hist, generator, samp, d,
            tables.shape[1] * cache.page_len,
            lambda t, ln, n: self.model.paged_decode_step(
                t, cache.k, cache.v, tables, ln, n_layers=n, **kw),
            lambda t, ln: self.model.paged_decode_block(
                t, cache.k, cache.v, tables, ln, **kw))

    @torch.no_grad()
    def paged_tree_spec_decode_window(
        self, cache: PagedKVCache, tables, tokens, active, hist,
        generator: Optional[torch.Generator] = None,
        samp: Optional[SamplingParams] = None,
        draft: Optional[int] = None,
    ) -> torch.Tensor:
        """The tree-speculative paged window (``spec_tree`` W >= 2):
        each of ``spec_steps`` steps proposes W n-gram branches
        (:func:`propose_ngram_tree`), verifies them in one
        :meth:`~apex_tpu_torch.models.GPTLM.paged_decode_tree_block`
        forward, takes the longest accepted branch and compacts its K/V
        into the chain slots.  The host must have made each active
        slot's ``[len, len + write_horizon(draft))`` range exclusively
        writable (the tree parks every branch before compaction).
        Returns one (steps, slots, draft + 3) int32 device buffer, read
        by the host with one copy: the winner's D + 1 candidate tokens,
        its accepted count and the winning branch."""
        if self.spec_tree_width < 2:
            raise ValueError(
                "paged_tree_spec_decode_window needs spec_tree >= 2")
        d = self._draft(draft)
        tables = self._ints(tables)
        tok, act, samp = self._window_args(tokens, active, samp)
        w = self.spec_tree_width
        return self._spec_window(
            cache, tok, act, hist, generator, samp, d,
            tables.shape[1] * cache.page_len, None,
            lambda t, ln: self.model.paged_decode_tree_block(
                t, cache.k, cache.v, tables, ln, k_scale=cache.k_scale,
                v_scale=cache.v_scale, width=w, depth=d),
            tables=tables)

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

    # -- handoff: the pages' contents to and from the host ----------------

    @torch.no_grad()
    def gather_pages(self, cache: PagedKVCache, pages):
        """The contents of physical ``pages`` (logical order) on the host:
        ``(k, v, k_scale, v_scale)`` CPU tensors of leading dim
        ``len(pages)``, the scales None on fp32/bf16 pools.  The export
        half of a handoff; the cache is only read, so the source keeps
        serving.  JAX pads the ids to a power-of-two bucket to reuse its
        compiled programs; the port compiles nothing and reads the exact
        pages.  Under tensor parallelism each rank's head block is
        all-gathered over the axis (tag ``tp_handoff``), so every rank
        returns every head."""
        if len(pages) < 1:
            raise ValueError("gather_pages needs at least one page")
        ids = self._ints(pages).long()
        out = [cache.k[ids], cache.v[ids]]
        if cache.k_scale is not None:
            out += [cache.k_scale[ids], cache.v_scale[ids]]
        axis = self.cfg.decode_tp_axis
        if axis is not None and axis.size > 1:
            out = [all_gather(t, axis, dim=2, tag="tp_handoff") for t in out]
        out = [t.cpu() for t in out]
        if len(out) == 2:
            out += [None, None]
        return tuple(out)

    @torch.no_grad()
    def adopt_pages(self, cache: PagedKVCache, pages, k, v, k_scale,
                    v_scale, slot: int, length: int) -> None:
        """Scatter transferred page contents (host tensors of every head,
        as :meth:`gather_pages` returns them) into physical ``pages`` and
        set ``slot``'s length to ``length`` on the device, in place: the
        import half of a handoff.  A rank of a tensor-parallel decoder
        takes its own head block.  The host copies are plain pageable
        ones, done when the call returns, so the caller may drop the
        container at once."""
        ids = self._ints(pages).long()
        h0, nh = 0, self.cfg.local_heads
        if self.cfg.decode_tp_axis is not None:
            h0 = self.cfg.decode_tp_axis.index * nh

        def put(dst, src):
            dst[ids] = src[:, :, h0:h0 + nh].to(self.device, dst.dtype)

        put(cache.k, k)
        put(cache.v, v)
        if cache.k_scale is not None:
            put(cache.k_scale, k_scale)
            put(cache.v_scale, v_scale)
        cache.lengths[int(slot)] = int(length)

    def reset_programs(self) -> None:
        """The restart hook of :mod:`apex_tpu_torch.resilience` (JAX's
        drops the decoder's jit cache, so a restarted process re-traces).
        The eager port keeps no compiled program and no other host state
        per decoder: the model, its weights and the settings are what a
        restarted process would build again, so there is nothing to drop
        and this does nothing.  The kernel libraries are loaded once per
        process (:mod:`apex_tpu_torch.ops._build`) and stay loaded, so a
        restart inside one process builds and loads nothing.  Engine
        crash recovery keeps the decoder and does not call this;
        :meth:`with_params` clones share what they shared before."""

    def with_params(self, params: Dict[str, torch.Tensor]) -> "GPTDecoder":
        """A clone of this decoder serving ``params``: its own
        :class:`~apex_tpu_torch.models.GPTLM`, loaded and cast as the
        constructor does, while this decoder keeps serving its weights
        (two engines that share a decoder can swap one at a time).  The
        new state dict must match the one this decoder was built from in
        keys, shapes and dtypes, checked before anything is built: a
        geometry change needs a new decoder."""
        old = self.params
        if set(old) != set(params):
            missing = sorted(set(old) - set(params))
            extra = sorted(set(params) - set(old))
            raise ValueError(
                f"with_params: the new state dict's keys differ from the "
                f"served ones (missing {missing[:4]}, extra {extra[:4]}) — "
                "a geometry change needs a new decoder")
        for name in sorted(old):
            a, b = old[name], params[name]
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"with_params: leaf {name!r} changed from {a.dtype}"
                    f"{tuple(a.shape)} to {b.dtype}{tuple(b.shape)} — a "
                    "geometry change needs a new decoder")
        clone = copy.copy(self)
        clone.params = params
        clone.model = self._serving_model(params)
        return clone


@torch.no_grad()
def reference_generate(
    cfg: GPTConfig,
    params: Dict[str, torch.Tensor],
    prompt_ids: Sequence[int],
    n_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    pad_to: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> List[int]:
    """The per-token full-recompute oracle: each token runs the whole
    training forward (``GPTLM.forward``, no cache, no dropout) over the
    sequence so far and samples from its last position.  The cached
    engines must give the same greedy tokens.

    The sequence lies in a right-padded buffer of ``pad_to`` tokens
    (default: the final length rounded up to a power of two, at least
    8): causal attention makes position ``len - 1`` independent of the
    padding.  ``device`` None is the CUDA device, as for every entry
    point."""
    dev = resolve_device(device)
    total = len(prompt_ids) + n_tokens
    if pad_to is None:
        pad_to = 8
        while pad_to < total:
            pad_to *= 2
    if pad_to < total or pad_to > cfg.max_position:
        raise ValueError(f"pad_to {pad_to} must fit prompt+n_tokens "
                         f"({total}) and max_position ({cfg.max_position})")
    cfg = dataclasses.replace(cfg, dropout_rate=0.0, attn_dropout_rate=0.0,
                              remat_policy="none")
    with torch.device(dev):
        model = GPTLM(cfg)
    model.load_state_dict(params)
    model.requires_grad_(False)
    model.eval()
    buf = torch.zeros((1, pad_to), dtype=torch.long, device=dev)
    cur = len(prompt_ids)
    buf[0, :cur] = torch.as_tensor(list(prompt_ids), dtype=torch.long)
    out = []
    for _ in range(n_tokens):
        logits = model(buf)[0, cur - 1]
        tok = int(sample_tokens(logits[None], generator, temperature)[0])
        out.append(tok)
        if cur < pad_to:
            buf[0, cur] = tok
        cur += 1
    return out
