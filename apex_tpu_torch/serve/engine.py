"""ServeEngine — continuous batching over the paged or the contiguous KV
cache, with chain and tree self-speculative decoding.

Counterpart of ``apex_tpu/serve/engine.py``, FIFO admission only.
Requests queue on the host; at each dispatch boundary the paged engine
(1) admits queued requests into free slots under the page budget,
mapping shared prompt prefixes onto the same physical pages, (2)
advances every in-flight prefill by one bucket-padded chunk, (3) makes
every active slot's next write horizon exclusively writable
(copy-on-write, fresh tail pages, or preemption when the pool is dry)
and runs ONE decode window over all slots, then (4) fetches the
window's tokens in one host sync and retires finished requests.  The
contiguous engine (``paged=False``) admits into free slots with one
batched, bucket-padded prefill instead, and has no pages to plan.

A preempted request frees its pages and re-enters the queue at the
front, to be re-prefilled from prompt + tokens so far; under greedy
decoding the recompute reproduces the same tokens.

With a speculative decoder (``spec_tokens`` > 0) the window is a spec
window: the engine keeps each slot's token history on the host (the
n-gram proposer's input), consumes each verify step's accepted tokens,
and counts drafts, accepted drafts and rollbacks (``stats()["spec"]``).
A tree decoder (``spec_tree`` >= 2, paged only) runs the tree window and
counts the steps a branch other than 0 won.  ``spec_autotune`` walks the
draft depth between 1 and ``spec_tokens`` from the accepted counts of
the last :data:`ServeEngine.AUTOTUNE_PERIOD` verify steps.

Tensor-parallel serving: over a decoder built with a mesh
(``GPTDecoder(mesh=serve_mesh(tp))``), every rank of the axis runs its
own engine over the same request stream, with the same seed.  Each rank
holds its head shard of the pool and makes every host decision itself
(admission, chunking, the prefix registry, copy-on-write, preemption,
the sampling generator's draws); they agree because their inputs do,
and a token that differed between ranks would desynchronise the gang.
``stats()["tensor_parallel"]`` reports the degree and the head
all-reduces of the last window and in all.

Not ported yet: handoff and weight swaps, and the obs, SLO,
flight-recorder and fault-injection planes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.ops import launch_counts
from apex_tpu_torch.parallel.mesh import collective_counts
from apex_tpu_torch.serve.decode import GPTDecoder, SamplingParams, sample_tokens
from apex_tpu_torch.serve.kv_cache import PagePool, SlotAllocator, auto_page_len

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state
    (``temperature=None`` defers to the decoder's default)."""

    uid: int
    prompt: List[int]
    max_new_tokens: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    truncated: bool = False  # hit cache capacity before EOS/budget
    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0


class ServeEngine:
    """Continuous-batching scheduler around a :class:`GPTDecoder`.

    Args:
      decoder: the model, its device, K, the default temperature and
        the speculative settings.
      slots: concurrent sequences.
      max_len: cache columns per slot (default ``max_position``); a
        prompt needs ``len(prompt) < max_len``.
      eos_id: token that ends a sequence (None: run to the budget).
      seed: seed of the sampling generator (on the decoder's device).
      paged: the paged KV cache (default) or the contiguous one
        (``False``: every slot owns ``max_len`` columns, no prefix
        sharing, no preemption).
      page_len: tokens per page (None: the largest power of two <= 16
        dividing ``max_len``).
      num_pages: pool size including the trash page (None: ``1 + slots
        * max_len / page_len``, room for every slot at full length).
      prefill_chunk: most prompt tokens prefilled per request per
        boundary; chunks pad to power-of-two buckets (minimum 8).
      spec_autotune: the draft-depth auto-tuner (off without
        speculation): every :data:`AUTOTUNE_PERIOD` consumed verify
        steps it deepens the draft when the mean accepted count is at
        least 0.8 (D + 1) and shallows it when it is at most max(1.25,
        0.3 (D + 1)), within [1, ``spec_tokens``]; each window runs at
        the tuner's depth.
    """

    #: consumed verify steps between two auto-tuner decisions
    AUTOTUNE_PERIOD = 8

    def __init__(
        self,
        decoder: GPTDecoder,
        slots: int = 4,
        max_len: Optional[int] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        paged: bool = True,
        page_len: Optional[int] = None,
        num_pages: Optional[int] = None,
        prefill_chunk: int = 64,
        spec_autotune: bool = False,
    ):
        self.decoder = decoder
        self.max_len = int(decoder.cfg.max_position if max_len is None
                           else max_len)
        self.eos_id = eos_id
        self.paged = bool(paged)
        self._spec = decoder.spec_enabled
        # the tree parks sibling branches in pool slots past the length,
        # which the contiguous layout lacks
        self._tree = self._spec and decoder.spec_tree_width > 1
        if self._tree and not self.paged:
            raise ValueError(
                "tree speculation (spec_tree > 1) requires the paged cache: "
                "sibling branches park in pool slots past the committed "
                "length, which the contiguous layout lacks")
        if self.paged:
            self.page_len = (auto_page_len(self.max_len) if page_len is None
                             else int(page_len))
            if self.page_len < 1 or self.max_len % self.page_len:
                raise ValueError(f"page_len {self.page_len} must divide "
                                 f"max_len {self.max_len}")
            pages_per_slot = self.max_len // self.page_len
            self.num_pages = (1 + slots * pages_per_slot if num_pages is None
                              else int(num_pages))
            if prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            self.prefill_chunk = int(prefill_chunk)
            self.pool = PagePool(self.num_pages, self.page_len, slots,
                                 pages_per_slot)
            self.cache = decoder.init_paged_cache(self.num_pages, slots,
                                                  self.page_len)
        else:
            self.cache = decoder.init_cache(slots, self.max_len)
        self.alloc = SlotAllocator(slots)
        self._queue: Deque[Request] = deque()
        self._active: Dict[int, Request] = {}  # slot -> request
        # slot -> [request, context tokens, next chunk offset]
        self._prefilling: Dict[int, list] = {}
        self._last_token = np.zeros((slots,), np.int32)
        self._slot_len = np.zeros((slots,), np.int64)  # host mirror
        self._samp_t = np.zeros((slots,), np.float32)
        self._samp_k = np.zeros((slots,), np.int32)
        self._samp_p = np.ones((slots,), np.float32)
        self._samp_mp = np.zeros((slots,), np.float32)
        # speculation: the host copy of each slot's trailing tokens, the
        # n-gram proposer's input (rebuilt from the fetched tokens, so
        # it goes to every window as a plain argument)
        if self._spec:
            self._hist = np.full((slots, decoder.spec_hist), -1, np.int32)
        self._accepted_hist: Dict[int, int] = {}
        # the tree's winning branch a consumed step, and the steps a
        # branch other than 0 (the chain's draft) won
        self._tree_branch_hist: Dict[int, int] = {}
        self.tree_branch_wins = 0
        # the draft auto-tuner: its depth, the accepted counts since its
        # last decision, and (window, new depth) at each move
        self.spec_autotune = bool(spec_autotune) and self._spec
        self._auto_draft = decoder.spec_tokens if self._spec else 0
        self._auto_window: List[int] = []
        self._auto_traj: List[tuple] = []
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rollbacks = 0
        self._gen = torch.Generator(device=decoder.device)
        self._gen.manual_seed(seed)
        self._next_uid = 0
        self.results: Dict[int, Request] = {}
        self.prefill_dispatches = 0
        self.decode_dispatches = 0
        self.cow_dispatches = 0
        self.preemptions = 0
        self.prompt_tokens = 0
        self.peak_live_tokens = 0
        # tensor parallelism: head all-reduces of the last window, in all
        self.tp_window_collectives = 0
        self.tp_collectives = 0

    # -- request intake -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None, top_k: int = 0,
               top_p: float = 1.0, min_p: float = 0.0) -> int:
        """Queue a request; returns its uid.  Admission happens at the
        next dispatch boundary (:meth:`step`/:meth:`run`)."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt length {len(prompt)} needs at least "
                             f"one free cache column (max_len={self.max_len})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if top_k < 0 or not 0.0 < top_p <= 1.0 or not 0.0 <= min_p <= 1.0:
            raise ValueError(f"bad sampling params: top_k={top_k} "
                             f"top_p={top_p} min_p={min_p}")
        uid = self._next_uid
        self._next_uid += 1
        self._queue.append(Request(
            uid, prompt, int(max_new_tokens), temperature=temperature,
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p)))
        return uid

    # -- per-slot sampling params ---------------------------------------

    def _req_samp(self, r: Request):
        t = (self.decoder.temperature if r.temperature is None
             else float(r.temperature))
        return t, r.top_k, r.top_p, r.min_p

    def _bind_samp(self, r: Request, slot: int) -> None:
        (self._samp_t[slot], self._samp_k[slot], self._samp_p[slot],
         self._samp_mp[slot]) = self._req_samp(r)

    def _reset_samp(self, slot: int) -> None:
        self._samp_t[slot] = 0.0
        self._samp_k[slot] = 0
        self._samp_p[slot] = 1.0
        self._samp_mp[slot] = 0.0

    def _samp_params(self) -> SamplingParams:
        return SamplingParams.make(
            len(self._samp_t), self._samp_t, self._samp_k, self._samp_p,
            self._samp_mp, device=self.decoder.device)

    def _sample_first(self, logits, batch: List[Request]) -> List[int]:
        """Sample each request's FIRST token from its prefill logits (one
        row a request) with its own params."""
        ts, ks, ps, mps = zip(*(self._req_samp(r) for r in batch))
        tok = sample_tokens(logits, self._gen, np.asarray(ts, np.float32),
                            top_k=np.asarray(ks, np.int32),
                            top_p=np.asarray(ps, np.float32),
                            min_p=np.asarray(mps, np.float32))
        return tok.cpu().tolist()

    # -- lifecycle ------------------------------------------------------

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad chunks to power-of-two widths (min 8), so a serving run
        sees a few chunk shapes, not one per length."""
        p = 8
        while p < n:
            p *= 2
        return p

    def _activate(self, r: Request, slot: int, ctx: List[int]) -> None:
        """Slot activation: sampling params bound, and the spec history
        seeded from the context (the first sampled token lands through
        the following :meth:`_append`)."""
        self._active[slot] = r
        self._slot_len[slot] = len(ctx)
        self._bind_samp(r, slot)
        if self._spec:
            h = self._hist.shape[1]
            tail = ctx[-h:]
            self._hist[slot] = -1
            self._hist[slot, h - len(tail):] = tail

    def _append(self, r: Request, token: int) -> None:
        """Record one generated token; retire on EOS or budget."""
        r.tokens.append(token)
        if self._spec:
            row = self._hist[r.slot]
            row[:-1] = row[1:]
            row[-1] = token
        if (self.eos_id is not None and token == self.eos_id) or (
                len(r.tokens) >= r.max_new_tokens):
            self._finish(r)
        else:
            self._last_token[r.slot] = token

    def _finish(self, r: Request, truncated: bool = False) -> None:
        r.done = True
        r.truncated = truncated
        self.results[r.uid] = r
        if self.paged:
            self.pool.release_slot(r.slot)
        self.alloc.free(r.slot)
        self._active.pop(r.slot, None)
        self._reset_samp(r.slot)
        r.slot = None

    # -- contiguous admission -------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the queue with ONE batched prefill, the
        prompts right-padded to a power-of-two bucket."""
        batch: List[Request] = []
        while self._queue and self.alloc.n_free:
            r = self._queue.popleft()
            r.slot = self.alloc.allocate()
            batch.append(r)
        if not batch:
            return
        p = min(self._bucket(max(len(r.prompt) for r in batch)),
                self.max_len)
        ids = np.zeros((len(batch), p), np.int32)
        for i, r in enumerate(batch):
            ids[i, :len(r.prompt)] = r.prompt
        logits = self.decoder.prefill(
            self.cache, [r.slot for r in batch], ids,
            [len(r.prompt) for r in batch])
        self.prefill_dispatches += 1
        for r, first in zip(batch, self._sample_first(logits, batch)):
            self._activate(r, r.slot, r.prompt)
            self._append(r, first)

    # -- paged scheduling -----------------------------------------------

    def _run_copies(self, pairs) -> None:
        """Run copy-on-write page splits in one dispatch, padded with
        ``0 -> 0`` identity rows to a power-of-two width."""
        if not pairs:
            return
        width = 1
        while width < len(pairs):
            width *= 2
        src = np.zeros((width,), np.int32)
        dst = np.zeros((width,), np.int32)
        for i, (s, d) in enumerate(pairs):
            src[i], dst[i] = s, d
        self.decoder.copy_pages(self.cache, src, dst)
        self.cow_dispatches += 1

    def _evict(self, r: Request) -> None:
        """Preempt a request when the pool runs dry: free its pages and
        slot, and re-queue it at the front for recompute."""
        slot = r.slot
        self.pool.release_slot(slot)
        self.alloc.free(slot)
        self._active.pop(slot, None)
        self._prefilling.pop(slot, None)
        self._reset_samp(slot)
        r.slot = None
        self.preemptions += 1
        self._queue.appendleft(r)

    def _admit_paged(self) -> None:
        """Admit queued requests FIFO into free slots under the page
        budget: the head needs pages for its non-shared context plus one
        headroom page, or everyone waits.  Shared-prefix pages are mapped
        here; prefill starts at the first non-shared token."""
        while self._queue and self.alloc.n_free:
            r = self._queue[0]
            ctx = r.prompt + r.tokens  # re-prefill context on preemption
            if len(ctx) >= self.max_len:
                # a preempted request that was already at capacity
                self._queue.popleft()
                r.done = True
                r.truncated = True
                self.results[r.uid] = r
                continue
            pages, shared = self.pool.match_prefix(ctx)
            pl = self.page_len
            need = (len(ctx) + pl) // pl - len(pages) + 1
            if self.pool.n_free < need:
                break
            self._queue.popleft()
            slot = self.alloc.allocate()
            r.slot = slot
            self.pool.share(slot, pages, shared)
            self.prompt_tokens += len(ctx)
            # a fully shared context still re-runs its LAST token as a
            # 1-token chunk: its logits seed sampling
            self._prefilling[slot] = [r, ctx, min(shared, len(ctx) - 1)]

    def _prefill_chunks(self) -> None:
        """Advance every in-flight prefill by ONE chunk; a request whose
        final chunk lands samples its first token and becomes active, and
        its prompt pages are published for prefix reuse."""
        if not self._prefilling:
            return
        pending = []
        pairs = []
        for slot, entry in list(self._prefilling.items()):
            r, ctx, base = entry
            n = min(self.prefill_chunk, len(ctx) - base)
            copies = self.pool.ensure_writable(slot, base, base + n)
            if copies is None:
                self._evict(r)
                continue
            pairs.extend(copies)
            pending.append((slot, entry, n))
        self._run_copies(pairs)
        for slot, entry, n in pending:
            r, ctx, base = entry
            ids = np.zeros((1, self._bucket(n)), np.int32)
            ids[0, :n] = ctx[base:base + n]
            logits = self.decoder.prefill_chunk(
                self.cache, self.pool.tables[slot][None],
                np.asarray([slot], np.int32), ids,
                np.asarray([base], np.int32), np.asarray([n], np.int32))
            self.prefill_dispatches += 1
            base += n
            if base >= len(ctx):
                del self._prefilling[slot]
                self.pool.register(slot, ctx)
                first = self._sample_first(logits, [r])[0]
                self._activate(r, slot, ctx)
                self._append(r, first)
            else:
                entry[2] = base

    def _dispatch_draft(self) -> Optional[int]:
        """The next spec window's draft depth: the tuner's under
        auto-tuning, else None (the decoder's ``spec_tokens``)."""
        if self.spec_autotune:
            return self._auto_draft
        return None

    def _autotune_update(self) -> None:
        """Once :data:`AUTOTUNE_PERIOD` accepted counts have gathered:
        deepen the draft when their mean is at least 0.8 (D + 1) (nearly
        every draft lands), shallow it when the mean is at most max(1.25,
        0.3 (D + 1)) (drafts mostly roll back), within [1,
        ``spec_tokens``], and record each move."""
        if len(self._auto_window) < self.AUTOTUNE_PERIOD:
            return
        mean = sum(self._auto_window) / len(self._auto_window)
        self._auto_window.clear()
        d = self._auto_draft
        if mean >= 0.8 * (d + 1) and d < self.decoder.spec_tokens:
            self._auto_draft = d + 1
        elif mean <= max(1.25, 0.3 * (d + 1)) and d > 1:
            self._auto_draft = d - 1
        if self._auto_draft != d:
            self._auto_traj.append((self.decode_dispatches, self._auto_draft))

    def _prepare_decode_pages(self) -> None:
        """Before a window: make every active slot's write horizon
        (``decoder.write_horizon`` at the window's draft depth: K, or
        every position a fully accepted spec window writes, a tree's
        parked branches included) exclusively owned and run the copies;
        a slot the pool cannot supply is preempted."""
        k = self.decoder.write_horizon(self._dispatch_draft())
        pairs = []
        for slot, r in list(self._active.items()):
            ln = int(self._slot_len[slot])
            copies = self.pool.ensure_writable(slot, ln, ln + k)
            if copies is None:
                self._evict(r)
                continue
            pairs.extend(copies)
        self._run_copies(pairs)

    # -- the dispatch boundary ------------------------------------------

    def step(self) -> bool:
        """One scheduling round: admit (and prefill chunks when paged),
        one decode window, retire.  Returns False once everything is
        drained."""
        if self.paged:
            self._admit_paged()
            self._prefill_chunks()
        else:
            self._admit()
        if not self._active:
            return bool(self._queue or self._prefilling)
        if self.paged:
            self._prepare_decode_pages()
            if not self._active:
                return bool(self._queue or self._prefilling)
        active = np.zeros((self.cache.slots,), bool)
        active[list(self._active)] = True
        samp = self._samp_params()
        tp0 = collective_counts().get("tp_heads", 0)
        if self._spec:
            draft = self._dispatch_draft()
            if self._tree:
                buf = self.decoder.paged_tree_spec_decode_window(
                    self.cache, self.pool.tables, self._last_token, active,
                    self._hist, self._gen, samp=samp, draft=draft)
            elif self.paged:
                buf = self.decoder.paged_spec_decode_window(
                    self.cache, self.pool.tables, self._last_token, active,
                    self._hist, self._gen, samp=samp, draft=draft)
            else:
                buf = self.decoder.spec_decode_window(
                    self.cache, self._last_token, active, self._hist,
                    self._gen, samp=samp, draft=draft)
        elif self.paged:
            buf = self.decoder.paged_decode_window(
                self.cache, self.pool.tables, self._last_token, active,
                self._gen, samp=samp)
        else:
            buf = self.decoder.decode_window(
                self.cache, self._last_token, active, self._gen, samp=samp)
        self.decode_dispatches += 1
        if self.decoder.tp_degree > 1:
            self.tp_window_collectives = (
                collective_counts().get("tp_heads", 0) - tp0)
            self.tp_collectives += self.tp_window_collectives
        # (K, slots), or (steps, slots, 2 + draft) under speculation (3 +
        # draft for a tree): the one host sync of the window
        buf = buf.cpu().numpy()
        if self._tree:
            self._fetch_spec(buf[..., :-2], buf[..., -2], buf[..., -1])
        elif self._spec:
            self._fetch_spec(buf[..., :-1], buf[..., -1])
        else:
            self._fetch(buf)
        if self.paged:
            live = sum(int(self._slot_len[s]) for s in self._active)
            live += sum(e[2] for e in self._prefilling.values())
            self.peak_live_tokens = max(self.peak_live_tokens, live)
        return bool(self._queue or self._active or self._prefilling)

    def _fetch(self, toks: np.ndarray) -> None:
        """Consume a window's (K, slots) tokens."""
        k = toks.shape[0]
        for slot, r in list(self._active.items()):
            base = self._slot_len[slot]
            for i in range(k):
                if base + i >= self.max_len:
                    # the device clamped this write: tokens from here on
                    # are garbage — capacity retirement
                    self._finish(r, truncated=True)
                    break
                self._append(r, int(toks[i, slot]))
                if r.done:
                    break
            if not r.done:
                self._slot_len[slot] = base + k

    def _fetch_spec(self, toks: np.ndarray, acc: np.ndarray,
                    branches: Optional[np.ndarray] = None) -> None:
        """Consume a spec window's (steps, slots, 1 + draft) candidate
        tokens and (steps, slots) accepted counts: each slot emits
        ``toks[i, s, :acc[i, s]]`` at step i until EOS, budget or
        capacity retires it (a position at ``max_len`` was clamped on
        the device: capacity retirement, as in :meth:`_fetch`).  The
        spec counters, the tree's winning ``branches`` (steps, slots)
        and the auto-tuner's samples stop at the retiring step, so they
        count steps that were consumed."""
        steps, _, d1 = toks.shape
        for slot, r in list(self._active.items()):
            base = self._slot_len[slot]
            count = 0
            for i in range(steps):
                n = int(acc[i, slot])
                self.spec_draft_tokens += d1 - 1
                self.spec_accepted_tokens += n - 1
                self.spec_rollbacks += int(n < d1)
                self._accepted_hist[n] = self._accepted_hist.get(n, 0) + 1
                if self.spec_autotune:
                    self._auto_window.append(n)
                if branches is not None:
                    br = int(branches[i, slot])
                    self._tree_branch_hist[br] = (
                        self._tree_branch_hist.get(br, 0) + 1)
                    self.tree_branch_wins += int(br > 0)
                for j in range(n):
                    if base + count >= self.max_len:
                        self._finish(r, truncated=True)
                        break
                    self._append(r, int(toks[i, slot, j]))
                    count += 1
                    if r.done:
                        break
                if r.done:
                    break
            if not r.done:
                self._slot_len[slot] = base + count
        if self.spec_autotune:
            self._autotune_update()

    def run(self, max_rounds: int = 100_000) -> Dict[int, List[int]]:
        """Drain the queue; returns ``{uid: generated tokens}``."""
        rounds = 0
        while self.step():
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(f"undrained after {max_rounds} rounds")
        return {uid: r.tokens for uid, r in self.results.items()}

    # -- accounting -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Dispatch counters, the device token meter (one fetch), the
        kernels' launch counts, under speculation the ``"spec"`` counters
        and, for the paged engine, page, prefix and preemption counters
        (for the contiguous one, the bytes a slot pins)."""
        s: Dict[str, object] = {
            "decoded_tokens": int(self.cache.decoded),
            "decode_dispatches": self.decode_dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "tokens_per_dispatch": self.decoder.tokens_per_dispatch,
            "requests_done": len(self.results),
            "slots": self.cache.slots,
            "kernel_launches": launch_counts(),
        }
        if self.decoder.tp_degree > 1:
            s["tensor_parallel"] = {
                "degree": self.decoder.tp_degree,
                "axis": self.decoder.tp_axis,
                "all_reduces_last_window": self.tp_window_collectives,
                "all_reduces_windows": self.tp_collectives}
        if self._spec:
            s["spec"] = {
                "draft_tokens": self.spec_draft_tokens,
                "accepted_draft_tokens": self.spec_accepted_tokens,
                "acceptance_rate": round(
                    self.spec_accepted_tokens
                    / max(self.spec_draft_tokens, 1), 4),
                "rollbacks": self.spec_rollbacks,
                "steps_per_dispatch": self.decoder.spec_steps,
                "draft_per_step": self.decoder.spec_tokens,
                "mean_tokens_per_dispatch": round(
                    s["decoded_tokens"] / max(self.decode_dispatches, 1), 2),
                "accepted_per_step_hist": {
                    k: self._accepted_hist[k]
                    for k in sorted(self._accepted_hist)},
            }
            if self._tree:
                s["spec"]["tree"] = {
                    "width": self.decoder.spec_tree_width,
                    "branch_wins": self.tree_branch_wins,
                    "verify_steps": sum(self._tree_branch_hist.values()),
                }
            if self.spec_autotune:
                s["spec"]["autotune"] = {"draft": self._auto_draft,
                                         "trajectory": list(self._auto_traj)}
        if not self.paged:
            s["cache_bytes_per_slot"] = self.cache.bytes_per_slot
            return s
        in_use = self.pool.in_use
        live = sum(int(self._slot_len[sl]) for sl in self._active)
        live += sum(e[2] for e in self._prefilling.values())
        s.update({
            "kv_dtype": str(self.cache.k.dtype).replace("torch.", ""),
            "kv_quantized": self.cache.quantized,
            "page_len": self.page_len,
            "num_pages": self.num_pages,
            "pages_in_use": in_use,
            "peak_pages_in_use": self.pool.peak_in_use,
            "peak_live_tokens": self.peak_live_tokens,
            "cache_bytes_per_page": self.cache.bytes_per_page,
            "fragmentation": (
                round(max(0.0, 1.0 - live / (in_use * self.page_len)), 4)
                if in_use else 0.0),
            "prefix_hits": self.pool.prefix_hits,
            "prefix_hit_tokens": self.pool.prefix_hit_tokens,
            "prefix_hit_rate": round(
                self.pool.prefix_hit_tokens / max(self.prompt_tokens, 1), 4),
            "cow_copies": self.pool.cow_copies,
            "cow_dispatches": self.cow_dispatches,
            "preemptions": self.preemptions,
        })
        return s
