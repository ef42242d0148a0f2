"""ServeEngine — continuous batching over the paged or the contiguous KV
cache, with chain and tree self-speculative decoding.

Counterpart of ``apex_tpu/serve/engine.py``.  Requests queue on the
host; at each dispatch boundary the paged engine
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

Observability (:mod:`apex_tpu_torch.obs`): the scheduling counters live
in a per-engine :class:`~apex_tpu_torch.obs.MetricsRegistry`
(``stats()`` is a snapshot over it), every phase runs inside a span of
the engine's tracer under JAX's names (``serve/admit``,
``serve/prefix_match``, ``serve/prefill``, ``serve/prefill_chunk``,
``serve/cow_plan``, ``serve/cow_copy``, ``serve/decode_window``), with
instants for retirements, preemptions, cancellations and SLO decisions
and boundary records in the flight recorder, and each request's
lifecycle feeds TTFT, inter-token-latency and queue-delay histograms
from one clock read a boundary (``clock=``: the load harness injects a
virtual clock, :mod:`apex_tpu_torch.serve.loadgen`).  All of it is host
work: no launch, no host sync and no token changes with obs on or off
(:func:`apex_tpu_torch.obs.set_enabled`), and with obs off ``stats()``
still counts.

SLO-aware admission (``slo_admission=True``, default off, as in JAX):
the lifecycle feeds TTFT, ITL and queue delay to a live
:class:`~apex_tpu_torch.obs.SloTracker`, and at each boundary the
scheduler consults its burn alerts: priority classes order admission
(FIFO within a class), a page-starved head may be overtaken by one of
the next :data:`ServeEngine.OVERTAKE_SCAN` candidates while the TTFT
budget burns, and prefill chunks yield the boundary to the decode window
while the ITL budget burns.  Only the order changes: under greedy
decoding every request streams the same tokens under both policies.

Disaggregated serving: a prefill-only engine (``prefill_only=True``)
admits and chunk-prefills but runs no decode window; each finished
prefill parks in its slot until :meth:`ServeEngine.export_handoff`
packages its pages as a :class:`~apex_tpu_torch.serve.handoff.KVHandoff`
that a decode engine's :meth:`ServeEngine.adopt` imports, and
:meth:`ServeEngine.detach` frees the source slot.  The streamed variant
ships a long prompt's full pages while its tail still prefills
(:meth:`ServeEngine.export_prefill_chunk`, then
:meth:`ServeEngine.export_handoff_tail`; the destination stages them,
``adopt_stage_begin``/``_chunk``/``_commit``/``_abort``).  A registered
prefix migrates ahead of demand (:meth:`ServeEngine.export_prefix`,
:meth:`ServeEngine.import_prefix`), and :meth:`ServeEngine.swap_weights`
serves new weights with no restart.  Every refusal returns None, the
caller's signal to recompute.

Not ported yet: the fault injector.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import obs
from apex_tpu_torch.checkpoint import state_digest
from apex_tpu_torch.ops import launch_counts
from apex_tpu_torch.parallel.mesh import collective_counts
from apex_tpu_torch.serve.decode import GPTDecoder, SamplingParams, sample_tokens
from apex_tpu_torch.serve.handoff import KVHandoff, KVHandoffChunk
from apex_tpu_torch.serve.kv_cache import (TRASH_PAGE, PagePool, SlotAllocator,
                                           auto_page_len)

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
    # admission class: higher admits first under SLO-aware admission;
    # ignored (pure FIFO) when the policy is off
    priority: int = 0
    # correlation id stamped on the request's lifecycle record,
    # instants and flight-recorder events
    corr: Optional[str] = None


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
      registry: metrics destination (None: a fresh per-engine
        :class:`~apex_tpu_torch.obs.MetricsRegistry`); ``stats()``
        snapshots it.
      tracer: span destination (None: the ambient
        :func:`~apex_tpu_torch.obs.default_tracer`, a no-op with obs
        off).  With a disabled tracer the engine keeps no lifecycle.
      clock: ns-returning monotonic callable stamping every lifecycle
        event (default ``time.perf_counter_ns``; the load harness
        injects a :class:`~apex_tpu_torch.serve.loadgen.VirtualClock`).
      slo_tracker: a live :class:`~apex_tpu_torch.obs.SloTracker` the
        lifecycle feeds and SLO-aware admission consults (None with
        ``slo_admission`` on and the tracer enabled:
        :meth:`~apex_tpu_torch.obs.SloTracker.default_serve`).
      slo_admission: the SLO-aware policy (see the module docstring).
      flightrec: the boundary-event recorder (None: the ambient
        :func:`~apex_tpu_torch.obs.default_flightrec`, a no-op with obs
        off), stamped by its own clock, not by ``clock``.
      prefill_only: a disaggregated prefill engine: it admits and
        chunk-prefills but never runs a decode window; finished prefills
        park in their slots until they are exported and detached.
    """

    #: consumed verify steps between two auto-tuner decisions
    AUTOTUNE_PERIOD = 8
    #: queue candidates (priority-then-FIFO order) a page-starved head's
    #: overtake scans while the TTFT budget burns
    OVERTAKE_SCAN = 4

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
        registry: Optional[obs.MetricsRegistry] = None,
        tracer: Optional[obs.Tracer] = None,
        clock=None,
        slo_tracker: Optional[obs.SloTracker] = None,
        slo_admission: bool = False,
        flightrec: Optional[obs.FlightRecorder] = None,
        prefill_only: bool = False,
    ):
        self.decoder = decoder
        self.prefill_only = bool(prefill_only)
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
        # slot -> {"next": next logical page index} of a streamed
        # adoption in flight (the slot is allocated, so admission never
        # takes it)
        self._staging: Dict[int, Dict[str, int]] = {}
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
        # the draft auto-tuner: its depth, the accepted counts since its
        # last decision, and (window, new depth) at each move
        self.spec_autotune = bool(spec_autotune) and self._spec
        self._auto_draft = decoder.spec_tokens if self._spec else 0
        self._auto_window: List[int] = []
        self._auto_traj: List[tuple] = []
        self._gen = torch.Generator(device=decoder.device)
        self._gen.manual_seed(seed)
        self._next_uid = 0
        self.results: Dict[int, Request] = {}
        # tensor parallelism: head all-reduces of the last window, in all
        self.tp_window_collectives = 0
        self.tp_collectives = 0
        # the obs planes: the counters live in the registry (the old
        # attribute names are read-only properties below)
        self.obs_registry = (obs.MetricsRegistry() if registry is None
                             else registry)
        self._tracer = obs.default_tracer() if tracer is None else tracer
        self._fr = obs.default_flightrec() if flightrec is None \
            else flightrec
        self._clock = time.perf_counter_ns if clock is None else clock
        self.slo_admission = bool(slo_admission)
        if slo_tracker is None and self.slo_admission \
                and self._tracer.enabled:
            slo_tracker = obs.SloTracker.default_serve(clock=self._clock)
        self._slo = slo_tracker
        self._lifecycle = (
            obs.RequestLifecycle(self.obs_registry, slo=self._slo)
            if self._tracer.enabled else obs.NULL_LIFECYCLE)
        m = self.obs_registry
        self._c_prefill = m.counter("serve.prefill_dispatches")
        self._c_decode = m.counter("serve.decode_dispatches")
        self._c_cow = m.counter("serve.cow_dispatches")
        self._c_preempt = m.counter("serve.preemptions")
        self._c_prompt = m.counter("serve.prompt_tokens")
        self._c_retired = m.counter("serve.requests_finished")
        self._c_cancelled = m.counter("serve.requests_cancelled")
        self._g_peak_live = m.gauge("serve.peak_live_tokens")
        # speculation: drafts proposed and accepted, verify steps that
        # rolled a draft back, the accepted length a step; under a tree
        # the winning branch a step and the steps a branch > 0 won
        self._c_spec_draft = m.counter("serve.spec.draft_tokens")
        self._c_spec_acc = m.counter("serve.spec.accepted_tokens")
        self._c_spec_roll = m.counter("serve.spec.rollbacks")
        self._h_spec_acc = m.histogram("serve.spec.accepted_per_step")
        self._h_tree_branch = m.histogram("serve.spec.tree_branch")
        self._c_tree_wins = m.counter("serve.spec.tree_branch_wins")
        # SLO-aware admission: boundaries where prefill yielded under
        # ITL burn, admissions that overtook a starved head under TTFT
        # burn
        self._c_slo_yield = m.counter("serve.slo.prefill_yields")
        self._c_slo_overtake = m.counter("serve.slo.overtakes")
        self._c_prefix_hits = m.counter("serve.prefix_hits")
        self._c_prefix_hit_tok = m.counter("serve.prefix_hit_tokens")
        # disaggregation: requests adopted from a handoff, and detached to
        # migrate elsewhere
        self._c_adopted = m.counter("serve.adoptions")
        self._c_detached = m.counter("serve.detached")
        # weight swaps served, and in-flight requests that swaps to
        # changed weights requeued for recompute
        self._c_swaps = m.counter("serve.weight_swaps")
        self._c_swap_recompute = m.counter("serve.swap_recomputed")
        # the digest of the served weights: computed at its first read,
        # then kept by swap_weights
        self._weights_digest: Optional[str] = None
        # tokens materialized this boundary, flushed to the lifecycle in
        # batches so ITL amortizes over the fetch that produced them
        self._pending_tok: Dict[int, int] = {}
        self._boundary_t = self._clock()

    # -- accounting properties (the registry's counters) ----------------

    @property
    def prefill_dispatches(self) -> int:
        return self._c_prefill.value

    @property
    def decode_dispatches(self) -> int:
        return self._c_decode.value

    @property
    def cow_dispatches(self) -> int:
        return self._c_cow.value

    @property
    def preemptions(self) -> int:
        return self._c_preempt.value

    @property
    def prompt_tokens(self) -> int:
        return self._c_prompt.value

    @property
    def peak_live_tokens(self) -> int:
        return self._g_peak_live.value

    @property
    def spec_draft_tokens(self) -> int:
        return self._c_spec_draft.value

    @property
    def spec_accepted_tokens(self) -> int:
        return self._c_spec_acc.value

    @property
    def spec_rollbacks(self) -> int:
        return self._c_spec_roll.value

    @property
    def tree_branch_wins(self) -> int:
        return self._c_tree_wins.value

    # -- request intake -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               temperature: Optional[float] = None, top_k: int = 0,
               top_p: float = 1.0, min_p: float = 0.0, priority: int = 0,
               corr: Optional[str] = None) -> int:
        """Queue a request; returns its uid.  Admission happens at the
        next dispatch boundary (:meth:`step`/:meth:`run`).  ``priority``
        orders admission under SLO-aware admission (higher first, FIFO
        within a class) and is ignored under FIFO; ``corr`` is a
        correlation id stamped on the request's telemetry."""
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
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p),
            priority=int(priority), corr=corr))
        self._lifecycle.submitted(uid, self._clock(), corr=corr)
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

    # -- lifecycle plumbing ---------------------------------------------

    def _note_token(self, r: Request) -> None:
        """Count one materialized token against the current boundary's
        fetch (flushed in a batch, so ITL amortizes over it)."""
        self._pending_tok[r.uid] = self._pending_tok.get(r.uid, 0) + 1

    def _flush_tokens(self, uid: Optional[int] = None) -> None:
        if uid is not None:
            n = self._pending_tok.pop(uid, 0)
            if n:
                self._lifecycle.tokens(uid, n, self._boundary_t)
            return
        for u, n in self._pending_tok.items():
            if n:
                self._lifecycle.tokens(u, n, self._boundary_t)
        self._pending_tok.clear()

    @staticmethod
    def _corr_kw(r: Request) -> Dict[str, str]:
        """The correlation-id attr of instants and recorder events
        (empty for requests submitted without one)."""
        return {"corr": r.corr} if r.corr is not None else {}

    def _admit_order(self) -> List[int]:
        """Queue indices in admission order: FIFO, or priority classes
        first (FIFO within a class) under SLO-aware admission."""
        n = len(self._queue)
        if not self.slo_admission:
            return list(range(n))
        return sorted(range(n), key=lambda i: (-self._queue[i].priority, i))

    def _slo_burning(self, metric: str) -> bool:
        """Whether ``metric``'s error budget burns now (the policy's one
        question a boundary)."""
        return (self.slo_admission and self._slo is not None
                and self._slo.burning(metric, self._clock()))

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
        self._note_token(r)
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

    def _release(self, r: Request) -> None:
        """Free a request's slot (and pages) and clear its bindings."""
        slot = r.slot
        if self.paged:
            self.pool.release_slot(slot)
        self.alloc.free(slot)
        self._active.pop(slot, None)
        self._prefilling.pop(slot, None)
        self._reset_samp(slot)
        r.slot = None

    def _finish(self, r: Request, truncated: bool = False,
                abandoned: bool = False) -> None:
        r.done = True
        r.truncated = truncated
        self.results[r.uid] = r
        self._release(r)
        self._flush_tokens(r.uid)
        if abandoned:
            self._lifecycle.abandoned(r.uid, self._clock())
            self._c_cancelled.inc()
        else:
            self._lifecycle.finished(r.uid, self._boundary_t)
            self._c_retired.inc()
        self._tracer.instant("serve/retire", uid=r.uid,
                             tokens=len(r.tokens), truncated=truncated,
                             abandoned=abandoned, **self._corr_kw(r))
        if self._fr.enabled:
            self._fr.record("serve/retire", uid=r.uid,
                            tokens=len(r.tokens), truncated=truncated,
                            abandoned=abandoned, **self._corr_kw(r))

    def cancel(self, uid: int) -> List[int]:
        """Abandon a request wherever it is: a queued one leaves the
        queue, a prefilling or active one frees its slot (and pages) at
        this host boundary, as a retirement does.  Returns the tokens
        generated so far; a finished request's tokens come back
        unchanged (cancel is then a no-op)."""
        r = self.results.get(uid)
        if r is not None:
            return list(r.tokens)
        for r in list(self._active.values()):
            if r.uid == uid:
                self._finish(r, truncated=True, abandoned=True)
                self._tracer.instant("serve/cancel", uid=uid, where="active")
                return list(r.tokens)
        queued = [q for q in self._queue if q.uid == uid]
        prefilling = [e[0] for e in self._prefilling.values()
                      if e[0].uid == uid]
        if queued:
            r, where = queued[0], "queued"
            self._queue.remove(r)
        elif prefilling:
            r, where = prefilling[0], "prefilling"
            self._release(r)
        else:
            raise KeyError(f"unknown request uid {uid}")
        r.done = True
        r.truncated = True
        self.results[uid] = r
        self._flush_tokens(uid)
        self._lifecycle.abandoned(uid, self._clock())
        self._c_cancelled.inc()
        self._tracer.instant("serve/cancel", uid=uid, where=where)
        if self._fr.enabled:
            self._fr.record("serve/cancel", uid=uid, where=where)
        return list(r.tokens)

    # -- live weight swaps ----------------------------------------------

    @property
    def weights_digest(self) -> str:
        """SHA-256 of the served state dict
        (:func:`apex_tpu_torch.checkpoint.state_digest`): computed at its
        first read, then kept by :meth:`swap_weights`."""
        if self._weights_digest is None:
            self._weights_digest = state_digest(self.decoder.params)
        return self._weights_digest

    def swap_weights(self, bundle) -> Dict[str, Any]:
        """Serve new weights from this boundary on, with no restart.

        ``bundle`` is a state dict of the served one's keys, shapes and
        dtypes, or anything with ``.params`` (such a state dict) and
        optionally ``.digest`` (computed when absent).  Two regimes, by
        the digest:

        - identical (a rollback to the running weights, a configuration
          promotion): the decoder is rebound
          (:meth:`GPTDecoder.with_params`) and nothing else moves: pages,
          registry, queue and every in-flight request stay, and the
          requests go on token for token;
        - changed: the cached K/V encodes the old weights, so every
          prefilling and active request goes back to the queue (lowest
          uid at the head) to re-prefill its prompt and tokens so far
          under the new weights, staged adoptions are aborted and the
          prefix registry is dropped.

        ``with_params`` validates before anything changes, so a refused
        swap leaves the engine as it was.  Returns ``{"identical",
        "recomputed", "kept", "digest", "prefixes_dropped"}``."""
        params = getattr(bundle, "params", bundle)
        digest = getattr(bundle, "digest", None)
        if digest is None:
            digest = state_digest(params)
        decoder = self.decoder.with_params(params)  # raises before changes
        identical = digest == self.weights_digest
        recomputed = 0
        dropped = 0
        if not identical:
            inflight = [e[0] for e in self._prefilling.values()]
            inflight += list(self._active.values())
            # lowest uid at the queue's head
            for r in sorted(inflight, key=lambda r: -r.uid):
                self._release(r)
                recomputed += 1
                self._queue.appendleft(r)
            if self.paged:
                for stage in list(self._staging):
                    self.adopt_stage_abort(stage)
                dropped = self.pool.drop_prefixes()
            self._c_swap_recompute.inc(recomputed)
        self.decoder = decoder
        self._weights_digest = digest
        self._c_swaps.inc()
        self._tracer.instant("serve/swap_weights", digest=digest[:12],
                             identical=identical, recomputed=recomputed)
        if self._fr.enabled:
            self._fr.record("serve/swap_weights", digest=digest[:12],
                            identical=identical, recomputed=recomputed,
                            prefixes_dropped=dropped)
        return {"identical": identical, "recomputed": recomputed,
                "kept": len(self._active) + len(self._prefilling),
                "digest": digest, "prefixes_dropped": dropped}

    # -- disaggregated handoff ------------------------------------------

    def _active_by_uid(self, uid: int) -> Request:
        for r in self._active.values():
            if r.uid == uid:
                return r
        raise KeyError(f"request {uid} is not active on this engine")

    def _compatible(self, container) -> bool:
        """A container's page_len and geometry against this pool; a
        container carries every head, so a tensor-parallel rank's pool is
        held against the model's head count."""
        if container.page_len != self.page_len:
            return False
        ok, _why = container.compatible_with(
            self.cache, heads=self.decoder.cfg.num_heads)
        return ok

    def export_handoff(self, uid: int) -> KVHandoff:
        """An active request's KV pages for a decode engine: the slot's
        page contents (:meth:`GPTDecoder.gather_pages`), the context they
        encode and the sampled-but-uncommitted tokens.  A pure read: the
        request keeps its slot until :meth:`detach`, so a transfer lost
        on the way loses nothing here."""
        if not self.paged:
            raise ValueError("handoff export is paged-only")
        r = self._active_by_uid(uid)
        slot = r.slot
        length = int(self._slot_len[slot])
        n_pages = (length + self.page_len - 1) // self.page_len
        pages = self.pool.export_slot(slot, n_pages)
        with self._tracer.span("serve/handoff_export", uid=uid,
                               pages=n_pages):
            k, v, ks, vs = self.decoder.gather_pages(self.cache, pages)
        full = r.prompt + r.tokens
        return KVHandoff(tokens=full[:length], seed_tokens=list(r.tokens),
                         length=length, page_len=self.page_len, k=k, v=v,
                         k_scale=ks, v_scale=vs, corr=r.corr)

    def _resume(self, slot: int, container, max_new_tokens: int,
                temperature, top_k, top_p, min_p, priority, corr,
                streamed: bool) -> int:
        """Activate an adopted request in ``slot``, whose pages and device
        length are in place: a new uid, the registry, the lifecycle, the
        sampling params, the spec history from context + seed tokens, the
        adoption's counter, instant and record."""
        uid = self._next_uid
        self._next_uid += 1
        ctx = list(container.tokens)
        # the correlation id rides the header: an explicit one wins
        corr = corr if corr is not None else container.corr
        r = Request(uid, ctx, int(max_new_tokens),
                    tokens=list(container.seed_tokens), slot=slot,
                    temperature=temperature, top_k=int(top_k),
                    top_p=float(top_p), min_p=float(min_p),
                    priority=int(priority), corr=corr)
        # the imported prompt pages serve local prefix reuse
        self.pool.register(slot, ctx)
        t = self._clock()
        self._lifecycle.submitted(uid, t, corr=corr)
        self._lifecycle.admitted(uid, t)
        self._active[slot] = r
        self._slot_len[slot] = container.length
        self._last_token[slot] = r.tokens[-1]
        self._bind_samp(r, slot)
        if self._spec:
            h = self._hist.shape[1]
            tail = (ctx + r.tokens)[-h:]
            self._hist[slot] = -1
            self._hist[slot, h - len(tail):] = tail
        self._c_adopted.inc()
        extra = {"streamed": True} if streamed else {}
        self._tracer.instant("serve/adopt", uid=uid, slot=slot,
                             length=container.length, **extra,
                             seed=len(r.tokens), **self._corr_kw(r))
        if self._fr.enabled:
            self._fr.record("serve/adopt", uid=uid, slot=slot,
                            length=container.length, **extra,
                            **self._corr_kw(r))
        return uid

    def adopt(self, handoff: KVHandoff, max_new_tokens: int,
              temperature: Optional[float] = None, top_k: int = 0,
              top_p: float = 1.0, min_p: float = 0.0, priority: int = 0,
              corr: Optional[str] = None) -> Optional[int]:
        """Admit a request whose KV arrives as a :class:`KVHandoff`
        instead of being prefilled: fresh pages imported, the contents
        scattered and the slot's length set on the device
        (:meth:`GPTDecoder.adopt_pages`), the prompt pages registered,
        and decoding resumed from the last seed token.  Returns the new
        uid, or None when this engine cannot take it now (paging off,
        another page_len or geometry, no room for a token, a budget the
        seed tokens already spend, more pages than a slot maps, no free
        slot or pages); None is the caller's signal to recompute, and
        leaves the pool as it was.  ``max_new_tokens`` counts the seed
        tokens as generated."""
        if not self.paged or not self._compatible(handoff):
            return None
        if handoff.length + 1 > self.max_len \
                or max_new_tokens <= len(handoff.seed_tokens):
            return None
        n_pages = handoff.n_pages
        if n_pages > self.pool.pages_per_slot:
            return None
        slot = self.alloc.allocate()
        if slot is None:
            return None
        pages = self.pool.import_slot(slot, n_pages)
        if pages is None:
            self.alloc.free(slot)
            return None
        with self._tracer.span("serve/handoff_import", pages=n_pages):
            self.decoder.adopt_pages(self.cache, pages, handoff.k, handoff.v,
                                     handoff.k_scale, handoff.v_scale, slot,
                                     handoff.length)
        return self._resume(slot, handoff, max_new_tokens, temperature,
                            top_k, top_p, min_p, priority, corr, False)

    def detach(self, uid: int) -> List[int]:
        """Free an active request's slot and pages without retiring it:
        it migrates to another engine, where its lifecycle goes on (this
        engine records neither a completion nor an abandonment).  Returns
        the tokens generated here."""
        r = self._active_by_uid(uid)
        self._flush_tokens(uid)
        self._release(r)
        self._c_detached.inc()
        self._tracer.instant("serve/detach", uid=uid, tokens=len(r.tokens),
                             **self._corr_kw(r))
        if self._fr.enabled:
            self._fr.record("serve/detach", uid=uid, tokens=len(r.tokens),
                            **self._corr_kw(r))
        return list(r.tokens)

    # -- the streamed handoff -------------------------------------------

    def prefill_progress(self, uid: int):
        """``(full pages written, prompt pages)`` of a request in chunked
        prefill, or None once it has left that phase."""
        pl = self.page_len
        for r, ctx, base in self._prefilling.values():
            if r.uid == uid:
                return base // pl, (len(ctx) + pl - 1) // pl
        return None

    def export_prefill_chunk(self, uid: int, start_page: int,
                             seq: int = 0) -> Optional[KVHandoffChunk]:
        """The full pages a prefilling request has written at logical
        indices ``[start_page, ...)``, as an interior
        :class:`KVHandoffChunk`, while the rest of the prompt still
        prefills.  The last prompt page is always held back for the final
        chunk (:meth:`export_handoff_tail`), so the commit carries the
        resume metadata and at least one page.  None when no new full
        page is ready."""
        if not self.paged:
            raise ValueError("handoff export is paged-only")
        pl = self.page_len
        for slot, (r, ctx, base) in self._prefilling.items():
            if r.uid != uid:
                continue
            total = (len(ctx) + pl - 1) // pl
            full = min(base // pl, total - 1)  # hold back the last page
            if full <= start_page:
                return None
            pages = []
            for pidx in range(start_page, full):
                page = int(self.pool.tables[slot, pidx])
                if page == TRASH_PAGE:
                    raise ValueError(f"slot {slot} logical page {pidx} "
                                     "unmapped mid-prefill — cannot stream")
                pages.append(page)
            with self._tracer.span("serve/handoff_export", uid=uid,
                                   pages=len(pages), chunk=seq):
                k, v, ks, vs = self.decoder.gather_pages(self.cache, pages)
            return KVHandoffChunk(seq=int(seq), page_offset=int(start_page),
                                  page_len=pl, k=k, v=v, k_scale=ks,
                                  v_scale=vs, corr=r.corr)
        return None

    def export_handoff_tail(self, uid: int, start_page: int,
                            seq: int = 0) -> KVHandoffChunk:
        """The final chunk of a streamed handoff: the pages from
        ``start_page`` to the end of an active request's written KV, with
        :meth:`export_handoff`'s resume metadata.  A pure read."""
        if not self.paged:
            raise ValueError("handoff export is paged-only")
        r = self._active_by_uid(uid)
        slot = r.slot
        length = int(self._slot_len[slot])
        pl = self.page_len
        n_total = (length + pl - 1) // pl
        if start_page >= n_total:
            raise ValueError(f"stream already covers all {n_total} page(s) "
                             f"of uid {uid} — the tail must carry at least "
                             "one")
        pages = self.pool.export_slot(slot, n_total)[start_page:]
        with self._tracer.span("serve/handoff_export", uid=uid,
                               pages=len(pages), chunk=seq, final=True):
            k, v, ks, vs = self.decoder.gather_pages(self.cache, pages)
        full = r.prompt + r.tokens
        return KVHandoffChunk(seq=int(seq), page_offset=int(start_page),
                              page_len=pl, k=k, v=v, k_scale=ks, v_scale=vs,
                              tokens=full[:length],
                              seed_tokens=list(r.tokens), length=length,
                              corr=r.corr)

    def adopt_stage_begin(self) -> Optional[int]:
        """Reserve a slot for an incoming streamed handoff.  Returns the
        stage id (the slot), or None when no slot is free (the caller
        then streams nothing and hands off whole at the end)."""
        if not self.paged:
            return None
        slot = self.alloc.allocate()
        if slot is None:
            return None
        self._staging[slot] = {"next": 0}
        self._tracer.instant("serve/adopt_stage", slot=slot)
        return slot

    def adopt_stage_chunk(self, stage: int, chunk: KVHandoffChunk) -> bool:
        """Import one interior chunk into a staged slot: fresh pages at the
        chunk's logical offset, the contents scattered, the provisional
        device length set to the pages imported.  The staged slot is not
        active, so every window gives its row the trash page.  False (the
        stage as it was) on a chunk out of sequence, of another geometry,
        leaving no page for the tail, or finding no pages; the caller
        then aborts the stage."""
        st = self._staging.get(stage)
        if st is None or chunk.final or chunk.n_pages < 1:
            return False
        if chunk.page_offset != st["next"] or not self._compatible(chunk):
            return False
        end = chunk.page_offset + chunk.n_pages
        if end >= self.pool.pages_per_slot:
            return False  # must leave room for the tail chunk
        pages = self.pool.import_pages(stage, chunk.page_offset,
                                       chunk.n_pages)
        if pages is None:
            return False
        with self._tracer.span("serve/handoff_import", pages=len(pages),
                               chunk=chunk.seq):
            self.decoder.adopt_pages(self.cache, pages, chunk.k, chunk.v,
                                     chunk.k_scale, chunk.v_scale, stage,
                                     end * self.page_len)
        st["next"] = end
        return True

    def adopt_stage_commit(
            self, stage: int, chunk: KVHandoffChunk, max_new_tokens: int,
            temperature: Optional[float] = None, top_k: int = 0,
            top_p: float = 1.0, min_p: float = 0.0, priority: int = 0,
            corr: Optional[str] = None) -> Optional[int]:
        """Land a stream's final chunk and activate the request
        (:meth:`adopt`'s epilogue over pages that mostly arrived
        already).  Returns the new uid, or None (the stage as it was; the
        caller aborts) when the final validation fails."""
        st = self._staging.get(stage)
        if st is None or not chunk.final:
            return None
        if chunk.page_offset != st["next"] or chunk.n_pages < 1 \
                or not self._compatible(chunk):
            return None
        if chunk.length + 1 > self.max_len \
                or max_new_tokens <= len(chunk.seed_tokens):
            return None
        if chunk.page_offset + chunk.n_pages > self.pool.pages_per_slot:
            return None
        pages = self.pool.import_pages(stage, chunk.page_offset,
                                       chunk.n_pages)
        if pages is None:
            return None
        with self._tracer.span("serve/handoff_import", pages=len(pages),
                               chunk=chunk.seq, final=True):
            self.decoder.adopt_pages(self.cache, pages, chunk.k, chunk.v,
                                     chunk.k_scale, chunk.v_scale, stage,
                                     chunk.length)
        del self._staging[stage]
        return self._resume(stage, chunk, max_new_tokens, temperature,
                            top_k, top_p, min_p, priority, corr, True)

    def adopt_stage_abort(self, stage: int) -> None:
        """Tear a staged adoption down (a damaged or lost chunk, a failed
        commit): its pages are freed and the slot goes back to the
        allocator."""
        st = self._staging.pop(stage, None)
        if st is None:
            return
        self.pool.release_slot(stage)
        self.alloc.free(stage)
        self._tracer.instant("serve/adopt_abort", slot=stage,
                             staged_pages=st["next"])
        if self._fr.enabled:
            self._fr.record("serve/adopt_abort", slot=stage,
                            staged_pages=st["next"])

    # -- prefix migration -----------------------------------------------

    def export_prefix(self, tokens: List[int]) -> Optional[KVHandoffChunk]:
        """The registered pages covering a page-aligned token prefix, as
        an interior :class:`KVHandoffChunk` (no resume metadata: a prefix
        migrates, not a request).  A pure read; None when the pool does
        not cover the whole prefix."""
        if not self.paged:
            return None
        pl = self.page_len
        if not tokens or len(tokens) % pl:
            return None
        n = len(tokens) // pl
        pages, pos = self.pool.match_prefix(list(tokens))
        if pos < len(tokens):
            return None
        pages = pages[:n]
        with self._tracer.span("serve/prefix_export", pages=n):
            k, v, ks, vs = self.decoder.gather_pages(self.cache, pages)
        return KVHandoffChunk(seq=0, page_offset=0, page_len=pl, k=k, v=v,
                              k_scale=ks, v_scale=vs)

    def import_prefix(self, chunk: KVHandoffChunk,
                      tokens: List[int]) -> Optional[List[int]]:
        """Adopt a migrated prefix ahead of demand: anchor pages allocated
        and registered with no slot owning them, the contents scattered
        by :meth:`GPTDecoder.adopt_pages`.  Returns the anchored pages,
        which the caller owns and must :meth:`release_prefix` in the end.
        None when the geometry differs, the tokens do not match the
        chunk, the prefix is registered already, no slot is free, or the
        import would leave less than one slot's worth of free pages (a
        fill ahead of demand must never starve admission)."""
        if not self.paged or not self._compatible(chunk):
            return None
        pl = self.page_len
        if not tokens or len(tokens) % pl \
                or len(tokens) // pl != chunk.n_pages:
            return None
        headroom = -(-self.max_len // pl)  # one slot's worth of pages
        if self.pool.n_free < chunk.n_pages + headroom:
            return None
        # the scatter borrows a free slot and leaves its device length
        # stale: the slot is not active, so every window gives its row the
        # trash page (step), and its next admission sets the length anew
        slot = self.alloc.allocate()
        if slot is None:
            return None
        self.alloc.free(slot)
        pages = self.pool.adopt_prefix(list(tokens))
        if pages is None:
            return None
        with self._tracer.span("serve/prefix_import", pages=len(pages)):
            self.decoder.adopt_pages(self.cache, pages, chunk.k, chunk.v,
                                     chunk.k_scale, chunk.v_scale, slot,
                                     len(tokens))
        self._tracer.instant("serve/prefix_adopt", pages=len(pages),
                             tokens=len(tokens))
        if self._fr.enabled:
            self._fr.record("serve/prefix_adopt", pages=len(pages),
                            tokens=len(tokens))
        return list(pages)

    def release_prefix(self, pages: List[int]) -> None:
        """Drop an :meth:`import_prefix` anchor (pages that live slots
        still share survive until their last reader)."""
        if self.paged and pages:
            self.pool.release_prefix([int(p) for p in pages])

    # -- contiguous admission -------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the queue with ONE batched prefill, the
        prompts right-padded to a power-of-two bucket."""
        batch: List[Request] = []
        while self._queue and self.alloc.n_free:
            r = self._queue[self._admit_order()[0]]
            self._queue.remove(r)
            r.slot = self.alloc.allocate()
            batch.append(r)
        if not batch:
            return
        t_admit = self._clock()
        for r in batch:
            self._lifecycle.admitted(r.uid, t_admit)
        p = min(self._bucket(max(len(r.prompt) for r in batch)),
                self.max_len)
        ids = np.zeros((len(batch), p), np.int32)
        for i, r in enumerate(batch):
            ids[i, :len(r.prompt)] = r.prompt
        if self._fr.enabled:
            for r in batch:
                self._fr.record("serve/admit", uid=r.uid, slot=r.slot,
                                **self._corr_kw(r))
            self._fr.record("serve/prefill", requests=len(batch), bucket=p)
        with self._tracer.span("serve/prefill", requests=len(batch),
                               bucket=p):
            logits = self.decoder.prefill(
                self.cache, [r.slot for r in batch], ids,
                [len(r.prompt) for r in batch])
            self._c_prefill.inc()
            first = self._sample_first(logits, batch)
        self._boundary_t = self._clock()
        for r, tok in zip(batch, first):
            self._activate(r, r.slot, r.prompt)
            self._append(r, tok)
        self._flush_tokens()

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
        with self._tracer.span("serve/cow_copy", pages=len(pairs),
                               bucket=width):
            self.decoder.copy_pages(self.cache, src, dst)
        self._c_cow.inc()

    def _evict(self, r: Request) -> None:
        """Preempt a request when the pool runs dry: free its pages and
        slot, and re-queue it at the front for recompute."""
        self._release(r)
        self._c_preempt.inc()
        self._tracer.instant("serve/preempt", uid=r.uid,
                             tokens=len(r.tokens))
        if self._fr.enabled:
            self._fr.record("serve/preempt", uid=r.uid,
                            tokens=len(r.tokens))
        self._queue.appendleft(r)

    def _admit_paged(self) -> None:
        """Admit queued requests into free slots under the page budget:
        the next request (FIFO, or priority-then-FIFO under SLO-aware
        admission) needs pages for its non-shared context plus one
        headroom page.  A page-starved head waits, except while the TTFT
        budget burns: then the first of the next :data:`OVERTAKE_SCAN`
        candidates that fits is admitted instead.  Shared-prefix pages
        are mapped here; prefill starts at the first non-shared token."""
        t_admit = self._clock()
        ttft_burn = self._slo_burning("ttft_ms")
        while self._queue and self.alloc.n_free:
            progressed = False
            for pos, j in enumerate(self._admit_order()):
                r = self._queue[j]
                ctx = r.prompt + r.tokens  # re-prefill context on preemption
                if len(ctx) >= self.max_len:
                    # a preempted request that was already at capacity
                    del self._queue[j]
                    r.done = True
                    r.truncated = True
                    self.results[r.uid] = r
                    self._flush_tokens(r.uid)
                    self._lifecycle.finished(r.uid, t_admit)
                    self._c_retired.inc()
                    progressed = True
                    break  # the queue changed: recompute the order
                with self._tracer.span("serve/prefix_match", uid=r.uid):
                    pages, shared = self.pool.match_prefix(ctx)
                pl = self.page_len
                need = (len(ctx) + pl) // pl - len(pages) + 1
                if self.pool.n_free < need:
                    if ttft_burn and pos + 1 < self.OVERTAKE_SCAN:
                        continue  # scan on for one that fits
                    break
                del self._queue[j]
                slot = self.alloc.allocate()
                r.slot = slot
                self._lifecycle.admitted(r.uid, t_admit)
                if self._fr.enabled:
                    self._fr.record("serve/admit", uid=r.uid, slot=slot,
                                    shared=shared, **self._corr_kw(r))
                self.pool.share(slot, pages, shared)
                if pages:
                    self._c_prefix_hits.inc()
                    self._c_prefix_hit_tok.inc(shared)
                self._c_prompt.inc(len(ctx))
                if pos > 0:
                    self._c_slo_overtake.inc()
                    self._tracer.instant("serve/slo_overtake", uid=r.uid,
                                         skipped=pos)
                # a fully shared context still re-runs its LAST token as
                # a 1-token chunk: its logits seed sampling
                self._prefilling[slot] = [r, ctx, min(shared, len(ctx) - 1)]
                progressed = True
                break
            if not progressed:
                break

    def _prefill_chunks(self) -> None:
        """Advance every in-flight prefill by ONE chunk; a request whose
        final chunk lands samples its first token and becomes active, and
        its prompt pages are published for prefix reuse.  Under SLO-aware
        admission the chunks yield the boundary while the ITL budget
        burns and decodes are active."""
        if not self._prefilling:
            return
        if self._active and self._slo_burning("itl_ms"):
            self._c_slo_yield.inc()
            self._tracer.instant("serve/slo_yield",
                                 prefilling=len(self._prefilling))
            return
        pending = []
        pairs = []
        with self._tracer.span("serve/cow_plan", phase="prefill"):
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
            width = self._bucket(n)
            ids = np.zeros((1, width), np.int32)
            ids[0, :n] = ctx[base:base + n]
            if self._fr.enabled:
                self._fr.record("serve/prefill_chunk", uid=r.uid, base=base,
                                n=n)
            with self._tracer.span("serve/prefill_chunk", uid=r.uid,
                                   bucket=width, base=base):
                logits = self.decoder.prefill_chunk(
                    self.cache, self.pool.tables[slot][None],
                    np.asarray([slot], np.int32), ids,
                    np.asarray([base], np.int32), np.asarray([n], np.int32))
            self._c_prefill.inc()
            base += n
            if base >= len(ctx):
                del self._prefilling[slot]
                self.pool.register(slot, ctx)
                first = self._sample_first(logits, [r])[0]
                self._boundary_t = self._clock()
                self._activate(r, slot, ctx)
                self._append(r, first)
                self._flush_tokens(r.uid)
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
        with self._tracer.span("serve/cow_plan", phase="decode"):
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
        if self._fr.enabled:
            self._fr.record("serve/boundary", active=len(self._active),
                            queued=len(self._queue),
                            prefilling=len(self._prefilling))
        with self._tracer.span("serve/admit"):
            if self.paged:
                self._admit_paged()
            else:
                self._admit()
        if self.paged:
            self._prefill_chunks()
        if self.prefill_only:
            # a prefill engine runs no window: its active slots hold
            # finished prefills that wait for their handoff
            self._boundary_counters()
            return bool(self._queue or self._prefilling or self._active)
        if not self._active:
            self._boundary_counters()
            return bool(self._queue or self._prefilling)
        if self.paged:
            self._prepare_decode_pages()
            if not self._active:
                self._boundary_counters()
                return bool(self._queue or self._prefilling)
        k = self.decoder.tokens_per_dispatch
        if self._fr.enabled:
            self._fr.record("serve/decode_window", k=k,
                            active=len(self._active))
        active = np.zeros((self.cache.slots,), bool)
        active[list(self._active)] = True
        if self.paged:
            # every slot decodes, and writes its K/V at its device length
            # through its table row: a slot still prefilling (its length
            # stale until its first chunk lands) would write garbage into
            # pages it maps, shared prefix pages included.  Inactive rows
            # point at the trash page for the window.
            tables = np.where(active[:, None], self.pool.tables, TRASH_PAGE)
        samp = self._samp_params()
        tp0 = collective_counts().get("tp_heads", 0)
        with self._tracer.span("serve/decode_window", k=k,
                               active=len(self._active)):
            if self._spec:
                draft = self._dispatch_draft()
                if self._tree:
                    buf = self.decoder.paged_tree_spec_decode_window(
                        self.cache, tables, self._last_token,
                        active, self._hist, self._gen, samp=samp,
                        draft=draft)
                elif self.paged:
                    buf = self.decoder.paged_spec_decode_window(
                        self.cache, tables, self._last_token,
                        active, self._hist, self._gen, samp=samp,
                        draft=draft)
                else:
                    buf = self.decoder.spec_decode_window(
                        self.cache, self._last_token, active, self._hist,
                        self._gen, samp=samp, draft=draft)
            elif self.paged:
                buf = self.decoder.paged_decode_window(
                    self.cache, tables, self._last_token, active,
                    self._gen, samp=samp)
            else:
                buf = self.decoder.decode_window(
                    self.cache, self._last_token, active, self._gen,
                    samp=samp)
            self._c_decode.inc()
            # (K, slots), or (steps, slots, 2 + draft) under speculation
            # (3 + draft for a tree): the one host sync of the window
            buf = buf.cpu().numpy()
        if self.decoder.tp_degree > 1:
            self.tp_window_collectives = (
                collective_counts().get("tp_heads", 0) - tp0)
            self.tp_collectives += self.tp_window_collectives
        self._boundary_t = self._clock()
        if self._tree:
            self._fetch_spec(buf[..., :-2], buf[..., -2], buf[..., -1])
        elif self._spec:
            self._fetch_spec(buf[..., :-1], buf[..., -1])
        else:
            self._fetch(buf)
        self._flush_tokens()
        if self.paged:
            live = sum(int(self._slot_len[s]) for s in self._active)
            live += sum(e[2] for e in self._prefilling.values())
            self._g_peak_live.set_max(live)
        self._boundary_counters()
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
                self._c_spec_draft.inc(d1 - 1)
                self._c_spec_acc.inc(n - 1)
                if n < d1:
                    self._c_spec_roll.inc()
                self._h_spec_acc.observe(n)
                self._accepted_hist[n] = self._accepted_hist.get(n, 0) + 1
                if self.spec_autotune:
                    self._auto_window.append(n)
                if branches is not None:
                    br = int(branches[i, slot])
                    self._h_tree_branch.observe(br)
                    if br > 0:
                        self._c_tree_wins.inc()
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

    def _boundary_counters(self) -> None:
        """Timestamped samples of the pool pages, active slots and queue
        depth: the timeline of a trace."""
        tr = self._tracer
        if not tr.enabled:
            return
        tr.counter("serve/active_slots", len(self._active))
        tr.counter("serve/queue_depth", len(self._queue))
        if self.paged:
            tr.counter("serve/pages_in_use", self.pool.in_use)

    def progress(self) -> Dict[int, tuple]:
        """``{uid: (tokens so far, done)}`` over queued, prefilling,
        active and finished requests: the streaming view the load
        harness polls at boundaries."""
        out: Dict[int, tuple] = {}
        for r in self._queue:
            out[r.uid] = (list(r.tokens), False)
        for entry in self._prefilling.values():
            out[entry[0].uid] = (list(entry[0].tokens), False)
        for r in self._active.values():
            out[r.uid] = (list(r.tokens), False)
        for uid, r in self.results.items():
            out[uid] = (list(r.tokens), True)
        return out

    def run(self, max_rounds: int = 100_000) -> Dict[int, List[int]]:
        """Drain the queue; returns ``{uid: generated tokens}``."""
        rounds = 0
        while self.step():
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(f"undrained after {max_rounds} rounds")
        return {uid: r.tokens for uid, r in self.results.items()}

    # -- accounting -----------------------------------------------------

    def lifecycle_summary(self) -> Dict[str, object]:
        """The request lifecycle's goodput and abandonment summary
        (:meth:`apex_tpu_torch.obs.RequestLifecycle.summary`; zeros with
        obs off)."""
        return self._lifecycle.summary()

    def slo_report(self) -> Optional[obs.SloReport]:
        """The live SLO report with the lifecycle summary attached, or
        None without a tracker."""
        if self._slo is None:
            return None
        return self._slo.report(self._clock(),
                                lifecycle=self.lifecycle_summary())

    def stats(self) -> Dict[str, object]:
        """A snapshot over ``obs_registry`` (which also holds the
        lifecycle histograms): dispatch counters, the device token meter
        (one fetch), the kernels' launch counts, under speculation the
        ``"spec"`` counters, under SLO-aware admission the ``"slo"``
        ledger and, for the paged engine, page, prefix and preemption
        counters (for the contiguous one, the bytes a slot pins)."""
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
                    "verify_steps": self._h_tree_branch.count,
                }
            if self.spec_autotune:
                s["spec"]["autotune"] = {"draft": self._auto_draft,
                                         "trajectory": list(self._auto_traj)}
        if self.slo_admission:
            s["slo"] = {
                "prefill_yields": self._c_slo_yield.value,
                "overtakes": self._c_slo_overtake.value,
                "alerting": (self._slo.report(self._clock()).alerting()
                             if self._slo is not None else []),
            }
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
            "cache_bytes_in_use": in_use * self.cache.bytes_per_page,
            # shared pages count positions twice in `live`: clamp
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
