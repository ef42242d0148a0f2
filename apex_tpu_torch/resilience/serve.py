"""Self-healing serving: the resilient shell around ``ServeEngine``.

Counterpart of ``apex_tpu/resilience/serve.py``.  A serving host's
failures are request-shaped: a dispatch fails, the engine dies
mid-stream, the page pool saturates, a caller gives up.  The engine
already owns the primitive that makes them recoverable, the recompute
path: any request can be rebuilt as ``prompt + tokens generated so
far``, and under greedy decoding the re-prefill continues with the same
tokens.  This wrapper turns it into host behaviour:

- **bounded retry of a failed boundary**: an injected or transient
  :class:`~apex_tpu_torch.resilience.faults.DispatchFailure` fires
  before the engine changes any state or launches anything, so running
  the boundary again is safe and runs the same launches;
- **engine crash recovery**: on :class:`HostPreemption` the wrapper
  dumps the flight recorder, salvages every request's tokens from the
  dead engine's host state, builds a fresh ``ServeEngine`` on the same
  decoder (the kernel libraries stay loaded in the process, so recovery
  builds nothing) and resubmits every unfinished request as prompt +
  generated; the dead engine's page pool lives until it is dropped, so
  the card briefly holds two pools;
- **per-request deadlines**: ``submit(..., deadline_ms=)`` bounds a
  request's life from its submit stamp on the injected ``clock``; a
  boundary scan abandons an overdue request wherever it is (deferred,
  queued, prefilling or decoding), freeing its slot and pages
  (``resilience.deadline_exceeded``);
- **admission backpressure**: past a pool or queue high-water mark, new
  submits wait on the host instead of queueing into the engine, and
  drain as pressure drops (``resilience.backpressure_deferred``).

The handoff, streamed-handoff and prefix methods pass through to the
inner engine; a stage or prefix token pins the engine generation it was
taken against, so one taken before a crash is refused after it.
Recoveries land in the ``resilience.*`` counters and the
``resilience.recovery_ms`` histogram; ``enabled=False`` makes the
wrapper a transparent pass-through.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch import obs
from apex_tpu_torch.resilience.faults import (DispatchFailure, FaultInjector,
                                              FaultPlan, HostPreemption,
                                              resilience_default)
from apex_tpu_torch.resilience.train import RetryBudgetExceeded

__all__ = ["ResilientServeEngine"]

_MS = 1e-6  # ns -> ms


@dataclasses.dataclass
class _Record:
    """The durable host-side view of one request: everything crash
    recovery needs to rebuild it on a fresh engine."""

    uid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: Optional[float]
    top_k: int
    top_p: float
    min_p: float
    deadline_ms: Optional[float]
    t_submit: int
    priority: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    inner_uid: Optional[int] = None
    done: bool = False
    truncated: bool = False
    abandoned: bool = False
    # the correlation id survives engine rebuilds with the record
    corr: Optional[str] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)


class ResilientServeEngine:
    """Deadline, backpressure, retry and crash-recovery shell over
    :class:`~apex_tpu_torch.serve.ServeEngine`.

    Args:
      decoder: the :class:`~apex_tpu_torch.serve.GPTDecoder`; it survives
        engine crashes (a simulated crash loses the engine's host state,
        not the model in the process).
      max_retries: boundary retries before giving up.
      backoff_s: exponential backoff base between retries.
      deadline_ms: default per-request deadline (None: unbounded;
        ``submit`` overrides it per request).
      backpressure: pool-use high-water mark in (0, 1]; above it,
        submits wait on the host (paged engines only).
      backpressure_queue: also wait when the engine queue is this deep
        (0: off).
      fault_plan / injector: deterministic chaos, wired into every inner
        engine's host sites (``serve/boundary``, ``serve/decode_window``,
        ``serve/prefill``, ``serve/prefill_chunk``).
      registry / tracer: obs destinations of the ``resilience.*`` ledger
        (None: the ambient ones); every inner engine shares them unless
        ``engine_kwargs`` names its own.
      enabled: the switch (None: on; see :func:`resilience_default`).
      clock: ns clock stamping submits and driving the deadline scan
        (default ``time.perf_counter_ns``), forwarded to every inner
        engine; the load harness injects its virtual clock here, which
        makes abandonment replayable.
      flightrec: the recorder shared with the injector and every inner
        engine, dumped on crash recovery and when the retry budget runs
        out (None: the ambient one).
      **engine_kwargs: forwarded to every ``ServeEngine`` built (slots,
        max_len, eos_id, seed, paged, page_len, num_pages,
        prefill_chunk, slo_tracker, slo_admission, ...).
    """

    def __init__(
        self,
        decoder,
        *,
        max_retries: int = 2,
        backoff_s: float = 0.01,
        deadline_ms: Optional[float] = None,
        backpressure: float = 1.0,
        backpressure_queue: int = 0,
        fault_plan: Optional[FaultPlan] = None,
        injector: Optional[FaultInjector] = None,
        registry=None,
        tracer=None,
        enabled: Optional[bool] = None,
        clock=None,
        flightrec=None,
        **engine_kwargs,
    ):
        if not 0.0 < backpressure <= 1.0:
            raise ValueError("backpressure must be in (0, 1]")
        self.decoder = decoder
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.deadline_ms = deadline_ms
        self.backpressure = float(backpressure)
        self.backpressure_queue = int(backpressure_queue)
        self.enabled = resilience_default(enabled)
        self.registry = obs.default_registry() if registry is None \
            else registry
        self.tracer = obs.default_tracer() if tracer is None else tracer
        # one recorder for the injector and every inner engine, so the
        # postmortem ring holds cause (fault), context (boundaries) and
        # effect (recovery) together
        self._fr = obs.default_flightrec() if flightrec is None \
            else flightrec
        if injector is None and fault_plan is not None:
            injector = FaultInjector(fault_plan, registry=self.registry,
                                     tracer=self.tracer, flightrec=self._fr)
        self.injector = injector
        self._engine_kwargs = dict(engine_kwargs)
        self._engine_kwargs.setdefault("flightrec", self._fr)
        self._clock = time.perf_counter_ns if clock is None else clock
        self._engine_kwargs.setdefault("clock", self._clock)
        self._records: Dict[int, _Record] = {}
        self._deferred: Deque[int] = deque()  # uids awaiting admission
        self._next_uid = 0
        m = self.registry
        self._c_retries = m.counter("resilience.retries")
        self._c_restarts = m.counter("resilience.restarts")
        self._c_deadline = m.counter("resilience.deadline_exceeded")
        self._c_deferred = m.counter("resilience.backpressure_deferred")
        self._g_deferred = m.gauge("resilience.deferred_depth")
        self._h_recovery = m.histogram("resilience.recovery_ms")
        self.engine = self._mk_engine()

    # -- engine lifecycle ------------------------------------------------

    def _mk_engine(self):
        from apex_tpu_torch.serve.engine import ServeEngine

        kwargs = dict(self._engine_kwargs)
        kwargs.setdefault("registry", self.registry)
        kwargs.setdefault("tracer", self.tracer)
        return ServeEngine(self.decoder, fault_injector=self.injector,
                           **kwargs)

    def swap_weights(self, bundle):
        """Swap the inner engine's weights (:meth:`ServeEngine.
        swap_weights`) and keep the swapped decoder as the rebuild
        template: a crash after a swap recovers onto the new weights."""
        summary = self.engine.swap_weights(bundle)
        self.decoder = self.engine.decoder
        return summary

    @property
    def weights_digest(self) -> str:
        """The digest of the weights served (see
        :attr:`ServeEngine.weights_digest`)."""
        return self.engine.weights_digest

    # -- accounting properties -------------------------------------------

    @property
    def retries(self) -> int:
        return self._c_retries.value

    @property
    def restarts(self) -> int:
        return self._c_restarts.value

    @property
    def deadline_exceeded(self) -> int:
        return self._c_deadline.value

    @property
    def backpressure_deferred(self) -> int:
        return self._c_deferred.value

    # -- intake ----------------------------------------------------------

    def _saturated(self) -> bool:
        eng = self.engine
        if self.backpressure_queue and len(eng._queue) >= \
                self.backpressure_queue:
            return True
        if self.backpressure >= 1.0 or not eng.paged:
            return False
        # pages held plus the pages the queued requests will claim at
        # admission (context + one headroom page each): a burst starts
        # waiting before the pool is committed, not after it runs dry
        usable = max(eng.pool.num_pages - 1, 1)
        pl = eng.page_len
        projected = eng.pool.in_use + sum(
            (len(r.prompt) + pl) // pl + 1 for r in eng._queue)
        return projected / usable >= self.backpressure

    def submit(
        self, prompt: Sequence[int], max_new_tokens: int = 64,
        temperature: Optional[float] = None, top_k: int = 0,
        top_p: float = 1.0, min_p: float = 0.0,
        deadline_ms: Optional[float] = None, priority: int = 0,
        corr: Optional[str] = None,
    ) -> int:
        """Queue a request; returns its uid (the wrapper's, stable across
        engine rebuilds).  ``deadline_ms`` bounds its life from this
        submit; past it the request is abandoned wherever it is and its
        tokens so far are the result.  ``priority`` rides into the inner
        engine's SLO-aware admission."""
        if deadline_ms is None:
            deadline_ms = self.deadline_ms
        uid = self._next_uid
        self._next_uid += 1
        rec = _Record(
            uid=uid, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens), temperature=temperature,
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p),
            deadline_ms=deadline_ms, t_submit=self._clock(),
            priority=int(priority), corr=corr)
        self._records[uid] = rec
        if self.enabled and self._saturated():
            self._c_deferred.inc()
            self._deferred.append(uid)
            self._g_deferred.set_max(len(self._deferred))
            self.tracer.instant("resilience/backpressure_defer", uid=uid)
            if self._fr.enabled:
                self._fr.record("resilience/backpressure_defer", uid=uid)
        else:
            self._admit_record(rec)
        return uid

    def _admit_record(self, rec: _Record) -> None:
        """Hand one record to the inner engine, as prompt + generated
        when it already holds tokens (the recompute path)."""
        rec.inner_uid = self.engine.submit(
            rec.prompt + rec.tokens, max_new_tokens=rec.remaining,
            temperature=rec.temperature, top_k=rec.top_k, top_p=rec.top_p,
            min_p=rec.min_p, priority=rec.priority, corr=rec.corr)

    def _adopted_record(self, prompt, max_new_tokens, temperature, top_k,
                        top_p, min_p, priority, inner, corr) -> int:
        """The durable record of a request adopted from a handoff: its
        covered context is the prompt, so a crash after the adoption
        replays it as prompt + generated."""
        uid = self._next_uid
        self._next_uid += 1
        self._records[uid] = _Record(
            uid=uid, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens), temperature=temperature,
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p),
            deadline_ms=self.deadline_ms, t_submit=self._clock(),
            priority=int(priority), inner_uid=inner, corr=corr)
        return uid

    # -- disaggregated handoff -------------------------------------------

    def _live(self, uid: int) -> _Record:
        rec = self._records[uid]
        if rec.done or rec.inner_uid is None:
            raise KeyError(f"request {uid} has no active inner request")
        return rec

    def export_handoff(self, uid: int):
        """Package the (active) request's pages for a decode host (see
        :meth:`ServeEngine.export_handoff`); ``uid`` is the wrapper's."""
        return self.engine.export_handoff(self._live(uid).inner_uid)

    def adopt(
        self, handoff, max_new_tokens: int,
        temperature: Optional[float] = None, top_k: int = 0,
        top_p: float = 1.0, min_p: float = 0.0, priority: int = 0,
        corr: Optional[str] = None,
    ) -> Optional[int]:
        """Adopt a handed-off request (see :meth:`ServeEngine.adopt`);
        returns the wrapper uid, or None when the inner engine cannot
        take it.  The imported pages are never the only copy: the record
        keeps the covered context as its prompt."""
        corr = corr if corr is not None else handoff.corr
        inner = self.engine.adopt(
            handoff, max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, min_p=min_p, priority=priority, corr=corr)
        if inner is None:
            return None
        return self._adopted_record(handoff.tokens, max_new_tokens,
                                    temperature, top_k, top_p, min_p,
                                    priority, inner, corr)

    def detach(self, uid: int) -> List[int]:
        """Drop the request from this host without retiring it (it is
        migrating); returns every token it generated here.  The record
        goes: the caller owns the request's further life."""
        rec = self._records.pop(uid)
        toks = list(rec.tokens)
        if not rec.done and rec.inner_uid is not None:
            toks.extend(self.engine.detach(rec.inner_uid))
        try:
            self._deferred.remove(uid)
        except ValueError:
            pass
        return toks

    # -- streamed handoff and prefix migration ---------------------------

    def prefill_progress(self, uid: int):
        """See :meth:`ServeEngine.prefill_progress` (wrapper uid)."""
        rec = self._records.get(uid)
        if rec is None or rec.done or rec.inner_uid is None:
            return None
        return self.engine.prefill_progress(rec.inner_uid)

    def export_prefill_chunk(self, uid: int, start_page: int, seq: int = 0):
        """See :meth:`ServeEngine.export_prefill_chunk` (wrapper uid)."""
        rec = self._records[uid]
        if rec.done or rec.inner_uid is None:
            return None
        return self.engine.export_prefill_chunk(rec.inner_uid, start_page,
                                                seq=seq)

    def export_handoff_tail(self, uid: int, start_page: int, seq: int = 0):
        """See :meth:`ServeEngine.export_handoff_tail` (wrapper uid)."""
        return self.engine.export_handoff_tail(self._live(uid).inner_uid,
                                               start_page, seq=seq)

    def adopt_stage_begin(self):
        """Reserve a staged slot on the inner engine.  The stage token
        pins the engine generation it was taken against: after a crash
        rebuild the staged pages are gone, so the later chunk and commit
        calls refuse and the caller falls back to a whole handoff."""
        inner = self.engine.adopt_stage_begin()
        if inner is None:
            return None
        return (inner, self.restarts)

    def adopt_stage_chunk(self, stage, chunk) -> bool:
        inner, gen = stage
        if gen != self.restarts:
            return False
        return self.engine.adopt_stage_chunk(inner, chunk)

    def adopt_stage_commit(
        self, stage, chunk, max_new_tokens: int,
        temperature: Optional[float] = None, top_k: int = 0,
        top_p: float = 1.0, min_p: float = 0.0, priority: int = 0,
        corr: Optional[str] = None,
    ) -> Optional[int]:
        """Commit a staged stream; as with :meth:`adopt`, the record
        keeps the stream's covered context as its prompt."""
        inner_stage, gen = stage
        if gen != self.restarts:
            return None
        corr = corr if corr is not None else chunk.corr
        inner = self.engine.adopt_stage_commit(
            inner_stage, chunk, max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, min_p=min_p, priority=priority,
            corr=corr)
        if inner is None:
            return None
        return self._adopted_record(chunk.tokens, max_new_tokens,
                                    temperature, top_k, top_p, min_p,
                                    priority, inner, corr)

    def adopt_stage_abort(self, stage) -> None:
        inner, gen = stage
        if gen != self.restarts:
            return
        self.engine.adopt_stage_abort(inner)

    def export_prefix(self, tokens):
        """See :meth:`ServeEngine.export_prefix`."""
        return self.engine.export_prefix(tokens)

    def import_prefix(self, chunk, tokens):
        """See :meth:`ServeEngine.import_prefix`.  The anchor pins the
        engine generation like a stage token: releasing it after a
        crash rebuild does nothing (its pages died with the engine)."""
        pages = self.engine.import_prefix(chunk, tokens)
        if pages is None:
            return None
        return (pages, self.restarts)

    def release_prefix(self, anchor) -> None:
        """Release an :meth:`import_prefix` anchor (a no-op after a crash
        rebuild)."""
        pages, gen = anchor
        if gen != self.restarts:
            return
        self.engine.release_prefix(pages)

    # -- deadline and backpressure scans ---------------------------------

    def _overdue(self, rec: _Record, now: int) -> bool:
        return (rec.deadline_ms is not None and not rec.done
                and (now - rec.t_submit) * _MS > rec.deadline_ms)

    def _check_deadlines(self) -> None:
        self._harvest()  # a finished request can no longer be overdue
        now = self._clock()
        for rec in self._records.values():
            if not self._overdue(rec, now):
                continue
            if rec.inner_uid is not None:
                rec.tokens.extend(self.engine.cancel(rec.inner_uid))
                rec.inner_uid = None
            else:
                try:
                    self._deferred.remove(rec.uid)
                except ValueError:
                    pass
            rec.done = True
            rec.abandoned = True
            rec.truncated = True
            self._c_deadline.inc()
            self.tracer.instant("resilience/deadline_exceeded",
                                uid=rec.uid, tokens=len(rec.tokens))
            if self._fr.enabled:
                self._fr.record("resilience/deadline_exceeded",
                                uid=rec.uid, tokens=len(rec.tokens))

    def _drain_deferred(self) -> None:
        while self._deferred and not self._saturated():
            rec = self._records[self._deferred.popleft()]
            if not rec.done:
                self._admit_record(rec)
        self._g_deferred.set(len(self._deferred))

    # -- crash recovery --------------------------------------------------

    def _find_inner(self, inner_uid: int):
        eng = self.engine
        r = eng.results.get(inner_uid)
        if r is not None:
            return r
        for r in eng._active.values():
            if r.uid == inner_uid:
                return r
        for entry in eng._prefilling.values():
            if entry[0].uid == inner_uid:
                return entry[0]
        for r in eng._queue:
            if r.uid == inner_uid:
                return r
        return None

    def _harvest(self) -> None:
        """Merge finished inner requests into the durable records."""
        eng = self.engine
        for rec in self._records.values():
            if rec.done or rec.inner_uid is None:
                continue
            r = eng.results.get(rec.inner_uid)
            if r is not None and r.done:
                rec.tokens.extend(r.tokens)
                rec.done = True
                rec.truncated = r.truncated
                rec.inner_uid = None

    def _recover(self) -> None:
        """Build a fresh engine from the surviving host state and replay
        every unfinished request as prompt + generated (the prefix
        registry warms again from the replayed prompts)."""
        t0 = self._clock()
        old = self.engine
        # the postmortem before recovery changes anything: its tail holds
        # the boundaries that led up to the crash and the fault itself
        self._fr.dump(reason="engine_crash")
        with self.tracer.span("resilience/engine_restart"):
            # salvage the tokens in the dead engine's host state
            self._harvest()
            for rec in self._records.values():
                if rec.done or rec.inner_uid is None:
                    continue
                r = self._find_inner(rec.inner_uid)
                if r is not None:
                    rec.tokens.extend(r.tokens)
                    if r.done:
                        rec.done = True
                        rec.truncated = r.truncated
                rec.inner_uid = None
            if self.injector is not None:
                # the reserved pages are the dead pool's: give them back
                # to it, before the new engine (and pool) exists
                self.injector.release_pressure()
            self.engine = self._mk_engine()
            eos = self._engine_kwargs.get("eos_id")
            for rec in self._records.values():
                if rec.done or rec.inner_uid is not None:
                    continue
                if rec.remaining <= 0 or (
                        eos is not None and rec.tokens
                        and rec.tokens[-1] == eos):
                    rec.done = True
                    continue
                self._admit_record(rec)
        del old  # the dead engine's cache and pool go with it
        self._c_restarts.inc()
        self._h_recovery.observe((self._clock() - t0) * _MS)
        if self._fr.enabled:
            self._fr.record("resilience/engine_restart")

    # -- the dispatch boundary -------------------------------------------

    def step(self) -> bool:
        """One protected scheduling round; returns False once everything
        is drained (the deferred requests included)."""
        if not self.enabled:
            more = self.engine.step()
            self._harvest()
            return more or any(not r.done and r.inner_uid is None
                               for r in self._records.values())
        self._check_deadlines()
        self._drain_deferred()
        attempt = 0
        while True:
            try:
                more = self.engine.step()
                break
            except DispatchFailure:
                if attempt >= self.max_retries:
                    # the postmortem before the failure leaves the layer
                    self._fr.dump(reason="retry_budget_exceeded")
                    raise RetryBudgetExceeded(
                        f"decode boundary failed {attempt + 1} times")
                self._c_retries.inc()
                self.tracer.instant("resilience/retry", attempt=attempt)
                if self._fr.enabled:
                    self._fr.record("resilience/retry", attempt=attempt)
                time.sleep(self.backoff_s * (2 ** attempt))
                attempt += 1
            except HostPreemption:
                self._recover()
                more = True
                break
        self._harvest()
        return bool(more or self._deferred)

    def run(self, max_rounds: int = 100_000) -> Dict[int, List[int]]:
        """Drain everything; returns ``{uid: generated tokens}`` by the
        wrapper's uids (stable across crashes)."""
        rounds = 0
        while self.step():
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(f"undrained after {max_rounds} rounds")
        if self.injector is not None:
            self.injector.release_pressure()
        return self.results()

    def results(self) -> Dict[int, List[int]]:
        self._harvest()
        return {uid: list(rec.tokens) for uid, rec in self._records.items()}

    def progress(self) -> Dict[int, Tuple[List[int], bool]]:
        """``{uid: (tokens so far, done)}``, in-flight requests' tokens
        included: the stream a router harvests at every boundary."""
        self._harvest()
        out: Dict[int, Tuple[List[int], bool]] = {}
        for uid, rec in self._records.items():
            toks = list(rec.tokens)
            if not rec.done and rec.inner_uid is not None:
                r = self._find_inner(rec.inner_uid)
                if r is not None:
                    # a record takes the inner tokens only at harvest
                    # (finish or crash), so this never counts one twice
                    toks.extend(int(t) for t in r.tokens)
            out[uid] = (toks, rec.done)
        return out

    def request(self, uid: int) -> _Record:
        return self._records[uid]

    # -- accounting ------------------------------------------------------

    def lifecycle_summary(self) -> Dict[str, Any]:
        """The current inner engine's goodput and abandonment summary
        (the lifecycle is per engine generation; the shared registry's
        histograms span rebuilds)."""
        return self.engine.lifecycle_summary()

    def slo_report(self):
        """The inner engine's live SLO report (None without a tracker)."""
        return self.engine.slo_report()

    def stats(self) -> Dict[str, Any]:
        """The inner engine's stats and the wrapper's recovery ledger."""
        s = self.engine.stats()
        s["resilience"] = {
            "retries": self.retries,
            "restarts": self.restarts,
            "deadline_exceeded": self.deadline_exceeded,
            "backpressure_deferred": self.backpressure_deferred,
            "deferred_pending": len(self._deferred),
        }
        return s
