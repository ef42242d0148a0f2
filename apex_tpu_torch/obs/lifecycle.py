"""Per-request lifecycle accounting: TTFT, ITL and queue delay.

Counterpart of ``apex_tpu/obs/lifecycle.py``.  The serving numbers that
matter to a user are the request-level tail: how long until the first
token (TTFT), how fast tokens stream after it (inter-token latency,
ITL), and how long a request sat queued before a slot opened.  This
module computes them on the host from the engine's own boundary
timestamps: no clock read beyond one per dispatch boundary, and no
device read at all (token counts come from the window's one fetch).

Timing model (the fused window): tokens materialize in batches at host
fetch points: the prefill fetch yields token 1, each K-token decode
window yields up to K at one sync.  For a batch of ``n`` tokens fetched
at time ``t`` with the previous fetch at ``t_prev``:

- the request's FIRST token sets ``ttft = t - t_submit``;
- every other token in the batch adds one ITL observation of
  ``(t - t_prev) / n`` (the window's latency amortized over the tokens
  it produced).

All three distributions land in the registry as exact-quantile
histograms (``serve.ttft_ms``, ``serve.itl_ms``,
``serve.queue_delay_ms``), with ``serve.request_latency_ms`` and
``serve.tokens_per_request`` at retirement.

The same observations optionally go to a live
:class:`~apex_tpu_torch.obs.slo.SloTracker`, so the SLO engine and the
lifetime histograms see identical values, and
:meth:`RequestLifecycle.summary` is the one source of goodput
(completed tokens / wall) and abandonment rate.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from apex_tpu_torch.obs.metrics import MetricsRegistry

__all__ = ["NULL_LIFECYCLE", "RequestLifecycle"]

_MS = 1e-6  # ns -> ms


class RequestLifecycle:
    """Host-side request timelines feeding lifecycle histograms.

    The engine calls :meth:`submitted` / :meth:`admitted` /
    :meth:`tokens` / :meth:`finished` with ONE shared timestamp per
    dispatch boundary (``clock()`` ns).  State per request is a 4-slot
    list — allocation stays O(live requests).  ``slo`` tees every
    TTFT/ITL/queue-delay observation into a
    :class:`~apex_tpu_torch.obs.slo.SloTracker` under the metric names
    ``ttft_ms`` / ``itl_ms`` / ``queue_delay_ms``.
    """

    def __init__(self, registry: MetricsRegistry, prefix: str = "serve.",
                 slo=None):
        self._reg = registry
        self._slo = slo
        self._ttft = registry.histogram(prefix + "ttft_ms")
        self._itl = registry.histogram(prefix + "itl_ms")
        self._queue = registry.histogram(prefix + "queue_delay_ms")
        self._latency = registry.histogram(prefix + "request_latency_ms")
        self._ntok = registry.histogram(prefix + "tokens_per_request")
        self._abandoned = registry.histogram(prefix + "abandoned_after_ms")
        self._c_completed_tok = registry.counter(
            prefix + "completed_tokens"
        )
        # uid -> [t_submit, t_admit, t_last_fetch, tokens_so_far]
        self._live: Dict[int, List] = {}
        # uid -> correlation id: stamped at submit so a request's
        # records stitch into a cross-host flow; kept past retirement
        # (postmortems read finished requests)
        self._corr: Dict[int, str] = {}
        # goodput/abandonment accounting (summary())
        self._completed = 0
        self._abandoned_n = 0
        self._completed_tokens = 0
        self._abandoned_tokens = 0
        self._t_first: Optional[int] = None
        self._t_last: Optional[int] = None

    def submitted_at(self, uid: int):
        """Submit timestamp (clock ns) of a live request, or None (the
        deadline scanner's source of truth)."""
        rec = self._live.get(uid)
        return rec[0] if rec is not None else None

    def submitted(self, uid: int, t: int,
                  corr: Optional[str] = None) -> None:
        self._live[uid] = [t, None, None, 0]
        if corr is not None:
            self._corr[uid] = str(corr)
        if self._t_first is None:
            self._t_first = t
        self._mark(t)

    def corr_of(self, uid: int) -> Optional[str]:
        """The request's correlation id, or None when it was submitted
        without one (single-engine callers)."""
        return self._corr.get(uid)

    def _mark(self, t: int) -> None:
        if self._t_last is None or t > self._t_last:
            self._t_last = t

    def admitted(self, uid: int, t: int) -> None:
        """First admission into a slot (re-admission after preemption
        does not re-observe queue delay — the request already paid it)."""
        rec = self._live.get(uid)
        if rec is None or rec[1] is not None:
            return
        rec[1] = t
        qd = (t - rec[0]) * _MS
        self._queue.observe(qd)
        if self._slo is not None:
            self._slo.observe("queue_delay_ms", qd, t)

    def tokens(self, uid: int, n: int, t: int) -> None:
        """``n`` tokens for ``uid`` materialized at host time ``t``."""
        rec = self._live.get(uid)
        if rec is None or n <= 0:
            return
        if rec[2] is None:
            ttft = (t - rec[0]) * _MS
            self._ttft.observe(ttft)
            if self._slo is not None:
                self._slo.observe("ttft_ms", ttft, t)
            extra = n - 1
        else:
            extra = n
        if extra > 0:
            prev = rec[2] if rec[2] is not None else t
            itl = (t - prev) * _MS / n
            for _ in range(extra):
                self._itl.observe(itl)
                if self._slo is not None:
                    self._slo.observe("itl_ms", itl, t)
        rec[2] = t
        rec[3] += n
        self._mark(t)

    def finished(self, uid: int, t: int) -> None:
        rec = self._live.pop(uid, None)
        if rec is None:
            return
        self._latency.observe((t - rec[0]) * _MS)
        self._ntok.observe(rec[3])
        self._completed += 1
        self._completed_tokens += rec[3]
        self._c_completed_tok.inc(rec[3])
        self._mark(t)

    def abandoned(self, uid: int, t: int) -> None:
        """Deadline/cancellation retirement: the request left without a
        normal finish — its age lands in ``serve.abandoned_after_ms``
        instead of polluting the completed-request latency histogram."""
        rec = self._live.pop(uid, None)
        if rec is None:
            return
        self._abandoned.observe((t - rec[0]) * _MS)
        self._abandoned_n += 1
        self._abandoned_tokens += rec[3]
        self._mark(t)

    def summary(self) -> Dict[str, object]:
        """Goodput + abandonment, computed once here (the SLO report and
        the load harness read this): goodput = tokens of COMPLETED
        requests / wall between the first submit and the last lifecycle
        event (the same clock everything else uses, virtual under the
        load harness)."""
        retired = self._completed + self._abandoned_n
        wall_ms = (
            (self._t_last - self._t_first) * _MS
            if self._t_first is not None and self._t_last is not None
            else 0.0
        )
        return {
            "completed": self._completed,
            "abandoned": self._abandoned_n,
            "abandonment_rate": (
                round(self._abandoned_n / retired, 4) if retired else 0.0
            ),
            "completed_tokens": self._completed_tokens,
            "abandoned_tokens": self._abandoned_tokens,
            "wall_ms": round(wall_ms, 3),
            "goodput_tokens_per_s": (
                round(self._completed_tokens / (wall_ms * 1e-3), 2)
                if wall_ms > 0 else 0.0
            ),
        }


class _NullLifecycle:
    """No-op lifecycle for engines built with obs off."""

    __slots__ = ()

    def submitted(self, uid, t, corr=None):
        pass

    def corr_of(self, uid):
        return None

    def admitted(self, uid, t):
        pass

    def tokens(self, uid, n, t):
        pass

    def finished(self, uid, t):
        pass

    def abandoned(self, uid, t):
        pass

    def submitted_at(self, uid):
        return None

    def summary(self):
        return {
            "completed": 0, "abandoned": 0, "abandonment_rate": 0.0,
            "completed_tokens": 0, "abandoned_tokens": 0,
            "wall_ms": 0.0, "goodput_tokens_per_s": 0.0,
        }


NULL_LIFECYCLE = _NullLifecycle()
