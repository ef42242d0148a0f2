"""Live SLO engine: sliding-window quantiles and error-budget burn.

Counterpart of ``apex_tpu/obs/slo.py``.  A lifetime
:class:`~apex_tpu_torch.obs.metrics.Histogram` can say "p99 TTFT over
the whole run was 80 ms" but not "p99 TTFT over the *last 15 seconds*
is 400 ms and climbing", and only the second is actionable while the
run goes on.  This module is the loop-resident half, cheap enough to
consult at every dispatch boundary:

- :class:`WindowedHistogram`: a ring of fixed-duration sub-window
  histograms.  Observations land in the sub-window their timestamp
  selects; quantiles merge the sub-windows still inside the sliding
  window, so memory stays bounded however long the run.  Timestamps
  come from an injectable clock (the load harness drives a VIRTUAL
  one), so window rotation, and every quantile, is a pure function of
  the observation sequence.
- :class:`SloTracker`: declarative objectives (:func:`parse_objective`
  takes ``"ttft_ms p99 < 50 over 15s"``) with multi-rate error-budget
  burn alerts: an objective ``p99 < X`` grants a budget of 1 %
  violating observations; the tracker keeps violation fractions over a
  FAST window (the objective's own) and a SLOW one (``slow_mult`` x
  longer) and trips when both burn rates cross their thresholds.
  Alerts clear with hysteresis (``clear_burn`` < ``fast_burn``), so the
  admission policy reading :meth:`SloTracker.burning` never flaps.
- :class:`SloReport`: the machine-readable snapshot
  (``to_dict``/``to_json``/``from_json``): per objective the window
  quantile, burn rates, alert state and trip/clear counts, with the
  request-lifecycle goodput/abandonment summary when attached;
  :func:`apex_tpu_torch.obs.export.to_openmetrics` exposes it.

Everything is host-side Python; one ``observe`` is a couple of integer
compares and a float append, and a tracker built with obs off
(:func:`apex_tpu_torch.obs.set_enabled`) is inert.

The scheduler half lives in :mod:`apex_tpu_torch.serve.engine`
(``ServeEngine(slo_admission=True)``, default off): prefill chunks yield
to decode while the ITL budget burns, and priority classes plus the
TTFT-burn overtake reorder admission.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.obs.metrics import Histogram

__all__ = [
    "SloObjective",
    "SloReport",
    "SloTracker",
    "WindowedHistogram",
    "parse_objective",
]

_MS_NS = 1e6  # ms -> ns


class WindowedHistogram:
    """Sliding-window quantiles from a ring of sub-window histograms.

    The window ``[t - window_ms, t]`` is approximated by the
    ``sub_windows`` most recent fixed-duration buckets (each
    ``window_ms / sub_windows`` long, aligned to the clock origin) —
    the standard ring-buffer tradeoff: rotation is O(1), the window
    edge is quantized to one sub-window, and memory is bounded by
    ``sub_windows * max_samples`` no matter how long the process
    lives.  Each bucket is a plain
    :class:`~apex_tpu_torch.obs.metrics.Histogram`, so within a bucket the
    deterministic decimation story is unchanged and the merged
    window quantile is nearest-rank over the concatenated retained
    samples — a pure function of the (value, timestamp) sequence.

    Timestamps are clock ns; ``clock`` (default
    ``time.perf_counter_ns``) only supplies them when the caller does
    not.  The serve load harness passes a virtual clock, which is what
    makes two seeded runs produce byte-identical SLO reports.

    Lifetime ``count``/``sum``/``min``/``max`` stay exact forever,
    like the flat histogram.
    """

    __slots__ = ("name", "window_ms", "sub_windows", "count", "sum",
                 "min", "max", "_sub_ns", "_max_samples", "_clock",
                 "_ring", "_head")

    def __init__(self, name: str, window_ms: float = 15_000.0,
                 sub_windows: int = 8, max_samples: int = 8192,
                 clock=None):
        if window_ms <= 0 or sub_windows < 2:
            raise ValueError(
                f"need window_ms > 0 and sub_windows >= 2, got "
                f"{window_ms}/{sub_windows}"
            )
        self.name = name
        self.window_ms = float(window_ms)
        self.sub_windows = int(sub_windows)
        self._sub_ns = int(window_ms * _MS_NS) // int(sub_windows)
        self._max_samples = int(max_samples)
        self._clock = clock or time.perf_counter_ns
        # (bucket_index, Histogram) newest-last; bucket_index is the
        # absolute t // sub_ns, so rotation is pure timestamp math
        self._ring: List[Tuple[int, Histogram]] = []
        self._head: Optional[int] = None  # newest bucket index seen
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, t: int) -> int:
        return int(t) // self._sub_ns

    def _advance(self, b: int) -> None:
        """Move the window head to bucket ``b`` (monotonic — a stale
        timestamp clamps into the current head so determinism never
        depends on out-of-order arrival)."""
        if self._head is None or b > self._head:
            self._head = b
        floor = self._head - self.sub_windows + 1
        while self._ring and self._ring[0][0] < floor:
            self._ring.pop(0)

    def advance(self, t: Optional[int] = None) -> None:
        """Let time pass without observing — expired sub-windows drop
        out, so a quantile taken after a quiet period reflects it."""
        self._advance(self._bucket(self._clock() if t is None else t))

    def observe(self, v, t: Optional[int] = None) -> None:
        t = self._clock() if t is None else int(t)
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        b = self._bucket(t)
        self._advance(b)
        if b < self._head:  # stale: clamp into the live head bucket
            b = self._head
        if not self._ring or self._ring[-1][0] != b:
            self._ring.append(
                (b, Histogram(self.name, max_samples=self._max_samples))
            )
        self._ring[-1][1].observe(v)

    # -- window queries --------------------------------------------------

    def _window_samples(self) -> List[float]:
        out: List[float] = []
        for _, h in self._ring:
            out.extend(h._samples)
        return out

    def window_count(self) -> int:
        return sum(h.count for _, h in self._ring)

    def quantile(self, q: float, t: Optional[int] = None) -> float:
        """Nearest-rank quantile over the current window (NaN when the
        window is empty).  Passing ``t`` first lets time pass."""
        if t is not None:
            self.advance(t)
        s = self._window_samples()
        if not s:
            return math.nan
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s.sort()
        return s[max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))]

    def snapshot(self, t: Optional[int] = None) -> Dict[str, object]:
        if t is not None:
            self.advance(t)
        n = self.window_count()
        d: Dict[str, object] = {
            "type": "windowed_histogram",
            "window_ms": self.window_ms,
            "sub_windows": self.sub_windows,
            "window_count": n,
            "lifetime_count": self.count,
        }
        if n:
            d.update({
                "p50": self.quantile(0.50),
                "p90": self.quantile(0.90),
                "p99": self.quantile(0.99),
            })
        return d


_OBJECTIVE_RE = re.compile(
    r"^\s*(?P<metric>[\w.]+)\s+p(?P<pct>\d+(?:\.\d+)?)\s*<\s*"
    r"(?P<thresh>[\d.]+)\s*(?:over\s+(?P<win>[\d.]+)\s*s)?\s*$"
)


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective: ``metric``'s ``quantile`` must stay
    below ``threshold`` over a sliding ``window_ms``.  The error budget
    is ``1 - quantile``: a ``p99 < X`` objective tolerates 1 % of
    observations above X; the burn rate is the observed violating
    fraction divided by that budget (burn 1.0 = spending exactly the
    budget, 2.0 = twice as fast)."""

    metric: str
    quantile: float
    threshold: float
    window_ms: float = 15_000.0

    def __post_init__(self):
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"quantile {self.quantile} outside (0, 1)")
        if self.threshold <= 0 or self.window_ms <= 0:
            raise ValueError(
                f"threshold/window must be positive "
                f"({self.threshold}/{self.window_ms})"
            )

    @property
    def name(self) -> str:
        pct = self.quantile * 100
        p = f"{pct:g}"
        return f"{self.metric}_p{p}"

    @property
    def budget(self) -> float:
        return 1.0 - self.quantile

    def describe(self) -> str:
        return (f"{self.metric} p{self.quantile * 100:g} < "
                f"{self.threshold:g} over {self.window_ms / 1e3:g}s")


def parse_objective(spec: str,
                    window_ms: float = 15_000.0) -> SloObjective:
    """Parse ``"ttft_ms p99 < 50 over 15s"`` (the ``over`` clause is
    optional and defaults to ``window_ms``)."""
    m = _OBJECTIVE_RE.match(spec)
    if m is None:
        raise ValueError(
            f"bad objective {spec!r} (want 'metric pNN < X [over Ns]')"
        )
    win = m.group("win")
    return SloObjective(
        metric=m.group("metric"),
        quantile=float(m.group("pct")) / 100.0,
        threshold=float(m.group("thresh")),
        window_ms=float(win) * 1e3 if win else float(window_ms),
    )


class _WindowedCounter:
    """(good, bad) observation counts over a sliding window — the burn
    ledger, same absolute-bucket rotation as the histogram ring but
    integers only, so burn math is exact."""

    __slots__ = ("_sub_ns", "_n", "_ring", "_head")

    def __init__(self, window_ms: float, sub_windows: int = 8):
        self._sub_ns = int(window_ms * _MS_NS) // int(sub_windows)
        self._n = int(sub_windows)
        self._ring: List[List[int]] = []  # [bucket, good, bad]
        self._head: Optional[int] = None

    def _advance(self, b: int) -> None:
        if self._head is None or b > self._head:
            self._head = b
        floor = self._head - self._n + 1
        while self._ring and self._ring[0][0] < floor:
            self._ring.pop(0)

    def observe(self, bad: bool, t: int) -> None:
        b = int(t) // self._sub_ns
        self._advance(b)
        if b < self._head:
            b = self._head
        if not self._ring or self._ring[-1][0] != b:
            self._ring.append([b, 0, 0])
        self._ring[-1][2 if bad else 1] += 1

    def advance(self, t: int) -> None:
        self._advance(int(t) // self._sub_ns)

    def fractions(self) -> Tuple[int, int]:
        good = sum(r[1] for r in self._ring)
        bad = sum(r[2] for r in self._ring)
        return good, bad


class _ObjectiveState:
    """One objective's live state: the window histogram, fast/slow burn
    ledgers, and the hysteretic alert flag."""

    __slots__ = ("objective", "hist", "fast", "slow", "alerting",
                 "trips", "clears")

    def __init__(self, objective: SloObjective, slow_mult: float,
                 sub_windows: int, max_samples: int, clock):
        self.objective = objective
        self.hist = WindowedHistogram(
            objective.name, window_ms=objective.window_ms,
            sub_windows=sub_windows, max_samples=max_samples,
            clock=clock,
        )
        self.fast = _WindowedCounter(objective.window_ms, sub_windows)
        self.slow = _WindowedCounter(
            objective.window_ms * slow_mult, sub_windows
        )
        self.alerting = False
        self.trips = 0
        self.clears = 0

    def burn(self, counter: _WindowedCounter) -> float:
        good, bad = counter.fractions()
        total = good + bad
        if not total:
            return 0.0
        return (bad / total) / self.objective.budget


class SloTracker:
    """Declarative SLO objectives with multi-rate burn alerts.

    Args:
      objectives: :class:`SloObjective` instances or
        :func:`parse_objective` strings.
      clock: ns clock for observations without explicit timestamps
        (the load harness passes its virtual clock).
      fast_burn / slow_burn: an alert TRIPS when the fast-window burn
        rate reaches ``fast_burn`` (default 2.0 — budget spending at
        2x) AND the slow-window burn reaches ``slow_burn`` (default
        1.0) — the classic two-window rule: the slow condition stops a
        single hot sub-window from alerting, the fast condition stops
        a long-cooled incident from lingering.
      clear_burn: the alert CLEARS only when the fast burn falls below
        this (default 1.0) — the hysteresis band between ``clear_burn``
        and ``fast_burn`` holds the last state, so admission policy
        reading :meth:`burning` never flaps on the threshold.
      slow_mult: slow window length as a multiple of each objective's
        own window (default 4).
      enabled: None defers to :func:`apex_tpu_torch.obs.enabled`; a
        disabled tracker's every entry point is a cheap no-op.
    """

    def __init__(
        self,
        objectives: Sequence,
        *,
        clock=None,
        fast_burn: float = 2.0,
        slow_burn: float = 1.0,
        clear_burn: float = 1.0,
        slow_mult: float = 4.0,
        sub_windows: int = 8,
        max_samples: int = 8192,
        enabled: Optional[bool] = None,
    ):
        from apex_tpu_torch.obs.trace import enabled as obs_enabled

        if clear_burn > fast_burn:
            raise ValueError(
                f"clear_burn {clear_burn} must not exceed fast_burn "
                f"{fast_burn} (the hysteresis band would be inverted)"
            )
        self.enabled = obs_enabled() if enabled is None else bool(enabled)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.clear_burn = float(clear_burn)
        self.slow_mult = float(slow_mult)
        self._clock = clock or time.perf_counter_ns
        self.observations = 0
        self._states: List[_ObjectiveState] = []
        self._by_metric: Dict[str, List[_ObjectiveState]] = {}
        for o in objectives:
            if isinstance(o, str):
                o = parse_objective(o)
            st = _ObjectiveState(o, self.slow_mult, sub_windows,
                                 max_samples, self._clock)
            self._states.append(st)
            self._by_metric.setdefault(o.metric, []).append(st)

    @classmethod
    def default_serve(cls, *, ttft_p99_ms: float = 200.0,
                      itl_p99_ms: float = 50.0,
                      window_s: float = 15.0, **kw) -> "SloTracker":
        """The stock serving tracker the engine builds when
        ``slo_admission=True`` arrives without an explicit tracker: p99
        TTFT and p99 inter-token latency objectives over one sliding
        window."""
        w = window_s * 1e3
        return cls([
            SloObjective("ttft_ms", 0.99, ttft_p99_ms, w),
            SloObjective("itl_ms", 0.99, itl_p99_ms, w),
        ], **kw)

    @property
    def objectives(self) -> List[SloObjective]:
        return [st.objective for st in self._states]

    # -- the hot path ----------------------------------------------------

    def observe(self, metric: str, value,
                t: Optional[int] = None) -> None:
        """Route one observation (clock ns timestamp) to every
        objective on ``metric`` and update their alert states."""
        if not self.enabled:
            return
        states = self._by_metric.get(metric)
        if not states:
            return
        t = self._clock() if t is None else int(t)
        v = float(value)
        self.observations += 1
        for st in states:
            st.hist.observe(v, t)
            bad = v >= st.objective.threshold
            st.fast.observe(bad, t)
            st.slow.observe(bad, t)
            self._update_alert(st)

    def _update_alert(self, st: _ObjectiveState) -> None:
        from apex_tpu_torch.obs.flightrec import default_flightrec

        fast = st.burn(st.fast)
        if st.alerting:
            if fast < self.clear_burn:
                st.alerting = False
                st.clears += 1
                fr = default_flightrec()
                if fr.enabled:
                    # alert TRANSITIONS (not per-observation state) ride
                    # the black box: a postmortem shows which budgets
                    # were burning on the way down
                    fr.record("slo/alert_clear",
                              objective=st.objective.name,
                              metric=st.objective.metric)
        elif fast >= self.fast_burn and st.burn(st.slow) >= self.slow_burn:
            st.alerting = True
            st.trips += 1
            fr = default_flightrec()
            if fr.enabled:
                fr.record("slo/alert_trip",
                          objective=st.objective.name,
                          metric=st.objective.metric)

    def _advance(self, st: _ObjectiveState, t: int) -> None:
        st.hist.advance(t)
        st.fast.advance(t)
        st.slow.advance(t)
        self._update_alert(st)

    def burning(self, metric: Optional[str] = None,
                t: Optional[int] = None) -> bool:
        """Whether any objective (on ``metric``, or overall) is in the
        alerting state *as of* ``t`` — time passing can clear an alert
        even with no new observations."""
        if not self.enabled:
            return False
        states = (self._states if metric is None
                  else self._by_metric.get(metric, []))
        if not states:
            return False
        t = self._clock() if t is None else int(t)
        for st in states:
            self._advance(st, t)
        return any(st.alerting for st in states)

    # -- reporting -------------------------------------------------------

    def report(self, t: Optional[int] = None,
               lifecycle: Optional[dict] = None) -> "SloReport":
        """The machine-readable snapshot as of ``t``; attach a
        :meth:`~apex_tpu_torch.obs.lifecycle.RequestLifecycle.summary` dict
        to carry goodput/abandonment alongside the objectives."""
        t = self._clock() if t is None else int(t)
        rows = []
        for st in self._states:
            if self.enabled:
                self._advance(st, t)
            o = st.objective
            cur = st.hist.quantile(o.quantile)
            rows.append({
                "name": o.name,
                "metric": o.metric,
                "quantile": o.quantile,
                "threshold": o.threshold,
                "window_ms": o.window_ms,
                "window_count": st.hist.window_count(),
                "current": None if math.isnan(cur) else cur,
                "met": (None if math.isnan(cur)
                        else bool(cur < o.threshold)),
                "burn_fast": round(st.burn(st.fast), 4),
                "burn_slow": round(st.burn(st.slow), 4),
                "alerting": st.alerting,
                "trips": st.trips,
                "clears": st.clears,
            })
        return SloReport(objectives=rows, t_ns=t,
                         enabled=self.enabled, lifecycle=lifecycle)


@dataclasses.dataclass
class SloReport:
    """Machine-readable SLO snapshot: what a scrape or a trace artifact
    carries.  ``objectives`` rows are plain dicts (see
    :meth:`SloTracker.report`); ``lifecycle`` is the optional
    goodput/abandonment summary."""

    objectives: List[dict]
    t_ns: int = 0
    enabled: bool = True
    lifecycle: Optional[dict] = None

    def alerting(self) -> List[str]:
        return [r["name"] for r in self.objectives if r["alerting"]]

    def to_dict(self) -> dict:
        d = {
            "schema": "apex_tpu.slo.v1",
            "enabled": self.enabled,
            "t_ns": self.t_ns,
            "objectives": self.objectives,
        }
        if self.lifecycle is not None:
            d["lifecycle"] = self.lifecycle
        return d

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=float)

    @classmethod
    def from_dict(cls, d: dict) -> "SloReport":
        return cls(objectives=list(d.get("objectives", [])),
                   t_ns=int(d.get("t_ns", 0)),
                   enabled=bool(d.get("enabled", True)),
                   lifecycle=d.get("lifecycle"))

    @classmethod
    def from_json(cls, text: str) -> "SloReport":
        return cls.from_dict(json.loads(text))
