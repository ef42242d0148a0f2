"""Deterministic fault injection: seeded, replayable, host side only.

Counterpart of ``apex_tpu/resilience/faults.py``, with the same plan
vocabulary, the same seeded draws and the same JSON schema, so a plan
drawn or serialised by either package replays in the other byte for
byte.  Failures become a deterministic input:

- a :class:`FaultPlan` is an explicit schedule of :class:`FaultEvent`\\ s
  keyed by ``(site, invocation index)``.  Sites are the host-side
  dispatch boundaries the driver and the engine already own
  (``train/dispatch``, ``serve/decode_window``, ``serve/boundary``,
  ...); no kernel is touched, so injection cannot perturb the numbers a
  launch computes;
- :meth:`FaultPlan.from_seed` derives a schedule from one integer seed
  (numpy ``RandomState``, in JAX's draw order), so every failure found
  in a chaos sweep replays as a regression test by quoting its seed;
- a :class:`FaultInjector` executes the plan: it sleeps for stall and
  straggler events, raises :class:`DispatchFailure` or
  :class:`HostPreemption` for error and crash events, poisons the
  host-fetched meters for NaN events and reserves pool pages for one
  boundary for pressure events, each firing counted in the
  ``resilience.injected.*`` counters, stamped on the tracer and
  recorded in the flight recorder.

The resilient wrappers (:mod:`apex_tpu_torch.resilience.train`,
:mod:`apex_tpu_torch.resilience.serve`) catch these exceptions and
heal; an injector wired into a bare ``ServeEngine`` or
``FusedTrainDriver`` run shows what an unprotected stack does (it
dies).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch import obs

__all__ = [
    "DISPATCH_ERROR",
    "ENGINE_CRASH",
    "EXCHANGE_STALL",
    "DispatchFailure",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "GANG_FAULT_KINDS",
    "HEARTBEAT_DROP",
    "HOST_FAULT_KINDS",
    "HOST_LOSS",
    "HOST_STALL",
    "HostPreemption",
    "InjectedFault",
    "LOADER_STALL",
    "NAN_METERS",
    "PAGE_PRESSURE",
    "PREEMPTION",
    "RANK_LOSS",
    "RESTART",
    "STRAGGLER",
    "gang_site",
    "host_site",
    "resilience_default",
]

# fault kinds (plan vocabulary; see FaultInjector for each one's effect)
DISPATCH_ERROR = "dispatch_error"   # raise DispatchFailure before a dispatch
PREEMPTION = "preemption"           # raise HostPreemption (train teardown)
ENGINE_CRASH = "engine_crash"       # raise HostPreemption (serve teardown)
NAN_METERS = "nan_meters"           # poison host-fetched loss/grad meters
LOADER_STALL = "loader_stall"       # sleep `value` s at the loader site
STRAGGLER = "straggler"             # sleep `value` s before a dispatch
PAGE_PRESSURE = "page_pressure"     # reserve `value` pool pages one boundary

# host-scoped kinds: fleet failure modes, polled by a fleet router at
# its per-host sites (``host_site(h)``) once per round; the router
# interprets them, since their effect is that a host leaves or rejoins
HOST_LOSS = "host_loss"             # the whole host process dies
HOST_STALL = "host_stall"           # host wedges: misses `value` heartbeats
HEARTBEAT_DROP = "heartbeat_drop"   # one heartbeat lost in transit (flap)
RESTART = "restart"                 # a lost/evicted host comes back up

# gang-train kinds: elastic-gang failure modes, keyed ``(rank, site,
# window index)`` through ``gang_site(r)`` and polled by a gang worker
# once per window with :meth:`FaultPlan.poll_at`
RANK_LOSS = "rank_loss"             # the worker process dies at a window
EXCHANGE_STALL = "exchange_stall"   # worker stalls `value` s pre-exchange

# the draw order of FaultPlan.from_seed: kinds appended later draw last,
# so older seeds' schedules never move
FAULT_KINDS = (
    DISPATCH_ERROR, PREEMPTION, ENGINE_CRASH, NAN_METERS, LOADER_STALL,
    STRAGGLER, PAGE_PRESSURE, HOST_LOSS, HOST_STALL, HEARTBEAT_DROP,
    RESTART, RANK_LOSS, EXCHANGE_STALL,
)

HOST_FAULT_KINDS = (HOST_LOSS, HOST_STALL, HEARTBEAT_DROP, RESTART)

GANG_FAULT_KINDS = (RANK_LOSS, EXCHANGE_STALL)


def host_site(host_id: int) -> str:
    """The per-host fleet site (``fleet/host<h>``): host-scoped events
    are keyed ``(host_id, site, invocation index)``."""
    return f"fleet/host{int(host_id)}"


def gang_site(rank: int) -> str:
    """The per-rank gang site (``gang/rank<r>``), keyed by the rank that
    drew the schedule, whatever an elastic resize renumbers it to."""
    return f"gang/rank{int(rank)}"


def resilience_default(flag: Optional[bool] = None) -> bool:
    """The self-healing switch: the explicit argument, or on (None).
    Off makes the resilient wrappers transparent pass-throughs: no
    retries, no rollback, no backpressure, faults propagate.  (JAX also
    reads ``APEX_TPU_RESILIENCE``; the port reads no environment
    variable.)"""
    return True if flag is None else bool(flag)


class InjectedFault(RuntimeError):
    """Base of every deliberately injected failure; carries its event."""

    def __init__(self, event: "FaultEvent"):
        super().__init__(
            f"injected {event.kind} at {event.site}[{event.index}]")
        self.event = event


class DispatchFailure(InjectedFault):
    """A dispatch failed before launching (the retryable class: nothing
    ran, so the carry and the cache are intact)."""


class HostPreemption(InjectedFault):
    """The host process was preempted or the engine crashed: its live
    state is gone, and recovery rebuilds from durable state
    (checkpoints, request records, the recompute path)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: fire at the ``index``-th poll of ``site``.

    ``value`` parameterizes the kind: seconds for ``straggler`` and
    ``loader_stall``, pool pages for ``page_pressure``, heartbeats for
    ``host_stall``, seconds for ``exchange_stall``; unused otherwise.
    """

    site: str
    index: int
    kind: str
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (have {FAULT_KINDS})")
        if self.index < 0:
            raise ValueError(f"negative fault index {self.index}")


class FaultPlan:
    """An explicit, replayable schedule of fault events.

    The events are fixed once built; the only mutation is one
    invocation counter per site, which :meth:`reset` rewinds, so the same
    plan object replays identically.  ``fired`` is the ledger of every
    event that triggered.
    """

    def __init__(self, events: Iterable[FaultEvent] = (),
                 seed: Optional[int] = None):
        self.seed = seed
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self._by_key: Dict[Tuple[str, int], List[FaultEvent]] = {}
        for ev in self.events:
            self._by_key.setdefault((ev.site, ev.index), []).append(ev)
        self._counts: Dict[str, int] = {}
        self.fired: List[FaultEvent] = []

    # -- construction ---------------------------------------------------

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        horizon: int = 32,
        rates: Optional[Dict[str, float]] = None,
        sites: Optional[Dict[str, Sequence[str]]] = None,
        stall_s: float = 0.002,
        pressure_pages: int = 4,
        hosts: int = 0,
        stall_beats: int = 2,
        gang_ranks: int = 0,
        gang_stall_s: float = 0.05,
    ) -> "FaultPlan":
        """Derive a schedule from one integer seed.

        For every (kind, site, index < horizon) an independent Bernoulli
        draw at ``rates[kind]`` decides whether an event is scheduled:
        ``numpy.random.RandomState(seed)`` drawing ``horizon`` uniforms a
        (kind, site) in :data:`FAULT_KINDS` order, whether or not the
        kind's rate is zero, so a rate never shifts another kind's draws
        and the plan is JAX's byte for byte.  ``sites`` maps a kind to
        the sites it may fire at (defaults: the train driver's and the
        serve engine's boundaries).  ``hosts=N`` draws the host kinds
        over N :func:`host_site`\\ s (``stall_beats`` is ``host_stall``'s
        value); ``gang_ranks=N`` draws the gang kinds over N
        :func:`gang_site`\\ s (``gang_stall_s`` is ``exchange_stall``'s
        value).  Both default to 0, which draws nothing for those
        kinds.
        """
        rates = dict(rates or {})
        default_sites: Dict[str, Sequence[str]] = {
            DISPATCH_ERROR: ("train/dispatch", "serve/decode_window"),
            PREEMPTION: ("train/dispatch",),
            ENGINE_CRASH: ("serve/boundary",),
            NAN_METERS: ("train/meters",),
            LOADER_STALL: ("train/loader",),
            STRAGGLER: ("train/dispatch", "serve/decode_window"),
            PAGE_PRESSURE: ("serve/boundary",),
        }
        fleet_sites = tuple(host_site(h) for h in range(int(hosts)))
        for kind in HOST_FAULT_KINDS:
            default_sites[kind] = fleet_sites
        rank_sites = tuple(gang_site(r) for r in range(int(gang_ranks)))
        for kind in GANG_FAULT_KINDS:
            default_sites[kind] = rank_sites
        sites = {**default_sites, **(sites or {})}
        rng = np.random.RandomState(seed)
        events: List[FaultEvent] = []
        for kind in FAULT_KINDS:  # fixed iteration order = fixed draws
            rate = rates.get(kind, 0.0)
            for site in sites[kind]:
                draws = rng.rand(horizon)
                if rate <= 0.0:
                    continue  # after the draw: rates don't shift others
                for idx in np.nonzero(draws < rate)[0]:
                    value = 0.0
                    if kind in (LOADER_STALL, STRAGGLER):
                        value = stall_s
                    elif kind == PAGE_PRESSURE:
                        value = float(pressure_pages)
                    elif kind == HOST_STALL:
                        value = float(stall_beats)
                    elif kind == EXCHANGE_STALL:
                        value = gang_stall_s
                    events.append(FaultEvent(site, int(idx), kind, value))
        return cls(events, seed=seed)

    # -- polling --------------------------------------------------------

    def poll(self, site: str) -> List[FaultEvent]:
        """Advance ``site``'s invocation counter and return the events
        scheduled at the index it just passed (empty for most polls)."""
        idx = self._counts.get(site, 0)
        self._counts[site] = idx + 1
        evs = self._by_key.get((site, idx), [])
        self.fired.extend(evs)
        return evs

    def poll_at(self, site: str, index: int) -> List[FaultEvent]:
        """The events scheduled at an explicit ``(site, index)``, without
        touching the site's counter (a gang worker's hook: its events
        are keyed by window, and a relaunched worker resuming at window
        W fires window W's events).  They land in ``fired`` like
        :meth:`poll`'s."""
        evs = self._by_key.get((site, int(index)), [])
        self.fired.extend(evs)
        return evs

    def peek_count(self, site: str) -> int:
        """How many times ``site`` has been polled."""
        return self._counts.get(site, 0)

    def reset(self) -> None:
        """Rewind every site counter and the fired ledger: the same plan
        then replays identically."""
        self._counts.clear()
        self.fired.clear()

    # -- serialization (the byte-for-byte replay contract) --------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": "apex_tpu.faultplan.v1",
                "seed": self.seed,
                "events": [dataclasses.asdict(ev) for ev in sorted(
                    self.events, key=lambda e: (e.site, e.index, e.kind))],
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        return cls((FaultEvent(**ev) for ev in doc["events"]),
                   seed=doc.get("seed"))

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, events={len(self.events)}, "
                f"fired={len(self.fired)})")


class FaultInjector:
    """Executes a :class:`FaultPlan` at the host dispatch boundaries.

    One injector serves one logical run (its counters live in the plan);
    the resilient wrappers thread it through driver and engine.  Every
    firing lands in the ``resilience.faults_injected`` and
    ``resilience.injected.<kind>`` counters, a ``resilience/fault``
    instant and a ``fault`` flight-recorder event, so the recovery
    ledger shows each cause next to its effect.  ``sleep`` is injectable
    (tests record the stalls instead of sleeping).
    """

    def __init__(self, plan: FaultPlan, registry=None, tracer=None,
                 sleep=time.sleep, flightrec=None):
        self.plan = plan
        self.registry = obs.default_registry() if registry is None \
            else registry
        self.tracer = obs.default_tracer() if tracer is None else tracer
        self.flightrec = obs.default_flightrec() if flightrec is None \
            else flightrec
        self._sleep = sleep
        # (pool, pages) reservations released at the next boundary
        self._reserved: List[Tuple[Any, List[int]]] = []

    def _record(self, ev: FaultEvent) -> None:
        self.registry.counter("resilience.faults_injected").inc()
        self.registry.counter(f"resilience.injected.{ev.kind}").inc()
        self.tracer.instant("resilience/fault", site=ev.site,
                            index=ev.index, kind=ev.kind)
        if self.flightrec.enabled:
            # the cause, right after the boundary events that led to it
            self.flightrec.record("fault", kind=ev.kind, site=ev.site,
                                  index=ev.index)

    # -- hooks ----------------------------------------------------------

    def poll_site(self, site: str) -> List[FaultEvent]:
        """Poll ``site`` and return its events, recorded and not raised:
        the hook of a caller that interprets the kinds itself (a fleet
        router's host kinds change the topology rather than fail one
        dispatch)."""
        evs = self.plan.poll(site)
        for ev in evs:
            self._record(ev)
        return evs

    def before_dispatch(self, site: str) -> None:
        """Poll ``site``: sleep for stall and straggler events, raise for
        error and preemption events.  The raise comes before the
        dispatch launches anything, so the carry and the cache are
        intact and a retry runs the same launches on the same inputs."""
        for ev in self.plan.poll(site):
            self._record(ev)
            if ev.kind in (STRAGGLER, LOADER_STALL):
                self._sleep(ev.value)
            elif ev.kind == DISPATCH_ERROR:
                raise DispatchFailure(ev)
            elif ev.kind in (PREEMPTION, ENGINE_CRASH):
                raise HostPreemption(ev)
            # nan_meters / page_pressure at a dispatch site are inert:
            # they belong to corrupt_meters / at_boundary

    def corrupt_meters(self, site: str, metrics: Dict[str, float]
                       ) -> Dict[str, float]:
        """Poll ``site`` and, for a ``nan_meters`` event, poison the
        host-fetched meters: the first (by name) NaN, the rest Inf, as a
        blown-up loss would read.  It fires after the window ran: the
        carry may be fine, and the sentry must not care."""
        for ev in self.plan.poll(site):
            self._record(ev)
            if ev.kind == NAN_METERS:
                for i, name in enumerate(sorted(metrics)):
                    metrics[name] = float("nan") if i == 0 \
                        else float("inf")
        return metrics

    def at_boundary(self, engine) -> None:
        """The serve boundary hook (``serve/boundary``): release the last
        boundary's pressure reservation, then apply this boundary's
        events.  ``page_pressure`` reserves pages from the live pool
        (admission and the write-horizon planning then see a dry pool:
        backpressure and preemption run), crash kinds raise."""
        for pool, pages in self._reserved:
            pool.unreserve(pages)
        self._reserved.clear()
        for ev in self.plan.poll("serve/boundary"):
            self._record(ev)
            if ev.kind == PAGE_PRESSURE:
                pool = getattr(engine, "pool", None)
                if pool is not None:
                    n = int(ev.value) if ev.value else pool.n_free
                    self._reserved.append((pool, pool.reserve(n)))
            elif ev.kind in (PREEMPTION, ENGINE_CRASH):
                raise HostPreemption(ev)
            elif ev.kind == DISPATCH_ERROR:
                raise DispatchFailure(ev)
            elif ev.kind in (STRAGGLER, LOADER_STALL):
                self._sleep(ev.value)

    def release_pressure(self) -> None:
        """Drop every outstanding page reservation (end of a run, or the
        pool died with its engine)."""
        for pool, pages in self._reserved:
            pool.unreserve(pages)
        self._reserved.clear()
