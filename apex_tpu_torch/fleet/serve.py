"""The serving fleet: a health-checked router over per-host engines.

Counterpart of ``apex_tpu/fleet/serve.py``, with its names, states,
routing decisions, counters, trace instants and flight-recorder events.
A process heals itself inside (:mod:`apex_tpu_torch.resilience`); a
fleet of hosts fails in ways a process never sees from the inside: a
host dies whole, wedges, loses heartbeats, comes back and must be
trusted again.  Two pieces:

- :class:`FleetHost`: one simulated host, a per-host
  :class:`~apex_tpu_torch.resilience.ResilientServeEngine` with its own
  obs registry and tracer (spans stamped with the host id at export) and
  its health surface (heartbeats, stall and drop counts, preflight
  report).  Every fleet behaviour runs on deterministic state, never the
  wall clock, so seeded chaos replays byte for byte.
- :class:`FleetRouter`: routing and the health control loop.  Each
  round polls the host-scoped faults (``host_loss``, ``host_stall``,
  ``heartbeat_drop``, ``restart`` at ``host_site(h)``), beats every
  admitted host (``heartbeat_misses`` misses in a row evict it),
  resubmits a lost or evicted host's in-flight requests to survivors as
  prompt + generated (the same tokens under greedy decoding, and the
  survivors build nothing), drives every serving host one boundary,
  harvests the token streams and scans for stragglers (a host's
  ``fleet.decode_window_ms`` p99 against the fleet's lower median).  A
  restarted host is readmitted only after a passing
  :func:`~apex_tpu_torch.fleet.preflight.run_preflight`; every host down
  with work outstanding raises :class:`FleetUnavailable` at once.

The router owns the durable request records (uid, prompt, tokens so
far), which is what makes host loss survivable.  Hosts of one process
share a decoder by default: one copy of the weights serves every host,
each with its own page pool.

On top: prefix-affinity routing over a consistent-hash ring (the longest
page-aligned prompt prefix routed before, load-guarded by
``affinity_gap``, with proactive prefix-page rebalancing as an option);
prefill/decode roles over the serialized KV handoff
(:mod:`apex_tpu_torch.serve.handoff`), whole or streamed chunk by chunk
while prefill runs, falling back to recompute on a corrupt handoff or a
source lost mid-transfer; SLO-driven autoscaling from ``standby`` hosts
(an :class:`~apex_tpu_torch.obs.SloTracker` on the router's clock is
the burn signal; calm rounds drain the newest scale-up); and
:meth:`FleetRouter.roll_host`, which drains one host, runs a callback
and readmits it on its own engine.

Where JAX reads an ``APEX_TPU_FLEET_*`` environment variable the port
takes an argument with JAX's default and reads no environment.  JAX's
live aggregation (``aggregator=``, ``scrape_every=``, ``scrape_stream=``)
serves ``apex_tpu/obs/aggregate.py``, which the port does not have yet:
passing an aggregator raises ``TypeError``.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from apex_tpu_torch import obs
from apex_tpu_torch.resilience.faults import (
    HEARTBEAT_DROP,
    HOST_LOSS,
    HOST_STALL,
    RESTART,
    FaultInjector,
    FaultPlan,
    host_site,
)

__all__ = ["FleetHost", "FleetRouter", "FleetUnavailable", "HOST_ROLES"]

_MS = 1e-6  # ns -> ms

# host lifecycle states
NEW = "new"
ADMITTED = "admitted"
EVICTED = "evicted"      # failed health checks; engine may still exist
LOST = "lost"            # host process died; engine state is gone
DRAINING = "draining"    # autoscale drain: serving actives, no new traffic
DRAINED = "drained"      # drain complete: engine released, standby again

# disaggregation roles
HOST_ROLES = ("mixed", "prefill", "decode")


def _role_capable(role: str, kind: str) -> bool:
    """Whether a host of ``role`` takes ``kind`` work (``"prefill"`` =
    fresh admissions, ``"decode"`` = handoff adoptions + decode)."""
    return role == "mixed" or role == kind


def _stable_hash(obj) -> int:
    """FNV-1a over ``repr`` bytes: deterministic across processes and
    runs (Python's builtin ``hash`` is salted)."""
    h = 0xCBF29CE484222325
    for b in repr(obj).encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class _Ring:
    """Incrementally maintained consistent-hash ring: a membership change
    insorts or deletes exactly ``vnodes`` points and a lookup is one
    bisect.  The point list always equals a rebuild over the same ids,
    so routing is that of a rebuild."""

    def __init__(self, vnodes: int = 8):
        self.vnodes = int(vnodes)
        self._pts: List[Tuple[int, int]] = []
        self._ids: Set[int] = set()

    @classmethod
    def from_ids(cls, ids, vnodes: int = 8) -> "_Ring":
        r = cls(vnodes)
        for hid in ids:
            r.add(hid)
        return r

    def points(self) -> List[Tuple[int, int]]:
        return list(self._pts)

    def add(self, hid: int) -> None:
        if hid in self._ids:
            return
        self._ids.add(hid)
        for v in range(self.vnodes):
            bisect.insort(self._pts,
                          (_stable_hash(("vnode", hid, v)), hid))

    def remove(self, hid: int) -> None:
        if hid not in self._ids:
            return
        self._ids.discard(hid)
        for v in range(self.vnodes):
            pt = (_stable_hash(("vnode", hid, v)), hid)
            i = bisect.bisect_left(self._pts, pt)
            if i < len(self._pts) and self._pts[i] == pt:
                del self._pts[i]

    def lookup(self, key) -> Optional[int]:
        """First point at or after the key's hash (wrapping), or None on
        an empty ring."""
        if not self._pts:
            return None
        i = bisect.bisect_left(self._pts, (_stable_hash(key), -1))
        if i >= len(self._pts):
            i = 0
        return self._pts[i][1]


class FleetUnavailable(RuntimeError):
    """Every host is unhealthy with work outstanding: the fleet-level
    failure, raised at once instead of hanging."""


@dataclasses.dataclass
class _FleetRecord:
    """The router's durable view of one request: everything host-loss
    recovery needs, owned outside any host."""

    uid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: Optional[float]
    top_k: int
    top_p: float
    min_p: float
    priority: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    host_id: Optional[int] = None
    inner_uid: Optional[int] = None
    done: bool = False
    # the router-minted correlation id, stamped on every milestone
    # instant, engine submit, handoff and recorder event of the request
    corr: str = ""
    # a completed handoff set this: the next fresh harvest is the decode
    # host's first token
    await_decode_first: bool = False
    # tokens of the current host assignment already absorbed into
    # ``tokens`` (the inner stream is relative to the resubmitted prompt
    # + generated context, so this resets on every reassignment)
    streamed: int = 0
    # fleet-level TTFT accounting (the autoscaler's burn signal)
    t_submit: int = 0
    ttft_seen: bool = False

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)


class FleetHost:
    """One per-host serve replica plus its health surface.

    Args:
      host_id: integer id (also the fault-site key via
        :func:`~apex_tpu_torch.resilience.host_site`).
      decoder: the :class:`~apex_tpu_torch.serve.GPTDecoder`.  Hosts of
        one process normally share it: one copy of the weights, and
        failover replays build nothing on the survivors.
      registry / tracer: per-host obs destinations (fresh by default:
        two hosts never mix counters; ``export_trace`` stamps the host
        id so merged reports stay attributable).
      role: ``"mixed"`` (default), ``"prefill"`` (chunked prefill only:
        the engine is built with ``prefill_only=True`` and finished
        prefills park until the router hands their pages off) or
        ``"decode"`` (takes handoff adoptions and decodes; routing
        sends it no fresh admission, but the recompute fallback may
        prefill on it when every prefill host is down).
      **engine_kwargs: forwarded to the host's
        :class:`~apex_tpu_torch.resilience.ResilientServeEngine` (slots,
        max_len, paged, page_len, prefill_chunk, eos_id, clock, ...).
    """

    def __init__(self, host_id: int, decoder, *, registry=None,
                 tracer=None, role: str = "mixed", **engine_kwargs):
        if role not in HOST_ROLES:
            raise ValueError(f"host role {role!r} not in {HOST_ROLES}")
        self.host_id = int(host_id)
        self.role = role
        self.decoder = decoder
        self.registry = (obs.MetricsRegistry() if registry is None
                         else registry)
        self.tracer = obs.Tracer() if tracer is None else tracer
        self._engine_kwargs = dict(engine_kwargs)
        self.engine = None
        self.state = NEW
        self.preflight: Optional[Any] = None
        # deterministic health state (counts, never wall time)
        self.beats = 0
        self.misses = 0
        self._stall_beats = 0   # heartbeats this host will still miss
        self._drop_beats = 0    # heartbeats lost in transit (host fine)
        # the router's hook: any event that can make the next heartbeat
        # miss flags this host a suspect, so the router's scan visits
        # only hosts with something to report
        self._suspect_cb = None
        self._h_decode = self.registry.histogram("fleet.decode_window_ms")
        # lifecycle summaries of gracefully released engine generations
        # (drain, preflighted restart); a killed host loses its counts
        # as a real process death would
        self._lc_stash: List[Dict[str, Any]] = []
        self._clock = time.perf_counter_ns

    def __repr__(self) -> str:
        return f"FleetHost({self.host_id}, {self.state}, {self.role})"

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        """(Re)build the host's engine: a restarted host starts with a
        fresh engine and no requests in flight, like a reboot."""
        from apex_tpu_torch.resilience.serve import ResilientServeEngine

        kwargs = dict(self._engine_kwargs)
        if self.role == "prefill":
            kwargs.setdefault("prefill_only", True)
        if self.engine is not None:  # graceful rebuild: keep the counts
            self._lc_stash.append(self.engine.lifecycle_summary())
        self.engine = ResilientServeEngine(
            self.decoder, registry=self.registry, tracer=self.tracer,
            **kwargs,
        )
        self.misses = 0
        self._stall_beats = 0
        self._drop_beats = 0

    def kill(self) -> None:
        """Simulated host loss: the engine, its records and its page
        pool are gone."""
        self.engine = None
        self.state = LOST
        if self._suspect_cb is not None:
            self._suspect_cb(self.host_id)

    def stall(self, beats: int) -> None:
        """Wedge the host for ``beats`` heartbeats (a deterministic count:
        the replayable stand-in for a hung process)."""
        self._stall_beats += max(1, int(beats))
        if self._suspect_cb is not None:
            self._suspect_cb(self.host_id)

    def drop_heartbeat(self) -> None:
        """Lose one heartbeat in transit; the host itself is fine (the
        flapping host's ingredient)."""
        self._drop_beats += 1
        if self._suspect_cb is not None:
            self._suspect_cb(self.host_id)

    # -- health ----------------------------------------------------------

    def heartbeat(self) -> bool:
        """One health-check round trip; False = missed.  A dead host
        never answers, a stalled or dropped host misses its scheduled
        count."""
        self.beats += 1
        if self.engine is None or self.state == LOST:
            return False
        if self._stall_beats > 0:
            self._stall_beats -= 1
            return False
        if self._drop_beats > 0:
            self._drop_beats -= 1
            return False
        return True

    @property
    def alive(self) -> bool:
        return self.engine is not None and self.state != LOST

    # -- work ------------------------------------------------------------

    def step(self) -> bool:
        """Drive one engine boundary; its wall time lands in the host's
        ``fleet.decode_window_ms`` histogram (the straggler signal)."""
        t0 = self._clock()
        more = self.engine.step()
        self._h_decode.observe((self._clock() - t0) * _MS)
        return more

    def progress(self) -> Dict[int, Tuple[List[int], bool]]:
        return self.engine.progress()

    def outstanding(self) -> int:
        if self.engine is None:
            return 0
        return sum(1 for _, (t, done) in self.engine.progress().items()
                   if not done)

    def release_engine(self) -> None:
        """Drop the engine gracefully (autoscale drain): its pages and
        device tensors go, its goodput and abandonment ledger stays."""
        if self.engine is not None:
            self._lc_stash.append(self.engine.lifecycle_summary())
        self.engine = None

    def swap_weights(self, bundle):
        """Serve ``bundle`` on this host (the engine's
        :meth:`~apex_tpu_torch.serve.ServeEngine.swap_weights`) and keep
        the swapped decoder as the host's build template: a later
        ``start()`` boots on the new weights.  The engine survives, so
        this is safe mid-traffic."""
        if self.engine is None:
            raise RuntimeError(
                f"host {self.host_id} has no engine to swap weights on"
            )
        summary = self.engine.swap_weights(bundle)
        self.decoder = self.engine.decoder
        return summary

    @property
    def weights_digest(self) -> Optional[str]:
        """Digest of the weights this host serves (None while it has no
        engine: lost or drained)."""
        if self.engine is None:
            return None
        return self.engine.weights_digest

    def lifecycle_summary(self) -> Dict[str, Any]:
        """Goodput and abandonment summed over every gracefully released
        engine generation and the live one: what the load harness reads,
        so a drained host's completed requests still count."""
        sums = list(self._lc_stash)
        if self.engine is not None:
            sums.append(self.engine.lifecycle_summary())
        keys = ("completed", "abandoned", "completed_tokens",
                "abandoned_tokens")
        out: Dict[str, Any] = {
            k: sum(s.get(k, 0) for s in sums) for k in keys
        }
        wall = max((s.get("wall_ms", 0.0) for s in sums), default=0.0)
        retired = out["completed"] + out["abandoned"]
        out["wall_ms"] = wall
        out["abandonment_rate"] = (
            round(out["abandoned"] / retired, 4) if retired else 0.0
        )
        out["goodput_tokens_per_s"] = (
            round(out["completed_tokens"] / (wall * 1e-3), 2)
            if wall > 0 else 0.0
        )
        return out

    def decode_p99(self) -> Optional[float]:
        """This host's decode-window p99 (ms), None before any sample."""
        snap = self._h_decode.snapshot()
        if not snap.get("count"):
            return None
        return float(snap["p99"])

    # -- exports ---------------------------------------------------------

    def export_trace(self, path: str) -> str:
        """Write this host's ``trace.jsonl`` with the host id stamped on
        every span and in the meta header; a live SLO tracker's report
        rides along as the ``{"type": "slo"}`` line."""
        from apex_tpu_torch.obs.export import write_jsonl

        for sp in self.tracer.spans:
            sp.set("host", self.host_id)
        slo = self.engine.slo_report() if self.engine is not None else None
        return write_jsonl(self.tracer, path, registry=self.registry,
                           extra_meta={"host": self.host_id,
                                       "role": self.role},
                           slo_report=slo)

    def export_openmetrics(self, path: str) -> str:
        """Write this host's registry as OpenMetrics text with ``host``
        and ``role`` stamped as labels on every series."""
        from apex_tpu_torch.obs.export import write_openmetrics

        slo = self.engine.slo_report() if self.engine is not None else None
        return write_openmetrics(
            path, self.registry, slo_report=slo,
            labels={"host": str(self.host_id), "role": self.role},
        )


class FleetRouter:
    """Deterministic health-checked router over N :class:`FleetHost`\\ s.

    Args:
      hosts: the fleet; hosts in state ``new`` are preflighted and
        admitted on construction.
      heartbeat_misses: consecutive missed heartbeats before eviction
        (at least 1).
      straggler_factor: the p99-over-fleet-median multiple that flags a
        straggler.
      fault_plan / injector: deterministic host-scoped chaos, polled at
        ``host_site(h)`` once per round.
      preflight: the admission gate: True runs
        :func:`~apex_tpu_torch.fleet.preflight.run_preflight` on the
        host's decoder at its engine geometry; a callable ``(host) ->
        PreflightReport`` is a custom gate; False admits every host.
      registry / tracer: fleet-level obs destinations (routing,
        evictions, recoveries; None: the ambient ones); per-host
        telemetry lives on each host.
      flightrec: the fleet's recorder (None: the ambient one).  Routing,
        handoff, eviction, loss, recovery, (re)admission and scaling
        decisions are recorded; a host loss dumps the postmortem.
      affinity / affinity_gap: prefix-affinity routing, and the most
        outstanding requests the affine host may run ahead of the
        least-loaded one.
      standby: hosts registered but not admitted: the autoscaler's pool.
      autoscale / autoscale_tracker: SLO-driven spin-up and drain, and
        the :class:`~apex_tpu_torch.obs.SloTracker` whose ``ttft_ms``
        burn drives it (None with autoscale on: p90 < 100 ms over 1 s on
        the router's clock).  The router feeds it every request's
        fleet-level TTFT.
      scale_cooldown_rounds / drain_after_rounds: rounds between
        spin-ups, and calm rounds before the newest scale-up drains.
      clock: ns clock of the fleet's timestamps (TTFT, recovery); the
        load harness passes its virtual clock.
      corr_prefix: prefix of the correlation ids minted at submit
        (``"c"`` -> ``c00000000``, ...).
      straggler_every: rounds between straggler scans.
      rebalance / rebalance_every / rebalance_min_heat / rebalance_gap:
        proactive shipping of the hottest shared prefix's pages to an
        under-loaded host (off by default).
      stream_handoff: ship finished prefill pages chunk by chunk while
        prefill runs, so only the tail crosses the blocking hop.
      aggregator: JAX's live aggregation (``apex_tpu/obs/aggregate.py``),
        not ported: an aggregator raises ``TypeError`` (and JAX's
        ``scrape_every``/``scrape_stream``, which only pace it, are not
        taken).
    """

    def __init__(
        self,
        hosts: Sequence[FleetHost],
        *,
        heartbeat_misses: int = 2,
        straggler_factor: float = 3.0,
        fault_plan: Optional[FaultPlan] = None,
        injector: Optional[FaultInjector] = None,
        preflight: Any = True,
        registry=None,
        tracer=None,
        flightrec=None,
        affinity: bool = True,
        affinity_gap: int = 2,
        standby: Sequence[FleetHost] = (),
        autoscale: bool = False,
        autoscale_tracker=None,
        scale_cooldown_rounds: int = 4,
        drain_after_rounds: int = 16,
        clock=None,
        corr_prefix: str = "c",
        aggregator=None,
        straggler_every: int = 1,
        rebalance: bool = False,
        rebalance_every: int = 8,
        rebalance_min_heat: int = 3,
        rebalance_gap: Optional[int] = None,
        stream_handoff: bool = False,
    ):
        if aggregator is not None:
            raise TypeError(
                f"{type(aggregator).__name__}: live fleet aggregation "
                "(aggregator=) waits for the port of "
                "apex_tpu/obs/aggregate.py")
        if not hosts:
            raise ValueError("a fleet needs at least one host")
        ids = [h.host_id for h in list(hosts) + list(standby)]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids: {ids}")
        self.hosts: Dict[int, FleetHost] = {
            h.host_id: h for h in list(hosts) + list(standby)
        }
        self.heartbeat_misses = max(1, int(heartbeat_misses))
        self.straggler_factor = float(straggler_factor)
        self.registry = (obs.default_registry() if registry is None
                         else registry)
        self.tracer = obs.default_tracer() if tracer is None else tracer
        self._fr = obs.default_flightrec() if flightrec is None \
            else flightrec
        if injector is None and fault_plan is not None:
            injector = FaultInjector(fault_plan, registry=self.registry,
                                     tracer=self.tracer,
                                     flightrec=self._fr)
        self.injector = injector
        self._preflight = preflight
        self._records: Dict[int, _FleetRecord] = {}
        self._next_uid = 0
        self.rounds = 0
        self.stragglers: set = set()
        self._clock = (time.perf_counter_ns if clock is None else clock)
        # -- prefix-affinity routing ------------------------------------
        self.affinity = bool(affinity)
        self.affinity_gap = max(0, int(affinity_gap))
        self._affinity_vnodes = 8
        first = next(iter(self.hosts.values()))
        kw = first._engine_kwargs
        from apex_tpu_torch.serve.kv_cache import auto_page_len

        self._affinity_pl = int(
            kw.get("page_len")
            or auto_page_len(int(kw.get("max_len",
                                        first.decoder.cfg.max_position)))
        )
        self._seen_prefixes: Set[Tuple[int, ...]] = set()
        self._attr: Dict[int, Dict[str, Any]] = {}
        # -- disaggregation ---------------------------------------------
        self._has_roles = any(h.role != "mixed"
                              for h in self.hosts.values())
        self._pending_handoff: Set[int] = set()
        # -- O(log H) hot paths -----------------------------------------
        # the router-side outstanding count per host (what
        # ``FleetHost.outstanding()`` would walk the records for)
        self._load: Dict[int, int] = {}
        # hid -> {uid: record}: harvest and handoff marking walk only a
        # host's own records
        self._assigned: Dict[int, Dict[int, _FleetRecord]] = {}
        self._unassigned: Set[int] = set()
        self._open = 0  # records not yet done
        # admitted membership per work kind + lazy-deletion min-heaps of
        # (load, hid): the least-loaded pick is O(log H)
        self._pools: Dict[str, Set[int]] = {
            "any": set(), "prefill": set(), "decode": set(),
        }
        self._heaps: Dict[str, List[Tuple[int, int]]] = {
            "any": [], "prefill": [], "decode": [],
        }
        self._rings: Dict[str, _Ring] = {
            "any": _Ring(self._affinity_vnodes),
            "prefill": _Ring(self._affinity_vnodes),
        }
        # heartbeat suspects + lazy beat credit: only hosts with a
        # pending stall, drop, miss or death are visited by the scan; a
        # healthy host's beats are implied one a round
        self._suspects: Set[int] = set()
        self._hb_synced: Dict[int, int] = {}
        for h in self.hosts.values():
            h._suspect_cb = self._mark_suspect
        self._draining: Set[int] = set()
        self._fault_hosts: List[FleetHost] = []
        self._fault_hosts_for: Any = None
        self.straggler_every = max(1, int(straggler_every))
        # -- proactive page rebalancing + streamed handoff --------------
        self.rebalance = bool(rebalance)
        self.rebalance_every = max(1, int(rebalance_every))
        self.rebalance_min_heat = max(1, int(rebalance_min_heat))
        # the migration trigger sits below the affinity gap: _pick itself
        # spills once the owner is gap ahead
        self.rebalance_gap = (max(1, self.affinity_gap // 2)
                              if rebalance_gap is None
                              else max(1, int(rebalance_gap)))
        self.stream_handoff = bool(stream_handoff)
        self._heat: Dict[Tuple[int, ...], int] = {}
        self._prefix_override: Dict[Tuple[int, ...], int] = {}
        self._anchors: Dict[Tuple[int, ...], Tuple[int, Any]] = {}
        self._streams: Dict[int, Dict[str, Any]] = {}
        self._stream_wire_bytes = 0   # bytes on the blocking tail hop
        self._stream_total_bytes = 0  # bytes shipped overall
        # -- autoscaling ------------------------------------------------
        self.autoscale = bool(autoscale)
        self._standby_ids = [h.host_id for h in standby]
        self.scale_cooldown_rounds = int(scale_cooldown_rounds)
        self.drain_after_rounds = int(drain_after_rounds)
        self._scaled_up: List[int] = []
        self._cooldown = 0
        self._calm_rounds = 0
        if autoscale_tracker is None and self.autoscale:
            autoscale_tracker = obs.SloTracker(
                [obs.SloObjective("ttft_ms", 0.9, 100.0, 1_000.0)],
                clock=self._clock,
            )
        self._slo = autoscale_tracker
        self._corr_prefix = str(corr_prefix)
        m = self.registry
        self._c_evictions = m.counter("fleet.evictions")
        self._c_losses = m.counter("fleet.host_losses")
        self._c_readmits = m.counter("fleet.readmissions")
        self._c_pf_fail = m.counter("fleet.preflight_failures")
        self._c_moved = m.counter("fleet.requests_recovered")
        self._c_straggler = m.counter("fleet.straggler_flags")
        self._h_recovery = m.histogram("fleet.recovery_ms")
        self._c_routed = m.counter("fleet.requests_routed")
        self._c_aff_hits = m.counter("fleet.affinity_hits")
        self._c_aff_fallbacks = m.counter("fleet.affinity_fallbacks")
        self._c_handoffs = m.counter("fleet.handoffs")
        self._c_handoff_fb = m.counter("fleet.handoff_fallbacks")
        self._c_scale_ups = m.counter("fleet.scale_ups")
        self._c_drains = m.counter("fleet.drains")
        self._c_boundaries = m.counter("fleet.host_boundaries")
        self._c_rebalances = m.counter("fleet.rebalances")
        self._c_chunks = m.counter("fleet.handoff_chunks")
        self._c_chunk_aborts = m.counter("fleet.handoff_chunk_aborts")
        self._c_rolls = m.counter("fleet.rolls")
        for h in hosts:
            if h.state == NEW:
                self.admit(h.host_id)

    # -- admission -------------------------------------------------------

    def _run_preflight(self, host: FleetHost):
        from apex_tpu_torch.fleet.preflight import run_preflight

        if self._preflight is False:
            return None
        if callable(self._preflight) and self._preflight is not True:
            return self._preflight(host)
        kw = host._engine_kwargs
        return run_preflight(
            host.decoder, host_id=host.host_id,
            slots=kw.get("slots", 2), max_len=kw.get("max_len", 64),
            page_len=kw.get("page_len", 8), paged=kw.get("paged", True),
        )

    def admit(self, host_id: int) -> bool:
        """Preflight-gate and admit one host (fresh engine).  Returns
        False, and the host stays out, when preflight fails."""
        host = self.hosts[host_id]
        report = self._run_preflight(host)
        host.preflight = report
        if report is not None and not report.passed:
            self._c_pf_fail.inc()
            self.tracer.instant("fleet/preflight_fail", host=host_id,
                                checks=[c.name for c in
                                        report.failures()])
            return False
        host.start()
        host.state = ADMITTED
        self._pool_join(host)
        self._suspects.discard(host_id)
        self._hb_synced[host_id] = self.rounds
        self._draining.discard(host_id)
        if self.rounds:
            self._c_readmits.inc()
        self.tracer.instant("fleet/admit", host=host_id)
        if self._fr.enabled:
            self._fr.record("fleet/admit", host=host_id,
                            readmit=bool(self.rounds))
        return True

    def admitted(self) -> List[FleetHost]:
        return [h for h in self.hosts.values() if h.state == ADMITTED]

    def serving(self) -> List[FleetHost]:
        """Hosts still doing work: admitted, plus draining hosts that
        finish their actives (no new traffic routes to those)."""
        return [h for h in self.hosts.values()
                if h.state in (ADMITTED, DRAINING)]

    # -- incremental routing state ---------------------------------------

    def _pool_join(self, host: FleetHost) -> None:
        """Admit ``host`` into the routing structures: ring insorts and
        heap pushes, never a rebuild."""
        hid = host.host_id
        self._load[hid] = 0
        self._assigned.setdefault(hid, {})
        self._pools["any"].add(hid)
        self._rings["any"].add(hid)
        heapq.heappush(self._heaps["any"], (0, hid))
        for kind in ("prefill", "decode"):
            if _role_capable(host.role, kind):
                self._pools[kind].add(hid)
                heapq.heappush(self._heaps[kind], (0, hid))
        if _role_capable(host.role, "prefill"):
            self._rings["prefill"].add(hid)

    def _pool_leave(self, host: FleetHost) -> None:
        """Remove ``host`` from routing (evict, loss, drain).  Heap
        entries go stale and are dropped on sight; prefix overrides and
        anchors aimed at the host are dropped."""
        hid = host.host_id
        for kind in ("any", "prefill", "decode"):
            self._pools[kind].discard(hid)
        self._rings["any"].remove(hid)
        self._rings["prefill"].remove(hid)
        if self._prefix_override:
            for k in [k for k, v in self._prefix_override.items()
                      if v == hid]:
                del self._prefix_override[k]
        if self._anchors:
            # the anchored pages leave with the host: release them if the
            # engine is still alive (drain, evict), forget them otherwise
            for k in [k for k, (h, _a) in self._anchors.items()
                      if h == hid]:
                _h, anchor = self._anchors.pop(k)
                if host.engine is not None:
                    host.engine.release_prefix(anchor)

    def _load_add(self, hid: int, delta: int) -> None:
        v = self._load.get(hid, 0) + delta
        self._load[hid] = v
        for kind in ("any", "prefill", "decode"):
            if hid in self._pools[kind]:
                heapq.heappush(self._heaps[kind], (v, hid))

    def _heap_least(self, use: str,
                    exclude_id: Optional[int] = None) -> Optional[int]:
        """Least-loaded host id in pool ``use``, ties broken on host id
        (``min(pool, key=(outstanding, host_id))``).  Entries whose load
        or membership went stale are popped on sight."""
        heap = self._heaps[use]
        pool = self._pools[use]
        excluded = []
        best = None
        while heap:
            load, hid = heap[0]
            if hid not in pool or self._load.get(hid, 0) != load:
                heapq.heappop(heap)
                continue
            if exclude_id is not None and hid == exclude_id:
                excluded.append(heapq.heappop(heap))
                continue
            best = hid
            break
        for e in excluded:
            heapq.heappush(heap, e)
        return best

    def _mark_suspect(self, host_id: int) -> None:
        """Host-side health hook: a stall, drop or kill flags the host,
        so the scan visits suspects only."""
        self._suspects.add(host_id)

    def _sync_beats(self, host: FleetHost, upto: int) -> None:
        """Credit a host's implied heartbeats up to round ``upto``."""
        synced = self._hb_synced.get(host.host_id)
        if synced is None:
            return
        if upto > synced:
            host.beats += upto - synced
            self._hb_synced[host.host_id] = upto

    def _state_summary(self, max_ids: int = 4) -> str:
        """Bounded diagnosis for :class:`FleetUnavailable`: counts by
        state and the first few hosts."""
        counts: Dict[str, int] = {}
        for h in self.hosts.values():
            counts[h.state] = counts.get(h.state, 0) + 1
        by = ", ".join(f"{s}={n}" for s, n in sorted(counts.items()))
        ids = list(self.hosts)[:max_ids]
        head = ", ".join(f"{hid}={self.hosts[hid].state}" for hid in ids)
        tail = (f", +{len(self.hosts) - max_ids} more"
                if len(self.hosts) > max_ids else "")
        return f"(states: {by}; {head}{tail})"

    # -- intake ----------------------------------------------------------

    def _affinity_key(self, prompt: List[int]) -> Tuple[int, ...]:
        """The longest previously routed page-aligned prefix of
        ``prompt`` (else its own first page): the value the ring
        places."""
        pl = self._affinity_pl
        n = (len(prompt) // pl) * pl
        for end in range(n, 0, -pl):
            key = tuple(prompt[:end])
            if key in self._seen_prefixes:
                return key
        return tuple(prompt[:min(pl, len(prompt))])

    def _register_prefixes(self, prompt: List[int]) -> None:
        pl = self._affinity_pl
        for end in range(pl, len(prompt) + 1, pl):
            self._seen_prefixes.add(tuple(prompt[:end]))

    def _pick(self, rec: Optional[_FleetRecord] = None,
              kind: str = "prefill",
              exclude: Optional[FleetHost] = None
              ) -> Tuple[FleetHost, str]:
        """Choose a host for ``kind`` work: role-capable hosts first
        (any admitted host when none is), then prefix affinity under the
        load guard, else the least-loaded.  Returns ``(host, reason)``;
        raises :class:`FleetUnavailable` with no admitted host."""
        if not self._pools["any"]:
            raise FleetUnavailable(
                "no admitted hosts to route to " + self._state_summary()
            )
        use = kind if (self._has_roles and self._pools[kind]) else "any"
        pool = self._pools[use]
        ex_id = exclude.host_id if exclude is not None else None
        if ex_id is not None and (len(pool) <= 1 or ex_id not in pool):
            ex_id = None
        least_id = self._heap_least(use, exclude_id=ex_id)
        least = self.hosts[least_id]
        if self.affinity and rec is not None and kind == "prefill":
            key = self._affinity_key(rec.prompt)
            affine_id = None
            if self.rebalance:
                # a migrated prefix routes to the host that now holds
                # its pages (load-guarded below)
                oid = self._prefix_override.get(key)
                if oid is not None and oid in pool and oid != ex_id:
                    affine_id = oid
            if affine_id is None:
                if ex_id is not None:
                    # an ad-hoc pool (the router never asks affinity to
                    # exclude a host): a ring over it
                    affine_id = _Ring.from_ids(
                        sorted(pool - {ex_id}),
                        self._affinity_vnodes).lookup(key)
                else:
                    ring = self._rings[
                        "prefill" if use == "prefill" else "any"
                    ]
                    affine_id = ring.lookup(key)
                if affine_id is None or affine_id not in pool:
                    affine_id = least_id
            if self._load.get(affine_id, 0) \
                    - self._load.get(least_id, 0) <= self.affinity_gap:
                return self.hosts[affine_id], "affine"
            return least, "affine_hot"
        return least, "least_loaded"

    def submit(
        self, prompt: Sequence[int], max_new_tokens: int = 64,
        temperature: Optional[float] = None, top_k: int = 0,
        top_p: float = 1.0, min_p: float = 0.0, priority: int = 0,
    ) -> int:
        """Route a request to a healthy host; returns the fleet uid
        (stable across host deaths).  ``priority`` rides into the host
        engine's SLO-aware admission and survives reassignment."""
        uid = self._next_uid
        self._next_uid += 1
        rec = _FleetRecord(
            uid=uid, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens), temperature=temperature,
            top_k=int(top_k), top_p=float(top_p), min_p=float(min_p),
            priority=int(priority), t_submit=self._clock(),
            corr=f"{self._corr_prefix}{uid:08d}",
        )
        self._records[uid] = rec
        self._open += 1
        self._unassigned.add(uid)
        if self.rebalance and self.affinity:
            # prefix heat: the rebalancer's demand signal
            k = self._affinity_key(rec.prompt)
            self._heat[k] = self._heat.get(k, 0) + 1
        # the correlation flow's anchor milestone, on the router clock
        self.tracer.instant("fleet/submit", corr=rec.corr, uid=uid,
                            t=rec.t_submit)
        self._assign(rec, *self._pick(rec))
        if self.affinity:
            self._register_prefixes(rec.prompt)
        return uid

    def _host_attr(self, host_id: int) -> Dict[str, Any]:
        return self._attr.setdefault(host_id, {
            "requests": 0, "affinity_hits": 0, "fallbacks": {},
            "handoffs_in": 0, "handoffs_out": 0,
        })

    def _assign(self, rec: _FleetRecord, host: FleetHost,
                reason: str = "least_loaded") -> None:
        ctx = rec.prompt + rec.tokens
        if self._fr.enabled:
            self._fr.record("fleet/route", uid=rec.uid, corr=rec.corr,
                            host=host.host_id,
                            resumed=len(rec.tokens), reason=reason)
        self.tracer.instant("fleet/assign", corr=rec.corr, uid=rec.uid,
                            host=host.host_id, reason=reason,
                            resumed=len(rec.tokens), t=self._clock())
        a = self._host_attr(host.host_id)
        a["requests"] += 1
        self._c_routed.inc()
        if reason == "affine":
            a["affinity_hits"] += 1
            self._c_aff_hits.inc()
        elif self.affinity and reason != "least_loaded":
            a["fallbacks"][reason] = a["fallbacks"].get(reason, 0) + 1
            self._c_aff_fallbacks.inc()
        rec.host_id = host.host_id
        rec.streamed = 0
        self._unassigned.discard(rec.uid)
        self._assigned.setdefault(host.host_id, {})[rec.uid] = rec
        self._load_add(host.host_id, 1)
        rec.inner_uid = host.engine.submit(
            ctx, max_new_tokens=rec.remaining,
            temperature=rec.temperature, top_k=rec.top_k,
            top_p=rec.top_p, min_p=rec.min_p, priority=rec.priority,
            corr=rec.corr,
        )

    # -- health control loop ---------------------------------------------

    def _poll_faults(self) -> None:
        if self.injector is None:
            return
        if self._fault_hosts_for is not self.injector:
            # poll only the hosts whose site the plan ever fires on (a
            # site with events is polled every round to keep its index
            # aligned)
            plan = getattr(self.injector, "plan", None)
            by_key = getattr(plan, "_by_key", None)
            if by_key is None:
                self._fault_hosts = list(self.hosts.values())
            else:
                sites = {site for site, _ix in by_key}
                self._fault_hosts = [
                    h for h in self.hosts.values()
                    if host_site(h.host_id) in sites
                ]
            self._fault_hosts_for = self.injector
        for h in self._fault_hosts:
            for ev in self.injector.poll_site(host_site(h.host_id)):
                if ev.kind == HOST_LOSS:
                    self._lose(h)
                elif ev.kind == HOST_STALL:
                    h.stall(int(ev.value) or 1)
                elif ev.kind == HEARTBEAT_DROP:
                    h.drop_heartbeat()
                elif ev.kind == RESTART:
                    if h.state in (LOST, EVICTED):
                        self.admit(h.host_id)

    def _lose(self, host: FleetHost) -> None:
        """Host process death: nothing more is harvested from it;
        recovery runs from the router's records."""
        if host.state == LOST:
            return
        host.kill()
        self._sync_beats(host, self.rounds - 1)
        self._hb_synced.pop(host.host_id, None)
        self._pool_leave(host)
        self._draining.discard(host.host_id)
        self._c_losses.inc()
        self.tracer.instant("fleet/host_loss", host=host.host_id)
        if self._fr.enabled:
            self._fr.record("fleet/host_loss", host=host.host_id)
        # the fleet postmortem: what every host was doing when this one
        # died
        self._fr.dump(reason="host_loss",
                      extra_meta={"host": host.host_id})
        self._recover_from(host.host_id)

    def _evict(self, host: FleetHost) -> None:
        """Health-check eviction: the host may still run, but its traffic
        moves to survivors and it returns only through a passing
        preflight."""
        if host.state not in (ADMITTED, DRAINING):
            return
        host.state = EVICTED
        self._sync_beats(host, self.rounds - 1)
        self._hb_synced.pop(host.host_id, None)
        self._pool_leave(host)
        self._draining.discard(host.host_id)
        self._c_evictions.inc()
        self.tracer.instant("fleet/evict", host=host.host_id,
                            misses=host.misses)
        if self._fr.enabled:
            self._fr.record("fleet/evict", host=host.host_id,
                            misses=host.misses)
        self._recover_from(host.host_id)

    def _recover_from(self, host_id: int) -> None:
        """Resubmit the host's in-flight requests to survivors as prompt
        + generated: the same tokens under greedy decoding."""
        t0 = self._clock()
        moved = 0
        recs = self._assigned.pop(host_id, None) or {}
        self._load[host_id] = 0
        # chunk streams from or to the dead host die with it; pages
        # staged on a live peer are released
        if self._streams:
            for uid in [u for u, s in self._streams.items()
                        if s.get("dst_id") == host_id or u in recs]:
                self._stream_abort(uid)
        with self.tracer.span("fleet/recover", host=host_id):
            for uid in sorted(recs):
                rec = recs[uid]
                if rec.done:
                    continue
                rec.host_id = None
                rec.inner_uid = None
                self._unassigned.add(uid)
                if rec.remaining <= 0:
                    self._finish_record(rec, t0)
                    continue
                self._pending_handoff.discard(rec.uid)
                try:
                    self._assign(rec, *self._pick(rec))
                except FleetUnavailable:
                    # no survivor now: the records stay parked, and the
                    # next round finds a readmitted host or raises
                    for uid2 in sorted(recs):
                        r2 = recs[uid2]
                        if not r2.done and r2.host_id == host_id:
                            r2.host_id = None
                            r2.inner_uid = None
                            self._pending_handoff.discard(uid2)
                            self._unassigned.add(uid2)
                    break
                moved += 1
        if moved:
            self._c_moved.inc(moved)
            self._h_recovery.observe((self._clock() - t0) * _MS)
            if self._fr.enabled:
                self._fr.record("fleet/recover", host=host_id,
                                moved=moved)

    def _heartbeat_scan(self) -> None:
        """Heartbeat the suspects only; a healthy host's beat is implied
        and credited by :meth:`_sync_beats`.  Beats, misses, eviction
        timing and miss instants are those of a scan of every host."""
        if not self._suspects:
            return
        for hid in sorted(self._suspects):
            h = self.hosts.get(hid)
            if h is None or h.state not in (ADMITTED, DRAINING):
                self._suspects.discard(hid)
                continue
            self._sync_beats(h, self.rounds - 1)
            self._hb_synced[hid] = self.rounds
            if h.heartbeat():
                h.misses = 0
                if h._stall_beats == 0 and h._drop_beats == 0:
                    self._suspects.discard(hid)
            else:
                h.misses += 1
                self.tracer.instant("fleet/heartbeat_miss",
                                    host=h.host_id, misses=h.misses)
                if not h.alive:
                    self._lose(h)
                elif h.misses >= self.heartbeat_misses:
                    self._evict(h)

    def _park_unassigned(self) -> None:
        """Requests parked while no host was available land on the first
        healthy host that appears."""
        if not self._unassigned:
            return
        for uid in sorted(self._unassigned):
            rec = self._records[uid]
            if rec.done or rec.host_id is not None:
                self._unassigned.discard(uid)
                continue
            try:
                self._assign(rec, *self._pick(rec))
            except FleetUnavailable:
                return

    def _finish_record(self, rec: _FleetRecord, t: int) -> None:
        """Retire a record: the terminal correlation milestone."""
        if rec.done:
            return
        if rec.host_id is not None:
            recs = self._assigned.get(rec.host_id)
            if recs is not None and recs.pop(rec.uid, None) is not None:
                self._load_add(rec.host_id, -1)
        self._unassigned.discard(rec.uid)
        self._open -= 1
        rec.done = True
        rec.inner_uid = None
        self.tracer.instant("fleet/finished", corr=rec.corr,
                            uid=rec.uid, tokens=len(rec.tokens), t=t)

    def _harvest(self) -> None:
        """Pull each serving host's token streams into the durable
        records (host loss then loses at most one round of tokens).  A
        record's first token stamps its fleet-level TTFT into the
        autoscale tracker."""
        t = self._clock()
        for h in self.serving():
            recs = self._assigned.get(h.host_id)
            if not recs:
                continue
            prog = h.progress()
            for uid in sorted(recs):
                rec = recs.get(uid)
                if rec is None or rec.inner_uid is None:
                    continue
                stream, done = prog.get(rec.inner_uid, ([], False))
                # the engine was handed prompt + generated at assignment:
                # its stream holds only the tokens since
                fresh = stream[rec.streamed:]
                if fresh:
                    rec.tokens.extend(fresh)
                    rec.streamed += len(fresh)
                    if not rec.ttft_seen:
                        rec.ttft_seen = True
                        self.tracer.instant(
                            "fleet/first_token", corr=rec.corr,
                            uid=rec.uid, host=h.host_id, t=t,
                        )
                        if self._slo is not None:
                            self._slo.observe(
                                "ttft_ms",
                                (t - rec.t_submit) * _MS, t,
                            )
                    if rec.await_decode_first:
                        rec.await_decode_first = False
                        self.tracer.instant(
                            "fleet/decode_first_token", corr=rec.corr,
                            uid=rec.uid, host=h.host_id, t=t,
                        )
                if done:
                    self._finish_record(rec, t)

    # -- disaggregated prefill/decode handoff ----------------------------

    def _mark_prefill_done(self) -> None:
        """After harvest: a request on a prefill host whose first token
        arrived has finished prefilling; its handoff runs next round
        (the round between is the window a host fault can kill into)."""
        if not self._has_roles:
            return
        for hid, recs in self._assigned.items():
            host = self.hosts.get(hid)
            if host is None or host.role != "prefill" or not recs:
                continue
            for uid, rec in recs.items():
                if rec.done or uid in self._pending_handoff \
                        or rec.inner_uid is None or rec.streamed == 0:
                    continue
                self._pending_handoff.add(uid)

    def _handoff_fallback(self, rec: _FleetRecord, src: FleetHost,
                          dst: FleetHost, why: str) -> None:
        """A handoff could not land (corrupt bytes, no capacity): detach
        from the source and resubmit prompt + generated to the decode
        host, the same tokens under greedy decoding."""
        src.engine.detach(rec.inner_uid)
        srecs = self._assigned.get(src.host_id)
        if srecs is not None and srecs.pop(rec.uid, None) is not None:
            self._load_add(src.host_id, -1)
        self._stream_abort(rec.uid)
        self._host_attr(src.host_id)["handoffs_out"] += 1
        rec.host_id = None
        rec.inner_uid = None
        self._unassigned.add(rec.uid)
        self._c_handoff_fb.inc()
        self.tracer.instant("fleet/handoff_fallback", uid=rec.uid,
                            corr=rec.corr, src=src.host_id, why=why,
                            t=self._clock())
        if self._fr.enabled:
            self._fr.record("fleet/handoff_fallback", uid=rec.uid,
                            corr=rec.corr, src=src.host_id, why=why)
        self._assign(rec, dst, reason="handoff_recompute")
        # the recompute continuation decodes on ``dst``: its next fresh
        # token is still the decode side's first
        rec.await_decode_first = True

    def _do_handoffs(self) -> None:
        """Run the pending prefill -> decode handoffs: export the slot's
        pages, serialize (the wire hop), import on a decode-capable host
        and adopt, detach from the source.  A source lost meanwhile was
        already recovered by the loss path; an import that cannot land
        falls back to recompute."""
        if not self._pending_handoff:
            return
        from apex_tpu_torch.serve.handoff import HandoffError, KVHandoff

        for uid in sorted(self._pending_handoff):
            rec = self._records[uid]
            if rec.done or rec.host_id is None or rec.inner_uid is None:
                # lost or recovered while pending: nothing to move
                self._pending_handoff.discard(uid)
                continue
            src = self.hosts.get(rec.host_id)
            if src is None or src.state not in (ADMITTED, DRAINING) \
                    or src.role != "prefill":
                self._pending_handoff.discard(uid)
                self._stream_abort(uid)
                continue
            # a streamed handoff: the chunks are already staged on the
            # decode host, only the tail rides the blocking hop
            stream = self._streams.get(uid) if self.stream_handoff \
                else None
            if stream is not None and not stream.get("failed"):
                sdst = self.hosts.get(stream["dst_id"])
                if sdst is not None and sdst.state == ADMITTED \
                        and sdst is not src and sdst.engine is not None \
                        and self._finish_stream(rec, src, sdst, stream):
                    continue
                # the stream could not land: release the stage and take
                # the whole hop
                self._stream_abort(uid)
                self._c_chunk_aborts.inc()
            elif stream is not None:
                self._streams.pop(uid, None)
            try:
                dst, _ = self._pick(rec, kind="decode", exclude=src)
            except FleetUnavailable:
                continue  # retry next round
            if dst is src:
                continue
            t_wire0 = self._clock()
            try:
                ho = src.engine.export_handoff(rec.inner_uid)
                blob = ho.to_bytes()  # the serialized wire hop
                ho = KVHandoff.from_bytes(blob)
                inner = dst.engine.adopt(
                    ho,
                    max_new_tokens=rec.remaining + len(ho.seed_tokens),
                    temperature=rec.temperature, top_k=rec.top_k,
                    top_p=rec.top_p, min_p=rec.min_p,
                    priority=rec.priority, corr=rec.corr,
                )
            except HandoffError as e:
                self._pending_handoff.discard(uid)
                self._handoff_fallback(rec, src, dst, str(e)[:120])
                continue
            self._pending_handoff.discard(uid)
            if inner is None:
                self._handoff_fallback(rec, src, dst, "no_capacity")
                continue
            src.engine.detach(rec.inner_uid)
            srecs = self._assigned.get(src.host_id)
            if srecs is not None and srecs.pop(uid, None) is not None:
                self._load_add(src.host_id, -1)
            self._host_attr(src.host_id)["handoffs_out"] += 1
            self._host_attr(dst.host_id)["handoffs_in"] += 1
            rec.host_id = dst.host_id
            rec.inner_uid = inner
            self._assigned.setdefault(dst.host_id, {})[uid] = rec
            self._load_add(dst.host_id, 1)
            rec.streamed = len(ho.seed_tokens)
            rec.await_decode_first = True
            self._c_handoffs.inc()
            # ``t0``/``t`` bracket the wire hop (export, serialize, CRC
            # import, adopt) on the router clock
            self.tracer.instant("fleet/handoff", uid=uid, corr=rec.corr,
                                src=src.host_id, dst=dst.host_id,
                                pages=ho.n_pages, t0=t_wire0,
                                t=self._clock())
            if self._fr.enabled:
                self._fr.record("fleet/handoff", uid=uid, corr=rec.corr,
                                src=src.host_id, dst=dst.host_id,
                                pages=ho.n_pages,
                                bytes=ho.payload_bytes)

    # -- streamed KV handoff ---------------------------------------------

    def _abort_stage(self, stream: Dict[str, Any]) -> None:
        dst = self.hosts.get(stream.get("dst_id", -1))
        stage = stream.get("stage")
        if dst is not None and dst.engine is not None \
                and stage is not None:
            dst.engine.adopt_stage_abort(stage)

    def _stream_abort(self, uid: int) -> None:
        """Drop a chunk stream, releasing its staged pages on the decode
        host if that host still lives."""
        stream = self._streams.pop(uid, None)
        if stream is None or stream.get("failed"):
            return
        self._abort_stage(stream)

    def _stream_fail(self, uid: int, why: str) -> None:
        """A chunk could not ship or land: release the stage and mark the
        uid, so the handoff takes the whole hop."""
        stream = self._streams.get(uid)
        if stream is not None and not stream.get("failed"):
            self._abort_stage(stream)
        self._streams[uid] = {"failed": True}
        self._c_chunk_aborts.inc()
        if self._fr.enabled:
            self._fr.record("fleet/handoff_chunk_abort", uid=uid,
                            why=why)

    def _stream_handoffs(self) -> None:
        """While a request still prefills on its prefill host, ship its
        finished pages chunk by chunk into a staged slot on the decode
        host it will hand off to, so only the tail chunk crosses the
        blocking hop in :meth:`_do_handoffs`.  Runs after the host
        steps; sorted hosts and uids, so deterministic."""
        if not (self.stream_handoff and self._has_roles):
            return
        from apex_tpu_torch.serve.handoff import (HandoffError,
                                                  KVHandoffChunk)

        for hid in sorted(self._assigned):
            host = self.hosts.get(hid)
            if host is None or host.state != ADMITTED \
                    or host.role != "prefill":
                continue
            recs = self._assigned[hid]
            for uid in sorted(recs):
                rec = recs.get(uid)
                if rec is None or rec.done or rec.inner_uid is None \
                        or uid in self._pending_handoff:
                    continue
                if host.engine.prefill_progress(rec.inner_uid) is None:
                    continue  # not admitted yet, or prefill finished
                stream = self._streams.get(uid)
                if stream is not None and stream.get("failed"):
                    continue
                if stream is None:
                    try:
                        dst, _ = self._pick(rec, kind="decode",
                                            exclude=host)
                    except FleetUnavailable:
                        continue
                    if dst is host:
                        continue
                    stage = dst.engine.adopt_stage_begin()
                    if stage is None:
                        # no free slot to stage into: this request hands
                        # off whole
                        self._streams[uid] = {"failed": True}
                        continue
                    stream = self._streams[uid] = {
                        "dst_id": dst.host_id, "stage": stage,
                        "sent": 0, "seq": 0, "bytes": 0,
                    }
                else:
                    dst = self.hosts.get(stream["dst_id"])
                    if dst is None or dst.state != ADMITTED \
                            or dst.engine is None:
                        self._stream_fail(uid, "dst_gone")
                        continue
                try:
                    chunk = host.engine.export_prefill_chunk(
                        rec.inner_uid, stream["sent"],
                        seq=stream["seq"])
                except ValueError:
                    self._stream_fail(uid, "export")
                    continue
                if chunk is None:
                    continue  # no newly finished pages this round
                try:
                    blob = chunk.to_bytes()  # the wire hop
                    chunk = KVHandoffChunk.from_bytes(blob)
                    ok = dst.engine.adopt_stage_chunk(stream["stage"],
                                                      chunk)
                except HandoffError as e:
                    self._stream_fail(uid, str(e)[:80])
                    continue
                if not ok:
                    self._stream_fail(uid, "stage_reject")
                    continue
                stream["sent"] += chunk.n_pages
                stream["seq"] += 1
                stream["bytes"] += len(blob)
                self._c_chunks.inc()
                if self._fr.enabled:
                    self._fr.record("fleet/handoff_chunk", uid=uid,
                                    corr=rec.corr, src=hid,
                                    dst=stream["dst_id"],
                                    pages=chunk.n_pages,
                                    offset=chunk.page_offset,
                                    bytes=len(blob))

    def _finish_stream(self, rec: _FleetRecord, src: FleetHost,
                       dst: FleetHost,
                       stream: Dict[str, Any]) -> bool:
        """Land a streamed handoff: only the tail chunk (the pages past
        what was streamed, and the sampled seed tokens) crosses the wire
        inside the ``t0``/``t`` bracket.  False (the caller takes the
        whole hop) on any failure; the staged pages are the caller's to
        release."""
        from apex_tpu_torch.serve.handoff import (HandoffError,
                                                  KVHandoffChunk)

        uid = rec.uid
        t_wire0 = self._clock()
        try:
            tail = src.engine.export_handoff_tail(
                rec.inner_uid, stream["sent"], seq=stream["seq"])
            blob = tail.to_bytes()  # the blocking wire hop: the tail
            tail = KVHandoffChunk.from_bytes(blob)
            inner = dst.engine.adopt_stage_commit(
                stream["stage"], tail,
                max_new_tokens=rec.remaining + len(tail.seed_tokens),
                temperature=rec.temperature, top_k=rec.top_k,
                top_p=rec.top_p, min_p=rec.min_p,
                priority=rec.priority, corr=rec.corr,
            )
        except (HandoffError, ValueError, KeyError):
            return False
        if inner is None:
            return False
        self._streams.pop(uid, None)
        self._pending_handoff.discard(uid)
        src.engine.detach(rec.inner_uid)
        srecs = self._assigned.get(src.host_id)
        if srecs is not None and srecs.pop(uid, None) is not None:
            self._load_add(src.host_id, -1)
        self._host_attr(src.host_id)["handoffs_out"] += 1
        self._host_attr(dst.host_id)["handoffs_in"] += 1
        rec.host_id = dst.host_id
        rec.inner_uid = inner
        self._assigned.setdefault(dst.host_id, {})[uid] = rec
        self._load_add(dst.host_id, 1)
        rec.streamed = len(tail.seed_tokens)
        rec.await_decode_first = True
        self._c_handoffs.inc()
        wire = len(blob)
        total = stream["bytes"] + wire
        self._stream_wire_bytes += wire
        self._stream_total_bytes += total
        pages = tail.page_offset + tail.n_pages
        self.tracer.instant("fleet/handoff", uid=uid, corr=rec.corr,
                            src=src.host_id, dst=dst.host_id,
                            pages=pages,
                            streamed_pages=stream["sent"],
                            t0=t_wire0, t=self._clock())
        if self._fr.enabled:
            self._fr.record("fleet/handoff", uid=uid, corr=rec.corr,
                            src=src.host_id, dst=dst.host_id,
                            pages=pages, bytes=total,
                            wire_bytes=wire, streamed=True)
        return True

    # -- proactive prefix-page rebalancing -------------------------------

    def _rebalance_tick(self) -> None:
        """Ship the hottest shared prefix's pages to an under-loaded
        prefill-capable host ahead of demand (export from the affinity
        owner, one :class:`~apex_tpu_torch.serve.KVHandoffChunk` over the
        wire, import on the destination) and aim affinity there.  One
        migration a tick; under greedy decoding a prefix hit reproduces
        the same K/V, so the tokens do not change."""
        if not (self.rebalance and self.affinity and self._heat):
            return
        use = ("prefill" if self._has_roles and self._pools["prefill"]
               else "any")
        pool = self._pools[use]
        if len(pool) < 2:
            return
        least_id = self._heap_least(use)
        if least_id is None:
            return
        from apex_tpu_torch.serve.handoff import (HandoffError,
                                                  KVHandoffChunk)

        for negheat, key in sorted(
                (-n, k) for k, n in self._heat.items()):
            if -negheat < self.rebalance_min_heat:
                break
            owner = self._prefix_override.get(key)
            if owner is None or owner not in pool:
                owner = self._rings[use].lookup(key)
            if owner is None or owner not in pool \
                    or owner == least_id:
                continue
            if self._load.get(owner, 0) - self._load.get(least_id, 0) \
                    <= self.rebalance_gap:
                continue  # the owner is not hot: nothing to shed
            src, dst = self.hosts[owner], self.hosts[least_id]
            if src.engine is None or dst.engine is None:
                continue
            t0 = self._clock()
            chunk = src.engine.export_prefix(list(key))
            if chunk is None:
                continue  # the pages are not resident on the owner
            try:
                blob = chunk.to_bytes()  # the wire hop
                chunk = KVHandoffChunk.from_bytes(blob)
                anchor = dst.engine.import_prefix(chunk, list(key))
            except HandoffError:
                anchor = None
            if anchor is None:
                continue
            self._release_anchor(key)
            self._anchors[key] = (dst.host_id, anchor)
            self._prefix_override[key] = dst.host_id
            self._heat[key] = 0
            self._c_rebalances.inc()
            self.tracer.instant("fleet/rebalance", src=src.host_id,
                                dst=dst.host_id, pages=chunk.n_pages,
                                tokens=len(key), t0=t0,
                                t=self._clock())
            if self._fr.enabled:
                self._fr.record("fleet/rebalance", src=src.host_id,
                                dst=dst.host_id, pages=chunk.n_pages,
                                tokens=len(key), bytes=len(blob))
            return

    def _release_anchor(self, key) -> None:
        """Drop the page anchor an earlier migration of ``key`` left (a
        cache never evicted would starve admission on a small pool)."""
        old = self._anchors.pop(key, None)
        if old is None:
            return
        hid, anchor = old
        host = self.hosts.get(hid)
        if host is not None and host.engine is not None:
            host.engine.release_prefix(anchor)

    # -- SLO-driven autoscaling ------------------------------------------

    def _standby_pool(self) -> List[int]:
        """Spin-up candidates in registration order: standby hosts never
        admitted, and drained ones (readmission rebuilds an engine through
        the cached preflight)."""
        return [hid for hid in self._standby_ids
                if self.hosts[hid].state in (NEW, DRAINED)]

    def _autoscale_tick(self) -> None:
        """One scaling decision a round: a TTFT burn admits the next
        standby host (cooldown-paced); ``drain_after_rounds`` calm rounds
        drain the newest scale-up (no new routing, actives finish, then
        its engine goes)."""
        t = self._clock()
        burning = (self._slo is not None
                   and self._slo.burning("ttft_ms", t))
        if self._cooldown > 0:
            self._cooldown -= 1
        if burning:
            self._calm_rounds = 0
            if self._cooldown == 0:
                pool = self._standby_pool()
                if pool:
                    hid = pool[0]
                    self._cooldown = self.scale_cooldown_rounds
                    if self._fr.enabled:
                        self._fr.record("fleet/scale_up", host=hid,
                                        reason="ttft_burn",
                                        round=self.rounds)
                    self.tracer.instant("fleet/scale_up", host=hid,
                                        reason="ttft_burn")
                    if self.admit(hid):
                        self._scaled_up.append(hid)
                        self._c_scale_ups.inc()
            return
        self._calm_rounds += 1
        if self._calm_rounds >= self.drain_after_rounds \
                and self._scaled_up:
            hid = self._scaled_up.pop()
            host = self.hosts[hid]
            if host.state == ADMITTED:
                host.state = DRAINING
                self._pool_leave(host)
                self._draining.add(hid)
                self._c_drains.inc()
                self.tracer.instant("fleet/drain", host=hid,
                                    outstanding=self._load.get(hid, 0))
                if self._fr.enabled:
                    self._fr.record("fleet/drain", host=hid,
                                    reason="ttft_calm",
                                    outstanding=self._load.get(hid, 0),
                                    round=self.rounds)
            self._calm_rounds = 0

    def _finish_drains(self) -> None:
        """A draining host with nothing in flight releases its engine
        (and every page) and returns to the standby pool as
        ``drained``."""
        if not self._draining:
            return
        for hid in sorted(self._draining):
            h = self.hosts[hid]
            if h.state != DRAINING:
                self._draining.discard(hid)
                continue
            if self._load.get(hid, 0) != 0:
                continue
            h.release_engine()
            h.state = DRAINED
            self._draining.discard(hid)
            self._sync_beats(h, self.rounds)
            self._hb_synced.pop(hid, None)
            self.tracer.instant("fleet/drained", host=hid)
            if self._fr.enabled:
                self._fr.record("fleet/drained", host=hid)

    def roll_host(self, host_id: int, on_drained=None, *,
                  drain_rounds: Optional[int] = None,
                  corr: Optional[str] = None,
                  max_rounds: int = 10_000) -> Dict[str, Any]:
        """Drain one host, wait until it is calm, run ``on_drained(host)``
        and readmit it keeping its engine: the maintenance primitive a
        weight promotion rolls hosts through one at a time.

        The host leaves the routing pools (state ``draining``) while the
        fleet keeps stepping, so its requests finish.  Once it is calm,
        or after ``drain_rounds`` rounds (a finite budget leaves
        requests in flight on purpose), ``on_drained`` runs and the host
        is readmitted without ``start()``: its engine, pages and active
        requests survive.  If ``on_drained`` raises, the host is
        readmitted on its untouched engine first and the exception goes
        on.  Returns ``{"host", "rounds", "calm", "outstanding",
        "result"}``, ``result`` being what ``on_drained`` returned."""
        host = self.hosts[host_id]
        if host.state != ADMITTED:
            raise ValueError(
                f"roll_host: host {host_id} is {host.state}, not admitted"
            )
        kw = {"corr": corr} if corr is not None else {}
        host.state = DRAINING
        self._pool_leave(host)
        self._c_rolls.inc()
        self.tracer.instant("fleet/roll", host=host_id,
                            outstanding=self._load.get(host_id, 0), **kw)
        if self._fr.enabled:
            self._fr.record("fleet/roll", host=host_id,
                            outstanding=self._load.get(host_id, 0),
                            round=self.rounds, **kw)
        rounds = 0
        budget = max_rounds if drain_rounds is None else int(drain_rounds)
        while self._load.get(host_id, 0) and rounds < budget:
            self.step()
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"roll_host: host {host_id} still has "
                    f"{self._load.get(host_id, 0)} request(s) in flight "
                    f"after {max_rounds} rounds"
                )
        outstanding = self._load.get(host_id, 0)
        self.tracer.instant("fleet/roll_calm", host=host_id,
                            rounds=rounds, outstanding=outstanding, **kw)
        if self._fr.enabled:
            self._fr.record("fleet/roll_calm", host=host_id,
                            rounds=rounds, outstanding=outstanding,
                            round=self.rounds, **kw)
        result = None
        try:
            if on_drained is not None:
                result = on_drained(host)
        finally:
            # readmit keeping the engine, with the load it still carries
            load = self._load.get(host_id, 0)
            host.state = ADMITTED
            self._pool_join(host)
            if load:
                self._load_add(host_id, load)
            self._suspects.discard(host_id)
            self._hb_synced[host_id] = self.rounds
            self._c_readmits.inc()
            self.tracer.instant("fleet/roll_readmit", host=host_id,
                                outstanding=load, **kw)
            if self._fr.enabled:
                self._fr.record("fleet/roll_readmit", host=host_id,
                                outstanding=load, round=self.rounds,
                                **kw)
        return {
            "host": host_id,
            "rounds": rounds,
            "calm": outstanding == 0,
            "outstanding": outstanding,
            "result": result,
        }

    def _scan_stragglers(self) -> None:
        """Each admitted host's decode-window p99 against the fleet's
        lower median (in a small fleet the straggler must not drag the
        reference up past its own threshold)."""
        p99s = {h.host_id: p for h in self.admitted()
                if (p := h.decode_p99()) is not None}
        if len(p99s) < 2:
            return
        vals = sorted(p99s.values())
        median = vals[(len(vals) - 1) // 2]
        for hid, p in p99s.items():
            if median > 0 and p > self.straggler_factor * median:
                if hid not in self.stragglers:
                    self._c_straggler.inc()
                    self.tracer.instant("fleet/straggler", host=hid,
                                        p99_ms=round(p, 3),
                                        fleet_median_ms=round(median, 3))
                self.stragglers.add(hid)
            else:
                self.stragglers.discard(hid)

    # -- the fleet round -------------------------------------------------

    def step(self) -> bool:
        """One fleet round: faults, heartbeats, handoffs, autoscale,
        (re)assignment, one boundary per serving host, harvest, handoff
        marking, drain completion, straggler scan.  Returns False once
        everything is drained."""
        self.rounds += 1
        self._poll_faults()
        self._heartbeat_scan()
        self._do_handoffs()
        if self.autoscale and self.serving():
            # tick on idle rounds too: a calm gap between bursts is when
            # the scaled-up host should drain
            self._autoscale_tick()
        if not self._open:
            self._finish_drains()
            return False
        if not self.serving():
            raise FleetUnavailable(
                f"all {len(self.hosts)} hosts unhealthy with "
                f"{self._open} request(s) outstanding "
                f"{self._state_summary()}"
            )
        self._park_unassigned()
        for h in self.serving():
            h.step()
            self._c_boundaries.inc()
        self._harvest()
        self._mark_prefill_done()
        self._stream_handoffs()
        if self.rebalance and self.rounds % self.rebalance_every == 0:
            self._rebalance_tick()
        self._finish_drains()
        if self.straggler_every == 1 \
                or self.rounds % self.straggler_every == 0:
            self._scan_stragglers()
        return self._open > 0

    def run(self, max_rounds: int = 100_000) -> Dict[int, List[int]]:
        """Drain the fleet; ``{fleet uid: generated tokens}``."""
        rounds = 0
        while self.step():
            rounds += 1
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"fleet undrained after {max_rounds} rounds"
                )
        return self.results()

    def results(self) -> Dict[int, List[int]]:
        return {uid: list(r.tokens) for uid, r in self._records.items()}

    def progress(self) -> Dict[int, Tuple[List[int], bool]]:
        """``{uid: (tokens so far, done)}`` from the router's records
        (harvested every round)."""
        return {uid: (list(r.tokens), r.done)
                for uid, r in self._records.items()}

    def export_trace(self, path: str) -> str:
        """Write the router's ``trace.jsonl`` (meta ``{"router": true}``):
        the ``fleet/submit``, ``fleet/assign``, ``fleet/first_token``, ...
        milestones that correlation stitching joins with the hosts'
        exports."""
        from apex_tpu_torch.obs.export import write_jsonl

        return write_jsonl(self.tracer, path, registry=self.registry,
                           extra_meta={"router": True})

    # -- accounting ------------------------------------------------------

    def _host_counter(self, host: FleetHost, name: str) -> int:
        c = host.registry.get(name)
        return int(c.value) if c is not None else 0

    def routing_attribution(self) -> Dict[str, Dict[str, Any]]:
        """Per-host routing ledger: requests routed, affinity hits,
        fallback reasons, handoffs in and out, and the host's prefix
        economics from its registry.  Counts only, so byte-replayable
        (``LoadReport.routing``)."""
        out: Dict[str, Dict[str, Any]] = {}
        for hid in sorted(self.hosts):
            h = self.hosts[hid]
            a = self._attr.get(hid, {})
            pt = self._host_counter(h, "serve.prompt_tokens")
            pht = self._host_counter(h, "serve.prefix_hit_tokens")
            out[str(hid)] = {
                "role": h.role,
                "state": h.state,
                "requests": a.get("requests", 0),
                "affinity_hits": a.get("affinity_hits", 0),
                "fallbacks": dict(sorted(
                    a.get("fallbacks", {}).items()
                )),
                "handoffs_in": a.get("handoffs_in", 0),
                "handoffs_out": a.get("handoffs_out", 0),
                "prompt_tokens": pt,
                "prefix_hit_tokens": pht,
                "prefix_hit_rate": round(pht / pt, 4) if pt else 0.0,
            }
        return out

    def fleet_prefix_hit_rate(self) -> float:
        """Shared prompt tokens over all prompt tokens, summed over every
        host's registry (registries survive rebuilds, so the rate holds
        across chaos)."""
        pt = sum(self._host_counter(h, "serve.prompt_tokens")
                 for h in self.hosts.values())
        pht = sum(self._host_counter(h, "serve.prefix_hit_tokens")
                  for h in self.hosts.values())
        return round(pht / pt, 4) if pt else 0.0

    def stats(self) -> Dict[str, Any]:
        """The fleet ledger and each host's state."""
        # settle the lazily credited heartbeats, so ``beats`` reads as if
        # every serving host had been beaten every round
        for hid, h in self.hosts.items():
            if hid in self._hb_synced:
                self._sync_beats(h, self.rounds)
        return {
            "hosts": {
                h.host_id: {
                    "state": h.state,
                    "role": h.role,
                    "beats": h.beats,
                    "preflight_passed": (None if h.preflight is None
                                         else h.preflight.passed),
                    "decode_p99_ms": h.decode_p99(),
                    "straggler": h.host_id in self.stragglers,
                }
                for h in self.hosts.values()
            },
            "rounds": self.rounds,
            "evictions": self._c_evictions.value,
            "host_losses": self._c_losses.value,
            "readmissions": self._c_readmits.value,
            "preflight_failures": self._c_pf_fail.value,
            "requests_recovered": self._c_moved.value,
            "straggler_flags": self._c_straggler.value,
            "affinity": self.affinity,
            "requests_routed": self._c_routed.value,
            "affinity_hits": self._c_aff_hits.value,
            "affinity_fallbacks": self._c_aff_fallbacks.value,
            "fleet_prefix_hit_rate": self.fleet_prefix_hit_rate(),
            "handoffs": self._c_handoffs.value,
            "handoff_fallbacks": self._c_handoff_fb.value,
            "rebalances": self._c_rebalances.value,
            "handoff_chunks": self._c_chunks.value,
            "handoff_chunk_aborts": self._c_chunk_aborts.value,
            "scale_ups": self._c_scale_ups.value,
            "drains": self._c_drains.value,
            "host_boundaries": self._c_boundaries.value,
        }
