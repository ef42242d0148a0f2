"""Open-loop traffic harness: seeded, byte-replayable load on a virtual
clock.

Counterpart of ``apex_tpu/serve/loadgen.py``, with the same plans and
reports: :meth:`TrafficPlan.from_seed` and :meth:`LoadReport.to_json`
give the same bytes in both packages for the same seed and the same
scheduling.

- **Open-loop arrivals.** Requests arrive on their own schedule whether
  or not the engine keeps up (queueing delay exists only when arrivals
  do not wait for completions).  :meth:`TrafficPlan.from_seed` draws a
  Poisson process, optionally modulated by on/off bursts (exponential
  phase lengths, ``burst_factor`` x the base rate while on).
- **Zipf-shared prefixes.** A small pool of shared prefixes with
  Zipf-weighted popularity fronts a fraction of the prompts, so the
  prefix registry sees skew under churn.
- **Long-tail lengths.** Prompt and output lengths are Pareto-tailed
  (clipped): most requests are short, a few are long, which is what
  makes FIFO admission's head-of-line blocking visible.
- **Deadlines and priorities.** A seeded fraction of requests carries a
  deadline (used by targets whose ``submit`` takes ``deadline_ms``) and
  a priority class (used by SLO-aware admission).

Everything is drawn from one ``numpy.random.RandomState(seed)`` in a
fixed order, and the plan serializes (:meth:`TrafficPlan.to_json`)
byte-identically for a given seed.

Execution runs on a VIRTUAL clock: :class:`LoadGen` owns a
:class:`VirtualClock`, the target engine is built with
``clock=gen.clock``, and virtual time advances ``step_cost_ms`` per
dispatch boundary (jumping over idle gaps to the next arrival).  Every
lifecycle timestamp (TTFT, ITL, queue delay, the SLO tracker's window
rotation) is then a pure function of the seed and the scheduling
policy: two runs of the same plan give byte-identical
:class:`LoadReport`\\ s, and a policy A/B (FIFO against SLO-aware
admission) is noise-free.

The target is the port's :class:`~apex_tpu_torch.serve.ServeEngine`, a
:class:`~apex_tpu_torch.resilience.ResilientServeEngine` (its deadlines
then fire at deterministic virtual times, so abandonment replays too)
or a :class:`~apex_tpu_torch.fleet.FleetRouter` (every host's registry
merged, drained hosts' lifecycle summaries counted, the routing
attribution in the report); targets differ only in which ``submit``
keywords they take, which :class:`LoadGen` inspects once.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["LoadGen", "LoadReport", "LoadRequest", "TrafficPlan",
           "VirtualClock"]

_MS_NS = 1_000_000  # ms -> ns


class VirtualClock:
    """A monotonic ns clock the harness advances by hand.  Call it like
    ``time.perf_counter_ns`` (the engine/lifecycle clock contract)."""

    __slots__ = ("t_ns",)

    def __init__(self, t0_ns: int = 0):
        self.t_ns = int(t0_ns)

    def __call__(self) -> int:
        return self.t_ns

    @property
    def now_ms(self) -> float:
        return self.t_ns / _MS_NS

    def advance_ms(self, ms: float) -> None:
        self.t_ns += int(round(ms * _MS_NS))

    def advance_to_ms(self, ms: float) -> None:
        """Jump forward to ``ms`` (never backwards)."""
        target = int(round(ms * _MS_NS))
        if target > self.t_ns:
            self.t_ns = target


@dataclasses.dataclass
class LoadRequest:
    """One planned arrival (times in virtual ms since plan start)."""

    uid: int
    at_ms: float
    prompt: List[int]
    max_new_tokens: int
    priority: int = 0
    deadline_ms: Optional[float] = None  # relative to at_ms
    prefix_id: int = -1  # shared-prefix pool index (-1 = unique)

    def to_dict(self) -> dict:
        return {
            "uid": self.uid, "at_ms": self.at_ms,
            "prompt": list(self.prompt),
            "max_new_tokens": self.max_new_tokens,
            "priority": self.priority, "deadline_ms": self.deadline_ms,
            "prefix_id": self.prefix_id,
        }


def _pareto_len(rng, lo: int, scale: float, alpha: float,
                cap: int) -> int:
    """Clipped Pareto-tailed integer length — the long-tail generator
    (most draws near ``lo``, occasional draws at ``cap``)."""
    return int(min(cap, lo + rng.pareto(alpha) * scale))


class TrafficPlan:
    """A fully materialized arrival timeline (see module docstring).

    Build one with :meth:`from_seed`; the plan is plain data
    (``requests`` is a list of :class:`LoadRequest`), serializes
    deterministically, and can be replayed against any number of
    targets/policies: the A/B discipline a scheduling claim rests on.
    """

    def __init__(self, requests: List[LoadRequest], meta: dict):
        self.requests = requests
        self.meta = dict(meta)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def seed(self):
        return self.meta.get("seed")

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        requests: int = 32,
        rate_rps: float = 50.0,
        arrival: str = "bursty",
        burst_factor: float = 8.0,
        burst_on_s: float = 0.4,
        burst_off_s: float = 1.6,
        vocab_size: int = 1000,
        n_prefixes: int = 4,
        prefix_len: int = 12,
        zipf_s: float = 1.2,
        shared_frac: float = 0.6,
        prompt_min: int = 2,
        prompt_scale: float = 4.0,
        prompt_alpha: float = 1.5,
        prompt_cap: int = 40,
        output_min: int = 2,
        output_scale: float = 4.0,
        output_alpha: float = 1.3,
        output_cap: int = 24,
        deadline_frac: float = 0.0,
        deadline_ms: float = 500.0,
        priorities: Sequence[int] = (0,),
        priority_weights: Optional[Sequence[float]] = None,
        interactive_max_prompt: Optional[int] = None,
    ) -> "TrafficPlan":
        """Draw a deterministic plan.  ``arrival`` is ``"poisson"``
        (exponential gaps at ``rate_rps``) or ``"bursty"`` (the same
        process rate-modulated by on/off phases with exponential
        lengths ``burst_on_s``/``burst_off_s`` — ``burst_factor`` x
        the base rate while on).  Shared prompts draw a prefix from a
        Zipf(``zipf_s``) popularity over ``n_prefixes`` pool entries;
        lengths are clipped-Pareto; a ``deadline_frac`` fraction of
        requests carries a deadline jittered around ``deadline_ms``;
        priorities draw from ``priorities`` with ``priority_weights``
        (uniform by default) — unless ``interactive_max_prompt`` is
        set, in which case priority is ASSIGNED by size (prompts at or
        under the threshold get ``max(priorities)``, the rest
        ``min(priorities)`` — the chat-vs-batch split)."""
        if arrival not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {arrival!r}")
        rng = np.random.RandomState(seed)
        prefixes = [
            [int(t) for t in rng.randint(0, vocab_size, size=prefix_len)]
            for _ in range(n_prefixes)
        ]
        zipf_w = np.array([1.0 / (k + 1) ** zipf_s
                           for k in range(n_prefixes)])
        zipf_w /= zipf_w.sum()
        prios = list(priorities)
        pw = (np.full(len(prios), 1.0 / len(prios))
              if priority_weights is None
              else np.asarray(priority_weights, float)
              / np.sum(priority_weights))

        out: List[LoadRequest] = []
        t_ms = 0.0
        in_burst = False
        phase_end_ms = 0.0
        for uid in range(int(requests)):
            # -- arrival time ------------------------------------------
            if arrival == "bursty":
                while t_ms >= phase_end_ms:
                    in_burst = not in_burst
                    dur_s = burst_on_s if in_burst else burst_off_s
                    phase_end_ms += rng.exponential(dur_s) * 1e3
                rate = rate_rps * (burst_factor if in_burst else 1.0)
            else:
                rate = rate_rps
            t_ms += rng.exponential(1000.0 / rate)
            # -- prompt ------------------------------------------------
            shared = bool(n_prefixes) and rng.rand() < shared_frac
            if shared:
                pid = int(rng.choice(n_prefixes, p=zipf_w))
                suffix_n = _pareto_len(rng, prompt_min, prompt_scale,
                                       prompt_alpha, prompt_cap)
                prompt = prefixes[pid] + [
                    int(t) for t in rng.randint(0, vocab_size,
                                                size=suffix_n)
                ]
            else:
                pid = -1
                n = _pareto_len(rng, prompt_min + prefix_len // 2,
                                prompt_scale, prompt_alpha, prompt_cap)
                prompt = [int(t) for t in rng.randint(0, vocab_size,
                                                      size=n)]
            # -- output budget / deadline / priority -------------------
            max_new = _pareto_len(rng, output_min, output_scale,
                                  output_alpha, output_cap)
            deadline = None
            if deadline_frac > 0 and rng.rand() < deadline_frac:
                deadline = round(deadline_ms * (0.5 + rng.rand()), 3)
            if interactive_max_prompt is not None:
                prio = (max(prios) if len(prompt) <= interactive_max_prompt
                        else min(prios))
            else:
                prio = prios[int(rng.choice(len(prios), p=pw))]
            out.append(LoadRequest(
                uid=uid, at_ms=round(t_ms, 3), prompt=prompt,
                max_new_tokens=max_new, priority=int(prio),
                deadline_ms=deadline, prefix_id=pid,
            ))
        meta = {
            "schema": "apex_tpu.loadgen.v1", "seed": int(seed),
            "arrival": arrival, "rate_rps": rate_rps,
            "burst_factor": burst_factor if arrival == "bursty" else 1.0,
            "requests": int(requests), "n_prefixes": n_prefixes,
            "zipf_s": zipf_s, "shared_frac": shared_frac,
            "deadline_frac": deadline_frac,
            "priorities": [int(p) for p in prios],
        }
        return cls(out, meta)

    # -- serialization (the byte-replayability witness) ------------------

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(
            {"meta": self.meta,
             "requests": [r.to_dict() for r in self.requests]},
            indent=indent, sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "TrafficPlan":
        d = json.loads(text)
        reqs = [LoadRequest(
            uid=r["uid"], at_ms=r["at_ms"], prompt=list(r["prompt"]),
            max_new_tokens=r["max_new_tokens"],
            priority=r.get("priority", 0),
            deadline_ms=r.get("deadline_ms"),
            prefix_id=r.get("prefix_id", -1),
        ) for r in d["requests"]]
        return cls(reqs, d.get("meta", {}))

    def stats(self) -> dict:
        """Shape summary of the plan (arrival span, length tails,
        shared fraction) — plan-level context for reports."""
        if not self.requests:
            return {"requests": 0}
        plens = sorted(len(r.prompt) for r in self.requests)
        outs = sorted(r.max_new_tokens for r in self.requests)
        shared = sum(1 for r in self.requests if r.prefix_id >= 0)
        return {
            "requests": len(self.requests),
            "span_ms": round(self.requests[-1].at_ms, 3),
            "prompt_len": {"min": plens[0], "max": plens[-1],
                           "p50": plens[len(plens) // 2]},
            "max_new_tokens": {"min": outs[0], "max": outs[-1]},
            "shared_prefix_frac": round(shared / len(self.requests), 3),
            "with_deadline": sum(
                1 for r in self.requests if r.deadline_ms is not None
            ),
        }


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _registries(target) -> List:
    """The metrics registries holding ``target``'s lifecycle histograms:
    a ``ServeEngine``'s own, a ``ResilientServeEngine``'s (shared by
    every inner engine it built), or every fleet host's."""
    if hasattr(target, "obs_registry"):       # ServeEngine
        return [target.obs_registry]
    if hasattr(target, "hosts"):              # FleetRouter
        return [h.registry for h in target.hosts.values()]
    if hasattr(target, "registry"):           # ResilientServeEngine
        return [target.registry]
    raise TypeError(f"no metrics registry on {type(target).__name__}")


def _lifecycle_summaries(target) -> List[dict]:
    """An engine's lifecycle summary, or each fleet host's (a
    ``FleetHost`` sums its released engine generations too, so a drained
    host keeps its counts)."""
    if hasattr(target, "lifecycle_summary"):
        return [target.lifecycle_summary()]
    if hasattr(target, "hosts"):
        out = []
        for h in target.hosts.values():
            fn = getattr(h, "lifecycle_summary", None)
            if fn is not None:
                out.append(fn())
            elif h.engine is not None:
                out.append(h.engine.lifecycle_summary())
        return out
    return []


def _results(target) -> Dict[int, List[int]]:
    """``{uid: tokens}``: a ``ServeEngine``'s finished requests, or a
    ``ResilientServeEngine``'s records (abandoned ones included)."""
    r = getattr(target, "results")
    if callable(r):
        return r()
    return {uid: list(req.tokens) for uid, req in r.items()}


def _merged_quantiles(regs, name: str) -> dict:
    """p50/p99 over the union of per-registry histogram samples
    (nearest-rank, the obs convention) — exact for any run that fits
    the reservoirs, which every harness run does."""
    samples: List[float] = []
    count = 0
    for reg in regs:
        h = reg.get(name)
        if h is None or not getattr(h, "count", 0):
            continue
        count += h.count
        samples.extend(h._samples)
    if not samples:
        return {"count": 0}
    samples.sort()

    def q(p):
        i = max(0, min(len(samples) - 1,
                       math.ceil(p * len(samples)) - 1))
        return round(samples[i], 3)

    return {"count": count, "p50": q(0.50), "p99": q(0.99)}


def _quantile_dict(vals: List[float]) -> dict:
    if not vals:
        return {"count": 0}
    s = sorted(vals)

    def q(p):
        return round(s[max(0, min(len(s) - 1,
                                  math.ceil(p * len(s)) - 1))], 3)

    return {"count": len(s), "p50": q(0.50), "p99": q(0.99)}


def _counter_sum(regs, name: str) -> int:
    total = 0
    for reg in regs:
        c = reg.get(name)
        if c is not None:
            total += c.value
    return total


@dataclasses.dataclass
class LoadReport:
    """The harness's deterministic run record: tail latencies from the
    target's own lifecycle histograms, goodput over the VIRTUAL wall,
    the abandonment/preemption ledger, the SLO report when a tracker
    was live, and the full ``{uid: tokens}`` map, so ``to_json``
    equality IS the byte-replayability check."""

    plan_meta: dict
    rounds: int
    virtual_wall_ms: float
    submitted: int
    completed: int
    abandoned: int
    abandonment_rate: float
    completed_tokens: int
    goodput_tokens_per_s: float
    ttft_ms: dict
    ttft_ms_by_priority: Dict[int, dict]
    itl_ms: dict
    queue_delay_ms: dict
    preemptions: int
    slo_yields: int
    slo_overtakes: int
    slo: Optional[dict]
    tokens: Dict[int, List[int]]
    # per-host routing attribution of a fleet target (requests, affinity
    # hits, fallback reasons, handoffs, prefix economics: counts only);
    # None for an engine
    routing: Optional[Dict[str, dict]] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["tokens"] = {str(k): list(v) for k, v in sorted(
            self.tokens.items())}
        d["ttft_ms_by_priority"] = {
            str(k): v for k, v in sorted(
                self.ttft_ms_by_priority.items())
        }
        return d

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True,
                          default=float)


class LoadGen:
    """Drive one :class:`TrafficPlan` into a target on virtual time.

    Args:
      plan: the materialized arrival timeline.
      step_cost_ms: virtual milliseconds one dispatch boundary costs —
        the clock's only source of progress while the target is busy
        (idle gaps jump straight to the next arrival).  TTFT/ITL are
        then measured in boundary-counts x this constant: determinism
        comes first, absolute wall realism is the real clock's job.
      clock: an existing :class:`VirtualClock` to share (default: a
        fresh one).  Construct the target with ``clock=gen.clock`` —
        the harness asserts the target actually shares it, because a
        wall-clock engine under a virtual-clock plan silently breaks
        replayability.

    One LoadGen instance runs ONE target (the clock only moves
    forward); build a fresh generator per leg when A/B-ing policies.
    """

    def __init__(self, plan: TrafficPlan, step_cost_ms: float = 5.0,
                 clock: Optional[VirtualClock] = None):
        if step_cost_ms <= 0:
            raise ValueError("step_cost_ms must be positive")
        self.plan = plan
        self.step_cost_ms = float(step_cost_ms)
        self.clock = VirtualClock() if clock is None else clock

    def _submit(self, target, r: LoadRequest, kw_names) -> int:
        kw = {"max_new_tokens": r.max_new_tokens}
        if "priority" in kw_names:
            kw["priority"] = r.priority
        if r.deadline_ms is not None and "deadline_ms" in kw_names:
            kw["deadline_ms"] = r.deadline_ms
        return target.submit(r.prompt, **kw)

    def run(self, target, max_rounds: int = 200_000) -> LoadReport:
        """Replay the plan to completion; returns the
        :class:`LoadReport`.  Arrivals are submitted the boundary
        their virtual timestamp has passed; the loop steps the target
        once per ``step_cost_ms`` of virtual time and jumps idle
        gaps."""
        if hasattr(target, "hosts"):  # FleetRouter: per-host engines
            clocks = [h.engine._clock for h in target.hosts.values()
                      if h.engine is not None]
        else:
            c = getattr(target, "_clock", None)
            clocks = [] if c is None else [c]
        if any(c is not self.clock for c in clocks):
            raise ValueError(
                "target does not share this LoadGen's virtual clock — "
                "construct it with clock=gen.clock or replayability "
                "is lost"
            )
        kw_names = inspect.signature(target.submit).parameters
        reqs = self.plan.requests
        uid_map: Dict[int, int] = {}
        submit_ms: Dict[int, float] = {}
        first_tok_ms: Dict[int, float] = {}
        t0_ms = self.clock.now_ms
        i = 0
        rounds = 0
        busy = True
        while i < len(reqs) or busy:
            now_ms = self.clock.now_ms - t0_ms
            while i < len(reqs) and reqs[i].at_ms <= now_ms:
                uid_map[reqs[i].uid] = self._submit(target, reqs[i],
                                                    kw_names)
                submit_ms[reqs[i].uid] = now_ms
                i += 1
            busy = target.step()
            # harness-side first-token watch (same boundary timestamp
            # the lifecycle uses — the clock has not advanced yet):
            # feeds the per-priority-class TTFT breakdown the
            # registry's one flat histogram cannot provide
            prog = target.progress()
            now_ms = self.clock.now_ms - t0_ms
            for lr_uid, tgt_uid in uid_map.items():
                if lr_uid in first_tok_ms:
                    continue
                toks, _ = prog.get(tgt_uid, ((), False))
                if toks:
                    first_tok_ms[lr_uid] = now_ms - submit_ms[lr_uid]
            self.clock.advance_ms(self.step_cost_ms)
            rounds += 1
            if not busy and i < len(reqs):
                self.clock.advance_to_ms(t0_ms + reqs[i].at_ms)
            if rounds >= max_rounds:
                raise RuntimeError(
                    f"load plan undrained after {max_rounds} rounds"
                )
        wall_ms = self.clock.now_ms - t0_ms
        by_prio: Dict[int, List[float]] = {}
        for r in reqs:
            v = first_tok_ms.get(r.uid)
            if v is not None:
                by_prio.setdefault(r.priority, []).append(v)

        regs = _registries(target)
        results = _results(target)
        tokens = {r.uid: list(results.get(uid_map[r.uid], []))
                  for r in reqs}
        sums = _lifecycle_summaries(target)
        completed = sum(s["completed"] for s in sums)
        abandoned = sum(s["abandoned"] for s in sums)
        completed_tokens = sum(s["completed_tokens"] for s in sums)
        retired = completed + abandoned
        slo = None
        rep_fn = getattr(target, "slo_report", None)
        if rep_fn is not None:
            rep = rep_fn()
            if rep is not None:
                slo = rep.to_dict()
        routing = None
        attr_fn = getattr(target, "routing_attribution", None)
        if attr_fn is not None:
            routing = attr_fn()
        return LoadReport(
            plan_meta=dict(self.plan.meta),
            rounds=rounds,
            virtual_wall_ms=round(wall_ms, 3),
            submitted=len(reqs),
            completed=completed,
            abandoned=abandoned,
            abandonment_rate=(round(abandoned / retired, 4)
                              if retired else 0.0),
            completed_tokens=completed_tokens,
            goodput_tokens_per_s=(
                round(completed_tokens / (wall_ms * 1e-3), 2)
                if wall_ms > 0 else 0.0
            ),
            ttft_ms=_merged_quantiles(regs, "serve.ttft_ms"),
            ttft_ms_by_priority={
                p: _quantile_dict(vals)
                for p, vals in sorted(by_prio.items())
            },
            itl_ms=_merged_quantiles(regs, "serve.itl_ms"),
            queue_delay_ms=_merged_quantiles(regs,
                                             "serve.queue_delay_ms"),
            preemptions=_counter_sum(regs, "serve.preemptions"),
            slo_yields=_counter_sum(regs, "serve.slo.prefill_yields"),
            slo_overtakes=_counter_sum(regs, "serve.slo.overtakes"),
            slo=slo,
            tokens=tokens,
            routing=routing,
        )
