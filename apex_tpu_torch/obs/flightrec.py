"""Flight recorder: an always-on bounded ring of boundary events.

Counterpart of ``apex_tpu/obs/flightrec.py``, with the same dump
format, so each package's :func:`read_flightrec` reads the other's
file.  When a run dies, what matters is the sequence of events leading
up to it, not the aggregate counters that survive it:

- a :class:`FlightRecorder` is a fixed-capacity ring of structured
  events (train dispatches, serve admit/prefill/decode boundaries,
  retirements and preemptions, SLO alert transitions, checkpoint saves
  and restores), each stamped with a monotonically increasing sequence
  number, a timestamp from the recorder's **injectable clock**, and
  whatever correlation ids the call site attaches (request uid, slot,
  window size, ...);
- recording is **allocation-light**: one tuple written into a
  preallocated slot, no I/O, no device work; a full ring overwrites the
  oldest event (``dropped`` counts what fell off);
- the **default stamp is the logical sequence number** (``clock=None``),
  so two runs of the same seeded schedule dump *byte-identical* files;
  inject ``time.perf_counter_ns`` (or the load harness's virtual clock)
  when timestamps matter more than replay;
- :meth:`FlightRecorder.dump` writes the last events as
  ``flightrec.jsonl``, schema ``apex_tpu.obs.v1``, one JSON object per
  line, atomically (tmp + ``os.replace``), to the path given or the
  recorder's ``dump_dir``; with neither, it writes nothing.

The port reads no environment variable: a recorder is on when built
with ``enabled=True``, or by default while obs is on
(:func:`apex_tpu_torch.obs.set_enabled`); a disabled recorder's
``record()`` is one truthiness check.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.obs.trace import enabled as obs_enabled

__all__ = [
    "DEFAULT_CAPACITY",
    "FlightRecorder",
    "NULL_FLIGHTREC",
    "SCHEMA",
    "default_flightrec",
    "read_flightrec",
    "reset_default_flightrec",
]

SCHEMA = "apex_tpu.obs.v1"
DEFAULT_CAPACITY = 256
DUMP_NAME = "flightrec.jsonl"


class FlightRecorder:
    """Fixed-capacity ring of ``(seq, ts, kind, attrs)`` events.

    Args:
      capacity: ring slots; the newest ``capacity`` events survive.
      clock: ns-returning callable stamping each event, or None (the
        default) to stamp the logical sequence number instead, the
        deterministic mode postmortem byte-replay depends on.
      enabled: None -> :func:`apex_tpu_torch.obs.enabled`, else forced.
        A disabled recorder's ``record`` is one check.
      dump_dir: where :meth:`dump` writes ``flightrec.jsonl`` when
        called without a path (None: such dumps write nothing).

    Hot-path discipline: call sites guard with ``if fr.enabled:`` so a
    disabled recorder never even builds the attrs dict.
    """

    __slots__ = ("enabled", "capacity", "dump_dir", "dumps",
                 "_clock", "_buf", "_seq")

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=None,
                 enabled: Optional[bool] = None,
                 dump_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = obs_enabled() if enabled is None else bool(enabled)
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.dumps = 0
        self._clock = clock
        # a disabled recorder holds NO ring: record() returns before
        # touching it
        self._buf: List[Optional[Tuple]] = (
            [None] * self.capacity if self.enabled else []
        )
        self._seq = 0

    # -- recording -------------------------------------------------------

    def record(self, kind: str, /, **attrs: Any) -> None:
        """Append one event (no-op when disabled).  ``attrs`` carry the
        correlation ids (``kind`` is positional-only so an attr may
        reuse the name); keep them to plain JSON-able scalars so dumps
        stay machine-readable."""
        if not self.enabled:
            return
        seq = self._seq
        self._seq = seq + 1
        ts = seq if self._clock is None else self._clock()
        self._buf[seq % self.capacity] = (seq, ts, kind, attrs or None)

    @property
    def recorded(self) -> int:
        """Total events ever recorded (the ring retains the last
        ``capacity`` of them)."""
        return self._seq

    @property
    def dropped(self) -> int:
        """Events that fell off the ring."""
        return max(0, self._seq - self.capacity)

    def clear(self) -> None:
        """Rewind the ring (tests, A/B legs)."""
        self._seq = 0

    # -- queries ---------------------------------------------------------

    def events(self, last: Optional[int] = None) -> List[Dict[str, Any]]:
        """The retained events, oldest first, as JSON-able dicts
        (``last`` trims to the newest N)."""
        n = min(self._seq, self.capacity)
        if last is not None:
            n = min(n, int(last))
        out: List[Dict[str, Any]] = []
        for i in range(self._seq - n, self._seq):
            ev = self._buf[i % self.capacity]
            if ev is None:
                continue
            seq, ts, kind, attrs = ev
            d: Dict[str, Any] = {"seq": seq, "ts": ts, "kind": kind}
            if attrs:
                d["attrs"] = attrs
            out.append(d)
        return out

    def kinds(self) -> Dict[str, int]:
        """``{kind: count}`` over the retained events (sorted)."""
        out: Dict[str, int] = {}
        for d in self.events():
            out[d["kind"]] = out.get(d["kind"], 0) + 1
        return dict(sorted(out.items()))

    # -- the postmortem --------------------------------------------------

    def dump(self, path: Optional[str] = None, reason: str = "",
             extra_meta: Optional[dict] = None) -> Optional[str]:
        """Write the retained events as ``flightrec.jsonl``: a meta
        header line (schema, reason, recorded/dropped/capacity) and one
        sorted-key JSON object per event, atomically (tmp +
        ``os.replace``).  Returns the path, or None when disabled or no
        destination is configured.  With the default logical clock, two
        identical event sequences dump byte-identically."""
        if not self.enabled:
            return None
        if path is None:
            if not self.dump_dir:
                return None
            path = os.path.join(self.dump_dir, DUMP_NAME)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        header = {
            "type": "meta", "schema": SCHEMA, "kind": "flightrec",
            "reason": reason, "recorded": self._seq,
            "dropped": self.dropped, "capacity": self.capacity,
        }
        if extra_meta:
            header.update(extra_meta)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for d in self.events():
                f.write(json.dumps({"type": "event", **d},
                                   sort_keys=True) + "\n")
        os.replace(tmp, path)
        self.dumps += 1
        return path


def read_flightrec(path: str) -> Tuple[dict, List[dict]]:
    """Parse a :meth:`FlightRecorder.dump` file back into ``(meta,
    events)`` (a directory resolves to its ``flightrec.jsonl``)."""
    if os.path.isdir(path):
        path = os.path.join(path, DUMP_NAME)
    meta: dict = {}
    events: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("type") == "meta":
                meta = d
            else:
                events.append(d)
    return meta, events


NULL_FLIGHTREC = FlightRecorder(capacity=1, enabled=False)

_DEFAULT: Optional[FlightRecorder] = None


def default_flightrec() -> FlightRecorder:
    """The ambient recorder the package's instrumentation writes to —
    :data:`NULL_FLIGHTREC` whenever obs is disabled (checked per call)."""
    global _DEFAULT
    if not obs_enabled():
        return NULL_FLIGHTREC
    if _DEFAULT is None:
        _DEFAULT = FlightRecorder(enabled=True)
    return _DEFAULT


def reset_default_flightrec() -> None:
    """Drop the ambient recorder (tests, A/B legs)."""
    global _DEFAULT
    _DEFAULT = None
