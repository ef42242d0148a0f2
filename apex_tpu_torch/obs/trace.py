"""Host-side span tracer: monotonic, nestable, build-attributed.

Counterpart of ``apex_tpu/obs/trace.py``.  The engine's and the train
driver's dispatch boundaries run inside spans of this tracer, under hard
constraints:

- **Host-side only.** Spans wrap host code around launches; nothing here
  launches a kernel, reads a tensor or synchronises the device, so
  instrumentation changes neither the launches nor the tokens of a run.
- **Monotonic clock.** ``time.perf_counter_ns``, as JAX's tracer uses:
  timestamps are ns since an arbitrary origin, durations exact
  differences.
- **Allocation-light.** One ``Span`` object (``__slots__``) and two
  clock reads per span; a disabled tracer costs one truthiness check and
  returns a shared no-op span.
- **Build-attributed.** JAX's tracer counts the XLA compiles that fire
  while a span is innermost.  The port compiles no program; its
  counterpart is a kernel library built or opened at first use
  (:mod:`apex_tpu_torch.ops._build`), which the tracer hears through
  :func:`~apex_tpu_torch.ops._build.add_build_listener`: each build and
  each first load lands on the innermost open span (``span.compiles``),
  so a warm span with ``compiles > 0`` is a visible anomaly.

::

    tr = Tracer()
    with tr.span("serve/decode_window", k=8) as sp:
        buf = decoder.paged_decode_window(...)
    tr.counter("serve/pages_in_use", pool.in_use)

The module-level :func:`default_tracer` and :func:`default_registry`
give the package's built-in instrumentation one ambient destination;
:func:`set_enabled` is the switch (JAX's ``APEX_TPU_OBS``: the port
reads no environment variable) that swaps the ambient tracer for
:data:`NULL_TRACER`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.obs.metrics import MetricsRegistry
from apex_tpu_torch.ops import _build

__all__ = [
    "NULL_TRACER",
    "Span",
    "Tracer",
    "default_registry",
    "default_tracer",
    "enabled",
    "reset_default",
    "set_enabled",
]

_ENABLED = True


def enabled() -> bool:
    """Whether obs instrumentation is on (default on;
    :func:`set_enabled` switches it)."""
    return _ENABLED


def set_enabled(value: bool) -> None:
    """Switch the package's telemetry on or off: the default of every
    :class:`Tracer`, :class:`~apex_tpu_torch.obs.slo.SloTracker` and
    :class:`~apex_tpu_torch.obs.flightrec.FlightRecorder` built after
    this, and the ambient tracer and recorder, read on each call."""
    global _ENABLED
    _ENABLED = bool(value)


class Span:
    """One finished (or open) span: name, [t0, t0+dur) in clock ns,
    nesting depth, free-form attrs, and the number of kernel-library
    builds and loads that fired while it was the innermost open span."""

    __slots__ = ("name", "t0", "dur", "depth", "attrs", "compiles")

    def __init__(self, name: str, t0: int, depth: int,
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.t0 = t0
        self.dur = 0
        self.depth = depth
        self.attrs = attrs
        self.compiles = 0

    def set(self, key: str, value: Any) -> None:
        """Attach/overwrite one attr on an open span."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    @property
    def compiled(self) -> bool:
        """Executed-vs-compiled tag: did a library build or load fire
        inside this span?"""
        return self.compiles > 0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "type": "span", "name": self.name, "ts": self.t0,
            "dur": self.dur, "depth": self.depth,
            "compiles": self.compiles,
        }
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NullSpan:
    """Shared no-op span: the entire cost of disabled instrumentation."""

    __slots__ = ()
    name = ""
    t0 = dur = depth = compiles = 0
    attrs = None
    compiled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager pairing one span's enter/exit with the tracer's
    open-span stack."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc):
        self._tracer._finish(self._span)
        return False


class Tracer:
    """Nestable host-side span recorder.

    Args:
      enabled: None = the ambient :func:`enabled` switch, else forced.
      clock: ns-returning monotonic callable (default
        ``time.perf_counter_ns``; tests inject a fake).
      monitor_compiles: listen to kernel-library builds and loads for
        the tracer's lifetime, so spans carry them (default on).

    Finished spans accumulate in ``.spans`` (finish order, the Chrome
    trace convention); instant/counter events in ``.events`` as ``(ts,
    kind, name, payload)`` tuples; ``.compiles`` counts every build and
    load heard.  ``close()`` stops listening; a tracer is
    single-threaded, like the schedulers it instruments.
    """

    def __init__(self, enabled: Optional[bool] = None, clock=None,
                 monitor_compiles: bool = True):
        self.enabled = _ENABLED if enabled is None else bool(enabled)
        self.clock = clock or time.perf_counter_ns
        self.spans: List[Span] = []
        self.events: List[Tuple[int, str, str, Any]] = []
        self.compiles = 0
        self._stack: List[Span] = []
        self._listening = self.enabled and monitor_compiles
        if self._listening:
            _build.add_build_listener(self._on_build)

    # -- recording -----------------------------------------------------

    def span(self, name: str, **attrs):
        """Open a nested span; use as ``with tracer.span("x") as sp:``.
        Returns the shared no-op span when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(name, self.clock(), len(self._stack), attrs or None)
        self._stack.append(sp)
        return _SpanCtx(self, sp)

    def _finish(self, sp: Span) -> None:
        sp.dur = self.clock() - sp.t0
        # tolerate exception-path unwinding out of order: pop through
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        elif sp in self._stack:
            self._stack.remove(sp)
        self.spans.append(sp)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration event (retirement, preemption, anomaly)."""
        if self.enabled:
            self.events.append(
                (self.clock(), "instant", name, attrs or None)
            )

    def counter(self, name: str, value) -> None:
        """Timestamped counter sample (page-pool use, active slots,
        queue depth)."""
        if self.enabled:
            self.events.append((self.clock(), "counter", name, value))

    def _on_build(self, kind: str, name: str) -> None:
        self.compiles += 1
        if self._stack:
            self._stack[-1].compiles += 1

    # -- lifecycle -----------------------------------------------------

    def close(self) -> None:
        """Stop listening to library builds and loads (idempotent)."""
        if self._listening:
            _build.remove_build_listener(self._on_build)
            self._listening = False

    def clear(self) -> None:
        """Drop recorded spans/events (open spans stay open)."""
        self.spans.clear()
        self.events.clear()
        self.compiles = 0

    # -- queries -------------------------------------------------------

    def span_names(self) -> Dict[str, int]:
        """``{name: count}`` over finished spans (sorted)."""
        out: Dict[str, int] = {}
        for sp in self.spans:
            out[sp.name] = out.get(sp.name, 0) + 1
        return dict(sorted(out.items()))

    def compiled_spans(self) -> List[Span]:
        """Spans inside which a library was built or loaded: the
        cold-vs-warm ledger (a warm loop's span here is the anomaly)."""
        return [sp for sp in self.spans if sp.compiles]

    # -- export (delegates; see apex_tpu_torch.obs.export) --------------

    def export_jsonl(self, path: str,
                     registry: Optional[MetricsRegistry] = None) -> str:
        from apex_tpu_torch.obs.export import write_jsonl

        return write_jsonl(self, path, registry=registry)

    def export_chrome(self, path: str,
                      registry: Optional[MetricsRegistry] = None) -> str:
        from apex_tpu_torch.obs.export import write_chrome_trace

        return write_chrome_trace(self, path, registry=registry)


NULL_TRACER = Tracer(enabled=False, monitor_compiles=False)

_DEFAULT_TRACER: Optional[Tracer] = None
_DEFAULT_REGISTRY: Optional[MetricsRegistry] = None


def default_tracer() -> Tracer:
    """The ambient tracer the package's instrumentation writes to —
    :data:`NULL_TRACER` whenever obs is disabled (checked per call, so
    :func:`set_enabled` mid-process takes effect at once)."""
    global _DEFAULT_TRACER
    if not _ENABLED:
        return NULL_TRACER
    if _DEFAULT_TRACER is None:
        _DEFAULT_TRACER = Tracer(enabled=True)
    return _DEFAULT_TRACER


def default_registry() -> MetricsRegistry:
    """The ambient metrics registry (always live: counters are cheap,
    and ``stats()``-style readers must work with tracing off)."""
    global _DEFAULT_REGISTRY
    if _DEFAULT_REGISTRY is None:
        _DEFAULT_REGISTRY = MetricsRegistry()
    return _DEFAULT_REGISTRY


def reset_default() -> None:
    """Drop the ambient tracer and registry (tests, A/B legs)."""
    global _DEFAULT_TRACER, _DEFAULT_REGISTRY
    if _DEFAULT_TRACER is not None:
        _DEFAULT_TRACER.close()
    _DEFAULT_TRACER = None
    _DEFAULT_REGISTRY = None
