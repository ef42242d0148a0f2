"""apex_tpu_torch.obs — the port's host-side runtime telemetry.

Counterpart of ``apex_tpu/obs`` (its fleet and gang parts excepted).
Everything here runs on the host: instrumentation launches no kernel,
reads no tensor and synchronises nothing, so a run's launches, host
syncs and tokens are the same with it on or off.

- :mod:`~apex_tpu_torch.obs.metrics`: deterministic counters, gauges
  and exact-quantile histograms in a :class:`MetricsRegistry`
  (``ServeEngine.stats()`` is a snapshot over one of these);
- :mod:`~apex_tpu_torch.obs.trace`: the nestable :class:`Tracer`, with
  spans around the train driver's windows and checkpoints and every
  ``ServeEngine`` phase, each tagged with the kernel-library builds and
  loads that fired inside it;
- :mod:`~apex_tpu_torch.obs.lifecycle`: per-request TTFT, inter-token
  latency and queue-delay histograms from the engine's boundary
  timestamps;
- :mod:`~apex_tpu_torch.obs.slo`: sliding-window quantiles
  (:class:`WindowedHistogram`), declarative objectives with
  error-budget burn alerts (:class:`SloTracker`) and the
  :class:`SloReport` the engine's SLO-aware admission consults;
- :mod:`~apex_tpu_torch.obs.flightrec`: the bounded ring of boundary
  events (:class:`FlightRecorder`) and its postmortem dump;
- :mod:`~apex_tpu_torch.obs.export`: JSONL, Chrome/Perfetto
  ``trace_event`` JSON and OpenMetrics text.

The switch: :func:`set_enabled` (JAX's ``APEX_TPU_OBS``; the port reads
no environment variable).  With obs off, spans and events are shared
no-ops and the engine keeps no lifecycle, while its ``stats()``
counters keep counting: they are accounting, not telemetry.
"""
from apex_tpu_torch.obs.export import (  # noqa: F401
    SCHEMA,
    export_default,
    read_jsonl,
    to_openmetrics,
    write_chrome_trace,
    write_flightrec_line,
    write_jsonl,
    write_openmetrics,
    write_slo_line,
)
from apex_tpu_torch.obs.flightrec import (  # noqa: F401
    DEFAULT_CAPACITY,
    NULL_FLIGHTREC,
    FlightRecorder,
    default_flightrec,
    read_flightrec,
    reset_default_flightrec,
)
from apex_tpu_torch.obs.lifecycle import (  # noqa: F401
    NULL_LIFECYCLE,
    RequestLifecycle,
)
from apex_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from apex_tpu_torch.obs.slo import (  # noqa: F401
    SloObjective,
    SloReport,
    SloTracker,
    WindowedHistogram,
    parse_objective,
)
from apex_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    Span,
    Tracer,
    default_registry,
    default_tracer,
    enabled,
    reset_default,
    set_enabled,
)

__all__ = [
    "DEFAULT_CAPACITY",
    "SCHEMA",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_FLIGHTREC",
    "NULL_LIFECYCLE",
    "NULL_TRACER",
    "RequestLifecycle",
    "SloObjective",
    "SloReport",
    "SloTracker",
    "Span",
    "Tracer",
    "WindowedHistogram",
    "default_flightrec",
    "default_registry",
    "default_tracer",
    "enabled",
    "export_default",
    "parse_objective",
    "read_flightrec",
    "read_jsonl",
    "reset_default",
    "reset_default_flightrec",
    "set_enabled",
    "to_openmetrics",
    "write_chrome_trace",
    "write_flightrec_line",
    "write_jsonl",
    "write_openmetrics",
    "write_slo_line",
]
