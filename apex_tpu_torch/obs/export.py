"""Trace exporters: JSONL event log, Chrome/Perfetto JSON, OpenMetrics.

Counterpart of ``apex_tpu/obs/export.py``, with the same formats, schema
and metric names, so each package reads the other's files.  Three
formats, one tracer:

- **JSONL** (``trace.jsonl``): one JSON object per line: a ``meta``
  header, every span (``ts``/``dur`` in clock ns), every instant/counter
  event, optionally an SLO report, the flight recorder's ring and a
  final ``metrics`` line holding a
  :class:`~apex_tpu_torch.obs.metrics.MetricsRegistry` snapshot.
- **Chrome trace** (``trace.chrome.json``): the ``trace_event`` format
  (``chrome://tracing`` / Perfetto UI): spans as complete ``"ph": "X"``
  events (µs timestamps), counters as ``"ph": "C"`` series, spans
  inside which a kernel library was built or loaded carrying
  ``args.compiles``.
- **OpenMetrics text** (:func:`to_openmetrics`): the Prometheus scrape
  format: every registry counter/gauge/histogram (histograms as
  summaries with exact nearest-rank quantile labels) and the live
  :class:`~apex_tpu_torch.obs.slo.SloReport` objectives as labeled
  gauges, ``# EOF`` terminated, names sorted so two identical
  registries expose byte-identical text.  ``labels=`` stamps a base
  label set (a fleet host's ``host`` and ``role``) on every series.
  JAX's ``eof=`` and compiled-program ``census=`` serve its live fleet
  aggregator and cost census, not ported yet.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

from apex_tpu_torch.obs.metrics import MetricsRegistry

__all__ = ["SCHEMA", "export_default", "read_jsonl", "to_openmetrics",
           "write_chrome_trace", "write_flightrec_line", "write_jsonl",
           "write_openmetrics", "write_slo_line"]

SCHEMA = "apex_tpu.obs.v1"


def _span_lines(tracer):
    for sp in tracer.spans:
        yield sp.to_dict()
    for ts, kind, name, payload in tracer.events:
        d = {"type": kind, "name": name, "ts": ts}
        if kind == "counter":
            d["value"] = payload
        elif payload:
            d["attrs"] = payload
        yield d


def write_jsonl(tracer, path: str,
                registry: Optional[MetricsRegistry] = None,
                extra_meta: Optional[dict] = None,
                slo_report=None, flightrec=None) -> str:
    """Write the tracer's spans/events (+ optional registry snapshot)
    as one JSON object per line; returns ``path``.  ``extra_meta`` keys
    are merged into the meta header.  ``slo_report`` (an
    :class:`~apex_tpu_torch.obs.slo.SloReport`) lands as a ``{"type":
    "slo"}`` line; ``flightrec`` (a
    :class:`~apex_tpu_torch.obs.flightrec.FlightRecorder`) as ONE
    ``{"type": "flightrec"}`` line carrying the ring's retained events,
    the trace artifact's copy of the black box."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        header = {
            "type": "meta", "schema": SCHEMA,
            "clock": "perf_counter_ns", "compiles": tracer.compiles,
        }
        if extra_meta:
            header.update(extra_meta)
        f.write(json.dumps(header) + "\n")
        for d in _span_lines(tracer):
            f.write(json.dumps(d, default=str) + "\n")
        if slo_report is not None:
            f.write(json.dumps(
                {"type": "slo", "report": slo_report.to_dict()},
                default=float,
            ) + "\n")
        if flightrec is not None and flightrec.enabled:
            f.write(json.dumps(
                {"type": "flightrec", "recorded": flightrec.recorded,
                 "dropped": flightrec.dropped,
                 "events": flightrec.events()},
                sort_keys=True,
            ) + "\n")
        if registry is not None:
            f.write(json.dumps(
                {"type": "metrics", "metrics": registry.snapshot()},
                default=float,
            ) + "\n")
    os.replace(tmp, path)
    return path


def write_slo_line(path: str, slo_report) -> str:
    """Append one ``{"type": "slo"}`` line to an existing trace.jsonl
    (the format is line-appendable by design) — how a capture that
    exported through :func:`export_default` attaches its SLO snapshot
    afterwards."""
    with open(path, "a") as f:
        f.write(json.dumps(
            {"type": "slo", "report": slo_report.to_dict()},
            default=float,
        ) + "\n")
    return path


def write_flightrec_line(path: str, flightrec) -> str:
    """Append one ``{"type": "flightrec"}`` line (the recorder's
    retained ring) to an existing trace.jsonl — the black box rides
    the line-appendable trace artifact exactly like the SLO
    snapshot."""
    with open(path, "a") as f:
        f.write(json.dumps(
            {"type": "flightrec", "recorded": flightrec.recorded,
             "dropped": flightrec.dropped,
             "events": flightrec.events()},
            sort_keys=True,
        ) + "\n")
    return path


def read_jsonl(path: str):
    """Parse a :func:`write_jsonl` file back into ``(events, metrics)``
    — events as the list of per-line dicts (meta line included),
    metrics as the final snapshot dict (or None)."""
    events, metrics = [], None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("type") == "metrics":
                metrics = d.get("metrics")
            else:
                events.append(d)
    return events, metrics


def write_chrome_trace(tracer, path: str,
                       registry: Optional[MetricsRegistry] = None) -> str:
    """Write a ``trace_event``-format JSON (Chrome/Perfetto UI);
    returns ``path``.  Timestamps/durations are µs (the format's unit);
    span nesting is reconstructed by the viewer from containment, which
    the single-threaded tracer guarantees."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    events = []
    for sp in tracer.spans:
        ev = {
            "name": sp.name, "ph": "X", "pid": 0, "tid": 0,
            "ts": sp.t0 / 1e3, "dur": sp.dur / 1e3,
            "cat": "apex_tpu",
        }
        args = dict(sp.attrs) if sp.attrs else {}
        if sp.compiles:
            args["compiles"] = sp.compiles
        if args:
            ev["args"] = args
        events.append(ev)
    for ts, kind, name, payload in tracer.events:
        if kind == "counter":
            events.append({
                "name": name, "ph": "C", "pid": 0, "tid": 0,
                "ts": ts / 1e3, "args": {"value": payload},
            })
        else:
            events.append({
                "name": name, "ph": "i", "pid": 0, "tid": 0,
                "ts": ts / 1e3, "s": "t",
                **({"args": payload} if payload else {}),
            })
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"schema": SCHEMA, "compiles": tracer.compiles}}
    if registry is not None:
        doc["otherData"]["metrics"] = registry.snapshot()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=float)
    os.replace(tmp, path)
    return path


def export_default(out_dir: str) -> Optional[dict]:
    """Export the ambient tracer + registry into ``out_dir`` as
    ``trace.jsonl`` / ``trace.chrome.json`` / ``metrics.json``.  No-op
    (returns None) when obs is disabled or nothing was recorded."""
    from apex_tpu_torch.obs.trace import (default_registry, default_tracer,
                                         enabled)

    if not enabled():
        return None
    tracer = default_tracer()
    if not tracer.spans and not tracer.events:
        return None
    registry = default_registry()
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "jsonl": write_jsonl(
            tracer, os.path.join(out_dir, "trace.jsonl"),
            registry=registry,
        ),
        "chrome": write_chrome_trace(
            tracer, os.path.join(out_dir, "trace.chrome.json"),
            registry=registry,
        ),
        "metrics": os.path.join(out_dir, "metrics.json"),
    }
    registry.to_json(paths["metrics"])
    return paths


# ---------------------------------------------------------------------------
# OpenMetrics text exposition
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_QUANTILES = (0.5, 0.9, 0.99)


def _om_name(name: str, prefix: str = "apex_tpu_") -> str:
    n = _NAME_RE.sub("_", name)
    if not n or not (n[0].isalpha() or n[0] == "_"):
        n = "_" + n
    return prefix + n


def _om_num(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _om_labels(base: Optional[dict], extra: Optional[dict] = None) -> str:
    """A merged ``{k="v",...}`` label block ('' without labels)."""
    items = list((base or {}).items()) + list((extra or {}).items())
    if not items:
        return ""

    def esc(v) -> str:
        return str(v).replace("\\", "\\\\").replace('"', '\\"')

    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in items) + "}"


def to_openmetrics(registry: Optional[MetricsRegistry] = None,
                   slo_report=None, prefix: str = "apex_tpu_",
                   labels: Optional[dict] = None) -> str:
    """Render a registry snapshot (+ optional
    :class:`~apex_tpu_torch.obs.slo.SloReport`) in the OpenMetrics text
    format: counters as ``<name>_total``, gauges as gauges (running max
    as ``<name>_max``), histograms as summaries with exact nearest-rank
    ``quantile`` labels plus ``_count``/``_sum``, SLO objectives as
    labeled ``slo_*`` gauges (current window quantile, threshold, burn
    rates, alert state) and the lifecycle summary as
    ``slo_lifecycle_*`` gauges.  ``labels`` stamps a base label set on
    every series, merged with per-series labels such as ``quantile``.
    Names sort, so the text is deterministic."""
    lines = []
    ls = _om_labels(labels)
    if registry is not None:
        for name in registry.names():
            m = registry.get(name)
            om = _om_name(name, prefix)
            snap = m.snapshot()
            kind = snap.get("type")
            if kind == "counter":
                lines.append(f"# TYPE {om} counter")
                lines.append(f"{om}_total{ls} {_om_num(snap['value'])}")
            elif kind == "gauge":
                lines.append(f"# TYPE {om} gauge")
                lines.append(f"{om}{ls} {_om_num(snap['value'])}")
                lines.append(f"# TYPE {om}_max gauge")
                lines.append(f"{om}_max{ls} {_om_num(snap['max'])}")
            elif kind == "histogram":
                lines.append(f"# TYPE {om} summary")
                if snap.get("count"):
                    for q in _QUANTILES:
                        ql = _om_labels(labels, {"quantile": f"{q:g}"})
                        lines.append(f"{om}{ql} {_om_num(m.quantile(q))}")
                    lines.append(f"{om}_sum{ls} {_om_num(snap['sum'])}")
                lines.append(f"{om}_count{ls} {snap.get('count', 0)}")
    if slo_report is not None:
        base = prefix + "slo_objective"
        for field in ("current", "threshold", "burn_fast", "burn_slow",
                      "alerting", "window_count"):
            lines.append(f"# TYPE {base}_{field} gauge")
            for row in slo_report.objectives:
                rl = _om_labels(labels, {"objective": row["name"],
                                         "metric": row["metric"]})
                v = row.get(field)
                if field == "alerting":
                    v = 1 if v else 0
                if v is None:
                    continue
                lines.append(f"{base}_{field}{rl} {_om_num(v)}")
        lc = slo_report.lifecycle or {}
        for k in sorted(lc):
            om = _om_name("slo_lifecycle_" + k, prefix)
            lines.append(f"# TYPE {om} gauge")
            lines.append(f"{om}{ls} {_om_num(lc[k])}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_openmetrics(path: str,
                      registry: Optional[MetricsRegistry] = None,
                      slo_report=None, labels: Optional[dict] = None) -> str:
    """Write :func:`to_openmetrics` output to ``path`` atomically (tmp +
    ``os.replace``); returns ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(to_openmetrics(registry, slo_report, labels=labels))
    os.replace(tmp, path)
    return path
