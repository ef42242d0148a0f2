"""Metrics registry: counters, gauges, exact-quantile histograms.

Counterpart of ``apex_tpu/obs/metrics.py``, with the same semantics and
snapshots: host-side Python state with no dependency and no device
work.  Design constraints, in order:

- **Deterministic.** Two runs feeding identical values produce
  byte-identical snapshots: quantiles are nearest-rank over the stored
  samples (no interpolation, no randomized sketches), snapshot keys are
  sorted, and the bounded-reservoir decimation is a fixed stride (drop
  every other retained sample when full), never a random eviction.
- **Exact while small.** A :class:`Histogram` stores every observation
  until ``max_samples`` (default 65536), so quantiles are exact for any
  run that fits.  Past the bound the reservoir thins to every
  2nd/4th/... sample (deterministically), while ``count``/``sum``/
  ``min``/``max`` stay exact forever.
- **Allocation-light.** An observation is one float append; a counter
  bump is one int add.  Nothing here touches torch.

``ServeEngine`` keeps its scheduling counters here (``stats()`` is a
snapshot over this registry), :func:`apex_tpu_torch.train.read_metrics`
with a ``registry=`` lands the driver's meters here, and the request
lifecycle histograms (TTFT/ITL/queue delay,
:mod:`apex_tpu_torch.obs.lifecycle`) are plain :class:`Histogram`\\ s.

::

    reg = MetricsRegistry()
    reg.counter("serve.decode_dispatches").inc()
    reg.histogram("serve.ttft_ms").observe(12.5)
    reg.snapshot()   # JSON-able, deterministic
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

Number = Union[int, float]


class Counter:
    """Monotonic counter (int or float increments)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def snapshot(self) -> Dict[str, Number]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-value gauge with a running max (``set_max`` is the peak
    tracker the engine's ``peak_*`` stats use)."""

    __slots__ = ("name", "value", "max")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0
        self.max: Number = 0

    def set(self, v: Number) -> None:
        self.value = v
        if v > self.max:
            self.max = v

    def set_max(self, v: Number) -> None:
        """Keep ``value`` at the running maximum (peak semantics)."""
        if v > self.value:
            self.value = v
        if v > self.max:
            self.max = v

    def snapshot(self) -> Dict[str, Number]:
        return {"type": "gauge", "value": self.value, "max": self.max}


class Histogram:
    """Exact-quantile reservoir histogram.

    Stores raw observations (floats) up to ``max_samples``; quantiles
    are **nearest-rank** over the retained samples (``q(p)`` = the
    ``ceil(p*n)``-th smallest, the hand-computable definition the tests
    pin).  When the reservoir fills, every other retained sample is
    dropped and the keep-stride doubles — deterministic thinning, so a
    snapshot is a pure function of the observation sequence.  ``count``
    / ``sum`` / ``min`` / ``max`` always cover every observation.
    """

    __slots__ = ("name", "count", "sum", "min", "max", "_samples",
                 "_max_samples", "_stride", "_phase")

    def __init__(self, name: str, max_samples: int = 65536):
        if max_samples < 2:
            raise ValueError("max_samples must be >= 2")
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []
        self._max_samples = max_samples
        self._stride = 1  # keep every _stride-th observation
        self._phase = 0

    def observe(self, v: Number) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if self._phase == 0:
            self._samples.append(v)
            if len(self._samples) >= self._max_samples:
                # deterministic decimation: keep even indices, double
                # the stride — quantiles stay representative, memory
                # stays bounded
                self._samples = self._samples[::2]
                self._stride *= 2
        self._phase = (self._phase + 1) % self._stride

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over retained samples (NaN if empty)."""
        if not self._samples:
            return math.nan
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        s = sorted(self._samples)
        idx = max(0, min(len(s) - 1, math.ceil(q * len(s)) - 1))
        return s[idx]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    @property
    def exact(self) -> bool:
        """True while no observation has been thinned away."""
        return self._stride == 1

    def snapshot(self) -> Dict[str, object]:
        if not self.count:
            return {"type": "histogram", "count": 0}
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.mean,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "exact": self.exact,
        }


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Name -> metric store with get-or-create accessors.

    Each accessor returns the existing metric when the name is already
    registered (raising on a type clash) so call sites never need
    "register once" ceremony — ``reg.counter("x").inc()`` is always
    safe.  ``snapshot()`` walks names in sorted order, so two registries
    fed identical values snapshot identically.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, not a "
                f"{cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str,
                  max_samples: Optional[int] = None) -> Histogram:
        if max_samples is None:
            return self._get(Histogram, name)
        return self._get(Histogram, name, max_samples=max_samples)

    def get(self, name: str):
        """The metric under ``name``, or None."""
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """``{name: metric.snapshot()}``, names sorted — deterministic
        and ``json.dumps``-able as-is."""
        return {n: self._metrics[n].snapshot() for n in self.names()}

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        """Serialize the snapshot; also write it to ``path`` if given."""
        text = json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                          allow_nan=False, default=float)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text
