"""Self-healing training: the resilient shell around the K-step driver.

Counterpart of ``apex_tpu/resilience/train.py``.  The port already owns
the two recovery primitives: bitwise window-boundary checkpoints with
SHA-256 digests (:mod:`apex_tpu_torch.checkpoint`, the previous good
step kept) and deterministic windows (the carry holds the masters, the
optimizer and scaler state and the generators, so re-running a window
from a restored boundary reproduces it bit for bit).  This module turns
them into a self-healing loop:

- **bounded retry with backoff and seeded jitter** around every
  dispatch: an injected or transient
  :class:`~apex_tpu_torch.resilience.faults.DispatchFailure` fires before
  the window launches anything, so the carry is intact and the retry
  runs the same launches on the same inputs;
- **a per-dispatch watchdog**: a window whose wall (its host read of
  the meters included) passes ``watchdog_s`` trips
  ``resilience.watchdog_trips`` and a tracer instant;
- **a non-finite sentry** over the window's host-read meters: a NaN or
  Inf rolls the run back to the last good checkpoint and replays the
  windows since, so a faulted run's final carry equals the clean run's
  bit for bit;
- **preemption recovery**: a :class:`HostPreemption` drops the driver's
  host state (:meth:`FusedTrainDriver.reset_programs`), restores the
  last good checkpoint and resumes.

Two things the eager port does differently from JAX, by nature:

- the restore template.  JAX captures ``ShapeDtypeStruct``\\ s before
  the first donation; here every tensor leaf of the template is a
  one-element stand-in expanded to the leaf's shape, dtype and device,
  so it aliases nothing a window updates in place (the optimizers
  update with ``_foreach_*_``).  A ``torch.Generator`` leaf is the live
  generator itself: the restore ``set_state``\\ s it.  A step that
  draws dropout must therefore read its generator from the carry, not
  from a closure, or a replayed window draws other masks;
- ``on_restore(carry)``.  JAX's carry holds the compute params; under
  O2 the port's half copy lives in the model, outside the carry
  (:mod:`apex_tpu_torch.train.driver`), so a restore that does not call
  ``AmpOptimizer.copy_to_model(model, masters)`` replays from stale
  weights.  The hook runs after every rollback and restart restore,
  before the replayed window.

Every recovery lands in the ``resilience.*`` counters and the
``resilience.recovery_ms`` histogram; the flight recorder is dumped
with reason ``retry_budget_exceeded``, ``nan_rollback`` or
``preemption``.  ``enabled=False`` makes the wrapper a transparent
pass-through: no checkpoint, no retry, no rollback, faults propagate.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import obs
from apex_tpu_torch.resilience.faults import (DispatchFailure, FaultInjector,
                                              FaultPlan, HostPreemption,
                                              resilience_default)
from apex_tpu_torch.train.driver import read_metrics

__all__ = ["NonFiniteMeters", "ResilientTrainDriver", "RetryBudgetExceeded"]

_MS = 1e-6  # ns -> ms


class NonFiniteMeters(RuntimeError):
    """The window's host-read meters hold a NaN or Inf: the sentry's
    signal to roll back (it surfaces only with healing off)."""

    def __init__(self, window: int, metrics: Dict[str, float]):
        bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
        super().__init__(f"non-finite meters at window {window}: {bad}")
        self.window = window
        self.metrics = metrics


class RetryBudgetExceeded(RuntimeError):
    """A window kept failing past ``max_retries``: healing gave up."""


def restore_template(carry: Any) -> Any:
    """The carry's restore template: the same structure, each tensor a
    one-element stand-in expanded to the leaf's shape, dtype and device
    (aliasing no live tensor), each generator the live one."""
    if isinstance(carry, torch.Tensor):
        return carry.new_empty(()).expand(carry.shape)
    if isinstance(carry, Mapping):
        return {k: restore_template(v) for k, v in carry.items()}
    if isinstance(carry, tuple) and hasattr(carry, "_fields"):
        return type(carry)(*(restore_template(v) for v in carry))
    if isinstance(carry, (list, tuple)):
        return type(carry)(restore_template(v) for v in carry)
    return carry  # generators (restored in place), None


class ResilientTrainDriver:
    """Watchdog, retry and rollback shell over a ``FusedTrainDriver``.

    Args:
      driver: the :class:`~apex_tpu_torch.train.FusedTrainDriver` to
        protect.
      ckpt_dir: checkpoint directory (crash-safe saves through
        :meth:`FusedTrainDriver.save`; the previous good step is kept).
      watchdog_s: per-dispatch wall threshold; exceeding it trips
        ``resilience.watchdog_trips`` (detection only: the window has
        already run).
      max_retries: dispatch retries per window before giving up.
      backoff_s / jitter_seed: exponential backoff base (doubling per
        attempt) plus seeded jitter in [0, ``backoff_s``).
      checkpoint_every: windows between checkpoint saves (1: every
        boundary, the tightest rollback).
      keep: checkpoints kept (at least 2: the newest and the one before).
      sentry: meter names the non-finite sentry watches (None: every
        scalar meter of the window).
      fault_plan / injector: deterministic chaos; a plan is wrapped in a
        :class:`FaultInjector` on this wrapper's registry, tracer and
        recorder.
      registry / tracer: obs destinations (None: the ambient ones).
      enabled: the switch (None: on; see :func:`resilience_default`).
      flightrec: the recorder dumped on every rollback and restart and
        when the retry budget runs out (None: the ambient one).
      on_restore: ``on_restore(carry)``, called with the restored carry
        after every rollback and restart restore, before the replayed
        window: the place for ``AmpOptimizer.copy_to_model(model,
        carry[0])``, the counterpart of JAX's carry holding the compute
        params.

    ``run(carry, n_windows)`` drives ``n_windows`` windows (closure data,
    or ``window_source(w) -> batches``) and returns ``(carry, report)``.
    """

    def __init__(
        self,
        driver,
        ckpt_dir: str,
        *,
        watchdog_s: Optional[float] = None,
        max_retries: int = 3,
        backoff_s: float = 0.02,
        jitter_seed: int = 0,
        checkpoint_every: int = 1,
        keep: int = 3,
        sentry: Optional[Tuple[str, ...]] = None,
        fault_plan: Optional[FaultPlan] = None,
        injector: Optional[FaultInjector] = None,
        registry=None,
        tracer=None,
        enabled: Optional[bool] = None,
        flightrec=None,
        on_restore: Optional[Callable[[Any], None]] = None,
    ):
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.driver = driver
        self.ckpt_dir = str(ckpt_dir)
        self.watchdog_s = watchdog_s
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self._jitter = np.random.RandomState(jitter_seed)
        self.checkpoint_every = int(checkpoint_every)
        self.keep = max(2, int(keep))
        self.sentry = tuple(sentry) if sentry is not None else None
        self.enabled = resilience_default(enabled)
        self.on_restore = on_restore
        self.registry = obs.default_registry() if registry is None \
            else registry
        self.tracer = obs.default_tracer() if tracer is None else tracer
        self._fr = obs.default_flightrec() if flightrec is None \
            else flightrec
        if injector is None and fault_plan is not None:
            injector = FaultInjector(fault_plan, registry=self.registry,
                                     tracer=self.tracer, flightrec=self._fr)
        self.injector = injector
        m = self.registry
        self._c_retries = m.counter("resilience.retries")
        self._c_rollbacks = m.counter("resilience.rollbacks")
        self._c_restarts = m.counter("resilience.restarts")
        self._c_watchdog = m.counter("resilience.watchdog_trips")
        self._c_saves = m.counter("resilience.checkpoint_saves")
        self._h_recovery = m.histogram("resilience.recovery_ms")
        self._last_good: int = 0

    # -- accounting properties -------------------------------------------

    @property
    def retries(self) -> int:
        return self._c_retries.value

    @property
    def rollbacks(self) -> int:
        return self._c_rollbacks.value

    @property
    def restarts(self) -> int:
        return self._c_restarts.value

    @property
    def watchdog_trips(self) -> int:
        return self._c_watchdog.value

    # -- internals -------------------------------------------------------

    def _save(self, carry: Any, window: int) -> None:
        k = self.driver.steps_per_dispatch
        self.driver.save(self.ckpt_dir, carry, step=window * k,
                         keep=self.keep)
        self._c_saves.inc()
        self._last_good = window

    def _restore(self, template: Any) -> Tuple[Any, int]:
        """Back to the newest verified checkpoint, then ``on_restore``;
        returns ``(carry, window)``."""
        carry, step = self.driver.restore(self.ckpt_dir, template)
        if self.on_restore is not None:
            self.on_restore(carry)
        return carry, step // self.driver.steps_per_dispatch

    def _sentry_check(self, window: int, metrics: Dict[str, float]) -> None:
        names = self.sentry if self.sentry is not None else metrics.keys()
        for name in names:
            v = metrics.get(name)
            if isinstance(v, float) and not math.isfinite(v):
                raise NonFiniteMeters(window, metrics)

    def _backoff(self, attempt: int) -> None:
        base = self.backoff_s * (2 ** attempt)
        time.sleep(base + float(self._jitter.rand()) * self.backoff_s)

    # -- the resilient loop ----------------------------------------------

    def run(
        self,
        carry: Any,
        n_windows: int,
        *,
        window_source: Optional[Callable[[int], Any]] = None,
        on_window: Optional[Callable[[int, Dict[str, float]], None]] = None,
    ) -> Tuple[Any, Dict[str, int]]:
        """Drive ``n_windows`` windows under the healing policy.

        ``window_source(w)`` must be deterministic in ``w`` (a rollback
        replays windows).  ``on_window(w, metrics)`` fires once for each
        window that finally succeeds; replayed windows fire again, in
        order, as the clean run would.  Returns ``(carry, report)``.
        """
        inj = self.injector
        if not self.enabled:
            # transparent pass-through: no checkpoints, no healing
            for w in range(n_windows):
                if inj is not None:
                    inj.before_dispatch("train/loader")
                batches = window_source(w) if window_source else None
                if inj is not None:
                    inj.before_dispatch("train/dispatch")
                carry, res = self.driver.run_window(carry, batches)
                metrics = read_metrics(res.metrics)
                if inj is not None:
                    metrics = inj.corrupt_meters("train/meters", metrics)
                self._sentry_check(w, metrics)
                if on_window is not None:
                    on_window(w, metrics)
            return carry, self.report()

        template = restore_template(carry)
        self._save(carry, 0)  # the window-0 boundary: the rollback floor
        w = 0
        while w < n_windows:
            if inj is not None:
                inj.before_dispatch("train/loader")
            batches = window_source(w) if window_source else None
            attempt = 0
            while True:
                try:
                    if inj is not None:
                        inj.before_dispatch("train/dispatch")
                    t0 = time.perf_counter_ns()
                    with self.tracer.span("resilience/window", window=w,
                                          attempt=attempt):
                        carry2, res = self.driver.run_window(carry, batches)
                        metrics = read_metrics(res.metrics)
                    dt_s = (time.perf_counter_ns() - t0) * 1e-9
                    if self.watchdog_s is not None and dt_s > self.watchdog_s:
                        self._c_watchdog.inc()
                        self.tracer.instant("resilience/watchdog_trip",
                                            window=w, wall_s=round(dt_s, 4))
                    if inj is not None:
                        metrics = inj.corrupt_meters("train/meters", metrics)
                    self._sentry_check(w, metrics)
                    carry = carry2
                    break
                except DispatchFailure:
                    # fired before the dispatch: the carry is intact
                    if attempt >= self.max_retries:
                        self._fr.dump(reason="retry_budget_exceeded")
                        raise RetryBudgetExceeded(
                            f"window {w} failed {attempt + 1} times")
                    self._c_retries.inc()
                    self.tracer.instant("resilience/retry", window=w,
                                        attempt=attempt)
                    if self._fr.enabled:
                        self._fr.record("resilience/retry", window=w,
                                        attempt=attempt)
                    self._backoff(attempt)
                    attempt += 1
                except NonFiniteMeters:
                    # poisoned meters: distrust everything since the last
                    # good boundary (the window updated the carry in
                    # place), restore it and replay
                    self._fr.dump(reason="nan_rollback")
                    t0 = time.perf_counter_ns()
                    carry, w = self._restore(template)
                    self._c_rollbacks.inc()
                    self._h_recovery.observe(
                        (time.perf_counter_ns() - t0) * _MS)
                    self.tracer.instant("resilience/rollback", to_window=w)
                    if self._fr.enabled:
                        self._fr.record("resilience/rollback", to_window=w)
                    batches = window_source(w) if window_source else None
                    attempt = 0
                except HostPreemption:
                    # the host died: rebuild from durable state
                    self._fr.dump(reason="preemption")
                    t0 = time.perf_counter_ns()
                    self.driver.reset_programs()
                    carry, w = self._restore(template)
                    self._c_restarts.inc()
                    self._h_recovery.observe(
                        (time.perf_counter_ns() - t0) * _MS)
                    self.tracer.instant("resilience/restart", to_window=w)
                    if self._fr.enabled:
                        self._fr.record("resilience/restart", to_window=w)
                    batches = window_source(w) if window_source else None
                    attempt = 0
            w += 1
            if w % self.checkpoint_every == 0 or w == n_windows:
                self._save(carry, w)
            if on_window is not None:
                on_window(w - 1, metrics)
        if inj is not None:
            inj.release_pressure()
        return carry, self.report()

    def report(self) -> Dict[str, int]:
        """The recovery ledger as plain ints (the registry holds the same
        values and the ``recovery_ms`` distribution)."""
        return {
            "retries": self.retries,
            "rollbacks": self.rollbacks,
            "restarts": self.restarts,
            "watchdog_trips": self.watchdog_trips,
            "checkpoint_saves": self._c_saves.value,
            "last_good_window": self._last_good,
        }
