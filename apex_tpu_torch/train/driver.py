"""K training steps per window, with on-device meters and one host read.

Counterpart of ``apex_tpu/train/driver.py``.  ``step_fn(carry, batch) ->
(carry, metrics)`` is the user's one-step function; ``carry`` is any
state it threads (master weights, ``AmpOptState`` with the loss-scaler
state, generators) and ``metrics`` a flat dict of 0-d tensors.  A window
runs ``step_fn`` K times; each declared meter (``mean``, ``sum``,
``last``, ``max``, ``min``) accumulates in fp32 on the device, and
nothing in the window reads a device value on the host, so the host
queues work ahead of the card.  :func:`read_metrics` makes the window's
one host read.

JAX compiles the window into one donated ``lax.scan`` dispatch; PyTorch
runs eagerly, so here a window is a Python loop over the same step, the
same function of the same state.  A
:class:`~apex_tpu_torch.train.accum.MicrobatchedStep` in place of
``step_fn`` makes each step consume M microbatches with the gradient
accumulated on the device (:mod:`apex_tpu_torch.train.accum`).
:meth:`FusedTrainDriver.save` and :meth:`FusedTrainDriver.restore`
checkpoint the carry at a window boundary
(:mod:`apex_tpu_torch.checkpoint`); a carry with the masters, the
``AmpOptState`` (scaler state included) and the dropout generator
resumes bit for bit, once the resumed run has called
``AmpOptimizer.copy_to_model`` (the model's half copy is not in the
carry).

A data-parallel window runs one driver per process: each rank's driver
steps its own replica of the carry on its own shard of the batch, and
``step_fn`` makes the collectives (``ddp.allreduce`` of the gradients,
or ``amp_microbatch_step(ddp=)``'s one all-reduce a boundary; the
SyncBatchNorms' own).

With a ``mesh`` (:func:`apex_tpu_torch.parallel.make_mesh`) the driver
plays JAX's ``shard_map`` around the window, still one driver per rank:
a batched window holds the global batch on every rank, and each rank
steps on its block of it by ``batch_spec`` (a
:class:`~apex_tpu_torch.parallel.mesh.P` or a tree of them over the
per-step batch; default ``P(axis_name)``, the leading dimension split
over ``axis_name``).  ``carry_spec`` (a tree of ``P``, a prefix of the
carry; default all replicated) marks the carry leaves that are
rank-local shards, as ZeRO's and FSDP's state are
(``accum.zero_state_spec``, ``fsdp_param_spec``, ``fsdp_state_spec``),
or a :class:`~apex_tpu_torch.sharding.RulesTable`
(``sharding.train_state_rules``), matched over the carry it is given
(``sharding.carry_spec_from_rules``): :meth:`FusedTrainDriver.save` and
:meth:`~FusedTrainDriver.restore` then keep each rank's carry in a
directory of its own (``checkpoint.save_checkpoint(process_local=True)``:
``<path>/process_<rank>``), since no rank holds the whole state.  The
metrics are the step's own on each rank (the steps of this package
return the same loss, scale and skip flag on every rank).

Telemetry (:mod:`apex_tpu_torch.obs`), as in JAX: each window runs in a
``train/dispatch`` span of the ambient tracer (K and the microbatch
count as attrs; a kernel library built or loaded inside it counts on
the span), preceded by a ``train/dispatch`` flight-recorder event, and
its host wall lands in the ambient registry (``train.dispatch_ms``,
``train.dispatches``, ``train.steps``); :meth:`FusedTrainDriver.save`
and :meth:`~FusedTrainDriver.restore` run in ``train/checkpoint_save``
and ``train/checkpoint_restore`` spans with their recorder events, and
:func:`read_metrics` lands the meters in a registry when given one.
The window's wall is the host's: the eager loop's launches are queued,
and no span waits for the card.  Not ported yet: CUDA graphs around
the window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, Iterable, Mapping, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

from apex_tpu_torch import checkpoint, obs
from apex_tpu_torch.parallel.mesh import Mesh, P
from apex_tpu_torch.train.accum import MicrobatchedStep, _index, build_opt_step

__all__ = ["DEFAULT_STEPS_PER_DISPATCH", "FusedTrainDriver", "WindowResult",
           "read_metrics"]

DEFAULT_STEPS_PER_DISPATCH = 10
_REDUCTIONS = ("mean", "sum", "last", "max", "min")


class WindowResult(NamedTuple):
    """Device-side results of one window: ``metrics`` the finalized fp32
    0-d meters, ``per_step`` the (K,) traces of the names asked for."""

    metrics: Dict[str, torch.Tensor]
    per_step: Dict[str, torch.Tensor]


def read_metrics(tree: Any, registry: Optional[obs.MetricsRegistry] = None,
                 prefix: str = "train.") -> Any:
    """ONE device-to-host read of a dict (or :class:`WindowResult`) of
    tensors: 0-d tensors come back as floats, others as lists.  With a
    ``registry``, each float of a dict also lands in a
    ``<prefix><name>`` histogram."""
    if isinstance(tree, WindowResult):
        return WindowResult(read_metrics(tree.metrics),
                            read_metrics(tree.per_step))
    items = list(tree.items())
    if not items:
        return {}
    flat = torch.cat([v.detach().float().reshape(-1) for _, v in items])
    host = flat.cpu().tolist()
    out, i = {}, 0
    for k, v in items:
        n = v.numel()
        out[k] = host[i] if v.dim() == 0 else host[i:i + n]
        i += n
    if registry is not None:
        for name, v in out.items():
            if isinstance(v, float):
                registry.histogram(prefix + name).observe(v)
    return out


def _acc_init(reduction: str, like: torch.Tensor) -> torch.Tensor:
    fill = {"max": -float("inf"), "min": float("inf")}.get(reduction, 0.0)
    return torch.full((), fill, dtype=torch.float32, device=like.device)


def _acc_update(acc: torch.Tensor, val: torch.Tensor,
                reduction: str) -> torch.Tensor:
    v = val.detach().float()
    if reduction in ("mean", "sum"):
        return acc + v
    if reduction == "last":
        return v
    if reduction == "max":
        return torch.maximum(acc, v)
    return torch.minimum(acc, v)


def _window_len(batches: Any) -> int:
    if isinstance(batches, torch.Tensor):
        return batches.shape[0]
    leaves = [_window_len(v) for v in (batches.values()
                                       if isinstance(batches, Mapping)
                                       else batches)]
    if not leaves or any(n != leaves[0] for n in leaves):
        raise ValueError(f"window leaves disagree on the leading (step) "
                         f"axis: {leaves}")
    return leaves[0]


@dataclasses.dataclass
class FusedTrainDriver:
    """Run ``step_fn`` in windows of K steps.

    Args:
      step_fn: ``(carry, batch) -> (carry, metrics)``, ``metrics`` a flat
        dict of 0-d tensors; ``batch`` is None when the window runs on
        closure-captured data.  Or a
        :class:`~apex_tpu_torch.train.accum.MicrobatchedStep`: each step
        then consumes M microbatches, and a batched window carries a
        leading axis of K * M microbatches.
      steps_per_dispatch: K (None: :data:`DEFAULT_STEPS_PER_DISPATCH`).
      metrics: ``{name: reduction}``; undeclared names are ``mean``.
      per_step: names also returned as (K,) traces.
      mesh / axis_name / batch_spec / carry_spec: the mesh mode (see the
        module docstring): ``batch_spec`` splits each rank's block out of
        the global batch, ``carry_spec`` (a tree of ``P`` or a
        ``RulesTable``) marks the rank-local carry leaves.
    """

    # Callable[(carry, batch) -> (carry, metrics)] | MicrobatchedStep
    step_fn: Any
    steps_per_dispatch: Optional[int] = None
    metrics: Optional[Mapping[str, str]] = None
    per_step: Sequence[str] = ()
    mesh: Optional[Mesh] = None
    axis_name: str = "data"
    batch_spec: Any = None
    carry_spec: Any = None

    def __post_init__(self):
        _check_spec(self.carry_spec, "carry_spec", rules_ok=True)
        _check_spec(self.batch_spec, "batch_spec")
        if self.mesh is None and (self.batch_spec is not None
                                  or self.carry_spec is not None):
            raise ValueError("batch_spec and carry_spec need a mesh")
        if self.steps_per_dispatch is None:
            self.steps_per_dispatch = DEFAULT_STEPS_PER_DISPATCH
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{self.steps_per_dispatch}")
        for name, red in (self.metrics or {}).items():
            if red not in _REDUCTIONS:
                raise ValueError(f"metric {name!r}: unknown reduction "
                                 f"{red!r} (expected one of {_REDUCTIONS})")
        self._accum = isinstance(self.step_fn, MicrobatchedStep)
        if self._accum:
            self._microbatches = int(self.step_fn.microbatches)
            self._step_fn = build_opt_step(self.step_fn)
        else:
            self._microbatches = 1
            self._step_fn = self.step_fn
        # the newest window's host wall, builds and loads, and K
        self.last_dispatch_ms: Optional[float] = None
        self.last_dispatch_compiles = 0
        self.last_window_k = 0

    @property
    def microbatches(self) -> int:
        """Microbatches per optimizer step (1 unless ``step_fn`` is a
        :class:`~apex_tpu_torch.train.accum.MicrobatchedStep`)."""
        return self._microbatches

    def _steps(self, batches: Any) -> int:
        """Optimizer steps in a batched window: its leading axis over M,
        which must divide it."""
        n, m = _window_len(batches), self._microbatches
        if n % m:
            raise ValueError(f"batched window leading axis ({n} "
                             f"microbatches) is not a multiple of "
                             f"microbatches={m}")
        return n // m

    def run_window(self, carry: Any, batches: Any = None
                   ) -> Tuple[Any, WindowResult]:
        """One window: ``batches`` with a leading window axis of length
        K * M (K this window's step count, M :attr:`microbatches`), or
        None for ``steps_per_dispatch`` steps on closure-captured data."""
        if batches is None:
            return self._dispatch(carry, self.steps_per_dispatch, None)
        k = self._steps(batches)
        if self.mesh is not None:
            spec = (P(self.axis_name) if self.batch_spec is None
                    else self.batch_spec)
            batches = _local(batches, spec, self.mesh.coords, self.mesh)
        return self._dispatch(carry, k, batches)

    def _dispatch(self, carry, k: int, batches):
        """One window inside its ``train/dispatch`` span, with its
        recorder event before and its host wall in the registry."""
        tracer = obs.default_tracer()
        fr = obs.default_flightrec()
        if fr.enabled:
            fr.record("train/dispatch", k=k, microbatches=self._microbatches)
        t0 = time.perf_counter_ns()
        with tracer.span("train/dispatch", k=k,
                         microbatches=self._microbatches) as sp:
            out = self._window(carry, k, batches)
        self.last_dispatch_ms = (time.perf_counter_ns() - t0) * 1e-6
        self.last_dispatch_compiles = sp.compiles
        self.last_window_k = k
        if tracer.enabled:
            reg = obs.default_registry()
            reg.counter("train.dispatches").inc()
            reg.counter("train.steps").inc(k)
            reg.histogram("train.dispatch_ms").observe(self.last_dispatch_ms)
        return out

    def _window(self, carry, k: int, batches):
        declared = dict(self.metrics or {})
        acc: Dict[str, torch.Tensor] = {}
        reductions: Dict[str, str] = {}
        traces: Dict[str, list] = {n: [] for n in self.per_step}
        mb = self._microbatches
        for i in range(k):
            batch = None
            if batches is not None:
                # a MicrobatchedStep takes its M microbatches as one slice
                batch = _index(batches, slice(i * mb, (i + 1) * mb)
                               if self._accum else i)
            carry, m = self._step_fn(carry, batch)
            if not isinstance(m, Mapping):
                raise TypeError("step_fn must return (carry, metrics) with "
                                "metrics a dict of 0-d tensors; got "
                                f"{type(m).__name__}")
            if i == 0:
                reductions = {n: declared.get(n, "mean") for n in m}
                missing = [n for n in self.per_step if n not in m]
                if missing:
                    raise KeyError(f"per_step names {missing} not in step "
                                   f"metrics {sorted(m)}")
                acc = {n: _acc_init(r, m[n]) for n, r in reductions.items()}
            acc = {n: _acc_update(acc[n], m[n], r)
                   for n, r in reductions.items()}
            for n in self.per_step:
                traces[n].append(m[n].detach().float())
        meters = {n: acc[n] / k if r == "mean" else acc[n]
                  for n, r in reductions.items()}
        return carry, WindowResult(
            metrics=meters,
            per_step={n: torch.stack(v) for n, v in traces.items()})

    def run(self, carry: Any, windows: Optional[Iterable[Any]] = None, *,
            steps: Optional[int] = None,
            on_window: Optional[Callable[[int, WindowResult], None]] = None
            ) -> Tuple[Any, int]:
        """Many windows; returns ``(carry, total_steps)``.  ``windows``
        yields stacked batches; without it, ``steps`` closure-data steps
        run in windows of K (the tail shorter).  ``on_window(done,
        result)`` follows each window: the place for a host read."""
        done = 0
        if windows is not None:
            if steps is not None:
                raise ValueError("pass either windows or steps, not both")
            for w in windows:
                steps = self._steps(w)
                carry, res = self.run_window(carry, w)
                done += steps
                if on_window is not None:
                    on_window(done, res)
            return carry, done
        if steps is None:
            raise ValueError("run() needs windows or steps")
        while done < steps:
            k = min(self.steps_per_dispatch, steps - done)
            carry, res = self._dispatch(carry, k, None)
            done += k
            if on_window is not None:
                on_window(done, res)
        return carry, done

    def reset_programs(self) -> None:
        """The restart hook of :mod:`apex_tpu_torch.resilience` (JAX's
        drops the compiled window programs, so a restarted process
        re-traces).  The eager window has no compiled program, and the
        step function, the meters' declarations and the mesh are what a
        restarted process would build again; the only per-driver host
        state is the newest window's record, which this clears.  The
        kernel libraries stay loaded in the process
        (:mod:`apex_tpu_torch.ops._build`), so a restart inside one
        process builds and loads nothing."""
        self.last_dispatch_ms = None
        self.last_dispatch_compiles = 0
        self.last_window_k = 0

    # -- checkpointing (window-boundary resume) -------------------------

    def carry_spec_for(self, carry: Any) -> Any:
        """The tree of ``P`` of ``carry``: ``carry_spec`` itself, or a
        rules table matched over the carry."""
        from apex_tpu_torch.sharding import RulesTable, carry_spec_from_rules

        if isinstance(self.carry_spec, RulesTable):
            return carry_spec_from_rules(self.carry_spec, carry, self.mesh)
        return self.carry_spec

    def save(self, path: str, carry: Any, step: int, **kw) -> str:
        """Save the carry at a window boundary under ``path/<step>``
        (``path/process_<rank>/<step>`` when the carry has rank-local
        leaves) through :func:`apex_tpu_torch.checkpoint.save_checkpoint`,
        whose keyword arguments ``kw`` takes; returns the step's
        directory."""
        fr = obs.default_flightrec()
        if fr.enabled:
            fr.record("train/checkpoint_save", step=step)
        with obs.default_tracer().span("train/checkpoint_save", step=step):
            return checkpoint.save_checkpoint(
                path, carry, step,
                process_local=_sharded(self.carry_spec_for(carry)), **kw)

    def restore(self, path: str, carry_template: Any,
                step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore a carry saved by :meth:`save` into the template's
        structure and devices; returns ``(carry, step)``.  Under O2, call
        ``AmpOptimizer.copy_to_model(model, masters)`` before the first
        step of the resumed run."""
        with obs.default_tracer().span("train/checkpoint_restore"):
            carry, step = checkpoint.restore_checkpoint(
                path, carry_template, step,
                process_local=_sharded(self.carry_spec_for(carry_template)))
        fr = obs.default_flightrec()
        if fr.enabled:
            fr.record("train/checkpoint_restore", step=step)
        return carry, step


def _is_spec_tree(spec: Any) -> bool:
    if spec is None or isinstance(spec, P):
        return True
    if isinstance(spec, Mapping):
        return all(_is_spec_tree(v) for v in spec.values())
    if isinstance(spec, (list, tuple)):
        return all(_is_spec_tree(v) for v in spec)
    return False


def _check_spec(spec: Any, what: str, rules_ok: bool = False) -> None:
    """A tree of ``P`` (None: replicated) passes, and with ``rules_ok`` a
    :class:`~apex_tpu_torch.sharding.RulesTable`; anything else raises
    ``TypeError``."""
    from apex_tpu_torch.sharding import RulesTable

    if _is_spec_tree(spec) or (rules_ok and isinstance(spec, RulesTable)):
        return
    raise TypeError(f"{what} must be a tree of P (tuples, lists, dicts, "
                    f"NamedTuples){' or a RulesTable' if rules_ok else ''}, "
                    f"got {type(spec).__name__}")


def _sharded(spec: Any) -> bool:
    """Whether any leaf of the spec tree is sharded over some axis."""
    if spec is None:
        return False
    if isinstance(spec, P):
        return any(d is not None for d in spec.dims)
    vals = spec.values() if isinstance(spec, Mapping) else spec
    return any(_sharded(v) for v in vals)


def _block(t, spec: P, coords: Mapping[str, int], mesh: Mesh):
    """This rank's block of a window leaf ``t`` (window axis first) by
    ``spec`` over the per-step dimensions."""
    for dim, axes in enumerate(spec.dims, start=1):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = 1, 0
        for a in axes:  # row-major over the named axes
            size = mesh.shape[mesh.axis_names.index(a)]
            n, i = n * size, i * size + coords[a]
        if t.shape[dim] % n:
            raise ValueError(f"batch dimension {dim - 1} of "
                             f"{tuple(t.shape[1:])} does not divide into "
                             f"{n} blocks over {axes}")
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t


def _local(batches: Any, spec: Any, coords, mesh: Mesh) -> Any:
    """The window with every leaf cut to this rank's block; a single
    ``P`` applies to every leaf."""
    if isinstance(spec, P) or spec is None:
        spec = P() if spec is None else spec
        if isinstance(batches, torch.Tensor):
            return _block(batches, spec, coords, mesh)
        if isinstance(batches, Mapping):
            return {k: _local(v, spec, coords, mesh)
                    for k, v in batches.items()}
        return type(batches)(_local(v, spec, coords, mesh) for v in batches)
    if isinstance(batches, Mapping):
        return {k: _local(batches[k], spec[k], coords, mesh)
                for k in batches}
    return type(batches)(_local(b, s, coords, mesh)
                         for b, s in zip(batches, spec))
