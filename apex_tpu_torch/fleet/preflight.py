"""Per-host preflight: a machine-readable PASS/FAIL before admission.

Counterpart of ``apex_tpu/fleet/preflight.py``, with the same report
types (:class:`PreflightReport` serializes to the same JSON, schema
``apex_tpu.fleet.preflight.v1``), the same four check names and the same
qualification cache on the decoder.  A host whose decode window quietly
holds a half-precision accumulation, reallocates its page pool every
window, reads the device more than once a window or builds a kernel
library on a warm window would poison fleet tail latency, so the router
admits a host only after its own window passes.

JAX inspects a jaxpr, an HLO text and a compiled executable.  The port
runs eager, so each check runs the host's own warm decode window (the
paged or contiguous window that :class:`~apex_tpu_torch.serve.
GPTDecoder` dispatches at the host engine's geometry, speculative or
not, followed by its one token fetch) and watches it:

- ``precision``: a ``TorchDispatchMode`` records the window's aten ops
  and flags the rule classes of JAX's ``lint_jaxpr``, under the same
  rule names, each with the source line that issued the op: a reduction
  to a scalar with a half input or output (``half-loss-reduction``),
  ``exp`` of a half tensor (``half-softmax``), ``rsqrt`` of a half
  tensor (``half-norm-stats``), an all-reduce, reduce-scatter or
  all-gather of a half tensor (``half-psum``).  A CUDA kernel called
  through ``ctypes`` is one opaque call to the mode: what it accumulates
  in is held by its own tests (``tests/test_torch_*.py``) and by
  ``chip_smoke.py``'s kernel phases, not here;
- ``donation``: the window updates the page pool in place: every K/V
  tensor of the pool (and its scales under int8) keeps its storage
  across the window, and on CUDA ``torch.cuda.memory_allocated()``
  after the window exceeds the figure before it by less than one pool;
- ``transfers``: on CUDA, under ``torch.cuda.set_sync_debug_mode
  ("warn")``, a warm window reads the device to the host (a ``.cpu()``,
  ``.item()``, ``.tolist()`` or ``.numpy()`` on the synchronizing line)
  no more than once: the design's one token fetch.  A CPU decoder has
  no device to read, and the check says so in its ``detail``;
- ``warm_compile``: two warming windows, then a third under an
  :func:`~apex_tpu_torch.ops._build.add_build_listener` listener that
  must hear no kernel library built or loaded.  The port keeps no
  per-shape program cache (``GPTDecoder.reset_programs``), so this is
  the whole of JAX's "zero compiles" here.

A check that raises is itself a FAIL, as in JAX.
"""
from __future__ import annotations

import dataclasses
import json
import linecache
import os
import sys
import time
import warnings
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from apex_tpu_torch.ops import _build

__all__ = ["PreflightCheck", "PreflightReport", "run_preflight"]

_HALF = (torch.bfloat16, torch.float16)
# scalar-accumulation reductions (JAX's reduce_sum/max/min/prod; the mean
# is a sum there)
_REDUCTIONS = frozenset({"sum", "nansum", "mean", "prod", "amax", "amin",
                         "max", "min"})
_COLLECTIVES = ("allreduce", "all_reduce", "reduce_scatter", "all_gather")
_D2H = (".cpu()", ".item()", ".tolist()", ".numpy()")
_TORCH_DIR = os.path.dirname(torch.__file__)


@dataclasses.dataclass(frozen=True)
class PreflightCheck:
    """One named check's outcome; ``detail`` holds the violation text
    (empty when passed, unless the check has something to say)."""

    name: str
    passed: bool
    detail: str = ""


@dataclasses.dataclass
class PreflightReport:
    """Machine-readable preflight outcome for one host.

    ``passed`` is the conjunction the router gates admission on;
    ``checks`` carries the per-check verdicts for diagnostics.
    """

    host_id: Any
    checks: List[PreflightCheck]
    wall_s: float = 0.0

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)

    def failures(self) -> List[PreflightCheck]:
        return [c for c in self.checks if not c.passed]

    def to_json(self) -> str:
        return json.dumps(
            {
                "schema": "apex_tpu.fleet.preflight.v1",
                "host_id": self.host_id,
                "passed": self.passed,
                "wall_s": round(self.wall_s, 4),
                "checks": [dataclasses.asdict(c) for c in self.checks],
            },
            sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "PreflightReport":
        doc = json.loads(text)
        return cls(
            host_id=doc.get("host_id"),
            checks=[PreflightCheck(**c) for c in doc.get("checks", [])],
            wall_s=doc.get("wall_s", 0.0),
        )

    def __repr__(self) -> str:
        status = "PASS" if self.passed else (
            "FAIL:" + ",".join(c.name for c in self.failures())
        )
        return (f"PreflightReport(host={self.host_id}, {status}, "
                f"{len(self.checks)} checks, {self.wall_s:.2f}s)")


def _window(decoder, slots: int, max_len: int, page_len: int,
            paged: bool) -> Tuple[Callable[[], torch.Tensor], Any]:
    """The host's decode window on a fresh cache of the engine's
    geometry: ``(run, cache)``, where ``run()`` dispatches one window as
    the engine does (every slot active, the same decoder entry point)
    and fetches its tokens to the host, the window's one read.  Each run
    restarts the slots at length 0, so any number of runs stays inside
    ``max_len``."""
    tokens = np.zeros((slots,), np.int32)
    active = np.ones((slots,), bool)
    gen = torch.Generator(device=decoder.device)
    gen.manual_seed(0)
    if decoder.spec_enabled:
        hist = np.full((slots, decoder.spec_hist), -1, np.int32)
    if paged:
        pps = max_len // page_len
        cache = decoder.init_paged_cache(1 + slots * pps, slots, page_len)
        tables = np.arange(1, 1 + slots * pps,
                           dtype=np.int32).reshape(slots, pps)
    else:
        cache = decoder.init_cache(slots, max_len)

    def run() -> torch.Tensor:
        cache.lengths.zero_()
        gen.manual_seed(0)
        if decoder.spec_enabled and paged and decoder.spec_tree_width > 1:
            buf = decoder.paged_tree_spec_decode_window(
                cache, tables, tokens, active, hist, gen)
        elif decoder.spec_enabled and paged:
            buf = decoder.paged_spec_decode_window(
                cache, tables, tokens, active, hist, gen)
        elif decoder.spec_enabled:
            buf = decoder.spec_decode_window(cache, tokens, active, hist,
                                             gen)
        elif paged:
            buf = decoder.paged_decode_window(cache, tables, tokens,
                                              active, gen)
        else:
            buf = decoder.decode_window(cache, tokens, active, gen)
        return buf.cpu()  # the window's one device-to-host read

    return run, cache


def _where() -> str:
    """``file:line`` of the innermost frame outside torch and this
    module: the line that issued the op."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_TORCH_DIR) and fn != __file__:
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return ""


def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class _PrecisionLint(TorchDispatchMode):
    """Records each aten op of the region that breaks a half-precision
    accumulation rule (the rule classes of JAX's ``lint_jaxpr``)."""

    def __init__(self):
        super().__init__()
        self.violations: List[str] = []

    def _emit(self, rule: str, msg: str) -> None:
        where = _where()
        loc = f" [{where}]" if where else ""
        self.violations.append(f"{rule}: {msg}{loc}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip("_")
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        half_in = next((t for t in ins if t.dtype in _HALF), None)
        half_out = next((t for t in outs if t.dtype in _HALF), None)
        if name in _REDUCTIONS and (half_in is not None
                                    or half_out is not None):
            if outs and all(t.numel() == 1 for t in outs):
                t = half_out if half_out is not None else half_in
                self._emit(
                    "half-loss-reduction",
                    f"{name} collapses to a scalar with {_dt(t)} "
                    "input/output — losses accumulate in fp32 (cast after "
                    "the reduction, not before)")
        elif name == "exp" and half_in is not None:
            self._emit(
                "half-softmax",
                f"exp on {_dt(half_in)} — softmax/logsumexp statistics "
                "must be computed in fp32 (probs_bf16 rounds "
                "probabilities AFTER the fp32 normalization)")
        elif name == "rsqrt" and half_in is not None:
            self._emit(
                "half-norm-stats",
                f"rsqrt on {_dt(half_in)} — layer-norm/RMS variance paths "
                "must be fp32 (keep_batchnorm_fp32 is the same rule for BN)")
        elif any(c in name for c in _COLLECTIVES) and half_in is not None:
            self._emit(
                "half-psum",
                f"{name} accumulates {_dt(half_in)} across replicas — "
                "gradient collectives run in fp32 "
                "(DistributedDataParallel allreduce_always_fp32)")
        return out


def _precision(run) -> Tuple[List[str], str]:
    lint = _PrecisionLint()
    with lint:
        run()
    return lint.violations, ""


def _transfers(run, device) -> Tuple[List[str], str]:
    if device.type != "cuda":
        return [], f"{device.type} decoder: no device to read back"
    run()  # warm: first loads and allocations happen outside the count
    torch.cuda.synchronize(device)
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    reads = []
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        line = linecache.getline(w.filename, w.lineno)
        if any(f in line for f in _D2H):
            reads.append(f"{os.path.basename(w.filename)}:{w.lineno}")
    if len(reads) > 1:
        return [f"{len(reads)} device-to-host reads in one warm window "
                f"(the design has one, the token fetch): "
                f"{', '.join(reads)}"], ""
    return [], ""


def _pool(cache) -> Dict[str, torch.Tensor]:
    return {n: getattr(cache, n) for n in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, n, None) is not None}


def _donation(run, cache, device) -> Tuple[List[str], str]:
    before = {n: t.untyped_storage().data_ptr()
              for n, t in _pool(cache).items()}
    pool_bytes = sum(t.nbytes for t in _pool(cache).values())
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        m0 = torch.cuda.memory_allocated(device)
    run()
    errs = [f"pool tensor {n} reallocated by the window (not updated in "
            f"place)" for n, t in _pool(cache).items()
            if t.untyped_storage().data_ptr() != before.get(n)]
    if cuda:
        torch.cuda.synchronize(device)
        grew = torch.cuda.memory_allocated(device) - m0
        if grew >= pool_bytes:
            errs.append(f"device memory grew {grew} B across one window "
                        f"(a pool is {pool_bytes} B)")
    return errs, ""


def _warm_compile(run) -> Tuple[List[str], str]:
    for _ in range(2):
        run()
    heard: List[str] = []

    def listen(kind: str, name: str) -> None:
        heard.append(f"{kind} {name}")

    _build.add_build_listener(listen)
    try:
        run()
    finally:
        _build.remove_build_listener(listen)
    if heard:
        return [f"warm window built or loaded {len(heard)} kernel "
                f"librar{'y' if len(heard) == 1 else 'ies'} "
                f"({', '.join(heard)}) — shape-unstable window"], ""
    return [], ""


def run_preflight(
    decoder,
    *,
    host_id: Any = "host",
    slots: int = 2,
    max_len: int = 64,
    page_len: int = 8,
    paged: bool = True,
    warm_check: bool = True,
    use_cache: bool = True,
) -> PreflightReport:
    """Run the four checks on ``decoder``'s decode window; returns a
    :class:`PreflightReport`.

    The geometry arguments should match the engine the host will run.
    ``warm_check=False`` skips the warm-compile check's three windows.
    ``use_cache`` (default) serves a repeat qualification of the same
    decoder and model at the same geometry from the cache (stamped with
    the new ``host_id``), so a readmitted host or a second host sharing
    the fleet's decoder runs no window; ``use_cache=False`` forces a
    fresh run.
    """
    # the qualification cache, kept on the decoder and keyed by the model
    # it serves: a decoder cloned for new weights qualifies afresh
    cache = decoder.__dict__.get("_preflight_cache")
    if cache is None or cache["model"] is not decoder.model:
        cache = decoder.__dict__["_preflight_cache"] = {
            "model": decoder.model, "reports": {}}
    cache_key = (slots, max_len, page_len, paged, warm_check)
    if use_cache and cache_key in cache["reports"]:
        cached = cache["reports"][cache_key]
        return PreflightReport(host_id=host_id, checks=cached.checks,
                               wall_s=cached.wall_s)

    t0 = time.time()
    checks: List[PreflightCheck] = []
    device = torch.device(decoder.device)

    def _check(name, fn):
        try:
            errs, note = fn()
        except Exception as e:  # a crashed check is itself a FAIL
            errs, note = [f"{type(e).__name__}: {e}"], ""
        checks.append(PreflightCheck(
            name, not errs, ("; ".join(errs) or note)[:500]))

    def fresh():
        return _window(decoder, slots, max_len, page_len, paged)

    _check("precision", lambda: _precision(fresh()[0]))
    _check("transfers", lambda: _transfers(fresh()[0], device))
    _check("donation", lambda: _donation(*fresh(), device))
    if warm_check:
        _check("warm_compile", lambda: _warm_compile(fresh()[0]))

    report = PreflightReport(host_id=host_id, checks=checks,
                             wall_s=time.time() - t0)
    cache["reports"][cache_key] = report
    return report
