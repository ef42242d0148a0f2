"""Build the CUDA sources under ``apex_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, which :func:`load` opens with
``ctypes``.  No PyTorch header is included, so a build takes seconds,
not the minutes ``torch.utils.cpp_extension.load`` needs.

Libraries go to ``build/apex_tpu_torch/`` at the root of the checkout,
named by a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one is reused.  A build writes
a temporary file and renames it into place, so two processes building
at once never load a half-written library.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for all of them;
a failed build raises with ``nvcc``'s output.

A library built (:func:`build`) or opened (:func:`load`) is an event
that listeners added with :func:`add_build_listener` hear, as
``fn(kind, name)`` with ``kind`` ``"build"`` or ``"load"``: the
tracer of :mod:`apex_tpu_torch.obs` counts them on the innermost open
span, the port's counterpart of the XLA compiles JAX's tracer counts.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

__all__ = ["BUILD_DIR", "CSRC_DIR", "KERNEL_SOURCES", "NVCC_FLAGS",
           "add_build_listener", "build", "build_log", "library_path",
           "load", "remove_build_listener"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "apex_tpu_torch"
KERNEL_SOURCES: Tuple[str, ...] = (
    "conv_bn", "flash_attention", "fused_lamb", "layer_norm",
    "paged_attention", "softmax_xentropy")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 900

_loaded: Dict[str, ctypes.CDLL] = {}
# each entry returns its listener, or None once a weakly held one is gone
_listeners: List[Callable[[], Callable[[str, str], None]]] = []


def add_build_listener(fn: Callable[[str, str], None]) -> None:
    """Call ``fn(kind, name)`` after each library build (``"build"``) and
    each first load of a library in this process (``"load"``).  A bound
    method is held weakly, so its object can go away without removing
    it; anything else is held until :func:`remove_build_listener`."""
    if hasattr(fn, "__self__"):
        _listeners.append(weakref.WeakMethod(fn))
    else:
        _listeners.append(lambda: fn)


def remove_build_listener(fn: Callable[[str, str], None]) -> None:
    """Stop calling ``fn`` (no-op when it is not listening)."""
    _listeners[:] = [ref for ref in _listeners if ref() not in (fn, None)]


def _notify(kind: str, name: str) -> None:
    for ref in list(_listeners):
        fn = ref()
        if fn is None:
            _listeners.remove(ref)
        else:
            fn(kind, name)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content hash."""
    h = hashlib.sha256()
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every listed library that is not built yet, one ``nvcc``
    each, all started together.  Returns the seconds each build took
    (0.0 for a library already on disk)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = {}
    took: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            took[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        fh = open(log, "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        started[name] = (proc, fh, tmp, out, log, time.perf_counter())
    failures = []
    for name, (proc, fh, tmp, out, log, t0) in started.items():
        try:
            rc = proc.wait(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = None
        finally:
            fh.close()
        took[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
            _notify("build", name)
        else:
            tmp.unlink(missing_ok=True)
            failures.append(f"--- nvcc {name}.cu (exit {rc}):\n"
                            f"{log.read_text()}")
    if failures:
        raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        _notify("load", name)
    return lib


def build_log(name: str) -> str:
    """``nvcc``'s output for the current build of ``name`` (the
    ``-Xptxas -v`` register and shared-memory report), or '' when the
    library was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
