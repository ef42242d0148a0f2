"""Build the native sources under ``apex_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, which :func:`load` opens with
``ctypes``.  No PyTorch header is included, so a build takes seconds,
not the minutes ``torch.utils.cpp_extension.load`` needs.  The host
libraries of :data:`HOST_SOURCES` (``csrc/<name>.cpp``: the data
loader) compile the same way with ``g++`` and :data:`GXX_FLAGS`, the
flags the JAX package builds its copy with; they need no CUDA toolkit.

Libraries go to ``build/apex_tpu_torch/`` at the root of the checkout,
named by a hash of the source, the shared headers (CUDA sources only)
and the flags, so an edited source rebuilds and an unchanged one is
reused.  A build writes a temporary file and renames it into place, so
two processes building at once never load a half-written library.
:func:`build` starts one compiler per missing library, all at once,
and waits for all of them; a failed build raises with the compiler's
output.

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

__all__ = ["BUILD_DIR", "CSRC_DIR", "GXX_FLAGS", "HOST_SOURCES",
           "KERNEL_SOURCES", "NVCC_FLAGS", "add_build_listener", "build",
           "build_log", "library_path", "load", "remove_build_listener"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR.parent.parent / "build" / "apex_tpu_torch"
KERNEL_SOURCES: Tuple[str, ...] = (
    "conv_bn", "flash_attention", "fused_lamb", "layer_norm",
    "paged_attention", "softmax_xentropy")
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: host C++ libraries (``csrc/<name>.cpp``), built with g++
HOST_SOURCES: Tuple[str, ...] = ("loader",)
GXX_FLAGS: Tuple[str, ...] = ("-O2", "-shared", "-fPIC", "-std=c++17",
                              "-pthread")
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


def _gxx() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host libraries build with "
                           "g++")
    return path


def _route(name: str):
    """``(source, compiler lookup, flags, whether the *.cuh headers key
    the build)`` of ``name``: g++ for :data:`HOST_SOURCES`, else nvcc."""
    if name in HOST_SOURCES:
        return CSRC_DIR / f"{name}.cpp", _gxx, GXX_FLAGS, False
    return CSRC_DIR / f"{name}.cu", _nvcc, NVCC_FLAGS, True


def library_path(name: str) -> Path:
    """Where ``name``'s source builds to, keyed by its content hash (with
    the ``*.cuh`` headers for a CUDA source) and the flags."""
    src, _, flags, headers = _route(name)
    h = hashlib.sha256()
    h.update(src.read_bytes())
    if headers:
        for hdr in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Build every listed library that is not built yet, one compiler
    each (``nvcc``, or ``g++`` for :data:`HOST_SOURCES`), all started
    together.  Returns the seconds each build took (0.0 for a library
    already on disk)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(names)
    took = {name: 0.0 for name in names if library_path(name).exists()}
    missing = [name for name in names if name not in took]
    # find the compilers before starting any build, so a missing one
    # leaves no build running
    compilers = {find: find() for find in {_route(n)[1] for n in missing}}
    started = {}
    for name in missing:
        src, find, flags, _ = _route(name)
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        fh = open(log, "w")
        cmd = [compilers[find], *flags, str(src), "-o", str(tmp)]
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        started[name] = (proc, fh, tmp, out, log, time.perf_counter(),
                         f"{Path(cmd[0]).name} {src.name}")
    failures = []
    for name, (proc, fh, tmp, out, log, t0, what) in started.items():
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
            failures.append(f"--- {what} (exit {rc}):\n{log.read_text()}")
    if failures:
        raise RuntimeError("library build failed\n" + "\n".join(failures))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``'s source, built on first use."""
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
    """The compiler's output for the current build of ``name`` (for a
    CUDA source the ``-Xptxas -v`` register and shared-memory report),
    or '' when the library was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
