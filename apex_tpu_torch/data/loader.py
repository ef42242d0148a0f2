"""ctypes binding and Python surface for the native loader.

Counterpart of ``apex_tpu/data/loader.py``.  The C++ side
(``csrc/loader.cpp``, a copy of the JAX package's source, byte for byte)
owns the worker threads, the mmap, the shuffle and batch assembly;
Python sees completed batches in the loader's ring buffers, copies them
out and recycles the buffer at once.  The library is built with g++ on
first use into ``build/apex_tpu_torch/`` (:mod:`apex_tpu_torch.ops.
_build`, which keys it on the source and the flags); a failed build
raises with g++'s output, and nothing falls back to a Python loader.
The same seed gives the same batch order as the JAX package's loader:
the shuffle is the same seeded Fisher-Yates compiled with the same
flags.

Record format: a flat binary file of fixed-size records.  The structure
WITHIN a record is the caller's contract: ``fields`` maps names to
(dtype, shape) and batches come back as a dict of CPU tensors, e.g.::

    fields = {"image": (np.uint8, (32, 32, 3)), "label": (np.int32, ())}
    write_records("train.bin", [{"image": ..., "label": ...}, ...], fields)
    for batch in NativeDataLoader("train.bin", fields, batch_size=128,
                                  shuffle=True, seed=0).epoch(0):
        ...  # batch["image"]: (128, 32, 32, 3) uint8 tensor

:class:`DevicePrefetcher` stages batches on the card ahead of the
consumer, through pinned memory on a side stream (the reference's
``data_prefetcher``, examples/imagenet/main_amp.py).
"""
from __future__ import annotations

import collections
import ctypes
import os
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch import obs
from apex_tpu_torch.multi_tensor import tree_map
from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import resolve_device

__all__ = ["DevicePrefetcher", "NativeDataLoader", "window_batches",
           "write_records"]

_lib = None


def _load_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load("loader")
    lib.ldr_open.restype = ctypes.c_void_p
    lib.ldr_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.ldr_len.restype = ctypes.c_int64
    lib.ldr_len.argtypes = [ctypes.c_void_p]
    lib.ldr_start_epoch.restype = None
    lib.ldr_start_epoch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.ldr_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ldr_next.argtypes = [ctypes.c_void_p]
    lib.ldr_release.restype = None
    lib.ldr_release.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8)]
    lib.ldr_close.restype = None
    lib.ldr_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


Fields = Dict[str, Tuple[Any, Tuple[int, ...]]]


def _record_layout(fields: Fields):
    offs, off = {}, 0
    for name, (dt, shape) in fields.items():
        nbytes = int(np.dtype(dt).itemsize * int(np.prod(shape or (1,))))
        offs[name] = (off, np.dtype(dt), tuple(shape))
        off += nbytes
    return offs, off


def _numpy(a, dt) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dt)


def write_records(path: str, samples, fields: Fields) -> int:
    """Serialize dict-samples (numpy arrays or CPU tensors) to the flat
    fixed-record format; returns the count.  The file is byte for byte
    the JAX package's."""
    offs, rec_bytes = _record_layout(fields)
    n = 0
    with open(path, "wb") as f:
        for s in samples:
            buf = bytearray(rec_bytes)
            for name, (off, dt, shape) in offs.items():
                a = _numpy(s[name], dt)
                if tuple(a.shape) != shape:
                    raise ValueError(
                        f"{name}: expected shape {shape}, got {a.shape}"
                    )
                raw = a.tobytes()
                buf[off : off + len(raw)] = raw
            f.write(bytes(buf))
            n += 1
    return n


class NativeDataLoader:
    """Epoch iterator over the native loader (drop-last batching).

    Same knobs as the reference's DataLoader usage in the examples:
    ``batch_size``, ``shuffle``, ``num_workers``, plus ``prefetch`` ring
    depth.  Deterministic per (seed, epoch) — checkpoint/resume replays
    the exact batch order.
    """

    def __init__(
        self,
        path: str,
        fields: Fields,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 3,
    ):
        self._h = None
        self._lib = _load_lib()
        self._offs, self._rec_bytes = _record_layout(fields)
        self.batch_size = batch_size
        self._h = self._lib.ldr_open(
            os.fspath(path).encode(), self._rec_bytes, batch_size,
            num_workers, prefetch, int(shuffle), seed,
        )
        if not self._h:
            raise FileNotFoundError(f"cannot open dataset {path!r}")

    def __len__(self) -> int:  # records
        return self._lib.ldr_len(self._h)

    @property
    def batches_per_epoch(self) -> int:
        return len(self) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Iterate one epoch's batches as dicts of CPU tensors.

        The tensors own COPIES of the ring buffer, which is recycled as
        soon as the copy is made (use :class:`DevicePrefetcher` for the
        transfer).  The wait for each batch runs in a ``data/next_batch``
        span of the ambient tracer."""
        tracer = obs.default_tracer()
        self._lib.ldr_start_epoch(self._h, epoch)
        flat_bytes = self.batch_size * self._rec_bytes
        while True:
            with tracer.span("data/next_batch"):
                p = self._lib.ldr_next(self._h)
            if not p:
                return
            flat = np.ctypeslib.as_array(p, shape=(flat_bytes,))
            recs = flat.reshape(self.batch_size, self._rec_bytes)
            out = {}
            for name, (off, dt, shape) in self._offs.items():
                nb = dt.itemsize * int(np.prod(shape or (1,)))
                out[name] = torch.from_numpy(
                    recs[:, off : off + nb]
                    .copy()
                    .view(dt)
                    .reshape((self.batch_size,) + shape)
                )
            self._lib.ldr_release(self._h, p)
            yield out

    def close(self):
        if self._h:
            self._lib.ldr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def window_batches(it, k: int, *, drop_last: bool = True):
    """Group per-step batches from ``it`` into K-stacked windows.

    The train driver (:mod:`apex_tpu_torch.train`) takes batches with a
    leading steps-per-dispatch axis; this stacks K host batches leaf by
    leaf (``torch.stack`` over a dict, tuple or list tree: one contiguous
    buffer per field, so the transfer is one copy per field, not K).  A
    short tail window is yielded unless ``drop_last``.  Each stack runs
    in a ``data/window`` span of the ambient tracer.
    """
    if k < 1:
        raise ValueError(f"window size must be >= 1, got {k}")
    tracer = obs.default_tracer()
    buf = []
    for batch in it:
        buf.append(batch)
        if len(buf) == k:
            with tracer.span("data/window", k=k):
                w = _stack_window(buf)
            yield w
            buf = []
    if buf and not drop_last:
        with tracer.span("data/window", k=len(buf)):
            w = _stack_window(buf)
        yield w


def _stack_window(batches):
    return tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                    *batches)


class DevicePrefetcher:
    """Stage the batches of ``it`` on ``device`` ahead of the consumer.

    ``transform`` maps each host batch (a tree of tensors or numpy
    arrays) to what the step wants before the transfer; ``depth`` is the
    number of batches staged on the device ahead of the consumer (1 =
    classic double buffering: batch N + 1's transfer is issued before
    batch N is yielded).  Each stage (transform and copy) runs in a
    ``train/prefetch`` span of the ambient tracer, with ``depth=`` the
    number of batches already staged.

    On a CUDA device it stages as the reference's ``data_prefetcher``
    (ref examples/imagenet/main_amp.py): each host tensor goes into
    pinned memory (once: a tensor already pinned is used as it is), and
    is copied with ``non_blocking=True`` on a side stream this
    prefetcher owns, followed by an event.  When a batch is yielded, the
    consumer's current stream waits on its event, so no kernel reads the
    batch before its copy ends, and each of its tensors is marked with
    ``record_stream`` on that stream, so the caching allocator does not
    hand its memory to a later copy while the consumer's kernels still
    read it.  A pinned source made here by ``pin_memory()`` is kept by
    the caching host allocator until its copy has ended; one that came
    in pinned is held by the prefetcher until its copy's event has
    passed.  On the CPU a stage is a plain ``.to(device)``.

    ``device=None`` is the card, and raises without CUDA
    (:func:`~apex_tpu_torch.ops._common.resolve_device`).  JAX's
    ``sharding`` has no counterpart here: each process stages the whole
    window and a mesh ``FusedTrainDriver`` cuts this rank's block out
    of it (``batch_spec``).
    """

    def __init__(self, it, transform=None,
                 device: Optional[Union[str, torch.device]] = None,
                 depth: int = 1):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(it)
        self._transform = transform or (lambda b: b)
        self._device = resolve_device(device)
        self._depth = depth
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)

    def _stage(self, batch):
        """``(the batch's copy on the device, the event that ends the
        copy, the pinned source)``; the last two None off CUDA."""
        if self._stream is None:
            return tree_map(lambda t: torch.as_tensor(t).to(self._device),
                             batch), None, None

        def pinned(t):
            t = torch.as_tensor(t)
            return t if t.is_pinned() else t.pin_memory()

        host = tree_map(pinned, batch)
        with torch.cuda.stream(self._stream):
            dev = tree_map(lambda t: t.to(self._device, non_blocking=True),
                            host)
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done, host

    def _hand_over(self, staged, in_flight):
        """The staged batch, ordered after its copy on the consumer's
        current stream; its pinned source joins ``in_flight``."""
        batch, done, host = staged
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            tree_map(lambda t: t.record_stream(stream), batch)
            in_flight.append((done, host))
        return batch

    def __iter__(self):
        tracer = obs.default_tracer()
        staged = collections.deque()
        # pinned sources whose copies may still run: a buffer that was
        # pinned before it got here is not the caching host allocator's
        # to guard, so it is held until its copy's event has passed
        in_flight = collections.deque()
        try:
            for batch in self._it:
                while in_flight and in_flight[0][0].query():
                    in_flight.popleft()
                with tracer.span("train/prefetch", depth=len(staged)):
                    staged.append(self._stage(self._transform(batch)))
                if len(staged) > self._depth:
                    yield self._hand_over(staged.popleft(), in_flight)
            while staged:
                yield self._hand_over(staged.popleft(), in_flight)
        finally:
            for done in [d for d, _ in in_flight] + [d for _, d, _ in staged]:
                if done is not None:
                    done.synchronize()
