"""apex_tpu_torch.data — native input pipeline (threaded C++ loader +
prefetch).

Counterpart of ``apex_tpu/data``.  ref role: the reference's examples
feed the GPU through DALI pipelines or torch DataLoader worker processes
(examples/imagenet/main_amp.py); the byte-moving machinery there is C++.

- :mod:`apex_tpu_torch.data.loader` — a C++ worker pool (built with g++
  on first use from ``csrc/loader.cpp`` into ``build/apex_tpu_torch/``,
  bound via ctypes) that memory-maps a fixed-record dataset, shuffles
  per epoch with a seeded Fisher-Yates (bitwise-reproducible resume, the
  same order as the JAX package's loader), and assembles batches into a
  ring of reusable buffers;
- :class:`DevicePrefetcher` — stages batch N + 1 on the card (pinned
  memory, a non-blocking copy on its own side stream) while batch N
  computes, ``depth`` batches ahead (ref main_amp.py data_prefetcher);
- :func:`window_batches` — stacks K per-step batches into the
  leading-axis windows the train driver (``apex_tpu_torch.train``)
  consumes as one window.
"""
from apex_tpu_torch.data.loader import (  # noqa: F401
    DevicePrefetcher,
    NativeDataLoader,
    window_batches,
    write_records,
)

__all__ = [
    "NativeDataLoader",
    "DevicePrefetcher",
    "window_batches",
    "write_records",
]
