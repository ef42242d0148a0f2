"""Kernels of the port and their plain versions.

Each kernel wrapper counts its launches in a plain integer attribute,
``wrapper.launches``; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

from apex_tpu_torch.ops.attention import (  # noqa: F401
    cached_attention,
    paged_cached_attention,
    paged_fused_attention,
    quantize_kv,
)
from apex_tpu_torch.ops.layer_norm import layer_norm, layer_norm_ref  # noqa: F401

#: every kernel wrapper of the package, by name
KERNELS = {
    "layer_norm": layer_norm,
    "paged_fused_attention": paged_fused_attention,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "cached_attention",
    "launch_counts",
    "layer_norm",
    "layer_norm_ref",
    "paged_cached_attention",
    "paged_fused_attention",
    "quantize_kv",
    "reset_launch_counts",
]
