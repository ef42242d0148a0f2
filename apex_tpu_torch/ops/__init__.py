"""Kernels of the port and their plain versions.

Each kernel wrapper counts its launches in a plain integer attribute,
``wrapper.launches``; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

from apex_tpu_torch.ops.attention import (  # noqa: F401
    attention_ref,
    cached_attention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_acc,
    flash_attention_fwd,
    paged_cached_attention,
    paged_fused_attention,
    quantize_kv,
)
from apex_tpu_torch.ops.conv_bn import (  # noqa: F401
    bn_relu_matmul,
    matmul_bwd_dual,
    matmul_stats,
)
from apex_tpu_torch.ops.fused_optim import lamb_stage1  # noqa: F401
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    layer_norm,
    layer_norm_bwd,
    layer_norm_ref,
)
from apex_tpu_torch.ops.softmax_xentropy import (  # noqa: F401
    softmax_cross_entropy,
    softmax_cross_entropy_bwd,
    softmax_cross_entropy_fwd,
    softmax_cross_entropy_ref,
)

#: every kernel wrapper of the package, by name
KERNELS = {
    "layer_norm": layer_norm,
    "layer_norm_bwd": layer_norm_bwd,
    "paged_fused_attention": paged_fused_attention,
    "flash_attention_fwd": flash_attention_fwd,
    "flash_attention_bwd": flash_attention_bwd,
    "flash_attention_bwd_acc": flash_attention_bwd_acc,
    "softmax_xentropy_fwd": softmax_cross_entropy_fwd,
    "softmax_xentropy_bwd": softmax_cross_entropy_bwd,
    "lamb_stage1": lamb_stage1,
    "matmul_stats": matmul_stats,
    "bn_relu_matmul": bn_relu_matmul,
    "matmul_bwd_dual": matmul_bwd_dual,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "attention_ref",
    "bn_relu_matmul",
    "cached_attention",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_acc",
    "flash_attention_fwd",
    "lamb_stage1",
    "launch_counts",
    "layer_norm",
    "layer_norm_bwd",
    "layer_norm_ref",
    "matmul_bwd_dual",
    "matmul_stats",
    "paged_cached_attention",
    "paged_fused_attention",
    "quantize_kv",
    "reset_launch_counts",
    "softmax_cross_entropy",
    "softmax_cross_entropy_bwd",
    "softmax_cross_entropy_fwd",
    "softmax_cross_entropy_ref",
]
