"""LayerNorm forward: a hand-written CUDA kernel plus its plain version.

Counterpart of ``apex_tpu/ops/layer_norm.py``.  :func:`layer_norm_ref` is
the plain PyTorch version of ``layer_norm_ref`` (fp32 stats, variance as
E[x^2] - mean^2, output in ``x.dtype``); :func:`layer_norm` runs
``csrc/layer_norm.cu`` on a CUDA tensor and the plain version on a CPU
tensor.  Forward only: the backward kernels belong to the training
slice, so a CUDA call that would need a gradient raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel

__all__ = ["MAX_N", "layer_norm", "layer_norm_ref"]

# widest row the kernel takes (the block strides the row, so this is a
# sanity bound on inputs, not a shared-memory limit)
MAX_N = 8192
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_ref(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis, stats in fp32, output in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("layer_norm").apex_ln_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape).

    CUDA tensors run ``csrc/layer_norm.cu``: ``x`` contiguous fp32 or
    bf16 with a last axis of at most :data:`MAX_N`, ``weight``/``bias``
    fp32 of that length (or both None).  A one-sided affine is completed
    with ones or zeros, as the JAX wrapper does.  CPU tensors run
    :func:`layer_norm_ref`.
    """
    if not use_kernel(x, weight, bias):
        return layer_norm_ref(x, weight, bias, eps)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError(
            "layer_norm on CUDA is forward-only: the backward kernels "
            "belong to the training slice (run under torch.no_grad())")
    n = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm kernel takes fp32/bf16 x, got {x.dtype}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"layer_norm kernel takes 1 <= n <= {MAX_N}, got {n}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel takes a contiguous x")
    if weight is None and bias is not None:
        weight = torch.ones_like(bias)
    elif bias is None and weight is not None:
        bias = torch.zeros_like(weight)
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                              or not t.is_contiguous()):
            raise ValueError(f"layer_norm kernel takes a contiguous fp32 "
                             f"{name} of shape ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    y = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        err = _kernel_fn()(
            x.data_ptr(),
            None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), rows, n, eps, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
