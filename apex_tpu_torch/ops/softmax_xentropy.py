"""Fused softmax cross-entropy with label smoothing: hand-written CUDA
kernels plus their plain versions.

Counterpart of ``apex_tpu/ops/softmax_xentropy.py``.
:func:`softmax_cross_entropy_ref` is the plain PyTorch version of the
JAX reference (fp32 per-example losses from any-dtype logits);
:func:`softmax_cross_entropy` is a ``torch.autograd.Function`` over
:func:`softmax_cross_entropy_fwd` and :func:`softmax_cross_entropy_bwd`,
the wrappers of ``csrc/softmax_xentropy.cu`` (ports of the Pallas
``_xent_fwd_kernel`` and ``_xent_bwd_kernel``).  On CPU tensors they run
:func:`softmax_cross_entropy_fwd_ref` and
:func:`softmax_cross_entropy_bwd_ref`.

Semantics, as the reference's: ``nll = lse - l[label]``, ``smooth = lse -
mean(l)``, ``loss = (1 - eps) * nll + eps * smooth`` in fp32; the
backward is ``(softmax(l) - (1 - eps) * onehot - eps / V) * g`` in the
logits' dtype.  The JAX package picks its kernel for half-precision
logits at V >= 4096; here the rule is the port's: CUDA tensors always
run the kernels (fp32 or bf16, any V), CPU tensors the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel

__all__ = [
    "softmax_cross_entropy",
    "softmax_cross_entropy_bwd",
    "softmax_cross_entropy_bwd_ref",
    "softmax_cross_entropy_fwd",
    "softmax_cross_entropy_fwd_ref",
    "softmax_cross_entropy_ref",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def softmax_cross_entropy_ref(logits: torch.Tensor, labels: torch.Tensor,
                              label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example fp32 losses, shape ``labels.shape``."""
    return softmax_cross_entropy_fwd_ref(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
        label_smoothing)[0].reshape(labels.shape)


def _logsumexp(x: torch.Tensor) -> torch.Tensor:
    """max + log(sum(exp(x - max))) over the last axis: the kernels'
    formula, shared by the plain versions of this module and of flash
    attention."""
    m = x.amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)))[..., 0]


def softmax_cross_entropy_fwd_ref(logits2, labels1, smoothing: float):
    """Plain version of the forward kernel on (rows, V): ``(loss, lse)``,
    both fp32 (rows,)."""
    l32 = logits2.float()
    lse = _logsumexp(l32)
    label_logit = torch.gather(l32, -1, labels1.long()[:, None])[:, 0]
    nll = lse - label_logit
    if smoothing:
        smooth = lse - l32.mean(dim=-1)
        nll = (1.0 - smoothing) * nll + smoothing * smooth
    return nll, lse


def softmax_cross_entropy_bwd_ref(logits2, labels1, lse, g,
                                  smoothing: float) -> torch.Tensor:
    """Plain version of the backward kernel: ``(exp(l - lse) - target) *
    g`` in the logits' dtype."""
    l32 = logits2.float()
    v = l32.shape[-1]
    p = torch.exp(l32 - lse[:, None])
    # target = (1 - eps) * onehot + eps / V, without a (rows, V) one-hot
    target = torch.full_like(p, smoothing / v)
    rows = torch.arange(p.shape[0], device=p.device)
    target[rows, labels1.long()] += 1.0 - smoothing
    return ((p - target) * g.float()[:, None]).to(logits2.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("softmax_xentropy")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_xent_fwd.argtypes = [p, ll, p, p, p, ll, i, ctypes.c_float, i,
                                  i, p]
    lib.apex_xent_fwd.restype = i
    lib.apex_xent_bwd.argtypes = [p, ll, p, p, p, p, ll, i, ctypes.c_float,
                                  i, i, p]
    lib.apex_xent_bwd.restype = i
    return lib


def _rows_view(logits2: torch.Tensor) -> int:
    """The row stride of a (rows, V) logits view the kernels take (unit
    last stride); raises on anything else."""
    if logits2.dtype not in _DTYPE_CODE:
        raise ValueError(f"softmax cross-entropy kernel takes fp32/bf16 "
                         f"logits, got {logits2.dtype}")
    rows, v = logits2.shape
    if v < 1 or (v > 1 and logits2.stride(1) != 1) or \
            (rows > 1 and logits2.stride(0) < v):
        raise ValueError(f"softmax cross-entropy kernel takes (rows, V) "
                         f"logits with unit last stride, got strides "
                         f"{logits2.stride()}")
    if rows > 2 ** 31 - 1 or v > 2 ** 31 - 1:
        raise ValueError(f"softmax cross-entropy kernel: shape "
                         f"{tuple(logits2.shape)} too large")
    return logits2.stride(0) if rows > 1 else v


def _vec_ok(t: torch.Tensor, ld: int) -> bool:
    n = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and ld % n == 0


def softmax_cross_entropy_fwd(logits2: torch.Tensor, labels1: torch.Tensor,
                              smoothing: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on (rows, V) logits (any row stride on CUDA): ``(loss,
    lse)``.  CUDA tensors run ``apex_xent_fwd``; CPU tensors the plain
    version.  Labels must lie in [0, V)."""
    if not use_kernel(logits2, labels1):
        return softmax_cross_entropy_fwd_ref(logits2, labels1, smoothing)
    ld = _rows_view(logits2)
    rows, v = logits2.shape
    labels1 = labels1.to(torch.int64).contiguous()
    if labels1.shape != (rows,):
        raise ValueError(f"labels shape {tuple(labels1.shape)} != ({rows},)")
    loss = torch.empty(rows, dtype=torch.float32, device=logits2.device)
    lse = torch.empty_like(loss)
    with torch.cuda.device(logits2.device):
        err = _lib().apex_xent_fwd(
            logits2.data_ptr(), ld, labels1.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), rows, v, float(smoothing),
            _DTYPE_CODE[logits2.dtype], int(_vec_ok(logits2, ld)),
            torch.cuda.current_stream(logits2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmax cross-entropy forward kernel launch "
                           f"failed: CUDA error {err}")
    softmax_cross_entropy_fwd.launches += 1
    return loss, lse


def softmax_cross_entropy_bwd(logits2: torch.Tensor, labels1: torch.Tensor,
                              lse: torch.Tensor, g: torch.Tensor,
                              smoothing: float) -> torch.Tensor:
    """dlogits, contiguous (rows, V) in the logits' dtype.  CUDA tensors
    run ``apex_xent_bwd``; CPU tensors the plain version."""
    if not use_kernel(logits2, labels1, lse, g):
        return softmax_cross_entropy_bwd_ref(logits2, labels1, lse, g,
                                             smoothing)
    ld = _rows_view(logits2)
    rows, v = logits2.shape
    labels1 = labels1.to(torch.int64).contiguous()
    g = g.to(torch.float32).contiguous()
    lse = lse.contiguous()
    if labels1.shape != (rows,) or g.shape != (rows,) or lse.shape != (rows,):
        raise ValueError("softmax cross-entropy backward takes (rows,) "
                         "labels, g and lse")
    dlogits = torch.empty((rows, v), dtype=logits2.dtype,
                          device=logits2.device)
    vec = _vec_ok(logits2, ld) and _vec_ok(dlogits, v)
    with torch.cuda.device(logits2.device):
        err = _lib().apex_xent_bwd(
            logits2.data_ptr(), ld, labels1.data_ptr(), g.data_ptr(),
            lse.data_ptr(), dlogits.data_ptr(), rows, v, float(smoothing),
            _DTYPE_CODE[logits2.dtype], int(vec),
            torch.cuda.current_stream(logits2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"softmax cross-entropy backward kernel launch "
                           f"failed: CUDA error {err}")
    softmax_cross_entropy_bwd.launches += 1
    return dlogits


class _Xent(torch.autograd.Function):
    """The custom VJP: residuals are (logits, labels, lse)."""

    @staticmethod
    def forward(ctx, logits2, labels1, smoothing):
        loss, lse = softmax_cross_entropy_fwd(logits2, labels1, smoothing)
        ctx.save_for_backward(logits2, labels1, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2, labels1, lse = ctx.saved_tensors
        return (softmax_cross_entropy_bwd(logits2, labels1, lse, g,
                                          ctx.smoothing), None, None)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Fused softmax cross-entropy with label smoothing; fp32 per-example
    losses of shape ``labels.shape``, differentiable in ``logits``.

    Any leading shape: logits (..., V), labels (...) int in [0, V).  CUDA
    tensors run the kernels on fp32 or bf16 logits of any V (the ragged
    tail is masked in the kernel, never padded); CPU tensors the plain
    versions."""
    v = logits.shape[-1]
    loss = _Xent.apply(logits.reshape(-1, v), labels.reshape(-1),
                       float(label_smoothing))
    return loss.reshape(labels.shape)


softmax_cross_entropy_fwd.launches = 0
softmax_cross_entropy_bwd.launches = 0
