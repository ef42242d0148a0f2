"""The fused 1x1-conv + BatchNorm matmuls of RN50: hand-written CUDA
kernels plus their plain versions.

Counterpart of ``apex_tpu/ops/conv_bn.py``.  A 1x1 convolution in NHWC is
a matmul over (N*H*W, C):

- :func:`matmul_stats` — ``y = x @ w`` that also returns the per-column
  ``sum(y)`` and ``sum(y*y)`` of the stored (rounded) y, in fp32;
- :func:`bn_relu_matmul` — ``relu((x - mean) * (rstd * gamma) + beta) @ w``
  with the normalisation applied to the left operand as it is loaded, and
  the same stats;
- :func:`matmul_bwd_dual` — both cotangents of ``y = x @ w``, dx in x's
  dtype and dw always fp32.

The plain versions :func:`matmul_stats_ref`, :func:`bn_relu_matmul_ref`
and :func:`matmul_bwd_dual_ref` are the JAX package's jnp branches (the
BN operand is not rounded there; the kernel rounds it to w's dtype before
the product, as the TPU kernel does).  The first two entry points are
``torch.autograd.Function`` s whose backward is the JAX package's own jnp
VJP in plain torch (no Pallas kernel there either): the stats cotangents
fold into dy as ``dy + ds + 2*y*dss`` and each gradient comes back in its
input's dtype.

The JAX package gates its kernels on multiples of 128 and takes tile
sizes; here a CUDA tensor always runs ``csrc/conv_bn.cu`` (any M, K, N;
fp32 or bf16, anything else raises) and a CPU tensor the plain version.
The JAX package does not wire these kernels into its ResNet, and neither
does the port: they are library entry points.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel

__all__ = ["bn_relu_matmul", "bn_relu_matmul_ref", "matmul_bwd_dual",
           "matmul_bwd_dual_ref", "matmul_stats", "matmul_stats_ref"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# dw row chunks of the dual backward: about two blocks per SM of an H100
_DW_BLOCKS = 264


def _stats(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    y32 = y.float()
    return y32.sum(dim=0), (y32 * y32).sum(dim=0)


def matmul_stats_ref(x: torch.Tensor, w: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, sum, sqsum)``: y = x @ w as an fp32 product stored in x's
    dtype, the stats of the stored y."""
    y = (x.float() @ w.float()).to(x.dtype)
    return (y, *_stats(y))


def _bn_lhs(x, mean, rstd, gamma, beta, relu: bool) -> torch.Tensor:
    """The normalised left operand in fp32 (parameters cast to fp32 before
    the product rstd * gamma, as the kernel receives them)."""
    scale = rstd.float() * gamma.float()
    a = (x.float() - mean.float()) * scale + beta.float()
    return torch.clamp_min(a, 0.0) if relu else a


def bn_relu_matmul_ref(x, mean, rstd, gamma, beta, w, relu: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(z, sum, sqsum)``: z = bn(x) [relu] @ w, fp32 throughout, stored
    in x's dtype, with the stats of the stored z."""
    a = _bn_lhs(x, mean, rstd, gamma, beta, relu)
    y = (a @ w.float()).to(x.dtype)
    return (y, *_stats(y))


def matmul_bwd_dual_ref(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of y = x @ w as two fp32 products; dx in x's dtype, dw
    fp32."""
    dx = (dy.float() @ w.float().T).to(x.dtype)
    dw = x.float().T @ dy.float()
    return dx, dw


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("conv_bn")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_conv_bn_fwd.argtypes = [p, p, p, p, p, p, i, p, p, p, p, ll, i,
                                     i, i, i, p]
    lib.apex_conv_bn_fwd.restype = i
    lib.apex_matmul_bwd_dual.argtypes = [p, p, p, p, p, p, ll, i, i, ll, i, p]
    lib.apex_matmul_bwd_dual.restype = i
    for name in ("apex_conv_bn_rows_per_block", "apex_conv_bn_step"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    return lib


def _check_matrix(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv_bn kernel takes fp32/bf16 {name}, got "
                         f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"conv_bn kernel: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"conv_bn kernel takes a contiguous {name}")


def _check_widths(k: int, n: int) -> None:
    if k > 2 ** 31 - 1 or n > 2 ** 31 - 1:
        raise ValueError(f"conv_bn kernel: K = {k} or N = {n} too large")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(x, w, bn, relu: bool, with_stats: bool):
    """The forward kernel: ``(y, sum, sqsum)`` (stats None without
    ``with_stats``).  ``bn`` is (mean, rstd, gamma, beta) or None."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"conv_bn kernel takes 2-D x and w, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    _check_matrix("x", x, (m, k))
    _check_matrix("w", w, (k, n))
    _check_widths(k, n)
    params = None
    if bn is not None:
        for name, t in zip(("mean", "rstd", "gamma", "beta"), bn):
            if tuple(t.shape) != (k,) or not t.is_floating_point():
                raise ValueError(f"bn_relu_matmul kernel takes a float {name} "
                                 f"of shape ({k},), got {t.dtype} "
                                 f"{tuple(t.shape)}")
        params = [t.float().contiguous() for t in bn]
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    s = ss = None
    if with_stats:
        s = torch.zeros(n, dtype=torch.float32, device=dev)
        ss = torch.zeros(n, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return y, s, ss
    if k == 0:
        return y.zero_(), s, ss
    part = None
    if with_stats:
        rows = _lib().apex_conv_bn_rows_per_block()
        part = torch.empty((-(-m // rows), 2, n), dtype=torch.float32,
                           device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    mean, rstd, gamma, beta = params or (None,) * 4
    with torch.cuda.device(dev):
        err = _lib().apex_conv_bn_fwd(
            x.data_ptr(), w.data_ptr(), ptr(mean), ptr(rstd), ptr(gamma),
            ptr(beta), int(relu), y.data_ptr(), ptr(part), ptr(s), ptr(ss),
            m, k, n, _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"conv_bn forward kernel launch failed: CUDA "
                           f"error {err}")
    if bn is None:
        matmul_stats.launches += 1
    else:
        bn_relu_matmul.launches += 1
    return y, s, ss


def _fold(y, dy, ds, dss) -> torch.Tensor:
    """The stats cotangents folded into dy: d(sum y)/dy = 1, d(sum
    y^2)/dy = 2y."""
    return dy.float() + ds[None, :] + 2.0 * y.float() * dss[None, :]


class _MatmulStats(torch.autograd.Function):
    """The custom VJP; residuals are (x, w, y)."""

    @staticmethod
    def forward(ctx, x, w, with_stats):
        if use_kernel(x, w):
            y, s, ss = _launch_fwd(x, w, None, False, with_stats)
        else:
            y, s, ss = matmul_stats_ref(x, w)
        ctx.save_for_backward(x, w, y)
        ctx.with_stats = with_stats
        return (y, s, ss) if with_stats else y

    @staticmethod
    def backward(ctx, dy, ds=None, dss=None):
        x, w, y = ctx.saved_tensors
        if ctx.with_stats:
            dy32 = _fold(y, dy, ds, dss)
        else:
            dy32 = dy.float()
        dx = (dy32 @ w.float().T).to(x.dtype)
        dw = (x.float().T @ dy32).to(w.dtype)
        return dx, dw, None


class _BnReluMatmul(torch.autograd.Function):
    """The custom VJP; residuals are the inputs and y (the normalised
    operand is recomputed, never kept)."""

    @staticmethod
    def forward(ctx, x, mean, rstd, gamma, beta, w, relu, with_stats):
        if use_kernel(x, mean, rstd, gamma, beta, w):
            y, s, ss = _launch_fwd(x, w, (mean, rstd, gamma, beta), relu,
                                   with_stats)
        else:
            y, s, ss = bn_relu_matmul_ref(x, mean, rstd, gamma, beta, w, relu)
        ctx.save_for_backward(x, mean, rstd, gamma, beta, w, y)
        ctx.relu = relu
        ctx.with_stats = with_stats
        return (y, s, ss) if with_stats else y

    @staticmethod
    def backward(ctx, dy, ds=None, dss=None):
        x, mean, rstd, gamma, beta, w, y = ctx.saved_tensors
        dy32 = _fold(y, dy, ds, dss) if ctx.with_stats else dy.float()
        a = _bn_lhs(x, mean, rstd, gamma, beta, ctx.relu)
        da = dy32 @ w.float().T
        dw = (a.T @ dy32).to(w.dtype)
        if ctx.relu:
            da = torch.where(a > 0.0, da, 0.0)
        rstd32, gamma32 = rstd.float(), gamma.float()
        g32 = rstd32 * gamma32
        xc = x.float() - mean.float()
        dax = (da * xc).sum(dim=0)
        dsum = da.sum(dim=0)
        # each cotangent in its primal's dtype (bf16 BN params get bf16)
        return ((da * g32).to(x.dtype), (-dsum * g32).to(mean.dtype),
                (dax * gamma32).to(rstd.dtype), (dax * rstd32).to(gamma.dtype),
                dsum.to(beta.dtype), dw, None, None)


def matmul_stats(x: torch.Tensor, w: torch.Tensor, *, with_stats: bool = True
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]]:
    """``y = x @ w`` plus the per-column (sum, sqsum) of the stored y.

    x: (M, K), w: (K, N), contiguous fp32 or bf16 on CUDA.  Returns (y in
    x's dtype, sum (N,) fp32, sqsum (N,) fp32), or just y with
    ``with_stats=False`` (the kernel then skips its stats epilogue).
    Differentiable in x and w, the stats included."""
    return _MatmulStats.apply(x, w, bool(with_stats))


def bn_relu_matmul(x, mean, rstd, gamma, beta, w, *, relu: bool = True,
                   with_stats: bool = True):
    """``z = relu((x - mean) * (rstd * gamma) + beta) @ w`` with the
    normalisation in the kernel's operand load (the normalised tensor
    never reaches device memory), plus the stats of the stored z like
    :func:`matmul_stats`.  x: (M, K); mean, rstd, gamma, beta: (K,) of any
    float dtype (read as fp32); w: (K, N).  Differentiable in all six."""
    return _BnReluMatmul.apply(x, mean, rstd, gamma, beta, w, bool(relu),
                               bool(with_stats))


def _dual_chunk_rows(m: int, k: int, n: int, step: int, tile: int) -> int:
    """Rows per dw chunk: about :data:`_DW_BLOCKS` dw blocks in all, a
    multiple of the kernel's reduction step."""
    tiles = -(-k // tile) * -(-n // tile)
    chunks = max(1, min(-(-m // step), -(-_DW_BLOCKS // tiles)))
    rows = -(-m // chunks)
    return -(-rows // step) * step


def matmul_bwd_dual(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both cotangents of ``y = x @ w``: ``(dx, dw)`` with dx = dy @ w^T in
    x's dtype and dw = x^T @ dy always fp32 (cast it to w's dtype where a
    cotangent contract needs that).  x: (M, K), dy: (M, N), w: (K, N), one
    dtype (fp32 or bf16), contiguous, any M, K, N on CUDA; the plain
    version on the CPU."""
    if not use_kernel(x, dy, w):
        return matmul_bwd_dual_ref(x, dy, w)
    if x.dim() != 2 or dy.dim() != 2 or w.dim() != 2:
        raise ValueError("matmul_bwd_dual takes 2-D x, dy and w")
    m, k = x.shape
    n = w.shape[1]
    for name, t, shape in (("x", x, (m, k)), ("dy", dy, (m, n)),
                           ("w", w, (k, n))):
        _check_matrix(name, t, shape)
    _check_widths(k, n)
    if not x.dtype == dy.dtype == w.dtype:
        raise ValueError(f"matmul_bwd_dual kernel takes x, dy and w of one "
                         f"dtype, got {x.dtype}, {dy.dtype}, {w.dtype}")
    dev = x.device
    dx = torch.empty((m, k), dtype=x.dtype, device=dev)
    dw = torch.zeros((k, n), dtype=torch.float32, device=dev)
    if m == 0 or k == 0 or n == 0:
        return dx.zero_(), dw
    lib = _lib()
    rows = _dual_chunk_rows(m, k, n, lib.apex_conv_bn_step(),
                            lib.apex_conv_bn_rows_per_block())
    part = torch.empty((-(-m // rows), k, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.apex_matmul_bwd_dual(
            x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dw.data_ptr(), m, k, n, rows,
            _DTYPE_CODE[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"matmul_bwd_dual kernel launch failed: CUDA "
                           f"error {err}")
    matmul_bwd_dual.launches += 1
    return dx, dw


matmul_stats.launches = 0
bn_relu_matmul.launches = 0
matmul_bwd_dual.launches = 0

