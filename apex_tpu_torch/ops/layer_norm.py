"""LayerNorm forward and backward: hand-written CUDA kernels plus their
plain versions.

Counterpart of ``apex_tpu/ops/layer_norm.py``.  :func:`layer_norm_ref` is
the plain PyTorch version of ``layer_norm_ref`` (fp32 stats, variance as
E[x^2] - mean^2, output in ``x.dtype``) and :func:`layer_norm_bwd_ref`
the plain version of the backward (the reference's jnp ``_ln_bwd_rule``
branch: mean and rstd recomputed from x, dgamma/dbeta as fp32 column sums
cast to the weight's dtype).  :func:`layer_norm` is a
``torch.autograd.Function``: on CUDA tensors its forward runs
``apex_ln_fwd`` and its backward ``apex_ln_bwd`` of ``csrc/layer_norm.cu``
(the dx kernel plus the deterministic dgamma/dbeta reduction; with no
weight, the dx-only variant); on CPU tensors both run the plain versions.

Each direction has three designs, picked here alone
(:func:`_ln_fwd_design`, :func:`_ln_bwd_design`) and passed to the
library by code: rows of at most :data:`WARP_MAX_N` that are a whole
number of 16-byte vectors, on 16-byte aligned bases (every ported
model), run the warp design (a warp a row, persistent blocks, 16-byte
vector loads and stores, the row read once); other rows of at most
:data:`BLOCK_MAX_N` the block design (a block of 256 threads a row, the
row held in registers; the backward's blocks own 16 rows); wider rows,
of any n, the wide design (the block design with the row read again
from memory for each pass instead of held).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel

__all__ = ["BLOCK_MAX_N", "LN_BWD_DESIGNS", "LN_BWD_WARP_KERNELS",
           "LN_FWD_DESIGNS", "LN_FWD_WARP_KERNELS", "WARP_MAX_N",
           "layer_norm", "layer_norm_bwd", "layer_norm_bwd_ref",
           "layer_norm_ref", "ln_bwd_blocks", "ln_bwd_kernel",
           "ln_fwd_kernel"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the designs of each direction (the codes apex_ln_fwd and apex_ln_bwd
# take; the rules that pick them are here alone): a warp a row with
# 16-byte vectors, n up to WARP_MAX_N; a block of 256 threads a row with
# the row in registers (ceil(n / 256) <= 32 columns a thread), n up to
# BLOCK_MAX_N; the same block reading the row again for each pass, any n
LN_FWD_BLOCK = LN_BWD_BLOCK = 0
LN_FWD_WARP = LN_BWD_WARP = 1
LN_FWD_WIDE = LN_BWD_WIDE = 2
LN_FWD_DESIGNS = {LN_FWD_BLOCK: "block_per_row_registers",
                  LN_FWD_WARP: "warp_per_row_vec16",
                  LN_FWD_WIDE: "block_per_row_two_pass"}
LN_BWD_DESIGNS = {LN_BWD_BLOCK: "block_per_16_rows",
                  LN_BWD_WARP: "warp_per_row_vec16",
                  LN_BWD_WIDE: "wide_persistent_three_pass"}
WARP_MAX_N = 1024
BLOCK_MAX_N = 8192
# the warp designs' instantiations in csrc/layer_norm.cu: for each x and
# weight dtype, the vectors a lane holds at n = 768 (taken by every n up
# to 768) and at n = 1024
_WARP_WIDTHS = (768, WARP_MAX_N)
_DT_NAME = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def _warp_name(kernel: str, x_dt: torch.dtype, w_dt: torch.dtype,
               width: int) -> str:
    vw = 16 // torch.tensor([], dtype=x_dt).element_size()
    return (f"{kernel}<{_DT_NAME[x_dt]}, {_DT_NAME[w_dt]}, "
            f"{width // (32 * vw)} x {vw}>")


LN_FWD_WARP_KERNELS, LN_BWD_WARP_KERNELS = (tuple(
    _warp_name(kernel, x_dt, w_dt, width) for x_dt in _DT_NAME
    for w_dt in _DT_NAME for width in _WARP_WIDTHS)
    for kernel in ("ln_fwd_warp", "ln_bwd_warp"))


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


def layer_norm_bwd_ref(
    x2: torch.Tensor,
    weight: Optional[torch.Tensor],
    dy2: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, dgamma, dbeta) of LayerNorm over (rows, n) ``x2``; dgamma and
    dbeta in the weight's dtype, None without a weight."""
    x32 = x2.float()
    dy32 = dy2.float()
    n = x2.shape[-1]
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dxhat = dy32 * weight.float() if weight is not None else dy32
    m1 = dxhat.sum(dim=-1, keepdim=True) / n
    m2 = (dxhat * xhat).sum(dim=-1, keepdim=True) / n
    dx = (rstd * (dxhat - m1 - xhat * m2)).to(x2.dtype)
    if weight is None:
        return dx, None, None
    dw = (dy32 * xhat).sum(dim=0).to(weight.dtype)
    db = dy32.sum(dim=0).to(weight.dtype)
    return dx, dw, db


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("layer_norm")
    lib.apex_ln_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.apex_ln_fwd.restype = ctypes.c_int
    lib.apex_ln_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.apex_ln_bwd.restype = ctypes.c_int
    lib.apex_ln_bwd_geometry.argtypes = [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.apex_ln_bwd_geometry.restype = ctypes.c_int
    return lib


def _design(*tensors: torch.Tensor) -> int:
    """The design code for rows of ``tensors`` (x and dy; the outputs are
    allocated aligned): warp for rows of n <= :data:`WARP_MAX_N` that are
    a whole number of 16-byte vectors, every base 16-byte aligned; block
    for other rows up to :data:`BLOCK_MAX_N`; wide past it."""
    n = tensors[0].shape[-1]
    if (n <= WARP_MAX_N and n * tensors[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors)):
        return LN_FWD_WARP
    return LN_FWD_BLOCK if n <= BLOCK_MAX_N else LN_FWD_WIDE


def _ln_fwd_design(x2: torch.Tensor) -> int:
    """The forward kernel a call on (rows, n) ``x2`` runs (code of
    :data:`LN_FWD_DESIGNS`)."""
    return _design(x2)


def _ln_bwd_design(x2: torch.Tensor, dy2: torch.Tensor) -> int:
    """The backward kernel a call on (rows, n) ``x2`` and ``dy2`` runs
    (code of :data:`LN_BWD_DESIGNS`)."""
    return _design(x2, dy2)


def _block_columns(n: int) -> int:
    """Columns a thread holds in the block designs: ceil(n / 256) rounded
    up to a power of two."""
    c = 1
    while 256 * c < n:
        c *= 2
    return c


def ln_fwd_kernel(x_dtype: torch.dtype, w_dtype: Optional[torch.dtype],
                  n: int, design: int) -> str:
    """The instantiation that a forward call with design code ``design``
    launches (without a weight, the fp32-weight one): an entry of
    :data:`LN_FWD_WARP_KERNELS` for the warp design."""
    w_dtype = w_dtype or torch.float32
    if design == LN_FWD_WARP:
        width = next(wd for wd in _WARP_WIDTHS if n <= wd)
        return _warp_name("ln_fwd_warp", x_dtype, w_dtype, width)
    x, w = _DT_NAME[x_dtype], _DT_NAME[w_dtype]
    if design == LN_FWD_BLOCK:
        return f"ln_fwd_block<{x}, {w}, {_block_columns(n)}>"
    return f"ln_fwd_wide<{x}, {w}>"


def ln_bwd_kernel(x_dtype: torch.dtype, w_dtype: Optional[torch.dtype],
                  n: int, design: int) -> Optional[str]:
    """The entry of :data:`LN_BWD_WARP_KERNELS` that a backward call with
    design code ``design`` launches (without a weight, the fp32-weight
    one); None for the block and wide designs."""
    if design != LN_BWD_WARP:
        return None
    width = next(wd for wd in _WARP_WIDTHS if n <= wd)
    return _warp_name("ln_bwd_warp", x_dtype, w_dtype or torch.float32,
                      width)


def ln_bwd_blocks(x2: torch.Tensor, weight: Optional[torch.Tensor],
                  dy2: torch.Tensor) -> Tuple[int, int, int]:
    """``(design, blocks, rows_per_block)`` of the backward kernel on
    (rows, n) ``x2``, as the library reports them: block b owns rows
    [b R, b R + R), the last block the rest, and writes dgamma/dbeta
    partial b."""
    rows, n = x2.shape
    design = _ln_bwd_design(x2, dy2)
    out = (ctypes.c_longlong * 2)()
    if _lib().apex_ln_bwd_geometry(
            rows, n, _DTYPE_CODE[x2.dtype],
            _DTYPE_CODE[weight.dtype] if weight is not None else -1, design,
            out) != 0:
        raise ValueError(f"layer_norm backward: design {design} cannot run "
                         f"rows={rows} n={n}")
    return design, out[0], out[1]


def _check(x: torch.Tensor, weight: Optional[torch.Tensor],
           bias: Optional[torch.Tensor]) -> None:
    """What the kernels take; raises on anything else."""
    n = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm kernel takes fp32/bf16 x, got {x.dtype}")
    if n < 1:
        raise ValueError(f"layer_norm kernel takes n >= 1, got {n}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel takes a contiguous x")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (t.dtype not in _DTYPE_CODE or t.shape != (n,)
                              or not t.is_contiguous()):
            raise ValueError(f"layer_norm kernel takes a contiguous fp32/bf16 "
                             f"{name} of shape ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if weight is not None and bias is not None and weight.dtype != bias.dtype:
        raise ValueError(f"layer_norm kernel takes weight and bias of one "
                         f"dtype, got {weight.dtype} and {bias.dtype}")


def _launch_fwd(x2, weight, bias, eps,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel on (rows, n) ``x2``, into a new tensor or into
    ``out`` (like ``x2``, 16-byte aligned; the card's checks hand in one
    filled with NaN, to see every row written)."""
    y = torch.empty_like(x2) if out is None else out
    rows, n = x2.shape
    if rows == 0:
        return y
    w_code = _DTYPE_CODE[weight.dtype] if weight is not None else -1
    with torch.cuda.device(x2.device):
        err = _lib().apex_ln_fwd(
            x2.data_ptr(),
            None if weight is None else weight.data_ptr(),
            None if bias is None else bias.data_ptr(),
            y.data_ptr(), rows, n, eps, _DTYPE_CODE[x2.dtype], w_code,
            _ln_fwd_design(x2),
            torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    layer_norm.launches += 1
    return y


def layer_norm_bwd(x2: torch.Tensor, weight: Optional[torch.Tensor],
                   dy2: torch.Tensor, eps: float = 1e-5):
    """(dx, dgamma, dbeta) of LayerNorm over (rows, n) ``x2``: the backward
    kernel on CUDA tensors (dgamma/dbeta None without a weight), the plain
    :func:`layer_norm_bwd_ref` on CPU tensors."""
    if not use_kernel(x2, weight, dy2):
        return layer_norm_bwd_ref(x2, weight, dy2, eps)
    _check(x2, weight, None)
    if dy2.dtype != x2.dtype or dy2.shape != x2.shape:
        raise ValueError(f"layer_norm backward takes dy like x, got "
                         f"{dy2.dtype} {tuple(dy2.shape)}")
    dy2 = dy2.contiguous()
    rows, n = x2.shape
    dx = torch.empty_like(x2)
    dw = db = part = None
    if weight is not None:
        dw = torch.empty_like(weight)
        db = torch.empty_like(weight)
    if rows == 0:
        if dw is not None:
            dw.zero_()
            db.zero_()
        return dx, dw, db
    with torch.cuda.device(x2.device):
        design, parts, _ = ln_bwd_blocks(x2, weight, dy2)
        if weight is not None:
            part = torch.empty(parts, 2, n, device=x2.device,
                               dtype=torch.float32)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = _lib().apex_ln_bwd(
            x2.data_ptr(), ptr(weight), dy2.data_ptr(), dx.data_ptr(),
            ptr(part), ptr(dw), ptr(db), rows, n, eps,
            _DTYPE_CODE[x2.dtype],
            _DTYPE_CODE[weight.dtype] if weight is not None else -1,
            design, torch.cuda.current_stream(x2.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"layer_norm backward kernel launch failed: CUDA "
                           f"error {err}")
    layer_norm_bwd.launches += 1
    return dx, dw, db


class _LayerNorm(torch.autograd.Function):
    """The custom VJP: residuals are (x, weight) only; the backward
    recomputes the row stats from x."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, weight)
        if use_kernel(x2, weight, bias):
            return _launch_fwd(x2, weight, bias, eps)
        return layer_norm_ref(x2, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy2):
        x2, weight = ctx.saved_tensors
        dx, dw, db = layer_norm_bwd(x2, weight, dy2.contiguous(), ctx.eps)
        return dx, dw, db, None


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Differentiable LayerNorm over the last axis of ``x`` (any leading
    shape).

    CUDA tensors run ``csrc/layer_norm.cu``: ``x`` contiguous fp32 or bf16
    with a last axis of any length, ``weight``/``bias`` fp32 or
    bf16 (one dtype) of that length, or both None.  Under O2 the affine
    parameters are bf16 while x is fp32; they are upcast in the kernel and
    their gradients come back in their own dtype.  A one-sided affine is
    completed with ones or zeros (constants, so no gradient flows to
    them), as the JAX wrapper does.  CPU tensors run the plain versions.
    """
    n = x.shape[-1]
    if weight is None and bias is not None:
        weight = torch.ones(n, dtype=bias.dtype, device=bias.device)
    elif bias is None and weight is not None:
        bias = torch.zeros(n, dtype=weight.dtype, device=weight.device)
    kernel = use_kernel(x, weight, bias)
    if kernel:
        _check(x, weight, bias)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        y = _LayerNorm.apply(x2, weight, bias, eps)
    elif kernel:  # no graph to record (serving): skip the Function
        y = _launch_fwd(x2, weight, bias, eps)
    else:
        y = layer_norm_ref(x2, weight, bias, eps)
    return y.reshape(*lead, n)


layer_norm.launches = 0
layer_norm_bwd.launches = 0
