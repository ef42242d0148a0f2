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

Which kernel of ``csrc/conv_bn.cu`` a call runs is a fixed rule,
:func:`_conv_bn_design`: bf16 ``matmul_stats``, ``bn_relu_matmul`` and
``matmul_bwd_dual`` whose matrices TMA can read (16-byte aligned bases,
rows a whole number of 16 bytes) run the Hopper kernels (``wgmma`` fed
by a TMA/mbarrier ring, persistent blocks; ``csrc/hopper_gemm.cuh``;
``bn_relu_matmul`` on the stats kernel with its BN prologue applied to
each x tile in shared memory); fp32 or mixed operands and rows TMA
cannot describe run the ``mma.sync``/FMA kernels.  A call the rule
sends to a kernel launches it or raises.
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

# The designs of csrc/conv_bn.cu (the codes its C entries take; the rule
# that picks them is here alone, the library runs what a code names)
PRESENT = 0                       # mma.sync (bf16) / FMA (fp32) kernels
# wgmma stats, w in the ring / kept; 128-wide column tiles, or 64 (N64)
STATS_STREAMED, STATS_RESIDENT = 1, 2
STATS_STREAMED_N64, STATS_RESIDENT_N64 = 3, 4
DUAL_TILES, DUAL_FUSED = 1, 2     # wgmma dx and dw tiles / one pass
STATS_DESIGNS = {PRESENT: "mma_sync", STATS_STREAMED: "wgmma_w_streamed",
                 STATS_RESIDENT: "wgmma_w_resident",
                 STATS_STREAMED_N64: "wgmma_n64_w_streamed",
                 STATS_RESIDENT_N64: "wgmma_n64_w_resident"}
DUAL_DESIGNS = {PRESENT: "mma_sync", DUAL_TILES: "wgmma_tiles",
                DUAL_FUSED: "wgmma_one_pass"}
# bytes of w a stats block keeps in shared memory (its (K, column tile)
# panel, K rounded up to 64)
_RESIDENT_W = 128 * 1024
# N -> the slice of K the one-pass dual is built for at that N: a block's
# slice of w and of the fp32 dw fit on chip (slice * N <= 16384), the
# three (slice, N) of RN50's stage-1 and stage-2 shapes
_FUSED_SLICE = {64: 256, 128: 128, 256: 64}
# slices of K a one-pass call may take (each reads dy again from the L2)
_FUSED_MAX_SLICES = 4


def _fused_slice(k: int, n: int) -> int:
    """The one-pass dual's slice of K at (K, N): the slice built for N
    where it divides K into at most :data:`_FUSED_MAX_SLICES` slices; 0
    where there is none."""
    ks = _FUSED_SLICE.get(n, 0)
    return ks if ks and k % ks == 0 and k // ks <= _FUSED_MAX_SLICES else 0


# the Hopper kernels' names, in apex_conv_bn_tc_info's order (", bn":
# the stats kernel with bn_relu_matmul's prologue)
TC_KERNELS = ("stats_tc<64, w resident>", "stats_tc<64, w streamed>",
              "dual_tc", "dual_fused<256, 64>", "dual_fused<64, 256>",
              "dual_fused<128, 128>", "stats_tc<128, w resident>",
              "stats_tc<128, w streamed>", "stats_tc<64, w resident, bn>",
              "stats_tc<64, w streamed, bn>", "stats_tc<128, w resident, bn>",
              "stats_tc<128, w streamed, bn>")


def tc_kernel(kind: str, design: int, n: int) -> Union[str, None]:
    """The entry of :data:`TC_KERNELS` that a call of ``kind`` ("stats"
    for ``matmul_stats``, "bn" for ``bn_relu_matmul``, "dual") with
    design code ``design`` and N = ``n`` launches; None for
    :data:`PRESENT`."""
    if design == PRESENT:
        return None
    if kind in ("stats", "bn"):
        tile = 64 if design in (STATS_STREAMED_N64, STATS_RESIDENT_N64) else 128
        kept = design in (STATS_RESIDENT, STATS_RESIDENT_N64)
        bn = ", bn" if kind == "bn" else ""
        return f"stats_tc<{tile}, w {'resident' if kept else 'streamed'}{bn}>"
    if design == DUAL_TILES:
        return "dual_tc"
    return f"dual_fused<{_FUSED_SLICE[n]}, {n}>"


def _tma_ok(t: torch.Tensor) -> bool:
    """A contiguous 2-D matrix that a TMA map can describe: a 16-byte
    aligned base and rows a whole number of 16 bytes apart (and fewer than
    2^31 rows, the kernels' int row index)."""
    return (t.data_ptr() % 16 == 0 and t.shape[0] < 2 ** 31
            and (t.shape[1] * t.element_size()) % 16 == 0)


def _conv_bn_design(kind: str, x: torch.Tensor, w: torch.Tensor,
                    dy: torch.Tensor = None) -> int:
    """The kernel a call runs (``kind`` "stats" for the forwards,
    ``matmul_stats`` and ``bn_relu_matmul``; "dual" for the backward).

    - forward: bf16 x and w, both TMA-readable -> the wgmma kernel with
      column tiles 64 wide for N <= 64 (no masked columns; the ``_N64``
      codes), else 128; w resident when its (K, column tile) panel fits
      in :data:`_RESIDENT_W`, else streamed.  ``bn_relu_matmul`` takes
      the same code (its prologue needs no shared memory of its own) and
      the C entry adds the prologue because it is given the parameters;
    - dual: bf16 x, dy and w, all TMA-readable -> :data:`DUAL_FUSED`
      where K cuts into slices of the one built for N
      (:func:`_fused_slice`), else :data:`DUAL_TILES`;
    - else :data:`PRESENT` (fp32 has no exact wgmma; mixed dtypes and
      rows TMA cannot describe stay on the mma.sync/FMA kernels, with the
      BN prologue in their operand loads)."""
    bf = torch.bfloat16
    if kind == "stats":
        if x.dtype != bf or w.dtype != bf or not (_tma_ok(x) and _tma_ok(w)):
            return PRESENT
        k, n = w.shape
        tile = 64 if n <= 64 else 128
        resident = -(-k // 64) * 64 * tile * 2 <= _RESIDENT_W
        if tile == 64:
            return STATS_RESIDENT_N64 if resident else STATS_STREAMED_N64
        return STATS_RESIDENT if resident else STATS_STREAMED
    if kind != "dual":
        raise ValueError(f"conv_bn design: unknown kind {kind!r}")
    if not (x.dtype == dy.dtype == w.dtype == bf
            and _tma_ok(x) and _tma_ok(dy) and _tma_ok(w)):
        return PRESENT
    return DUAL_FUSED if _fused_slice(*w.shape) else DUAL_TILES


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
                                     i, i, i, i, i, p]
    lib.apex_conv_bn_fwd.restype = i
    lib.apex_matmul_bwd_dual.argtypes = [p, p, p, p, p, p, ll, i, i, ll, i,
                                         i, p, i, p]
    lib.apex_matmul_bwd_dual.restype = i
    for name in ("apex_conv_bn_rows_per_block", "apex_conv_bn_step"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.apex_conv_bn_stats_parts.argtypes = [ll, i, i, i]
    lib.apex_conv_bn_stats_parts.restype = ll
    lib.apex_conv_bn_dual_parts.argtypes = [ll, i, i, ll, i]
    lib.apex_conv_bn_dual_parts.restype = ll
    lib.apex_conv_bn_tc_info.argtypes = [i, i, p]
    lib.apex_conv_bn_tc_info.restype = i
    lib.apex_conv_bn_tile_check.argtypes = [p, p, p, i, i, p]
    lib.apex_conv_bn_tile_check.restype = i
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


def _launch_fwd(x, w, bn, relu: bool, with_stats: bool, fault: int = 0):
    """The forward kernel: ``(y, sum, sqsum)`` (stats None without
    ``with_stats``).  ``bn`` is (mean, rstd, gamma, beta) or None;
    ``fault`` plants an error in the wgmma kernel for the checks."""
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
        # fp32, contiguous and 16-byte aligned (the wgmma prologue reads
        # them as vectors): a copy only where a view starts off alignment
        params = [t.float().contiguous() for t in bn]
        params = [t if t.data_ptr() % 16 == 0 else t.clone() for t in params]
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
    design = _conv_bn_design("stats", x, w)
    lib = _lib()
    part = None
    if with_stats:
        parts = lib.apex_conv_bn_stats_parts(m, k, n, design)
        part = torch.empty((parts, 2, n), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    mean, rstd, gamma, beta = params or (None,) * 4
    with torch.cuda.device(dev):
        err = lib.apex_conv_bn_fwd(
            x.data_ptr(), w.data_ptr(), ptr(mean), ptr(rstd), ptr(gamma),
            ptr(beta), int(relu), y.data_ptr(), ptr(part), ptr(s), ptr(ss),
            m, k, n, _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], design,
            int(fault), _stream(x))
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
    def forward(ctx, x, w, with_stats, fault):
        if use_kernel(x, w):
            y, s, ss = _launch_fwd(x, w, None, False, with_stats, fault)
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
        return dx, dw, None, None


class _BnReluMatmul(torch.autograd.Function):
    """The custom VJP; residuals are the inputs and y (the normalised
    operand is recomputed, never kept)."""

    @staticmethod
    def forward(ctx, x, mean, rstd, gamma, beta, w, relu, with_stats,
                fault):
        if use_kernel(x, mean, rstd, gamma, beta, w):
            y, s, ss = _launch_fwd(x, w, (mean, rstd, gamma, beta), relu,
                                   with_stats, fault)
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
                dsum.to(beta.dtype), dw, None, None, None)


def matmul_stats(x: torch.Tensor, w: torch.Tensor, *, with_stats: bool = True,
                 _fault: int = 0
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]]:
    """``y = x @ w`` plus the per-column (sum, sqsum) of the stored y.

    x: (M, K), w: (K, N), contiguous fp32 or bf16 on CUDA.  Returns (y in
    x's dtype, sum (N,) fp32, sqsum (N,) fp32), or just y with
    ``with_stats=False`` (the kernel then skips its stats epilogue).
    Differentiable in x and w, the stats included.  For the checks,
    ``_fault`` plants an error in the wgmma kernel (1: each tile's last
    ring stage left out of its products; 2: each block's last row tile
    skipped); the other designs refuse it."""
    return _MatmulStats.apply(x, w, bool(with_stats), int(_fault))


def bn_relu_matmul(x, mean, rstd, gamma, beta, w, *, relu: bool = True,
                   with_stats: bool = True, _fault: int = 0):
    """``z = relu((x - mean) * (rstd * gamma) + beta) @ w`` with the
    normalisation applied to the kernel's operand between its load and
    the product (the normalised tensor never reaches device memory), plus
    the stats of the stored z like :func:`matmul_stats`.  x: (M, K);
    mean, rstd, gamma, beta: (K,) of any float dtype (read as fp32); w:
    (K, N).  Differentiable in all six.  ``_fault`` as for
    :func:`matmul_stats`, and 3: the padded rows and k of the wgmma
    kernel's tiles left unmasked after the prologue."""
    return _BnReluMatmul.apply(x, mean, rstd, gamma, beta, w, bool(relu),
                               bool(with_stats), int(_fault))


def _dual_chunk_rows(m: int, k: int, n: int, step: int, tile: int) -> int:
    """Rows per dw chunk: about :data:`_DW_BLOCKS` dw blocks in all, a
    multiple of the kernel's reduction step."""
    tiles = -(-k // tile) * -(-n // tile)
    chunks = max(1, min(-(-m // step), -(-_DW_BLOCKS // tiles)))
    rows = -(-m // chunks)
    return -(-rows // step) * step


_sched_by_stream: dict = {}


def _sched(device: torch.device, stream: int) -> torch.Tensor:
    """The tiled dual's two tile-ticket counters for this device and
    stream: zeros made once, which the kernel's last block sets back to
    0, so a call needs no clearing pass.  One pair per stream: calls on
    one stream run in order and never share a counter in flight."""
    key = (device.index, stream)
    buf = _sched_by_stream.get(key)
    if buf is None:
        buf = torch.zeros(2, dtype=torch.int32, device=device)
        _sched_by_stream[key] = buf
    return buf


def matmul_bwd_dual(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, *,
                    _fault: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both cotangents of ``y = x @ w``: ``(dx, dw)`` with dx = dy @ w^T in
    x's dtype and dw = x^T @ dy always fp32 (cast it to w's dtype where a
    cotangent contract needs that).  x: (M, K), dy: (M, N), w: (K, N), one
    dtype (fp32 or bf16), contiguous, any M, K, N on CUDA; the plain
    version on the CPU.  ``_fault`` as for :func:`matmul_stats` (1: the
    one-pass design leaves its first stage out instead)."""
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
    design = _conv_bn_design("dual", x, w, dy)
    rows = _dual_chunk_rows(m, k, n, lib.apex_conv_bn_step(),
                            lib.apex_conv_bn_rows_per_block())
    parts = lib.apex_conv_bn_dual_parts(m, k, n, rows, design)
    part = torch.empty((parts, k, n), dtype=torch.float32, device=dev)
    stream = _stream(x)
    sched = _sched(dev, stream) if design == DUAL_TILES else None
    with torch.cuda.device(dev):
        err = lib.apex_matmul_bwd_dual(
            x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
            part.data_ptr(), dw.data_ptr(), m, k, n, rows,
            _DTYPE_CODE[x.dtype], design,
            None if sched is None else sched.data_ptr(), int(_fault), stream)
    if err != 0:
        raise RuntimeError(f"matmul_bwd_dual kernel launch failed: CUDA "
                           f"error {err}")
    matmul_bwd_dual.launches += 1
    return dx, dw


matmul_stats.launches = 0
bn_relu_matmul.launches = 0
matmul_bwd_dual.launches = 0

