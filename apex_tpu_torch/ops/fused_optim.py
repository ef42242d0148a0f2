"""LAMB stage 1: the moment update with the per-tensor norm sums in one
pass — a hand-written CUDA kernel and its plain version.

Counterpart of ``apex_tpu/ops/fused_optim.py``.  :func:`lamb_stage1`
reads one leaf's (g, p, m, v) once and returns the new moments with the
leaf's ``sum(p^2)`` and ``sum(u^2)``, the two reductions the trust ratio
needs, so no separate norm passes are made.  CUDA tensors run
``csrc/fused_lamb.cu`` (the port of ``_lamb_stage1_kernel``) for every
leaf, whatever its size: the JAX package keeps its kernel off by default
and gates it on TPU tiling (``size % 1024``, ``>= 65536``), for reasons
that were the TPU's (the ``pallas_call`` boundary stopped XLA from fusing
the AMP gates into the update loops); eager PyTorch has no such fusion to
lose.  CPU tensors run :func:`lamb_stage1_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel

__all__ = ["lamb_stage1", "lamb_stage1_ref"]

_G_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lamb_stage1_ref(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                    v: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                    b2: float, eps: float, wd: float, adam_w: bool
                    ) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`lamb_stage1`, the same operations in the
    same order (each rounded once, in fp32)."""
    g32 = g.float() * scalars[0]
    p32 = p.float()
    if not adam_w and wd != 0.0:
        g32 = g32 + wd * p32
    skip = scalars[3] > 0.0
    m_new = torch.where(skip, m, b1 * m + (1.0 - b1) * g32)
    v_new = torch.where(skip, v, b2 * v + (1.0 - b2) * g32 * g32)
    u = (m_new / scalars[1]) / (torch.sqrt(v_new / scalars[2]) + eps)
    if adam_w and wd != 0.0:
        u = u + wd * p32
    psq, usq = (p32 * p32).sum(), (u * u).sum()
    m.copy_(m_new)
    v.copy_(v_new)
    return m, v, psq, usq


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fused_lamb")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.apex_lamb_stage1.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong,
                                     i, f, f, f, f, f, f, i, p]
    lib.apex_lamb_stage1.restype = i
    lib.apex_lamb_blocks.argtypes = [ctypes.c_longlong]
    lib.apex_lamb_blocks.restype = ctypes.c_longlong
    return lib


def lamb_stage1(g: torch.Tensor, p: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                b2: float, eps: float, wd: float, adam_w: bool
                ) -> Tuple[torch.Tensor, ...]:
    """LAMB stage 1 for one leaf: returns ``(m, v, sum_p2, sum_u2)``.

    ``g`` (bf16 or fp32) and fp32 ``p``, ``m``, ``v`` of one size, any
    shape; ``scalars`` a device fp32 ``[g_scale, bc1, bc2, skip]``, with
    ``g_scale`` the combined 1/clip (and 1/loss_scale) grad multiplier
    and ``skip`` > 0 on an AMP overflow step, which writes m and v back
    unchanged.  m and v are updated IN PLACE and returned;
    ``u = (m/bc1) / (sqrt(v/bc2) + eps)`` (+ ``wd * p`` in AdamW mode, or
    ``wd * p`` folded into g in L2 mode) is not stored, only its sum of
    squares.  The sums are fp32 0-d tensors, the same bits on every run.
    On CUDA the tensors must be contiguous; anything else raises.
    """
    if not use_kernel(g, p, m, v, scalars):
        return lamb_stage1_ref(g, p, m, v, scalars, b1=b1, b2=b2, eps=eps,
                               wd=wd, adam_w=adam_w)
    n = p.numel()
    if g.dtype not in _G_CODE or any(t.dtype != torch.float32
                                     for t in (p, m, v, scalars)):
        raise ValueError(f"lamb_stage1 kernel takes fp32/bf16 g and fp32 p, "
                         f"m, v and scalars, got {g.dtype}, {p.dtype}, "
                         f"{m.dtype}, {v.dtype}, {scalars.dtype}")
    if any(t.numel() != n for t in (g, m, v)) or scalars.shape != (4,) \
            or n == 0:
        raise ValueError(f"lamb_stage1 kernel takes one non-empty size for "
                         f"g, p, m, v and 4 scalars, got {g.numel()}, {n}, "
                         f"{m.numel()}, {v.numel()}, {tuple(scalars.shape)}")
    if not all(t.is_contiguous() for t in (g, p, m, v, scalars)):
        raise ValueError("lamb_stage1 kernel takes contiguous tensors")
    lib = _lib()
    buf = torch.empty(2 * lib.apex_lamb_blocks(n) + 2, dtype=torch.float32,
                      device=p.device)
    sums = buf[-2:]
    with torch.cuda.device(p.device):
        err = lib.apex_lamb_stage1(
            g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr(),
            scalars.data_ptr(), buf.data_ptr(), sums.data_ptr(), n,
            _G_CODE[g.dtype], b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            int(adam_w), torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lamb_stage1 kernel launch failed: CUDA error "
                           f"{err}")
    lamb_stage1.launches += 1
    return m, v, sums[0], sums[1]


lamb_stage1.launches = 0
