"""Comms-efficient gradient exchange: compressed boundary collectives and
Adasum.

Counterpart of the device half of ``apex_tpu/train/compress.py``.  Every
reduction policy of :mod:`apex_tpu_torch.train.accum` moves a full-width
fp32 gradient through one collective a boundary; this module makes the
bytes of that collective a policy:

- :class:`CompressionSpec`, ``none | bf16 | int8``.  ``none`` (the
  default) leaves every step exactly as it was built without
  compression; ``bf16`` casts around the SUM (half the bytes); ``int8``
  quantizes with a shared scale (a quarter of the bytes) and carries the
  quantization error into the next boundary through an fp32
  error-feedback residual (:class:`EfState`, EF-SGD's fix for a biased
  quantizer);
- :func:`compress_allreduce` and :func:`compress_reduce_scatter`, the
  codecs around a boundary's all-reduce or reduce-scatter over an
  :class:`~apex_tpu_torch.parallel.mesh.Axis`;
- :func:`adasum_pair` and :func:`adasum_combine`, Adasum's pairwise
  combining rule (arxiv 2006.02924), behind
  :func:`apex_tpu_torch.train.accum.adasum_microbatch_step`.

int8's shared scale is ``max |e|`` over the axis (one scalar MAX
all-reduce, counted as ``pmax``) over ``qmax = 127 // world``, so the
direct int8 SUM of ``world`` ranks cannot overflow.  A non-finite shared
max (an inf or a NaN in some rank's gradient) decodes as a non-finite
sum on every rank, so the step's overflow gate skips the boundary and
keeps the residual.  The JAX package takes scale 1 there and clips the
inf to ``qmax``: the mean policy's gate never sees it and the residual
turns non-finite for good (ROADMAP C); ZeRO and FSDP check the
accumulated gradient before the codec, so there both agree.  The port reads no
environment variable: the mode is an explicit argument (JAX's
``APEX_TPU_GRAD_COMPRESS`` has no counterpart).  The host blob codecs
of the JAX module serve only ``fleet``'s ``DcnExchange`` and come with
the host planes (ROADMAP A.7).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from apex_tpu_torch.parallel.mesh import Axis, pmax, psum, reduce_scatter

__all__ = ["COMPRESSION_MODES", "CompressionSpec", "EfState", "adasum_combine",
           "adasum_pair", "compress_allreduce", "compress_reduce_scatter",
           "compression_default", "ef_init", "ef_length", "ef_state_spec"]

COMPRESSION_MODES = ("none", "bf16", "int8")


class CompressionSpec(NamedTuple):
    """The gradient-exchange compression policy: ``mode`` one of
    :data:`COMPRESSION_MODES`; ``int8`` implies the fp32 error-feedback
    residual."""

    mode: str = "none"

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def error_feedback(self) -> bool:
        return self.mode == "int8"


def compression_default(spec=None) -> CompressionSpec:
    """The policy from an explicit argument: a :class:`CompressionSpec`, a
    mode string (``"int8_ef"`` and ``"int8+ef"`` read as ``"int8"``), or
    None for ``none``."""
    if spec is None:
        return CompressionSpec("none")
    mode = spec.mode if isinstance(spec, CompressionSpec) else str(
        spec).strip().lower()
    if mode in ("int8_ef", "int8+ef"):
        mode = "int8"
    if mode not in COMPRESSION_MODES:
        raise ValueError(f"compression mode must be one of "
                         f"{COMPRESSION_MODES}, got {mode!r}")
    return CompressionSpec(mode)


class EfState(NamedTuple):
    """The int8 error-feedback residual: ``ef_residual`` (world, L) fp32
    over the dp axis, of which each rank's carry holds its own (1, L) row
    (``train_state_rules`` shards it; :func:`ef_state_spec`)."""

    ef_residual: Any


def ef_length(tree) -> int:
    """The flat length of a gradient dict: the residual's L for the mean
    policy (ZeRO and FSDP use their flat spec's ``padded``)."""
    return int(sum(t.numel() for t in tree.values()))


def ef_init(length: int, world: int = 1, *, device=None) -> EfState:
    """A zero residual of ``world`` rows; a rank's carry takes one row
    (``world=1``, or its row of the full one)."""
    return EfState(torch.zeros((int(world), int(length)),
                               dtype=torch.float32, device=device))


def ef_state_spec(axis_name: str = "data") -> EfState:
    """The :class:`EfState`'s spec tree: the residual rides
    ``axis_name`` on its leading, per-rank axis (from
    :func:`apex_tpu_torch.sharding.train_state_rules`)."""
    from apex_tpu_torch.sharding import train_state_rules
    from apex_tpu_torch.sharding.rules import _Leaf

    return train_state_rules(axis_name).match(EfState(ef_residual=_Leaf()))


def _int8_quantize(e: torch.Tensor, axis: Axis, world: int):
    """The shared-scale int8 quantization: ``scale = pmax(max |e|) /
    qmax``, ``qmax = 127 // world``, so ``world`` ranks' int8 values sum
    within int8; a zero or non-finite max takes scale 1.  Returns ``(q,
    scale, amax)``."""
    qmax = float(max(127 // world, 1))
    amax = pmax(torch.amax(torch.abs(e)), axis)
    ok = (amax > 0) & torch.isfinite(amax)
    # a tensor divisor: CUDA divides by a Python number as a multiply by
    # its reciprocal, one ulp off the CPU's division
    scale = torch.where(ok, amax / amax.new_tensor(qmax),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(e / scale), -qmax, qmax).to(torch.int8)
    return q, scale, amax


def _decode(summed_q: torch.Tensor, scale, amax) -> torch.Tensor:
    """The int8 SUM back in fp32; a non-finite shared max (the same on
    every rank) decodes as itself, so the overflow stays visible."""
    out = summed_q.float() * scale
    return torch.where(torch.isfinite(amax), out, amax)


def _need_residual(residual) -> None:
    if residual is None:
        raise ValueError("int8 compression requires an EfState residual")


def compress_allreduce(flat: torch.Tensor, axis: Axis, spec: CompressionSpec,
                       residual: Optional[torch.Tensor] = None, *,
                       tag: str = "all_reduce"):
    """One boundary SUM all-reduce of the flat fp32 gradient over
    ``axis``; returns ``(summed fp32, new residual)``.  ``none``: an fp32
    SUM (the residual passes through); ``bf16``: the SUM in bf16;
    ``int8``: ``flat + residual`` quantized, the int8 SUM times the
    scale, and the quantization error as the new residual (this rank's
    (L,) row; the caller keeps the old one on an overflowed boundary,
    which a non-finite shared max makes visible in the sum)."""
    if not spec.enabled:
        return psum(flat, axis, tag=tag), residual
    if spec.mode == "bf16":
        return psum(flat.to(torch.bfloat16), axis, tag=tag).float(), residual
    _need_residual(residual)
    e = flat + residual
    q, scale, amax = _int8_quantize(e, axis, axis.size)
    new_residual = e - q.float() * scale
    return _decode(psum(q, axis, tag=tag), scale, amax), new_residual


def compress_reduce_scatter(flat: torch.Tensor, axis: Axis,
                            spec: CompressionSpec,
                            residual: Optional[torch.Tensor] = None, *,
                            tag: str = "reduce_scatter"):
    """One boundary SUM reduce-scatter of the padded flat gradient: this
    rank's ``L / world`` block of the sum, and the new residual (over the
    whole flat vector: the quantization error is the rank's own, before
    the scatter)."""
    if not spec.enabled:
        return reduce_scatter(flat, axis, tag=tag), residual
    if spec.mode == "bf16":
        return reduce_scatter(flat.to(torch.bfloat16), axis,
                              tag=tag).float(), residual
    _need_residual(residual)
    e = flat + residual
    q, scale, amax = _int8_quantize(e, axis, axis.size)
    new_residual = e - q.float() * scale
    return (_decode(reduce_scatter(q, axis, tag=tag), scale, amax),
            new_residual)


# -- Adasum (arxiv 2006.02924) ------------------------------------------------


def adasum_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b`` over the last
    axis: orthogonal blocks add, parallel ones average; a zero-norm block
    takes coefficient 1."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    na = torch.sum(a * a, dim=-1, keepdim=True)
    nb = torch.sum(b * b, dim=-1, keepdim=True)
    ca = torch.where(na > 0, 1.0 - dot / torch.where(na > 0, 2.0 * na, 1.0),
                     1.0)
    cb = torch.where(nb > 0, 1.0 - dot / torch.where(nb > 0, 2.0 * nb, 1.0),
                     1.0)
    return ca * a + cb * b


def adasum_combine(gathered: torch.Tensor) -> torch.Tensor:
    """The recursive-halving Adasum over an all-gathered (world, L)
    stack: every rank computes the same log2(world) pairwise tree on the
    same operand, so the result agrees across ranks by construction.
    ``world`` must be a power of two."""
    world = int(gathered.shape[0])
    if world & (world - 1):
        raise ValueError(f"adasum needs a power-of-two dp world, got {world}")
    arr = gathered.float()
    while arr.shape[0] > 1:
        arr = adasum_pair(arr[0::2], arr[1::2])
    return arr[0]
