"""Serving-side attention: the paged-attention CUDA kernel and its plain
versions.

Counterpart of the decode-path half of ``apex_tpu/ops/attention.py``:

- :func:`cached_attention`, :func:`quantize_kv` and the materializing
  :func:`paged_cached_attention` are plain PyTorch, written op for op
  after the JAX functions of the same names;
- :func:`paged_fused_attention` is the wrapper of
  ``csrc/paged_attention.cu``, the port of the Pallas serving kernel
  ``_paged_fused_kernel``.  On CPU tensors it runs
  :func:`paged_cached_attention` instead.

All softmax and accumulation math is fp32 whatever the input, cache or
pool dtype; masked scores are the finite ``_NEG_INF`` (never ``-inf``),
as in the JAX package.  The flash-attention training kernels are not
part of this module yet.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel

__all__ = [
    "cached_attention",
    "paged_cached_attention",
    "paged_fused_attention",
    "quantize_kv",
]

_NEG_INF = -1e30
_Q_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_D = 128


def cached_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache_k: Optional[torch.Tensor] = None,
    cache_v: Optional[torch.Tensor] = None,
    cache_lengths: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of T new tokens against a KV cache — the decode path.

    ``q``/``k_new``/``v_new``: (B, H, T, D) projections of the T new
    tokens at global ``positions`` (B, T).  ``cache_k``/``cache_v``:
    (B, H, S, D) history (any dtype) with ``cache_lengths`` (B,) valid
    prefixes; None means no history.  Cache key j is visible to query t
    iff ``j < cache_lengths[b]`` and ``j <= positions[b, t]``; new key t'
    iff ``positions[b, t'] <= positions[b, t]`` and, when given,
    ``block_mask[t, t']``.  One softmax over ``[cache, new]`` scores, in
    fp32; the output is cast to ``q.dtype``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    t = q.shape[2]
    q32 = q.float() * scale
    pos = positions.to(torch.int32)
    pos_q = pos[:, None, :, None]   # (B, 1, T, 1)
    pos_k = pos[:, None, None, :]   # (B, 1, 1, T)

    s_new = torch.einsum("bhqd,bhkd->bhqk", q32, k_new.float())
    ok = pos_k <= pos_q
    if block_mask is not None:
        ok = ok & block_mask.bool()[None, None]
    s_new = torch.where(ok, s_new, _NEG_INF)

    if cache_k is not None:
        if cache_lengths is None:
            raise ValueError("cache_k requires cache_lengths")
        s_c = torch.einsum("bhqd,bhkd->bhqk", q32, cache_k.float())
        j = torch.arange(s_c.shape[3], device=q.device, dtype=torch.int32)
        valid = (j < cache_lengths.to(torch.int32)[:, None, None, None]) \
            & (j <= pos_q)
        s_c = torch.where(valid, s_c, _NEG_INF)
        s = torch.cat([s_c, s_new], dim=-1)
    else:
        s = s_new
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p[..., -t:], v_new.float())
    if cache_k is not None:
        out = out + torch.einsum("bhqk,bhkd->bhqd", p[..., :-t],
                                 cache_v.float())
    return out.to(q.dtype)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis.

    ``x`` (..., D) -> ``(q, scale)``: ``q`` int8 (..., D) and ``scale``
    fp32 (...,) = ``max(amax, 1e-8) / 127``; rounding is half to even
    (``torch.round``, as ``jnp.round``)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / s[..., None]), -127.0, 127.0)
    return q.to(torch.int8), s


def paged_cached_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    *,
    positions: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    cache_lengths: torch.Tensor,
    pool_k_scale: Optional[torch.Tensor] = None,
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    layer: int = 0,
    block_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`cached_attention` reading K/V through a page table — the
    plain, materializing version.

    ``pool_k``/``pool_v``: the full pool ``(num_pages, L, H, page_len,
    D)``, read at ``layer``.  ``page_table`` (B, n_pages) maps each
    row's logical pages to physical ones.  The gather builds each row's
    ``(B, H, n_pages * page_len, D)`` view (dequantized to fp32 against
    ``pool_k_scale``/``pool_v_scale`` for int8 pools) and hands it to
    :func:`cached_attention`."""
    pool_k, pool_v = pool_k[:, layer], pool_v[:, layer]
    if pool_k_scale is not None:
        pool_k_scale = pool_k_scale[:, layer]
        pool_v_scale = pool_v_scale[:, layer]
    b = q.shape[0]
    _, h, page_len, d = pool_k.shape
    n_pages = page_table.shape[1]
    table = page_table.long()

    def view(pool, pscale):
        g = pool[table]  # (B, n_pages, H, page_len, D)
        g = g.permute(0, 2, 1, 3, 4).reshape(b, h, n_pages * page_len, d)
        if pscale is not None:
            s = pscale[table].permute(0, 2, 1, 3).reshape(
                b, h, n_pages * page_len)
            g = g.float() * s[..., None]
        return g

    return cached_attention(
        q, k_new, v_new,
        positions=positions,
        cache_k=view(pool_k, pool_k_scale),
        cache_v=view(pool_v, pool_v_scale),
        cache_lengths=cache_lengths,
        scale=scale,
        block_mask=block_mask,
    )


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("paged_attention").apex_paged_attention
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_fused_attention kernel: {msg}")


def paged_fused_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    *,
    positions: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    cache_lengths: torch.Tensor,
    pool_k_scale: Optional[torch.Tensor] = None,
    pool_v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    layer: int = 0,
    block_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The serving read: page gather, int8 dequant and attention in one
    CUDA kernel (``csrc/paged_attention.cu``).

    Same arguments and result as :func:`paged_cached_attention`.  The
    full 5-D pool is passed with ``layer``, so no per-layer slice copy
    is made, and the gathered view never exists in device memory.  On
    CUDA tensors it takes: ``q`` fp32/bf16 and ``k_new``/``v_new``
    fp32/bf16, each (B, H, T, D) with a unit last stride and ``D`` a
    multiple of 32 up to 128; contiguous pools fp32/bf16/int8 (int8 with
    contiguous fp32 scales, others without); int32 ``page_table``,
    ``cache_lengths`` and ``positions``; ``block_mask`` (T, T) bool.
    Anything else raises.  CPU tensors run :func:`paged_cached_attention`.
    """
    if not use_kernel(q, k_new, v_new, positions, pool_k, pool_v, page_table,
                      cache_lengths, pool_k_scale, pool_v_scale, block_mask):
        return paged_cached_attention(
            q, k_new, v_new, positions=positions, pool_k=pool_k,
            pool_v=pool_v, page_table=page_table,
            cache_lengths=cache_lengths, pool_k_scale=pool_k_scale,
            pool_v_scale=pool_v_scale, scale=scale, layer=layer,
            block_mask=block_mask,
        )
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, t, d = q.shape
    num_pages, n_layers, hp, page_len, dp = pool_k.shape
    _check(q.dtype in _Q_CODE, f"q dtype {q.dtype}")
    _check(k_new.dtype in _Q_CODE and v_new.dtype == k_new.dtype,
           f"k_new/v_new dtypes {k_new.dtype}/{v_new.dtype}")
    _check(k_new.shape == q.shape and v_new.shape == q.shape,
           f"k_new/v_new shapes {tuple(k_new.shape)}/{tuple(v_new.shape)} "
           f"vs q {tuple(q.shape)}")
    _check(all(x.stride(-1) == 1 for x in (q, k_new, v_new)),
           "q/k_new/v_new need a unit last stride")
    _check(d % 32 == 0 and d <= _MAX_D, f"head dim {d}")
    _check((hp, dp) == (h, d), f"pool heads/dim {(hp, dp)} vs q {(h, d)}")
    _check(pool_v.shape == pool_k.shape and pool_v.dtype == pool_k.dtype
           and pool_k.dtype in _POOL_CODE, "pool_k/pool_v shapes or dtypes")
    _check(pool_k.is_contiguous() and pool_v.is_contiguous(),
           "pools must be contiguous")
    _check(0 <= layer < n_layers, f"layer {layer} of {n_layers}")
    quantized = pool_k.dtype == torch.int8
    if quantized:
        for s in (pool_k_scale, pool_v_scale):
            _check(s is not None and s.dtype == torch.float32
                   and s.shape == pool_k.shape[:4] and s.is_contiguous(),
                   "int8 pools need contiguous fp32 scales "
                   f"of shape {tuple(pool_k.shape[:4])}")
    else:
        _check(pool_k_scale is None and pool_v_scale is None,
               "scales are for int8 pools only")
    n_pages = page_table.shape[1]
    for name, x, shape in (("page_table", page_table, (b, n_pages)),
                           ("cache_lengths", cache_lengths, (b,)),
                           ("positions", positions, (b, t))):
        _check(x.dtype == torch.int32 and tuple(x.shape) == shape
               and x.is_contiguous(),
               f"{name} must be contiguous int32 of shape {shape}")
    if block_mask is not None:
        _check(block_mask.dtype == torch.bool
               and tuple(block_mask.shape) == (t, t)
               and block_mask.is_contiguous(),
               f"block_mask must be contiguous bool ({t}, {t})")

    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    ptrs = (ctypes.c_void_p * 12)(
        ptr(q), ptr(k_new), ptr(v_new), ptr(pool_k), ptr(pool_v),
        ptr(pool_k_scale), ptr(pool_v_scale), ptr(page_table),
        ptr(cache_lengths), ptr(positions), ptr(block_mask), ptr(out))
    dims = (ctypes.c_longlong * 17)(
        b, h, t, d, n_layers, layer, page_len, n_pages,
        q.stride(0), q.stride(1), q.stride(2),
        k_new.stride(0), k_new.stride(1), k_new.stride(2),
        v_new.stride(0), v_new.stride(1), v_new.stride(2))
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            ctypes.addressof(ptrs), ctypes.addressof(dims), float(scale),
            _Q_CODE[q.dtype], _Q_CODE[k_new.dtype], _POOL_CODE[pool_k.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"paged_fused_attention kernel launch failed: CUDA error {err}")
    paged_fused_attention.launches += 1
    return out


paged_fused_attention.launches = 0
