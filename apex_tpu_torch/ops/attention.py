"""Attention: the paged-attention and flash-attention CUDA kernels and
their plain versions.

Counterpart of ``apex_tpu/ops/attention.py``.  The serving half:

- :func:`cached_attention`, :func:`quantize_kv` and the materializing
  :func:`paged_cached_attention` are plain PyTorch, written op for op
  after the JAX functions of the same names;
- :func:`paged_fused_attention` is the wrapper of
  ``csrc/paged_attention.cu``, the port of the Pallas serving kernel
  ``_paged_fused_kernel``.  On CPU tensors it runs
  :func:`paged_cached_attention` instead.

The training half:

- :func:`attention_ref` and the counter-hash dropout mask
  :func:`_keep_mask` (bit for bit the JAX function), plain PyTorch;
- :func:`flash_attention`, a ``torch.autograd.Function`` over
  :func:`flash_attention_fwd` and :func:`flash_attention_bwd`, the
  wrappers of ``csrc/flash_attention.cu`` (ports of the Pallas
  ``_fwd_kernel``/``_fwd_kernel_nobias`` and of the combined backward
  ``_bwd_fused_kernel``/``_bwd_fused_nobias``, which here also writes
  the bias gradient of the two-pass ``_bwd_dq_kernel``), and
  :func:`flash_attention_bwd_acc`, the port of the dq-accumulating
  ``_bwd_fused_acc_kernel``/``_bwd_fused_acc_nobias`` (``dq_acc``).
  bf16 q, k, v at head_dim 64 or 128 run the tensor-core kernels, fp32
  ones at head_dim 64 the fp32 FMA kernels (:data:`_FLASH_DIMS`).  On
  CPU tensors they run their plain versions
  :func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref`.

All softmax and accumulation math is fp32 whatever the input, cache or
pool dtype; masked scores are the finite ``_NEG_INF`` (never ``-inf``),
as in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from apex_tpu_torch.ops import _build
from apex_tpu_torch.ops._common import use_kernel
from apex_tpu_torch.ops.softmax_xentropy import _logsumexp

__all__ = [
    "attention_ref",
    "cached_attention",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_acc",
    "flash_attention_bwd_ref",
    "flash_attention_fwd",
    "flash_attention_fwd_ref",
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


#: the largest T the split-K decode kernel takes (csrc kDecodeMaxT); it
#: runs every T up to this for fp32 q or fp32 pools, and up to
#: :data:`PAGED_TC_MIN_T` - 1 where the tensor-core kernel can take over
PAGED_DECODE_MAX_T = 16
#: the smallest T the tensor-core kernel takes (bf16 q, bf16 or int8
#: pools): on an H100 the decode kernel's time grows with T and the
#: tensor-core kernel's hardly does, and they cross between T = 4 and 8
#: (measured with ``tools/paged_ab.py``; PERF.md §6)
PAGED_TC_MIN_T = 8
_FMA, _DECODE, _TENSOR_CORES = 0, 1, 2  # csrc's design codes
_SPLIT_KEYS = 64      # keys a decode split covers at least (one chunk)
_PREFILL_TILES = 8    # 64-key tiles a prefill split covers at least
_MAX_SPLITS = 64      # splits a row has at most, in either kernel
_PAGE_WIN = 1024      # page entries a prefill split holds (csrc kPageWin)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _paged_design(t: int, q_dtype: torch.dtype,
                  pool_dtype: torch.dtype) -> int:
    """Which kernel of ``csrc/paged_attention.cu`` a call runs: the
    tensor-core prefill kernel for bf16 q with bf16 or int8 pools from
    :data:`PAGED_TC_MIN_T` on, else the decode kernel up to
    :data:`PAGED_DECODE_MAX_T`, else the fp32 FMA kernel."""
    if (q_dtype == torch.bfloat16 and pool_dtype != torch.float32
            and t >= PAGED_TC_MIN_T):
        return _TENSOR_CORES
    return _DECODE if t <= PAGED_DECODE_MAX_T else _FMA


def _paged_split(page_len: int, n_pages: int) -> Tuple[int, int]:
    """``(split_pages, n_splits)`` of the decode kernel: each split is a
    run of whole pages, at least 64 keys and at most 64 splits a row (so
    GPT-2 small's 64 pages of 16 give 16 splits of 4 pages)."""
    split_pages = max(_cdiv(_SPLIT_KEYS, page_len),
                      _cdiv(n_pages, _MAX_SPLITS))
    return split_pages, _cdiv(n_pages, split_pages)


def _prefill_split(page_len: int, n_pages: int) -> Tuple[int, int]:
    """``(split_tiles, n_splits)`` of the tensor-core prefill kernel: each
    split is a run of 64-key tiles, at least eight and at most 64 splits
    a query tile, and no more keys than the kernel's page window holds
    (so GPT-2 small's 1024 keys give 2 splits of 512).  Eight tiles a
    split were faster on an H100 than four or two (PERF.md §6)."""
    keys = n_pages * page_len
    tiles = min(max(_PREFILL_TILES, _cdiv(_cdiv(keys, 64), _MAX_SPLITS)),
                (_PAGE_WIN - 2) * page_len // 64)
    return tiles, _cdiv(keys, tiles * 64)


_tickets_by_stream: dict = {}


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The split kernels' n ticket counters for this device and stream:
    zeros made once, which the kernel's merging blocks set back to 0, so
    a call needs no clearing pass.  One buffer per stream: calls on one
    stream run in order and never share a counter in flight."""
    key = (device.index, stream)
    buf = _tickets_by_stream.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _tickets_by_stream[key] = buf
    return buf


def _check(cond: bool, msg) -> None:
    """Raise unless ``cond``; ``msg`` is the message or a function that
    makes it (an f-string costs host time on every call, and the wrapper
    runs 12 times a decode step)."""
    if not cond:
        raise ValueError("paged_fused_attention kernel: "
                         f"{msg() if callable(msg) else msg}")


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
    CUDA kernel launch (``csrc/paged_attention.cu``).

    Same arguments and result as :func:`paged_cached_attention`.  The
    full 5-D pool is passed with ``layer``, so no per-layer slice copy
    is made, and the gathered view never exists in device memory.  On
    CUDA tensors it takes: ``q`` fp32/bf16 and ``k_new``/``v_new``
    fp32/bf16, each (B, H, T, D) with a unit last stride and ``D`` a
    multiple of 32 up to 128; contiguous pools fp32/bf16/int8 starting
    on 16 bytes (int8 with contiguous fp32 scales, others without);
    int32 ``page_table``, ``cache_lengths`` and ``positions``;
    ``block_mask`` (T, T) bool.  Anything else raises, fp16 among them
    (ROADMAP B.2).  CPU tensors run :func:`paged_cached_attention`.

    The kernel (:func:`_paged_design`): bf16 q with bf16 or int8 pools
    run the split-K decode kernel (:func:`_paged_split`) below T =
    :data:`PAGED_TC_MIN_T` (8: decode steps and short speculative verify
    blocks) and the split-K tensor-core kernel (:func:`_prefill_split`)
    from there on; fp32 q or fp32 pools run the decode kernel up to T =
    :data:`PAGED_DECODE_MAX_T` (16) and the fp32 FMA kernel above.  The
    split kernels write fp32 partials to a workspace that the last split
    of each row (or query tile) merges in split order, in the same
    launch.
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
    _check(torch.float16 not in (q.dtype, k_new.dtype, pool_k.dtype),
           "fp16 q, new keys or pools are not taken yet (ROADMAP B.2: "
           "fp16 inputs to the kernels)")
    _check(q.dtype in _Q_CODE, lambda: f"q dtype {q.dtype}")
    _check(k_new.dtype in _Q_CODE and v_new.dtype == k_new.dtype,
           lambda: f"k_new/v_new dtypes {k_new.dtype}/{v_new.dtype}")
    _check(k_new.shape == q.shape and v_new.shape == q.shape,
           lambda: f"k_new/v_new shapes {tuple(k_new.shape)}/"
           f"{tuple(v_new.shape)} vs q {tuple(q.shape)}")
    _check(all(x.stride(-1) == 1 for x in (q, k_new, v_new)),
           "q/k_new/v_new need a unit last stride")
    _check(d % 32 == 0 and d <= _MAX_D, lambda: f"head dim {d}")
    _check((hp, dp) == (h, d),
           lambda: f"pool heads/dim {(hp, dp)} vs q {(h, d)}")
    _check(pool_v.shape == pool_k.shape and pool_v.dtype == pool_k.dtype
           and pool_k.dtype in _POOL_CODE, "pool_k/pool_v shapes or dtypes")
    _check(pool_k.is_contiguous() and pool_v.is_contiguous(),
           "pools must be contiguous")
    _check(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
           "pools must start on 16 bytes")
    _check(0 <= layer < n_layers, lambda: f"layer {layer} of {n_layers}")
    quantized = pool_k.dtype == torch.int8
    if quantized:
        for s in (pool_k_scale, pool_v_scale):
            _check(s is not None and s.dtype == torch.float32
                   and s.shape == pool_k.shape[:4] and s.is_contiguous(),
                   lambda: "int8 pools need contiguous fp32 scales "
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
               lambda: f"{name} must be contiguous int32 of shape {shape}")
    if block_mask is not None:
        _check(block_mask.dtype == torch.bool
               and tuple(block_mask.shape) == (t, t)
               and block_mask.is_contiguous(),
               lambda: f"block_mask must be contiguous bool ({t}, {t})")

    out = torch.empty((b, h, t, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    design = _paged_design(t, q.dtype, pool_k.dtype)
    ws = tickets = None
    split = n_splits = 0
    if design == _DECODE:
        split, n_splits = _paged_split(page_len, n_pages)
        rows = b * h  # (b, h) rows of T queries, T rows a partial
        part_rows, n_parts = t, n_splits + 1  # + the new keys' split
    elif design == _TENSOR_CORES:
        split, n_splits = _prefill_split(page_len, n_pages)
        rows = b * h * _cdiv(t, 64)  # 64-query tiles, 64 rows a partial
        part_rows, n_parts = 64, n_splits + _cdiv(t, 64)  # + new-key tiles
    if n_splits:
        ws = torch.empty(rows * n_parts * part_rows * (d + 2),
                         dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, rows)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    ptrs = (ctypes.c_void_p * 14)(
        ptr(q), ptr(k_new), ptr(v_new), ptr(pool_k), ptr(pool_v),
        ptr(pool_k_scale), ptr(pool_v_scale), ptr(page_table),
        ptr(cache_lengths), ptr(positions), ptr(block_mask), ptr(out),
        ptr(ws), ptr(tickets))
    dims = (ctypes.c_longlong * 20)(
        b, h, t, d, n_layers, layer, page_len, n_pages,
        q.stride(0), q.stride(1), q.stride(2),
        k_new.stride(0), k_new.stride(1), k_new.stride(2),
        v_new.stride(0), v_new.stride(1), v_new.stride(2),
        split, n_splits, design)
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            ctypes.addressof(ptrs), ctypes.addressof(dims), float(scale),
            _Q_CODE[q.dtype], _Q_CODE[k_new.dtype], _POOL_CODE[pool_k.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"paged_fused_attention kernel launch failed: CUDA error {err}")
    paged_fused_attention.launches += 1
    return out


paged_fused_attention.launches = 0


# ---------------------------------------------------------------------------
# flash attention (training): the dropout hash, plain versions, kernels
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
#: head_dims the flash kernels take, by input dtype: bf16 runs the
#: tensor-core kernels, fp32 the fp32 FMA kernels
_FLASH_DIMS = {torch.bfloat16: (64, 128), torch.float32: (64,)}
_FLASH_TILE = 64  # the kernels' key tile: probs_bf16's forward rounds per tile

#: Whether :func:`flash_attention` and :func:`flash_attention_bwd` take the
#: dq-accumulating backward (:func:`flash_attention_bwd_acc`) when a call
#: passes no ``dq_acc``.  Off, as the JAX package's ``_FUSED_DQ_ACC``: the
#: two backwards give the same bits, and which is faster on the card is
#: still to be measured.
DQ_ACC_DEFAULT = False


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for an int64 ``a`` in [0, 2^32) and a 32-bit
    constant ``c``, in int64 without overflow: the uint32 wrap-around
    multiply of the JAX hash (torch's uint32 support is partial)."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _keep_mask(seed, bh, row0, col0, shape, rate: float) -> torch.Tensor:
    """Bernoulli(1 - rate) keep mask from the murmur3-fmix32-style hash
    of (seed, batch*head index, global row, global col) — bit for bit
    ``apex_tpu.ops.attention._keep_mask``.

    ``seed``, ``bh``, ``row0``, ``col0`` are ints or int tensors that
    broadcast against the (rows, cols) ``shape`` (``bh`` of shape
    (BH, 1, 1) gives a (BH, rows, cols) mask)."""
    dev = next((t.device for t in (seed, bh, row0, col0)
                if isinstance(t, torch.Tensor)), None)
    i64 = lambda t: torch.as_tensor(t, device=dev).long()  # noqa: E731
    rows = i64(row0) + torch.arange(shape[0], device=dev)[:, None]
    cols = i64(col0) + torch.arange(shape[1], device=dev)[None, :]
    x = (_mul32(rows & _M32, 0x9E3779B1) + _mul32(cols & _M32, 0x85EBCA77)
         + _mul32(i64(bh) & _M32, 0xC2B2AE3D)) & _M32
    x = x ^ (i64(seed) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x < _keep_thresh(rate)


def _keep_thresh(rate: float) -> int:
    """keep iff hash < (1 - rate) * 2^32 (``attention.py:154``)."""
    return min(int((1.0 - rate) * 2 ** 32), 2 ** 32 - 1)


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    dropout_heads=None,
) -> torch.Tensor:
    """Plain attention.  q, k, v: (B, H, S, D); bias: (B, Sq, Sk) additive.

    ``dropout_rate`` > 0 applies probability dropout with the same
    counter-based mask as the kernel; ``dropout_heads=(h_total,
    head_offset)`` keys it on global head indices."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias[:, None].float()
    if causal:
        s = torch.where(_causal(sq, sk, q.device), s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        h_total, head0 = (h, 0) if dropout_heads is None else dropout_heads
        i = torch.arange(b * h, device=q.device)
        bhg = (i // h) * h_total + torch.as_tensor(head0).long() + i % h
        keep = _keep_mask(dropout_seed, bhg[:, None, None], 0, 0, (sq, sk),
                          dropout_rate).reshape(b, h, sq, sk)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _causal(sq: int, sk: int, device) -> torch.Tensor:
    row = torch.arange(sq, device=device)[:, None]
    return row >= torch.arange(sk, device=device)[None, :]


def _pack_seed(dropout_seed, row_offset=0, col_offset=0, head_offset=0, *,
               device) -> torch.Tensor:
    """The kernel's device int32[4]: [dropout seed, row offset, col
    offset, head offset] (``attention.py::_pack_seed``).  Built on the
    device (a tensor seed stays there), so it costs no host sync."""
    if isinstance(dropout_seed, torch.Tensor):
        seed = dropout_seed.to(device=device, dtype=torch.int32).reshape(1)
    else:
        seed = torch.full((1,), 0 if dropout_seed is None
                          else int(dropout_seed), dtype=torch.int32,
                          device=device)
    offs = [torch.full((1,), int(o), dtype=torch.int32, device=device)
            for o in (row_offset, col_offset, head_offset)]
    return torch.cat([seed, *offs])


def _drop_keep(seed_pack, bh_count, h_map, sq, sk, rate):
    """The (BH, sq, sk) keep mask the kernels draw from ``seed_pack``."""
    h_local, h_total = h_map
    i = torch.arange(bh_count, device=seed_pack.device)
    bh = (i // h_local) * h_total + seed_pack[3].long() + i % h_local
    return _keep_mask(seed_pack[0], bh[:, None, None], seed_pack[1],
                      seed_pack[2], (sq, sk), rate)


def _bias_scores(s, bias):
    """``s`` (BH, Sq, Sk) plus the (B, Sq, Sk) ``bias`` of each
    batch*head's batch, ``bh // (BH / B)``, in fp32 (no copy of the bias
    per head)."""
    if bias is None:
        return s
    bh, sq, sk = s.shape
    b = bias.shape[0]
    return (s.reshape(b, bh // b, sq, sk) + bias.float()[:, None]).reshape(
        bh, sq, sk)


def flash_attention_fwd_ref(q3, k3, v3, seed_pack, scale: float,
                            causal: bool, rate: float, h_map, bias=None,
                            probs_bf16: bool = False):
    """Plain version of the forward kernel on (BH, S, D), with an optional
    additive (B, Sq, Sk) ``bias``: returns ``(o, lse)``, o in q's dtype
    and the fp32 per-row logsumexp.  With ``probs_bf16`` and bf16 inputs
    it walks the kernel's 64-key tiles with the online softmax and rounds
    each tile's ``exp(s - m_running)`` (after the dropout mask) to bf16
    before p.V, as the kernel does; for fp32 inputs the rounding is the
    identity."""
    sq, sk = q3.shape[1], k3.shape[1]
    s = _bias_scores(
        torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale, bias)
    if causal:
        s = torch.where(_causal(sq, sk, q3.device), s, _NEG_INF)
    keep = None
    if rate > 0.0:
        keep = _drop_keep(seed_pack, q3.shape[0], h_map, sq, sk, rate)
    if probs_bf16 and q3.dtype != torch.float32:
        return _fwd_tiled_probs(s, keep, v3, rate, q3.dtype)
    lse = _logsumexp(s)
    p = torch.exp(s - lse[..., None])
    if keep is not None:
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    o = torch.einsum("bqk,bkd->bqd", p, v3.float()).to(q3.dtype)
    return o, lse


def _fwd_tiled_probs(s, keep, v3, rate: float, dtype):
    """The forward's online softmax over 64-key tiles with each tile's
    probabilities rounded to ``dtype`` before p.V (``probs_bf16``):
    ``(o, lse)`` from the fp32 scores ``s`` (BH, Sq, Sk)."""
    bh, sq, sk = s.shape
    m = torch.full((bh, sq), _NEG_INF, device=s.device)
    lsum = torch.zeros(bh, sq, device=s.device)
    acc = torch.zeros(bh, sq, v3.shape[2], device=s.device)
    v32 = v3.float()
    for k0 in range(0, sk, _FLASH_TILE):
        st = s[:, :, k0:k0 + _FLASH_TILE]
        m_new = torch.maximum(m, st.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        lsum = alpha * lsum + p.sum(dim=-1)
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + _FLASH_TILE], p, 0.0)
        p = p.to(dtype).float()
        acc = acc * alpha[..., None] + torch.einsum(
            "bqk,bkd->bqd", p, v32[:, k0:k0 + _FLASH_TILE])
        m = m_new
    l_safe = torch.where(lsum == 0.0, 1.0, lsum)
    denom = l_safe * (1.0 - rate) if rate > 0.0 else l_safe
    return (acc / denom[..., None]).to(dtype), m + torch.log(l_safe)


def flash_attention_bwd_ref(q3, k3, v3, o, lse, do, seed_pack,
                            scale: float, causal: bool, rate: float, h_map,
                            bias=None, bias_grad: bool = False,
                            probs_bf16: bool = False):
    """Plain version of the backward kernels on (BH, S, D) (the partials
    and the dq-accumulating one compute the same function): recomputes p
    from lse, takes delta = rowsum(do * o), returns ``(dq, dk, dv,
    dbias)`` with the grads in q's dtype and, with ``bias_grad``, ``dbias
    = p * (dp - delta)`` (no ``scale`` factor) per batch*head as fp32
    (BH, Sq, Sk), else None; every product accumulates in fp32.  With
    ``probs_bf16`` pd and ds are rounded to q's dtype before their
    products (dbias keeps the unrounded value)."""
    sq, sk = q3.shape[1], k3.shape[1]
    q32, k32, v32, do32 = q3.float(), k3.float(), v3.float(), do.float()
    delta = (do32 * o.float()).sum(dim=-1)
    s = _bias_scores(torch.einsum("bqd,bkd->bqk", q32, k32) * scale, bias)
    if causal:
        s = torch.where(_causal(sq, sk, q3.device), s, _NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do32, v32)
    if rate > 0.0:
        keep = _drop_keep(seed_pack, q3.shape[0], h_map, sq, sk, rate)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    else:
        pd = p
    dsb = p * (dp - delta[..., None])
    ds = dsb * scale
    dt = q3.dtype
    if probs_bf16:
        pd, ds = pd.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bqk,bqd->bkd", pd, do32)
    dk = torch.einsum("bqk,bqd->bkd", ds, q32)
    dq = torch.einsum("bqk,bkd->bqd", ds, k32)
    return (dq.to(dt), dk.to(dt), dv.to(dt),
            dsb if bias is not None and bias_grad else None)


@functools.lru_cache(maxsize=None)
def _flash_lib():
    lib = _build.load("flash_attention")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    u = ctypes.c_uint
    bias = [p, i, i, ll, ll]  # pointer, dtype code, heads, batch/row strides
    # ..., bh, sq, sk, h_local, h_total, scale, causal, rate, thresh
    shape = [i, i, i, i, i, f, i, f, u]
    # ..., probs_bf16, fault, head_dim, dtype code, stream
    tail = [i, i, i, i, p]
    lib.apex_flash_fwd.argtypes = [p, p, p, p, p, p, *bias, *shape, *tail]
    lib.apex_flash_fwd.restype = i
    lib.apex_flash_bwd.argtypes = [p, p, p, p, p, p, p, *bias, p, p, p, p,
                                   p, *shape, *tail]
    lib.apex_flash_bwd.restype = i
    lib.apex_flash_bwd_acc.argtypes = [p, p, p, p, p, p, p, *bias, p, p, p,
                                       p, p, *shape, *tail]
    lib.apex_flash_bwd_acc.restype = i
    lib.apex_flash_dq_tiles.argtypes = [i, i, i]
    lib.apex_flash_dq_tiles.restype = ll
    lib.apex_flash_acc_floats.argtypes = [i, i, i]
    lib.apex_flash_acc_floats.restype = ll
    lib.apex_flash_acc_turns.argtypes = [i, i]
    lib.apex_flash_acc_turns.restype = ll
    lib.apex_flash_tc_info.argtypes = [i, i, i, p]
    lib.apex_flash_tc_info.restype = i
    return lib


def _flash_check(q3, k3, v3, seed_pack, bias) -> None:
    """What the flash kernels take; raises on anything else: bf16 q, k,
    v at head_dim 64 or 128 (the tensor-core kernels), fp32 at 64 (the
    FMA kernels)."""
    bh, sq, d = q3.shape
    if q3.dtype not in _FLASH_DIMS or k3.dtype != q3.dtype \
            or v3.dtype != q3.dtype:
        raise ValueError(f"flash attention kernel takes fp32/bf16 q, k, v of "
                         f"one dtype, got {q3.dtype}/{k3.dtype}/{v3.dtype}")
    dims = _FLASH_DIMS[q3.dtype]
    if d not in dims or k3.shape[2] != d or v3.shape != k3.shape \
            or k3.shape[0] != bh:
        raise ValueError(f"flash attention kernel takes head_dim "
                         f"{' or '.join(map(str, dims))} at {q3.dtype} and "
                         f"matching k/v, got q {tuple(q3.shape)}, k "
                         f"{tuple(k3.shape)}, v {tuple(v3.shape)}")
    if not 1 <= bh <= 65535 or sq < 1 or k3.shape[1] < 1:
        raise ValueError(f"flash attention kernel takes 1..65535 "
                         f"batch*heads and non-empty sequences, got "
                         f"{tuple(q3.shape)}")
    if not (q3.is_contiguous() and k3.is_contiguous()
            and v3.is_contiguous()):
        raise ValueError("flash attention kernel takes contiguous q, k, v")
    _check_aligned(q3, k3, v3)
    if seed_pack.dtype != torch.int32 or seed_pack.shape != (4,):
        raise ValueError("flash attention kernel takes an int32[4] seed pack")
    if bias is not None:
        b = bias.shape[0]
        if bias.dim() != 3 or b < 1 or bh % b \
                or tuple(bias.shape[1:]) != (sq, k3.shape[1]):
            raise ValueError(f"flash attention kernel takes a (B, Sq, Sk) "
                             f"bias with B dividing {bh}, got "
                             f"{tuple(bias.shape)}")
        if bias.dtype not in _Q_CODE or (bias.stride(2) != 1
                                         and bias.shape[2] > 1):
            raise ValueError(f"flash attention kernel takes an fp32/bf16 "
                             f"bias with a unit last stride, got "
                             f"{bias.dtype} strides {bias.stride()}")


def _check_aligned(*tensors) -> None:
    """The tensor-core kernels stage bf16 tiles with 16-byte ``cp.async``:
    raises unless each bf16 tensor starts on a 16-byte boundary (a
    contiguous view at an odd offset into its storage may not)."""
    for t in tensors:
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel takes bf16 q, k, v "
                             f"and do starting on a 16-byte boundary, got "
                             f"an address {t.data_ptr() % 16} bytes past "
                             f"one")


def _bias_args(bias, bh):
    """(pointer, dtype code, batch*heads per bias batch, batch stride,
    row stride) of the kernels' bias arguments."""
    if bias is None:
        return None, 0, 1, 0, 0
    return (bias.data_ptr(), _Q_CODE[bias.dtype], bh // bias.shape[0],
            bias.stride(0), bias.stride(1))


def _shape_args(q3, k3, scale, causal, rate, h_map):
    """(bh, sq, sk, h_local, h_total, scale, causal, rate, thresh) of the
    kernels' arguments."""
    return (q3.shape[0], q3.shape[1], k3.shape[1], h_map[0], h_map[1],
            float(scale), int(causal), float(rate), _keep_thresh(rate))


def flash_attention_fwd(q3, k3, v3, seed_pack, scale: float, causal: bool,
                        rate: float, h_map, bias=None,
                        probs_bf16: bool = False, *, _fault: int = 0):
    """Forward on (BH, S, D) with an optional (B, Sq, Sk) ``bias``
    (any batch and row strides, so a broadcast key-padding mask is read
    in place): ``(o, lse)``.  CUDA tensors run ``apex_flash_fwd``; CPU
    tensors :func:`flash_attention_fwd_ref`.  For the checks, ``_fault``
    3 plants an error in the bf16 kernel that they must reject: the rows
    past the end of a ragged tile staged as NaN instead of zeros."""
    if not use_kernel(q3, k3, v3, seed_pack, bias):
        return flash_attention_fwd_ref(q3, k3, v3, seed_pack, scale, causal,
                                       rate, h_map, bias, probs_bf16)
    _flash_check(q3, k3, v3, seed_pack, bias)
    bh, sq, d = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty(bh, sq, dtype=torch.float32, device=q3.device)
    with torch.cuda.device(q3.device):
        err = _flash_lib().apex_flash_fwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o.data_ptr(),
            lse.data_ptr(), seed_pack.data_ptr(), *_bias_args(bias, bh),
            *_shape_args(q3, k3, scale, causal, rate, h_map),
            int(probs_bf16), int(_fault), d, _Q_CODE[q3.dtype],
            torch.cuda.current_stream(q3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_fwd.launches += 1
    return o, lse


def _bwd_inputs(q3, k3, v3, o, lse, do, seed_pack, bias):
    """Checks the backward's inputs; returns (do, delta, lse) as the
    kernels take them."""
    _flash_check(q3, k3, v3, seed_pack, bias)
    if do.shape != q3.shape or do.dtype != q3.dtype or o.shape != q3.shape:
        raise ValueError("flash attention backward takes do and o like q")
    do = do.contiguous()
    _check_aligned(do)
    delta = (do.float() * o.float()).sum(dim=-1)
    return do, delta, lse.contiguous()


def flash_attention_bwd(q3, k3, v3, o, lse, do, seed_pack, scale: float,
                        causal: bool, rate: float, h_map, bias=None,
                        bias_grad: bool = False, probs_bf16: bool = False,
                        dq_acc: Optional[bool] = None, *, _fault: int = 0):
    """Backward on (BH, S, D): ``(dq, dk, dv, dbias)``, dbias as for
    :func:`flash_attention_bwd_ref`.  ``dq_acc`` (None:
    :data:`DQ_ACC_DEFAULT`) hands the call to
    :func:`flash_attention_bwd_acc`, as the JAX package's ``_FUSED_DQ_ACC``
    does, except with a bias and ``bias_grad``, which that backward does
    not take (JAX's fused backwards exclude it too).  Otherwise CUDA
    tensors run ``apex_flash_bwd`` (the combined dk/dv/dq-partials kernel,
    writing dbias with ``bias_grad``, then the fixed-order dq sum); CPU
    tensors :func:`flash_attention_bwd_ref`.  ``_fault`` as for
    :func:`flash_attention_fwd`."""
    with_dbias = bias is not None and bias_grad
    if (DQ_ACC_DEFAULT if dq_acc is None else dq_acc) and not with_dbias:
        return flash_attention_bwd_acc(q3, k3, v3, o, lse, do, seed_pack,
                                       scale, causal, rate, h_map, bias,
                                       probs_bf16, _fault=_fault)
    if not use_kernel(q3, k3, v3, o, lse, do, seed_pack, bias):
        return flash_attention_bwd_ref(q3, k3, v3, o, lse, do, seed_pack,
                                       scale, causal, rate, h_map, bias,
                                       bias_grad, probs_bf16)
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    # dbias is taken from the allocator first, so that a check can hand
    # the kernel a poisoned block (one it has just freed) and see every
    # tile written, causally skipped ones included
    dbias = None
    if with_dbias:
        dbias = torch.empty(bh, sq, sk, dtype=torch.float32, device=q3.device)
    do, delta, lse = _bwd_inputs(q3, k3, v3, o, lse, do, seed_pack, bias)
    lib = _flash_lib()
    tiles = lib.apex_flash_dq_tiles(sq, sk, int(causal))
    part = torch.empty(bh * tiles * 64 * d, dtype=torch.float32,
                       device=q3.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    with torch.cuda.device(q3.device):
        err = lib.apex_flash_bwd(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), seed_pack.data_ptr(),
            *_bias_args(bias, bh), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), part.data_ptr(),
            None if dbias is None else dbias.data_ptr(),
            *_shape_args(q3, k3, scale, causal, rate, h_map),
            int(probs_bf16), int(_fault), d, _Q_CODE[q3.dtype],
            torch.cuda.current_stream(q3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv, dbias


def flash_attention_bwd_acc(q3, k3, v3, o, lse, do, seed_pack, scale: float,
                            causal: bool, rate: float, h_map, bias=None,
                            probs_bf16: bool = False, *, _fault: int = 0,
                            _run: Optional[torch.Tensor] = None):
    """Backward on (BH, S, D) with dq accumulated in key order in one
    running fp32 buffer of (BH, Sq, D) (Sq rounded up to the 64-row tile)
    instead of a partials buffer per visited tile: ``(dq, dk, dv,
    None)``, bit for bit those of :func:`flash_attention_bwd` (no
    ``bias_grad``).  CUDA tensors run ``apex_flash_bwd_acc`` (one launch,
    no second pass); CPU tensors :func:`flash_attention_bwd_ref`.  For the
    checks: ``_fault`` plants an error in the kernel that they must
    reject (1: key tile 1's contribution dropped; 2: the contributions
    added in reverse key order; 3: as for :func:`flash_attention_fwd`),
    and ``_run`` hands the kernel its running buffer (fp32, contiguous,
    of ``apex_flash_acc_floats(BH, Sq, D)`` elements), which may hold
    anything: its first contributors write it without reading it."""
    if not use_kernel(q3, k3, v3, o, lse, do, seed_pack, bias):
        return flash_attention_bwd_ref(q3, k3, v3, o, lse, do, seed_pack,
                                       scale, causal, rate, h_map, bias,
                                       False, probs_bf16)
    bh, sq, d = q3.shape
    lib = _flash_lib()
    floats = lib.apex_flash_acc_floats(bh, sq, d)
    run = _run
    if run is None:
        run = torch.empty(floats, dtype=torch.float32, device=q3.device)
    elif (run.dtype != torch.float32 or run.numel() != floats
          or not run.is_contiguous() or run.device != q3.device):
        raise ValueError(f"the running dq buffer must be a contiguous fp32 "
                         f"tensor of {floats} elements on {q3.device}")
    turns = torch.empty(lib.apex_flash_acc_turns(bh, sq), dtype=torch.int32,
                        device=q3.device)
    do, delta, lse = _bwd_inputs(q3, k3, v3, o, lse, do, seed_pack, bias)
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    with torch.cuda.device(q3.device):
        err = lib.apex_flash_bwd_acc(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), seed_pack.data_ptr(),
            *_bias_args(bias, bh), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), run.data_ptr(), turns.data_ptr(),
            *_shape_args(q3, k3, scale, causal, rate, h_map),
            int(probs_bf16), int(_fault), d, _Q_CODE[q3.dtype],
            torch.cuda.current_stream(q3.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash attention dq-accumulating backward kernel "
                           f"launch failed: CUDA error {err}")
    flash_attention_bwd_acc.launches += 1
    return dq, dk, dv, None


class _Flash(torch.autograd.Function):
    """The custom VJP: residuals are (q, k, v, bias, o, lse, seed pack).
    The bias gets a gradient only with ``bias_grad``: the per-head dbias
    summed over heads in fp32, then cast to the bias dtype."""

    @staticmethod
    def forward(ctx, q3, k3, v3, bias, seed_pack, scale, causal, rate, h_map,
                bias_grad, probs_bf16, dq_acc):
        o, lse = flash_attention_fwd(q3, k3, v3, seed_pack, scale, causal,
                                     rate, h_map, bias, probs_bf16)
        ctx.save_for_backward(q3, k3, v3, bias, o, lse, seed_pack)
        ctx.cfg = (scale, causal, rate, h_map)
        ctx.opts = (bias_grad, probs_bf16, dq_acc)
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, bias, o, lse, seed_pack = ctx.saved_tensors
        dq, dk, dv, dbias3 = flash_attention_bwd(
            q3, k3, v3, o, lse, do, seed_pack, *ctx.cfg, bias, *ctx.opts)
        dbias = None
        if dbias3 is not None:
            b, sq, sk = bias.shape
            dbias = dbias3.reshape(b, -1, sq, sk).sum(dim=1).to(bias.dtype)
        return (dq, dk, dv, dbias) + (None,) * 8


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: Union[None, int, torch.Tensor] = None,
    dropout_heads=None,
    bias_grad: bool = False,
    probs_bf16: bool = False,
    dq_acc: Optional[bool] = None,
) -> torch.Tensor:
    """Differentiable flash attention.  q, k, v: (B, H, S, D); optional
    additive bias (B, Sq, Sk), fp32 or bf16, added to the scaled scores in
    fp32 before the causal mask.  It may be a broadcast view (a (B, 1, Sk)
    key-padding mask expanded over queries): it is read through its
    strides and never copied per head or per query.

    ``dropout_rate`` > 0 applies attention-probability dropout from the
    counter hash keyed on ``dropout_seed`` (an int32 in [0, 2^31 - 1), a
    0-d device tensor on the hot path so no host sync is needed); the
    forward and backward regenerate the same mask, and it is the JAX
    package's mask bit for bit.  ``dropout_heads=(h_total,
    head_offset)`` keys it on global head indices, so a call on a head
    group draws the mask of those heads in the whole call.

    ``bias_grad=False`` keeps the bias a constant (a mask: no gradient
    flows to it).  With ``bias_grad=True`` the backward also writes each
    batch*head's ``p * (dp - delta)`` and sums it over heads in fp32
    before the cast to the bias dtype, so a learned bias trains; that
    costs an fp32 (B*H, Sq, Sk) buffer per call.

    ``probs_bf16`` rounds the probabilities (each 64-key tile's, in the
    forward) and the backward's pd and ds to the input dtype before their
    products, as the JAX kernels do; a no-op for fp32 inputs.
    ``dq_acc`` (None: :data:`DQ_ACC_DEFAULT`) selects the dq-accumulating
    backward, which gives the same bits as the partials one from a
    (B*H, Sq, D) fp32 buffer instead of one per visited tile; calls with
    ``bias_grad`` keep the partials backward.

    CUDA tensors run ``csrc/flash_attention.cu``, any lengths: bf16 q, k,
    v at head_dim 64 or 128 on the tensor cores, fp32 at head_dim 64 as
    fp32 FMAs; any other head_dim raises.  CPU tensors run the kernels'
    plain versions, the same functions.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if bias is not None and tuple(bias.shape) != (b, sq, sk):
        raise ValueError(f"bias shape {tuple(bias.shape)} != expected "
                         f"({b}, {sq}, {sk})")
    if scale is None:
        scale = d ** -0.5
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 requires dropout_seed")
    if bias is not None and not bias_grad:
        bias = bias.detach()
    h_total, head0 = (h, 0) if dropout_heads is None else dropout_heads
    seed_pack = _pack_seed(dropout_seed, 0, 0, head0, device=q.device)
    out = _Flash.apply(
        q.reshape(b * h, sq, d).contiguous(),
        k.reshape(b * h, sk, d).contiguous(),
        v.reshape(b * h, sk, d).contiguous(),
        bias, seed_pack, float(scale), bool(causal), float(dropout_rate),
        (h, int(h_total)), bool(bias_grad), bool(probs_bf16), dq_acc)
    return out.reshape(b, h, sq, d)


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
flash_attention_bwd_acc.launches = 0
