"""The split-K decomposition of the paged-attention kernels, on the CPU.

``csrc/paged_attention.cu``'s decode and tensor-core kernels split a row's
history into runs of whole pages, keep an online softmax (m, l, acc) per
split, and merge the splits' partials in split order; the T new keys are
splits of their own.  A CUDA kernel cannot run here, so
:func:`split_decomposition` below is a plain PyTorch model of that
arithmetic, used only by these tests:

- page-aligned splits of ``split_pages`` pages, each read through the
  page table at ``layer``; a split past the row's visible keys adds
  nothing;
- each split's (m, l, acc) over its visible keys, with ``scale`` applied
  to the fp32 score after the dot (q is never rounded after scaling);
- int8 pages: the raw int8 key in the dot and its per-token scale on the
  score afterwards; the value scale folded into p, not into the values;
- the new keys as one more split, causal by position and the mask;
- the merge in split order: M = max m_s, l = sum l_s e^(m_s - M), acc =
  sum acc_s e^(m_s - M); a row with l = 0 is 0.

It is held against the JAX package's Pallas ``paged_fused_attention`` in
interpret mode, as ``tests/test_torch_paged_attention.py`` runs it, on
numpy-seeded problems: fp32, bf16 and int8 pools, T in {1, 4, 16}, with
and without the in-block mask, splits of 1, 2 and 4 pages, and rows with
an empty history, histories ending on a split boundary of every split
size and one key past it, and one filling every page.  Tolerances: fp32
outputs within 1e-5 (only the order of the fp32 sums differs; an int8
problem has fp32 q), bf16 outputs within 1e-2 (both sides round one fp32
result to bf16).  The wrapper's split and design rules and
``SamplingParams.make``'s device are checked too.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.serve.decode import SamplingParams

_NEG = -1e30
PAGE_LEN = 4
PAGES = 6  # a row's logical pages: 24 keys
# rows: an empty history, 8 (a boundary of 1- and 2-page splits), 9, 16
# (a boundary of every split size here), 17, and every page full
LENGTHS = (0, 8, 9, 16, 17, PAGES * PAGE_LEN)
SPLITS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _gather(pool, pscale, pages, layer):
    """The raw keys or values of a run of pages, (B, H, K, D) fp32, and
    their per-token scales (B, H, K) (ones without scales)."""
    g = pool[pages.long(), layer]  # (B, n, H, P, D)
    b, n, h, p, d = g.shape
    g = g.permute(0, 2, 1, 3, 4).reshape(b, h, n * p, d).float()
    if pscale is None:
        return g, torch.ones(b, h, n * p)
    s = pscale[pages.long(), layer].permute(0, 2, 1, 3).reshape(b, h, n * p)
    return g, s


def _partial(s, ok, v, vscale):
    """One split's (m, l, acc): s (B, H, T, K) scaled scores, ok their
    visibility, v (B, H, K, D) raw values, vscale (B, H, K)."""
    m = torch.where(ok, s, _NEG).amax(-1)
    p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhtk,bhkd->bhtd", p * vscale[:, :, None, :], v)
    return m, p.sum(-1), acc


def split_decomposition(q, k_new, v_new, *, positions, pool_k, pool_v,
                        page_table, cache_lengths, pool_k_scale=None,
                        pool_v_scale=None, scale=None, layer=0,
                        block_mask=None, split_pages):
    """The paged read as the split-K kernels compute it (module
    docstring); same arguments and result as ``paged_cached_attention``
    plus ``split_pages``."""
    b, h, t, d = q.shape
    n_pages = page_table.shape[1]
    scale = d ** -0.5 if scale is None else scale
    q32 = q.float()
    pos = positions.long()
    n_vis = torch.clamp(torch.minimum(cache_lengths.long(),
                                      pos.amax(1) + 1), 0, n_pages * PAGE_LEN)
    parts = []
    for p0 in range(0, n_pages, split_pages):
        pages = page_table[:, p0:p0 + split_pages]
        k, ksc = _gather(pool_k, pool_k_scale, pages, layer)
        v, vsc = _gather(pool_v, pool_v_scale, pages, layer)
        s = (torch.einsum("bhtd,bhkd->bhtk", q32, k) * scale
             * ksc[:, :, None, :])
        j = p0 * PAGE_LEN + torch.arange(k.shape[2])
        ok = ((j[None, :] < n_vis[:, None])[:, None, None, :]
              & (j[None, None, :] <= pos[:, :, None])[:, None])
        parts.append(_partial(s, ok, v, vsc))
    s = torch.einsum("bhtd,bhkd->bhtk", q32, k_new.float()) * scale
    ok = (pos[:, None, :] <= pos[:, :, None])[:, None]
    if block_mask is not None:
        ok = ok & block_mask.bool()[None, None]
    parts.append(_partial(s, ok, v_new.float(), torch.ones(b, h, t)))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l_sum = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, d)
    for m, l_s, a_s in parts:  # split order
        w = torch.exp(m - mx)
        l_sum = l_sum + l_s * w
        acc = acc + a_s * w[..., None]
    out = torch.where(l_sum[..., None] > 0, acc / l_sum[..., None], 0.0)
    return out.to(q.dtype)


def _problem(pool_dtype, t, masked, seed=5):
    """Two-layer 5-D pools of shuffled pages, one row per entry of
    LENGTHS (the empty row maps only the trash page 0), T new tokens at
    positions lengths + arange(T).  numpy arrays; q, k_new, v_new are
    bf16 for the bf16 pool, fp32 otherwise."""
    rng = np.random.RandomState(seed)
    b, h, d, layers = len(LENGTHS), 2, 8, 2
    num_pages = 1 + b * PAGES

    def mk(shape):
        return (rng.randn(*shape) * 0.5).astype(np.float32)

    pool_k = mk((num_pages, layers, h, PAGE_LEN, d))
    pool_v = mk((num_pages, layers, h, PAGE_LEN, d))
    ksc = vsc = None
    if pool_dtype == "bf16":
        pool_k = pool_k.astype(ml_dtypes.bfloat16)
        pool_v = pool_v.astype(ml_dtypes.bfloat16)
    elif pool_dtype == "int8":
        kq, ks = jattn.quantize_kv(jnp.asarray(pool_k))
        vq, vs = jattn.quantize_kv(jnp.asarray(pool_v))
        pool_k, ksc = np.asarray(kq), np.asarray(ks)
        pool_v, vsc = np.asarray(vq), np.asarray(vs)
    table = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = table.reshape(b, PAGES)
    table[0] = 0
    lengths = np.asarray(LENGTHS, np.int32)
    qdt = ml_dtypes.bfloat16 if pool_dtype == "bf16" else np.float32
    q, kn, vn = (mk((b, h, t, d)).astype(qdt) for _ in range(3))
    positions = (lengths[:, None] + np.arange(t, dtype=np.int32)).astype(
        np.int32)
    bm = None
    if masked:
        bm = rng.rand(t, t) < 0.6
        np.fill_diagonal(bm, True)
    return dict(q=q, k_new=kn, v_new=vn, positions=positions,
                pool_k=pool_k, pool_v=pool_v, page_table=table,
                cache_lengths=lengths, pool_k_scale=ksc, pool_v_scale=vsc,
                block_mask=bm)


def _torch(p):
    def conv(v):
        if v is None:
            return None
        if v.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(v))

    return {k: conv(v) for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _case(pool_dtype, t, masked, layer=1):
    """(problem as torch tensors, the JAX kernel's output as fp32 numpy),
    computed once for every split size."""
    prob = _problem(pool_dtype, t, masked)
    jp = {k: None if v is None else jnp.asarray(v) for k, v in prob.items()}
    q, kn, vn = jp.pop("q"), jp.pop("k_new"), jp.pop("v_new")
    want = jax.jit(lambda a, b, c: jattn.paged_fused_attention(
        a, b, c, layer=layer, **jp))(q, kn, vn)
    return _torch(prob), np.asarray(want, np.float32)


def _split(p):
    p = dict(p)
    return p.pop("q"), p.pop("k_new"), p.pop("v_new"), p


@pytest.mark.parametrize("split_pages", SPLITS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [1, 4, 16])
@pytest.mark.parametrize("pool_dtype", ["fp32", "bf16", "int8"])
def test_split_decomposition_matches_jax_kernel(pool_dtype, t, masked,
                                                split_pages):
    prob, want = _case(pool_dtype, t, masked)
    q, kn, vn, kw = _split(prob)
    got = split_decomposition(q, kn, vn, layer=1, split_pages=split_pages,
                              **kw)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(q.shape)
    atol = 1e-2 if pool_dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("split_pages", SPLITS)
def test_split_decomposition_sees_a_lost_key(split_pages):
    """The edge rows are what the comparison can see: one key short at a
    split boundary moves the output past the tolerance."""
    prob, want = _case("fp32", 1, False)
    q, kn, vn, kw = _split(prob)
    kw["cache_lengths"] = kw["cache_lengths"] - 1
    got = split_decomposition(q, kn, vn, layer=1, split_pages=split_pages,
                              **kw)
    err = np.abs(got.numpy() - want).max(axis=(1, 2, 3))
    # every row with a history (all but the first) differs
    assert err[0] <= 1e-5 and (err[1:] > 1e-3).all()


@pytest.mark.parametrize("page_len,n_pages", [
    (16, 64), (8, 3), (1, 5000), (256, 4), (16, 4096), (48, 7)])
def test_splits_are_whole_pages_covering_the_row(page_len, n_pages):
    split_pages, n_splits = tattn._paged_split(page_len, n_pages)
    assert split_pages * page_len >= 64 and n_splits <= 64
    assert (n_splits - 1) * split_pages < n_pages <= n_splits * split_pages
    tiles, n_pre = tattn._prefill_split(page_len, n_pages)
    keys = tiles * 64
    assert tiles >= 1
    assert keys <= (tattn._PAGE_WIN - 2) * page_len  # one page window
    assert (n_pre - 1) * keys < n_pages * page_len <= n_pre * keys
    if page_len == 16 and n_pages == 64:  # GPT-2 small's pool row
        assert (split_pages, n_splits) == (4, 16) and (tiles, n_pre) == (8, 2)


def test_design_by_t_and_dtype():
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    design = tattn._paged_design
    for pool in (bf, i8):
        assert design(1, bf, pool) == tattn._DECODE
        assert design(tattn.PAGED_TC_MIN_T - 1, bf, pool) == tattn._DECODE
        assert design(tattn.PAGED_TC_MIN_T, bf, pool) == tattn._TENSOR_CORES
        assert design(512, bf, pool) == tattn._TENSOR_CORES
        assert design(16, f32, pool) == tattn._DECODE
        assert design(17, f32, pool) == tattn._FMA
    assert design(16, bf, f32) == tattn._DECODE
    assert design(128, bf, f32) == tattn._FMA


def test_sampling_params_on_the_cpu_when_asked():
    sp = SamplingParams.make(3, temperature=[0.0, 0.7, 1.0], top_k=5,
                             device="cpu")
    for x in (sp.temperature, sp.top_k, sp.top_p, sp.min_p):
        assert x.device.type == "cpu" and x.shape == (3,)
    assert sp.top_k.dtype == torch.int32 and not sp.all_greedy


def test_sampling_params_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplingParams.make(2)
