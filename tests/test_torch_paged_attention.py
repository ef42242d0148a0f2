"""apex_tpu_torch paged attention vs the JAX package, on the CPU.

On CPU tensors the port's ``paged_fused_attention`` runs its plain
version (the materializing ``paged_cached_attention``).  Both are held
against the JAX Pallas kernel ``paged_fused_attention`` (interpret mode
off-TPU) and the JAX materializing path, on numpy-seeded problems: fp32,
bf16 and int8 pools x T in {1, 4} x with and without an in-block mask,
both layers of a 2-layer pool.  Tolerances: fp32 outputs atol 1e-5
(only the order of fp32 sums differs); bf16 outputs atol 1e-2 (both
sides round the same fp32 result to bf16, so they differ by at most an
ulp of values below 2).  ``quantize_kv`` is int8-exact with scales at
rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import launch_counts, reset_launch_counts


def _problem(pool_dtype, t, masked, seed=3):
    """A small paged read: 2-layer 5-D pools, three rows with different
    cache lengths (one ending mid-page, one empty), T new tokens.  Pools
    are fp32 / bf16 / int8 (with per-token scales); q, k_new and v_new
    are bf16 for the bf16 problem, fp32 otherwise.  numpy arrays."""
    rng = np.random.RandomState(seed)
    b, h, d, page_len, pps, layers = 3, 2, 8, 8, 3, 2
    num_pages = 1 + b * pps
    s_total = pps * page_len

    def mk(shape):
        return (rng.randn(*shape) * 0.3).astype(np.float32)

    pool_k = mk((num_pages, layers, h, page_len, d))
    pool_v = mk((num_pages, layers, h, page_len, d))
    ksc = vsc = None
    if pool_dtype == "bf16":
        pool_k = pool_k.astype(ml_dtypes.bfloat16)
        pool_v = pool_v.astype(ml_dtypes.bfloat16)
    elif pool_dtype == "int8":
        kq, ks = jattn.quantize_kv(jnp.asarray(pool_k))
        vq, vs = jattn.quantize_kv(jnp.asarray(pool_v))
        pool_k, ksc = np.asarray(kq), np.asarray(ks)
        pool_v, vsc = np.asarray(vq), np.asarray(vs)
    # shuffled physical pages; the empty row maps only the trash page
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    table = perm.reshape(b, pps)
    table[2] = 0
    lengths = np.asarray([s_total - 5, s_total // 2 + 3, 0], np.int32)
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


def _jax(p):
    return {k: None if v is None else jnp.asarray(v) for k, v in p.items()}


def _torch(p):
    def conv(v):
        if v is None:
            return None
        if v.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(v))

    return {k: conv(v) for k, v in p.items()}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _split(p):
    p = dict(p)
    return p.pop("q"), p.pop("k_new"), p.pop("v_new"), p


@pytest.mark.parametrize("pool_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_port_matches_jax_kernel_and_materializing_path(pool_dtype, t,
                                                        masked):
    prob = _problem(pool_dtype, t, masked)
    jq, jk, jv, jkw = _split(_jax(prob))
    tq, tk, tv, tkw = _split(_torch(prob))
    atol = 1e-2 if pool_dtype == "bf16" else 1e-5
    for layer in (0, 1):
        want_kernel = jax.jit(lambda a, b, c: jattn.paged_fused_attention(
            a, b, c, layer=layer, **jkw))(jq, jk, jv)
        want_plain = jax.jit(lambda a, b, c: jattn.paged_cached_attention(
            a, b, c, layer=layer, use_fused=False, **jkw))(jq, jk, jv)
        got = tattn.paged_fused_attention(tq, tk, tv, layer=layer, **tkw)
        got_plain = tattn.paged_cached_attention(tq, tk, tv, layer=layer,
                                                 **tkw)
        assert got.dtype == tq.dtype and tuple(got.shape) == tq.shape
        assert torch.equal(got, got_plain)  # the CPU route IS the plain path
        for want in (want_kernel, want_plain):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cached_attention_matches_jax(with_cache, masked):
    rng = np.random.RandomState(7)
    b, h, t, d, s = 2, 2, 3, 8, 10
    q, kn, vn = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    ck, cv = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(2))
    lengths = np.asarray([7, 4], np.int32)
    pos = (lengths[:, None] + np.arange(t)).astype(np.int32)
    bm = np.tril(np.ones((t, t), bool)) if masked else None
    if masked:
        bm[2, 1] = False
    kw = dict(positions=pos, block_mask=bm)
    if with_cache:
        kw.update(cache_k=ck, cache_v=cv, cache_lengths=lengths)
    want = jattn.cached_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    got = tattn.cached_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_quantize_kv_exact():
    rng = np.random.RandomState(9)
    x = (rng.randn(4, 3, 64) * 2).astype(np.float32)
    x[0, 0] = 0.0  # all-zero vector round-trips to zeros
    # amax 127 makes the scale 1.0: exact halves round to even
    x[1, 1, :6] = [127.0, 63.5, 62.5, -0.5, 1.5, -2.5]
    x[1, 1, 6:] = 0.25
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    tq, ts = tattn.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert tq[1, 1, :6].tolist() == [127, 64, 62, 0, 2, -2]
    assert not tq[0, 0].any()
    # bf16 input quantizes like its fp32 value
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jb = jattn.quantize_kv(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))[0]
    np.testing.assert_array_equal(tattn.quantize_kv(xb)[0].numpy(),
                                  np.asarray(jb))


def test_cpu_route_counts_no_launch():
    reset_launch_counts()
    q, k, v, kw = _split(_torch(_problem("int8", 4, True)))
    tattn.paged_fused_attention(q, k, v, **kw)
    assert launch_counts()["paged_fused_attention"] == 0


def test_mixed_devices_raise():
    q, k, v, kw = _split(_torch(_problem("fp32", 1, False)))
    kw["page_table"] = torch.empty((3, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        tattn.paged_fused_attention(q, k, v, **kw)
