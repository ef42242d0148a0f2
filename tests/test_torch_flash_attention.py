"""apex_tpu_torch flash attention vs the JAX package, on the CPU.

The port's ``flash_attention`` on CPU tensors runs its plain versions
(``flash_attention_fwd_ref``/``flash_attention_bwd_ref`` inside the same
``autograd.Function`` the CUDA kernels use).  They are held against the
JAX ``flash_attention`` in Pallas interpret mode (``force_pallas(True)``:
``_fwd_kernel_nobias`` and the combined ``_bwd_fused_nobias``) and at its
CPU default (``attention_ref`` and autodiff), on the same numpy-seeded
inputs at S = 128 (shorter S fails the JAX shape gate and would silently
take ``attention_ref``).  Tolerances: the dropout keep mask is bit-exact;
outputs within 1e-5 at fp32 (summation order) and 2 bf16 ulps at bf16
(both sides round an fp32 result once, and the fp32 sums may straddle a
rounding boundary), plus 1e-6 absolute where an output cancels to
near zero and the fp32 summation order alone is a few of its ulps);
grads within 1e-4 at fp32.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu.ops._common import force_pallas
from apex_tpu_torch.ops import attention as tattn

B, H, S, D = 1, 2, 128, 64
DTYPES = {"fp32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _qkv(seed, np_dt):
    rng = np.random.RandomState(seed)
    q = (2.0 * rng.randn(B, H, S, D)).astype(np_dt)
    k = rng.randn(B, H, S, D).astype(np_dt)
    v = rng.randn(B, H, S, D).astype(np_dt)
    return q, k, v


def _t(a, dt):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_bf16_ulps(got, want, ulps, floor=1e-6):
    got, want = _f32(got), _f32(want)
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulps * ulp + floor), \
        np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_is_bit_exact(rate):
    shape, seed, bh, row0, col0 = (128, 128), 123456789, 7, 384, 1000
    want = np.asarray(jattn._keep_mask(jnp.int32(seed), jnp.int32(bh),
                                       row0, col0, shape, rate))
    got = tattn._keep_mask(torch.tensor(seed, dtype=torch.int32), bh, row0,
                           col0, shape, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.3 < got.mean() < 0.95


def test_keep_mask_batched_heads_and_negative_offsets():
    seeds = [0, 1, 2 ** 31 - 2]
    for seed in seeds:
        bh = torch.arange(6)[:, None, None]
        got = tattn._keep_mask(seed, bh, -5, 3, (16, 32), 0.25).numpy()
        for i in range(6):
            want = np.asarray(jattn._keep_mask(jnp.int32(seed), jnp.int32(i),
                                               -5, 3, (16, 32), 0.25))
            np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_forward_matches_jax(dtype, rate, causal):
    np_dt, tdt = DTYPES[dtype]
    q, k, v = _qkv(1, np_dt)
    seed = 20240607
    got = tattn.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                causal=causal, dropout_rate=rate,
                                dropout_seed=seed)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, S, D)
    kw = dict(causal=causal, dropout_rate=rate,
              dropout_seed=jnp.int32(seed))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    with force_pallas(True):
        kern = jattn.flash_attention(jq, jk, jv, **kw)
    ref = jattn.flash_attention(jq, jk, jv, **kw)
    for want in (kern, ref):
        if dtype == "fp32":
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=0,
                                       atol=1e-5)
        else:
            _assert_bf16_ulps(got, want, 2)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_grads_match_jax_fp32(rate):
    q, k, v = _qkv(2, np.float32)
    cot = np.random.RandomState(3).randn(B, H, S, D).astype(np.float32)
    seed = 77

    def jloss(q_, k_, v_):
        out = jattn.flash_attention(q_, k_, v_, causal=True,
                                    dropout_rate=rate,
                                    dropout_seed=jnp.int32(seed))
        return jnp.sum(out * jnp.asarray(cot))

    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    with force_pallas(True):
        want_kern = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    want_ref = jax.grad(jloss, argnums=(0, 1, 2))(*jargs)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=True, dropout_rate=rate,
                                dropout_seed=seed)
    (out * torch.from_numpy(cot)).sum().backward()
    for want in (want_kern, want_ref):
        for g, w in zip((tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=0, atol=1e-4)


def test_plain_backward_matches_autograd_of_attention_ref():
    """The plain backward (the kernel's arithmetic from lse and delta)
    against autograd through the plain forward, with dropout."""
    q, k, v = _qkv(4, np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    seed = torch.tensor(5, dtype=torch.int32)
    want_out = tattn.attention_ref(tq, tk, tv, causal=True, dropout_rate=0.1,
                                   dropout_seed=seed)
    cot = torch.randn(want_out.shape, generator=torch.Generator()
                      .manual_seed(6))
    want = torch.autograd.grad((want_out * cot).sum(), (tq, tk, tv))
    got_out = tattn.flash_attention(tq, tk, tv, causal=True,
                                    dropout_rate=0.1, dropout_seed=seed)
    got = torch.autograd.grad((got_out * cot).sum(), (tq, tk, tv))
    torch.testing.assert_close(got_out, want_out, rtol=0, atol=1e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


def test_bias_and_head_offsets_match_jax_reference():
    q, k, v = _qkv(7, np.float32)
    bias = np.random.RandomState(8).randn(B, S, S).astype(np.float32)
    got = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                bias=torch.from_numpy(bias), causal=True,
                                dropout_rate=0.1, dropout_seed=9,
                                dropout_heads=(8, 3))
    want = jattn.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               bias=jnp.asarray(bias), causal=True,
                               dropout_rate=0.1, dropout_seed=jnp.int32(9),
                               dropout_heads=(8, 3))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-5)
    # the head offset reaches the plain flash path too (no bias)
    got = tattn.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=True, dropout_rate=0.1,
                                dropout_seed=9, dropout_heads=(8, 3))
    want = jattn.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=True, dropout_rate=0.1,
                               dropout_seed=jnp.int32(9),
                               dropout_heads=(8, 3))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-5)


def test_cuda_path_raises_on_what_the_kernel_does_not_take(monkeypatch):
    """With the dispatch rule forced to the kernel, unsupported inputs
    raise before any launch (there is no fallback to the plain path)."""
    monkeypatch.setattr(tattn, "use_kernel", lambda *t: True)
    q, k, v = (torch.zeros(1, 2, 128, 64) for _ in range(3))
    with pytest.raises(ValueError, match="bias shape"):
        tattn.flash_attention(q, k, v, bias=torch.zeros(1, 128, 64))
    small = torch.zeros(1, 2, 128, 32)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(small, small, small)
    with pytest.raises(ValueError, match="one dtype"):
        tattn.flash_attention(q.half(), q.half(), q.half())
