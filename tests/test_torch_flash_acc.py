"""apex_tpu_torch flash attention's ``probs_bf16`` option and its
dq-accumulating backward (``dq_acc``) vs the JAX package, on the CPU.

On CPU tensors the port's wrappers run their kernels' plain versions, so
these tests hold the plain versions (what ``chip_smoke.py`` holds the
CUDA kernels to on the card) against JAX's Pallas kernels in interpret
mode, on the same numpy-seeded inputs:

- ``probs_bf16`` at bf16, at head_dim 64 and 128: the forward (``_fwd_kernel``, which rounds each
  key block's ``exp(s - m_running)``, so both sides use 64-key tiles:
  ``block_q = block_k = 64``) and the grads of the combined backward
  (``_bwd_fused_kernel``/``_bwd_fused_nobias``, nk = 4), causal and not,
  with dropout and with a bias.  Tolerance: every element within 2 bf16
  ulps of the larger magnitude plus 1e-3 of max|want|, and at most 2 % of
  the elements different at all: the two sides sum in other orders, so a
  probability now and then rounds to the neighbouring bf16 value (about
  0.1-0.5 % of the outputs move by an ulp), while leaving the rounding
  out moves a third of them (checked: the port without ``probs_bf16``
  fails the same test against JAX with it);
- at fp32 ``probs_bf16`` is the identity: the port's results with and
  without it are equal bit for bit;
- ``dq_acc=True`` on CPU tensors runs the plain version (the same bits as
  ``dq_acc=False``) and launches no kernel, at head_dim 64 and 128;
- dq with several key tiles (nk = 2 and 4): the port's ``dq_acc`` path
  against JAX's combined backward that writes per-key-tile dq partials
  and sums them (``_bwd_fused_nobias``/``_bwd_fused_kernel``), fp32,
  within 1e-4 of max|want|.  JAX's own accumulating kernel
  (``_bwd_fused_acc_kernel``) cannot run off a TPU: interpret mode gives
  its aliased dq buffer copy semantics, so the revisits would read the
  zeros it started from (``apex_tpu/ops/attention.py:1102-1106``), and
  JAX takes the partials path there.  The port's accumulating kernel
  equals its partials kernel bit for bit on the card (``chip_smoke.py``,
  phase ``flash_acc``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu.ops._common import force_pallas
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops import launch_counts, reset_launch_counts

SEED = 7
D128_SEED = 11


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(seed, b, h, sq, sk, with_bias, d=64, q_scale=1.0):
    """q ~ ``q_scale`` N(0, 1), k, v and a cotangent ~ N(0, 1), all
    bf16-exact fp32 numpy, at head_dim ``d``, and an N(0, 1) bias
    (B, Sq, Sk) or None."""
    rng = np.random.RandomState(seed)
    bf = lambda a: np.array(  # noqa: E731
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    q = bf(q_scale * rng.randn(b, h, sq, d))
    k, v = (bf(rng.randn(b, h, sk, d)) for _ in range(2))
    cot = bf(rng.randn(b, h, sq, d))
    bias = rng.randn(b, sq, sk).astype(np.float32) if with_bias else None
    return q, k, v, cot, bias


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port(q, k, v, cot, bias, dtype, **kw):
    """The port's output and (dq, dk, dv) through ``flash_attention``."""
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    out = tattn.flash_attention(tq, tk, tv, bias=tb, **kw)
    grads = torch.autograd.grad(
        (out.float() * torch.from_numpy(cot)).sum(), (tq, tk, tv))
    return out, grads


def _jax(q, k, v, cot, bias, dtype, **kw):
    """JAX's output and grads in interpret mode, 64-wide tiles."""
    jb = None if bias is None else jnp.asarray(bias)
    jc = jnp.asarray(cot)

    def loss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, bias=jb, block_q=64,
                                  block_k=64, **kw)
        return jnp.sum(o.astype(jnp.float32) * jc), o

    args = tuple(jnp.asarray(a).astype(dtype) for a in (q, k, v))
    with force_pallas(True):
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return out, grads


def _bf16_close(got, want, ulps=2, floor_rel=1e-3, max_frac=0.02):
    """(ok, max error, fraction of elements that differ): every element
    within ``ulps`` bf16 ulps of the larger magnitude plus ``floor_rel``
    of max|want|, and at most ``max_frac`` of them different at all."""
    g, w = _f32(got), _f32(want)
    big = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    tol = ulps * ulp + floor_rel * np.abs(w).max()
    frac = float(np.mean(g != w))
    err = float(np.abs(g - w).max())
    return bool(np.all(np.abs(g - w) <= tol)) and frac <= max_frac, err, frac


def _probs_bf16_matches_jax(inputs, seed, **kw):
    """The port's ``probs_bf16`` output and grads within
    :func:`_bf16_close` of JAX's interpret-mode kernels."""
    q, k, v, cot, bias = inputs
    kw.update(probs_bf16=True)
    out, grads = _port(q, k, v, cot, bias, torch.bfloat16,
                       dropout_seed=seed, **kw)
    want_out, want = _jax(q, k, v, cot, bias, jnp.bfloat16,
                          dropout_seed=jnp.int32(seed), use_pallas=True,
                          **kw)
    assert out.dtype == torch.bfloat16
    for name, g, w in zip(("o", "dq", "dk", "dv"), (out, *grads),
                          (want_out, *want)):
        ok, err, frac = _bf16_close(g, w)
        assert ok, (name, err, frac)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_probs_bf16_matches_jax_kernels(with_bias, causal, rate):
    _probs_bf16_matches_jax(_inputs(1, 1, 2, 256, 256, with_bias), SEED,
                            causal=causal, dropout_rate=rate)


@pytest.mark.parametrize("causal", [False, True])
def test_d128_probs_bf16_matches_jax_kernels(causal):
    _probs_bf16_matches_jax(
        _inputs(2, 1, 2, 192, 192, not causal, d=128, q_scale=2.0),
        D128_SEED, causal=causal, dropout_rate=0.1)


def _rounding_left_out_fails(inputs):
    """The planted fault: the port without ``probs_bf16`` against JAX
    with it fails the tolerance above in every output (a third of the
    elements move)."""
    q, k, v, cot, bias = inputs
    out, grads = _port(q, k, v, cot, bias, torch.bfloat16, causal=True)
    want_out, want = _jax(q, k, v, cot, bias, jnp.bfloat16, causal=True,
                          probs_bf16=True, use_pallas=True)
    res = [_bf16_close(g, w) for g, w in zip((out, *grads),
                                             (want_out, *want))]
    assert not any(r[0] for r in res)
    assert min(r[2] for r in res) > 0.1, res


def test_probs_bf16_check_rejects_the_rounding_left_out():
    _rounding_left_out_fails(_inputs(2, 1, 2, 256, 256, False))


def test_d128_check_rejects_the_rounding_left_out():
    """As above at head_dim 128 (the tensor-core kernels' split of fp32 p
    into bf16 hi and lo parts is held on the card to a gate that the same
    rounding must fail, ``chip_smoke.py``)."""
    _rounding_left_out_fails(
        _inputs(4, 1, 2, 192, 192, False, d=128, q_scale=2.0))


@pytest.mark.parametrize("causal", [False, True])
def test_probs_bf16_is_the_identity_at_fp32(causal):
    q, k, v, cot, bias = _inputs(3, 1, 2, 192, 192, True)
    kw = dict(causal=causal, dropout_rate=0.1, dropout_seed=SEED)
    on_out, on = _port(q, k, v, cot, bias, torch.float32, probs_bf16=True,
                       **kw)
    off_out, off = _port(q, k, v, cot, bias, torch.float32, **kw)
    assert torch.equal(on_out, off_out)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    want_out, want = _jax(q, k, v, cot, bias, jnp.float32, probs_bf16=True,
                          use_pallas=True, causal=causal, dropout_rate=0.1,
                          dropout_seed=jnp.int32(SEED))
    np.testing.assert_allclose(_f32(on_out), _f32(want_out), rtol=0,
                               atol=1e-5)
    for g, w in zip(on, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=0, atol=1e-4)


def _acc_is_the_partials_backward(inputs, dtype, **kw):
    """``dq_acc=True`` and ``dq_acc=False`` on CPU tensors: the same
    bits, and no kernel launched; returns the partials (out, grads)."""
    q, k, v, cot, bias = inputs
    reset_launch_counts()
    base_out, base = _port(q, k, v, cot, bias, dtype, dq_acc=False, **kw)
    acc_out, acc = _port(q, k, v, cot, bias, dtype, dq_acc=True, **kw)
    assert all(n == 0 for n in launch_counts().values()), launch_counts()
    assert torch.equal(acc_out, base_out)
    assert all(torch.equal(a, b) for a, b in zip(acc, base))
    return base_out, base


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_acc_on_cpu_runs_the_plain_version_and_launches_nothing(
        dtype, monkeypatch):
    q, k, v, cot, bias = _inputs(4, 2, 2, 130, 130, True)
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=SEED,
              probs_bf16=True)
    base_out, base = _acc_is_the_partials_backward((q, k, v, cot, bias),
                                                   dtype, **kw)
    # the module default decides when a call passes no dq_acc
    monkeypatch.setattr(tattn, "DQ_ACC_DEFAULT", True)
    dflt_out, dflt = _port(q, k, v, cot, bias, dtype, **kw)
    assert all(n == 0 for n in launch_counts().values()), launch_counts()
    assert all(torch.equal(a, b) for a, b in zip(dflt, base))
    assert torch.equal(dflt_out, base_out)
    # the backward wrappers themselves: the acc one returns no dbias
    q3, k3, v3 = (torch.from_numpy(a).reshape(4, -1, 64).to(dtype)
                  for a in (q, k, v))
    seed = tattn._pack_seed(SEED, device="cpu")
    args = (seed, 0.125, True, 0.1, (2, 2))
    o, lse = tattn.flash_attention_fwd(q3, k3, v3, *args)
    do = torch.from_numpy(cot).reshape(4, -1, 64).to(dtype)
    got = tattn.flash_attention_bwd_acc(q3, k3, v3, o, lse, do, *args)
    want = tattn.flash_attention_bwd(q3, k3, v3, o, lse, do, *args,
                                     dq_acc=False)
    assert got[3] is None
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_d128_dq_acc_on_cpu_is_the_partials_backward(dtype):
    _acc_is_the_partials_backward(
        _inputs(3, 1, 2, 130, 190, True, d=128, q_scale=2.0), dtype,
        causal=False, dropout_rate=0.1, dropout_seed=D128_SEED)


@pytest.mark.parametrize("causal,sq,sk,with_bias", [
    (True, 256, 256, False),    # nk = 4, causal tiles skipped
    (False, 128, 256, True),    # nk = 4 with a bias, Sq != Sk
    (True, 128, 128, True),     # nk = 2
])
def test_dq_acc_matches_jax_partials_backward(causal, sq, sk, with_bias):
    q, k, v, cot, bias = _inputs(5, 1, 2, sq, sk, with_bias)
    kw = dict(causal=causal, dropout_rate=0.1)
    assert sk // 64 <= jattn._FUSED_BWD_MAX_NK  # JAX's combined backward
    out, grads = _port(q, k, v, cot, bias, torch.float32, dq_acc=True,
                       dropout_seed=SEED, **kw)
    want_out, want = _jax(q, k, v, cot, bias, jnp.float32,
                          dropout_seed=jnp.int32(SEED), use_pallas=True,
                          **kw)
    np.testing.assert_allclose(_f32(out), _f32(want_out), rtol=0, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        w = _f32(w)
        err = np.abs(_f32(g) - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)
