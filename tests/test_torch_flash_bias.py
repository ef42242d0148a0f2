"""apex_tpu_torch flash attention with an additive bias vs the JAX package,
on the CPU.

The port's ``flash_attention`` on CPU tensors runs the plain versions of
its kernels (``flash_attention_fwd_ref``/``flash_attention_bwd_ref``,
inside the ``autograd.Function`` the CUDA kernels use).  They are held
against the JAX ``flash_attention`` in Pallas interpret mode
(``force_pallas(True)``: the bias forward ``_fwd_kernel`` and the
combined bias backward ``_bwd_fused_kernel``; with ``bias_grad=True`` the
two-pass backward ``_bwd_dkv_kernel`` + ``_bwd_dq_kernel`` with its
per-tile dbias) and at its CPU default (``attention_ref`` and autodiff),
on the same numpy-seeded inputs at S = 128 (the JAX shape gate), with a
full (B, Sq, Sk) bias and with a (B, 1, Sk) key-padding mask expanded to
(B, Sq, Sk) (a view with row stride 0 on the port's side).  Tolerances,
fp32: outputs within 1e-5 (summation order), grads within 1e-4, the
per-head dbias within 1e-5 and exactly zero on causally masked entries,
where the reference's skipped tiles are zero-filled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.ops import attention as jattn
from apex_tpu.ops._common import force_pallas
from apex_tpu_torch.ops import attention as tattn

B, H, S, D = 2, 2, 128, 64
SEED = 4242


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(seed, kind):
    """q, k, v, the bias (numpy, (B, Sq, Sk) or (B, 1, Sk)) and a
    cotangent.  ``kind`` "full": N(0, 1) bias; "padding": a key mask of
    0 / -1e9 from lengths 128 and 77, as BERT builds it."""
    rng = np.random.RandomState(seed)
    q = (2.0 * rng.randn(B, H, S, D)).astype(np.float32)
    k = rng.randn(B, H, S, D).astype(np.float32)
    v = rng.randn(B, H, S, D).astype(np.float32)
    cot = rng.randn(B, H, S, D).astype(np.float32)
    if kind == "full":
        bias = rng.randn(B, S, S).astype(np.float32)
    else:
        lengths = np.array([S, 77])
        keep = np.arange(S)[None, :] < lengths[:, None]
        bias = ((1.0 - keep) * -1e9).astype(np.float32)[:, None, :]
    return q, k, v, bias, cot


def _torch_bias(bias):
    t = torch.from_numpy(bias)
    return t.expand(B, S, S)  # the padding mask stays a stride-0 view


def _jax_bias(bias):
    return jnp.broadcast_to(jnp.asarray(bias), (B, S, S))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kind", ["full", "padding"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_forward_and_grads_match_jax(kind, causal, rate):
    q, k, v, bias, cot = _inputs(1, kind)
    kw = dict(causal=causal, dropout_rate=rate)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tb = _torch_bias(bias)
    if kind == "padding":
        assert tb.stride(1) == 0
    out = tattn.flash_attention(tq, tk, tv, bias=tb, dropout_seed=SEED, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))

    def jloss(q_, k_, v_):
        o = jattn.flash_attention(q_, k_, v_, bias=_jax_bias(bias),
                                  dropout_seed=jnp.int32(SEED), **kw)
        return jnp.sum(o * jnp.asarray(cot)), o

    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    for force in (True, None):
        with force_pallas(force):
            (_, want_out), want = jax.value_and_grad(
                jloss, argnums=(0, 1, 2), has_aux=True)(*jargs)
        np.testing.assert_allclose(_f32(out), _f32(want_out), rtol=0,
                                   atol=1e-5)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bias_grad_matches_jax_two_pass(causal, rate):
    """``bias_grad=True``: the head-summed dbias against the JAX two-pass
    backward (64-wide tiles, so causal runs skip tiles) and against
    autodiff of its ``attention_ref``."""
    q, k, v, bias, cot = _inputs(2, "full")
    tb = torch.from_numpy(bias).requires_grad_()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, bias=tb, causal=causal,
                                dropout_rate=rate, dropout_seed=SEED,
                                bias_grad=True)
    (got,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (tb,))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, S)

    def jloss(b_):
        o = jattn.flash_attention(
            *(jnp.asarray(a) for a in (q, k, v)), bias=b_, causal=causal,
            dropout_rate=rate, dropout_seed=jnp.int32(SEED), bias_grad=True,
            block_q=64, block_k=64)
        return jnp.sum(o * jnp.asarray(cot))

    for force in (True, None):
        with force_pallas(force):
            want = jax.grad(jloss)(jnp.asarray(bias))
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-5)
    if causal:
        upper = np.triu(np.ones((S, S), bool), 1)
        assert np.all(_f32(got)[:, upper] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_per_head_dbias_matches_the_jax_dq_kernel(causal):
    """The plain backward's per-(batch*head) dbias against the JAX
    ``_bwd_dq_kernel`` output itself (before the head sum), with dropout:
    the same ``p * (dp - delta)`` with no scale factor, zero on every
    causally skipped tile."""
    q, k, v, bias, cot = _inputs(3, "full")
    rate, scale = 0.1, D ** -0.5
    q3, k3, v3, do3 = (a.reshape(B * H, S, D) for a in (q, k, v, cot))
    seed = jattn._pack_seed(jnp.int32(SEED), 0, 0)
    with force_pallas(True):
        out, lse = jattn._flash_fwd(
            *(jnp.asarray(a) for a in (q3, k3, v3)), jnp.asarray(bias), seed,
            scale, causal, 64, 64, rate)
        *_, want = jattn._flash_bwd(
            *(jnp.asarray(a) for a in (q3, k3, v3)), jnp.asarray(bias), seed,
            out, lse, jnp.asarray(do3), scale, causal, 64, 64, rate,
            bias_grad=True)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    seed_pack = tattn._pack_seed(SEED, device="cpu")
    o, lse_t = tattn.flash_attention_fwd_ref(t(q3), t(k3), t(v3), seed_pack,
                                             scale, causal, rate, (H, H),
                                             t(bias))
    np.testing.assert_allclose(_f32(o), _f32(out), rtol=0, atol=1e-5)
    *_, dbias3 = tattn.flash_attention_bwd_ref(
        t(q3), t(k3), t(v3), o, lse_t, t(do3), seed_pack, scale, causal,
        rate, (H, H), t(bias), bias_grad=True)
    assert dbias3.shape == (B * H, S, S)
    np.testing.assert_allclose(_f32(dbias3), _f32(want), rtol=0, atol=1e-5)
    if causal:
        # the (query tile 0, key tile 1) tile is skipped by the reference
        assert np.all(np.asarray(want)[:, :64, 64:] == 0.0)
        assert np.all(_f32(dbias3)[:, :64, 64:] == 0.0)
    # without bias_grad the plain backward returns no dbias
    assert tattn.flash_attention_bwd_ref(
        t(q3), t(k3), t(v3), o, lse_t, t(do3), seed_pack, scale, causal,
        rate, (H, H), t(bias))[3] is None


def test_bf16_bias_and_a_constant_mask():
    """A bf16 bias is added in fp32 (as the reference's astype); with
    ``bias_grad=False`` the bias is a constant and gets no gradient."""
    q, k, v, bias, _ = _inputs(4, "full")
    bias16 = torch.from_numpy(bias).to(torch.bfloat16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, bias=bias16)
    want = jattn.attention_ref(
        *(jnp.asarray(a) for a in (q, k, v)),
        bias=jnp.asarray(bias16.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=1e-5)
    tb = torch.from_numpy(bias).requires_grad_()
    tq.requires_grad_()
    out = tattn.flash_attention(tq, tk, tv, bias=tb)
    out.sum().backward()
    assert tb.grad is None and tq.grad is not None


def test_kernel_wrapper_checks_the_bias(monkeypatch):
    """With the dispatch rule forced to the kernel, a bias the kernel does
    not take raises before any launch."""
    monkeypatch.setattr(tattn, "use_kernel", lambda *t: True)
    q = torch.zeros(B * H, S, D)
    seed = torch.zeros(4, dtype=torch.int32)
    args = (seed, 0.125, False, 0.0, (H, H))
    with pytest.raises(ValueError, match="bias"):
        tattn.flash_attention_fwd(q, q, q, *args,
                                  bias=torch.zeros(3, S, S))
    with pytest.raises(ValueError, match="bias"):
        tattn.flash_attention_fwd(q, q, q, *args,
                                  bias=torch.zeros(B, S, S).half())
    with pytest.raises(ValueError, match="unit last stride"):
        tattn.flash_attention_fwd(q, q, q, *args,
                                  bias=torch.zeros(B, S, S).transpose(1, 2))
