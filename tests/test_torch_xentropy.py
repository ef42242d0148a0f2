"""apex_tpu_torch softmax cross-entropy vs the JAX package, on the CPU.

The port's ``softmax_cross_entropy`` on CPU tensors runs its plain
versions (the forward and backward of the same ``autograd.Function`` the
CUDA kernels use).  They are held against the JAX function in Pallas
interpret mode (``force_pallas(True)``: the vocab-tiled
``_xent_fwd_kernel`` and ``_xent_bwd_kernel``, ragged last tile masked)
and at its CPU default, on numpy-seeded logits: 300 rows (not a multiple
of the 256-row block), V in {1000, 4500} (neither a multiple of the
2048-wide vocab tile), label smoothing {0, 0.1}.  Tolerances: losses
within 1e-5 (fp32 sums in another order); dlogits within 1 bf16 ulp of
the larger magnitude for bf16 logits (one rounding of an fp32 result on
each side) plus 1e-9 absolute, and 1e-6 for fp32 logits: where p cancels
against the smoothing target eps / V, a few fp32 ulps of p (the JAX
reference takes a softmax, the kernel exp(l - lse)) are many bf16 ulps of
the tiny difference.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops._common import force_pallas
from apex_tpu.ops.softmax_xentropy import (
    softmax_cross_entropy as jax_xent,
    softmax_cross_entropy_ref as jax_xent_ref,
)
from apex_tpu_torch.ops import softmax_xentropy as tx

ROWS = 300
DTYPES = {"fp32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(v, np_dt, seed):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(ROWS, v)).astype(np_dt)
    labels = rng.randint(0, v, size=(ROWS,)).astype(np.int32)
    g = rng.rand(ROWS).astype(np.float32)
    return logits, labels, g


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-9), \
        np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("v", [1000, 4500])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_loss_and_dlogits_match_jax(dtype, v, smoothing):
    np_dt, tdt = DTYPES[dtype]
    logits, labels, g = _inputs(v, np_dt, seed=v + int(smoothing * 10))
    tl = torch.from_numpy(np.asarray(logits, np.float32)).to(tdt)
    tl.requires_grad_()
    loss = tx.softmax_cross_entropy(tl, torch.from_numpy(labels).long(),
                                    smoothing)
    assert loss.dtype == torch.float32 and loss.shape == (ROWS,)
    (loss * torch.from_numpy(g)).sum().backward()
    assert tl.grad.dtype == tdt

    def jloss(lg):
        return jnp.sum(jax_xent(lg, jnp.asarray(labels), smoothing)
                       * jnp.asarray(g))

    jl = jnp.asarray(logits)
    # the JAX package takes its kernel for half-precision logits only
    for force in ((True, None) if dtype == "bf16" else (None,)):
        with force_pallas(force):
            want = jax_xent(jl, jnp.asarray(labels), smoothing)
            want_d = jax.grad(jloss)(jl)
        np.testing.assert_allclose(_f32(loss), _f32(want), rtol=0, atol=1e-5)
        _close(tl.grad, want_d, dtype)


def test_reference_matches_jax_reference_with_leading_shape():
    rng = np.random.RandomState(1)
    logits = rng.randn(3, 7, 512).astype(np.float32)
    labels = rng.randint(0, 512, size=(3, 7))
    got = tx.softmax_cross_entropy_ref(torch.from_numpy(logits),
                                       torch.from_numpy(labels), 0.1)
    want = jax_xent_ref(jnp.asarray(logits), jnp.asarray(labels), 0.1)
    assert got.shape == (3, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # the differentiable wrapper keeps the leading shape too
    out = tx.softmax_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 0.1)
    torch.testing.assert_close(out, got, rtol=0, atol=1e-6)


def test_cuda_path_raises_on_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(tx, "use_kernel", lambda *t: True)
    labels = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="fp32/bf16"):
        tx.softmax_cross_entropy(torch.zeros(4, 8, dtype=torch.float16),
                                 labels)
    with pytest.raises(ValueError, match="unit last stride"):
        tx.softmax_cross_entropy_fwd(torch.zeros(8, 4).t(), labels, 0.0)
