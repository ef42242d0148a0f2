"""apex_tpu_torch's contrib ``SoftmaxCrossEntropyLoss`` vs the JAX
package's, on the CPU.

Per-row losses of numpy-seeded logits (fp32, and bf16 logits that both
sides upcast to fp32 inside) at vocabularies 1000 and 5000 (not a
multiple of 128, as the kernels' ragged tail), label smoothing 0 and
0.1, ``padding_idx`` 0 (the default: rows labelled 0 lose nothing) and
None through ``apply``, against JAX's module with its Pallas kernel in
interpret mode and its jnp reference (``force_pallas`` True and None):
the losses and the logits' gradient within 1e-5 of their largest
magnitude, the padded rows' losses and gradients exactly 0.  Also a
leading batch shape and ``half_to_float`` accepted and inert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.xentropy import SoftmaxCrossEntropyLoss as JaxLoss
from apex_tpu.ops._common import force_pallas
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss

ROWS = 64


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _data(v, seed=0):
    rng = np.random.RandomState(seed)
    logits = (2.0 * rng.randn(ROWS, v)).astype(np.float32)
    labels = rng.randint(0, v, size=(ROWS,))
    labels[::5] = 0  # the padding rows
    return logits, labels


def _within(got, want):
    want = np.asarray(want, np.float32)
    return bool(np.abs(np.asarray(got, np.float32) - want).max()
                <= 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v", [1000, 5000])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_loss_module_matches_jax(dtype, v, smoothing):
    logits, labels = _data(v)
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    tlab = torch.from_numpy(labels)
    loss = SoftmaxCrossEntropyLoss(smoothing=smoothing)(tl, tlab)
    assert loss.dtype == torch.float32 and loss.shape == (ROWS,)
    assert not loss[::5].any()
    loss.sum().backward()
    assert not tl.grad[::5].any()
    jmod = JaxLoss(smoothing=smoothing)
    for force in (True, None):
        with force_pallas(force):
            want = jmod(jl, jnp.asarray(labels))
            jg = jax.grad(lambda x: jnp.sum(jmod(x, jnp.asarray(labels))))(jl)
        assert _within(loss.detach().numpy(), want)
        assert _within(tl.grad.float().numpy(), jnp.asarray(jg, jnp.float32))


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_apply_matches_jax(padding_idx):
    logits, labels = _data(1000, seed=1)
    labels[::4] = 3
    got = SoftmaxCrossEntropyLoss.apply(
        torch.from_numpy(logits), torch.from_numpy(labels), 0.1, padding_idx,
        True)
    want = JaxLoss.apply(jnp.asarray(logits), jnp.asarray(labels), 0.1,
                         padding_idx)
    assert _within(got.numpy(), want)
    assert bool((got[::4] == 0).all()) == (padding_idx is not None)


def test_leading_shape_and_half_to_float():
    logits, labels = _data(1000, seed=2)
    x = torch.from_numpy(logits).reshape(4, ROWS // 4, 1000)
    y = torch.from_numpy(labels).reshape(4, ROWS // 4)
    a = SoftmaxCrossEntropyLoss(0.1, padding_idx=0, half_to_float=True)(x, y)
    b = SoftmaxCrossEntropyLoss(0.1, padding_idx=0)(x.reshape(ROWS, 1000),
                                                    y.reshape(ROWS))
    assert a.shape == (4, ROWS // 4)
    assert torch.equal(a.reshape(ROWS), b)
