"""apex_tpu_torch LayerNorm vs the JAX package, on the CPU.

The port's ``layer_norm`` on CPU tensors runs its plain version; it is
held against the JAX ``layer_norm_ref`` and against the Pallas
``_ln_fwd_kernel`` run in interpret mode (``force_pallas(True)``), on
the same numpy-seeded inputs, at fp32 and bf16 and with row counts that
do not fill a row block.  Tolerances: fp32 atol 1e-6 (only the order of
the fp32 sums differs); bf16 within one bf16 ulp of the larger output
(the fp32 results may land on either side of a rounding boundary).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.normalization import FusedLayerNorm as JaxFusedLayerNorm
from apex_tpu.ops._common import force_pallas
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu.ops.layer_norm import layer_norm_ref as jax_layer_norm_ref
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.layer_norm import layer_norm, layer_norm_ref

SHAPES = [(7, 256), (3, 5, 128), (1, 768), (13, 384)]
DTYPES = {"fp32": (np.float32, jnp.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    n = shape[-1]
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(n)).astype(np.float32)
    b = (0.1 * rng.randn(n)).astype(np.float32)
    return x, w, b


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _as_f32(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y, np.float32)


def _assert_close(got, want, dtype_name):
    got, want = _as_f32(got), _as_f32(want)
    if dtype_name == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    # one bf16 ulp (8 significand bits) of the larger magnitude
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_reference_and_interpreted_kernel(shape, dtype_name):
    np_dt, jdt, tdt = DTYPES[dtype_name]
    x, w, b = _inputs(shape, seed=len(shape) * 100 + shape[-1])
    xq = x.astype(np_dt)  # both sides see the same rounded input
    got = layer_norm(_to_torch(xq, tdt), torch.from_numpy(w),
                     torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == shape
    ref = jax_layer_norm_ref(jnp.asarray(xq), jnp.asarray(w), jnp.asarray(b))
    _assert_close(got, ref, dtype_name)
    with force_pallas(True):
        kern = jax_layer_norm(jnp.asarray(xq), jnp.asarray(w), jnp.asarray(b))
    assert kern.dtype == jdt
    _assert_close(got, kern, dtype_name)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
def test_non_affine_and_one_sided(dtype_name):
    np_dt, _, tdt = DTYPES[dtype_name]
    x, w, b = _inputs((9, 128), seed=5)
    xq = x.astype(np_dt)
    xt, xj = _to_torch(xq, tdt), jnp.asarray(xq)
    _assert_close(layer_norm(xt), jax_layer_norm_ref(xj), dtype_name)
    # one-sided affine is completed with ones/zeros, as the JAX wrapper does
    with force_pallas(True):
        want_w = jax_layer_norm(xj, jnp.asarray(w), None)
        want_b = jax_layer_norm(xj, None, jnp.asarray(b))
    _assert_close(layer_norm(xt, torch.from_numpy(w), None), want_w,
                  dtype_name)
    _assert_close(layer_norm(xt, None, torch.from_numpy(b)), want_b,
                  dtype_name)


def test_cpu_wrapper_is_the_plain_version_bitwise():
    x, w, b = _inputs((6, 256), seed=11)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    assert torch.equal(layer_norm(xt, wt, bt), layer_norm_ref(xt, wt, bt))


@pytest.mark.parametrize("shape", [(4, 3, 128), (2, 5, 768)])
def test_fused_layer_norm_module_matches_flax_module(shape):
    x, _, _ = _inputs(shape, seed=3)
    n = shape[-1]
    jmod = JaxFusedLayerNorm(n)
    rng = np.random.RandomState(4)
    params = {"scale": jnp.asarray(1 + 0.1 * rng.randn(n), jnp.float32),
              "bias": jnp.asarray(0.1 * rng.randn(n), jnp.float32)}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    mod = FusedLayerNorm(n)
    assert mod.weight.dtype == torch.float32 and mod.bias.dtype == torch.float32
    with torch.no_grad():
        mod.weight.copy_(torch.tensor(np.array(params["scale"])))
        mod.bias.copy_(torch.tensor(np.array(params["bias"])))
        got = mod(torch.from_numpy(x))
    _assert_close(got, want, "fp32")


def test_fused_layer_norm_rejects_wrong_trailing_dims():
    with pytest.raises(ValueError):
        FusedLayerNorm(64)(torch.zeros(2, 32))
