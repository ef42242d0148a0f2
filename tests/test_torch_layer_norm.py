"""apex_tpu_torch LayerNorm vs the JAX package, on the CPU.

The port's ``layer_norm`` on CPU tensors runs its plain version; it is
held against the JAX ``layer_norm_ref`` and against the Pallas
``_ln_fwd_kernel`` run in interpret mode (``force_pallas(True)``), on
the same numpy-seeded inputs, at fp32 and bf16 and with row counts that
do not fill a row block.  Tolerances: fp32 atol 1e-6 (only the order of
the fp32 sums differs); bf16 within one bf16 ulp of the larger output
(the fp32 results may land on either side of a rounding boundary).
"""
import importlib

import jax
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


# -- backward (the autograd.Function over the backward kernel's plain
# version): dx within 1e-5 (fp32 x; 1 bf16 ulp of the larger magnitude
# plus 1e-6 for bf16 x), dgamma/dbeta within rtol 1e-5 for fp32 weights
# and one bf16 ulp for bf16 weights (the O2 case: fp32 x, bf16 affine),
# against the JAX VJP in interpret mode (the fused dx + dgamma/dbeta
# epilogue kernel) and at its CPU default.

def _bwd_inputs(shape, seed):
    x, w, b = _inputs(shape, seed)
    dy = np.random.RandomState(seed + 1).randn(*shape).astype(np.float32)
    return x, w, b, dy


def _jax_vjp(x, w, b, dy):
    def f(x_, w_, b_):
        return jax_layer_norm(x_, w_, b_)
    _, vjp = jax.vjp(f, x, w, b)
    return vjp(dy)


def _close_dtype(got, want, tdt, rtol):
    got, want = _as_f32(got), _as_f32(want)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)
        return
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= ulp + 1e-6), \
        np.max(np.abs(got - want) / ulp)


@pytest.mark.parametrize("w_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 256), (3, 5, 128), (13, 384)])
def test_backward_matches_jax_vjp(shape, x_dtype, w_dtype):
    x_np_dt, _, x_tdt = DTYPES[x_dtype]
    w_np_dt, _, w_tdt = DTYPES[w_dtype]
    x, w, b, dy = _bwd_inputs(shape, seed=shape[-1] + len(shape))
    xq, dyq = x.astype(x_np_dt), dy.astype(x_np_dt)
    wq, bq = w.astype(w_np_dt), b.astype(w_np_dt)
    xt = _to_torch(xq, x_tdt).requires_grad_()
    wt = _to_torch(wq, w_tdt).requires_grad_()
    bt = _to_torch(bq, w_tdt).requires_grad_()
    y = layer_norm(xt, wt, bt)
    assert y.dtype == x_tdt
    y.backward(_to_torch(dyq, x_tdt))
    assert xt.grad.dtype == x_tdt and wt.grad.dtype == w_tdt
    assert bt.grad.dtype == w_tdt
    jargs = tuple(jnp.asarray(a) for a in (xq, wq, bq, dyq))
    for force in (True, None):
        with force_pallas(force):
            dx, dw, db = _jax_vjp(*jargs)
        _close_dtype(xt.grad, dx, x_tdt, rtol=0)
        _close_dtype(wt.grad, dw, w_tdt, rtol=1e-5)
        _close_dtype(bt.grad, db, w_tdt, rtol=1e-5)


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
def test_non_affine_backward_matches_jax(x_dtype):
    np_dt, _, tdt = DTYPES[x_dtype]
    x, _, _, dy = _bwd_inputs((9, 256), seed=21)
    xq, dyq = x.astype(np_dt), dy.astype(np_dt)
    xt = _to_torch(xq, tdt).requires_grad_()
    layer_norm(xt).backward(_to_torch(dyq, tdt))
    for force in (True, None):
        with force_pallas(force):
            _, vjp = jax.vjp(lambda a: jax_layer_norm(a), jnp.asarray(xq))
            (dx,) = vjp(jnp.asarray(dyq))
        _close_dtype(xt.grad, dx, tdt, rtol=0)


def test_bf16_affine_forward_matches_jax():
    """Under O2 the LayerNorm weights are bf16 while x is fp32."""
    x, w, b = _inputs((11, 768), seed=31)
    wq = w.astype(ml_dtypes.bfloat16)
    bq = b.astype(ml_dtypes.bfloat16)
    got = layer_norm(torch.from_numpy(x), _to_torch(wq, torch.bfloat16),
                     _to_torch(bq, torch.bfloat16))
    assert got.dtype == torch.float32
    for force in (True, None):
        with force_pallas(force):
            want = jax_layer_norm(jnp.asarray(x), jnp.asarray(wq),
                                  jnp.asarray(bq))
        _assert_close(got, want, "fp32")


def test_layer_norm_bwd_on_cpu_is_the_plain_version():
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_bwd_ref
    x, w, _, dy = _bwd_inputs((6, 128), seed=41)
    xt, wt, dyt = (torch.from_numpy(a) for a in (x, w, dy))
    for got, want in zip(layer_norm_bwd(xt, wt, dyt),
                         layer_norm_bwd_ref(xt, wt, dyt)):
        assert torch.equal(got, want)
    assert layer_norm_bwd.launches == 0


def test_cuda_path_raises_on_what_the_kernel_does_not_take(monkeypatch):
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    monkeypatch.setattr(ln, "use_kernel", lambda *t: True)
    with pytest.raises(ValueError, match="fp32/bf16 x"):
        ln.layer_norm(torch.zeros(2, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="n <="):
        ln.layer_norm(torch.zeros(2, ln.MAX_N + 1))
    with pytest.raises(ValueError, match="one dtype"):
        ln.layer_norm(torch.zeros(2, 8), torch.ones(8),
                      torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dy like x"):
        ln.layer_norm_bwd(torch.zeros(2, 8), torch.ones(8),
                          torch.zeros(2, 8, dtype=torch.bfloat16))
