"""apex_tpu_torch's conv+BN matmuls (``ops/conv_bn.py``) vs the JAX
package, on the CPU, where each entry point runs its plain version.

- ``matmul_stats``, ``bn_relu_matmul`` and ``matmul_bwd_dual`` at
  (256, 128, 256) against the JAX Pallas kernels in interpret mode
  (``use_pallas=True``), fp32 and bf16, ``relu`` on and off,
  ``with_stats`` on and off; and at a ragged (100, 72, 40) against JAX's
  jnp branch (``use_pallas=False``: the TPU kernels take multiples of 128
  only).  Tolerances: fp32 outputs within 1e-5 of the largest |x|.|w|
  term sum (fp32 sums in two orders); bf16 outputs within 1 bf16 ulp
  (a sum order can flip one rounding) plus that; the stats within the
  sum of the two sides' output differences (stats of different stored
  values) plus 1e-5 of sum|y|.  The Pallas BN kernel rounds the
  normalised operand to w's dtype before the product while both plain
  versions do not: against it a bf16 output may also move by 2^-8 of
  sum_k |a_k| |w_k| (one bf16 rounding of each term);
- the gradients of both autograd Functions, stats cotangents included,
  against ``jax.grad`` of the JAX functions (the same jnp VJP), fp32
  within 1e-5 of each gradient's largest magnitude, and bf16 inputs and
  parameters getting gradients of their own dtypes that match JAX's
  within 1 bf16 ulp plus 1e-3 of the largest magnitude;
- what the CUDA path refuses (dtype, contiguity, shapes) raises before
  any kernel is looked for.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops import conv_bn as jcb
from apex_tpu_torch.ops import conv_bn as tcb

M, K, N = 256, 128, 256
RAGGED = (100, 72, 40)
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(shape, dtype, seed=0):
    m, k, n = shape
    np_dt = DTYPES[dtype][0]
    rng = np.random.RandomState(seed)
    x = (0.5 * rng.randn(m, k)).astype(np_dt)
    w = (0.5 * rng.randn(k, n)).astype(np_dt)
    mean = (0.1 * rng.randn(k)).astype(np.float32)
    rstd = (1.0 + rng.rand(k)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(k)).astype(np.float32)
    beta = (0.1 * rng.randn(k)).astype(np.float32)
    dy = (0.5 * rng.randn(m, n)).astype(np_dt)
    return x, w, (mean, rstd, gamma, beta), dy


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.detach().float().numpy().astype(np.float64)


def _ulp(v):
    """One bf16 ulp of |v|."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _assert_out(got, want, absw, bf16, extra=0.0):
    """``got`` within 1e-5 of the term magnitudes ``absw`` (+ ``extra``),
    plus one bf16 ulp for a bf16 result."""
    g, w = _np(got), np.asarray(want, np.float64)
    tol = 1e-5 * absw + extra
    if bf16:
        tol = tol + _ulp(np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) - tol)


def _assert_stats(got, want, y_got, y_want):
    s, ss = _np(got[0]), _np(got[1])
    ws, wss = (np.asarray(v, np.float64) for v in want)
    yg, yw = _np(y_got), np.asarray(y_want, np.float64)
    dy = np.abs(yg - yw)
    tol_s = dy.sum(0) + 1e-5 * np.abs(yg).sum(0)
    tol_ss = (dy * (np.abs(yg) + np.abs(yw))).sum(0) + 1e-5 * (yg * yg).sum(0)
    assert np.all(np.abs(s - ws) <= tol_s + 1e-30)
    assert np.all(np.abs(ss - wss) <= tol_ss + 1e-30)


def _lhs(x, params, relu):
    mean, rstd, gamma, beta = params
    a = (np.asarray(x, np.float64) - mean) * (rstd.astype(np.float64)
                                              * gamma) + beta
    return np.maximum(a, 0.0) if relu else a


@pytest.mark.parametrize("with_stats", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_stats_matches_jax_kernel(dtype, with_stats):
    x, w, _, _ = _inputs((M, K, N), dtype)
    want = jcb.matmul_stats(jnp.asarray(x), jnp.asarray(w), use_pallas=True)
    got = tcb.matmul_stats(_t(x), _t(w), with_stats=with_stats)
    y = got[0] if with_stats else got
    assert isinstance(got, tuple) == with_stats
    assert y.dtype == DTYPES[dtype][1] and y.shape == (M, N)
    absw = np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(w,
                                                                 np.float64))
    _assert_out(y, want[0], absw, dtype == "bfloat16")
    if with_stats:
        assert got[1].dtype == got[2].dtype == torch.float32
        _assert_stats(got[1:], want[1:], y, want[0])


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bn_relu_matmul_matches_jax_kernel(dtype, relu):
    x, w, params, _ = _inputs((M, K, N), dtype, seed=1)
    jargs = [jnp.asarray(v) for v in (x, *params, w)]
    kern = jcb.bn_relu_matmul(*jargs, relu=relu, use_pallas=True)
    plain = jcb.bn_relu_matmul(*jargs, relu=relu, use_pallas=False)
    got = tcb.bn_relu_matmul(_t(x), *map(_t, params), _t(w), relu=relu)
    bf16 = dtype == "bfloat16"
    a = _lhs(x, params, relu)
    absw = np.abs(a) @ np.abs(np.asarray(w, np.float64))
    assert got[0].dtype == DTYPES[dtype][1]
    _assert_out(got[0], plain[0], absw, bf16)
    _assert_stats(got[1:], plain[1:], got[0], plain[0])
    # the kernel's bf16 rounding of the normalised operand
    _assert_out(got[0], kern[0], absw, bf16,
                extra=2.0 ** -8 * absw if bf16 else 0.0)
    y = tcb.bn_relu_matmul(_t(x), *map(_t, params), _t(w), relu=relu,
                           with_stats=False)
    assert torch.equal(y, got[0])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_bwd_dual_matches_jax_kernel(dtype):
    x, w, _, dy = _inputs((M, K, N), dtype, seed=2)
    jdx, jdw = jcb.matmul_bwd_dual(jnp.asarray(x), jnp.asarray(dy),
                                   jnp.asarray(w))
    dx, dw = tcb.matmul_bwd_dual(_t(x), _t(dy), _t(w))
    assert dx.dtype == DTYPES[dtype][1] and dw.dtype == torch.float32
    x64, dy64, w64 = (np.abs(np.asarray(v, np.float64)) for v in (x, dy, w))
    _assert_out(dx, jdx, dy64 @ w64.T, dtype == "bfloat16")
    _assert_out(dw, jdw, x64.T @ dy64, False)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ragged_shape_matches_jax_plain_branch(dtype):
    x, w, params, dy = _inputs(RAGGED, dtype, seed=3)
    bf16 = dtype == "bfloat16"
    want = jcb.matmul_stats(jnp.asarray(x), jnp.asarray(w), use_pallas=False)
    got = tcb.matmul_stats(_t(x), _t(w))
    absw = np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(w,
                                                                 np.float64))
    _assert_out(got[0], want[0], absw, bf16)
    _assert_stats(got[1:], want[1:], got[0], want[0])
    jargs = [jnp.asarray(v) for v in (x, *params, w)]
    want = jcb.bn_relu_matmul(*jargs, use_pallas=False)
    got = tcb.bn_relu_matmul(_t(x), *map(_t, params), _t(w))
    absw = np.abs(_lhs(x, params, True)) @ np.abs(np.asarray(w, np.float64))
    _assert_out(got[0], want[0], absw, bf16)
    _assert_stats(got[1:], want[1:], got[0], want[0])
    dx, dw = tcb.matmul_bwd_dual(_t(x), _t(dy), _t(w))
    x64, dy64, w64 = (np.asarray(v, np.float64) for v in (x, dy, w))
    _assert_out(dx, dy64 @ w64.T, np.abs(dy64) @ np.abs(w64).T, bf16)
    _assert_out(dw, x64.T @ dy64, np.abs(x64).T @ np.abs(dy64), False)


def _loss_jax(fn):
    def f(*args):
        y, s, ss = fn(*args)
        y = y.astype(jnp.float32)
        return jnp.mean(y ** 2) + 0.01 * jnp.sum(s) + 0.001 * jnp.sum(ss)
    return f


def _loss_torch(out):
    y, s, ss = out
    y = y.float()
    return (y ** 2).mean() + 0.01 * s.sum() + 0.001 * ss.sum()


def _grad_close(got, want, bf16):
    g, w = _np(got), np.asarray(want, np.float64)
    tol = (1e-3 if bf16 else 1e-5) * np.abs(w).max()
    if bf16:
        tol = tol + _ulp(np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) - tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_stats_grads_match_jax(dtype):
    x, w, _, _ = _inputs(RAGGED, dtype, seed=4)
    want = jax.grad(_loss_jax(lambda x, w: jcb.matmul_stats(
        x, w, use_pallas=False)), argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    _loss_torch(tcb.matmul_stats(tx, tw)).backward()
    for t, g in zip((tx, tw), want):
        assert t.grad.dtype == t.dtype
        _grad_close(t.grad, g, dtype == "bfloat16")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bn_relu_matmul_grads_match_jax(dtype, relu):
    """Every cotangent in its primal's dtype: with bf16 x, w and BN
    parameters all six gradients are bf16."""
    x, w, params, _ = _inputs(RAGGED, dtype, seed=5)
    np_dt = DTYPES[dtype][0]
    params = tuple(p.astype(np_dt) for p in params)
    jargs = [jnp.asarray(v) for v in (x, *params, w)]
    want = jax.grad(_loss_jax(lambda *a: jcb.bn_relu_matmul(
        *a, relu=relu, use_pallas=False)), argnums=tuple(range(6)))(*jargs)
    targs = [_t(v).requires_grad_() for v in (x, *params, w)]
    _loss_torch(tcb.bn_relu_matmul(*targs, relu=relu)).backward()
    for t, g in zip(targs, want):
        assert t.grad.dtype == t.dtype == DTYPES[dtype][1]
        _grad_close(t.grad, g, dtype == "bfloat16")


def test_kernel_path_refuses_what_it_does_not_take():
    """The CUDA path's checks (shape, dtype, contiguity), reached before
    the library is loaded."""
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="fp32/bf16"):
        tcb._launch_fwd(x.half(), torch.zeros(4, 3).half(), None, False, True)
    with pytest.raises(ValueError, match="contiguous"):
        tcb._launch_fwd(torch.zeros(4, 8).T, torch.zeros(4, 3), None, False,
                        True)
    with pytest.raises(ValueError, match="shape"):
        tcb._launch_fwd(x, torch.zeros(4, 3),
                        (torch.zeros(5),) * 4, False, True)
    with pytest.raises(ValueError, match="devices"):
        tcb.matmul_bwd_dual(x, torch.zeros(8, 3), torch.zeros(4, 3,
                                                              device="meta"))
