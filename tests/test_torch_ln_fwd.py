"""The LayerNorm forward's designs and rows of any width, on the CPU.

The forward's warp design (a warp a row, 16-byte vectors) runs only on
the card; here the tests hold a plain numpy model of its decomposition
(lane l holds columns (32 v + l) VW + e, each lane adds its elements in
order, the lane sums are added by an xor butterfly, the affine as one
fused multiply-add, one rounding to x's dtype) against JAX's
``_ln_fwd_kernel`` in interpret mode under ``force_pallas`` (its jnp
reference, the same math, where n is no multiple of 128), the design
rule ``_ln_fwd_design`` on bases off alignment, and the port's plain
forward and backward at rows wider than the block designs take against
JAX (the interpret-mode forward kernel; ``jax.vjp`` for the backward).

Tolerances: fp32 within 1e-5 of the largest |y|; a bf16 y within one
bf16 ulp of the larger magnitude plus, per element, 4 fp32 ulps (2^-21)
of (|x| + |mean|) rstd |w| + |b| (the fp32 sums in another order move a
y that cancels to near 0 by many of its own bf16 ulps, but by less than
an fp32 ulp of the magnitudes it is formed from; ``chip_smoke.py``'s
``ln_fwd_slack`` is the same rule on the card); a bf16 dx within one
bf16 ulp plus 1e-5 of the largest |dx|, as the card's backward check.
Also: ``SyncBatchNorm.init_stats`` and
``ResNet.init_batch_stats`` put their tensors on the card unless the
caller names another device.
"""
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops._common import force_pallas
from apex_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from apex_tpu_torch.models.resnet import resnet50
from apex_tpu_torch.ops.layer_norm import layer_norm
from apex_tpu_torch.parallel import SyncBatchNorm

tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

DTYPES = {"fp32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(rows, n, seed, x_dt, w_dt):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, n) * 2.0 + 0.5).astype(np.float32).astype(x_dt)
    w = (1.0 + 0.1 * rng.randn(n)).astype(np.float32).astype(w_dt)
    b = (0.1 * rng.randn(n)).astype(np.float32).astype(w_dt)
    return x, w, b


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _slack(x, w, b):
    """Per element of y = LayerNorm(x) w + b: 2^-21 of (|x| + |mean|) rstd
    |w| + |b| (w 1 and b 0 without an affine)."""
    x32 = _f32(x).astype(np.float64)
    mean = x32.mean(-1, keepdims=True)
    rstd = 1.0 / np.sqrt(x32.var(-1, keepdims=True) + 1e-5)
    w = 1.0 if w is None else np.abs(_f32(w))
    b = 0.0 if b is None else np.abs(_f32(b))
    return 2.0 ** -21 * ((np.abs(x32) + np.abs(mean)) * rstd * w + b)


def _assert_close(got, want, bf16: bool, slack=None):
    """fp32: within 1e-5 of max|want|.  bf16: within one bf16 ulp of the
    larger magnitude plus ``slack`` (an array like y), or, without one,
    plus 1e-5 of max|want|."""
    got, want = _f32(got), _f32(want)
    tol = 1e-5 * np.max(np.abs(want))
    if bf16:
        big = np.maximum(np.abs(got), np.abs(want))
        tol = (tol if slack is None else slack) \
            + np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) - tol)


def _model_ln_fwd(x, w, b, eps=1e-5):
    """The warp design's forward in numpy fp32 over (rows, n) ``x`` (fp32
    or bf16; n a whole number of 16-byte vectors of VW elements): lane l
    holds columns (32 v + l) VW + e of the instantiation's vectors (those
    of n = 768 up to 768, of 1024 above; past n, 0), adds them in order
    (x and x * x), the lane sums are added by the xor butterfly over
    offsets 16, 8, 4, 2, 1; mean = s / n, var = ss / n - mean^2; the
    affine is one fused multiply-add (its product exact in float64); the
    result rounded once to x's dtype."""
    rows, n = x.shape
    vw = 16 // x.dtype.itemsize
    assert n % vw == 0 and n <= tln.WARP_MAX_N
    nv = (768 if n <= 768 else tln.WARP_MAX_N) // (32 * vw)
    cols = ((32 * np.arange(nv)[None, :, None] + np.arange(32)[:, None, None])
            * vw + np.arange(vw)[None, None, :]).reshape(32, nv * vw)
    valid = cols < n
    x32 = x.astype(np.float32)
    xv = np.where(valid, x32[:, np.where(valid, cols, 0)],
                  np.float32(0)).astype(np.float32)  # (rows, 32, E)
    s = np.zeros((rows, 32), np.float32)
    ss = np.zeros((rows, 32), np.float32)
    for j in range(xv.shape[2]):
        s = s + xv[:, :, j]
        ss = ss + xv[:, :, j] * xv[:, :, j]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
        ss = ss + ss[:, lanes ^ o]
    assert np.all(s == s[:, :1]) and np.all(ss == ss[:, :1])
    mean = s[:, :1] / np.float32(n)
    var = ss[:, :1] / np.float32(n) - mean * mean
    rstd = (1.0 / np.sqrt(var.astype(np.float64) + eps)).astype(np.float32)
    y = (x32 - mean) * rstd
    if w is not None:
        y = (y.astype(np.float64) * w.astype(np.float32).astype(np.float64)
             + b.astype(np.float32).astype(np.float64)).astype(np.float32)
    return y.astype(x.dtype)


@pytest.mark.parametrize("w_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rows, n", [(300, 768), (257, 1024), (64, 96)])
def test_ln_fwd_warp_decomposition_matches_jax_kernel(rows, n, x_dtype,
                                                      w_dtype):
    x_np, x_tdt = DTYPES[x_dtype]
    w_np, _ = DTYPES[w_dtype]
    x, w, b = _inputs(rows, n, rows + n, x_np, w_np)
    assert tln._ln_fwd_design(
        torch.from_numpy(x.astype(np.float32)).to(x_tdt)) == tln.LN_FWD_WARP
    with force_pallas(True):
        want = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert want.dtype == x.dtype
    got = _model_ln_fwd(x, w, b)
    _assert_close(got, want, x_dtype == "bf16", _slack(x, w, b))
    with force_pallas(True):
        want0 = jax_layer_norm(jnp.asarray(x))
    _assert_close(_model_ln_fwd(x, None, None), want0, x_dtype == "bf16",
                  _slack(x, None, None))


def _offset_view(rows, n, dtype, misalign_bytes):
    """A contiguous (rows, n) view whose base is ``misalign_bytes`` past a
    16-byte boundary."""
    es = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(rows * n + 16, dtype=dtype)
    off = next(i for i in range(16)
               if (buf.data_ptr() + es * i) % 16 == misalign_bytes)
    return buf[off:off + rows * n].view(rows, n)


# the design of an aligned base at each n, fp32 and bf16 x (a bf16 row of
# 1021 is 2042 bytes, no whole number of vectors); a base off alignment
# turns the warp design into the block design
_ALIGNED = {768: tln.LN_FWD_WARP, 1024: tln.LN_FWD_WARP, 96: tln.LN_FWD_WARP,
            1021: tln.LN_FWD_BLOCK, 2304: tln.LN_FWD_BLOCK,
            12288: tln.LN_FWD_WIDE}


@pytest.mark.parametrize("misalign", [0, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", sorted(_ALIGNED))
def test_ln_fwd_design_rule(n, dtype, misalign):
    x = _offset_view(3, n, dtype, misalign)
    want = _ALIGNED[n]
    if misalign and want == tln.LN_FWD_WARP:
        want = tln.LN_FWD_BLOCK
    assert tln._ln_fwd_design(x) == want
    # the backward's rule is the same on x and dy
    dy = torch.zeros(3, n, dtype=dtype)
    assert tln._ln_bwd_design(x, dy) == want == tln._ln_bwd_design(dy, x)
    name = tln.ln_fwd_kernel(dtype, torch.bfloat16, n, want)
    assert (name in tln.LN_FWD_WARP_KERNELS) == (want == tln.LN_FWD_WARP)
    if want == tln.LN_FWD_WIDE:
        assert name.startswith("ln_fwd_wide<")
        assert tln.ln_bwd_kernel(dtype, None, n, want) is None


@pytest.mark.parametrize("n, want", [
    (96, "ln_fwd_block<fp32, bf16, 1>"), (1021, "ln_fwd_block<fp32, bf16, 4>"),
    (2304, "ln_fwd_block<fp32, bf16, 16>"),
    (8192, "ln_fwd_block<fp32, bf16, 32>")])
def test_ln_fwd_kernel_names_the_block_instantiation(n, want):
    assert tln.ln_fwd_kernel(torch.float32, torch.bfloat16, n,
                             tln.LN_FWD_BLOCK) == want


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [12288, 16384])
def test_wide_rows_forward_matches_jax_kernel(n, x_dtype):
    x_np, x_tdt = DTYPES[x_dtype]
    x, w, b = _inputs(3, n, n + 1, x_np, np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(x_tdt)
    assert tln._ln_fwd_design(xt) == tln.LN_FWD_WIDE
    got = layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))
    with force_pallas(True):
        want = jax_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _assert_close(got, want, x_dtype == "bf16", _slack(x, w, b))


@pytest.mark.parametrize("x_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [12288, 16384])
def test_wide_rows_backward_matches_jax_vjp(n, x_dtype):
    x_np, x_tdt = DTYPES[x_dtype]
    x, w, b = _inputs(3, n, n + 2, x_np, np.float32)
    dy = np.random.RandomState(n).randn(3, n).astype(np.float32).astype(x_np)
    assert tln._ln_bwd_design(torch.zeros(3, n, dtype=x_tdt),
                              torch.zeros(3, n, dtype=x_tdt)) \
        == tln.LN_BWD_WIDE
    xt = torch.from_numpy(x.astype(np.float32)).to(x_tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    layer_norm(xt, wt, bt).backward(
        torch.from_numpy(dy.astype(np.float32)).to(x_tdt))
    with force_pallas(True):
        _, vjp = jax.vjp(jax_layer_norm, *(jnp.asarray(a) for a in (x, w, b)))
        jdx, jdw, jdb = vjp(jnp.asarray(dy))
    _assert_close(xt.grad, jdx, x_dtype == "bf16")
    _assert_close(wt.grad, jdw, False)
    _assert_close(bt.grad, jdb, False)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_stats_go_to_the_card_unless_told(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bn = SyncBatchNorm(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bn.init_stats()
    mean, var = bn.init_stats(device)
    assert mean.device.type == var.device.type == device
    if device == "cpu":
        assert torch.equal(mean, torch.zeros(8))
        assert torch.equal(var, torch.ones(8))
    with torch.device("meta"):
        model = resnet50()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_batch_stats()
    stats = model.init_batch_stats(device)
    assert {t.device.type for t in stats.values()} == {device}
