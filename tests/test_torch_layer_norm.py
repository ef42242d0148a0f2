"""apex_tpu_torch LayerNorm vs the JAX package, on the CPU.

The port's ``layer_norm`` on CPU tensors runs its plain version; it is
held against the JAX ``layer_norm_ref`` and against the Pallas
``_ln_fwd_kernel`` run in interpret mode (``force_pallas(True)``), on
the same numpy-seeded inputs, at fp32 and bf16 and with row counts that
do not fill a row block.  Tolerances: fp32 atol 1e-6 (only the order of
the fp32 sums differs); bf16 within one bf16 ulp of the larger output
(the fp32 results may land on either side of a rounding boundary).

The backward's warp design runs only on the card; here the tests hold
its design rule (``_ln_bwd_design``), the partials the wrapper sizes by
what the library reports (a stand-in library), and a plain model of its
decomposition (a warp a row, lanes' strided sums reduced by an xor
butterfly, persistent blocks of four warps over contiguous row ranges,
each warp's dgamma/dbeta partials added in warp order into the block's,
the block partials added by a reduction whose eight warps each take a
contiguous run of them, then in warp order) against JAX's fused
``_ln_bwd_dx_dwdb`` VJP in interpret mode (its jnp rule where n is no
multiple of 128), within 1e-5 of each result's largest magnitude (plus
1 bf16 ulp for a bf16 result).
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

# the module (``apex_tpu_torch.ops.layer_norm`` as an attribute is the
# function the package re-exports)
tln = importlib.import_module("apex_tpu_torch.ops.layer_norm")

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


class _StandInFwdLib:
    """Records the design code each forward call hands the library."""

    def __init__(self):
        self.designs = []

    def apex_ln_fwd(self, *args):
        self.designs.append(args[-2])
        return 0


def test_cuda_path_raises_on_what_the_kernel_does_not_take(monkeypatch):
    import contextlib
    import types

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    monkeypatch.setattr(ln, "use_kernel", lambda *t: True)
    with pytest.raises(ValueError, match="fp32/bf16 x"):
        ln.layer_norm(torch.zeros(2, 8, dtype=torch.float16))
    # a row wider than the block designs take is accepted and runs the
    # wide design (any n)
    lib = _StandInFwdLib()
    monkeypatch.setattr(ln, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    wide = torch.zeros(2, ln.BLOCK_MAX_N + 1)
    assert ln.layer_norm(wide).shape == wide.shape
    assert lib.designs == [ln.LN_FWD_WIDE]
    assert ln._ln_bwd_design(wide, wide) == ln.LN_BWD_WIDE
    with pytest.raises(ValueError, match="one dtype"):
        ln.layer_norm(torch.zeros(2, 8), torch.ones(8),
                      torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dy like x"):
        ln.layer_norm_bwd(torch.zeros(2, 8), torch.ones(8),
                          torch.zeros(2, 8, dtype=torch.bfloat16))


# -- the backward's designs: the rule, the partials, a model ---------------

def _aligned_view(rows, n, dtype, misalign_bytes):
    """A contiguous (rows, n) view whose base is ``misalign_bytes`` past a
    16-byte boundary."""
    es = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(rows * n + 16, dtype=dtype)
    off = next(i for i in range(16)
               if (buf.data_ptr() + es * i) % 16 == misalign_bytes)
    return buf[off:off + rows * n].view(rows, n)


@pytest.mark.parametrize("n, dtype, misalign, want", [
    (768, torch.float32, 0, tln.LN_BWD_WARP),
    (768, torch.bfloat16, 0, tln.LN_BWD_WARP),
    (1024, torch.float32, 0, tln.LN_BWD_WARP),
    (96, torch.float32, 0, tln.LN_BWD_WARP),
    (1020, torch.bfloat16, 0, tln.LN_BWD_BLOCK),  # 2040 bytes a row
    (1021, torch.float32, 0, tln.LN_BWD_BLOCK),
    (768, torch.float32, 4, tln.LN_BWD_BLOCK),    # base off alignment
    (1025, torch.float32, 0, tln.LN_BWD_BLOCK),
    (8192, torch.bfloat16, 0, tln.LN_BWD_BLOCK)])
def test_ln_bwd_design_rule(n, dtype, misalign, want):
    x = _aligned_view(4, n, dtype, misalign)
    dy = torch.zeros(4, n, dtype=dtype)
    assert tln._ln_bwd_design(x, dy) == want
    assert tln._ln_bwd_design(dy, x) == want


@pytest.mark.parametrize("x_dt, w_dt, n, want", [
    (torch.float32, torch.bfloat16, 768, "ln_bwd_warp<fp32, bf16, 6 x 4>"),
    (torch.float32, None, 96, "ln_bwd_warp<fp32, fp32, 6 x 4>"),
    (torch.float32, torch.float32, 1000, "ln_bwd_warp<fp32, fp32, 8 x 4>"),
    (torch.bfloat16, torch.float32, 520, "ln_bwd_warp<bf16, fp32, 3 x 8>"),
    (torch.bfloat16, torch.bfloat16, 1024, "ln_bwd_warp<bf16, bf16, 4 x 8>")])
def test_ln_bwd_kernel_names_each_warp_instantiation(x_dt, w_dt, n, want):
    assert want in tln.LN_BWD_WARP_KERNELS
    assert tln.ln_bwd_kernel(x_dt, w_dt, n, tln.LN_BWD_WARP) == want
    assert tln.ln_bwd_kernel(x_dt, w_dt, n, tln.LN_BWD_BLOCK) is None


def test_every_ln_bwd_warp_kernel_is_reached_at_a_checked_case():
    """chip_smoke.py's LayerNorm backward cases launch every warp
    instantiation (its phase fails otherwise)."""
    import chip_smoke
    reached = set()
    for rows, n, x_dt, w_dt in chip_smoke.ln_bwd_cases():
        x = torch.zeros(1, n, dtype=x_dt)
        reached.add(tln.ln_bwd_kernel(x_dt, w_dt, n,
                                      tln._ln_bwd_design(x, x)))
    assert reached - {None} == set(tln.LN_BWD_WARP_KERNELS)


class _StandInLnLib:
    """Records what the backward wrapper hands the library; reports its
    own geometry (5 blocks of ceil(rows / 5) rows for the warp design,
    16 rows a block for the block design)."""

    PARTS = 5

    def __init__(self):
        self.seen = []

    def _geometry(self, rows, n, dtype, w_dtype, design):
        if design == tln.LN_BWD_BLOCK:
            return -(-rows // 16), 16
        rpb = -(-rows // self.PARTS)
        return -(-rows // rpb), rpb

    def apex_ln_bwd_geometry(self, rows, n, dtype, w_dtype, design, out):
        out[0], out[1] = self._geometry(rows, n, dtype, w_dtype, design)
        return 0

    def apex_ln_bwd(self, *args):
        self.seen.append((args[-2], args[4]))
        return 0


@pytest.mark.parametrize("rows, n, design", [
    (300, 768, tln.LN_BWD_WARP), (257, 1021, tln.LN_BWD_BLOCK),
    (40, 2048, tln.LN_BWD_BLOCK)])
def test_ln_bwd_partials_are_sized_by_the_library(monkeypatch, rows, n,
                                                  design):
    import contextlib
    import types

    lib = _StandInLnLib()
    made = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = tuple(t.shape)
        return t

    monkeypatch.setattr(tln, "_lib", lambda: lib)
    monkeypatch.setattr(tln, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tln.torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tln.layer_norm_bwd, "launches", 0)
    x, dy = torch.zeros(rows, n), torch.zeros(rows, n)
    want = tln._ln_bwd_design(x, dy)
    assert want == design
    assert tln.ln_bwd_blocks(x, torch.ones(n), dy) == (
        design, *lib._geometry(rows, n, 0, 0, design))
    tln.layer_norm_bwd(x, torch.ones(n, dtype=torch.bfloat16), dy)
    parts = lib._geometry(rows, n, 0, 1, design)[0]
    assert lib.seen[-1][0] == design
    assert made[lib.seen[-1][1]] == (parts, 2, n)
    tln.layer_norm_bwd(x, None, dy)  # no weight: no partials
    assert lib.seen[-1] == (design, None)
    assert tln.layer_norm_bwd.launches == 2


def _lane_sum(v):
    """Each lane's elements (v: (32, E)) added in its order, then the xor
    butterfly over offsets 16, 8, 4, 2, 1: every lane's total."""
    acc = np.zeros(32, np.float32)
    for j in range(v.shape[1]):
        acc = acc + v[:, j]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[lanes ^ o]
    return acc[0]


def _model_ln_bwd(x, w, dy, sms, blocks_per_sm=3, eps=1e-5):
    """The warp design's decomposition in numpy fp32: ``(dx, dgamma,
    dbeta)`` of (rows, n) ``x``.  Lane l holds columns (32 v + l) VW + e
    (VW: 16 bytes of x's dtype; n a whole number of them); blocks of 4
    warps, one per SM slot but at most one a 4 rows, each owning R =
    ceil(rows / blocks) consecutive rows, warp w of it rows w, w + 4,
    ...; per-warp partials added in warp order; the block partials added
    by 8 reduction warps over contiguous runs, then in warp order."""
    rows, n = x.shape
    x32, dy32 = x.astype(np.float32), dy.astype(np.float32)
    vw = 16 // x.dtype.itemsize
    assert n % vw == 0
    nv = -(-n // (32 * vw))
    cols = ((32 * np.arange(nv)[None, :, None] + np.arange(32)[:, None, None])
            * vw + np.arange(vw)[None, None, :]).reshape(32, nv * vw)
    valid = cols < n
    colc = np.where(valid, cols, 0)
    wv = np.where(valid, 1.0 if w is None else w.astype(np.float32)[colc],
                  0.0).astype(np.float32)
    p = min(sms * blocks_per_sm, -(-rows // 4))
    rpb = -(-rows // p)
    parts = -(-rows // rpb)
    dx = np.zeros((rows, n), np.float32)
    part = np.zeros((parts, 2, n), np.float32)
    for b in range(parts):
        r0, r1 = b * rpb, min(rows, (b + 1) * rpb)
        block = np.zeros((2, n), np.float32)
        for warp in range(4):
            pw = np.zeros((32, nv * vw), np.float32)
            pb = np.zeros_like(pw)
            for r in range(r0 + warp, r1, 4):
                xv = np.where(valid, x32[r][colc], 0.0).astype(np.float32)
                gv = np.where(valid, dy32[r][colc], 0.0).astype(np.float32)
                s, ss = _lane_sum(xv), _lane_sum(xv * xv)
                mean = s / np.float32(n)
                var = ss / np.float32(n) - mean * mean
                rstd = np.float32(1.0) / np.sqrt(var + np.float32(eps))
                xh = (xv - mean) * rstd
                dxh = gv * wv
                m1 = _lane_sum(dxh) * (np.float32(1.0) / np.float32(n))
                m2 = _lane_sum(dxh * xh) * (np.float32(1.0) / np.float32(n))
                out = rstd * (dxh - m1 - xh * m2)
                dx[r][colc[valid]] = out[valid]
                pw = pw + gv * xh
                pb = pb + gv
            for h, pp in ((0, pw), (1, pb)):
                add = np.zeros(n, np.float32)
                add[colc[valid]] = pp[valid]
                block[h] = add if warp == 0 else block[h] + add
        part[b] = block
    flat = part.reshape(parts, 2 * n)
    q = -(-parts // 8)
    total = np.zeros(2 * n, np.float32)
    for w8 in range(8):
        acc = np.zeros(2 * n, np.float32)
        for i in range(w8 * q, min(parts, (w8 + 1) * q)):
            acc = acc + flat[i]
        total = total + acc
    if w is None:
        return dx, None, None
    return dx, total[:n], total[n:]


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("x_dtype, w_dtype", [
    ("fp32", "fp32"), ("fp32", "bf16"), ("bf16", "bf16")])
@pytest.mark.parametrize("rows, n", [(300, 768), (257, 1024), (64, 96)])
def test_ln_bwd_warp_decomposition_matches_jax_vjp(rows, n, x_dtype,
                                                   w_dtype, sms):
    x_np_dt, _, x_tdt = DTYPES[x_dtype]
    w_np_dt, _, w_tdt = DTYPES[w_dtype]
    x, w, b, dy = _bwd_inputs((rows, n), seed=rows + n)
    xq, dyq = x.astype(x_np_dt), dy.astype(x_np_dt)
    wq, bq = w.astype(w_np_dt), b.astype(w_np_dt)
    assert tln._ln_bwd_design(_to_torch(xq, x_tdt),
                              _to_torch(dyq, x_tdt)) == tln.LN_BWD_WARP
    with force_pallas(n % 128 == 0):
        jdx, jdw, jdb = _jax_vjp(*(jnp.asarray(a) for a in (xq, wq, bq, dyq)))
    dx, dw, db = _model_ln_bwd(xq, wq, dyq, sms)
    # each result rounded to its dtype, as the kernel stores it
    dx = _to_torch(dx, torch.float32).to(x_tdt)
    dw = _to_torch(dw, torch.float32).to(w_tdt)
    db = _to_torch(db, torch.float32).to(w_tdt)
    for got, want in ((dx, jdx), (dw, jdw), (db, jdb)):
        g, wnt = _as_f32(got), _as_f32(want)
        tol = 1e-5 * np.max(np.abs(wnt))
        if got.dtype == torch.bfloat16:
            big = np.maximum(np.abs(g), np.abs(wnt))
            tol = tol + np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
        assert np.all(np.abs(g - wnt) <= tol), np.max(np.abs(g - wnt) - tol)


@pytest.mark.parametrize("rows, n", [(300, 768), (64, 96)])
def test_ln_bwd_warp_decomposition_without_affine(rows, n):
    x, _, _, dy = _bwd_inputs((rows, n), seed=rows * 2 + n)
    with force_pallas(n % 128 == 0):
        _, vjp = jax.vjp(lambda a: jax_layer_norm(a), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(dy))
    dx, dw, db = _model_ln_bwd(x, None, dy, sms=132)
    assert dw is None and db is None
    np.testing.assert_allclose(dx, _as_f32(jdx), rtol=0,
                               atol=1e-5 * np.max(np.abs(_as_f32(jdx))))
