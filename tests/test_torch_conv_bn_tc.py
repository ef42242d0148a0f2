"""The Hopper designs of apex_tpu_torch's conv+BN matmuls
(``ops/conv_bn.py`` over ``csrc/conv_bn.cu``), on the CPU.

The wgmma kernels run only on an H100; here the tests hold what the CPU
can hold:

- the design rule (``_conv_bn_design``): bf16 matrices TMA can read go
  to the wgmma kernels (64-wide column tiles for N <= 64, w kept in
  shared memory or streamed, ``bn_relu_matmul`` on the same kernels
  with its BN prologue; the one-pass dual where K cuts into at most
  four of the slices built for N, the tiled dual elsewhere), and every
  wgmma kernel is named by the rule at some shape that
  ``chip_smoke.py`` checks on the card; fp32, mixed dtypes, rows that
  are not whole 16-byte multiples (the (999, 70, 197) case) and
  unaligned bases stay on the mma.sync/FMA kernels, with and without
  the BN prologue;
- the scratch the wrapper allocates for each design, through a stand-in
  library that reports its own partial counts (the buffer is sized by
  what the library says, for the design the rule picked; the tiled dual
  gets its per-stream ticket pair, the others none; the BN parameters
  reach the library as 16-byte aligned fp32 vectors);
- a plain model of the new decompositions, against JAX's
  ``matmul_stats`` (interpret-mode Pallas at multiples of 128, its jnp
  branch at ragged sizes) and ``matmul_bwd_dual`` (interpret-mode
  Pallas): y rounded to its dtype and its column sums taken per
  persistent block over that block's row tiles in their order (128 rows
  a tile, column tiles of 64 for N <= 64 else 128, ``groups`` blocks a
  column tile), the block partials then added in block order; dx = dy
  w^T rounded; dw as the one-pass design takes it (per-block partials
  over 64-row tiles b, b + P, ..., P = SMs / slices of K, added in block
  order) and as the
  tiled design takes it (per-chunk partials, chunk rows a multiple of
  64, added in chunk order), at 2 and 132 SMs, bf16 and fp32.
  Tolerances: outputs within 1e-5 of the |x|.|w| term sums (fp32 sums
  in two orders) plus 1 bf16 ulp for a bf16 output; dw within 1e-5 of
  |x|^T.|dy|; the stats within the column sums of the two sides' output
  differences plus 1e-5 of sum|y| (and of sum y^2);
- a plain model of ``bn_relu_matmul``'s wgmma kernel: the operand
  normalised per element as the kernel does it (scale = rstd * gamma
  first, each operation rounded once, ReLU, bf16), laid into 128-row x
  64-k tiles whose padded rows and k are zeroed after the prologue, y
  rounded, the stats taken per persistent block over its row tiles and
  added in block order, at 2 and 132 SMs, against JAX's
  ``bn_relu_matmul`` (interpret-mode Pallas at multiples of 128, which
  rounds the operand as the kernel does: 1e-5 of |a|.|w| plus 1 bf16
  ulp; its jnp branch elsewhere, which does not: plus 2^-8 of |a|.|w|);
  the padding left unmasked (the kernel's planted fault 3) must break
  the stats where M leaves padded rows and change nothing where it
  does not.
"""
import contextlib
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.ops import conv_bn as jcb
from apex_tpu_torch.ops import conv_bn as tcb

DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _mat(rows, cols, dtype=BF):
    return torch.zeros(rows, cols, dtype=dtype)


# -- the design rule ---------------------------------------------------------

@pytest.mark.parametrize("k, n, want", [
    (256, 64, tcb.STATS_RESIDENT_N64), (64, 256, tcb.STATS_RESIDENT),
    (512, 128, tcb.STATS_RESIDENT), (128, 512, tcb.STATS_RESIDENT),
    (1024, 256, tcb.STATS_STREAMED), (256, 1024, tcb.STATS_RESIDENT),
    (2048, 512, tcb.STATS_STREAMED), (512, 2048, tcb.STATS_RESIDENT),
    (1024, 64, tcb.STATS_RESIDENT_N64), (1088, 64, tcb.STATS_STREAMED_N64),
    (72, 200, tcb.STATS_RESIDENT), (70, 197, tcb.PRESENT)])
def test_stats_design_rule(k, n, want):
    assert tcb._conv_bn_design("stats", _mat(8, k), _mat(k, n)) == want


@pytest.mark.parametrize("k, n, want", [
    (256, 64, tcb.DUAL_FUSED), (64, 256, tcb.DUAL_FUSED),
    (128, 128, tcb.DUAL_FUSED), (128, 64, tcb.DUAL_TILES),
    (64, 128, tcb.DUAL_TILES), (64, 64, tcb.DUAL_TILES),
    (512, 128, tcb.DUAL_FUSED), (1024, 64, tcb.DUAL_FUSED),
    (2048, 64, tcb.DUAL_TILES), (1024, 256, tcb.DUAL_TILES),
    (128, 512, tcb.DUAL_TILES), (192, 128, tcb.DUAL_TILES),
    (2048, 512, tcb.DUAL_TILES), (72, 200, tcb.DUAL_TILES),
    (70, 197, tcb.PRESENT)])
def test_dual_design_rule(k, n, want):
    x, w, dy = _mat(8, k), _mat(k, n), _mat(8, n)
    assert tcb._conv_bn_design("dual", x, w, dy) == want


# the bf16 shapes chip_smoke.py's conv_bn phase holds on the card: RN50's
# eight 1x1 convolutions and its ragged cases
_CHECKED_ON_CARD = ((256, 64), (64, 256), (512, 128), (128, 512),
                    (1024, 256), (256, 1024), (2048, 512), (512, 2048),
                    (72, 200), (1088, 64))


@pytest.mark.parametrize("name", tcb.TC_KERNELS)
def test_every_wgmma_kernel_is_reached_at_a_checked_shape(name):
    reached = set()
    for k, n in _CHECKED_ON_CARD:
        x, w, dy = _mat(8, k), _mat(k, n), _mat(8, n)
        code = tcb._conv_bn_design("stats", x, w)
        reached.add(tcb.tc_kernel("stats", code, n))
        reached.add(tcb.tc_kernel("bn", code, n))
        reached.add(tcb.tc_kernel("dual",
                                  tcb._conv_bn_design("dual", x, w, dy), n))
    assert name in reached


def test_tc_kernel_names_each_design():
    for kind in ("stats", "bn", "dual"):
        assert tcb.tc_kernel(kind, tcb.PRESENT, 64) is None
    names = {tcb.tc_kernel(kind, d, 512) for d in tcb.STATS_DESIGNS
             for kind in ("stats", "bn") if d != tcb.PRESENT}
    names |= {tcb.tc_kernel("dual", tcb.DUAL_FUSED, n)
              for n in tcb._FUSED_SLICE}
    names.add(tcb.tc_kernel("dual", tcb.DUAL_TILES, 512))
    assert names == set(tcb.TC_KERNELS)
    assert tcb.tc_kernel("bn", tcb.STATS_RESIDENT_N64, 64) == \
        "stats_tc<64, w resident, bn>"


def test_present_design_keeps_fp32_mixed_bn_and_unaligned(stand_in):
    """The rule, and what ``bn_relu_matmul`` hands the library: the
    wgmma code for bf16 TMA-readable x and w (as ``matmul_stats``),
    PRESENT for fp32, mixed and unaligned inputs, BN or not."""
    f32 = torch.float32
    x, w, dy = _mat(8, 256), _mat(256, 64), _mat(8, 64)
    bn = [torch.zeros(256) for _ in range(4)]
    # a base 2 bytes past a 16-byte boundary: TMA cannot read it
    buf = torch.zeros(8 * 256 + 8, dtype=BF)
    off = next(i for i in range(8) if (buf.data_ptr() + 2 * i) % 16 == 2)
    shifted = buf[off:off + 8 * 256].view(8, 256)
    assert shifted.data_ptr() % 16 == 2
    for args, want in (((x, w), tcb.STATS_RESIDENT_N64),
                       ((_mat(8, 256, f32), _mat(256, 64, f32)), tcb.PRESENT),
                       ((x, _mat(256, 64, f32)), tcb.PRESENT),
                       ((_mat(8, 256, f32), w), tcb.PRESENT),
                       ((shifted, w), tcb.PRESENT)):
        assert tcb._conv_bn_design("stats", *args) == want
        tcb.bn_relu_matmul(args[0], *bn, args[1])
        assert stand_in.seen[-1][1] == want
    assert tcb._conv_bn_design("dual", _mat(8, 256, f32), _mat(256, 64, f32),
                               _mat(8, 64, f32)) == tcb.PRESENT
    assert tcb._conv_bn_design("dual", x, w, _mat(8, 64, f32)) == tcb.PRESENT
    assert tcb._conv_bn_design("dual", shifted, w, dy) == tcb.PRESENT
    with pytest.raises(ValueError, match="unknown kind"):
        tcb._conv_bn_design("bwd", x, w)


# -- the scratch the wrapper allocates, through a stand-in library ----------

class _StandInLib:
    """Records what the wrapper hands the kernels; its partial counts are
    its own (7 stats partials, 5 dual partials for the wgmma designs), so
    the test sees the wrapper size its buffers by what the library says."""

    STATS_PARTS, DUAL_PARTS = 7, 5

    def __init__(self):
        self.seen = []

    def apex_conv_bn_rows_per_block(self):
        return 128

    def apex_conv_bn_step(self):
        return 32

    def apex_conv_bn_stats_parts(self, m, k, n, design):
        return -(-m // 128) if design == tcb.PRESENT else self.STATS_PARTS

    def apex_conv_bn_dual_parts(self, m, k, n, chunk_rows, design):
        if design == tcb.PRESENT:
            return -(-m // chunk_rows)
        return self.DUAL_PARTS

    def apex_conv_bn_fwd(self, *args):
        part = args[8]
        self.seen.append(("fwd", args[-3], args[-2],
                          None if part is None else self._numel(part)))
        self.bn_ptrs = args[2:6]
        return 0

    def apex_matmul_bwd_dual(self, *args):
        self.seen.append(("dual", args[11], args[13], self._numel(args[4]),
                          args[12] is not None))
        return 0

    def _numel(self, ptr):
        return self.sizes[ptr]


@pytest.fixture
def stand_in(monkeypatch):
    lib = _StandInLib()
    made = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = t.numel()
        return t

    lib.sizes = made
    monkeypatch.setattr(tcb, "_lib", lambda: lib)
    monkeypatch.setattr(tcb, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tcb.torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    for fn in (tcb.matmul_stats, tcb.bn_relu_matmul, tcb.matmul_bwd_dual):
        monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(tcb, "_sched_by_stream", {})
    return lib


@pytest.mark.parametrize("m, k, n, design", [
    (1000, 256, 64, tcb.STATS_RESIDENT_N64),
    (1000, 2048, 256, tcb.STATS_STREAMED),
    (1000, 72, 200, tcb.STATS_RESIDENT), (999, 70, 197, tcb.PRESENT)])
def test_stats_scratch_is_sized_by_design(stand_in, m, k, n, design):
    x, w = torch.zeros(m, k, dtype=BF), torch.zeros(k, n, dtype=BF)
    tcb.matmul_stats(x, w, _fault=2 if design != tcb.PRESENT else 0)
    parts = (stand_in.STATS_PARTS if design != tcb.PRESENT
             else -(-m // 128))
    fault = 2 if design != tcb.PRESENT else 0
    assert stand_in.seen == [("fwd", design, fault, parts * 2 * n)]
    tcb.matmul_stats(x, w, with_stats=False)
    assert stand_in.seen[-1] == ("fwd", design, 0, None)
    assert tcb.matmul_stats.launches == 2


@pytest.mark.parametrize("m, k, n, design", [
    (1000, 256, 64, tcb.STATS_RESIDENT_N64),
    (1000, 2048, 256, tcb.STATS_STREAMED),
    (1000, 72, 200, tcb.STATS_RESIDENT), (999, 70, 197, tcb.PRESENT)])
def test_bn_relu_matmul_keeps_the_present_design(stand_in, m, k, n, design):
    """``bn_relu_matmul`` keeps PRESENT only where ``matmul_stats`` does;
    elsewhere it takes the same wgmma code, its partials are sized by
    what the library says for that code, the planted faults (3 included)
    reach the library, and the BN parameters go as 16-byte aligned fp32
    vectors, copied only where a view starts off alignment."""
    x, w = torch.zeros(m, k, dtype=BF), torch.zeros(k, n, dtype=BF)
    # bf16 parameters, and an fp32 view 4 bytes past alignment
    store = torch.zeros(k + 4)
    off = next(i for i in range(4) if (store.data_ptr() + 4 * i) % 16 == 4)
    bn = [torch.zeros(k, dtype=BF), store[off:off + k], torch.ones(k),
          torch.zeros(k)]
    fault = 3 if design != tcb.PRESENT else 0
    tcb.bn_relu_matmul(x, *bn, w, _fault=fault)
    parts = (stand_in.STATS_PARTS if design != tcb.PRESENT
             else -(-m // 128))
    assert stand_in.seen == [("fwd", design, fault, parts * 2 * n)]
    assert all(p % 16 == 0 for p in stand_in.bn_ptrs)
    assert stand_in.bn_ptrs[2] == bn[2].data_ptr()  # aligned fp32: as is
    tcb.bn_relu_matmul(x, *bn, w, with_stats=False)
    assert stand_in.seen[-1] == ("fwd", design, 0, None)
    assert tcb.bn_relu_matmul.launches == 2


@pytest.mark.parametrize("m, k, n, design", [
    (1000, 256, 64, tcb.DUAL_FUSED), (1000, 512, 256, tcb.DUAL_TILES),
    (1000, 72, 200, tcb.DUAL_TILES), (999, 70, 197, tcb.PRESENT)])
def test_dual_scratch_is_sized_by_design(stand_in, m, k, n, design):
    x, dy = torch.zeros(m, k, dtype=BF), torch.zeros(m, n, dtype=BF)
    w = torch.zeros(k, n, dtype=BF)
    dx, dw = tcb.matmul_bwd_dual(x, dy, w)
    assert dx.shape == (m, k) and dw.shape == (k, n)
    if design == tcb.PRESENT:
        rows = tcb._dual_chunk_rows(m, k, n, 32, 128)
        parts = -(-m // rows)
    else:
        parts = stand_in.DUAL_PARTS
    assert stand_in.seen == [("dual", design, 0, parts * k * n,
                              design == tcb.DUAL_TILES)]
    # the ticket pair is made once per stream and reused
    tcb.matmul_bwd_dual(x, dy, w)
    assert len(tcb._sched_by_stream) == (design == tcb.DUAL_TILES)
    assert tcb.matmul_bwd_dual.launches == 2


# -- a plain model of the decompositions, against JAX -----------------------

def _cdiv(a, b):
    return -(-a // b)


def _np_inputs(m, k, n, dtype, seed):
    rng = np.random.RandomState(seed)
    np_dt = DTYPES[dtype][0]
    x = (0.5 * rng.randn(m, k)).astype(np_dt)
    w = (0.5 * rng.randn(k, n)).astype(np_dt)
    dy = (0.5 * rng.randn(m, n)).astype(np_dt)
    return x, w, dy


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(BF)
    return torch.from_numpy(a.copy())


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(a).astype(np.float64)


def _ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _assert_out(got, want, absw, bf16):
    g, w = _f64(got), _f64(want)
    tol = 1e-5 * absw
    if bf16:
        tol = tol + _ulp(np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g - w) <= tol), np.max(np.abs(g - w) - tol)


def _model_stats(x, w, sms):
    """The wgmma stats kernel's decomposition in plain torch: y stored
    rounded, then its stats as :func:`_block_stats` takes them."""
    y = (x.float() @ w.float()).to(x.dtype)
    return (y, *_block_stats(y, sms))


def _block_stats(y, sms):
    """Block (g, column tile j) sums its 128-row tiles g, g + groups, ...
    of the stored y in order in fp32; the partials added in g order."""
    m, n = y.shape
    bn = 64 if n <= 64 else 128
    nt, mt = _cdiv(n, bn), _cdiv(m, 128)
    groups = min(max(1, sms // nt), mt)
    yv = y.float()
    s = torch.zeros(n)
    ss = torch.zeros(n)
    for j in range(nt):
        cols = slice(j * bn, min(n, (j + 1) * bn))
        part_s, part_ss = [], []
        for g in range(groups):
            ps = torch.zeros(cols.stop - cols.start)
            pss = torch.zeros_like(ps)
            for tile in range(g, mt, groups):
                rows = yv[tile * 128:(tile + 1) * 128, cols]
                ps = ps + rows.sum(0)
                pss = pss + (rows * rows).sum(0)
            part_s.append(ps)
            part_ss.append(pss)
        acc_s = torch.zeros_like(part_s[0])
        acc_ss = torch.zeros_like(part_s[0])
        for ps, pss in zip(part_s, part_ss):
            acc_s = acc_s + ps
            acc_ss = acc_ss + pss
        s[cols], ss[cols] = acc_s, acc_ss
    return s, ss


def _model_dual(x, dy, w, sms, design):
    """The wgmma dual's decomposition in plain torch: dx = dy w^T rounded;
    dw from per-block (one pass: 64-row tiles b, b + P, ...) or per-chunk
    (tiled: chunks of a multiple of 64 rows, at least SMs / (2 * dw
    tiles) of them) fp32 partials, added in order."""
    m, k = x.shape
    n = w.shape[1]
    dx = (dy.float() @ w.float().T).to(x.dtype)
    xf, dyf = x.float(), dy.float()
    # (the one-pass design's K slices each hold their columns of the same
    # per-block partials: the sums do not depend on the slicing)
    if design == tcb.DUAL_FUSED:
        mt = _cdiv(m, 64)
        slices = k // tcb._fused_slice(k, n)
        p = min(mt, max(1, sms // slices))
        parts = []
        for b in range(p):
            acc = torch.zeros(k, n)
            for tile in range(b, mt, p):
                r = slice(tile * 64, (tile + 1) * 64)
                acc = acc + xf[r].T @ dyf[r]
            parts.append(acc)
    else:
        tiles = _cdiv(k, 128) * _cdiv(n, 128)
        c = min(max(1, _cdiv(sms, 2 * tiles)), _cdiv(m, 64))
        rows = _cdiv(_cdiv(m, c), 64) * 64
        parts = [xf[r0:r0 + rows].T @ dyf[r0:r0 + rows]
                 for r0 in range(0, m, rows)]
    dw = torch.zeros(k, n)
    for part in parts:
        dw = dw + part
    return dx, dw


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m, k, n", [(512, 256, 128), (384, 128, 64),
                                     (1000, 72, 200), (300, 64, 40)])
def test_stats_decomposition_matches_jax(m, k, n, dtype, sms):
    x, w, _ = _np_inputs(m, k, n, dtype, seed=m + k + n)
    pallas = m % 128 == 0 and k % 128 == 0 and n % 128 == 0
    want = jcb.matmul_stats(jnp.asarray(x), jnp.asarray(w),
                            use_pallas=pallas)
    y, s, ss = _model_stats(_t(x), _t(w), sms)
    absw = np.abs(_f64(x)) @ np.abs(_f64(w))
    _assert_out(y, want[0], absw, dtype == "bfloat16")
    yg, yw = _f64(y), _f64(want[0])
    d = np.abs(yg - yw)
    tol_s = d.sum(0) + 1e-5 * np.abs(yg).sum(0)
    tol_ss = (d * (np.abs(yg) + np.abs(yw))).sum(0) + 1e-5 * (yg * yg).sum(0)
    assert np.all(np.abs(_f64(s) - _f64(want[1])) <= tol_s + 1e-30)
    assert np.all(np.abs(_f64(ss) - _f64(want[2])) <= tol_ss + 1e-30)
    # the model's stats are those of the values it stores
    assert np.allclose(_f64(s), yg.sum(0), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m, k, n, design", [
    (512, 256, 64, tcb.DUAL_FUSED), (320, 64, 256, tcb.DUAL_FUSED),
    (448, 512, 128, tcb.DUAL_FUSED),
    (512, 256, 128, tcb.DUAL_FUSED), (1000, 72, 200, tcb.DUAL_TILES),
    (640, 256, 384, tcb.DUAL_TILES)])
def test_dual_decomposition_matches_jax(m, k, n, design, dtype, sms):
    x, w, dy = _np_inputs(m, k, n, dtype, seed=m * 3 + k + n)
    if dtype == "bfloat16":  # fp32 runs the FMA kernel on the card
        assert tcb._conv_bn_design("dual", _t(x), _t(w), _t(dy)) == design
    jdx, jdw = jcb.matmul_bwd_dual(jnp.asarray(x), jnp.asarray(dy),
                                   jnp.asarray(w))
    dx, dw = _model_dual(_t(x), _t(dy), _t(w), sms, design)
    ax, ady, aw = (np.abs(_f64(v)) for v in (x, dy, w))
    _assert_out(dx, jdx, ady @ aw.T, dtype == "bfloat16")
    _assert_out(dw, jdw, ax.T @ ady, False)


# -- a plain model of bn_relu_matmul's wgmma kernel, against JAX ------------

def _np_bn(k, seed):
    rng = np.random.RandomState(seed)
    return ((0.1 * rng.randn(k)).astype(np.float32),
            (1.0 + rng.rand(k)).astype(np.float32),
            (1.0 + 0.1 * rng.randn(k)).astype(np.float32),
            (0.1 * rng.randn(k)).astype(np.float32))


def _model_bn(x, bn, w, sms, relu=True, unmasked=False):
    """The BN wgmma kernel's decomposition in plain torch: x laid into
    128-row x 64-k tiles (TMA's zeros past M and K); each 16-byte chunk
    (8 k) normalised as the kernel does it, scale = rstd * gamma first
    and each fp32 operation rounded once, ReLU, bf16; then the padded
    rows and k set to 0, or, ``unmasked`` (planted fault 3), left as the
    prologue made them, with the parameters of k past K read at K - 8..
    K - 1; w's rows past K are TMA's zeros.  y rounded, the stats per
    persistent block as ``_block_stats`` takes them, over the padded
    rows too (the stored y is cut to M)."""
    m, k = x.shape
    n = w.shape[1]
    mp, kp = _cdiv(m, 128) * 128, _cdiv(k, 64) * 64
    xt = torch.zeros(mp, kp)
    xt[:m, :k] = x.float()
    # the parameter index each k reads: its own, or (past K) the same
    # place in the last chunk
    idx = torch.arange(kp)
    idx = torch.where(idx < k, idx, k - 8 + idx % 8)
    mean, rstd, gamma, beta = (p.float()[idx] for p in bn)
    scale = rstd * gamma
    a = (xt - mean) * scale + beta
    if relu:
        a = a.clamp_min(0.0)
    a = a.to(BF).float()
    if not unmasked:
        a[m:] = 0.0
        a[:, k:] = 0.0
    wt = torch.zeros(kp, n)
    wt[:k] = w.float()
    y_pad = (a @ wt).to(BF)
    return (y_pad[:m], *_block_stats(y_pad, sms))


def _bn_jax(x, bn, w, relu=True):
    m, k = x.shape
    n = w.shape[1]
    pallas = m % 128 == 0 and k % 128 == 0 and n % 128 == 0
    args = [jnp.asarray(v) for v in (x, *bn, w)]
    return jcb.bn_relu_matmul(*args, relu=relu, use_pallas=pallas), pallas


def _bn_absw(x, bn, w, relu=True):
    mean, rstd, gamma, beta = (np.asarray(p, np.float64) for p in bn)
    a = (_f64(x) - mean) * (rstd * gamma) + beta
    if relu:
        a = np.maximum(a, 0.0)
    return np.abs(a) @ np.abs(_f64(w))


def _stats_within(s, ss, y, want):
    """The stats within the column sums of the two outputs' differences
    plus 1e-5 of sum|y| (sum y^2)."""
    yg, yw = _f64(y), _f64(want[0])
    d = np.abs(yg - yw)
    tol_s = d.sum(0) + 1e-5 * np.abs(yg).sum(0)
    tol_ss = (d * (np.abs(yg) + np.abs(yw))).sum(0) + 1e-5 * (yg * yg).sum(0)
    return bool(np.all(np.abs(_f64(s) - _f64(want[1])) <= tol_s + 1e-30)
                and np.all(np.abs(_f64(ss) - _f64(want[2]))
                           <= tol_ss + 1e-30))


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m, k, n", [(512, 256, 128), (1000, 72, 200),
                                     (384, 128, 64)])
def test_bn_decomposition_matches_jax(m, k, n, relu, sms):
    x, w, _ = _np_inputs(m, k, n, "bfloat16", seed=m + 2 * k + n)
    bn = _np_bn(k, seed=k + n)
    code = tcb._conv_bn_design("stats", _t(x), _t(w))
    assert tcb.tc_kernel("bn", code, n).endswith(", bn>")
    want, pallas = _bn_jax(x, bn, w, relu)
    y, s, ss = _model_bn(_t(x), [_t(p) for p in bn], _t(w), sms, relu)
    absw = _bn_absw(x, bn, w, relu)
    # JAX's kernel rounds the operand to bf16 as this one does; its jnp
    # branch does not (one bf16 rounding of each term: 2^-8 of |a|.|w|)
    g, want_y = _f64(y), _f64(want[0])
    tol = 1e-5 * absw + _ulp(np.maximum(np.abs(g), np.abs(want_y)))
    if not pallas:
        tol = tol + 2.0 ** -8 * absw
    assert np.all(np.abs(g - want_y) <= tol), np.max(np.abs(g - want_y) - tol)
    assert _stats_within(s, ss, y, want)
    # the stats are those of the values stored
    assert np.allclose(_f64(s), g.sum(0), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("m, k, n", [(1000, 72, 200), (512, 256, 128)])
def test_bn_unmasked_padding_breaks_the_stats(m, k, n, sms):
    """Fault 3 of the kernel: where M leaves padded rows (1000 = 7 x 128 +
    104) their normalised zeros reach the stats, which the check rejects;
    where it does not, the fault changes no bit (and padded k meet w's
    zero rows either way)."""
    x, w, _ = _np_inputs(m, k, n, "bfloat16", seed=m + 2 * k + n)
    bn = _np_bn(k, seed=k + n)
    want, _ = _bn_jax(x, bn, w)
    args = (_t(x), [_t(p) for p in bn], _t(w), sms)
    good = _model_bn(*args)
    bad = _model_bn(*args, unmasked=True)
    assert torch.equal(bad[0], good[0])  # the stored y is cut to M
    if m % 128:
        assert not _stats_within(bad[1], bad[2], bad[0], want)
    else:
        assert all(torch.equal(b, g) for b, g in zip(bad, good))
