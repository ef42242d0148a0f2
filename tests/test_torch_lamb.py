"""apex_tpu_torch's LAMB (stage-1 kernel's plain version and
``fused_lamb``) vs the JAX package, on the CPU.

- ``lamb_stage1_ref`` (what ``lamb_stage1`` runs on CPU tensors) against
  the JAX ``lamb_stage1`` Pallas kernel in interpret mode, with a ragged
  final row chunk, skip on and off, AdamW and L2 mode: m and v within two
  fp32 roundings of their terms' magnitudes (``b1*m + (1-b1)*g``
  cancels, and XLA may fuse it into an FMA), the sums within rtol 1e-6
  (fp32 sums in two orders); sizes the TPU kernel does not take (a
  1000-element leaf) against a float64 numpy reference;
- seven ``fused_lamb`` steps with the AMP-fused unscale and a planted
  NaN step, against JAX's ``fused_lamb`` with ``use_pallas`` False and
  True: each param's movement within 1e-5 relative L2 error of JAX's (a
  step at half the learning rate is 0.5 off), m, v and the step count;
- the global-norm overflow window: grads whose scaled squares overflow
  fp32 still clip and update as JAX does (inv_scale applied before
  squaring);
- ``from_jax_opt_state`` for a ``FusedLAMBState``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.ops import fused_optim as jfo
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import amp
from apex_tpu_torch.ops import fused_optim as tfo
from apex_tpu_torch.optimizers import FusedLAMB, FusedLAMBState, fused_lamb
from apex_tpu_torch.weights import from_jax_opt_state

HYPER = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01)


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _assert_rounding(got, want, *terms):
    """|got - want| within two fp32 roundings of sum(|term|), elementwise
    (the terms of the moment update, before it cancels)."""
    mag = sum(np.abs(np.asarray(t, np.float64)) for t in terms)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= 2.0 ** -22 * mag), np.max(err / np.maximum(mag,
                                                                      1e-30))


def _moment_terms(g, p, m, v, gs, adam_w):
    g = np.asarray(g, np.float64) * gs
    if not adam_w:
        g = g + HYPER["wd"] * p
    return ((HYPER["b1"] * m, (1 - HYPER["b1"]) * g),
            (HYPER["b2"] * v, (1 - HYPER["b2"]) * g * g))


def _leaf(rng, n, g_dtype):
    g = (50.0 * rng.randn(n)).astype(g_dtype)
    p = rng.randn(n).astype(np.float32)
    m = (0.1 * rng.randn(n)).astype(np.float32)
    v = (0.01 * np.abs(rng.randn(n))).astype(np.float32)
    return g, p, m, v


@pytest.mark.parametrize("g_dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("adam_w", [True, False])
def test_lamb_stage1_ref_matches_jax_kernel(g_dtype, skip, adam_w):
    rng = np.random.RandomState(0)
    n = 1024 * 5  # 40 rows of 128: a ragged last chunk at block_rows 16
    g, p, m, v = _leaf(rng, n, g_dtype)
    gs, bc1, bc2 = 0.25, 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    jm, jv, jps, jus = jfo.lamb_stage1(
        jnp.asarray(g), *(jnp.asarray(a) for a in (p, m, v)),
        jnp.float32(gs), jnp.float32(bc1), jnp.float32(bc2), adam_w=adam_w,
        skip=jnp.asarray(skip), block_rows=16, **HYPER)
    tg = torch.from_numpy(np.asarray(g, np.float32))
    if g_dtype != np.float32:
        tg = tg.to(torch.bfloat16)
    tm, tv = _t(m), _t(v)
    scal = torch.tensor([gs, bc1, bc2, float(skip)], dtype=torch.float32)
    om, ov, ps, us = tfo.lamb_stage1(tg, _t(p), tm, tv, scal, adam_w=adam_w,
                                     **HYPER)
    assert om is tm and ov is tv  # updated in place
    mt, vt = _moment_terms(g, p, m, v, gs, adam_w)
    _assert_rounding(om.numpy(), jm, *mt)
    _assert_rounding(ov.numpy(), jv, *vt)
    if skip:
        np.testing.assert_array_equal(om.numpy(), m)
        np.testing.assert_array_equal(ov.numpy(), v)
    np.testing.assert_allclose(float(ps), float(jps), rtol=1e-6)
    np.testing.assert_allclose(float(us), float(jus), rtol=1e-6)


@pytest.mark.parametrize("n", [1000, 1, 131])
def test_lamb_stage1_any_size_matches_float64(n):
    """Sizes the TPU kernel's tiling refuses, against float64 numpy."""
    rng = np.random.RandomState(n)
    g, p, m, v = _leaf(rng, n, np.float32)
    gs, bc1, bc2 = 0.5, 0.1, 0.002
    scal = torch.tensor([gs, bc1, bc2, 0.0])
    om, ov, ps, us = tfo.lamb_stage1(_t(g), _t(p), _t(m), _t(v), scal,
                                     adam_w=True, **HYPER)
    g64, p64 = g.astype(np.float64) * gs, p.astype(np.float64)
    m64 = 0.9 * m + 0.1 * g64
    v64 = 0.999 * v + 0.001 * g64 * g64
    u64 = (m64 / bc1) / (np.sqrt(v64 / bc2) + 1e-6) + 0.01 * p64
    mt, vt = _moment_terms(g, p, m, v, gs, True)
    _assert_rounding(om.numpy(), m64, *mt)
    _assert_rounding(ov.numpy(), v64, *vt)
    np.testing.assert_allclose(float(ps), np.sum(p64 * p64), rtol=1e-5)
    np.testing.assert_allclose(float(us), np.sum(u64 * u64), rtol=1e-5)


SHAPES = {"w": (256, 256), "x": (7, 3), "b": (11,)}  # w takes JAX's kernel


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["adamw", "l2", "nvlamb_no_wd"])
def test_seven_fused_lamb_steps_match_jax(use_pallas, mode):
    kw = {"adamw": dict(weight_decay=0.01),
          "l2": dict(weight_decay=0.01, adam_w_mode=False),
          "nvlamb_no_wd": dict(weight_decay=0.0, use_nvlamb=True)}[mode]
    lr = 1e-2
    params = _params(1)
    jtx = jax_fused_lamb(lr, use_pallas=use_pallas, **kw)
    ttx = fused_lamb(lr, **kw)
    jp, js = dict(params), jtx.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = ttx.init(tp)
    rng = np.random.RandomState(2)
    inv = 2.0 ** -10
    for i in range(7):
        g = {k: (2.0 ** 10 * rng.randn(*s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == 4:
            g["b"][2] = np.nan
        found = not all(np.isfinite(x).all() for x in g.values())
        ju, js = jtx.update(g, js, jp, inv_scale=jnp.float32(inv),
                            found_inf=jnp.asarray(found))
        jp = {k: jp[k] + ju[k] for k in jp}
        before = {k: x.clone() for k, x in tp.items()}
        tu, ts = ttx.update({k: _t(x) for k, x in g.items()}, ts, tp,
                            inv_scale=torch.tensor(inv),
                            found_inf=torch.tensor(found))
        tp = {k: tp[k] + tu[k] for k in tp}
        assert int(ts.step) == int(js.step) == (i if i >= 4 else i + 1)
        if found:
            assert all(torch.equal(tp[k], before[k]) for k in tp)
        for k in tp:
            np.testing.assert_allclose(ts.m[k].numpy(), np.asarray(js.m[k]),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                       rtol=1e-5, atol=1e-9)
    for k in tp:
        move, want = tp[k].numpy() - params[k], np.asarray(jp[k]) - params[k]
        assert _rel_l2(move, want) <= 1e-5, (k, _rel_l2(move, want))
        # the rule separates: half the learning rate is 0.5 off
        assert _rel_l2(0.5 * want, want) > 1e-5


def test_global_norm_scales_before_squaring():
    """Scaled grads of ~1e20 square past fp32's range; unscaled first (as
    the reference folds inv_scale into the squaring) the norm is finite,
    the clip applies and the update matches JAX."""
    params = _params(3)
    scale = 2.0 ** 70
    rng = np.random.RandomState(4)
    g = {k: (scale * 0.1 * rng.randn(*s)).astype(np.float32)
         for k, s in SHAPES.items()}
    assert all(np.isfinite(x).all() for x in g.values())
    with np.errstate(over="ignore"):
        assert not np.isfinite(np.sum(np.square(g["w"])))
    jtx, ttx = jax_fused_lamb(1e-2), fused_lamb(1e-2)
    ju, _ = jtx.update(g, jtx.init(params), params,
                       inv_scale=jnp.float32(1.0 / scale),
                       found_inf=jnp.asarray(False))
    tp = {k: _t(v) for k, v in params.items()}
    tu, ts = ttx.update({k: _t(x) for k, x in g.items()}, ttx.init(tp), tp,
                        inv_scale=torch.tensor(1.0 / scale),
                        found_inf=torch.tensor(False))
    assert int(ts.step) == 1
    for k in tp:
        assert torch.isfinite(tu[k]).all()
        assert _rel_l2(tu[k].numpy(), ju[k]) <= 1e-5


def test_fused_lamb_class_and_amp_optimizer_take_it():
    params = {k: _t(v) for k, v in _params(5).items()}
    opt = FusedLAMB(lr=1e-2)
    state = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new, state = opt.step(grads, state, params)
    assert int(state.step) == 1 and isinstance(state, FusedLAMBState)
    assert all(not torch.equal(new[k], params[k]) for k in params)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedLAMB(amsgrad=True)
    amp.AmpOptimizer(fused_lamb(1e-3), amp.initialize("O2"))
    with pytest.raises(TypeError, match="init.*update"):
        amp.AmpOptimizer(object(), amp.initialize("O2"))


def test_from_jax_opt_state_maps_fused_lamb_state():
    from apex_tpu.models.bert import BertConfig as JaxBertConfig
    from apex_tpu.models.bert import BertForMLM as JaxBertForMLM

    ids = jnp.zeros((1, 16), jnp.int32)
    params = JaxBertForMLM(JaxBertConfig.tiny(compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), ids)["params"]
    jopt = jamp.AmpOptimizer(jax_fused_lamb(1e-3), jamp.initialize("O2"))
    state = jopt.init(params)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, state, _ = jax.jit(jopt.step)(grads, state, params)
    got = from_jax_opt_state(state, device="cpu")
    assert isinstance(got.opt_state, FusedLAMBState)
    assert int(got.opt_state.step) == int(state.opt_state.step) == 1
    name = "encoder.layers.1.self_attn.in_proj_weight"
    want = np.asarray(state.opt_state.m["encoder"]["layer_1"]["self_attn"]
                      ["in_proj_weight"])
    np.testing.assert_array_equal(got.opt_state.m[name].numpy(), want)
    assert set(got.opt_state.v) == set(got.opt_state.m)
    assert float(got.scaler[0].loss_scale) == float(state.scaler[0].loss_scale)


def test_lamb_stage1_kernel_wrapper_checks_its_inputs(monkeypatch):
    """With the dispatch rule forced to the kernel, inputs it does not take
    raise before any launch."""
    monkeypatch.setattr(tfo, "use_kernel", lambda *t: True)
    x = torch.zeros(64)
    scal = torch.zeros(4)
    with pytest.raises(ValueError, match="fp32"):
        tfo.lamb_stage1(x.half(), x, x, x, scal, adam_w=True, **HYPER)
    with pytest.raises(ValueError, match="one non-empty size"):
        tfo.lamb_stage1(x[:3], x, x, x, scal, adam_w=True, **HYPER)
    with pytest.raises(ValueError, match="contiguous"):
        y = torch.zeros(8, 8).t()
        tfo.lamb_stage1(y, y, y, y, scal, adam_w=True, **HYPER)
