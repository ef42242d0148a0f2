"""apex_tpu_torch's ``fused_novograd`` and ``fused_adagrad`` vs the JAX
package's, on the CPU.

Seven steps through each package's ``AmpOptimizer`` fused route (O2: the
scaled grads, the max-abs overflow check, the transform's own unscale and
gate) on the same numpy-seeded scaled grads, the fourth with a planted
NaN that both sides skip, for NovoGrad (the default decoupled mode, the
paper's ``reg_inside_moment`` mode with decay, ``norm_type`` inf with
bias correction, ``init_zero`` without grad averaging) and Adagrad (no
decay, L2 decay, decoupled decay): the masters' movement within 1e-3
relative L2 error of JAX's (SURVEY §6's optimizer bar), NovoGrad's
per-tensor norm EMAs within 1e-5 relative, Adagrad's sums within 1e-5
relative, the step counts and the scaler state (scale, clean steps,
overflows) exactly equal, and the skipped step leaving the masters and
the state bit for bit.  Also the constructors' refusals and the
class wrappers.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.optimizers import fused_adagrad as jax_adagrad
from apex_tpu.optimizers import fused_novograd as jax_novograd
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedNovoGrad,
                                       FusedNovoGradState, fused_adagrad,
                                       fused_novograd)

SHAPES = {"w": (16, 8), "b": (8,), "s": (3, 5, 7)}
CASES = {
    "novograd_default": ("novograd", dict(learning_rate=1e-2,
                                          betas=(0.95, 0.98),
                                          weight_decay=1e-3)),
    "novograd_reg_inside": ("novograd", dict(learning_rate=1e-2,
                                             weight_decay=1e-2,
                                             reg_inside_moment=True)),
    "novograd_inf_norm_bc": ("novograd", dict(learning_rate=1e-2,
                                              norm_type=math.inf,
                                              bias_correction=True)),
    "novograd_init_zero": ("novograd", dict(learning_rate=1e-2,
                                            init_zero=True,
                                            grad_averaging=False,
                                            bias_correction=True)),
    "adagrad_plain": ("adagrad", dict(learning_rate=1e-2)),
    "adagrad_l2": ("adagrad", dict(learning_rate=1e-2, weight_decay=1e-2)),
    "adagrad_w_mode": ("adagrad", dict(learning_rate=1e-2, weight_decay=1e-2,
                                       adagrad_w_mode=True)),
}
NAN_STEP = 3


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _txs(kind, kw):
    if kind == "novograd":
        return jax_novograd(**kw), fused_novograd(**kw)
    return jax_adagrad(**kw), fused_adagrad(**kw)


def _state_tree(kind, st):
    """The per-tensor state both sides keep: NovoGrad's norm EMAs,
    Adagrad's sums."""
    return st.v if kind == "novograd" else st.sum_sq


@pytest.mark.parametrize("case", sorted(CASES))
def test_seven_amp_fused_steps_match_jax(case):
    kind, kw = CASES[case]
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    jtx, ttx = _txs(kind, kw)
    jopt = jamp.AmpOptimizer(jtx, jamp.initialize("O2"))
    topt = amp.AmpOptimizer(ttx, amp.initialize("O2"))
    jp, js = dict(params), jopt.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = topt.init(tp)
    assert int(ts.opt_state.step) == 0
    for i in range(7):
        scale = float(ts.scaler[0].loss_scale)
        g = {k: (scale * rng.randn(*s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == NAN_STEP:
            g["s"][1, 2, 3] = np.nan
        jp, js, jstats = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp)
        before = {k: v.clone() for k, v in tp.items()}
        kept = {k: v.clone()
                for k, v in _state_tree(kind, ts.opt_state).items()}
        tp, ts, tstats = topt.step({k: _t(v) for k, v in g.items()}, ts, tp)
        assert bool(tstats.found_inf) == bool(jstats.found_inf) \
            == (i == NAN_STEP)
        if i == NAN_STEP:
            assert all(torch.equal(tp[k], before[k]) for k in tp)
            assert all(torch.equal(v, kept[k]) for k, v in
                       _state_tree(kind, ts.opt_state).items())
        assert int(ts.opt_state.step) == int(js.opt_state.step)
        sc, jsc = ts.scaler[0], js.scaler[0]
        assert (float(sc.loss_scale), int(sc.unskipped), int(sc.overflows)) \
            == (float(jsc.loss_scale), int(jsc.unskipped),
                int(jsc.overflows))
        for k, v in _state_tree(kind, ts.opt_state).items():
            want = np.asarray(_state_tree(kind, js.opt_state)[k])
            assert _rel_l2(v.numpy(), want) <= 1e-5, (i, k)
    assert int(ts.opt_state.step) == 6
    for k in tp:
        move = tp[k].numpy() - params[k]
        want = np.asarray(jp[k]) - params[k]
        assert _rel_l2(move, want) <= 1e-3, (k, _rel_l2(move, want))
        assert _rel_l2(0.5 * want, want) > 1e-3


def test_novograd_first_step_takes_the_norm_unless_init_zero():
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 3.0)}  # norm 6
    for init_zero, want in ((False, 6.0), (True, math.sqrt(1 - 0.999) * 6)):
        tx = fused_novograd(1e-3, init_zero=init_zero)
        _, st = tx.update(g, tx.init(p), p)
        assert math.isclose(float(st.v["w"]), want, rel_tol=1e-6)
        assert isinstance(st, FusedNovoGradState) and int(st.step) == 1


def test_constructors_reject_what_jax_rejects():
    with pytest.raises(ValueError, match="norm_type"):
        fused_novograd(norm_type=1)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedNovoGrad(amsgrad=True)


@pytest.mark.parametrize("cls", [FusedNovoGrad, FusedAdagrad])
def test_class_wrappers_step_params(cls):
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    opt = cls(lr=0.1)
    st = opt.init(params)
    grads = {k: torch.full_like(v, 0.5) for k, v in params.items()}
    new, st = opt.step(grads, st, params)
    assert int(st.step) == 1
    assert all(bool((new[k] < params[k]).all()) for k in params)
