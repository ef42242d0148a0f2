"""apex_tpu_torch's ``fused_sgd`` vs the JAX package's, on the CPU.

Seven steps with the AMP-fused ``inv_scale``/``found_inf`` extras on
scaled grads, one of them with a planted NaN (the step that both sides
must skip: buffer held, no update, step count held), for plain SGD,
momentum, momentum with dampening, nesterov and ``wd_after_momentum``:
the parameters within 1e-3 relative L2 error of JAX's over their whole
movement (SURVEY §6's optimizer bar) and, tighter, within 1e-5 (the two
run the same fp32 arithmetic; half a step's movement is far outside it);
the momentum buffers within 1e-5 relative; the step counts equal.  Also:
the first step sets the buffer to d_p with no dampening; the first step
skipped keeps the next one first; a bf16 parameter gets a bf16 update
from fp32 arithmetic; ``FusedSGD``, ``AmpOptimizer`` and
``from_jax_opt_state`` take the state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedSGD, FusedSGDState, fused_sgd
from apex_tpu_torch.weights import from_jax_opt_state

SHAPES = {"w": (16, 8), "b": (8,), "s": (3, 5, 7)}
MODES = {
    "plain": dict(),
    "momentum": dict(momentum=0.9, weight_decay=1e-4),
    "dampening": dict(momentum=0.9, dampening=0.3, weight_decay=1e-2),
    "nesterov": dict(momentum=0.9, nesterov=True, weight_decay=1e-2),
    "wd_after": dict(momentum=0.8, weight_decay=1e-2,
                     wd_after_momentum=True),
}
LR = 0.1
INV = 2.0 ** -10


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64)
                                - np.asarray(want, np.float64))
                 / np.linalg.norm(np.asarray(want, np.float64)))


def _params(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_seven_fused_sgd_steps_match_jax(mode):
    kw = MODES[mode]
    params = _params(0)
    jtx, ttx = jax_fused_sgd(LR, **kw), fused_sgd(LR, **kw)
    jp, js = dict(params), jtx.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = ttx.init(tp)
    rng = np.random.RandomState(1)
    for i in range(7):
        g = {k: (2.0 ** 10 * rng.randn(*s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == 3:
            g["s"][1, 2, 3] = np.nan
        found = i == 3
        ju, js = jtx.update(g, js, jp, inv_scale=jnp.float32(INV),
                            found_inf=jnp.asarray(found))
        jp = {k: jp[k] + ju[k] for k in jp}
        before = {k: x.clone() for k, x in tp.items()}
        buf_before = {k: x.clone() for k, x in ts.momentum_buf.items()}
        tu, ts = ttx.update({k: _t(x) for k, x in g.items()}, ts, tp,
                            inv_scale=torch.tensor(INV),
                            found_inf=torch.tensor(found))
        tp = {k: tp[k] + tu[k] for k in tp}
        assert int(ts.step) == int(js.step) == (i if i >= 3 else i + 1)
        if found:
            assert all(torch.equal(tp[k], before[k]) for k in tp)
            assert all(torch.equal(ts.momentum_buf[k], buf_before[k])
                       for k in tp)
        for k in tp:
            want = np.asarray(js.momentum_buf[k])
            if np.any(want):
                assert _rel_l2(ts.momentum_buf[k].numpy(), want) <= 1e-5
            else:
                assert not ts.momentum_buf[k].any()
    for k in tp:
        move, want = tp[k].numpy() - params[k], np.asarray(jp[k]) - params[k]
        assert _rel_l2(move, want) <= 1e-3
        assert _rel_l2(move, want) <= 1e-5, (k, _rel_l2(move, want))
        assert _rel_l2(0.5 * want, want) > 1e-5


@pytest.mark.parametrize("dampening", [0.0, 0.5])
def test_first_step_sets_the_buffer_to_d_p(dampening):
    p = {"w": torch.ones(4)}
    g = {"w": torch.full((4,), 2.0)}
    tx = fused_sgd(0.5, momentum=0.9, dampening=dampening)
    st = tx.init(p)
    # a skipped first step leaves the buffer at zero and the step at 0
    u, st = tx.update(g, st, p, found_inf=torch.tensor(True))
    assert int(st.step) == 0 and not st.momentum_buf["w"].any()
    assert not u["w"].any()
    u, st = tx.update(g, st, p, found_inf=torch.tensor(False))
    assert torch.equal(st.momentum_buf["w"], g["w"])  # no dampening
    assert torch.equal(u["w"], -0.5 * g["w"])
    u, st = tx.update(g, st, p)
    want = 0.9 * 2.0 + (1.0 - dampening) * 2.0
    assert torch.allclose(st.momentum_buf["w"], torch.full((4,), want))
    assert int(st.step) == 2


def test_bf16_param_gets_a_bf16_update_of_fp32_arithmetic():
    p = {"w": torch.tensor([1.0, -2.0, 3.0]).to(torch.bfloat16)}
    g = {"w": torch.tensor([0.3, 0.7, -1.1]).to(torch.bfloat16)}
    tx = fused_sgd(0.1, momentum=0.9, weight_decay=1e-2)
    u, st = tx.update(g, tx.init(p), p)
    assert u["w"].dtype == torch.bfloat16
    assert st.momentum_buf["w"].dtype == torch.float32
    d = g["w"].float() + 1e-2 * p["w"].float()
    assert torch.equal(u["w"], (-0.1 * d).to(torch.bfloat16))


def test_nesterov_needs_momentum_without_dampening():
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(0.1, nesterov=True)
    with pytest.raises(ValueError, match="Nesterov"):
        fused_sgd(0.1, momentum=0.9, dampening=0.1, nesterov=True)


def test_fused_sgd_class_and_amp_optimizer_take_it():
    params = {k: _t(v) for k, v in _params(2).items()}
    opt = FusedSGD(lr=0.1, momentum=0.9)
    st = opt.init(params)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new, st = opt.step(grads, st, params)
    assert isinstance(st, FusedSGDState) and int(st.step) == 1
    assert all(torch.allclose(new[k], params[k] - 0.1) for k in params)
    aopt = amp.AmpOptimizer(fused_sgd(0.1, momentum=0.9),
                            amp.initialize("O2"))
    state = aopt.init(params)
    assert isinstance(state.opt_state, FusedSGDState)


def test_from_jax_opt_state_maps_fused_sgd_state():
    """A JAX ResNet-shaped AmpOptState(FusedSGDState) after two steps."""
    tree = {"conv1": {"kernel": np.ones((7, 7, 3, 8), np.float32)},
            "bn1": {"scale": np.ones(8, np.float32),
                    "bias": np.zeros(8, np.float32)},
            "fc": {"kernel": np.ones((8, 10), np.float32),
                   "bias": np.zeros(10, np.float32)}}
    jopt = jamp.AmpOptimizer(jax_fused_sgd(0.1, momentum=0.9),
                             jamp.initialize("O2"))
    st = jopt.init(tree)
    grads = {k: {n: np.full(v.shape, 0.5, np.float32) for n, v in d.items()}
             for k, d in tree.items()}
    for _ in range(2):
        tree, st, _ = jopt.step(grads, st, tree)
    got = from_jax_opt_state(st, device="cpu")
    assert isinstance(got.opt_state, FusedSGDState)
    assert int(got.opt_state.step) == int(st.opt_state.step) == 2
    buf = got.opt_state.momentum_buf
    assert set(buf) == {"conv1.kernel", "bn1.scale", "bn1.bias",
                        "fc.kernel", "fc.bias"}
    np.testing.assert_array_equal(
        buf["fc.kernel"].numpy(),
        np.asarray(st.opt_state.momentum_buf["fc"]["kernel"]))
    assert float(got.scaler[0].loss_scale) == float(st.scaler[0].loss_scale)
