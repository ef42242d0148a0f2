"""apex_tpu_torch's accumulate/stash path and unfused optimizer route vs
the JAX package, on the CPU.

On the same numpy inputs: ``multi_tensor_axpby`` (each ``check``),
``LossScaler.unscale_with_stashed``, ``AmpOptimizer.accumulate`` with and
without the scaler update, a ``step`` after a stash with each of
``fused_sgd``, ``fused_adam`` and ``fused_lamb``, the unfused route with
a plain SGD transform defined here against ``optax.sgd``,
``track_grad_norm`` on both routes and the multi-loss scalers.  Results
within 1e-6 at fp32, the scaler state exact.  A planted overflow leaves
the masters and every optimizer state bit for bit as they were, and the
scale backs off; with ``fused_lamb``, whose stage 1 updates m and v in
place, a gate applied after the update would keep the poisoned moments,
and the test would fail.
"""
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu import multi_tensor as jmt
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu_torch import amp, multi_tensor
from apex_tpu_torch.optimizers import fused_adam, fused_lamb, fused_sgd
from apex_tpu_torch.weights import from_jax_opt_state, from_jax_params

SHAPES = {"a": (7, 3), "b": (11,), "c": (4, 5)}
OPTIMIZERS = {
    "fused_sgd": (lambda: jax_fused_sgd(1e-2, momentum=0.9,
                                        weight_decay=1e-4),
                  lambda: fused_sgd(1e-2, momentum=0.9, weight_decay=1e-4)),
    "fused_adam": (lambda: jax_fused_adam(1e-2, weight_decay=0.1),
                   lambda: fused_adam(1e-2, weight_decay=0.1)),
    "fused_lamb": (lambda: jax_fused_lamb(1e-2, weight_decay=0.01),
                   lambda: fused_lamb(1e-2, weight_decay=0.01)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(rng, scale=1.0, dtype=np.float32):
    return {k: (scale * rng.randn(*s)).astype(dtype)
            for k, s in SHAPES.items()}


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _same_scaler(st, sj):
    assert float(st.loss_scale) == float(sj.loss_scale)
    assert int(st.unskipped) == int(sj.unskipped)
    assert int(st.overflows) == int(sj.overflows)


def _state_leaves(state) -> Dict[str, torch.Tensor]:
    """The optimizer state's tensors by field and name."""
    out = {"step": state.step}
    for field in state._fields[1:]:
        for k, v in getattr(state, field).items():
            out[f"{field}.{k}"] = v
    return out


@pytest.mark.parametrize("check", ["x", "y", "both"])
def test_axpby_matches_jax(check):
    rng = np.random.RandomState(0)
    x, y = _tree(rng), _tree(rng, 3.0)
    y["b"][4] = np.inf  # y alone is non-finite
    jx = {k: jnp.asarray(v).astype(jnp.bfloat16) if k == "a"
          else jnp.asarray(v) for k, v in x.items()}
    tx = {k: _t(np.asarray(v, np.float32)).to(torch.bfloat16) if k == "a"
          else _t(v) for k, v in jx.items()}
    want, jfound = jmt.multi_tensor_axpby(jx, y, 0.5, -2.0, check=check)
    got, found = multi_tensor.multi_tensor_axpby(
        tx, {k: _t(v) for k, v in y.items()}, 0.5, -2.0, check=check)
    assert bool(found) == bool(jfound) == (check != "x")
    for k in got:
        assert got[k].dtype == torch.float32  # promote(bf16, fp32)
        g, w = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        np.testing.assert_allclose(g[np.isfinite(g)], w[np.isfinite(w)],
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="check"):
        multi_tensor.multi_tensor_axpby(tx, tx, 1.0, 1.0, check="z")


def test_unscale_with_stashed_matches_jax():
    rng = np.random.RandomState(1)
    new, stash = _tree(rng, 2.0 ** 10), _tree(rng)
    js, ts = JaxLossScaler(), amp.LossScaler()
    sj, st = js.init(), ts.init("cpu")
    jnew = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in new.items()}
    tnew = {k: _t(np.asarray(v, np.float32)).to(torch.bfloat16)
            for k, v in jnew.items()}
    want, jfound = js.unscale_with_stashed(jnew, stash, sj)
    got, found = ts.unscale_with_stashed(
        tnew, {k: _t(v) for k, v in stash.items()}, st)
    assert bool(found) is bool(jfound) is False
    for k in got:
        assert got[k].dtype == torch.float32
        _close(got[k], want[k])
    tnew["c"][1, 1] = float("inf")
    assert bool(ts.unscale_with_stashed(tnew, got, st)[1])


def _pair(name, num_losses=1, **kw):
    jtx, ttx = OPTIMIZERS[name]
    return (jamp.AmpOptimizer(jtx(), jamp.initialize("O2",
                                                     num_losses=num_losses),
                              **kw),
            amp.AmpOptimizer(ttx(), amp.initialize("O2",
                                                   num_losses=num_losses),
                             **kw))


def _grads(rng, scale=2.0 ** 16):
    g = _tree(rng, 0.1 * scale)
    return ({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()},
            {k: _t(np.asarray(jnp.asarray(v).astype(jnp.bfloat16),
                              np.float32)).to(torch.bfloat16)
             for k, v in g.items()})


@pytest.mark.parametrize("update_scaler", [True, False])
def test_accumulate_matches_jax(update_scaler):
    jopt, opt = _pair("fused_adam")
    rng = np.random.RandomState(2)
    params = _tree(rng)
    js = jopt.init(params)
    ts = opt.init({k: _t(v) for k, v in params.items()})
    for i in range(3):
        jg, tg = _grads(rng)
        if i == 1:
            jg["b"] = jg["b"].at[0].set(jnp.inf)
            tg["b"][0] = float("inf")
        js = jopt.accumulate(jg, js, update_scaler=update_scaler)
        ts = opt.accumulate(tg, ts, update_scaler=update_scaler)
        _same_scaler(ts.scaler[0], js.scaler[0])
        for k in ts.stash:
            np.testing.assert_array_equal(np.isfinite(ts.stash[k].numpy()),
                                          np.isfinite(np.asarray(js.stash[k])))
    # with the update, the inf backs the scale off once when it arrives
    # and again when the next grads merge into the poisoned stash
    assert float(ts.scaler[0].loss_scale) == (2.0 ** 14 if update_scaler
                                              else 2.0 ** 16)
    # the stash without the inf: two clean accumulations
    jopt, opt = _pair("fused_adam")
    js = jopt.init(params)
    ts = opt.init({k: _t(v) for k, v in params.items()})
    for _ in range(2):
        jg, tg = _grads(rng)
        js = jopt.accumulate(jg, js, update_scaler=update_scaler)
        ts = opt.accumulate(tg, ts, update_scaler=update_scaler)
    for k in ts.stash:
        _close(ts.stash[k], js.stash[k])
    _same_scaler(ts.scaler[0], js.scaler[0])


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("overflow", [False, True])
def test_step_after_a_stash_matches_jax(name, overflow):
    """Two microbatches: ``accumulate(update_scaler=False)``, then
    ``step`` adds the second and takes the unfused route.  Four rounds,
    from a state with moments; with ``overflow`` the third round's second
    microbatch holds an inf, and that step must leave the masters and
    the optimizer state bit for bit as they were."""
    jopt, opt = _pair(name)
    rng = np.random.RandomState(3)
    params = _tree(rng)
    jp, js = dict(params), jopt.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = opt.init(tp)
    for r in range(4):
        jg1, tg1 = _grads(rng)
        jg2, tg2 = _grads(rng)
        plant = overflow and r == 2
        if plant:
            jg2["a"] = jg2["a"].at[1, 1].set(jnp.inf)
            tg2["a"][1, 1] = float("inf")
            before = {k: v.clone() for k, v in tp.items()}
            state_before = {k: v.clone()
                            for k, v in _state_leaves(ts.opt_state).items()}
        js = jopt.accumulate(jg1, js, update_scaler=False)
        ts = opt.accumulate(tg1, ts, update_scaler=False)
        jp, js, jstats = jopt.step(jg2, js, jp)
        tp, ts, stats = opt.step(tg2, ts, tp)
        assert ts.stash is None and js.stash is None
        assert bool(stats.found_inf) == bool(jstats.found_inf) == plant
        _same_scaler(ts.scaler[0], js.scaler[0])
        assert int(ts.opt_state.step) == int(js.opt_state.step)
        if plant:
            assert all(torch.equal(tp[k], before[k]) for k in tp)
            after = _state_leaves(ts.opt_state)
            assert all(torch.equal(after[k], v)
                       for k, v in state_before.items()), name
            assert float(ts.scaler[0].loss_scale) == 2.0 ** 15
        for k in tp:
            _close(tp[k], jp[k])
    jleaves = {"step": js.opt_state.step}
    for field in js.opt_state._fields[1:]:
        for k, v in getattr(js.opt_state, field).items():
            jleaves[f"{field}.{k}"] = v
    for k, v in _state_leaves(ts.opt_state).items():
        _close(v, jleaves[k])


def test_unfused_lamb_overflow_leaves_m_and_v_unchanged():
    """``fused_lamb`` on the unfused route (a stash) with the inf in the
    stashed microbatch: stage 1 writes m and v in place, so only a gate
    inside the transform keeps them; a gate applied after it would
    compare a tensor with itself."""
    _, opt = _pair("fused_lamb")
    rng = np.random.RandomState(4)
    tp = {k: _t(v) for k, v in _tree(rng).items()}
    ts = opt.init(tp)
    _, g = _grads(rng)
    tp, ts, _ = opt.step(g, ts, tp)  # moments away from zero
    m = {k: v.clone() for k, v in ts.opt_state.m.items()}
    v = {k: x.clone() for k, x in ts.opt_state.v.items()}
    p = {k: x.clone() for k, x in tp.items()}
    _, g1 = _grads(rng)
    g1["c"][0, 0] = float("nan")
    ts = opt.accumulate(g1, ts, update_scaler=False)
    _, g2 = _grads(rng)
    tp, ts, stats = opt.step(g2, ts, tp)
    assert bool(stats.found_inf)
    assert all(torch.equal(ts.opt_state.m[k], m[k]) for k in m)
    assert all(torch.equal(ts.opt_state.v[k], v[k]) for k in v)
    assert all(torch.equal(tp[k], p[k]) for k in p)
    assert int(ts.opt_state.step) == 1


class _SGDState(NamedTuple):
    trace: Dict[str, torch.Tensor]


def _plain_sgd(lr: float, momentum: float):
    """optax.sgd(lr, momentum): ``trace = g + momentum * trace``, ``u =
    -lr * trace``; new tensors each step (not AMP-fused)."""
    def init(params):
        return _SGDState({k: torch.zeros_like(p) for k, p in params.items()})

    def update(grads, state, params):
        trace = {k: grads[k] + momentum * state.trace[k] for k in grads}
        return {k: -lr * t for k, t in trace.items()}, _SGDState(trace)
    return optax.GradientTransformation(init, update)


def test_unfused_route_with_a_plain_transform_matches_optax():
    amp_j, amp_t = jamp.initialize("O2"), amp.initialize("O2")
    jopt = jamp.AmpOptimizer(optax.sgd(1e-2, momentum=0.9), amp_j,
                             track_grad_norm=True)
    opt = amp.AmpOptimizer(_plain_sgd(1e-2, 0.9), amp_t,
                           track_grad_norm=True)
    rng = np.random.RandomState(5)
    params = _tree(rng)
    jp, js = dict(params), jopt.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = opt.init(tp)
    for i in range(4):
        jg, tg = _grads(rng)
        if i == 2:
            jg["b"] = jg["b"].at[3].set(jnp.inf)
            tg["b"][3] = float("inf")
            before = {k: v.clone() for k, v in tp.items()}
            trace = {k: v.clone() for k, v in ts.opt_state.trace.items()}
        jp, js, jstats = jopt.step(jg, js, jp)
        tp, ts, stats = opt.step(tg, ts, tp)
        assert bool(stats.found_inf) == bool(jstats.found_inf) == (i == 2)
        _same_scaler(ts.scaler[0], js.scaler[0])
        if i == 2:
            assert all(torch.equal(tp[k], before[k]) for k in tp)
            assert all(torch.equal(ts.opt_state.trace[k], trace[k])
                       for k in trace)
        else:
            np.testing.assert_allclose(float(stats.grad_norm),
                                       float(jstats.grad_norm), rtol=1e-6)
        for k in tp:
            _close(tp[k], jp[k])
        jtrace = js.opt_state[0].trace
        for k in tp:
            _close(ts.opt_state.trace[k], jtrace[k])


@pytest.mark.parametrize("stash", [False, True])
def test_track_grad_norm_matches_jax(stash):
    """The fused route reports the scaled grads' norm times 1/scale, the
    unfused one the master grads' norm (the stash included)."""
    jopt, opt = _pair("fused_adam", track_grad_norm=True)
    _, plain = _pair("fused_adam")
    rng = np.random.RandomState(6)
    params = _tree(rng)
    js = jopt.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = opt.init(tp)
    if stash:
        jg, tg = _grads(rng)
        js = jopt.accumulate(jg, js, update_scaler=False)
        ts = opt.accumulate(tg, ts, update_scaler=False)
    jg, tg = _grads(rng)
    _, _, jstats = jopt.step(jg, js, params)
    _, _, stats = opt.step(tg, ts, tp)
    assert stats.grad_norm.dtype == torch.float32
    np.testing.assert_allclose(float(stats.grad_norm),
                               float(jstats.grad_norm), rtol=1e-6)
    _, _, off = plain.step(tg, plain.init(tp), tp)
    assert off.grad_norm is None


def test_multi_loss_scalers_match_jax():
    """Two losses, one optimizer (the DCGAN discriminator's pattern): the
    first loss accumulates and updates its own scaler, the second steps
    with its own; an overflow in the first loss backs off only its
    scale and skips the step."""
    jopt, opt = _pair("fused_sgd", num_losses=2)
    rng = np.random.RandomState(7)
    params = _tree(rng)
    jp, js = dict(params), jopt.init(params)
    tp = {k: _t(v) for k, v in params.items()}
    ts = opt.init(tp)
    for r in range(3):
        jg0, tg0 = _grads(rng)
        jg1, tg1 = _grads(rng)
        if r == 1:
            jg0["c"] = jg0["c"].at[2, 2].set(-jnp.inf)
            tg0["c"][2, 2] = float("-inf")
        js = jopt.accumulate(jg0, js, loss_id=0)
        ts = opt.accumulate(tg0, ts, loss_id=0)
        jp, js, jstats = jopt.step(jg1, js, jp, loss_id=1)
        tp, ts, stats = opt.step(tg1, ts, tp, loss_id=1)
        assert bool(stats.found_inf) == bool(jstats.found_inf) == (r == 1)
        for st, sj in zip(ts.scaler, js.scaler):
            _same_scaler(st, sj)
        for k in tp:
            _close(tp[k], jp[k])
    assert [float(s.loss_scale) for s in ts.scaler] == [2.0 ** 15,
                                                       2.0 ** 15]
    assert [int(s.overflows) for s in ts.scaler] == [1, 1]


def test_master_params_returns_the_masters():
    assert amp.master_params({"a": 1}) == {"a": 1}

    class TrainState(NamedTuple):
        params: dict

    assert amp.master_params(TrainState({"a": 2})) == {"a": 2}


def test_a_jax_stash_converts_and_steps_as_jax():
    """``from_jax_opt_state`` maps a JAX state mid-accumulation (a GPT
    tiny stash) by parameter name; the port's step from it equals
    JAX's."""
    init = jax.jit(JaxGPTLM(JaxConfig.tiny(compute_dtype=jnp.float32)).init)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))[
        "params"]
    jopt, opt = _pair("fused_adam")
    rng = np.random.RandomState(8)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(0.01 * 2.0 ** 16 * rng.randn(*p.shape),
                              jnp.bfloat16), params) for _ in range(2)]
    js = jopt.accumulate(grads[0], jopt.init(params), update_scaler=False)
    state = from_jax_opt_state(js, device="cpu")
    want_stash = from_jax_params(jax.tree_util.tree_map(np.asarray, js.stash))
    assert set(state.stash) == set(want_stash)
    assert all(torch.equal(state.stash[k], want_stash[k]) for k in want_stash)
    jp, js, _ = jopt.step(grads[1], js, params)
    masters = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    g = {k: v.to(torch.bfloat16) for k, v in from_jax_params(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                               grads[1])).items()}
    masters, state, stats = opt.step(g, state, masters)
    assert state.stash is None and not bool(stats.found_inf)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    for k in masters:
        _close(masters[k], want[k])
