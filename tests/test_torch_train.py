"""apex_tpu_torch's training slice vs the JAX package, on the CPU.

A ``GPTConfig.tiny`` model (2 layers, hidden 128, S = 128, so the JAX
flash shape gate passes) with the same flax-initialised weights
(``from_jax_params``) and the same numpy-seeded tokens, at
``deterministic=True`` (flax's dropout bits cannot be reproduced; the
attention-dropout hash is held bit for bit in
``test_torch_flash_attention.py``).  Tolerances:

- O0 (fp32): the loss within rtol 1e-4 and every gradient within 1e-4 of
  its tensor's largest magnitude, against the JAX CPU default (jnp
  references) and its Pallas kernels in interpret mode;
- O2 (bf16 model, fp32 masters): the loss within 2e-2 and every gradient
  within 2e-2 relative L2 error (both sides round activations to bf16 at
  the same places, but their fp32 sums straddle bf16 rounding boundaries
  differently);
- three O2 steps of ``AmpOptimizer(fused_adam)`` from the same masters and
  optimizer state (``from_jax_opt_state``) on the same scaled bf16 grads,
  one of them with a planted inf that both sides skip: the masters'
  movement over the two applied steps within 1e-5 relative L2 error of
  JAX's, the loss-scaler state and Adam's step count exactly equal;
- the scaler trajectory, ``fused_adam`` and the multi-tensor reductions
  on their own: exact, or within fp32 rounding;
- a ``FusedTrainDriver`` window of K steps equals K single steps exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu import multi_tensor as jmt
from apex_tpu.amp.scaler import LossScaler as JaxLossScaler
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.ops._common import force_pallas
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import amp, multi_tensor
from apex_tpu_torch.models import GPTConfig, GPTLM
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train import FusedTrainDriver, read_metrics
from apex_tpu_torch.weights import from_jax_opt_state, from_jax_params

B, S = 2, 128
LR, WD = 6e-4, 0.1
PLANT = "ln_f.weight"  # the leaf that gets the planted inf


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, size=(B, S))
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], axis=1)
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids[:1, :16]))["params"]
    return ids, labels, jax.tree_util.tree_map(np.asarray, params)


def _jax_loss_fn(ids, labels, compute_dtype, cast=None):
    model = JaxGPTLM(JaxConfig.tiny(compute_dtype=compute_dtype))

    def loss(p):
        p = cast(p) if cast is not None else p
        return model.apply({"params": p}, jnp.asarray(ids),
                           labels=jnp.asarray(labels), deterministic=True)[1]
    return loss


def _model(params, compute_dtype):
    m = GPTLM(GPTConfig.tiny(compute_dtype=compute_dtype))
    m.load_state_dict(from_jax_params(params))
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_l2(got, want):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("force", [None, True])
def test_o0_loss_and_grads_match_jax(data, force):
    ids, labels, params = data
    with force_pallas(force):
        jl, jg = jax.value_and_grad(_jax_loss_fn(ids, labels, jnp.float32))(
            params)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jg))
    model = _model(params, torch.float32)
    logits, loss = model(_t(ids), _t(labels))
    assert logits.dtype == torch.float32 and logits.shape == (B, S, 1024)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def test_o2_loss_and_grads_match_jax(data):
    ids, labels, params = data
    jopt = jamp.AmpOptimizer(jax_fused_adam(LR, weight_decay=WD),
                             jamp.initialize("O2"))
    jl, jg = jax.value_and_grad(_jax_loss_fn(
        ids, labels, jnp.bfloat16, jopt.model_params))(params)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jg))
    opt = amp.AmpOptimizer(fused_adam(LR, weight_decay=WD),
                           amp.initialize("O2"))
    model = _model(params, torch.bfloat16)
    masters = opt.attach(model)
    assert all(m.dtype == torch.float32 for m in masters.values())
    # every GPT float parameter is cast, LayerNorm's included
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    logits, loss = model(_t(ids), _t(labels))
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    assert abs(float(loss.detach()) - float(jl)) <= 2e-2
    for name, g in zip(names, grads):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, want[name]) <= 2e-2, name


def _plant_jax(grads):
    g = dict(grads)
    g["ln_f"] = dict(g["ln_f"], scale=g["ln_f"]["scale"].at[3].set(jnp.inf))
    return g


def test_three_o2_steps_match_jax_with_a_skipped_step(data):
    ids, labels, params = data
    jamp_ = jamp.initialize("O2")
    jopt = jamp.AmpOptimizer(jax_fused_adam(LR, weight_decay=WD), jamp_)
    # not jitted: under jit XLA sums wte's two bf16 grads (lookup and
    # tied head) in fp32, and the grads would no longer be bf16 values
    jgrad = jax.grad(lambda mp, s: jamp_.scale_loss(
        _jax_loss_fn(ids, labels, jnp.bfloat16, jopt.model_params)(mp), s))
    jstep = jax.jit(jopt.step)
    masters_j, state_j = params, jopt.init(params)
    # one warm step, so the state handed across has nonzero moments
    masters_j, state_j, _ = jstep(jgrad(masters_j, state_j.scaler[0]),
                                  state_j, masters_j)

    opt = amp.AmpOptimizer(fused_adam(LR, weight_decay=WD),
                           amp.initialize("O2"))
    start = from_jax_params(jax.tree_util.tree_map(np.asarray, masters_j))
    model = _model(jax.tree_util.tree_map(np.asarray, masters_j),
                   torch.bfloat16)
    masters = opt.attach(model)
    assert all(torch.equal(masters[k], start[k]) for k in start)
    state = from_jax_opt_state(state_j, device="cpu")
    assert int(state.opt_state.step) == 1
    for i in range(3):
        g = jgrad(masters_j, state_j.scaler[0])
        if i == 1:
            g = _plant_jax(g)
            before = {k: v.clone() for k, v in masters.items()}
            m_before = {k: v.clone() for k, v in state.opt_state.m.items()}
        # both sides take the same scaled grads: JAX's grads of the bf16
        # cast are bf16 values, so the port's bf16 model grads hold them
        # exactly (the grads themselves are held in the O2 test above)
        g32 = from_jax_params(jax.tree_util.tree_map(np.asarray, g))
        grads = {k: v.to(torch.bfloat16) for k, v in g32.items()}
        assert all(torch.equal(grads[k].float(), g32[k]) for k in g32)
        masters_j, state_j, stats_j = jstep(g, state_j, masters_j)
        masters, state, stats = opt.step(grads, state, masters, model=model)
        assert bool(stats.found_inf) == bool(stats_j.found_inf) == (i == 1)
        if i == 1:
            assert all(torch.equal(masters[k], before[k]) for k in masters)
            assert all(torch.equal(state.opt_state.m[k], m_before[k])
                       for k in m_before)
        sj, st = state_j.scaler[0], state.scaler[0]
        assert float(st.loss_scale) == float(sj.loss_scale)
        assert int(st.unskipped) == int(sj.unskipped)
        assert int(st.overflows) == int(sj.overflows)
        assert int(state.opt_state.step) == int(state_j.opt_state.step)
    assert float(state.scaler[0].loss_scale) == 2.0 ** 15
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, masters_j))
    errs = {}
    for k, v in masters.items():
        # the two applied steps moved each weight by about 2 * LR: hold
        # that movement, not the weights, against JAX's
        errs[k] = _rel_l2(v - start[k], want[k] - start[k])
        # the model holds the masters rounded to bf16
        assert torch.equal(dict(model.named_parameters())[k],
                           v.to(torch.bfloat16))
    assert max(errs.values()) <= 1e-5, errs


def _train_setup(params):
    opt = amp.AmpOptimizer(fused_adam(6e-4, weight_decay=WD),
                           amp.initialize("O2"))
    model = _model(params, torch.bfloat16)
    masters = opt.attach(model)
    return opt, model, masters, opt.init(masters)


def test_driver_window_equals_single_steps(data):
    ids, labels, params = data
    k = 3

    def make_step(opt, model):
        names, ps = zip(*model.named_parameters())

        def step(carry, batch):
            masters, state = carry
            _, loss = model(batch[0], batch[1])
            grads = torch.autograd.grad(
                opt.amp.scale_loss(loss, state.scaler[0]), ps)
            masters, state, stats = opt.step(dict(zip(names, grads)), state,
                                             masters, model=model)
            return (masters, state), {"loss": loss.detach(),
                                      "scale": stats.loss_scale}
        return step

    batches = (_t(ids)[None].repeat(k, 1, 1), _t(labels)[None].repeat(k, 1, 1))
    opt, model, masters, state = _train_setup(params)
    step = make_step(opt, model)
    losses = []
    carry = (masters, state)
    for i in range(k):
        carry, m = step(carry, (batches[0][i], batches[1][i]))
        losses.append(float(m["loss"]))
    single = carry

    opt, model, masters, state = _train_setup(params)
    driver = FusedTrainDriver(make_step(opt, model), steps_per_dispatch=k,
                              metrics={"loss": "mean", "scale": "last"},
                              per_step=("loss",))
    carry, res = driver.run_window((masters, state), batches)
    host = read_metrics(res)
    assert host.per_step["loss"] == losses
    assert host.metrics["loss"] == float(torch.tensor(losses).sum() / k)
    assert host.metrics["scale"] == 2.0 ** 16
    for name in single[0]:
        assert torch.equal(carry[0][name], single[0][name])
    assert losses[-1] < losses[0]
    # run() over windows counts the steps and calls back once per window
    seen = []
    carry, done = driver.run(carry, [batches, batches],
                             on_window=lambda n, r: seen.append(n))
    assert (done, seen) == (2 * k, [k, 2 * k])


def test_scaler_trajectory_matches_jax_exactly():
    flags = [False, False, True, False, False, False, True, True, False]
    for kw in ({}, {"min_loss_scale": 2.0 ** 15}, {"max_loss_scale": 2.0 ** 17}):
        js = JaxLossScaler(scale_window=2, **kw)
        ts = amp.LossScaler(scale_window=2, **kw)
        sj, st = js.init(), ts.init("cpu")
        for f in flags:
            sj = js.update(sj, jnp.asarray(f))
            st = ts.update(st, torch.tensor(f))
            assert ts.state_dict(st) == js.state_dict(sj)
    static = amp.LossScaler(loss_scale=128.0)
    st = static.update(static.init("cpu"), torch.tensor(True))
    assert static.state_dict(st) == {"loss_scale": 128.0, "unskipped": 0,
                                     "overflows": 1}


def test_fused_adam_matches_jax_with_amp_gating():
    rng = np.random.RandomState(5)
    shapes = {"a": (7, 3), "b": (11,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jtx = jax_fused_adam(1e-2, weight_decay=0.1)
    ttx = fused_adam(1e-2, weight_decay=0.1)
    jp, js = dict(params), jtx.init(params)
    tp = {k: _t(v).clone() for k, v in params.items()}
    ts = ttx.init(tp)
    for i in range(7):
        g = {k: (100.0 * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        if i == 4:
            g["b"][2] = np.nan
        found = not all(np.isfinite(v).all() for v in g.values())
        ju, js = jtx.update(g, js, jp, inv_scale=jnp.float32(0.01),
                            found_inf=jnp.asarray(found))
        jp = {k: jp[k] + ju[k] for k in jp}
        tu, ts = ttx.update({k: _t(v) for k, v in g.items()}, ts, tp,
                            inv_scale=torch.tensor(0.01),
                            found_inf=torch.tensor(found))
        tp = {k: tp[k] + tu[k] for k in tp}
        assert int(ts.step) == int(js.step)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)


def test_multi_tensor_matches_jax():
    rng = np.random.RandomState(6)
    tree = {"x": rng.randn(5, 4).astype(np.float32),
            "y": (3 * rng.randn(9)).astype(np.float32)}
    ttree = {k: _t(v) for k, v in tree.items()}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    for kw in ({}, {"max_norm": True}):
        got = multi_tensor.multi_tensor_l2norm(ttree, **kw)
        want = jmt.multi_tensor_l2norm(jtree, **kw)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    total, per = multi_tensor.multi_tensor_l2norm(ttree, per_tensor=True)
    _, jper = jmt.multi_tensor_l2norm(jtree, per_tensor=True)
    for k in per:
        np.testing.assert_allclose(float(per[k]), float(jper[k]), rtol=1e-6)
    out, found = multi_tensor.multi_tensor_unscale(ttree, 0.5)
    jout, jfound = jmt.multi_tensor_unscale(jtree, 0.5)
    assert bool(found) == bool(jfound) is False
    for k in out:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
    bad = dict(ttree, y=ttree["y"].clone())
    bad["y"][0] = float("nan")
    assert not bool(multi_tensor.tree_finite(bad))
    scaled, found = multi_tensor.multi_tensor_scale(
        [ttree["x"].to(torch.bfloat16)], 2.0 ** 130)
    assert bool(found) and scaled[0].dtype == torch.bfloat16


def test_policies_match_jax_presets():
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
          None: None}
    for level in ("O0", "O1", "O2", "O3"):
        jp, tp = jamp.make_policy(level), amp.make_policy(level)
        assert dt[jp.cast_model_dtype] == tp.cast_model_dtype
        assert (jp.keep_batchnorm_fp32, jp.loss_scale, jp.autocast) == (
            tp.keep_batchnorm_fp32, tp.loss_scale, tp.autocast)
        assert dt[jp.compute_dtype] == tp.compute_dtype
    # O1: the cast tables' policy, bf16 products over fp32 parameters
    o1 = amp.initialize("O1").policy
    assert (o1.autocast, o1.compute_dtype, o1.loss_scale) == (
        True, torch.bfloat16, "dynamic")
    with pytest.raises(ValueError, match="letter O"):
        amp.make_policy("O4")
    with pytest.raises(ValueError, match="keep_batchnorm_fp32"):
        amp.make_policy("O0", keep_batchnorm_fp32=True)
    with pytest.raises(ValueError, match="loss_scale"):
        amp.make_policy("O2", loss_scale="static")
    assert amp.default_is_batchnorm(("layer1", "bn1", "scale"))
    assert not amp.default_is_batchnorm(("layers", "0", "ln1", "weight"))


def test_training_entry_points_need_a_device_or_a_generator(data):
    _, _, params = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amp.LossScaler().init()
    model = _model(params, torch.float32)
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="Generator"):
        model(ids, ids, deterministic=False)
    gen = torch.Generator().manual_seed(0)
    _, a = model(ids, ids, deterministic=False, generator=gen)
    _, b = model(ids, ids, deterministic=False,
                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a)
