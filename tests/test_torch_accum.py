"""apex_tpu_torch's gradient accumulation (``train.accum``) on one device,
on the CPU.

The single-device cases of ``tests/test_accum_driver.py``, ported: an O2
``AmpOptimizer(fused_sgd)`` over a linear model whose ``grad_fn`` returns
scaled grads.

- M in {1, 2, 4} microbatches per step through ``FusedTrainDriver``
  equals a per-microbatch loop (each microbatch's grads added into an fp32
  buffer, one update per boundary) bit for bit: masters, momentum, step
  count and loss-scaler state;
- an inf in one microbatch is found on the accumulated gradient, skips
  that whole boundary (the masters untouched, not just that microbatch's
  share) and halves the scale once;
- the ``bf16_compensated`` (Kahan) buffer tracks the fp32 one;
- the rejections: an unknown accumulation dtype, a window M does not
  divide, a microbatch count below 1, a metric name on both sides, the
  cross-replica arguments; and the microbatch count is the argument's
  (default 1), never an environment variable's;
- three O2 boundaries of GPT tiny with M = 2 against JAX's
  ``amp_microbatch_step`` with ``fused_adam``, both sides fed the same
  scaled grads of each microbatch (JAX's), with an inf planted in one
  microbatch of the second boundary: the scaler state exact at every
  boundary, the skipped boundary moving nothing, and each master's
  movement over the applied boundaries within 1e-5 relative L2 error of
  JAX's (as ``test_torch_train.py`` holds single steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.train.accum import amp_microbatch_step as jax_microbatch_step
from apex_tpu.train.accum import build_opt_step as jax_build_opt_step
from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_adam, fused_sgd
from apex_tpu_torch.train import (
    FusedTrainDriver,
    MicrobatchedStep,
    amp_microbatch_step,
    build_opt_step,
    read_metrics,
)
from apex_tpu_torch.weights import from_jax_opt_state, from_jax_params

N_MB = 8  # total microbatches every driver test consumes


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


def _tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    return all(torch.equal(x, y) for x, y in zip(la, lb))


def _setup():
    """O2 grad_fn over a linear model: scaled fp32 grads of the masters
    through their bf16 cast."""
    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_sgd(0.05, momentum=0.9), amp_)

    def grad_fn(carry, batch):
        masters, state = carry
        x, y = batch
        w = masters["w"].detach().requires_grad_()
        pred = x.to(torch.bfloat16) @ w.to(torch.bfloat16)
        loss = torch.square(pred.float() - y).mean()
        (g,) = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]),
                                   (w,))
        return {"w": g}, {"loss": loss.detach()}

    rng = np.random.RandomState(0)
    w0 = (rng.randn(16, 4) * 0.3).astype(np.float32)
    xs = torch.from_numpy(rng.randn(N_MB, 32, 16).astype(np.float32))
    ys = torch.from_numpy(rng.randn(N_MB, 32, 4).astype(np.float32))

    def fresh():
        masters = {"w": torch.from_numpy(w0.copy())}
        return masters, opt.init(masters)

    return grad_fn, opt, fresh, xs, ys


def _reference_loop(step, carry, xs, ys):
    """One grad_fn call per microbatch, the fp32 sum in the loop, one
    update_fn call per boundary."""
    m = step.microbatches
    for s in range(xs.shape[0] // m):
        acc = None
        for i in range(m):
            g, _ = step.grad_fn(carry, (xs[s * m + i], ys[s * m + i]))
            g32 = {n: t.float() for n, t in g.items()}
            acc = g32 if acc is None else {n: acc[n] + g32[n] for n in acc}
        carry, _ = step.update_fn(carry, acc)
    return carry


@pytest.mark.parametrize("m", [1, 2, 4])
def test_m_sweep_matches_reference_loop(m):
    grad_fn, opt, fresh, xs, ys = _setup()
    step = amp_microbatch_step(grad_fn, opt, microbatches=m)
    driver = FusedTrainDriver(step, steps_per_dispatch=2, metrics={
        "loss": "mean", "scale": "last", "skipped": "sum"})
    assert driver.microbatches == m
    c = fresh()
    for w in range(N_MB // (2 * m)):
        sl = slice(w * 2 * m, (w + 1) * 2 * m)
        c, res = driver.run_window(c, (xs[sl], ys[sl]))
    ref = _reference_loop(step, fresh(), xs, ys)
    assert _tree_equal(c, ref)
    assert read_metrics(res.metrics)["skipped"] == 0.0
    assert int(c[1].opt_state.step) == N_MB // m


def test_mid_window_overflow_skips_whole_accumulated_update():
    """An inf in microbatch 5 (step 2 of 4, M = 2) is found on the
    accumulated gradient, skips that boundary's update, halves the scale
    once, and lands bit for bit on the per-microbatch loop."""
    grad_fn, opt, fresh, xs, ys = _setup()
    xs = xs.clone()
    xs[5, 0, 0] = float("inf")
    step = amp_microbatch_step(grad_fn, opt, microbatches=2)
    driver = FusedTrainDriver(step, steps_per_dispatch=2,
                              metrics={"scale": "last", "skipped": "sum"})
    c = fresh()
    skipped = 0.0
    for w in range(2):
        sl = slice(w * 4, (w + 1) * 4)
        c, res = driver.run_window(c, (xs[sl], ys[sl]))
        skipped += read_metrics(res.metrics)["skipped"]
    assert skipped == 1.0  # exactly the one poisoned boundary
    ref = _reference_loop(step, fresh(), xs, ys)
    assert _tree_equal(c, ref)
    _, state = c
    assert float(state.scaler[0].loss_scale) == 2.0 ** 15
    assert int(state.scaler[0].overflows) == 1
    assert int(state.opt_state.step) == 3


def test_skipped_boundary_leaves_params_unchanged():
    """The whole M-microbatch update is gated, not just the poisoned
    microbatch's share."""
    grad_fn, opt, fresh, xs, ys = _setup()
    xs = xs.clone()
    xs[1, 0, 0] = float("nan")  # the second microbatch of step 0
    step = amp_microbatch_step(grad_fn, opt, microbatches=2)
    driver = FusedTrainDriver(step, steps_per_dispatch=1)
    c0 = fresh()
    w0 = c0[0]["w"].clone()
    c1, res = driver.run_window(c0, (xs[:2], ys[:2]))
    assert torch.equal(c1[0]["w"], w0)
    assert torch.equal(c1[1].opt_state.momentum_buf["w"],
                       torch.zeros_like(w0))
    assert read_metrics(res.metrics)["skipped"] == 1.0


def test_bf16_compensated_tracks_fp32():
    grad_fn, opt, fresh, xs, ys = _setup()

    def run(accum_dtype):
        step = amp_microbatch_step(grad_fn, opt, microbatches=4,
                                   accum_dtype=accum_dtype)
        driver = FusedTrainDriver(step, steps_per_dispatch=2)
        c, _ = driver.run_window(fresh(), (xs, ys))
        return c[0]["w"].numpy()

    w32, wbf = run("float32"), run("bf16_compensated")
    assert np.all(np.isfinite(wbf)) and not np.array_equal(w32, wbf)
    np.testing.assert_allclose(wbf, w32, rtol=2e-2, atol=2e-3)


def test_rejections():
    grad_fn, opt, fresh, xs, ys = _setup()
    with pytest.raises(ValueError, match="accum_dtype"):
        amp_microbatch_step(grad_fn, opt, microbatches=2,
                            accum_dtype="float16")
    driver = FusedTrainDriver(amp_microbatch_step(grad_fn, opt,
                                                  microbatches=4),
                              steps_per_dispatch=2)
    with pytest.raises(ValueError, match="multiple of microbatches"):
        driver.run_window(fresh(), (xs[:6], ys[:6]))  # 6 % 4 != 0
    with pytest.raises(ValueError, match="microbatches"):
        build_opt_step(MicrobatchedStep(lambda c, b: (c, {}),
                                        lambda c, a: (c, {}),
                                        microbatches=0))
    # ddp= and grad_presum= are ported (tests/test_torch_ddp.py); the
    # compressed boundary collective compresses DDP's all-reduce, so it
    # needs ddp= (tests/test_torch_compress.py)
    with pytest.raises(ValueError, match="pass ddp="):
        amp_microbatch_step(grad_fn, opt, microbatches=2, compress="bf16")


def test_metric_name_clash_rejected():
    step = MicrobatchedStep(
        lambda c, b: ({"g": torch.zeros(())}, {"scale": torch.ones(())}),
        lambda c, a: (c, {"scale": torch.ones(())}),
        microbatches=2)
    driver = FusedTrainDriver(step, steps_per_dispatch=1)
    with pytest.raises(ValueError, match="scale"):
        driver.run_window(torch.zeros(()))


def test_microbatches_come_from_the_argument_only(monkeypatch):
    """The JAX package reads APEX_TPU_MICROBATCHES; the port takes the
    argument (default 1) and reads no environment variable."""
    grad_fn, opt, _, _, _ = _setup()
    monkeypatch.setenv("APEX_TPU_MICROBATCHES", "3")
    assert amp_microbatch_step(grad_fn, opt).microbatches == 1
    assert amp_microbatch_step(grad_fn, opt, microbatches=5).microbatches == 5
    assert FusedTrainDriver(lambda c, b: (c, {})).microbatches == 1


def test_closure_data_mode():
    """batches=None: grad_fn runs M times per step on captured data."""
    def grad_fn(carry, batch):
        assert batch is None
        return {"g": torch.ones(())}, {"loss": torch.zeros(())}

    def update_fn(carry, acc):
        return carry + acc["g"], {"acc": acc["g"]}

    driver = FusedTrainDriver(MicrobatchedStep(grad_fn, update_fn,
                                               microbatches=3),
                              steps_per_dispatch=2)
    carry, res = driver.run_window(torch.zeros(()))
    # 2 steps x (sum of 3 unit grads) accumulated into the carry
    assert float(carry) == 6.0
    assert read_metrics(res.metrics)["acc"] == 3.0
    # run() counts optimizer steps, not microbatches
    step = MicrobatchedStep(lambda c, b: ({"g": b.sum()}, {}),
                            update_fn, microbatches=3)
    driver = FusedTrainDriver(step, steps_per_dispatch=2)
    carry, done = driver.run(torch.zeros(()), [torch.ones(6, 2)] * 2)
    assert done == 4 and float(carry) == 24.0


# -- GPT tiny, O2, three boundaries against JAX ------------------------------

B, S, M = 2, 128, 2
LR, WD = 6e-4, 0.1


def _jax_grads_of(cfg_dtype, jopt, jamp_):
    model = JaxGPTLM(JaxConfig.tiny(compute_dtype=cfg_dtype))

    def scaled(mp, scale_state, ids, labels):
        loss = model.apply({"params": jopt.model_params(mp)}, ids,
                           labels=labels, deterministic=True)[1]
        return jamp_.scale_loss(loss, scale_state), loss

    return jax.jit(jax.grad(scaled, has_aux=True))


def _plant_jax(grads):
    g = dict(grads)
    g["ln_f"] = dict(g["ln_f"], scale=g["ln_f"]["scale"].at[3].set(jnp.inf))
    return g


def _rel_l2(got, want):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_three_o2_boundaries_match_jax_with_a_skipped_one():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, size=(3 * M, B, S))
    labels = np.concatenate([ids[..., 1:], np.full((3 * M, B, 1), -100)],
                            axis=-1)
    params = JaxGPTLM(JaxConfig.tiny(compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.asarray(ids[0, :1, :16]))["params"]
    jamp_ = jamp.initialize("O2")
    jopt = jamp.AmpOptimizer(jax_fused_adam(LR, weight_decay=WD), jamp_)
    jgrad = _jax_grads_of(jnp.bfloat16, jopt, jamp_)
    plant = {"at": None}
    fed = []  # each microbatch's grads, as JAX computed them

    def jax_grad_fn(carry, mb):
        masters, state = carry
        g, loss = jgrad(masters, state.scaler[0], mb[0], mb[1])
        if plant["at"] == len(fed):
            g = _plant_jax(g)
        fed.append(g)
        return g, {"loss": loss}

    jstep = jax_build_opt_step(jax_microbatch_step(jax_grad_fn, jopt,
                                                   microbatches=M))
    masters_j = params
    state_j = jopt.init(params)
    # one warm plain step, so the state handed across has nonzero moments
    g0, _ = jgrad(masters_j, state_j.scaler[0], jnp.asarray(ids[0]),
                  jnp.asarray(labels[0]))
    masters_j, state_j, _ = jopt.step(g0, state_j, masters_j)

    opt = amp.AmpOptimizer(fused_adam(LR, weight_decay=WD),
                           amp.initialize("O2"))
    start = from_jax_params(jax.tree_util.tree_map(np.asarray, masters_j))
    masters = {k: v.clone() for k, v in start.items()}
    state = from_jax_opt_state(state_j, device="cpu")

    def grad_fn(carry, mb):
        # the same scaled grads JAX took for this microbatch (fp32: under
        # jit, wte's lookup and head grads are summed in fp32)
        g = fed[mb]
        return (from_jax_params(jax.tree_util.tree_map(np.asarray, g)),
                {"loss": torch.zeros(())})

    step = amp_microbatch_step(grad_fn, opt, microbatches=M)
    driver = FusedTrainDriver(step, steps_per_dispatch=1,
                              metrics={"scale": "last", "skipped": "sum"})
    carry = (masters, state)
    for b in range(3):
        if b == 1:
            plant["at"] = len(fed) + 1  # the second microbatch of boundary 2
            before = {k: v.clone() for k, v in masters.items()}
        mbs = tuple(jnp.asarray(a[b * M:(b + 1) * M]) for a in (ids, labels))
        n0 = len(fed)
        (masters_j, state_j), jm = jstep((masters_j, state_j), mbs)
        carry, res = driver.run_window(carry, torch.arange(n0, n0 + M))
        masters, state = carry
        host = read_metrics(res.metrics)
        assert host["skipped"] == float(jm["skipped"]) == float(b == 1)
        if b == 1:
            assert all(torch.equal(masters[k], before[k]) for k in masters)
        sj, st = state_j.scaler[0], state.scaler[0]
        assert float(st.loss_scale) == float(sj.loss_scale)
        assert int(st.unskipped) == int(sj.unskipped)
        assert int(st.overflows) == int(sj.overflows)
        assert int(state.opt_state.step) == int(state_j.opt_state.step)
    assert float(state.scaler[0].loss_scale) == 2.0 ** 15
    assert len(fed) == 3 * M
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, masters_j))
    errs = {k: _rel_l2(v - start[k], want[k] - start[k])
            for k, v in masters.items()}
    assert max(errs.values()) <= 1e-5, errs
