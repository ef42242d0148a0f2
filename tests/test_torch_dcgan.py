"""apex_tpu_torch's ``conv_transpose``/``ConvTranspose``, DCGAN and its
three-scaler example vs the JAX package, on the CPU.

- ``amp.functional.conv_transpose_nhwc`` against ``jax.lax.
  conv_transpose`` (NHWC/HWIO, ``transpose_kernel=False``, precision
  highest) at DCGAN's five (size, kernel, stride, padding) and at odd
  ones (kernels 1, 3 and 5, strides 1 to 3, odd sizes, ``"SAME"``,
  ``"VALID"`` and explicit pairs that torch's ``padding`` /
  ``output_padding`` can and cannot express): the output, dx and dw
  within 1e-5 of their largest magnitude (fp32); the ``ConvTranspose``
  layer with a bias against the JAX layer within 1e-5;
- ``Generator`` and ``Discriminator`` at nz 16, ngf = ndf = 8, batch 4,
  fp32, flax-initialised weights (BatchNorm affines perturbed): three
  training-mode forwards threading the batch statistics, the outputs
  within 1e-5 (the logits 1e-4) and the statistics within 1e-5 of
  flax's ``batch_stats``; the gradients of a weighted sum of the
  outputs within 1e-4 of each tensor's largest magnitude; eval mode too;
- three O1 iterations of ``examples/dcgan.py``'s step (batch 4) against
  the JAX example's D and G steps (``examples/dcgan/main_amp.py``, in
  bf16 through the layers' dtype), the third with an inf planted in
  D's errD_fake gradients: both skip D's step alone and halve scaler 1
  alone; the three scaler states exactly equal after every iteration;
  errD and errG within 5e-2 of their magnitude and every master within
  5e-2 of its tensor's largest magnitude (bf16 products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.amp import F as JF
from apex_tpu.amp.layers import ConvTranspose as JaxConvTranspose
from apex_tpu.models.dcgan import Discriminator as JaxD
from apex_tpu.models.dcgan import Generator as JaxG
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch.amp.functional import conv_transpose_nhwc
from apex_tpu_torch.amp.layers import ConvTranspose
from apex_tpu_torch.examples import dcgan as example
from apex_tpu_torch.models.dcgan import Discriminator, Generator
from apex_tpu_torch.weights import from_jax_dcgan_params

#: (H, W, kernel, stride, padding, in, out): DCGAN's five, then odd ones
CT_CASES = [
    (1, 1, 4, 1, "VALID", 16, 8), (4, 4, 4, 2, "SAME", 8, 8),
    (8, 8, 4, 2, "SAME", 8, 4), (16, 16, 4, 2, "SAME", 4, 4),
    (32, 32, 4, 2, "SAME", 4, 3),
    (5, 7, 3, 2, "SAME", 3, 4), (7, 5, 5, 3, "VALID", 2, 3),
    (6, 6, 3, 1, "SAME", 3, 2), (5, 5, 1, 2, "VALID", 2, 2),
    (6, 6, 2, 3, "SAME", 2, 2), (5, 6, 3, 2, ((0, 3), (2, 0)), 2, 3),
    (5, 5, 3, 2, ((4, 1), (1, 1)), 3, 2),
]
NZ, WIDTH, BATCH = 16, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("case", CT_CASES, ids=str)
def test_conv_transpose_matches_lax(case):
    h, w, k, s, pad, ci, co = case
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, w, ci).astype(np.float32)
    kern = rng.randn(k, k, ci, co).astype(np.float32)

    def jfn(x, kern):
        return jax.lax.conv_transpose(
            x, kern, (s, s), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(kern))
    cot = rng.randn(*want.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(cot))
    tx, tw = _t(x).requires_grad_(), _t(kern).requires_grad_()
    got = conv_transpose_nhwc(tx, tw, (s, s), pad)
    assert tuple(got.shape) == want.shape
    (got * _t(cot)).sum().backward()
    for a, b in ((got, want), (tx.grad, jdx), (tw.grad, jdw)):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_conv_transpose_layer_matches_flax_layer():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    jlayer = JaxConvTranspose(4, (3, 3), (2, 2), padding="SAME")
    params = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = dict(params, bias=rng.randn(4).astype(np.float32))
    want = jlayer.apply({"params": params}, jnp.asarray(x))
    layer = ConvTranspose(3, 4, (3, 3), (2, 2), padding="SAME")
    layer.load_state_dict({k: _t(v) for k, v in params.items()})
    np.testing.assert_allclose(_np(layer(_t(x))), np.asarray(want), rtol=0,
                               atol=1e-5)


def _perturb_bn(tree, rng):
    return {name: ({k: (float(k == "scale") + 0.1 * rng.randn(*v.shape))
                    .astype(np.float32) for k, v in sub.items()}
                   if name.startswith("BatchNorm") else
                   {k: np.asarray(v) for k, v in sub.items()})
            for name, sub in tree.items()}


def _init(model, x, seed):
    v = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    return (_perturb_bn(v["params"], np.random.RandomState(seed)),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]))


@pytest.mark.parametrize("which", ["generator", "discriminator"])
def test_models_and_batch_stats_match_flax(which):
    rng = np.random.RandomState(2)
    if which == "generator":
        jmodel, model = JaxG(nz=NZ, ngf=WIDTH), Generator(nz=NZ, ngf=WIDTH)
        xs = [rng.randn(BATCH, 1, 1, NZ).astype(np.float32) for _ in range(3)]
        atol = 1e-5
    else:
        jmodel, model = JaxD(ndf=WIDTH), Discriminator(ndf=WIDTH)
        xs = [rng.uniform(-1, 1, (BATCH, 64, 64, 3)).astype(np.float32)
              for _ in range(3)]
        atol = 1e-4
    params, jstats = _init(jmodel, xs[0], 3)
    state, stats = from_jax_dcgan_params(params, jstats)
    model.load_state_dict(state)
    train = jax.jit(lambda p, st, x: jmodel.apply(
        {"params": p, "batch_stats": st}, x, mutable=["batch_stats"]))
    for x in xs:
        out, upd = train(params, jstats, jnp.asarray(x))
        jstats = upd["batch_stats"]
        got, stats = model(_t(x), stats, train=True)
        np.testing.assert_allclose(_np(got), np.asarray(out), rtol=0,
                                   atol=atol)
        want_stats = from_jax_dcgan_params(params, jstats)[1]
        assert set(stats) == set(want_stats)
        for k, v in stats.items():
            np.testing.assert_allclose(_np(v), want_stats[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
    cot = rng.randn(*np.shape(out)).astype(np.float32)

    def jloss(p):
        o, _ = train(p, jstats, jnp.asarray(xs[0]))
        return jnp.sum(o * jnp.asarray(cot))

    jg = from_jax_dcgan_params(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(jloss))(params)))
    got, _ = model(_t(xs[0]), stats, train=True)
    (got * _t(cot)).sum().backward()
    for name, p in model.named_parameters():
        w = jg[name].numpy()
        assert np.abs(_np(p.grad) - w).max() <= 1e-4 * np.abs(w).max(), name
    eval_out = jmodel.apply({"params": params, "batch_stats": jstats},
                            jnp.asarray(xs[1]), train=False)
    got, same = model(_t(xs[1]), stats, train=False)
    assert same is stats
    np.testing.assert_allclose(_np(got), np.asarray(eval_out), rtol=0,
                               atol=atol)


def _jax_example_step(amp_, netG, netD, optG, optD, plant):
    """The JAX example's D and G steps (examples/dcgan/main_amp.py:
    d_step, g_step), with ``plant`` adding an inf to errD_fake's grads."""
    def step(carry, real, z):
        gparams, gstats, gstate, dparams, dstats, dstate = carry
        fake, _ = netG.apply({"params": gparams, "batch_stats": gstats}, z,
                             mutable=["batch_stats"])

        def loss_real(dp):
            out, upd = netD.apply({"params": optD.model_params(dp),
                                   "batch_stats": dstats}, real,
                                  mutable=["batch_stats"])
            loss = JF.binary_cross_entropy_with_logits(out,
                                                       jnp.ones_like(out))
            return amp_.scale_loss(loss, dstate.scaler[0], loss_id=0), (
                loss, upd)

        g_real, (err_real, upd) = jax.grad(loss_real, has_aux=True)(dparams)
        dstats2 = upd["batch_stats"]

        def loss_fake(dp):
            out, upd = netD.apply({"params": optD.model_params(dp),
                                   "batch_stats": dstats2}, fake,
                                  mutable=["batch_stats"])
            loss = JF.binary_cross_entropy_with_logits(out,
                                                       jnp.zeros_like(out))
            return amp_.scale_loss(loss, dstate.scaler[1], loss_id=1), (
                loss, upd)

        g_fake, (err_fake, upd) = jax.grad(loss_fake, has_aux=True)(dparams)
        if plant:
            g_fake = dict(g_fake, Conv_4={"kernel": g_fake["Conv_4"][
                "kernel"].at[0, 0, 0, 0].set(jnp.inf)})
        dstate1 = optD.accumulate(g_real, dstate, loss_id=0)
        dparams, dstate, _ = optD.step(g_fake, dstate1, dparams, loss_id=1)
        dstats = upd["batch_stats"]

        def loss_g(gp):
            fake, gupd = netG.apply({"params": optG.model_params(gp),
                                     "batch_stats": gstats}, z,
                                    mutable=["batch_stats"])
            out, _ = netD.apply({"params": dparams, "batch_stats": dstats},
                                fake, mutable=["batch_stats"])
            loss = JF.binary_cross_entropy_with_logits(out,
                                                       jnp.ones_like(out))
            return amp_.scale_loss(loss, gstate.scaler[2], loss_id=2), (
                loss, gupd)

        grads, (err_g, gupd) = jax.grad(loss_g, has_aux=True)(gparams)
        gparams, gstate, _ = optG.step(grads, gstate, gparams, loss_id=2)
        return ((gparams, gupd["batch_stats"], gstate, dparams, dstats,
                 dstate), err_real + err_fake, err_g)
    return jax.jit(step)


def _scalers(state):
    return [(float(s.loss_scale), int(s.unskipped), int(s.overflows))
            for s in state.scaler]


def test_three_o1_iterations_match_the_jax_example():
    rng = np.random.RandomState(4)
    reals = rng.uniform(-1, 1, (3, BATCH, 64, 64, 3)).astype(np.float32)
    zs = rng.randn(3, BATCH, 1, 1, NZ).astype(np.float32)
    amp_ = jamp.initialize("O1", num_losses=3)
    dt = amp_.policy.compute_dtype
    netG, netD = JaxG(nz=NZ, ngf=WIDTH, compute_dtype=dt), JaxD(
        ndf=WIDTH, compute_dtype=dt)
    gp, gs = _init(netG, zs[0], 5)
    dp, ds = _init(netD, reals[0], 6)
    optG = jamp.AmpOptimizer(jax_fused_adam(2e-4, betas=(0.5, 0.999)), amp_)
    optD = jamp.AmpOptimizer(jax_fused_adam(2e-4, betas=(0.5, 0.999)), amp_)
    jcarry = (gp, gs, optG.init(gp), dp, ds, optD.init(dp))
    steps = {p: _jax_example_step(amp_, netG, netD, optG, optD, p)
             for p in (False, True)}

    gan, carry = example.build(
        "O1", nz=NZ, ngf=WIDTH, ndf=WIDTH, device="cpu",
        params=(*from_jax_dcgan_params(gp, gs), *from_jax_dcgan_params(dp,
                                                                       ds)))
    plant = {"on": False}
    d_step = gan.optD.step

    def planted(grads, *a, **kw):
        if plant["on"]:
            g = grads["Conv_4.kernel"].clone()
            g[0, 0, 0, 0] = float("inf")
            grads = dict(grads, **{"Conv_4.kernel": g})
        return d_step(grads, *a, **kw)

    gan.optD.step = planted
    step = example.make_step(gan)
    for i in range(3):
        plant["on"] = i == 2
        d_before = {k: v.clone() for k, v in carry[3].items()}
        jcarry, j_errd, j_errg = steps[i == 2](jcarry, jnp.asarray(reals[i]),
                                               jnp.asarray(zs[i]))
        carry, m = step(carry, (_t(reals[i]), _t(zs[i])))
        assert _scalers(carry[5]) == _scalers(jcarry[5]), i
        assert _scalers(carry[2]) == _scalers(jcarry[2]), i
        for got, want in ((m["errD"], j_errd), (m["errG"], j_errg)):
            assert abs(float(got) - float(want)) <= 5e-2 * abs(float(want))
        if i == 2:
            assert all(torch.equal(carry[3][k], d_before[k])
                       for k in d_before)
            assert float(m["scale_d_fake"]) == 2.0 ** 15
            assert float(m["scale_d_real"]) == float(m["scale_g"]) == 2.0 ** 16
    for got, want in ((carry[0], jcarry[0]), (carry[3], jcarry[3])):
        want = from_jax_dcgan_params(jax.tree_util.tree_map(np.asarray, want))
        for k, w in want.items():
            w = w.numpy()
            assert np.abs(_np(got[k]) - w).max() <= 5e-2 * np.abs(w).max(), k
