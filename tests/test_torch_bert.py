"""apex_tpu_torch's BERT MLM slice vs the JAX package, on the CPU.

A ``BertConfig.tiny`` model (2 layers, hidden 128, 2 heads of 64, S = 128
so the JAX flash shape gate passes) with the same flax-initialised
weights (``from_jax_bert_params``; LayerNorm affines and ``mlm_bias``
perturbed so they matter), the same numpy-seeded tokens, a padding mask
(lengths 128 and 90) and MLM labels on 15 % of the valid positions, at
``deterministic=True`` (flax's dropout bits cannot be reproduced; the
attention-dropout hash is held in ``test_torch_flash_attention.py``).
Tolerances:

- O0 (fp32): logits within 1e-4, the loss within rtol 1e-4 and every
  gradient within 1e-4 of its tensor's largest magnitude, against the JAX
  CPU default (jnp references) and its Pallas kernels in interpret mode
  (the bias flash kernels among them);
- O2 (bf16 model, fp32 masters): the loss within 2e-2 and every gradient
  within 2e-2 relative L2 error (both sides round activations to bf16 at
  the same places; their fp32 sums straddle bf16 rounding boundaries
  differently);
- ``SelfMultiheadAttn`` at fp32, both impls, with additive and boolean
  key-padding masks, a time mask, separate q/k/v parameters and the
  pre-LN norm-add variant: output within 1e-5, parameter grads within
  1e-4 of the module's largest gradient magnitude;
- three O2 steps of ``AmpOptimizer(fused_lamb)`` on the same scaled bf16
  grads, one with a planted inf that both sides skip: the masters'
  movement within 1e-5 relative L2 error of JAX's, the scaler state and
  LAMB's step count exactly equal, m and v untouched by the skip;
- the O2 cast set, the mapping's refusal of unknown keys, and a
  ``FusedTrainDriver`` window equal to single steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.contrib.multihead_attn import SelfMultiheadAttn as JaxMHA
from apex_tpu.models.bert import BertConfig as JaxConfig
from apex_tpu.models.bert import BertForMLM as JaxBert
from apex_tpu.ops._common import force_pallas
from apex_tpu.optimizers import fused_lamb as jax_fused_lamb
from apex_tpu_torch import amp
from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
from apex_tpu_torch.models import BertConfig, BertForMLM
from apex_tpu_torch.optimizers import fused_lamb
from apex_tpu_torch.train import FusedTrainDriver, read_metrics
from apex_tpu_torch.weights import (_mha_state, from_jax_bert_params,
                                    from_jax_opt_state)

B, S = 2, 128
LENGTHS = (128, 90)
LR, WD = 1e-3, 0.01
PLANT = ("mlm_ln", "scale")  # the leaf that gets the planted inf


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, size=(B, S))
    mask = (np.arange(S)[None, :] < np.array(LENGTHS)[:, None]).astype(
        np.int32)
    picked = (rng.rand(B, S) < 0.15) & (mask == 1)
    labels = np.where(picked, ids, -100)
    ids = np.where(picked, 3, ids)  # the [MASK] token
    return ids, labels, mask


def _perturb(tree, rng):
    """Random LayerNorm affines and mlm_bias (flax inits them to 1 / 0,
    where a missing or misplaced gradient could hide)."""
    def go(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k in ("scale",):
                out[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "bias" or k == "mlm_bias":
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return go(tree)


@pytest.fixture(scope="module")
def data():
    ids, labels, mask = _batch()
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    params = JaxBert(cfg).init(jax.random.PRNGKey(0), jnp.asarray(ids[:1, :16]),
                               attention_mask=jnp.ones((1, 16)))["params"]
    return ids, labels, mask, _perturb(params, np.random.RandomState(1))


def _jax_loss_fn(ids, labels, mask, compute_dtype, cast=None):
    model = JaxBert(JaxConfig.tiny(compute_dtype=compute_dtype))

    def loss(p):
        p = cast(p) if cast is not None else p
        logits, l = model.apply({"params": p}, jnp.asarray(ids),
                                labels=jnp.asarray(labels),
                                attention_mask=jnp.asarray(mask),
                                deterministic=True)
        return l, logits
    return loss


def _model(params, compute_dtype):
    m = BertForMLM(BertConfig.tiny(compute_dtype=compute_dtype))
    m.load_state_dict(from_jax_bert_params(params))
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rel_l2(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _grads_by_name(jg):
    return from_jax_bert_params(jax.tree_util.tree_map(np.asarray, jg))


@pytest.mark.parametrize("force", [None, True])
def test_o0_logits_loss_and_grads_match_jax(data, force):
    ids, labels, mask, params = data
    with force_pallas(force):
        (jl, jlogits), jg = jax.value_and_grad(
            _jax_loss_fn(ids, labels, mask, jnp.float32), has_aux=True)(params)
    want = _grads_by_name(jg)
    model = _model(params, torch.float32)
    logits, loss = model(_t(ids), _t(labels), attention_mask=_t(mask))
    assert logits.dtype == torch.float32 and logits.shape == (B, S, 1024)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    names = set()
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)
        names.add(name)
    assert names == set(want)


def test_o2_loss_and_grads_match_jax(data):
    ids, labels, mask, params = data
    jopt = jamp.AmpOptimizer(jax_fused_lamb(LR, weight_decay=WD),
                             jamp.initialize("O2", keep_batchnorm_fp32=True))
    (jl, _), jg = jax.value_and_grad(_jax_loss_fn(
        ids, labels, mask, jnp.bfloat16, jopt.model_params),
        has_aux=True)(params)
    want = _grads_by_name(jg)
    opt = amp.AmpOptimizer(fused_lamb(LR, weight_decay=WD),
                           amp.initialize("O2", keep_batchnorm_fp32=True))
    model = _model(params, torch.bfloat16)
    masters = opt.attach(model)
    assert all(m.dtype == torch.float32 for m in masters.values())
    logits, loss = model(_t(ids), _t(labels), attention_mask=_t(mask))
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    assert abs(float(loss.detach()) - float(jl)) <= 2e-2
    for name, g in zip(names, grads):
        assert g.dtype == torch.bfloat16
        assert _rel_l2(g, want[name]) <= 2e-2, name


def test_o2_casts_the_parameters_jax_casts(data):
    *_, params = data
    jmp = jamp.AmpOptimizer(jax_fused_lamb(LR), jamp.initialize(
        "O2", keep_batchnorm_fp32=True)).model_params(params)
    flags = from_jax_bert_params(jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(x.dtype == jnp.bfloat16)), jmp))
    want = {k for k, v in flags.items() if bool(v.all())}
    model = _model(params, torch.bfloat16)
    amp.AmpOptimizer(fused_lamb(LR), amp.initialize(
        "O2", keep_batchnorm_fp32=True)).attach(model)
    got = {n for n, p in model.named_parameters() if p.dtype == torch.bfloat16}
    assert got == want == set(flags)
    assert not any(amp.default_is_batchnorm(tuple(n.split(".")))
                   for n in flags)


MHA_CASES = {
    "fast_additive": (dict(impl="fast", bias=True, mask_additive=True),
                      "additive"),
    "default_additive": (dict(impl="default", bias=True, mask_additive=True),
                         "additive"),
    "fast_separate_qkv": (dict(impl="fast", bias=True,
                               separate_qkv_params=True), "boolean"),
    "default_time_mask": (dict(impl="default"), "time"),
    "fast_norm_add": (dict(impl="fast", bias=True, include_norm_add=True),
                      "boolean"),
    "default_norm_add": (dict(impl="default", include_norm_add=True), None),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_self_multihead_attn_matches_jax(case):
    kw, mask_kind = MHA_CASES[case]
    h, nh = 128, 2
    rng = np.random.RandomState(7)
    x = rng.randn(B, S, h).astype(np.float32)
    cot = rng.randn(B, S, h).astype(np.float32)
    pad = np.arange(S)[None, :] >= np.array(LENGTHS)[:, None]  # True = pad
    masks = {"additive": dict(key_padding_mask=np.where(pad, -1e9, 0.0)
                              .astype(np.float32)),
             "boolean": dict(key_padding_mask=pad.astype(np.int32)),
             "time": dict(attn_mask=np.triu(np.ones((S, S), np.int32), 1)),
             None: {}}[mask_kind]
    jmod = JaxMHA(embed_dim=h, num_heads=nh, **kw)
    jparams = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x),
                        is_training=False)["params"]
    jparams = _perturb(jparams, np.random.RandomState(4))
    jmask = {k: jnp.asarray(v) for k, v in masks.items()}

    def jloss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), is_training=False,
                         **jmask)
        return jnp.sum(out * jnp.asarray(cot)), out

    mod = SelfMultiheadAttn(h, nh, **kw)
    mod.load_state_dict(_mha_state(jparams, ""))
    out = mod(_t(x), is_training=False,
              **{k: _t(v) for k, v in masks.items()})
    (out * _t(cot)).sum().backward()
    for force in (True, None):
        with force_pallas(force):
            (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=0, atol=1e-5)
        want = _mha_state(jax.tree_util.tree_map(np.asarray, jg), "")
        # k's bias has a zero gradient (softmax ignores a per-row
        # constant), rounding noise on both sides: hold every grad to the
        # module's largest gradient magnitude
        top = max(np.abs(w.numpy()).max() for w in want.values())
        for name, p in mod.named_parameters():
            g, w = p.grad.numpy(), want[name].numpy()
            assert np.abs(g - w).max() <= 1e-4 * top, name


def test_mha_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="divisible"):
        SelfMultiheadAttn(130, 4)
    with pytest.raises(ValueError, match="impl"):
        SelfMultiheadAttn(128, 2, impl="fastest")
    with pytest.raises(ValueError, match="additive mask"):
        SelfMultiheadAttn(128, 2, mask_additive=True, include_norm_add=True)
    mod = SelfMultiheadAttn(128, 2, dropout=0.1)
    x = torch.zeros(1, 8, 128)
    with pytest.raises(ValueError, match="both"):
        mod(x, key_padding_mask=torch.zeros(1, 8),
            attn_mask=torch.zeros(8, 8), is_training=False)
    with pytest.raises(ValueError, match="Generator"):
        mod(x, is_training=True)


def _plant_jax(grads):
    g = dict(grads)
    a, b = PLANT
    g[a] = dict(g[a], **{b: g[a][b].at[3].set(jnp.inf)})
    return g


def test_three_o2_lamb_steps_match_jax_with_a_skipped_step(data):
    ids, labels, mask, params = data
    jamp_ = jamp.initialize("O2", keep_batchnorm_fp32=True)
    jopt = jamp.AmpOptimizer(jax_fused_lamb(LR, weight_decay=WD), jamp_)
    # not jitted: under jit XLA sums the word table's two bf16 grads
    # (lookup and tied decoder) in fp32, and they would no longer be bf16
    loss_fn = _jax_loss_fn(ids, labels, mask, jnp.bfloat16, jopt.model_params)
    jgrad = jax.grad(lambda mp, s: jamp_.scale_loss(loss_fn(mp)[0], s))
    jstep = jax.jit(jopt.step)
    masters_j, state_j = params, jopt.init(params)
    # one warm step, so the state handed across has nonzero moments
    masters_j, state_j, _ = jstep(jgrad(masters_j, state_j.scaler[0]),
                                  state_j, masters_j)

    opt = amp.AmpOptimizer(fused_lamb(LR, weight_decay=WD),
                           amp.initialize("O2", keep_batchnorm_fp32=True))
    start = from_jax_bert_params(jax.tree_util.tree_map(np.asarray,
                                                        masters_j))
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
            v_before = {k: v.clone() for k, v in state.opt_state.v.items()}
        g32 = from_jax_bert_params(jax.tree_util.tree_map(np.asarray, g))
        grads = {k: v.to(torch.bfloat16) for k, v in g32.items()}
        assert all(torch.equal(grads[k].float(), g32[k]) for k in g32)
        masters_j, state_j, stats_j = jstep(g, state_j, masters_j)
        masters, state, stats = opt.step(grads, state, masters, model=model)
        assert bool(stats.found_inf) == bool(stats_j.found_inf) == (i == 1)
        if i == 1:
            assert all(torch.equal(masters[k], before[k]) for k in masters)
            assert all(torch.equal(state.opt_state.m[k], m_before[k])
                       and torch.equal(state.opt_state.v[k], v_before[k])
                       for k in m_before)
        sj, st = state_j.scaler[0], state.scaler[0]
        assert float(st.loss_scale) == float(sj.loss_scale)
        assert int(st.unskipped) == int(sj.unskipped)
        assert int(st.overflows) == int(sj.overflows)
        assert int(state.opt_state.step) == int(state_j.opt_state.step)
    assert float(state.scaler[0].loss_scale) == 2.0 ** 15
    want = from_jax_bert_params(jax.tree_util.tree_map(np.asarray, masters_j))
    errs = {k: _rel_l2(v - start[k], want[k] - start[k])
            for k, v in masters.items()}
    params_now = dict(model.named_parameters())
    for k, v in masters.items():
        assert torch.equal(params_now[k], v.to(torch.bfloat16))
    assert max(errs.values()) <= 1e-5, errs


def test_driver_window_equals_single_steps(data):
    ids, labels, mask, params = data
    k = 2
    batches = tuple(_t(a)[None].repeat(k, 1, 1) for a in (ids, labels, mask))

    def setup():
        opt = amp.AmpOptimizer(fused_lamb(LR, weight_decay=WD),
                               amp.initialize("O2", keep_batchnorm_fp32=True))
        model = _model(params, torch.bfloat16)
        masters = opt.attach(model)
        names, ps = zip(*model.named_parameters())

        def step(carry, batch):
            masters, state = carry
            _, loss = model(batch[0], batch[1], attention_mask=batch[2])
            grads = torch.autograd.grad(
                opt.amp.scale_loss(loss, state.scaler[0]), ps)
            masters, state, _ = opt.step(dict(zip(names, grads)), state,
                                         masters, model=model)
            return (masters, state), {"loss": loss.detach()}
        return step, (masters, opt.init(masters))

    step, carry = setup()
    losses = []
    for i in range(k):
        carry, m = step(carry, tuple(b[i] for b in batches))
        losses.append(float(m["loss"]))
    single = carry
    step, carry = setup()
    driver = FusedTrainDriver(step, steps_per_dispatch=k, per_step=("loss",))
    carry, res = driver.run_window(carry, batches)
    assert read_metrics(res).per_step["loss"] == losses
    for name in single[0]:
        assert torch.equal(carry[0][name], single[0][name])


def test_mapping_raises_on_unknown_keys(data):
    *_, params = data
    from_jax_bert_params(params)
    bad = dict(params, encoder=dict(params["encoder"],
                                    segment_embeddings={"embedding": 0}))
    with pytest.raises(ValueError, match="segment_embeddings"):
        from_jax_bert_params(bad)
    with pytest.raises(ValueError, match="mlm_decoder"):
        from_jax_bert_params(dict(params, mlm_decoder={"kernel": 0}))
    layer = dict(params["encoder"]["layer_0"], extra={"kernel": 0})
    with pytest.raises(ValueError, match="extra"):
        from_jax_bert_params(dict(params, encoder=dict(params["encoder"],
                                                       layer_0=layer)))
    attn = dict(params["encoder"]["layer_1"]["self_attn"], rel_bias=0)
    layer = dict(params["encoder"]["layer_1"], self_attn=attn)
    with pytest.raises(ValueError, match="rel_bias"):
        from_jax_bert_params(dict(params, encoder=dict(params["encoder"],
                                                       layer_1=layer)))


def test_what_is_not_ported_raises(data):
    with pytest.raises(ValueError, match="remat_policy"):
        BertConfig.tiny(remat_policy="everything")
    model = _model(data[3], torch.float32)
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="token_type_ids"):
        model.encoder(ids, token_type_ids=ids)
    with pytest.raises(ValueError, match="Generator"):
        model(ids, ids, deterministic=False)
    gen = torch.Generator().manual_seed(0)
    _, a = model(ids, ids, deterministic=False, generator=gen)
    _, b = model(ids, ids, deterministic=False,
                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a)
