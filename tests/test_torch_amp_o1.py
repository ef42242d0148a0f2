"""apex_tpu_torch's AMP O1 (cast tables, the functional namespace, the
policy-aware layers) vs the JAX package, on the CPU.

- the port's five tables equal ``apex_tpu.amp.lists``'s;
- every op of the functional namespace, inside ``autocast``, against
  JAX's ``F.*`` on the same numpy inputs: the same output dtype, values
  within fp32 rounding (1e-5) or, for bf16 results, within one bf16 ulp
  or 1e-2;
- ``disable_casts``, the decorators and their ``register_*`` forms, the
  banned BCE;
- GPT tiny, BERT tiny (padded, so flash attention takes its bias) and the
  narrow ResNet built with an fp32 compute dtype and run under
  ``amp_.autocast()`` against JAX's O1 from the same weights: logits
  within 5e-2 of the largest logit, the loss within 1e-2, every gradient
  within 2e-2 relative L2 error (ROADMAP's bf16-compute rules);
- the products: every Dense, projection, convolution and head product
  runs with bf16 operands, as many as JAX's jaxpr has bf16
  ``dot_general``/``conv_general_dilated`` operands;
- O0, O2 and O3: logits bit for bit the same inside and outside
  ``amp_.autocast()`` (a no-op there);
- a decoder built with an O1 policy stores a bf16 cache, as JAX's
  ``cache_dtype``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.amp import F as JF
from apex_tpu.amp import lists as jlists
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForMLM as JaxBert
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.models.resnet import ResNet as JaxResNet
from apex_tpu.ops import softmax_cross_entropy as jax_xent
from apex_tpu_torch import amp
from apex_tpu_torch.amp import F, lists
from apex_tpu_torch.models import (BertConfig, BertForMLM, GPTConfig, GPTLM,
                                   ResNet)
from apex_tpu_torch.ops import softmax_cross_entropy
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.serve import GPTDecoder
from apex_tpu_torch.weights import (from_jax_bert_params, from_jax_params,
                                    from_jax_resnet_params)

B, S = 2, 128
RN = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
NHWC = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _same_dtype(t, j) -> bool:
    return _DT[jnp.dtype(j.dtype).type] == t.dtype


# --- the tables -------------------------------------------------------------

def test_tables_equal_the_jax_packages():
    for name in ("HALF_FUNCS", "FP32_FUNCS", "PROMOTE_FUNCS",
                 "SEQUENCE_FUNCS", "BANNED_FUNCS"):
        assert set(getattr(lists, name)) == set(getattr(jlists, name)), name
    every = (set(jlists.HALF_FUNCS) | set(jlists.FP32_FUNCS)
             | set(jlists.PROMOTE_FUNCS) | set(jlists.SEQUENCE_FUNCS)
             | set(jlists.BANNED_FUNCS) | {"not_an_op"})
    for op in every:
        assert lists.category(op) == jlists.category(op), op
    assert "apex_tpu_torch" in lists.BANNED_FUNCS["binary_cross_entropy"]


# --- the functional namespace ----------------------------------------------

def _arr(rng, *shape, dtype=np.float32, lo=None):
    a = rng.randn(*shape).astype(np.float32)
    if lo is not None:
        a = lo + (1 - 2 * lo) / (1 + np.exp(-a))  # into (lo, 1 - lo)
    return a.astype(dtype) if dtype is not np.float32 else a


def _op_cases():
    rng = np.random.RandomState(0)
    f32 = lambda *s: _arr(rng, *s)  # noqa: E731
    labels = rng.randint(0, 10, size=(8,))
    probs = _arr(rng, 16, lo=0.05)
    targets = (rng.rand(16) > 0.5).astype(np.float32)
    return {
        "matmul": (lambda m, a, b: m.matmul(a, b), [f32(8, 16), f32(16, 4)]),
        "einsum": (lambda m, a, b: m.einsum("ij,jk->ik", a, b),
                   [f32(8, 16), f32(16, 4)]),
        "dense": (lambda m, x, w, b: m.dense(x, w, b),
                  [f32(4, 8, 16), f32(16, 12), f32(12)]),
        "conv_general_dilated": (
            lambda m, x, w: m.conv_general_dilated(
                x, w, (1, 1), "SAME", **({"dimension_numbers": NHWC}
                                          if m is JF else {})),
            [f32(2, 6, 6, 3), f32(3, 3, 3, 5)]),
        "softmax": (lambda m, x: m.softmax(x), [f32(4, 10)]),
        "log_softmax": (lambda m, x: m.log_softmax(x), [f32(4, 10)]),
        "logsumexp": (lambda m, x: m.logsumexp(x), [f32(4, 10)]),
        "logsumexp_axis": (lambda m, x: m.logsumexp(x, axis=-1),
                           [f32(4, 10)]),
        "layer_norm": (lambda m, x, s, b: m.layer_norm(x, s, b),
                       [f32(4, 32), f32(32), f32(32)]),
        "cross_entropy": (
            lambda m, x: m.cross_entropy(
                x, labels if m is JF else _t(labels)), [f32(8, 10)]),
        "mse_loss": (lambda m, a, b: m.mse_loss(a, b), [f32(16), f32(16)]),
        "l1_loss": (lambda m, a, b: m.l1_loss(a, b), [f32(16), f32(16)]),
        "bce_with_logits": (
            lambda m, a, b: m.binary_cross_entropy_with_logits(a, b),
            [f32(16), targets]),
        "add": (lambda m, a, b: m.add(a, b), [f32(16), f32(16)]),
        "mul": (lambda m, a, b: m.mul(a, b), [f32(16), f32(16)]),
        "concatenate": (lambda m, a, b: m.concatenate([a, b], axis=0),
                        [f32(3, 4), f32(2, 4)]),
        "stack": (lambda m, a, b: m.stack([a, b], axis=1),
                  [f32(3, 4), f32(3, 4)]),
        "exp": (lambda m, x: m.exp(x), [f32(16)]),
        "log": (lambda m, x: m.log(x), [probs]),
        "pow": (lambda m, x: m.pow(x, 3.0), [f32(16)]),
        "sum": (lambda m, x: m.sum(x), [f32(4, 8)]),
        "sum_axis": (lambda m, x: m.sum(x, axis=1), [f32(4, 8)]),
        "mean": (lambda m, x: m.mean(x), [f32(4, 8)]),
        "mean_axis": (lambda m, x: m.mean(x, axis=0), [f32(4, 8)]),
    }


_OPS = _op_cases()


def _bf16_close(got, want) -> bool:
    """Within one bf16 ulp of the larger magnitude, or 1e-2."""
    ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7
    return bool(np.all(np.abs(got - want) <= np.maximum(ulp, 1e-2)))


@pytest.mark.parametrize("name", sorted(_OPS))
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_functional_op_matches_jax_under_autocast(name, in_dtype):
    """The first operand arrives in ``in_dtype`` and the rest in fp32, so
    HALF ops cast down, FP32 ops cast up and PROMOTE ops widen."""
    fn, args = _OPS[name]
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    if in_dtype == "bfloat16":
        jargs[0] = jargs[0].astype(jnp.bfloat16)
        targs[0] = _t(np.asarray(jargs[0], np.float32)).to(torch.bfloat16)
    with jamp.autocast():
        want = fn(JF, *jargs)
    with amp.autocast():
        got = fn(F, *targs)
    assert _same_dtype(got, want), (got.dtype, want.dtype)
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if got.dtype == torch.bfloat16:
        assert _bf16_close(g, w), np.abs(g - w).max()
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["matmul", "dense", "softmax", "add",
                                  "concatenate", "sum"])
def test_functional_op_outside_autocast_promotes_as_jax(name):
    """Outside autocast the operands run as they are, a bf16/fp32 mix
    promoted to fp32 as numpy promotes it."""
    fn, args = _OPS[name]
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    targs = [_t(a) for a in args]
    targs[0] = _t(np.asarray(jargs[0], np.float32)).to(torch.bfloat16)
    want, got = fn(JF, *jargs), fn(F, *targs)
    assert _same_dtype(got, want), (got.dtype, want.dtype)
    if got.dtype == torch.bfloat16:
        assert _bf16_close(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5)


def test_matmul_out_dtype_is_an_fp32_product_of_rounded_operands():
    rng = np.random.RandomState(1)
    a, b = rng.randn(8, 64).astype(np.float32), rng.randn(64, 16).astype(
        np.float32)
    with jamp.autocast():
        want = JF.matmul(jnp.asarray(a), jnp.asarray(b),
                         preferred_element_type=jnp.float32)
    with amp.autocast():
        got = F.matmul(_t(a), _t(b), out_dtype=torch.float32)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    exact = _t(a).bfloat16().float() @ _t(b).bfloat16().float()
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_disable_casts_decorators_and_banned_bce():
    x = torch.ones(4, 4)
    with amp.autocast():
        assert F.matmul(x, x).dtype == torch.bfloat16
        with amp.disable_casts():
            assert amp.current_policy() is None
            assert F.matmul(x, x).dtype == torch.float32
        assert amp.current_policy().opt_level == "O1"
    assert amp.current_policy() is None
    assert F.matmul(x, x).dtype == torch.float32

    @amp.half_function
    def my_mm(a, b):
        return a @ b

    @amp.float_function
    def my_sum(a):
        return a.sum()

    @amp.promote_function
    def my_add(a, b):
        return a + b

    h = torch.ones(4, dtype=torch.bfloat16)
    with amp.autocast():
        assert my_mm(x, x).dtype == torch.bfloat16
        assert my_sum(h).dtype == torch.float32
        assert my_add(h, torch.ones(4)).dtype == torch.float32
        assert my_add(h, h).dtype == torch.bfloat16
    assert my_mm(x, x).dtype == torch.float32

    class Mod:
        @staticmethod
        def mm(a, b):
            return a @ b

        @staticmethod
        def total(a):
            return a.sum()

        @staticmethod
        def plus(a, b):
            return a + b

    amp.register_half_function(Mod, "mm")
    amp.register_float_function(Mod, "total")
    amp.register_promote_function(Mod, "plus")
    with amp.autocast():
        assert Mod.mm(x, x).dtype == torch.bfloat16
        assert Mod.total(h).dtype == torch.float32
        assert Mod.plus(h, torch.ones(4)).dtype == torch.float32

    p = torch.full((4,), 0.5, dtype=torch.bfloat16)
    with amp.autocast():
        with pytest.raises(RuntimeError, match="with_logits"):
            F.binary_cross_entropy(p, p)
    # outside autocast it computes, as JAX's does
    want = JF.binary_cross_entropy(jnp.full((4,), 0.5), jnp.ones(4))
    got = F.binary_cross_entropy(torch.full((4,), 0.5), torch.ones(4))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_policies_and_autocast_contexts_match_jax():
    o1, jo1 = amp.make_policy("O1"), jamp.make_policy("O1")
    assert (o1.autocast, o1.loss_scale, o1.cast_model_dtype) == (
        jo1.autocast, jo1.loss_scale, jo1.cast_model_dtype)
    assert o1.compute_dtype == torch.bfloat16 == _DT[jo1.compute_dtype]
    assert amp.initialize().policy.opt_level == "O1"
    with pytest.raises(ValueError, match="mutually exclusive"):
        amp.make_policy("O1", cast_model_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="O1 autocast"):
        amp.make_policy("O1", keep_batchnorm_fp32=True)
    amp_ = amp.initialize("O1", cast_model_outputs=torch.float16)
    out = amp_.cast_output({"y": torch.ones(2), "i": torch.ones(2).long()})
    assert out["y"].dtype == torch.float16 and out["i"].dtype == torch.long
    assert amp.initialize("O2").cast_output(torch.ones(2)).dtype == \
        torch.float32
    with amp_.autocast():
        assert amp.current_policy() is amp_.policy
    with amp.initialize("O2").autocast():
        assert amp.current_policy() is None
    with amp.initialize("O1", enabled=False).autocast():
        assert amp.current_policy() is None


def test_maybe_print_rank0_and_warn_once(capsys):
    amp.maybe_print("hello")
    assert "hello" in capsys.readouterr().out
    amp.set_verbosity(0)
    amp.maybe_print("quiet")
    assert capsys.readouterr().out == ""
    amp.set_verbosity(1)
    amp.warn_once("o1-test-key", "once")
    amp.warn_once("o1-test-key", "once")
    assert capsys.readouterr().out == "once\n"


# --- the models under O1 -----------------------------------------------------

def _bf16_products(jaxpr) -> int:
    """bf16-operand dot_general / conv_general_dilated in a jaxpr,
    nested jaxprs (custom VJPs, remat) included."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            n += eqn.invars[0].aval.dtype == jnp.bfloat16
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    n += _bf16_products(getattr(inner, "jaxpr", inner))
    return n


def _port_products() -> dict:
    counts = F.product_counts()
    return {dt: sum(n for (op, d), n in counts.items() if d == dt)
            for dt in ("bfloat16", "float32")}


def _check(got_logits, want_logits, got_loss, want_loss, grads, want,
           names):
    gl, wl = _np(got_logits), _np(want_logits)
    assert np.abs(gl - wl).max() <= 5e-2 * np.abs(wl).max(), \
        np.abs(gl - wl).max()
    assert abs(float(got_loss.detach()) - float(want_loss)) <= 1e-2
    errs = {n: _rel_l2(grads[n], want[n]) for n in names}
    assert max(errs.values()) <= 2e-2, errs


@pytest.fixture(scope="module")
def gpt():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, size=(B, S))
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], axis=1)
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids[:1, :16]))["params"]
    return ids, labels, jax.tree_util.tree_map(np.asarray, params)


def _jax_gpt_o1(ids, labels, params):
    model = JaxGPTLM(JaxConfig.tiny(compute_dtype=jnp.float32))
    amp_ = jamp.initialize("O1")

    def loss(p):
        with amp_.autocast():
            logits, l = model.apply({"params": p}, jnp.asarray(ids),
                                    labels=jnp.asarray(labels))
        return l, logits
    (l, logits), g = jax.value_and_grad(loss, has_aux=True)(params)
    n = _bf16_products(jax.make_jaxpr(lambda p: loss(p)[0])(params).jaxpr)
    return l, logits, from_jax_params(jax.tree_util.tree_map(np.asarray, g)), n


@pytest.fixture(scope="module")
def gpt_jax_o1(gpt):
    return _jax_gpt_o1(*gpt)


@pytest.mark.parametrize("remat", ["none", "full_block"])
def test_gpt_o1_matches_jax_o1(gpt, gpt_jax_o1, remat):
    """fp32 parameters, bf16 products: flash attention takes bf16 q, k,
    v, LayerNorm takes the fp32 residual stream, and the head's fp32
    logits feed the loss.  ``full_block`` recomputes each block in the
    backward, outside the ``autocast`` block, under the forward's
    policy."""
    ids, labels, params = gpt
    jl, jlogits, want, jn = gpt_jax_o1
    amp_ = amp.initialize("O1")
    model = GPTLM(GPTConfig.tiny(compute_dtype=torch.float32,
                                 remat_policy=remat))
    model.load_state_dict(from_jax_params(params))
    opt = amp.AmpOptimizer(fused_adam(1e-3), amp_)
    masters = opt.attach(model)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(torch.equal(masters[n], p) for n, p in model.named_parameters())
    F.reset_product_counts()
    with amp_.autocast():
        logits, loss = model(_t(ids), _t(labels))
    counts = _port_products()
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    assert logits.dtype == torch.float32
    _check(logits, jlogits, loss, jl, grads, want, names)
    # four Dense products a layer and the head, all on bf16 operands, as
    # in JAX's jaxpr (its attention reference computes in fp32)
    assert counts == {"bfloat16": 4 * 2 + 1, "float32": 0}, counts
    assert jn == counts["bfloat16"], jn


def test_bert_o1_matches_jax_o1():
    """Padded BERT tiny: the MHA projections through ``F.dense`` give
    flash attention bf16 q, k, v beside the fp32 padding bias."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, size=(B, S))
    mask = (np.arange(S)[None, :] < np.array([128, 90])[:, None]).astype(
        np.int32)
    labels = np.where((rng.rand(B, S) < 0.15) & (mask == 1), ids, -100)
    cfg = JaxBertConfig.tiny(compute_dtype=jnp.float32)
    jmodel = JaxBert(cfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids[:1, :16]),
                         attention_mask=jnp.ones((1, 16)))["params"]
    amp_j = jamp.initialize("O1")

    def jloss(p):
        with amp_j.autocast():
            logits, l = jmodel.apply({"params": p}, jnp.asarray(ids),
                                     labels=jnp.asarray(labels),
                                     attention_mask=jnp.asarray(mask),
                                     deterministic=True)
        return l, logits
    (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    want = from_jax_bert_params(jax.tree_util.tree_map(np.asarray, jg))
    amp_ = amp.initialize("O1")
    model = BertForMLM(BertConfig.tiny(compute_dtype=torch.float32))
    model.load_state_dict(from_jax_bert_params(
        jax.tree_util.tree_map(np.asarray, params)))
    F.reset_product_counts()
    with amp_.autocast():
        logits, loss = model(_t(ids), _t(labels), attention_mask=_t(mask))
    counts = _port_products()
    names, ps = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    _check(logits, jlogits, loss, jl, grads, want, names)
    # per layer the qkv and output projections and the FFN's two, then
    # the MLM transform and the tied decoder
    assert counts == {"bfloat16": 4 * 2 + 2, "float32": 0}, counts


def _rn_perturb(tree, rng):
    """Random BatchNorm affines (flax inits them to 1 / 0)."""
    if isinstance(tree, dict):
        return {k: _rn_perturb(v, rng) if isinstance(v, dict)
                else (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
                if k == "scale" else (0.1 * rng.randn(*v.shape)).astype(
                    np.float32) if k == "bias" else np.asarray(v)
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def rn():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, size=(4,))
    variables = jax.jit(JaxResNet(**RN).init)(jax.random.PRNGKey(0),
                                              jnp.asarray(x[:1]))
    params = _rn_perturb(variables["params"], np.random.RandomState(1))
    bstats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return x, y, params, bstats


def _jax_rn(x, y, params, bstats, train):
    """JAX's O1 op by op: each bf16 result rounded as the port rounds it
    (under jit XLA would fuse the bf16 chains in fp32); in training mode
    also the count of bf16 products in its jaxpr."""
    model = JaxResNet(**RN, compute_dtype=jnp.float32)
    amp_ = jamp.initialize("O1")

    def loss(p):
        with amp_.autocast():
            out = model.apply({"params": p, "batch_stats": bstats},
                              jnp.asarray(x), train=train,
                              mutable=["batch_stats"] if train else False)
        logits, upd = out if train else (out, {"batch_stats": bstats})
        return (jnp.mean(jax_xent(logits, jnp.asarray(y))),
                (logits, upd["batch_stats"]))
    (l, (logits, stats)), g = jax.value_and_grad(loss, has_aux=True)(params)
    n = (_bf16_products(jax.make_jaxpr(lambda p: loss(p)[0])(params).jaxpr)
         if train else None)
    want, _ = from_jax_resnet_params(jax.tree_util.tree_map(np.asarray, g),
                                     bstats)
    return l, logits, want, n, jax.tree_util.tree_map(np.asarray, stats)


def _port_rn(x, y, params, bstats, train, level="O1"):
    model = ResNet(**RN, compute_dtype=torch.float32)
    state, stats = from_jax_resnet_params(params, bstats)
    model.load_state_dict(state)
    amp_ = amp.initialize(level)
    F.reset_product_counts()
    with amp_.autocast():
        logits, _ = model(_t(x), stats, train=train)
        loss = softmax_cross_entropy(logits, _t(y)).mean()
    counts = _port_products()
    names, ps = zip(*model.named_parameters())
    return loss, logits, dict(zip(names, torch.autograd.grad(loss, ps))), \
        counts


def test_resnet_o1_matches_jax_o1(rn):
    """The narrow ResNet of ``test_torch_resnet.py``: every convolution
    (the space-to-depth stem's included) and the classifier as bf16
    products over fp32 parameters; bf16 logits, as JAX's.  Gradients
    within 2e-2 relative L2 with eval-mode BatchNorm (the running
    statistics after JAX's step).  With batch statistics this small
    model's bf16 gradient is mostly bf16 rounding, as the O2 test of
    ``test_torch_resnet.py`` finds: there each gradient must stay as
    close to the fp32 one (the port's O0, which matches JAX's within
    1e-4) as JAX's O1 gradient is: the median over parameters of the
    ratio of the two distances within [0.9, 1.1], as in the O2 test, and
    each ratio within [0.5, 2.5], a port that skipped a bf16 rounding
    (ratio near 0) failing.  The O2 test's per-leaf 1.6 does not hold
    here: the stem's BatchNorm bias measured 2.05, its JAX O1 gradient
    4.9 % from fp32 and the port's 10 % (0.85-1.33 at every other
    leaf, median 1.01)."""
    x, y, params, bstats = rn
    jl, jlogits, want, jn, jstats = _jax_rn(x, y, params, bstats, True)
    _, _, want32, _ = _port_rn(x, y, params, bstats, True, level="O0")
    loss, logits, grads, counts = _port_rn(x, y, params, bstats, True)
    assert logits.dtype == torch.bfloat16 and jlogits.dtype == jnp.bfloat16
    gl, wl = _np(logits), _np(jlogits)
    assert np.abs(gl - wl).max() <= 5e-2 * np.abs(wl).max()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-2
    ratios = {n: _rel_l2(g, want32[n]) / _rel_l2(want[n], want32[n])
              for n, g in grads.items()}
    assert 0.9 <= np.median(list(ratios.values())) <= 1.1, ratios
    assert 0.5 <= min(ratios.values()) and max(ratios.values()) <= 2.5, \
        ratios
    # stem + 4 blocks x (3 convolutions + the projection) + classifier
    assert counts == {"bfloat16": 1 + 4 * 4 + 1, "float32": 0}, counts
    assert jn == counts["bfloat16"], jn
    jl, jlogits, want, _, _ = _jax_rn(x, y, params, jstats, False)
    loss, logits, grads, _ = _port_rn(x, y, params, jstats, False)
    _check(logits, jlogits, loss, jl, grads, want, list(grads))


@pytest.mark.parametrize("level", ["O0", "O2", "O3"])
def test_autocast_is_a_no_op_outside_o1(gpt, level):
    """Under O0, O2 and O3 ``amp_.autocast()`` is a null context and the
    models' routes through the tables leave every product as it was:
    logits bit for bit the same inside and outside it."""
    ids, labels, params = gpt
    amp_ = amp.initialize(level)
    torch.manual_seed(0)
    x = torch.randn(2, 16, 16, 3)
    for make in ("gpt", "bert", "resnet"):
        if make == "gpt":
            model = GPTLM(GPTConfig.tiny(
                compute_dtype=amp_.policy.compute_dtype))
            model.load_state_dict(from_jax_params(params))
            run = lambda m: m(_t(ids), _t(labels))[0]  # noqa: E731
        elif make == "bert":
            model = BertForMLM(BertConfig.tiny(
                compute_dtype=amp_.policy.compute_dtype))
            for p in model.parameters():
                torch.nn.init.normal_(p, std=0.05)
            run = lambda m: m(_t(ids))  # noqa: E731
        else:
            model = ResNet(**RN, compute_dtype=amp_.policy.compute_dtype)
            for p in model.parameters():
                torch.nn.init.normal_(p, std=0.1)
            stats = model.init_batch_stats("cpu")
            run = lambda m: m(x, stats, train=True)[0]  # noqa: E731
        amp.AmpOptimizer(fused_adam(1e-3), amp_).attach(model)
        plain = run(model)
        with amp_.autocast():
            inside = run(model)
        assert torch.equal(plain, inside), (level, make)


def test_o1_decoder_stores_a_bf16_cache(gpt):
    _, _, params = gpt
    policy = amp.make_policy("O1")
    jpolicy = jamp.make_policy("O1")
    assert policy.cache_dtype == torch.bfloat16 == _DT[jpolicy.cache_dtype]
    dec = GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32),
                     from_jax_params(params), policy=policy, device="cpu")
    assert dec.cache_dtype == torch.bfloat16
    assert dec.init_cache(2, 32).k.dtype == torch.bfloat16
