"""apex_tpu_torch's ``bf16_utils`` vs the JAX package's, on the CPU.

Over a parameter map with a dense layer, a BatchNorm and an integer
leaf: each conversion helper's dtypes leaf by leaf equal to JAX's over
the same tree; ``prep_param_lists``/``master_params_to_model_params``
(nested and ``flat_master``) and ``model_grads_to_master_grads`` equal
JAX's values exactly (pure casts and copies); ``clip_grad_norm`` within
1e-6 relative; the legacy scalers' trajectories (static, and the dynamic
one's 2^32 start, halving and growth after 1000 clean steps) exactly
JAX's; ``BF16_Optimizer`` over ``fused_adam`` (and over plain SGD with
clipping) for five steps with the dynamic scaler, the third step's grads
overflowing: the masters within 1e-5 relative L2 of JAX's, the skipped
step keeping masters and state bit for bit, the scaler state exactly
JAX's, the model params bf16; its ``state_dict`` round trip exact.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import bf16_utils as JU
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu_torch import bf16_utils as U
from apex_tpu_torch.optimizers import Transformation, fused_adam


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"Dense_0": {"kernel": rng.randn(8, 4).astype(np.float32),
                        "bias": rng.randn(4).astype(np.float32)},
            "BatchNorm_0": {"scale": np.ones(4, np.float32),
                            "bias": np.zeros(4, np.float32)},
            "step": np.int32(3)}


_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


def _flat(tree, pre=""):
    """A nested tree (numpy or JAX leaves) as the port's name -> tensor
    map, each leaf in its own dtype."""
    out = {}
    for k, v in tree.items():
        name = f"{pre}.{k}" if pre else k
        if isinstance(v, dict):
            out.update(_flat(v, name))
        else:
            v = jnp.asarray(v)
            out[name] = torch.tensor(np.asarray(v.astype(jnp.float32))).to(
                _TORCH_DTYPE[str(v.dtype)])
    return out


def _dtypes(flat):
    return {k: str(v.dtype).replace("torch.", "") for k, v in flat.items()}


def _jdtypes(tree):
    return _dtypes(_flat(tree))


@pytest.mark.parametrize("fn", ["tobf16", "network_to_bf16",
                                "bn_convert_float"])
def test_conversions_cast_as_jax_does(fn):
    p = _params()
    jp = {k: (jnp.asarray(v) if not isinstance(v, dict) else
              {n: jnp.asarray(x) for n, x in v.items()}) for k, v in p.items()}
    if fn == "bn_convert_float":
        got, want = U.bn_convert_float(U.tobf16(_flat(p))), \
            JU.bn_convert_float(JU.tobf16(jp))
    else:
        got, want = getattr(U, fn)(_flat(p)), getattr(JU, fn)(jp)
    assert _dtypes(got) == _jdtypes(want)
    assert _dtypes(U.convert_network(_flat(p), torch.bfloat16)) \
        == _jdtypes(JU.convert_network(jp, jnp.bfloat16))


def test_bf16_model_casts_float_inputs_only():
    seen = {}

    def fwd(x, ids):
        seen["x"], seen["ids"] = x.dtype, ids.dtype
        return x

    U.bf16_model(fwd)(torch.ones(2, 3), torch.ones(2, dtype=torch.long))
    assert seen == {"x": torch.bfloat16, "ids": torch.long}


@pytest.mark.parametrize("flat_master", [False, True])
def test_param_lists_match_jax(flat_master):
    rng = np.random.RandomState(1)
    tree = {"a": rng.randn(3, 2).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}
    jmodel = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in tree.items()}
    model = {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in tree.items()}
    _, jm = JU.prep_param_lists(jmodel, flat_master=flat_master)
    _, m = U.prep_param_lists(model, flat_master=flat_master)
    if flat_master:
        assert m.shape == (11,) and m.dtype == torch.float32
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        jm, m = jm + 1.0, m + 1.0
    else:
        assert all(v.dtype == torch.float32 for v in m.values())
        jm = {k: v + 1.0 for k, v in jm.items()}
        m = {k: v + 1.0 for k, v in m.items()}
    jback = JU.master_params_to_model_params(jmodel, jm, flat_master)
    back = U.master_params_to_model_params(model, m, flat_master)
    for k in tree:
        assert back[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            back[k].float().numpy(), np.asarray(jback[k], np.float32))
    g = U.model_grads_to_master_grads(model, flat_master)
    jg = JU.model_grads_to_master_grads(jmodel, flat_master)
    if flat_master:
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    else:
        for k in tree:
            assert g[k].dtype == torch.float32
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(jg[k]))


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_grad_norm_matches_jax(max_norm):
    g = {"w": np.full(4, 3.0, np.float32), "v": np.full(9, 4.0, np.float32)}
    clipped, norm = U.clip_grad_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
    jclipped, jnorm = JU.clip_grad_norm({k: jnp.asarray(v)
                                         for k, v in g.items()}, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]),
                                   rtol=1e-6)
    assert U.to_python_float(norm) == pytest.approx(np.sqrt(180.0))


@pytest.mark.parametrize("which", ["static", "dynamic"])
def test_legacy_scalers_follow_jax(which):
    s, js = ((U.LossScaler(128.0), JU.LossScaler(128.0)) if which == "static"
             else (U.DynamicLossScaler(), JU.DynamicLossScaler()))
    st, jst = s.init("cpu"), js.init()
    flags = [True] + [False] * 1000 + [True, True]
    for f in flags:
        st = s.update(st, torch.tensor(f))
        jst = js.update(jst, jnp.bool_(f))
        assert (float(st.loss_scale), int(st.unskipped), int(st.overflows)) \
            == (float(jst.loss_scale), int(jst.unskipped),
                int(jst.overflows))
    if which == "dynamic":
        assert float(U.DynamicLossScaler().init("cpu").loss_scale) == 2.0 ** 32


OPTIMIZERS = {
    "fused_adam": (lambda: fused_adam(1e-2, weight_decay=1e-2),
                   lambda: jax_fused_adam(1e-2, weight_decay=1e-2), {}),
    "sgd_clip": (lambda: Transformation(
                     lambda p: {},
                     lambda g, s, p: ({k: -0.5 * v for k, v in g.items()},
                                      s)),
                 lambda: optax.sgd(0.5), dict(clip_master_grads=0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_bf16_optimizer_five_steps_match_jax(name):
    make, jmake, kw = OPTIMIZERS[name]
    rng = np.random.RandomState(2)
    tree = {"w": rng.randn(16, 8).astype(np.float32),
            "b": rng.randn(8).astype(np.float32)}
    jopt = JU.BF16_Optimizer(jmake(), dynamic_loss_scale=True, **kw)
    opt = U.BF16_Optimizer(make(), dynamic_loss_scale=True, **kw)
    jmodel = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in tree.items()}
    model = {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in tree.items()}
    jstate, state = jopt.init(jmodel), opt.init(model)
    for i in range(5):
        loss = torch.tensor(2.0)
        assert float(opt.scale_loss(loss, state)) == 2.0 * float(
            state.scaler.loss_scale)
        g = {k: (rng.randn(*v.shape) * float(state.scaler.loss_scale))
             .astype(np.float32) for k, v in tree.items()}
        if i == 2:
            g["w"][3, 1] = np.inf
        kept = {k: v.clone() for k, v in state.master.items()}
        jmodel, jstate = jopt.step({k: jnp.asarray(v).astype(jnp.bfloat16)
                                    for k, v in g.items()}, jstate, jmodel)
        model, state = opt.step({k: torch.from_numpy(v).to(torch.bfloat16)
                                 for k, v in g.items()}, state, model)
        sc, jsc = state.scaler, jstate.scaler
        assert (float(sc.loss_scale), int(sc.unskipped), int(sc.overflows)) \
            == (float(jsc.loss_scale), int(jsc.unskipped),
                int(jsc.overflows))
        if i == 2:
            assert all(torch.equal(state.master[k], kept[k]) for k in kept)
        assert all(v.dtype == torch.bfloat16 for v in model.values())
    for k in tree:
        move = state.master[k].numpy() - tree[k]
        want = np.asarray(jstate.master[k]) - tree[k]
        assert np.linalg.norm(move - want) <= 1e-5 * np.linalg.norm(want), k
    fresh = opt.init(model)
    restored = opt.load_state_dict(opt.state_dict(state), fresh)
    assert all(torch.equal(restored.master[k], state.master[k])
               for k in state.master)
    assert float(restored.scaler.loss_scale) == float(state.scaler.loss_scale)
    if name == "fused_adam":
        assert torch.equal(restored.inner.m["w"], state.inner.m["w"])
        assert int(restored.inner.step) == int(state.inner.step) == 4
