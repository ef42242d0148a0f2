"""apex_tpu_torch's ``EncdecMultiheadAttn`` vs the JAX package's, on the
CPU.

Cross-attention at fp32 from a 128-token decoder query to a 256-token
encoder output (h 128, 2 heads of 64; Sq != Sk, the flash kernels' bias
path with a (B, Sq, Sk) bias), with flax-initialised weights (biases and
the LayerNorm affine perturbed so they matter) carried over by
``weights._mha_state``, both impls, with and without the projection
biases and the pre-LN norm-add variant, under a boolean key-padding
mask (encoder lengths 256 and 170), a time mask or none.  JAX runs its
Pallas kernels in interpret mode and its jnp references
(``force_pallas`` True and None).  Tolerances: the output within 1e-5,
every parameter gradient and the query's and key's gradients within
1e-4 of the largest gradient magnitude of their kind.  Also: ``fast``
against ``default`` in the port, ``value`` ignored, the constructor's
and the masks' refusals, dropout needing a generator and reproducible
from its seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib.multihead_attn import EncdecMultiheadAttn as JaxEncdec
from apex_tpu.ops._common import force_pallas
from apex_tpu_torch.contrib.multihead_attn import EncdecMultiheadAttn
from apex_tpu_torch.weights import _mha_state

B, SQ, SK, H, NH = 2, 128, 256, 128, 2
KEY_LENGTHS = (256, 170)
CASES = {
    "fast_bias_padding": (dict(impl="fast", bias=True), "padding"),
    "default_bias_padding": (dict(impl="default", bias=True), "padding"),
    "fast_time_mask": (dict(impl="fast"), "time"),
    "default_no_mask": (dict(impl="default"), None),
    "fast_norm_add_padding": (dict(impl="fast", bias=True,
                                   include_norm_add=True), "padding"),
    "default_norm_add": (dict(impl="default", include_norm_add=True), None),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _perturb(tree, rng):
    """Random biases and LayerNorm affine (flax inits them to 0 / 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif "bias" in k or k == "scale":
            out[k] = (float(k == "scale") + 0.1 * rng.randn(*v.shape)
                      ).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _masks(kind):
    pad = np.arange(SK)[None, :] >= np.array(KEY_LENGTHS)[:, None]
    return {"padding": dict(key_padding_mask=pad.astype(np.int32)),
            "time": dict(attn_mask=np.triu(np.ones((SQ, SK), np.int32), 1)),
            None: {}}[kind]


def _inputs(seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, SQ, H).astype(np.float32),
            rng.randn(B, SK, H).astype(np.float32),
            rng.randn(B, SQ, H).astype(np.float32))


def _close_to_top(got, want, rtol):
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= rtol * top, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_encdec_multihead_attn_matches_jax(case):
    kw, mask_kind = CASES[case]
    q, k, cot = _inputs()
    masks = _masks(mask_kind)
    jmod = JaxEncdec(embed_dim=H, num_heads=NH, **kw)
    jparams = jmod.init(jax.random.PRNGKey(3), jnp.asarray(q), jnp.asarray(k),
                        is_training=False)["params"]
    jparams = _perturb(jparams, np.random.RandomState(4))
    jmask = {n: jnp.asarray(v) for n, v in masks.items()}

    def jloss(p, q, k):
        out = jmod.apply({"params": p}, q, k, is_training=False, **jmask)
        return jnp.sum(out * jnp.asarray(cot)), out

    mod = EncdecMultiheadAttn(H, NH, **kw)
    mod.load_state_dict(_mha_state(jparams, ""))
    tq, tk = _t(q).requires_grad_(), _t(k).requires_grad_()
    out = mod(tq, tk, is_training=False,
              **{n: _t(v) for n, v in masks.items()})
    (out * _t(cot)).sum().backward()
    got = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    for force in (True, None):
        with force_pallas(force):
            (_, jout), (jg, jdq, jdk) = jax.value_and_grad(
                jloss, argnums=(0, 1, 2), has_aux=True)(
                    jparams, jnp.asarray(q), jnp.asarray(k))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=0, atol=1e-5)
        want = {n: v.numpy() for n, v in _mha_state(
            jax.tree_util.tree_map(np.asarray, jg), "").items()}
        assert set(want) == set(got)
        # the k bias has a zero gradient (softmax ignores a per-row
        # constant): hold every grad to the module's largest
        _close_to_top(got, want, 1e-4)
        _close_to_top({"q": tq.grad.numpy(), "k": tk.grad.numpy()},
                      {"q": np.asarray(jdq), "k": np.asarray(jdk)}, 1e-4)


def test_fast_matches_default_and_value_is_ignored():
    q, k, _ = _inputs(11)
    torch.manual_seed(0)
    fast = EncdecMultiheadAttn(H, NH, bias=True, impl="fast")
    default = EncdecMultiheadAttn(H, NH, bias=True, impl="default")
    default.load_state_dict(fast.state_dict())
    mask = _t(_masks("padding")["key_padding_mask"])
    a = fast(_t(q), _t(k), value=torch.zeros(1), key_padding_mask=mask,
             is_training=False)
    b = default(_t(q), _t(k), key_padding_mask=mask, is_training=False)
    assert a.shape == (B, SQ, H)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_encdec_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="divisible"):
        EncdecMultiheadAttn(130, 4)
    with pytest.raises(ValueError, match="impl"):
        EncdecMultiheadAttn(H, NH, impl="fastest")
    mod = EncdecMultiheadAttn(H, NH, dropout=0.1)
    q, k = torch.zeros(1, 8, H), torch.zeros(1, 16, H)
    with pytest.raises(ValueError, match="both"):
        mod(q, k, key_padding_mask=torch.zeros(1, 16),
            attn_mask=torch.zeros(8, 16), is_training=False)
    with pytest.raises(ValueError, match="Generator"):
        mod(q, k, is_training=True)


@pytest.mark.parametrize("impl", ["fast", "default"])
def test_dropout_follows_the_generator(impl):
    q, k, _ = _inputs(13)
    mod = EncdecMultiheadAttn(H, NH, dropout=0.5, impl=impl,
                              include_norm_add=True)
    runs = [mod(_t(q), _t(k), generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    det = mod(_t(q), _t(k), is_training=False)
    assert not torch.equal(runs[0], det)
