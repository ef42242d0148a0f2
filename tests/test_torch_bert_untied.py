"""apex_tpu_torch's BERT token types and untied MLM head vs the JAX
package, on the CPU.

``BertConfig.tiny`` (2 layers, hidden 128, 2 heads of 64, S = 128) at
fp32 with flax-initialised weights (LayerNorm affines and biases
perturbed so they matter), numpy-seeded tokens, a padding mask (lengths
128 and 90) and MLM labels on 15 % of the valid positions, at
``deterministic=True`` (flax's dropout bits cannot be reproduced).
Tolerances:

- ``BertForMLM(tie_word_embeddings=False)`` (the untied ``mlm_head``):
  logits within 1e-4, the loss within rtol 1e-4, every gradient within
  1e-4 of its tensor's largest magnitude, against JAX's jnp references
  and its Pallas kernels in interpret mode;
- ``BertEncoder`` called with ``token_type_ids`` (two types): the hidden
  states within 1e-4 and every gradient (the token-type table's among
  them) within 1e-4 of its largest magnitude;
- the ``BertForMLM`` trees, tied and untied, convert from flax to the
  port's exact key set and back to flax's, with no token-type table;
  ``BertForMLM``'s encoder refuses ``token_type_ids``, as its flax tree
  has no table to look them up in.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.bert import BertConfig as JaxConfig
from apex_tpu.models.bert import BertEncoder as JaxEncoder
from apex_tpu.models.bert import BertForMLM as JaxBert
from apex_tpu.ops._common import force_pallas
from apex_tpu_torch.models import BertConfig, BertEncoder, BertForMLM
from apex_tpu_torch.weights import from_jax_bert_params, to_jax_bert_params

B, S, V = 2, 128, 1024
LENGTHS = (128, 90)


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, size=(B, S))
    mask = (np.arange(S)[None, :] < np.array(LENGTHS)[:, None]).astype(
        np.int32)
    picked = (rng.rand(B, S) < 0.15) & (mask == 1)
    labels = np.where(picked, ids, -100)
    types = (np.arange(S)[None, :] >= np.array([64, 40])[:, None]).astype(
        np.int32)
    return np.where(picked, 3, ids), labels, mask, types


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k == "scale":
            out[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k in ("bias", "mlm_bias"):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _flat_keys(tree, pre=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _flat_keys(v, pre + (k,))
        else:
            out.add(pre + (k,))
    return out


def _mlm_params(tied):
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, tie_word_embeddings=tied)
    ids = jnp.zeros((1, 16), jnp.int32)
    return cfg, JaxBert(cfg).init(jax.random.PRNGKey(0), ids,
                                  attention_mask=jnp.ones((1, 16)))["params"]


def _grads_within(model, want, rtol=1e-4):
    names = set()
    for name, p in model.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= rtol, (name, err)
        names.add(name)
    assert names == set(want)


@pytest.mark.parametrize("force", [None, True])
def test_untied_mlm_logits_loss_and_grads_match_jax(force):
    ids, labels, mask, _ = _batch()
    cfg, params = _mlm_params(tied=False)
    params = _perturb(params, np.random.RandomState(1))
    jmodel = JaxBert(cfg)

    def jloss(p):
        logits, loss = jmodel.apply({"params": p}, jnp.asarray(ids),
                                    labels=jnp.asarray(labels),
                                    attention_mask=jnp.asarray(mask))
        return loss, logits

    with force_pallas(force):
        (jl, jlogits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = BertForMLM(BertConfig.tiny(compute_dtype=torch.float32,
                                       tie_word_embeddings=False))
    model.load_state_dict(from_jax_bert_params(params))
    logits, loss = model(_t(ids), _t(labels), attention_mask=_t(mask))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    loss.backward()
    _grads_within(model, from_jax_bert_params(
        jax.tree_util.tree_map(np.asarray, jg)))


def test_encoder_with_token_types_matches_jax():
    ids, _, mask, types = _batch(3)
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32)
    jenc = JaxEncoder(cfg)
    params = jenc.init(jax.random.PRNGKey(5), jnp.asarray(ids[:1, :16]),
                       token_type_ids=jnp.asarray(types[:1, :16]))["params"]
    assert "token_type_embeddings" in params
    params = _perturb(params, np.random.RandomState(6))
    cot = np.random.RandomState(7).randn(B, S, 128).astype(np.float32)

    def jloss(p):
        x = jenc.apply({"params": p}, jnp.asarray(ids),
                       token_type_ids=jnp.asarray(types),
                       attention_mask=jnp.asarray(mask))
        return jnp.sum(x * jnp.asarray(cot)), x

    (_, jx), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    enc = BertEncoder(BertConfig.tiny(compute_dtype=torch.float32))
    enc.load_state_dict(from_jax_bert_params(params))
    x = enc(_t(ids), token_type_ids=_t(types), attention_mask=_t(mask))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=1e-4)
    (x * _t(cot)).sum().backward()
    _grads_within(enc, from_jax_bert_params(
        jax.tree_util.tree_map(np.asarray, jg)))
    # the types matter: the same ids without them differ
    plain = enc(_t(ids), attention_mask=_t(mask))
    assert not torch.allclose(plain, x)


@pytest.mark.parametrize("tied", [True, False])
def test_mlm_tree_converts_both_ways_without_a_token_type_table(tied):
    _, params = _mlm_params(tied)
    state = from_jax_bert_params(params)
    model = BertForMLM(BertConfig.tiny(compute_dtype=torch.float32,
                                       tie_word_embeddings=tied))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict
    assert not any("token_type" in k for k in state)
    assert ("mlm_bias" in state) == tied
    assert ("mlm_head.kernel" in state) == (not tied)
    back = to_jax_bert_params(model.state_dict())
    assert _flat_keys(back) == _flat_keys(params)
    np.testing.assert_array_equal(
        back["encoder"]["layer_1"]["attn_ln"]["scale"],
        np.asarray(params["encoder"]["layer_1"]["attn_ln"]["scale"]))
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="token_type"):
        model.encoder(ids, token_type_ids=ids)


def test_untied_mapping_raises_on_unknown_head_keys():
    _, params = _mlm_params(tied=False)
    bad = dict(params, mlm_head=dict(params["mlm_head"], scale=0))
    with pytest.raises(ValueError, match="scale"):
        from_jax_bert_params(bad)
