"""apex_tpu_torch's rematerialization policies (``apex_tpu_torch.remat``)
on GPT and BERT, on the CPU.

- Every policy (``dots_saveable``, ``full_block``) gives the loss and the
  grads of ``none`` bit for bit, at fp32 with dropout on, on
  ``GPTConfig.tiny`` and ``BertConfig.tiny`` (a padded batch): the
  recompute runs the same operations on the same values, and replays the
  explicit dropout generator, so it draws the same masks and seeds.
- The generator ends where the unwrapped forward leaves it.
- Without the replay the recompute draws other masks and the grads come
  out different (the trap the replay is there for).
- Each policy matches the JAX model with the same ``remat_policy``
  (deterministic, fp32, the same flax weights) within 1e-4: the loss in
  rtol and every grad of its tensor's largest magnitude.
- An unknown policy raises; ``none`` is the identity.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForMLM as JaxBert
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.models.gpt import GPTLM as JaxGPT
from apex_tpu_torch import remat
from apex_tpu_torch.models import BertConfig, BertForMLM, GPTConfig, GPTLM
from apex_tpu_torch.weights import from_jax_bert_params, from_jax_params

B, S = 2, 128
POLICIES = ("dots_saveable", "full_block")


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
    mask = (np.arange(S)[None, :] < np.array([S, 90])[:, None]).astype(
        np.int32)
    gpt = JaxGPT(JaxGPTConfig.tiny(compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.asarray(ids[:1, :16]))["params"]
    bert = JaxBert(JaxBertConfig.tiny(compute_dtype=jnp.float32)).init(
        jax.random.PRNGKey(1), jnp.asarray(ids[:1, :16]),
        attention_mask=jnp.ones((1, 16)))["params"]
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return ids, labels, mask, to_np(gpt), to_np(bert)


def _model(kind, data, policy):
    if kind == "gpt":
        m = GPTLM(GPTConfig.tiny(compute_dtype=torch.float32,
                                 remat_policy=policy))
        m.load_state_dict(from_jax_params(data[3]))
    else:
        m = BertForMLM(BertConfig.tiny(compute_dtype=torch.float32,
                                       remat_policy=policy))
        m.load_state_dict(from_jax_bert_params(data[4]))
    return m


def _run(kind, data, policy, deterministic=False):
    """Loss, grads (by name) and the generator's end state of one forward
    and backward."""
    ids, labels, mask = (torch.from_numpy(a) for a in data[:3])
    model = _model(kind, data, policy)
    gen = torch.Generator().manual_seed(11)
    kw = dict(deterministic=deterministic, generator=gen)
    if kind == "bert":
        kw["attention_mask"] = mask
    _, loss = model(ids, labels, **kw)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, ps)
    return loss.detach(), dict(zip(names, grads)), gen.get_state()


@pytest.fixture(scope="module")
def unwrapped(data):
    return {kind: _run(kind, data, "none") for kind in ("gpt", "bert")}


@pytest.mark.parametrize("kind", ["gpt", "bert"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_is_bitwise_none_with_dropout(kind, policy, data, unwrapped):
    loss, grads, state = _run(kind, data, policy)
    want_loss, want, want_state = unwrapped[kind]
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        assert torch.equal(g, want[name]), name
    # the generator ends where the unwrapped forward left it
    assert torch.equal(state, want_state)


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_recompute_without_the_replay_draws_other_masks(kind, data,
                                                        unwrapped,
                                                        monkeypatch):
    class _NoReplay:
        def __init__(self, fn, generator):
            self.fn = fn

        def __call__(self, *args):
            return self.fn(*args)

    monkeypatch.setattr(remat, "_Replay", _NoReplay)
    loss, grads, _ = _run(kind, data, "full_block")
    want_loss, want, _ = unwrapped[kind]
    assert torch.equal(loss, want_loss)  # the forward itself is the same
    assert not all(torch.equal(g, want[n]) for n, g in grads.items())


def _jax_grads(kind, data, policy):
    ids, labels, mask, gpt, bert = data
    if kind == "gpt":
        model = JaxGPT(JaxGPTConfig.tiny(compute_dtype=jnp.float32,
                                         remat_policy=policy))
        params, convert = gpt, from_jax_params
        kw = {}
    else:
        model = JaxBert(JaxBertConfig.tiny(compute_dtype=jnp.float32,
                                           remat_policy=policy))
        params, convert = bert, from_jax_bert_params
        kw = {"attention_mask": jnp.asarray(mask)}

    def loss(p):
        return model.apply({"params": p}, jnp.asarray(ids),
                           labels=jnp.asarray(labels), deterministic=True,
                           **kw)[1]

    jl, jg = jax.value_and_grad(loss)(params)
    return float(jl), convert(jax.tree_util.tree_map(np.asarray, jg))


@pytest.mark.parametrize("kind", ["gpt", "bert"])
@pytest.mark.parametrize("policy", ("none",) + POLICIES)
def test_policy_matches_jax_remat_policy(kind, policy, data):
    loss, grads, _ = _run(kind, data, policy, deterministic=True)
    want_loss, want = _jax_grads(kind, data, policy)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for name, g in grads.items():
        w = want[name].numpy()
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)


def test_unknown_policy_raises_and_none_is_the_identity():
    with pytest.raises(ValueError, match="remat_policy"):
        remat.checkpoint_policy("dots")
    with pytest.raises(ValueError, match="remat_policy"):
        GPTConfig.tiny(remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        BertConfig.tiny(remat_policy="full")
    assert remat.checkpoint_policy("none") is None
    assert remat.checkpoint_policy(None) is None
    assert remat.REMAT_POLICIES == ("none", "dots_saveable", "full_block")
    calls = []
    out = remat.remat_call(lambda x: calls.append(x) or x + 1, "none",
                           torch.ones(2))
    assert calls and torch.equal(out, torch.full((2,), 2.0))
