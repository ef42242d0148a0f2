"""apex_tpu_torch's ``mlp``/``MLP`` vs the JAX package's, on the CPU.

The whole-MLP chain (``mlp_sizes`` [64, 128, 32], batch 16) with
numpy-seeded fp32 inputs, weights and biases, for each activation
(``relu``, ``sigmoid``, ``none``: after every layer, the last one
included), with and without biases, under each remat policy (``none``,
``dots_saveable``, ``full_block``, and the legacy ``remat=True``):
output within 1e-5 and the input's and parameters' gradients within
1e-5 of their largest magnitude of JAX's ``ops.mlp.mlp``; every policy's
gradients bit for bit ``none``'s.  The ``MLP`` module with the flax
module's parameters: output within 1e-5 at fp32, and under O1
autocast bf16 within 5e-2 of the largest magnitude of JAX's autocast
output, both sides returning bf16.  Also the refusals (a flag with a
policy, an unknown policy or activation, fewer than two sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.mlp import MLP as JaxMLP
from apex_tpu.ops.mlp import mlp as jax_mlp
from apex_tpu_torch import amp
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.ops.mlp import mlp, mlp_ref

SIZES = [64, 128, 32]
POLICIES = [dict(remat_policy="none"), dict(remat_policy="dots_saveable"),
            dict(remat_policy="full_block"), dict(remat=True)]


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(16, SIZES[0]).astype(np.float32)
    ws = [(0.1 * rng.randn(a, b)).astype(np.float32)
          for a, b in zip(SIZES[:-1], SIZES[1:])]
    bs = [rng.randn(b).astype(np.float32) for b in SIZES[1:]]
    cot = rng.randn(16, SIZES[-1]).astype(np.float32)
    return x, ws, bs, cot


def _within(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    assert np.abs(np.asarray(got, np.float32) - want).max() \
        <= rtol * np.abs(want).max()


def _port_grads(x, ws, bs, cot, activation, **kw):
    tx = torch.from_numpy(x).requires_grad_()
    tw = [torch.from_numpy(w).requires_grad_() for w in ws]
    tb = None if bs is None else [torch.from_numpy(b).requires_grad_()
                                  for b in bs]
    out = mlp(tx, tw, tb, activation, **kw)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = [tx.grad] + [w.grad for w in tw] + (
        [] if tb is None else [b.grad for b in tb])
    return out.detach(), grads


@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
@pytest.mark.parametrize("bias", [True, False])
def test_mlp_and_each_remat_policy_match_jax(activation, bias):
    x, ws, bs, cot = _data()
    bs = bs if bias else None

    def jloss(x, ws, bs):
        return jnp.sum(jax_mlp(x, ws, bs, activation) * jnp.asarray(cot))

    argnums = (0, 1, 2) if bias else (0, 1)
    jg = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        None if bs is None else [jnp.asarray(b) for b in bs])
    want = [jg[0], *jg[1]] + ([] if bs is None else list(jg[2]))
    jout = jax_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                   None if bs is None else [jnp.asarray(b) for b in bs],
                   activation)
    base_out, base = _port_grads(x, ws, bs, cot, activation)
    _within(base_out.numpy(), jout)
    for g, w in zip(base, want):
        _within(g.numpy(), w)
    for kw in POLICIES[1:]:
        out, grads = _port_grads(x, ws, bs, cot, activation, **kw)
        assert torch.equal(out, base_out)
        assert all(torch.equal(a, b) for a, b in zip(grads, base)), kw
    torch.testing.assert_close(
        mlp_ref(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                None if bs is None else [torch.from_numpy(b) for b in bs],
                activation), base_out, rtol=0, atol=0)


def test_module_matches_flax_module_and_autocasts():
    x, *_ = _data(1)
    jm = JaxMLP(mlp_sizes=SIZES)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    m = MLP(SIZES)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in params["params"].items()})
    out = m(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == (16, SIZES[-1])
    _within(out.detach().numpy(), jm.apply(params, jnp.asarray(x)))
    with jamp.autocast():
        want = jm.apply(params, jnp.asarray(x))
    amp.F.reset_product_counts()
    with amp.autocast():
        got = m(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _within(got.float().detach().numpy(), jnp.asarray(want, jnp.float32),
            rtol=5e-2)
    assert amp.F.product_counts() == {("matmul", "bfloat16"): 2}


def test_refusals():
    x, ws, bs, _ = _data()
    tx, tw = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    with pytest.raises(ValueError, match="either"):
        mlp(tx, tw, remat=True, remat_policy="none")
    with pytest.raises(ValueError, match="remat_policy"):
        mlp(tx, tw, remat_policy="everything")
    with pytest.raises(ValueError, match="activation"):
        mlp(tx, tw, activation="gelu")
    with pytest.raises(ValueError, match="at least"):
        MLP([8])
