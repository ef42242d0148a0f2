"""apex_tpu_torch's fp32 L2 norms vs the JAX package's, on the CPU, at
leaf sizes where the order of the sum shows.

JAX takes ``sqrt(sum(x * x))`` per leaf in fp32 (its sums cascade), and
so must the port on CPU tensors: a naive running sum drifts by 9.6e-5
(relative) at 2^22 elements and by 2.4e-3 at GPT-2's (50257, 768) word
table.  Held here: ``multi_tensor_l2norm``'s global and per-leaf norms
within 1e-6 relative of JAX's at both sizes, its max norm exactly JAX's,
and ``fused_lamb``'s first update, clipped by that global norm, within
1e-6 relative L2 of JAX's (no weight decay, so no trust ratio rescales
the clip away, and an eps near |g / clip| so the update feels it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.multi_tensor import multi_tensor_l2norm as jax_l2norm
from apex_tpu.optimizers import fused_lamb as jax_lamb
from apex_tpu_torch.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.optimizers import fused_lamb

SHAPES = {"2^22": (2048, 2048), "gpt2_wte": (50257, 768)}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _leaf(shape, seed):
    """N(0, 0.02^2) fp32, a gradient's or a weight's scale."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


@pytest.mark.parametrize("size", list(SHAPES))
def test_l2norm_matches_jax_on_one_large_leaf(size):
    a = _leaf(SHAPES[size], 0)
    small = _leaf((37, 5), 1)
    want, want_per = jax_l2norm({"a": jnp.asarray(a), "b": jnp.asarray(small)},
                                per_tensor=True)
    got, got_per = multi_tensor_l2norm(
        {"a": torch.from_numpy(a), "b": torch.from_numpy(small)},
        per_tensor=True)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert _rel(got, want) <= 1e-6, (float(got), float(want))
    for k in ("a", "b"):
        assert _rel(got_per[k], want_per[k]) <= 1e-6, k
    exact = float(np.sqrt((a.astype(np.float64) ** 2).sum()
                          + (small.astype(np.float64) ** 2).sum()))
    assert _rel(got, exact) <= 1e-6
    got_max = multi_tensor_l2norm([torch.from_numpy(a),
                                   torch.from_numpy(small)], max_norm=True)
    want_max = jax_l2norm([jnp.asarray(a), jnp.asarray(small)], max_norm=True)
    assert float(got_max) == float(want_max)


def test_lamb_clipped_first_update_matches_jax():
    g = _leaf(SHAPES["2^22"], 2)
    p = _leaf(SHAPES["2^22"], 3)
    kw = dict(learning_rate=1e-2, eps=1e-3, weight_decay=0.0,
              max_grad_norm=1.0)
    jtx = jax_lamb(**kw)
    jp = {"w": jnp.asarray(p)}
    want, _ = jtx.update({"w": jnp.asarray(g)}, jtx.init(jp), jp)
    want = np.asarray(want["w"], np.float64)
    tx = fused_lamb(**kw)
    tp = {"w": torch.from_numpy(p.copy())}
    got, state = tx.update({"w": torch.from_numpy(g)}, tx.init(tp), tp)
    got = got["w"].double().numpy()
    assert int(state.step) == 1
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert rel <= 1e-6, rel
