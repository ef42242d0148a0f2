"""apex_tpu_torch's ``reparameterization`` (weight norm) vs the JAX
package's, on the CPU.

Over an MLP's parameter map (three dense kernels and their biases,
numpy-seeded) against the same tree through JAX's functions, for
``dim`` -1 (one norm per output channel of an (in, out) kernel, JAX's
default), 0 and None (one norm over the tensor): ``norm_except_axis``,
the ``_g``/``_v`` keys ``apply_weight_norm`` makes (all, and a regular
expression over ``/``-joined paths) and their values within 1e-6
relative, the reconstruction by
``compute_weights`` and ``remove_weight_norm`` within 1e-6 of the
weights, and the gradients to g and v of a loss through
``compute_weights`` within 1e-5 of their largest magnitude of JAX's.
Also vectors skipped, double application and a mismatched g rejected,
and torch's own ``weight_norm`` (dim 0 on its (out, in) layout) giving
the same gradients as ``dim=-1`` here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import reparameterization as JR
from apex_tpu_torch.mlp import MLP
from apex_tpu_torch.reparameterization import (apply_weight_norm,
                                               compute_weights,
                                               norm_except_axis,
                                               remove_weight_norm,
                                               weight_norm)

SIZES = [8, 16, 12, 4]


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _params(seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for i, (a, b) in enumerate(zip(SIZES[:-1], SIZES[1:])):
        out[f"kernel_{i}"] = rng.randn(a, b).astype(np.float32)
        out[f"bias_{i}"] = rng.randn(b).astype(np.float32)
    return out


def _nested(flat):
    """The same parameters as a flax-style tree: layer_i/{kernel, bias}."""
    tree = {}
    for k, v in flat.items():
        kind, i = k.rsplit("_", 1)
        tree.setdefault(f"layer_{i}", {})[kind] = jnp.asarray(v)
    return tree


def _port(flat):
    return {f"layer_{k.rsplit('_', 1)[1]}.{k.rsplit('_', 1)[0]}":
            torch.from_numpy(v.copy()) for k, v in flat.items()}


def _flatten(tree):
    return {f"{a}.{b}": np.asarray(v) for a, sub in tree.items()
            for b, v in sub.items()}


@pytest.mark.parametrize("dim", [-1, 0, None])
def test_weight_norm_matches_jax(dim):
    flat = _params()
    p, jp = _port(flat), _nested(flat)
    for k, v in p.items():
        np.testing.assert_allclose(norm_except_axis(v, dim).numpy(),
                                   np.asarray(JR.norm_except_axis(
                                       jnp.asarray(v.numpy()), dim)),
                                   rtol=1e-6)
    wn, jwn = apply_weight_norm(p, dim=dim), JR.apply_weight_norm(jp, dim=dim)
    assert set(wn) == set(_flatten(jwn))
    assert "layer_0.bias" in wn and "layer_0.kernel_g" in wn
    for k, v in _flatten(jwn).items():  # g: the same sum in another order
        np.testing.assert_allclose(wn[k].numpy(), v, rtol=1e-6, atol=0)
    for fold in (compute_weights, remove_weight_norm):
        back = fold(wn, dim=dim)
        assert set(back) == set(p)
        for k, v in p.items():
            np.testing.assert_allclose(back[k].numpy(), v.numpy(), rtol=0,
                                       atol=1e-6)
    x = np.random.RandomState(1).randn(5, SIZES[0]).astype(np.float32)

    def jloss(t):
        w = JR.compute_weights(t, dim=dim)
        h = jnp.asarray(x)
        for i in range(3):
            h = jnp.tanh(h @ w[f"layer_{i}"]["kernel"] + w[f"layer_{i}"]["bias"])
        return jnp.sum(h ** 2)

    leaves = {k: v.clone().requires_grad_() for k, v in wn.items()}
    w = compute_weights(leaves, dim=dim)
    h = torch.from_numpy(x)
    for i in range(3):
        h = torch.tanh(h @ w[f"layer_{i}.kernel"] + w[f"layer_{i}.bias"])
    torch.sum(h ** 2).backward()
    want = _flatten(jax.grad(jloss)(jwn))
    for k, v in leaves.items():
        assert np.abs(v.grad.numpy() - want[k]).max() \
            <= 1e-5 * np.abs(want[k]).max(), k


def test_name_selects_by_slash_path_as_jax():
    flat = _params(2)
    p, jp = _port(flat), _nested(flat)
    for pattern in (r"^layer_1/", r"kernel$", r"layer_[02]/kernel"):
        got = apply_weight_norm(p, name=pattern)
        want = _flatten(JR.apply_weight_norm(jp, name=pattern))
        assert set(got) == set(want), pattern
        back = remove_weight_norm(got, name=pattern)
        assert set(back) == set(p)


def test_refusals_and_skips():
    p = {"w": torch.randn(8, 8), "b": torch.zeros(8)}
    wn = apply_weight_norm(p)
    assert set(wn) == {"w_g", "w_v", "b"}  # vectors are skipped
    with pytest.raises(ValueError, match="already applied"):
        apply_weight_norm(wn)
    with pytest.raises(ValueError, match="does not match"):
        weight_norm(wn["w_v"], wn["w_g"], axis=0)


def test_dim_minus_one_is_torch_weight_norm_dim_zero():
    torch.manual_seed(0)
    m = MLP([5, 3], bias=False, activation="none")
    x = torch.randn(7, 5)
    wn = {k: v.detach().clone().requires_grad_()
          for k, v in apply_weight_norm(dict(m.named_parameters())).items()}
    out = torch.func.functional_call(m, compute_weights(wn), (x,))
    torch.sum(out ** 2).backward()
    lin = torch.nn.Linear(5, 3, bias=False)
    with torch.no_grad():
        lin.weight.copy_(m.kernel_0.T)  # torch (out, in)
    # dim=0: per-output norms; original0 is g, original1 is v
    lin = torch.nn.utils.parametrizations.weight_norm(lin)
    torch.sum(lin(x) ** 2).backward()
    orig = lin.parametrizations.weight
    torch.testing.assert_close(wn["kernel_0_v"].grad, orig.original1.grad.T)
    torch.testing.assert_close(wn["kernel_0_g"].grad.reshape(-1),
                               orig.original0.grad.reshape(-1))
