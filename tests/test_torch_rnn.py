"""apex_tpu_torch.RNN vs the JAX package's ``apex_tpu.RNN``, on the CPU.

Each of the five modes (``lstm``, ``mlstm``, ``gru``, ``relu``,
``tanh``), a three-layer stack and the bidirectional layer, with the JAX
package's weights carried over by ``from_jax_rnn_params``, on the same
numpy-seeded time-major input: fp32 outputs and final carries within
atol 1e-5, and autograd's gradients of a loss over the outputs and the
carries against ``jax.grad`` within 1e-5 relative L2 (every weight and
the input).  In bf16 both sides round h at every step and take their
sigmoids and tanhs in bf16, in their own orders: outputs and carries
are held within 2e-2 absolute (the gap measured 5.9e-3 at most).  The
LSTM and the GRU also match ``torch.nn.LSTM``/``GRU`` (as the JAX
package's own tests hold JAX), and the factories' refusals and the
dropout between layers are checked.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.RNN as jrnn
import apex_tpu_torch.RNN as trnn
from apex_tpu_torch.weights import from_jax_rnn_params

T, B, F, H = 5, 3, 6, 8
# name -> (mode, num_layers, bidirectional)
CASES = {
    "lstm": ("lstm", 1, False),
    "mlstm": ("mlstm", 1, False),
    "gru": ("gru", 1, False),
    "relu": ("relu", 1, False),
    "tanh": ("tanh", 1, False),
    "lstm_stacked3": ("lstm", 3, False),
    "gru_bidirectional": ("gru", 1, True),
}
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.randn(T, B, F).astype(np.float32)
    return xs, rng


def _factory(pkg, mode):
    return getattr(pkg, {"lstm": "LSTM", "mlstm": "mLSTM", "gru": "GRU",
                         "relu": "ReLU", "tanh": "Tanh"}[mode])


def _carries(carries, bidir):
    """Every final (h, c) as a flat list, in layer order."""
    if bidir:
        carries = list(carries)
    return [t for carry in carries for t in carry]


def _loss_parts(ys, carries, cot):
    """sum(ys * cot) + sum over carries of sum(h) + 0.5 sum(c)."""
    total = (ys * cot).sum()
    for i, t in enumerate(carries):
        total = total + (1.0 if i % 2 == 0 else 0.5) * t.sum()
    return total


@functools.lru_cache(maxsize=None)
def _jax_run(name, dtype="float32"):
    mode, layers, bidir = CASES[name]
    xs, rng = _inputs()
    width = 2 * H if bidir else H
    cot = rng.randn(T, B, width).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    m = _factory(jrnn, mode)(hidden_size=H, num_layers=layers,
                             bidirectional=bidir, dtype=jdt)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(xs))["params"]

    def loss(params, x):
        ys, carries = m.apply({"params": params}, x)
        flat = _carries(carries, bidir)
        return (_loss_parts(ys.astype(jnp.float32), flat, jnp.asarray(cot)),
                (ys, flat))

    if dtype == "bfloat16":
        _, (ys, flat) = jax.jit(loss)(params, jnp.asarray(xs))
        return params, xs, cot, ys, flat, None
    (_, (ys, flat)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(xs))
    return params, xs, cot, ys, flat, grads


def _port(name, params, dtype=torch.float32):
    mode, layers, bidir = CASES[name]
    m = _factory(trnn, mode)(F, hidden_size=H, num_layers=layers,
                             bidirectional=bidir, dtype=dtype)
    m.load_state_dict(from_jax_rnn_params(params))
    return m


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32), np.float32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", list(CASES))
def test_fp32_outputs_and_carries_match_jax(name):
    params, xs, _, ys, flat, _ = _jax_run(name)
    m = _port(name, params)
    got_ys, got_carries = m(torch.from_numpy(xs))
    got_flat = _carries(got_carries, CASES[name][2])
    assert got_ys.dtype == torch.float32
    np.testing.assert_allclose(_np(got_ys), np.asarray(ys), rtol=0,
                               atol=1e-5)
    assert len(got_flat) == len(flat)
    for g, w in zip(got_flat, flat):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_fp32_gradients_match_jax(name):
    params, xs, cot, _, _, (gparams, gx) = _jax_run(name)
    m = _port(name, params)
    x = torch.from_numpy(xs).requires_grad_(True)
    ys, carries = m(x)
    _loss_parts(ys, _carries(carries, CASES[name][2]),
                torch.from_numpy(cot)).backward()
    want = from_jax_rnn_params(gparams)
    got = dict(m.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        assert _rel_l2(_np(got[k].grad), w.numpy()) <= 1e-5, k
    assert _rel_l2(_np(x.grad), np.asarray(gx)) <= 1e-5


@pytest.mark.parametrize("name", ["lstm", "mlstm", "gru", "relu", "tanh",
                                  "gru_bidirectional"])
def test_bf16_matches_jax(name):
    params, xs, _, ys, flat, _ = _jax_run(name, "bfloat16")
    m = _port(name, params, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    got_ys, got_carries = m(torch.from_numpy(xs))
    got_flat = _carries(got_carries, CASES[name][2])
    assert got_ys.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in got_flat)
    np.testing.assert_allclose(_np(got_ys), np.asarray(ys, np.float32),
                               rtol=0, atol=BF16_TOL)
    for g, w in zip(got_flat, flat):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), rtol=0,
                                   atol=BF16_TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_matches_torch_nn(mode):
    """torch's gate orders (LSTM i, f, g, o; GRU r, z, n with the n gate's
    r * (h Whn + bhn)) are the cell's: torch.nn's weights are the
    transposes."""
    name = mode
    params, xs, _, ys, _, _ = _jax_run(name)
    m = _port(name, params)
    ref = (torch.nn.LSTM if mode == "lstm" else torch.nn.GRU)(F, H, 1)
    cell = m.layers[0].cell
    with torch.no_grad():
        ref.weight_ih_l0.copy_(cell.wi.T)
        ref.weight_hh_l0.copy_(cell.wh.T)
        ref.bias_ih_l0.copy_(cell.bi)
        ref.bias_hh_l0.copy_(cell.bh)
        want, _ = ref(torch.from_numpy(xs))
        got, _ = m(torch.from_numpy(xs))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(ys), rtol=0, atol=1e-5)


def test_factory_refusals():
    with pytest.raises(NotImplementedError, match="bidirectional"):
        trnn.LSTM(F, H, num_layers=2, bidirectional=True)
    with pytest.raises(NotImplementedError, match="bidirectional"):
        jrnn.LSTM(hidden_size=H, num_layers=2, bidirectional=True)
    with pytest.raises(ValueError, match="input_size"):
        trnn.GRU(hidden_size=H)
    with pytest.raises(ValueError, match="unknown mode"):
        trnn.RNNCell(F, H, mode="elman")
    with pytest.raises(ValueError, match="unmapped"):
        from_jax_rnn_params({"layer_0": {"ScanRNNCell_0": {"wz": 0.0}}})


def test_dropout_between_layers():
    xs = torch.from_numpy(_inputs(1)[0])
    m = trnn.LSTM(F, H, num_layers=2, dropout=0.5,
                  generator=torch.Generator().manual_seed(3))
    plain, _ = m(xs)
    same, _ = m(xs, deterministic=True)
    assert torch.equal(plain, same)
    with pytest.raises(ValueError, match="Generator"):
        m(xs, deterministic=False)
    a, _ = m(xs, deterministic=False,
             generator=torch.Generator().manual_seed(5))
    b, _ = m(xs, deterministic=False,
             generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    # the last layer's outputs get no dropout: a one-layer stack is exact
    one = trnn.LSTM(F, H, num_layers=1, dropout=0.5)
    assert torch.equal(one(xs, deterministic=False)[0], one(xs)[0])
