"""apex_tpu_torch flash attention at head_dim 128 vs the JAX package, on
the CPU, and the wrappers' rules for what the kernels take.

On the card, bf16 q, k, v at head_dim 64 or 128 run the tensor-core
kernels and fp32 ones at head_dim 64 the FMA kernels; anything else
raises.  On CPU tensors the wrappers run their kernels' plain versions,
and these tests hold those against JAX's Pallas kernels in interpret
mode (``force_pallas(True)``, ``block_q = block_k = 64``, with the
helpers of ``tests/test_torch_flash_acc.py``, which also holds
``probs_bf16`` and the dq-accumulating backward at head_dim 128) at
head_dim 128, B 1, H 2, S 128-192, on the same numpy-seeded inputs:

- fp32 forward and grads, causal or not, with and without a bias and
  dropout: the output within 1e-5, each grad within 1e-4 of its
  max|want| (fp32 sums of up to 192 terms in other orders);
- bf16 forward and grads: every element within 2 bf16 ulps of the larger
  magnitude plus 1e-3 of max|want|, and at most 2 % of the elements
  different at all (both sides compute in fp32 and round once, so a sum
  near a rounding boundary now and then lands on the neighbouring value).

The wrappers' rules, exercised on CPU tensors: ``_flash_check`` takes bf16
at head_dim 64 and 128 and refuses head_dim 96, fp32 at 128, k/v that do
not match q, and bf16 tensors that do not start on a 16-byte boundary
(the tensor-core kernels stage them with 16-byte ``cp.async``); and both
backwards size their dq scratch by head_dim (a stand-in for the kernels'
library records the buffers the wrappers allocate).
"""
import contextlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_acc import (  # noqa: F401 (the autouse fixture)
    _bf16_close, _f32, _inputs, _jax, _port, _warm_torch_exp)

from apex_tpu_torch.ops import attention as tattn

SEED = 11
D = 128


# (causal, dropout rate, bias, Sq = Sk)
CASES = {
    "causal_dropout": (True, 0.1, False, 192),
    "bias_dropout": (False, 0.1, True, 128),
    "causal_bias": (True, 0.0, True, 128),
    "plain": (False, 0.0, False, 192),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_d128_matches_jax_kernels(dtype, case):
    causal, rate, with_bias, s = CASES[case]
    q, k, v, cot, bias = _inputs(1, 1, 2, s, s, with_bias, d=D, q_scale=2.0)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    out, grads = _port(q, k, v, cot, bias, tdt, causal=causal,
                       dropout_rate=rate, dropout_seed=SEED)
    want_out, want = _jax(q, k, v, cot, bias, jdt, causal=causal,
                          dropout_rate=rate, dropout_seed=jnp.int32(SEED),
                          use_pallas=True)
    assert out.shape == (1, 2, s, D) and out.dtype == tdt
    if dtype == "fp32":
        np.testing.assert_allclose(_f32(out), _f32(want_out), rtol=0,
                                   atol=1e-5)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want):
            w = _f32(w)
            err = np.abs(_f32(g) - w).max() / np.abs(w).max()
            assert err <= 1e-4, (name, err)
    else:
        for name, g, w in zip(("o", "dq", "dk", "dv"), (out, *grads),
                              (want_out, *want)):
            ok, err, frac = _bf16_close(g, w)
            assert ok, (name, err, frac)


def _qkv3(dtype, d, bh=4, sq=100, sk=150):
    return (torch.zeros(bh, sq, d, dtype=dtype),
            torch.zeros(bh, sk, d, dtype=dtype),
            torch.zeros(bh, sk, d, dtype=dtype))


SEED_PACK = torch.zeros(4, dtype=torch.int32)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_check_takes_bf16_at_head_dim_64_and_128(d):
    tattn._flash_check(*_qkv3(torch.bfloat16, d), SEED_PACK, None)


def test_flash_check_takes_fp32_at_head_dim_64():
    tattn._flash_check(*_qkv3(torch.float32, 64), SEED_PACK, None)


@pytest.mark.parametrize("what", ["bf16_d96", "fp32_d96", "fp32_d128",
                                  "k_head_dim", "v_shape", "k_dtype"])
def test_flash_check_refuses(what):
    dt = torch.float32 if what.startswith("fp32") else torch.bfloat16
    d = 96 if what.endswith("d96") else 128
    q, k, v = _qkv3(dt, d)
    if what == "k_head_dim":
        k = torch.zeros(4, 150, 64, dtype=dt)
    elif what == "v_shape":
        v = torch.zeros(4, 151, d, dtype=dt)
    elif what == "k_dtype":
        k = k.float()
    match = "one dtype" if what == "k_dtype" else "head_dim"
    with pytest.raises(ValueError, match=match):
        tattn._flash_check(q, k, v, SEED_PACK, None)


def _offset(t):
    """t's values as a contiguous view one element into a larger buffer:
    for bf16, 2 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    return view


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_check_refuses_bf16_off_a_16_byte_boundary(which):
    qkv = list(_qkv3(torch.bfloat16, 128))
    qkv[which] = _offset(qkv[which])
    with pytest.raises(ValueError, match="16-byte boundary"):
        tattn._flash_check(*qkv, SEED_PACK, None)


def test_backward_refuses_a_bf16_do_off_a_16_byte_boundary():
    q, k, v = _qkv3(torch.bfloat16, 64)
    lse = torch.zeros(q.shape[:2])
    tattn._bwd_inputs(q, k, v, q, lse, q, SEED_PACK, None)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tattn._bwd_inputs(q, k, v, q, lse, _offset(q), SEED_PACK, None)


def test_cuda_path_raises_at_fp32_head_dim_128(monkeypatch):
    """With the dispatch rule forced to the kernel, an fp32 call at
    head_dim 128 and a bf16 one at 96 raise before any launch: no path
    falls back to the plain version or to another kernel."""
    monkeypatch.setattr(tattn, "use_kernel", lambda *t: True)
    for dt, d in ((torch.float32, 128), (torch.bfloat16, 96)):
        q = torch.zeros(1, 2, 64, d, dtype=dt)
        with pytest.raises(ValueError, match="head_dim"):
            tattn.flash_attention(q, q, q)


class _StandInLib:
    """The kernels' library as the wrappers see it: its sizing functions
    (the C formulas) and launches that record the dq scratch buffer the
    calling wrapper allocated (read from its frame) and return 0."""

    def __init__(self):
        self.seen = {}

    @staticmethod
    def apex_flash_dq_tiles(sq, sk, causal):
        nq, nk = -(-sq // 64), -(-sk // 64)
        return nq * (nq + 1) // 2 if causal else nq * nk

    @staticmethod
    def apex_flash_acc_floats(bh, sq, d):
        return bh * -(-sq // 64) * 64 * d

    @staticmethod
    def apex_flash_acc_turns(bh, sq):
        return bh * -(-sq // 64) + 1

    def apex_flash_bwd(self, *args):
        self.seen["partials"] = sys._getframe(1).f_locals["part"].numel()
        self.seen["head_dim_arg"] = args[-3]
        return 0

    def apex_flash_bwd_acc(self, *args):
        self.seen["acc"] = sys._getframe(1).f_locals["run"].numel()
        self.seen["head_dim_arg_acc"] = args[-3]
        return 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_dq_scratch_is_sized_by_head_dim(d, causal, monkeypatch):
    lib = _StandInLib()
    monkeypatch.setattr(tattn, "use_kernel", lambda *t: True)
    monkeypatch.setattr(tattn, "_flash_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    for fn in (tattn.flash_attention_bwd, tattn.flash_attention_bwd_acc):
        monkeypatch.setattr(fn, "launches", 0)
    bh, sq, sk = 6, 200, 130
    q, k, v = _qkv3(torch.bfloat16, d, bh, sq, sk)
    lse = torch.zeros(bh, sq)
    args = (SEED_PACK, d ** -0.5, causal, 0.0, (3, 3))
    tattn.flash_attention_bwd(q, k, v, q, lse, q, *args, dq_acc=False)
    tattn.flash_attention_bwd_acc(q, k, v, q, lse, q, *args)
    nq, nk = -(-sq // 64), -(-sk // 64)
    tiles = nq * (nq + 1) // 2 if causal else nq * nk
    assert lib.seen == {"partials": bh * tiles * 64 * d, "head_dim_arg": d,
                        "acc": bh * nq * 64 * d, "head_dim_arg_acc": d}
    # a running buffer sized for another head_dim is refused
    other = torch.empty(bh * nq * 64 * (192 - d))
    with pytest.raises(ValueError, match="running dq buffer"):
        tattn.flash_attention_bwd_acc(q, k, v, q, lse, q, *args, _run=other)
