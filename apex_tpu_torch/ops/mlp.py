"""The whole-MLP chain: ``x @ W_i + b_i`` then the activation, per layer.

Counterpart of ``apex_tpu/ops/mlp.py`` (ref apex/mlp/mlp.py,
csrc/mlp_cuda.cu: cuBLAS products with bias and activation epilogues and
one reserved activation buffer).  The JAX package computes the chain as
plain ``jnp.matmul``s that XLA fuses, outside any Pallas kernel, so here
it is plain PyTorch: each product goes through
:func:`apex_tpu_torch.amp.functional.matmul` (counted, and cast by O1's
tables), fp32 products at full precision (TF32 off, PyTorch's default for
``matmul``), and ``remat_policy`` (:mod:`apex_tpu_torch.remat`) gives the
reserved-buffer memory behaviour: ``full_block`` recomputes the whole
chain in the backward, ``dots_saveable`` keeps the products' outputs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch.amp import functional as amp_F
from apex_tpu_torch.remat import remat_call

__all__ = ["ACTIVATIONS", "mlp", "mlp_ref"]

ACTIVATIONS = {"none": lambda x: x, "relu": torch.relu,
               "sigmoid": torch.sigmoid}


def mlp(x: torch.Tensor, weights: Sequence[torch.Tensor],
        biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
        activation: str = "relu", *, remat_policy: Optional[str] = None,
        remat: bool = False) -> torch.Tensor:
    """The full MLP; the activation follows EVERY layer, the last one
    included (ref mlp.cpp:7-100, tests/L0/run_mlp/test_mlp.py:24-31).
    ``weights[i]``: (in_i, out_i); ``biases[i]``: (out_i,) or None.  The
    legacy ``remat=True`` is ``remat_policy="full_block"``."""
    if remat_policy is None:
        remat_policy = "full_block" if remat else "none"
    elif remat:
        raise ValueError("pass either remat_policy or the legacy remat flag")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}")
    act = ACTIVATIONS[activation]
    n = len(weights)
    bs = list(biases) if biases is not None else [None] * n

    def run(x, *params):
        for w, b in zip(params[:n], params[n:]):
            x = amp_F.matmul(x, w)
            if b is not None:
                x = x + b
            x = act(x)
        return x

    return remat_call(run, remat_policy, x, *weights, *bs)


def mlp_ref(x: torch.Tensor, weights: Sequence[torch.Tensor],
            biases: Optional[Sequence[Optional[torch.Tensor]]] = None,
            activation: str = "relu") -> torch.Tensor:
    """The chain itself is the reference; kept for harness symmetry."""
    return mlp(x, weights, biases, activation)
