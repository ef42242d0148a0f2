"""RNN factories — parity with apex/RNN/models.py:9-56.

Counterpart of ``apex_tpu/RNN/models.py``.  Each returns a module over
time-major (T, B, F) input.  flax infers the input width at the first
call; a torch module allocates its weights when it is built, so here
``input_size`` is required.
"""
from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.RNN.backend import BidirectionalRNN, StackedRNN

__all__ = ["GRU", "LSTM", "ReLU", "Tanh", "mLSTM"]


def _make(mode: str):
    def factory(input_size: Optional[int] = None, hidden_size: int = 512,
                num_layers: int = 1, bias: bool = True, dropout: float = 0.0,
                bidirectional: bool = False,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None):
        if input_size is None:
            raise ValueError(
                f"{mode.upper()}: input_size is required (a torch module "
                "allocates its weights when it is built; flax infers the "
                "width at the first call instead)")
        if bidirectional:
            if num_layers != 1:
                raise NotImplementedError(
                    "bidirectional stacks: compose BidirectionalRNN layers "
                    "manually (the reference's bidirectionalRNN is also "
                    "single-stack, RNNBackend.py:25-60)")
            return BidirectionalRNN(input_size, hidden_size, mode=mode,
                                    bias=bias, dtype=dtype,
                                    generator=generator)
        return StackedRNN(input_size, hidden_size, num_layers, mode=mode,
                          bias=bias, dropout=dropout, dtype=dtype,
                          generator=generator)

    factory.__name__ = mode.upper()
    factory.__doc__ = (
        f"A {mode} stack: ``StackedRNN``, or with ``bidirectional`` (one "
        "layer only) ``BidirectionalRNN``; weights drawn from "
        "``generator`` (default: one seeded 0 on the CPU).")
    return factory


LSTM = _make("lstm")
GRU = _make("gru")
ReLU = _make("relu")
Tanh = _make("tanh")
mLSTM = _make("mlstm")
