"""apex_tpu_torch.RNN — recurrent stacks over time-major input.

Counterpart of ``apex_tpu/RNN`` (ref apex/RNN: the LSTM, GRU, ReLU, Tanh
and mLSTM factories, RNNBackend's stacked and bidirectional RNNs).  The
JAX package scans each layer with ``lax.scan``; the port loops over the
steps in Python.  :func:`apex_tpu_torch.weights.from_jax_rnn_params`
carries the JAX package's weights over.
"""
from apex_tpu_torch.RNN.backend import (  # noqa: F401
    BidirectionalRNN,
    RNNCell,
    StackedRNN,
)
from apex_tpu_torch.RNN.models import (  # noqa: F401
    GRU,
    LSTM,
    ReLU,
    Tanh,
    mLSTM,
)

__all__ = ["BidirectionalRNN", "GRU", "LSTM", "RNNCell", "ReLU",
           "StackedRNN", "Tanh", "mLSTM"]
