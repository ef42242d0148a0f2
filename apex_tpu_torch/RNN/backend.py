"""RNN backend: cells, stacking and bidirectionality over time-major
input.

Counterpart of ``apex_tpu/RNN/backend.py`` (ref apex/RNN/RNNBackend.py
and cells.py's mLSTM cell).  A cell computes all its gates with one
input product and one hidden product, its weights stored as flax stores
them: ``wi`` (in, n_gates * hs), ``wh`` (hs, n_gates * hs), biases ``bi``
and ``bh`` (n_gates * hs), and for the mLSTM ``wmx`` (in, hs) and ``wmh``
(hs, hs).  The JAX package scans the cell with ``lax.scan``; here a layer
runs a Python loop over the T steps, each step a few eager launches
(plain products and pointwise ops: the JAX package has no Pallas kernel
for the RNNs, and neither has the port).

Precision follows the JAX package: a cell casts x and h to ``dtype``,
computes in it and returns its ``(h, c)`` carry in fp32 and its output
in ``dtype``, so a bf16 stack rounds h at every step.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._random import dropout

__all__ = ["BidirectionalRNN", "RNNCell", "StackedRNN"]

Carry = Tuple[torch.Tensor, torch.Tensor]

N_GATES = {"lstm": 4, "mlstm": 4, "gru": 3, "relu": 1, "tanh": 1}


def _gates(x, h, wi, wh, bi, bh):
    g = x @ wi + h @ wh
    if bi is not None:
        g = g + bi + bh
    return g


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator the weights are drawn from: the caller's, else one
    seeded 0 on the CPU (never the global RNG)."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


class RNNCell(nn.Module):
    """One recurrent cell; ``mode`` is ``lstm``, ``mlstm``, ``gru``,
    ``relu`` or ``tanh`` (ref models.py:9-56).  Weights are drawn
    uniform(-1/sqrt(hs), 1/sqrt(hs)) from ``generator`` in ``dtype`` on
    its device (ref RNNBackend.py:291-297), biases start at 0."""

    def __init__(self, input_size: int, hidden_size: int, mode: str = "lstm",
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in N_GATES:
            raise ValueError(f"unknown mode {mode}")
        self.hidden_size, self.mode, self.dtype = hidden_size, mode, dtype
        gen = _generator(generator)
        stdev = 1.0 / math.sqrt(hidden_size)
        width = N_GATES[mode] * hidden_size

        def uniform(*shape):
            return nn.Parameter(torch.empty(
                shape, dtype=dtype, device=gen.device).uniform_(
                    -stdev, stdev, generator=gen))

        self.wi = uniform(input_size, width)
        self.wh = uniform(hidden_size, width)
        if bias:
            self.bi = nn.Parameter(torch.zeros(width, dtype=dtype,
                                               device=gen.device))
            self.bh = nn.Parameter(torch.zeros(width, dtype=dtype,
                                               device=gen.device))
        else:
            self.bi = self.bh = None
        if mode == "mlstm":
            self.wmx = uniform(input_size, hidden_size)
            self.wmh = uniform(hidden_size, hidden_size)

    def forward(self, carry: Carry, x: torch.Tensor
                ) -> Tuple[Carry, torch.Tensor]:
        """One step: ``((h, c), x (B, in))`` -> ``((h', c') in fp32, h' in
        dtype)``."""
        h, c = carry
        dt = self.dtype
        x, h = x.to(dt), h.to(dt)
        wi, wh, bi, bh = self.wi, self.wh, self.bi, self.bh
        if self.mode in ("lstm", "mlstm"):
            if self.mode == "mlstm":
                # multiplicative LSTM (ref cells.py:12-79): m = (x Wmx) *
                # (h Wmh) takes h's place in the gate products
                h = (x @ self.wmx) * (h @ self.wmh)
            i, f, gg, o = _gates(x, h, wi, wh, bi, bh).chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c.to(dt) + i * torch.tanh(gg)
            h_new = o * torch.tanh(c_new)
        elif self.mode == "gru":
            # torch's GRU gate layout: the n gate takes r * (h Whn + bhn)
            xg, hg = x @ wi, h @ wh
            if bi is not None:
                xg, hg = xg + bi, hg + bh
            xr, xz, xn = xg.chunk(3, dim=-1)
            hr, hz, hn = hg.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
            c_new = c
        else:
            g = _gates(x, h, wi, wh, bi, bh)
            h_new = torch.relu(g) if self.mode == "relu" else torch.tanh(g)
            c_new = c
        return (h_new.float(), c_new.float()), h_new


class _Layer(nn.Module):
    """One cell run over time: (T, B, F) -> ((T, B, H), final carry),
    from the last step back to the first with ``reverse``; the outputs
    stay at their steps' positions."""

    def __init__(self, input_size: int, hidden_size: int, mode: str,
                 bias: bool, dtype: torch.dtype,
                 generator: torch.Generator, reverse: bool = False):
        super().__init__()
        self.hidden_size, self.reverse = hidden_size, reverse
        self.cell = RNNCell(input_size, hidden_size, mode, bias, dtype,
                            generator)

    def forward(self, xs: torch.Tensor, h0: Optional[Carry] = None
                ) -> Tuple[torch.Tensor, Carry]:
        t, b, _ = xs.shape
        if h0 is None:
            zero = torch.zeros(b, self.hidden_size, dtype=torch.float32,
                               device=xs.device)
            h0 = (zero, zero)
        carry, ys = h0, [None] * t
        for i in (range(t - 1, -1, -1) if self.reverse else range(t)):
            carry, ys[i] = self.cell(carry, xs[i])
        return torch.stack(ys), carry


class StackedRNN(nn.Module):
    """``num_layers`` cells, each over the previous one's outputs, with
    dropout between them when not ``deterministic`` (ref
    RNNBackend.stackedRNN).  Parameters ``layers.{i}.cell.*``."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, mode: str = "lstm", bias: bool = True,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        self.dropout = dropout
        self.layers = nn.ModuleList(
            _Layer(input_size if i == 0 else hidden_size, hidden_size, mode,
                   bias, dtype, gen) for i in range(num_layers))

    def forward(self, xs: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, List[Carry]]:
        """``xs`` (T, B, F) -> (the last layer's outputs, each layer's
        final carry).  Training with dropout draws its masks from
        ``generator`` (a ``torch.Generator`` on the input's device)."""
        carries = []
        for i, layer in enumerate(self.layers):
            xs, carry = layer(xs)
            carries.append(carry)
            if (self.dropout > 0 and not deterministic
                    and i < len(self.layers) - 1):
                xs = dropout(xs, self.dropout, generator)
        return xs, carries


class BidirectionalRNN(nn.Module):
    """A forward and a reversed layer over the same input, features
    concatenated (ref RNNBackend.bidirectionalRNN).  Parameters
    ``fwd.cell.*`` and ``bwd.cell.*``."""

    def __init__(self, input_size: int, hidden_size: int, mode: str = "lstm",
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = _generator(generator)
        self.fwd = _Layer(input_size, hidden_size, mode, bias, dtype, gen)
        self.bwd = _Layer(input_size, hidden_size, mode, bias, dtype, gen,
                          reverse=True)

    def forward(self, xs: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[Carry, Carry]]:
        fwd, cf = self.fwd(xs)
        bwd, cb = self.bwd(xs)
        return torch.cat([fwd, bwd], dim=-1), (cf, cb)
