"""Long-context GPT training: ring attention over a ``seq`` axis, ZeRO
over a ``data`` axis, microbatches and remat, under O2.

Port of ``examples/gpt_long_context/main_amp.py`` (its ``--generate``
serving demo is the port's ``serve`` package, left out here):

- a mesh (data, seq), default 2 x 2, one rank a process
  (:func:`apex_tpu_torch.parallel.make_mesh`);
- a stack of ``GPTLayer``s whose attention is
  :func:`~apex_tpu_torch.parallel.ring_attention` over ``seq`` (or
  ``--attention ulysses``): each rank holds S / n_seq of every
  activation, causal future blocks are skipped and the attention-dropout
  mask is keyed on global positions, so the sharded stack computes the
  unsharded one.  The port also keys it on the global batch row (each
  data rank passes its batch offset), so one seed on every rank draws the
  unsharded batch's masks; the JAX example folds the data index into the
  seed instead;
- ``--microbatches`` gradient passes a step accumulated on the device,
  ``--remat-policy`` per block (``dots_saveable`` by default);
- ``--zero`` (default): the accumulated gradient goes to
  ``DistributedFusedAdam`` over ``data`` (reduce-scatter, the shard's
  update, all-gather); ``--no-zero`` reduces it with
  ``DistributedDataParallel`` into a replicated ``fused_adam``;
- the loss is this rank's mean, averaged over ``seq`` by a
  differentiable :func:`~apex_tpu_torch.parallel.psum`; as in JAX, the
  parameters are replicated over ``seq``, so the boundary sums their
  partial gradients over it once (``grad_presum``).  Under JAX's
  convention (``psum``'s backward is a ``psum``) that makes the
  gradient n_seq times the mean loss's, as in the JAX example.

A gang of ``data x seq`` processes on the CPU::

    WORLD_SIZE=4 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.gpt_long_context --device cpu \\
        --backend gloo --steps 4

On one card, several ranks share it through gloo (NCCL takes one rank a
card): ``--backend gloo`` with the default device.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.models.gpt import GPTConfig, GPTLayer
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import (
    Axis,
    DistributedDataParallel,
    P,
    all_reduce,
    init_distributed,
    make_mesh,
    psum,
    ring_attention,
    sync_replicated_grads,
    ulysses_attention,
)
from apex_tpu_torch.remat import remat_call
from apex_tpu_torch.train import (
    FusedTrainDriver,
    amp_microbatch_step,
    zero_init,
    zero_microbatch_step,
    zero_state_spec,
)

LR = 3e-3


def make_layers(cfg: GPTConfig, n_layers: int,
                attention_fn: Optional[Callable] = None, *, device="cuda",
                seed: int = 0) -> nn.ModuleList:
    """``n_layers`` fp32 ``GPTLayer``s with GPT-2's init (normal(0, 0.02)
    kernels, zero biases, unit LayerNorm scales), drawn on the CPU from
    ``seed`` so every rank and device holds the same numbers."""
    g = torch.Generator().manual_seed(seed)
    layers = nn.ModuleList(GPTLayer(cfg, attention_fn)
                           for _ in range(n_layers))
    with torch.no_grad():
        for name, p in layers.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln" in name:
                p.fill_(1.0)
            else:
                p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=g))
    return layers.to(device)


def sequence_attention(kind: str, seq: Axis, batch_offset: int = 0, *,
                       probs_bf16: bool = False) -> Callable:
    """The layers' ``attention_fn``: causal ``ring`` or ``ulysses``
    attention over ``seq``.  The ring keys its dropout on global batch
    rows from ``batch_offset`` (this data rank's first row)."""
    if kind == "ring":
        def attend(q, k, v, *, dropout_rate, dropout_seed):
            b, h = q.shape[:2]
            return ring_attention(
                q, k, v, seq, causal=True, dropout_rate=dropout_rate,
                dropout_seed=dropout_seed,
                dropout_heads=(h, batch_offset * h), probs_bf16=probs_bf16)
    elif kind == "ulysses":
        def attend(q, k, v, *, dropout_rate, dropout_seed):
            return ulysses_attention(
                q, k, v, seq, causal=True, dropout_rate=dropout_rate,
                dropout_seed=dropout_seed, probs_bf16=probs_bf16)
    else:
        raise ValueError(f"attention must be ring or ulysses, got {kind!r}")
    return attend


def forward(layers: nn.ModuleList, x: torch.Tensor, *, remat_policy: str,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The stack on (B, S_local, h) ``x`` in the compute dtype, each layer
    under ``remat_policy``, dropout from ``generator`` (None:
    deterministic)."""
    det = generator is None
    for layer in layers:
        x = remat_call(layer, remat_policy, x, det, generator,
                       generator=generator)
    return x


def make_grad_fn(layers: nn.ModuleList, amp_, seq: Axis, data: Axis, *,
                 remat_policy: str, generator: Optional[torch.Generator],
                 grad_factor: float = 1.0):
    """``grad_fn(carry, (x, y))`` of one microbatch: the scaled loss's
    gradients by parameter name and ``{"loss": the data-mean loss}``.
    The loss is this rank's mean squared error averaged over ``seq`` by a
    differentiable psum; ``grad_factor`` multiplies the loss the
    gradients are taken of (a one-rank run passes n_seq to take the
    gang's gradient)."""
    names, params = zip(*layers.named_parameters())
    dt = layers[0].cfg.compute_dtype

    def grad_fn(carry, batch):
        state = carry[1]
        xb, yb = batch
        out = forward(layers, xb.to(dt), remat_policy=remat_policy,
                      generator=generator)
        local = (out.float() - yb).square().mean()
        loss = psum(local, seq, tag="loss") / seq.size
        scaled = amp_.scale_loss(loss * grad_factor, state.scaler[0])
        grads = torch.autograd.grad(scaled, params)
        metric = loss.detach().clone()
        if data.group is not None:
            all_reduce(metric, data.group, tag="loss")
        return dict(zip(names, grads)), {"loss": metric / data.size}

    return grad_fn


def build(layers: nn.ModuleList, seq: Axis, data: Axis, *,
          opt_level: str = "O2", zero: bool = True, microbatches: int = 4,
          remat_policy: str = "dots_saveable",
          generator: Optional[torch.Generator] = None,
          grad_factor: float = 1.0, lr: float = LR):
    """The recipe's step and carry over the fp32 ``layers``: returns
    ``(step, carry, carry_spec)`` for :class:`~apex_tpu_torch.train.
    FusedTrainDriver` (the carry ``(masters, state)``; with ``zero`` the
    state is a ``ZeroAmpState`` whose shards ``carry_spec`` marks).  The
    model keeps its fp32 parameters, as the JAX example does: each
    ``Dense`` casts to the compute dtype, and the new masters are copied
    into the model after every step."""
    amp_ = amp.initialize(opt_level)
    grad_fn = make_grad_fn(layers, amp_, seq, data, remat_policy=remat_policy,
                           generator=generator, grad_factor=grad_factor)
    masters = {n: p.detach().clone() for n, p in layers.named_parameters()}

    def presum(g):
        return sync_replicated_grads(g, seq, tag="seq_presum")

    if zero:
        zopt = DistributedFusedAdam(data, lr=lr)
        spec = zopt.make_spec(masters)
        step = zero_microbatch_step(grad_fn, zopt, amp_, spec,
                                    microbatches=microbatches,
                                    grad_presum=presum, model=layers)
        return step, (masters, zero_init(zopt, amp_, masters, spec)), \
            (P(), zero_state_spec("data"))
    opt = amp.AmpOptimizer(fused_adam(lr), amp_)
    ddp = (DistributedDataParallel(group=data.group) if data.size > 1
           else None)
    step = amp_microbatch_step(grad_fn, opt, microbatches=microbatches,
                               ddp=ddp, grad_presum=presum, model=layers)
    return step, (masters, opt.init(masters)), None


def synthetic_data(cfg: GPTConfig, batch: int, seq_len: int, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The example's sequence-regression data over the global batch and
    sequence: x and y of (batch, seq_len, hidden), normal * 0.3."""
    rng = np.random.RandomState(seed)
    shape = (batch, seq_len, cfg.hidden_size)
    x = rng.randn(*shape).astype(np.float32) * 0.3
    y = rng.randn(*shape).astype(np.float32) * 0.3
    return torch.from_numpy(x), torch.from_numpy(y)


def train(args) -> List[float]:
    """The example in the initialised process group: returns the
    per-step losses."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh([("data", args.data), ("seq", args.seq)])
    data, seq = mesh["data"], mesh["seq"]
    cfg = GPTConfig(hidden_size=args.hidden, num_heads=args.heads,
                    num_layers=args.layers, dropout_rate=0.0,
                    attn_dropout_rate=0.1,
                    compute_dtype=amp.initialize(
                        args.opt_level).policy.compute_dtype)
    attend = sequence_attention(args.attention, seq,
                                data.index * args.batch_local,
                                probs_bf16=args.probs_bf16)
    layers = make_layers(cfg, args.layers, attend, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    step, carry, carry_spec = build(
        layers, seq, data, opt_level=args.opt_level, zero=args.zero,
        microbatches=args.microbatches, remat_policy=args.remat_policy,
        generator=gen)
    driver = FusedTrainDriver(step, steps_per_dispatch=args.steps_per_dispatch,
                              mesh=mesh, batch_spec=P("data", "seq"),
                              carry_spec=carry_spec, per_step=("loss",))
    x, y = synthetic_data(cfg, args.data * args.batch_local,
                          args.seq * args.seq_local)
    x, y = x.to(dev), y.to(dev)
    losses: List[float] = []
    done = 0
    while done < args.steps:
        k = min(args.steps_per_dispatch, args.steps - done)
        n = k * args.microbatches
        window = (x.expand(n, *x.shape), y.expand(n, *y.shape))
        carry, res = driver.run_window(carry, window)
        losses += res.per_step["loss"].tolist()
        done += k
    amp.maybe_print(f"step  0: loss {losses[0]:.4f}")
    amp.maybe_print(f"step {args.steps - 1:2d}: loss {losses[-1]:.4f}")
    amp.maybe_print(
        f"long-context {args.opt_level} {args.attention}-attention training "
        f"(mesh data={args.data} seq={args.seq}, S="
        f"{args.seq * args.seq_local} split {args.seq_local}/rank), "
        f"microbatches={args.microbatches} remat={args.remat_policy} "
        f"zero={args.zero}; effective batch "
        f"{args.data * args.batch_local * args.microbatches} sequences/step")
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--steps-per-dispatch", type=int, default=5)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--opt-level", default="O2", choices=["O0", "O2"])
    ap.add_argument("--remat-policy", default="dots_saveable",
                    choices=["none", "dots_saveable", "full_block"])
    ap.add_argument("--zero", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--attention", default="ring",
                    choices=["ring", "ulysses"])
    ap.add_argument("--probs-bf16", action="store_true")
    # GPTConfig.tiny's width, one layer, as the JAX example
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--seq-local", type=int, default=32)
    ap.add_argument("--batch-local", type=int, default=2)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not init_distributed(args.backend):
        raise SystemExit("run under python -m apex_tpu_torch.parallel."
                         "multiproc with WORLD_SIZE = data x seq")
    try:
        losses = train(args)
    finally:
        dist.destroy_process_group()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
