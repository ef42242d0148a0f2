"""Minimal data-parallel training: AMP O2, ``fused_sgd`` and DDP.

Port of ``examples/simple/distributed_data_parallel.py`` (ref
``examples/simple/distributed/distributed_data_parallel.py``): a two-layer
toy model, its fp32 masters behind ``AmpOptimizer``, each rank's
gradients averaged by :class:`~apex_tpu_torch.parallel.
DistributedDataParallel`, 50 steps.

One process (world 1)::

    python -m apex_tpu_torch.examples.distributed_data_parallel

A gang (``WORLD_SIZE`` processes, default 2)::

    python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.distributed_data_parallel

The backend is NCCL on the card, which takes one rank a card; on the CPU
pass ``--device cpu --backend gloo``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    Reducer,
    init_distributed,
    replicate,
    shard_batch,
)
from apex_tpu_torch.parallel.multiproc import free_port

PER_RANK = 16  # rows of the batch on each rank


def train(steps: int = 50, device="cuda", log_every: int = 10,
          seed: int = 42) -> List[float]:
    """``steps`` O2 steps on this rank's shard of one seeded batch, in
    the initialised process group; returns the rank-averaged losses."""
    dev = torch.device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_sgd(0.03, momentum=0.9), amp_)
    ddp = DistributedDataParallel()
    mean = Reducer(average=True)
    rng = np.random.RandomState(seed)
    masters = {
        "w1": torch.from_numpy(rng.randn(32, 64).astype(np.float32) * 0.2),
        "w2": torch.from_numpy(rng.randn(64, 8).astype(np.float32) * 0.2)}
    masters = replicate({k: v.to(dev) for k, v in masters.items()})
    state = opt.init(masters)
    x = rng.randn(world * PER_RANK, 32).astype(np.float32)
    y = x @ (rng.randn(32, 8).astype(np.float32) * 0.5)
    x, y = shard_batch((torch.from_numpy(x).to(dev),
                        torch.from_numpy(y).to(dev)))
    losses = []
    for i in range(steps):
        mp = {k: v.detach().requires_grad_()
              for k, v in opt.model_params(masters).items()}
        h = torch.relu(x.to(mp["w1"].dtype) @ mp["w1"])
        loss = ((h @ mp["w2"]).float() - y).square().mean()
        grads = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]),
                                    list(mp.values()))
        grads = ddp.allreduce(dict(zip(mp, grads)))
        masters, state, _ = opt.step(grads, state, masters)
        losses.append(float(mean.reduce(loss.detach())))
        if log_every and i % log_every == 0:
            amp.maybe_print(f"step {i:3d}  loss {losses[-1]:.5f}  scale "
                            f"{float(state.scaler[0].loss_scale):.0f}")
    amp.maybe_print(f"final loss: {losses[-1]} (world {world}, rank "
                    f"{rank} of a {dist.get_backend()} group)")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl",
                    help="nccl (the card) or gloo (the CPU, or ranks that "
                    "share a card)")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    if not init_distributed(args.backend):  # not launched: world 1
        init_distributed(args.backend,
                         init_method=f"tcp://127.0.0.1:{free_port()}",
                         rank=0, world_size=1)
    try:
        device = args.device
        if device == "cuda":
            device = f"cuda:{torch.cuda.current_device()}"
        losses = train(args.steps, device)
    finally:
        dist.destroy_process_group()
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
