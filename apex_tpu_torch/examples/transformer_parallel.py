"""3D-parallel transformer training: data x pipe x model under O2.

Port of ``examples/transformer_parallel/main_amp.py``:

- a mesh (data, pipe, model), default 2 x 2 x 2, one rank a process;
- a pipeline stage is ``blocks`` :class:`Stage` blocks (the JAX example
  has one): pre-LN tensor-parallel self-attention and a pre-LN
  tensor-parallel MLP, one all-reduce a sub-block each way;
- the GPipe schedule over ``pipe`` (:func:`~apex_tpu_torch.parallel.
  pipeline_apply`), M microbatches a step;
- O2: the bf16 model copy behind ``AmpOptimizer(fused_adam)``, fp32
  masters, dynamic loss scaling;
- gradients as in JAX: the loss divided by the model and pipe axis sizes
  (``replicated_loss``), the model-replicated parameters' partial
  gradients summed (``sync_replicated_grads``: the LayerNorms and the
  row-parallel biases), then ``DistributedDataParallel`` over ``data``.

A gang of ``data x pipe x model`` processes on the CPU::

    WORLD_SIZE=8 python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.transformer_parallel --device cpu \\
        --backend gloo --steps 4

The LayerNorms are flax ``nn.LayerNorm``'s (epsilon 1e-6) through the
port's LayerNorm kernels.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.parallel import (
    Axis,
    DistributedDataParallel,
    TensorParallelMLP,
    TensorParallelSelfAttention,
    init_distributed,
    make_mesh,
    pipeline_apply,
    replicated_loss,
    sync_replicated_grads,
)

LR = 3e-3
#: a Stage's model-replicated parameters (their gradients are partial
#: sums over the model axis)
REPLICATED = ("ln1.", "ln2.", "attn.proj.bias", "mlp.wo.bias")


def is_replicated(name: str) -> bool:
    """Whether a stage parameter (``<block>.<name>``) is replicated over
    the model axis."""
    return name.split(".", 1)[1].startswith(REPLICATED)


class Stage(nn.Module):
    """One block: pre-LN tensor-parallel attention, pre-LN
    tensor-parallel MLP, over ``model``."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int,
                 head_dim: int, model: Axis,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.ln1 = FusedLayerNorm(d_model, eps=1e-6)
        self.attn = TensorParallelSelfAttention(
            d_model, num_heads, head_dim, model, causal=True,
            compute_dtype=compute_dtype)
        self.ln2 = FusedLayerNorm(d_model, eps=1e-6)
        self.mlp = TensorParallelMLP(d_model, d_ff, model,
                                     compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x.float()))
        return x + self.mlp(self.ln2(x.float()))


def make_stage(blocks: int, d_model: int, d_ff: int, num_heads: int,
               head_dim: int, model: Axis,
               compute_dtype: torch.dtype = torch.bfloat16) -> nn.Sequential:
    """A pipeline stage of ``blocks`` :class:`Stage` blocks."""
    return nn.Sequential(*(Stage(d_model, d_ff, num_heads, head_dim, model,
                                 compute_dtype) for _ in range(blocks)))


def full_weights(stage: nn.Sequential, n_model: int, seed: int
                 ) -> Dict[str, torch.Tensor]:
    """Seeded full (unsharded) fp32 weights of a stage whose modules are
    sharded ``n_model`` ways: normal(0, 0.02) kernels, small random
    biases and LayerNorm parameters (so a misplaced gradient shows); the
    fused QKV in the natural (3, H, head_dim) column order."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in stage.named_parameters():
        shape = list(p.shape)
        if name.endswith("kernel"):
            if ".qkv." in name or ".wi." in name:
                shape[-1] *= n_model
            else:
                shape[0] *= n_model
            out[name] = torch.empty(shape).normal_(0.0, 0.02, generator=g)
        else:
            if name.endswith("bias") and (".qkv." in name or ".wi." in name):
                shape[-1] *= n_model
            base = 1.0 if ".ln" in name and name.endswith("weight") else 0.0
            out[name] = base + 0.02 * torch.randn(shape, generator=g)
    return out


def make_step(stage: nn.Module, amp_, opt, pipe: Axis, model: Axis,
              data: Axis):
    """``step(masters, state, x_mb, y_mb) -> (masters, state, loss)``: one
    optimizer step of the pipeline over this rank's (M, mb, S, D)
    microbatches; ``loss`` is the un-normalised mean loss."""
    ddp = (DistributedDataParallel(group=data.group) if data.size > 1
           else None)
    names, params = zip(*stage.named_parameters())

    def step(masters, state, x_mb, y_mb):
        out = pipeline_apply(lambda m, xb: m(xb), stage, x_mb, pipe)
        loss = (out.float() - y_mb).square().mean()
        norm = replicated_loss(replicated_loss(loss, model), pipe)
        # fp32, as JAX's gradients of its fp32 masters through the cast
        grads = {k: g.float() for k, g in zip(names, torch.autograd.grad(
            amp_.scale_loss(norm, state.scaler[0]), params))}
        sync_replicated_grads([g for k, g in grads.items()
                               if is_replicated(k)], model)
        if ddp is not None:
            grads = ddp.allreduce(grads)
        masters, state, _ = opt.step(grads, state, masters, model=stage)
        return masters, state, loss.detach()

    return step


def train(args) -> List[float]:
    """The example in the initialised process group: returns the per-step
    losses."""
    from apex_tpu_torch.weights import tp_shard_params

    dev = torch.device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh([("data", args.data), ("pipe", args.pipe),
                      ("model", args.model)])
    data, pipe, model = mesh["data"], mesh["pipe"], mesh["model"]
    amp_ = amp.initialize(args.opt_level)
    stage = make_stage(args.blocks, args.d_model, args.d_ff, args.heads,
                       args.head_dim, model, amp_.policy.compute_dtype)
    full = full_weights(stage, args.model, seed=100 + pipe.index)
    stage.load_state_dict(tp_shard_params(full, model.index, args.model))
    stage.to(dev)
    opt = amp.AmpOptimizer(fused_adam(LR), amp_)
    masters = opt.attach(stage)
    state = opt.init(masters)
    step = make_step(stage, amp_, opt, pipe, model, data)
    rng = np.random.RandomState(0)
    shape = (args.data * args.microbatches, args.mb, args.seq_len,
             args.d_model)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.5)
    y = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.5)
    rows = slice(data.index * args.microbatches,
                 (data.index + 1) * args.microbatches)
    x, y = x[rows].to(dev), y[rows].to(dev)
    losses = []
    for _ in range(args.steps):
        masters, state, loss = step(masters, state, x, y)
        losses.append(float(loss))
    amp.maybe_print(f"step  0: loss {losses[0]:.4f}")
    amp.maybe_print(f"step {args.steps - 1:2d}: loss {losses[-1]:.4f}")
    amp.maybe_print(f"3D-parallel {args.opt_level} training (mesh data="
                    f"{args.data} pipe={args.pipe} model={args.model})")
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--opt-level", default="O2", choices=["O0", "O2"])
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--pipe", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    # the JAX example's sizes
    ap.add_argument("--blocks", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=8)
    ap.add_argument("--mb", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=16)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not init_distributed(args.backend):
        raise SystemExit("run under python -m apex_tpu_torch.parallel."
                         "multiproc with WORLD_SIZE = data x pipe x model")
    try:
        losses = train(args)
    finally:
        dist.destroy_process_group()
    ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
