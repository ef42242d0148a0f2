"""ZeRO-style sharded optimizers: DistributedFusedAdam and
DistributedFusedLAMB.

Counterpart of ``apex_tpu/contrib/optimizers/distributed_fused.py`` (ref
apex/contrib/optimizers/distributed_fused_adam.py and
distributed_fused_lamb.py).  One step over a data
:class:`~apex_tpu_torch.parallel.mesh.Axis` of n ranks::

    flat_g  = the gradients in one fp32 buffer, padded to a multiple of n
    g_shard = reduce_scatter(flat_g)             # this rank's 1/n, summed
    master, m, v live only for the local shard   # the ZeRO memory saving
    shard'  = the Adam / LAMB update of the shard
    params  = unflatten(all_gather(shard'))

The flat layout (:class:`FlatSpec`) follows the order of the parameter
dict.  LAMB's global gradient norm is one all-reduce of the shards'
partial sums, and its per-tensor trust ratios come from shard-local
segment sums plus one small all-reduce.  The update is plain PyTorch on
one flat shard, as JAX's is jnp: no Pallas kernel ran there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from apex_tpu_torch.parallel.mesh import Axis, all_gather, psum, reduce_scatter

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB", "FlatSpec",
           "ShardedOptState"]

Params = Mapping[str, torch.Tensor]


class FlatSpec(NamedTuple):
    """The flat layout of a parameter dict, padded to a world multiple."""

    names: Tuple[str, ...]
    shapes: Tuple[torch.Size, ...]
    dtypes: Tuple[torch.dtype, ...]
    sizes: Tuple[int, ...]
    padded: int


def _make_spec(params: Params, world: int) -> FlatSpec:
    names = tuple(params)
    sizes = tuple(params[k].numel() for k in names)
    total = sum(sizes)
    padded = -(-total // world) * world
    return FlatSpec(names, tuple(params[k].shape for k in names),
                    tuple(params[k].dtype for k in names), sizes, padded)


def _flatten(tree: Params, spec: FlatSpec) -> torch.Tensor:
    flat = torch.cat([tree[k].reshape(-1).float() for k in spec.names])
    return torch.nn.functional.pad(flat, (0, spec.padded - flat.numel()))


def _unflatten(flat: torch.Tensor, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape, dtype, size in zip(spec.names, spec.shapes, spec.dtypes,
                                        spec.sizes):
        out[name] = flat[off:off + size].reshape(shape).to(dtype)
        off += size
    return out


class ShardedOptState(NamedTuple):
    step: torch.Tensor          # i32 0-d
    master_shard: torch.Tensor  # fp32 (padded / world,)
    m_shard: torch.Tensor
    v_shard: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistributedFusedAdam:
    """ZeRO Adam/AdamW over ``axis`` (ref distributed_fused_adam.py):
    ``gradient_predivide_factor`` divides the gradients before the
    reduce-scatter, ``gradient_average`` divides the sum by the world
    over that factor, ``adam_w_mode`` chooses decoupled decay or L2."""

    axis: Axis
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    adam_w_mode: bool = True
    bias_correction: bool = True
    gradient_average: bool = True
    gradient_predivide_factor: float = 1.0

    def make_spec(self, params: Params, world: int = None) -> FlatSpec:
        """The flat layout of ``params`` (world: the axis size)."""
        return _make_spec(params, self.axis.size if world is None else world)

    def _shard(self, flat: torch.Tensor, spec: FlatSpec) -> torch.Tensor:
        n = spec.padded // self.axis.size
        return flat[self.axis.index * n:(self.axis.index + 1) * n]

    def init(self, params: Params, spec: FlatSpec) -> ShardedOptState:
        """This rank's state: its master shard and zero moments."""
        master = self._shard(_flatten(params, spec), spec).clone()
        return ShardedOptState(
            torch.zeros((), dtype=torch.int32, device=master.device), master,
            torch.zeros_like(master), torch.zeros_like(master))

    def _reduce_scatter(self, grads: Params, spec: FlatSpec) -> torch.Tensor:
        flat_g = _flatten(grads, spec)
        pre = self.gradient_predivide_factor
        if pre != 1.0:
            flat_g = flat_g / pre
        g_shard = reduce_scatter(flat_g, self.axis, tag="zero_grads")
        if self.gradient_average:
            g_shard = g_shard / (self.axis.size / pre)
        return g_shard

    def _moments(self, g, state: ShardedOptState):
        b1, b2 = self.betas
        step = state.step + 1
        t = step.float()
        one = torch.ones((), device=t.device)
        bc1 = 1 - torch.pow(b1, t) if self.bias_correction else one
        bc2 = 1 - torch.pow(b2, t) if self.bias_correction else one
        m = b1 * state.m_shard + (1 - b1) * g
        v = b2 * state.v_shard + (1 - b2) * g * g
        return step, m, v, (m / bc1) / (torch.sqrt(v / bc2) + self.eps)

    def _shard_update(self, g, state: ShardedOptState,
                      lr: float) -> ShardedOptState:
        p = state.master_shard
        if not self.adam_w_mode and self.weight_decay:
            g = g + self.weight_decay * p
        step, m, v, upd = self._moments(g, state)
        if self.adam_w_mode and self.weight_decay:
            upd = upd + self.weight_decay * p
        return ShardedOptState(step, p - lr * upd, m, v)

    def _gather(self, shard: torch.Tensor, spec: FlatSpec):
        return _unflatten(all_gather(shard, self.axis, tag="zero_params"),
                          spec)

    def step(self, grads: Params, state: ShardedOptState, spec: FlatSpec
             ) -> Tuple[Dict[str, torch.Tensor], ShardedOptState]:
        """reduce-scatter, the shard's update, all-gather: returns the new
        parameters (a new dict) and state."""
        g_shard = self._reduce_scatter(grads, spec)
        new = self._shard_update(g_shard, state, self.lr)
        return self._gather(new.master_shard, spec), new


@dataclasses.dataclass(frozen=True)
class DistributedFusedLAMB(DistributedFusedAdam):
    """ZeRO LAMB (ref distributed_fused_lamb.py): the sharded Adam
    moments, the global gradient-norm clip and per-tensor trust ratios.
    Per step the collectives are the gradients' reduce-scatter, one
    scalar all-reduce of the norm, one all-reduce of the (2, tensors)
    partial sums and the new shard's all-gather."""

    eps: float = 1e-6
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    use_nvlamb: bool = False

    def _segments(self, spec: FlatSpec):
        """Lengths of this shard's pieces of each tensor (0 where a
        tensor lies outside it) and of its padding tail."""
        n = spec.padded // self.axis.size
        lo, hi = self.axis.index * n, (self.axis.index + 1) * n
        lengths, start = [], 0
        for size in spec.sizes:
            lengths.append(max(0, min(hi, start + size) - max(lo, start)))
            start += size
        lengths.append(n - sum(lengths))
        return lengths

    def step(self, grads: Params, state: ShardedOptState, spec: FlatSpec
             ) -> Tuple[Dict[str, torch.Tensor], ShardedOptState]:
        g_shard = self._reduce_scatter(grads, spec)
        gnorm = torch.sqrt(psum(torch.sum(g_shard * g_shard), self.axis,
                                tag="zero_norm"))
        if self.max_grad_norm:
            g_shard = g_shard / torch.clamp_min(gnorm / self.max_grad_norm,
                                                1.0)
        p = state.master_shard
        step, m, v, u = self._moments(g_shard, state)
        if self.weight_decay:
            u = u + self.weight_decay * p
        lengths = self._segments(spec)
        k = len(spec.sizes)
        partial = torch.stack([
            torch.stack([seg.sum() for seg in (x * x).split(lengths)])
            for x in (p, u)])
        sums = psum(partial, self.axis, tag="zero_norm")
        r1, r2 = torch.sqrt(sums[0, :k]), torch.sqrt(sums[1, :k])
        if self.weight_decay != 0.0 or self.use_nvlamb:
            ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, 1.0)
        else:
            ratio = torch.ones(k, device=p.device)
        ratio = torch.cat([ratio, torch.ones(1, device=p.device)])
        ratio_elem = ratio.repeat_interleave(
            torch.tensor(lengths, device=p.device), output_size=p.numel())
        new_master = p - self.lr * ratio_elem * u
        return self._gather(new_master, spec), ShardedOptState(
            step, new_master, m, v)
