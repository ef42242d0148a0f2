"""Data parallelism across processes: the DistributedDataParallel policy.

Counterpart of ``apex_tpu/parallel/distributed.py``.  Each process holds
one replica and computes the gradients of its own shard with eager
autograd; :meth:`DistributedDataParallel.allreduce` then reduces them
over the process group with the reference's scaling policy:

==============================================  ============================
JAX package                                     port
==============================================  ============================
``DistributedDataParallel(axis_name=...)``      ``(group=...)``: a process
                                                  group (None: the default)
``axis_index_groups=``                          ``groups=``: the
                                                  :class:`~.mesh.Subgroups`
                                                  of :func:`~.mesh.new_groups`
``gradient_average``, ``gradient_predivide_``   the same fields, the same
  ``factor``, ``allreduce_always_fp32``           order of operations
``delay_allreduce`` (warns once)                the same
``local_params`` (``pcast`` to varying)         the identity
``allreduce``: one ``psum`` a leaf              one SUM all-reduce a dtype,
                                                  over a flat buffer
``Reducer``                                     :class:`Reducer`
``data_parallel_step`` (``shard_map`` + jit,    :func:`data_parallel_step`:
  ``lax.scan`` over K)                            a loop over K on each rank
``flatten_tree`` / ``unflatten_tree``           the same
==============================================  ============================

This is not ``torch.nn.parallel.DistributedDataParallel``: that class
wraps a module with backward hooks and buckets and averages on its own
terms.  Here the caller computes the gradients and hands them over::

    ddp = DistributedDataParallel()
    grads = dict(zip(names, torch.autograd.grad(scaled_loss, params)))
    grads = ddp.allreduce(grads)        # averaged over the group
    masters, state, stats = opt.step(grads, state, masters, model=model)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch

from apex_tpu_torch.parallel import mesh as mesh_lib

__all__ = ["DistributedDataParallel", "Reducer", "data_parallel_step",
           "flatten_tree", "unflatten_tree"]


def _tree_flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of nested dicts, lists, tuples and NamedTuples in
    order, and a function that rebuilds the tree from a list of
    tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, Mapping):
        keys = list(tree)
        parts = [_tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_tree_flatten(v) for v in tree]
    else:
        raise TypeError(f"not a tree of tensors: {type(tree).__name__}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)

    return [t for p in parts for t in p[0]], rebuild


@dataclasses.dataclass(frozen=True)
class DistributedDataParallel:
    """Gradient-averaging policy over a process group (ref
    distributed.py:129-253).

    Fields: ``group`` (None: the default process group);
    ``gradient_average`` (divide the sum by the world size);
    ``gradient_predivide_factor`` (divide before the sum and by
    world / factor after); ``allreduce_always_fp32`` (half leaves summed
    in fp32 and cast back); ``delay_allreduce`` (accepted, says once
    that it does nothing: the reduction already follows the whole
    backward); ``groups`` (:class:`~.mesh.Subgroups`: each rank reduces
    over its own subgroup, the reference's process-group argument)."""

    group: Any = None
    gradient_average: bool = True
    gradient_predivide_factor: float = 1.0
    allreduce_always_fp32: bool = False
    delay_allreduce: bool = False
    groups: Optional[mesh_lib.Subgroups] = None

    def __post_init__(self):
        if self.delay_allreduce:
            from apex_tpu_torch.amp import warn_once

            warn_once("ddp.delay_allreduce",
                      "apex_tpu_torch DDP: delay_allreduce=True is accepted "
                      "for config parity but has no effect: the gradients "
                      "are reduced once, after the whole backward.")

    def world(self) -> int:
        """Ranks the gradients are summed over."""
        if self.groups is not None:
            return self.groups.own_size()
        return mesh_lib.world_size(self.group)

    def local_params(self, params):
        """The identity.  In JAX the replicated parameters are cast to
        device-varying so that their gradients stay per shard; eager
        autograd on a process's own replica gives its local gradients
        already."""
        return params

    def _all_reduce(self, flat: torch.Tensor) -> torch.Tensor:
        if self.groups is not None:
            return mesh_lib.grouped_all_reduce(flat, self.groups, tag="ddp")
        return mesh_lib.all_reduce(flat, self.group, tag="ddp")

    def allreduce(self, grads, enabled: bool = True):
        """Sum-reduce ``grads`` (a tree of tensors) over the group with
        the reference's scaling policy; returns a new tree.

        Leaf by leaf the arithmetic is the JAX version's (ref
        allreduce_bucket, distributed.py:425-475): the optional fp32
        upcast, ``/ gradient_predivide_factor`` (applied whenever the
        factor is not 1, averaging or not, as the reference does), the
        SUM, ``/ (world / factor)`` when averaging, the cast back.  The
        leaves of one dtype share one flat buffer and one collective (the
        reference's flat bucket), so bf16 leaves are summed in bf16
        unless ``allreduce_always_fp32``.  ``enabled=False`` is the
        no-sync path (ref disable_allreduce)."""
        if not enabled:
            return grads
        leaves, rebuild = _tree_flatten(grads)
        buckets = {}
        for i, g in enumerate(leaves):
            buckets.setdefault(g.dtype, []).append(i)
        out: List[Optional[torch.Tensor]] = [None] * len(leaves)
        pre = self.gradient_predivide_factor
        for dtype, idx in buckets.items():
            sum_dtype = torch.float32 if self.allreduce_always_fp32 else dtype
            flat = torch.cat([leaves[i].reshape(-1).to(sum_dtype)
                              for i in idx])
            if pre != 1.0:
                flat.div_(pre)
            self._all_reduce(flat)
            if self.gradient_average:
                flat.div_(self.world() / pre)
            flat = flat.to(dtype)
            off = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = flat[off:off + n].view(leaves[i].shape)
                off += n
        return rebuild(out)


class Reducer:
    """Manual reduction of gradients or buffers (ref
    distributed.py:89-126): returns the tree summed, or averaged, over
    the group, one collective a dtype."""

    def __init__(self, group=None, average: bool = True):
        self.group = group
        self.average = average

    def reduce(self, tree):
        return DistributedDataParallel(
            group=self.group, gradient_average=self.average).allreduce(tree)


def data_parallel_step(step_fn: Callable, group=None, *,
                       steps_per_dispatch: int = 1) -> Callable:
    """Wrap a per-rank ``step_fn(state, batch) -> (state, metrics)``.

    Each rank calls the wrapper with its replica of ``state`` and its own
    shard of the batch (:func:`~.mesh.shard_batch`); ``step_fn`` makes
    its collectives itself (``ddp.allreduce``, SyncBatchNorm).  With
    ``steps_per_dispatch=K > 1`` the batch has a leading K axis: the
    wrapper runs the K steps in order and returns the per-step metrics
    stacked on that axis (JAX's per-step contract; the window meters of
    :class:`~apex_tpu_torch.train.FusedTrainDriver` are the other
    one)."""
    k = int(steps_per_dispatch)
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    mesh_lib.world_size(group)  # raises without a process group
    if k == 1:
        return step_fn

    def window(state, batches):
        per_step = []
        for i in range(k):
            state, metrics = step_fn(state, _tree_index(batches, i))
            per_step.append(metrics)
        leaves, rebuild = _tree_flatten(per_step[0])
        stacked = [torch.stack([_tree_flatten(m)[0][j] for m in per_step])
                   for j in range(len(leaves))]
        return state, rebuild(stacked)

    return window


def _tree_index(tree, i: int):
    leaves, rebuild = _tree_flatten(tree)
    return rebuild([t[i] for t in leaves])


def flatten_tree(tree) -> Tuple[torch.Tensor, tuple]:
    """Every leaf of ``tree`` in one flat fp32 buffer, and the spec that
    :func:`unflatten_tree` restores it with (ref apex_C.flatten)."""
    leaves, rebuild = _tree_flatten(tree)
    spec = (rebuild, [t.shape for t in leaves], [t.dtype for t in leaves],
            [t.numel() for t in leaves])
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in leaves])
    return flat, spec


def unflatten_tree(flat: torch.Tensor, spec: tuple):
    """The inverse of :func:`flatten_tree`: each leaf a piece of
    ``flat`` in its own shape and dtype (ref apex_C.unflatten)."""
    rebuild, shapes, dtypes, sizes = spec
    out, off = [], 0
    for shape, dtype, size in zip(shapes, dtypes, sizes):
        out.append(flat[off:off + size].view(shape).to(dtype))
        off += size
    return rebuild(out)
