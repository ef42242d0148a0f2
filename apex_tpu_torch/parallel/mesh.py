"""Process groups and collectives: the port's data-parallel substrate.

Counterpart of ``apex_tpu/parallel/mesh.py``.  A named mesh axis becomes
a ``torch.distributed`` process group and a ``psum`` a SUM all-reduce:

=================================  =========================================
JAX package                        port
=================================  =========================================
``data_parallel_mesh(n)``          :func:`data_parallel_group`: the world
                                     group of the initialised process group
``axis_size(axis)``                :func:`world_size`
``syncbn_groups(world, g)``        :func:`syncbn_groups`, the same lists
``axis_index_groups=``             :func:`new_groups`: one process group a
                                     subgroup, made on every rank
``grouped_psum`` (all_gather and   :func:`grouped_all_reduce`: a real
  a group mask under shard_map)      subgroup all-reduce
``lax.psum``                       :func:`all_reduce`
``replicate(tree, mesh)``          :func:`replicate`: broadcast from the
                                     group's first rank
``shard_batch(tree, mesh)``        :func:`shard_batch`: this rank's rows
=================================  =========================================

Every collective of the port goes through :func:`all_reduce` or
:func:`replicate`, which count their calls by tag
(:func:`collective_counts`), as the kernel wrappers count their launches.
Only ``all_reduce`` and ``broadcast`` are used: gloo takes both on CUDA
tensors, and no ``all_gather``.  ``make_mesh`` (several axes) is not
ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor import tree_map

__all__ = ["Subgroups", "all_reduce", "collective_counts",
           "data_parallel_group", "grouped_all_reduce", "new_groups",
           "replicate", "reset_collective_counts", "shard_batch",
           "syncbn_groups", "world_size"]

_COUNTS: Dict[str, int] = collections.Counter()


def collective_counts() -> Dict[str, int]:
    """Collectives made since the last reset, by tag."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _require_init() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "apex_tpu_torch.parallel.init_distributed first")


def data_parallel_group():
    """The world group of the initialised default process group."""
    _require_init()
    return dist.group.WORLD


def world_size(group=None) -> int:
    """Ranks in ``group`` (None: the default group)."""
    _require_init()
    return dist.get_world_size(group)


def syncbn_groups(world_size: int, group_size: int) -> List[List[int]]:
    """Contiguous rank lists ``[[0..g-1], [g..2g-1], ...]`` for BatchNorm
    statistics over subgroups (ref ``create_syncbn_process_group``):
    ``world_size`` must be divisible by ``group_size``."""
    if group_size <= 0:
        raise ValueError("group_size must be positive")
    if world_size % group_size != 0:
        raise ValueError(f"world_size ({world_size}) must be divisible by "
                         f"group_size ({group_size})")
    return [list(range(i * group_size, (i + 1) * group_size))
            for i in range(world_size // group_size)]


@dataclasses.dataclass(frozen=True)
class Subgroups:
    """Disjoint rank lists and their process groups, made by
    :func:`new_groups`; each rank reduces over the one that holds it."""

    ranks: Tuple[Tuple[int, ...], ...]
    handles: Tuple[Any, ...]

    def _own(self) -> int:
        me = dist.get_rank()
        for i, r in enumerate(self.ranks):
            if me in r:
                return i
        raise ValueError(f"rank {me} is in no subgroup of {self.ranks}")

    def own_group(self):
        """The process group of this rank's subgroup."""
        return self.handles[self._own()]

    def own_size(self) -> int:
        """Ranks in this rank's subgroup."""
        return len(self.ranks[self._own()])


def new_groups(groups: Sequence[Sequence[int]]) -> Subgroups:
    """One process group per rank list, created on every rank in the
    same order (``dist.new_group`` is collective over the world: a rank
    that skipped a group it is not in would deadlock the others)."""
    _require_init()
    ranks = tuple(tuple(int(r) for r in g) for g in groups)
    flat = [r for g in ranks for r in g]
    if len(set(flat)) != len(flat):
        raise ValueError(f"subgroups overlap: {ranks}")
    return Subgroups(ranks, tuple(dist.new_group(ranks=list(g))
                                  for g in ranks))


def all_reduce(x: torch.Tensor, group=None, *,
               tag: str = "all_reduce") -> torch.Tensor:
    """SUM all-reduce of ``x`` in place over ``group`` (None: the default
    group); returns ``x``.  Counted under ``tag``."""
    _COUNTS[tag] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def grouped_all_reduce(x: torch.Tensor, groups: Subgroups, *,
                       tag: str = "all_reduce") -> torch.Tensor:
    """SUM all-reduce of ``x`` in place over this rank's subgroup."""
    return all_reduce(x, groups.own_group(), tag=tag)


def replicate(tree, group=None):
    """Every tensor of ``tree`` broadcast in place from the group's first
    rank (DDP's parameter broadcast at init); returns ``tree``."""
    _require_init()
    src = 0 if group is None else dist.get_global_rank(group, 0)

    def one(t):
        if isinstance(t, torch.Tensor):
            _COUNTS["broadcast"] += 1
            dist.broadcast(t, src, group=group)
        return t

    tree_map(one, tree)
    return tree


def shard_batch(tree, group=None):
    """This rank's rows ``[r n / w, (r + 1) n / w)`` of the leading axis
    of every tensor (the split ``P("data")`` gives device r in JAX); the
    leading axis must divide by the world size."""
    w = world_size(group)
    r = dist.get_rank(group)

    def one(t):
        n = t.shape[0]
        if n % w:
            raise ValueError(f"leading axis {n} does not divide into "
                             f"{w} ranks")
        return t[r * n // w:(r + 1) * n // w]

    return tree_map(one, tree)
