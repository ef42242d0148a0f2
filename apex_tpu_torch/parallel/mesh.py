"""Process groups and collectives: the port's substrate for every axis.

Counterpart of ``apex_tpu/parallel/mesh.py``.  A named mesh axis becomes
a ``torch.distributed`` process group, one per slice of the axis, and a
JAX collective one call on that group:

=================================  =========================================
JAX package                        port
=================================  =========================================
``data_parallel_mesh(n)``          :func:`data_parallel_group`: the world
                                     group of the initialised process group
``make_mesh([(name, size), ...])`` :func:`make_mesh`: a :class:`Mesh` of
                                     :class:`Axis` objects over the world,
                                     ranks laid out row-major
``axis_size(axis)``,               :func:`axis_size`, :func:`axis_index`
  ``lax.axis_index(axis)``           (of an :class:`Axis`); :func:`world_size`
``syncbn_groups(world, g)``        :func:`syncbn_groups`, the same lists
``axis_index_groups=``             :func:`new_groups`: one process group a
                                     subgroup, made on every rank
``grouped_psum`` (all_gather and   :func:`grouped_all_reduce`: a real
  a group mask under shard_map)      subgroup all-reduce
``lax.psum``                       :func:`all_reduce` (in place), or
                                     :func:`psum` (differentiable)
``lax.pmax``                       :func:`pmax` (no gradient)
``lax.all_gather(tiled=True)``     :func:`all_gather`
``lax.psum_scatter(tiled=True)``   :func:`reduce_scatter`
``lax.ppermute`` by +-1            :func:`ring_shift`
``lax.all_to_all(tiled=True)``     :func:`all_to_all`
``replicate(tree, mesh)``          :func:`replicate`: broadcast from the
                                     group's first rank
``shard_batch(tree, mesh)``        :func:`shard_batch`: this rank's rows
``PartitionSpec``                  :class:`P`: which axes shard a leaf
=================================  =========================================

Every collective of the port goes through this module, which counts its
calls by tag (:func:`collective_counts`), as the kernel wrappers count
their launches.  :func:`psum`, :func:`all_gather`, :func:`reduce_scatter`,
:func:`ring_shift` and :func:`all_to_all` are differentiable with JAX's
transposes, not Megatron's conventions: ``psum``'s backward is a
``psum`` of the cotangent (so a loss that is replicated over an axis is
divided by its size first: ``tensor_parallel.replicated_loss``), an
``all_gather``'s a ``reduce_scatter`` and the reverse, a shift's the
reverse shift and an all-to-all's the reverse all-to-all.  Each
backward's collective is counted like a forward's.

Backends.  NCCL takes every collective here on CUDA tensors; gloo takes
all of them on CPU tensors.  On CUDA tensors gloo takes the (collective,
dtype) pairs of :data:`GLOO_CUDA` and not the point-to-point pair a ring
shift is made of (``apex_tpu_torch/tools/gloo_cuda_probe.py`` measures
this on a card: torch 2.11's gloo gives the right values for the SUM
``all_reduce`` and ``reduce_scatter_tensor`` in fp32, bf16 and int8, the
fp32 MAX ``all_reduce``, ``all_gather(_into_tensor)`` in fp32, bf16 and
int8, ``all_to_all_single`` in fp32 and bf16 and fp32 ``broadcast``, and
its ``isend``/``irecv`` pair fails).  So under gloo a CUDA tensor's
collective outside that table goes through host memory: the tensor is
copied to the CPU, the collective runs there and the result is copied
back.  The backend, the device, the op and the dtype choose that branch,
never a caught failure; it is counted under ``<tag>[host]`` and is never
taken under NCCL.  A collective that a backend does not take raises.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor import tree_map

__all__ = ["Axis", "GLOO_CUDA", "Mesh", "P", "Subgroups", "all_gather",
           "all_reduce", "all_to_all", "axis_index", "axis_size",
           "collective_counts", "data_parallel_group", "grouped_all_reduce",
           "group_axis", "make_mesh", "new_groups", "pmax", "psum",
           "reduce_scatter", "replicate",
           "reset_collective_counts", "ring_shift", "shard_batch",
           "syncbn_groups", "world_size"]

#: the (collective, dtype) pairs gloo takes on CUDA tensors, as
#: tools/gloo_cuda_probe.py measured them on an H100 (torch 2.11); any
#: other goes through host memory under gloo (the module docstring)
GLOO_CUDA = frozenset(
    [(op, dt) for op in ("all_reduce", "reduce_scatter", "all_gather")
     for dt in (torch.float32, torch.bfloat16, torch.int8)]
    + [("all_to_all", torch.float32), ("all_to_all", torch.bfloat16),
       ("all_reduce_max", torch.float32), ("broadcast", torch.float32)])

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


# -- meshes of several axes ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the process group of its slice
    along the axis and the global ranks of that slice, in axis order.

    ``Axis.single(name)`` is an axis of one member and no group: every
    collective over it is the identity and nothing is counted (JAX's
    collectives over an axis of size 1)."""

    name: str
    ranks: Tuple[int, ...]
    group: Any = None

    @staticmethod
    def single(name: str) -> "Axis":
        rank = dist.get_rank() if dist.is_initialized() else 0
        return Axis(name, (rank,), None)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This rank's position along the axis."""
        if self.group is None:
            return 0
        return self.ranks.index(dist.get_rank())


def axis_size(axis: Axis) -> int:
    """The axis's size (JAX's ``axis_size``)."""
    return axis.size


def axis_index(axis: Axis) -> int:
    """This rank's index along the axis (``lax.axis_index``)."""
    return axis.index


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over the world's ranks, laid out row-major: rank ``r``
    sits at ``np.unravel_index(r, shape)``, so earlier axes vary
    slowest, as ``Mesh(np.array(devices).reshape(shape))`` places the
    devices.  ``mesh["seq"]`` is this rank's :class:`Axis` along it."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    axes: Tuple[Axis, ...]

    def __getitem__(self, name: str) -> Axis:
        if name not in self.axis_names:
            raise KeyError(f"no axis {name!r} in mesh axes "
                           f"{self.axis_names}")
        return self.axes[self.axis_names.index(name)]

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        return {a.name: a.index for a in self.axes}


def group_axis(group=None, name: str = "data") -> Axis:
    """The :class:`Axis` of a process group (None: the default group), for
    the axis-based collectives over a group-based policy such as
    ``DistributedDataParallel(group=)``."""
    _require_init()
    g = dist.group.WORLD if group is None else group
    return Axis(name, tuple(dist.get_process_group_ranks(g)), g)


def make_mesh(axes: Sequence[Tuple[str, int]]) -> Mesh:
    """A :class:`Mesh` from ordered ``(axis_name, size)`` pairs over the
    initialised world, e.g. ``make_mesh([("data", 2), ("seq", 2)])``; the
    sizes must multiply to the world size.  Every process group of every
    axis slice is made on every rank, in one order (``dist.new_group`` is
    collective over the world)."""
    _require_init()
    names = tuple(str(n) for n, _ in axes)
    shape = tuple(int(s) for _, s in axes)
    if len(set(names)) != len(names) or any(s < 1 for s in shape):
        raise ValueError(f"mesh axes must have distinct names and positive "
                         f"sizes, got {list(axes)}")
    world = dist.get_world_size()
    n = math.prod(shape)
    if n != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} holds {n} ranks, "
                         f"the world {world}")
    me = dist.get_rank()
    grid = torch.arange(world).reshape(shape)
    mine = []
    for i, name in enumerate(names):
        # every slice along axis i: the other coordinates fixed
        slices = grid.movedim(i, -1).reshape(-1, shape[i]).tolist()
        handle = None
        for ranks in slices:
            g = dist.new_group(ranks=ranks)
            if me in ranks:
                handle, own = g, tuple(ranks)
        mine.append(Axis(name, own, handle))
    return Mesh(names, shape, tuple(mine))


@dataclasses.dataclass(frozen=True, init=False)
class P:
    """``PartitionSpec``: the mesh axes that shard each leading dimension
    of a leaf (a name, a tuple of names, or None); ``P()`` is a
    replicated leaf.  The driver's ``batch_spec`` and ``carry_spec`` are
    trees of these."""

    dims: Tuple[Any, ...]

    def __init__(self, *dims):
        object.__setattr__(self, "dims", tuple(dims))

    def __repr__(self) -> str:
        return f"P{self.dims!r}"


# -- counted collectives over an Axis ------------------------------------------


# the flat-tensor collectives under their current names (older torch has
# only the *_tensor ones)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _staged(x: torch.Tensor, axis: Axis, op: str) -> bool:
    """Whether this collective goes through host memory: a CUDA tensor
    under gloo, for an (op, dtype) pair gloo does not take on CUDA
    tensors."""
    return (x.is_cuda and (op, x.dtype) not in GLOO_CUDA
            and dist.get_backend(axis.group) == "gloo")


def _count(tag: str, staged: bool) -> None:
    _COUNTS[f"{tag}[host]" if staged else tag] += 1


def _run(x: torch.Tensor, axis: Axis, op: str, tag: str, fn):
    """``fn(x)`` (a collective on a contiguous tensor), through host
    memory where :func:`_staged` says so; counted under ``tag``."""
    staged = _staged(x, axis, op)
    _count(tag, staged)
    if not staged:
        return fn(x.contiguous())
    return fn(x.detach().contiguous().cpu()).to(x.device)


def _all_gather(x, axis, dim, tag):
    def go(t):  # flat buffers: gloo takes only the concatenated form
        out = t.new_empty(axis.size * t.numel())
        _ALL_GATHER(out, t.reshape(-1), group=axis.group)
        return out.view((axis.size,) + tuple(t.shape))
    out = _run(x, axis, "all_gather", tag, go)
    return torch.cat(out.unbind(0), dim=dim)


def _reduce_scatter(x, axis, dim, tag):
    n = axis.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of "
                         f"{tuple(x.shape)} does not divide into {n}")
    stacked = torch.stack(x.chunk(n, dim=dim))

    def go(t):
        out = t.new_empty(t[0].numel())
        _REDUCE_SCATTER(out, t.reshape(-1), op=dist.ReduceOp.SUM,
                        group=axis.group)
        return out.view(t.shape[1:])
    return _run(stacked, axis, "reduce_scatter", tag, go)


def _ring_shift(x, axis, shift, tag):
    n, r = axis.size, axis.index
    dst = axis.ranks[(r + shift) % n]
    src = axis.ranks[(r - shift) % n]

    def go(t):
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, dst, axis.group),
               dist.P2POp(dist.irecv, out, src, axis.group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return out
    return _run(x, axis, "ring_shift", tag, go)


def _all_to_all(x, axis, split_dim, concat_dim, tag):
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not divide into {n}")
    stacked = torch.stack(x.chunk(n, dim=split_dim))

    def go(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=axis.group)
        return out
    out = _run(stacked, axis, "all_to_all", tag, go)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _psum(x, axis, tag, op="all_reduce"):
    red = dist.ReduceOp.MAX if op == "all_reduce_max" else dist.ReduceOp.SUM

    def go(t):
        t = t.clone()
        dist.all_reduce(t, op=red, group=axis.group)
        return t
    return _run(x, axis, op, tag, go)


class _Collective(torch.autograd.Function):
    """A collective and, in the backward, its JAX transpose."""

    @staticmethod
    def forward(ctx, x, kind, axis, args, tag):
        ctx.kind, ctx.axis, ctx.args, ctx.tag = kind, axis, args, tag
        return _forward(kind, x, axis, args, tag)

    @staticmethod
    def backward(ctx, g):
        kind, axis, args, tag = ctx.kind, ctx.axis, ctx.args, ctx.tag
        if kind == "psum":
            dx = _psum(g, axis, tag)
        elif kind == "all_gather":
            dx = _reduce_scatter(g, axis, args[0], tag)
        elif kind == "reduce_scatter":
            dx = _all_gather(g, axis, args[0], tag)
        elif kind == "ring_shift":
            dx = _ring_shift(g, axis, -args[0], tag)
        else:
            dx = _all_to_all(g, axis, args[1], args[0], tag)
        return dx, None, None, None, None


def _forward(kind, x, axis, args, tag):
    if kind == "psum":
        return _psum(x, axis, tag)
    if kind == "all_gather":
        return _all_gather(x, axis, args[0], tag)
    if kind == "reduce_scatter":
        return _reduce_scatter(x, axis, args[0], tag)
    if kind == "ring_shift":
        return _ring_shift(x, axis, args[0], tag)
    return _all_to_all(x, axis, args[0], args[1], tag)


def _collective(kind, x, axis, args, tag):
    if axis.group is None:
        if axis.size != 1:
            raise ValueError(f"axis {axis.name!r} of size {axis.size} has "
                             f"no process group")
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Collective.apply(x, kind, axis, args, tag)
    return _forward(kind, x, axis, args, tag)


def psum(x: torch.Tensor, axis: Axis, *,
         tag: str = "all_reduce") -> torch.Tensor:
    """SUM over the axis, out of place (``lax.psum``); the backward sums
    the cotangent over the axis too."""
    return _collective("psum", x, axis, (), tag)


def pmax(x: torch.Tensor, axis: Axis, *, tag: str = "pmax") -> torch.Tensor:
    """MAX over the axis, out of place (``lax.pmax``); not
    differentiable: the codecs take it of a detached scale."""
    if axis.group is None:
        if axis.size != 1:
            raise ValueError(f"axis {axis.name!r} of size {axis.size} has "
                             f"no process group")
        return x
    return _psum(x.detach(), axis, tag, op="all_reduce_max")


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0, *,
               tag: str = "all_gather") -> torch.Tensor:
    """The axis members' ``x`` concatenated along ``dim`` in axis order
    (``lax.all_gather(tiled=True)``)."""
    return _collective("all_gather", x, axis, (dim,), tag)


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int = 0, *,
                   tag: str = "reduce_scatter") -> torch.Tensor:
    """SUM over the axis, of which this rank keeps block ``index`` of
    ``dim`` (``lax.psum_scatter(tiled=True)``); ``dim`` must divide by
    the axis size."""
    return _collective("reduce_scatter", x, axis, (dim,), tag)


def ring_shift(x: torch.Tensor, axis: Axis, shift: int = 1, *,
               tag: str = "ring_shift") -> torch.Tensor:
    """Member ``j``'s ``x`` to member ``(j + shift) mod n``
    (``lax.ppermute`` over the ring); the identity on an axis of one
    member, where no collective is made."""
    if axis.size == 1:
        return x
    return _collective("ring_shift", x, axis, (int(shift),), tag)


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int,
               *, tag: str = "all_to_all") -> torch.Tensor:
    """``lax.all_to_all(split_axis, concat_axis, tiled=True)``: block
    ``j`` of ``split_dim`` goes to member ``j``, and the blocks received
    are concatenated along ``concat_dim`` in axis order."""
    return _collective("all_to_all", x, axis, (split_dim, concat_dim), tag)
