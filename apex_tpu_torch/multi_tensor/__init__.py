"""Multi-tensor primitives over lists or dicts of tensors.

Counterpart of ``apex_tpu/multi_tensor/__init__.py`` (apex's ``amp_C``
multi-tensor kernels): scale, unscale, ``a*x + b*y``, L2 and max norms
and the non-finite check, over a "tree" that is a dict (name -> tensor)
or a list/tuple of tensors; outputs keep the container type.  The reductions
accumulate in fp32 whatever the leaf dtype: on the card one multi-tensor
launch (``torch._foreach_norm``), on the CPU the L2 norm as the JAX
package takes it, ``sqrt(sum(x * x))`` per leaf (the CPU's
``_foreach_norm`` sums naively: 2.4e-3 relative off at GPT-2's
(50257, 768) word table); the found_inf flag is a 0-d bool tensor on the
device, never read on the host.
"""
from __future__ import annotations

import math
from typing import Callable, List, Mapping, Sequence, Tuple, TypeVar, Union

import torch

__all__ = ["multi_tensor_axpby", "multi_tensor_l2norm", "multi_tensor_scale",
           "multi_tensor_unscale", "tree_finite", "tree_leaves", "tree_map"]

Tree = TypeVar("Tree", bound=Union[Mapping[str, torch.Tensor],
                                   Sequence[torch.Tensor]])


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a dict (in key order) or a list/tuple."""
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` leaf by leaf over nested dicts, lists, tuples and
    NamedTuples and matching ``rest``; the result has the first tree's
    containers (dicts come back as dicts).  ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *args) for args in zip(tree, *rest)]
        if hasattr(tree, "_fields"):  # a NamedTuple
            return type(tree)(*out)
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_finite(tree) -> torch.Tensor:
    """True iff every element of every leaf is finite (0-d bool)."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.isfinite(multi_tensor_l2norm(tree, max_norm=True))


def multi_tensor_scale(tree: Tree, scale) -> Tuple[Tree, torch.Tensor]:
    """``out = in * scale`` (bf16 leaves scaled in fp32 and rounded back),
    plus a found_inf flag over the outputs."""
    def one(x):
        if x.dtype == torch.bfloat16:
            return (x.float() * scale).to(x.dtype)
        return x * scale
    scaled = tree_map(one, tree)
    return scaled, torch.logical_not(tree_finite(scaled))


def multi_tensor_l2norm(tree, *, per_tensor: bool = False,
                        max_norm: bool = False):
    """Global L2 (or max-abs) norm over all leaves, in fp32; with
    ``per_tensor`` also the per-leaf norms in the tree's container."""
    leaves = tree_leaves(tree)
    if not leaves:
        total = torch.tensor(0.0)
        return (total, tree_map(lambda x: x, tree)) if per_tensor else total
    if max_norm:
        norms = torch._foreach_norm(leaves, math.inf, dtype=torch.float32)
        total = torch.stack(norms).max()
    elif leaves[0].is_cuda:
        norms = torch._foreach_norm(leaves, 2.0, dtype=torch.float32)
        total = torch.linalg.vector_norm(torch.stack(norms))
    else:
        sq = [torch.sum(x.float().square()) for x in leaves]
        norms = torch._foreach_sqrt(sq)
        total = torch.sqrt(torch.stack(sq).sum())
    if not per_tensor:
        return total
    if isinstance(tree, Mapping):
        return total, dict(zip(tree.keys(), norms))
    return total, type(tree)(norms) if isinstance(tree, tuple) else norms


def multi_tensor_unscale(tree: Tree, inv_scale) -> Tuple[Tree, torch.Tensor]:
    """Gradient unscale: fp32 ``g * inv_scale`` plus a found_inf flag."""
    out = tree_map(lambda g: g.float() * inv_scale, tree)
    return out, torch.logical_not(tree_finite(out))


def multi_tensor_axpby(x_tree: Tree, y_tree: Tree, a, b, *,
                       check: str = "both") -> Tuple[Tree, torch.Tensor]:
    """``out = a*x + b*y`` leaf by leaf, computed in fp32 and returned in
    the promoted dtype of ``x`` and ``y``, plus a found_inf flag over the
    operand ``check`` names (the reference functor's ``arg_to_check``):
    ``'x'``, ``'y'`` or ``'both'`` (the output)."""
    if check not in ("x", "y", "both"):
        raise ValueError(f"check must be 'x', 'y' or 'both', got {check!r}")
    names = list(x_tree) if isinstance(x_tree, Mapping) else None
    xs, ys = tree_leaves(x_tree), [y_tree[k] for k in names] \
        if names is not None else tree_leaves(y_tree)
    out = torch._foreach_mul([x.float() for x in xs], a)
    torch._foreach_add_(out, torch._foreach_mul([y.float() for y in ys], b))
    out = [o.to(torch.promote_types(x.dtype, y.dtype))
           for o, x, y in zip(out, xs, ys)]
    checked = {"x": x_tree, "y": y_tree, "both": out}[check]
    found_inf = torch.logical_not(tree_finite(checked))
    if names is not None:
        return dict(zip(names, out)), found_inf
    return (tuple(out) if isinstance(x_tree, tuple) else out), found_inf
