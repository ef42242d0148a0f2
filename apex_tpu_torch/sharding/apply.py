"""Mesh-aware application of partition rules: place, gather, check, and
the reshard-on-restore record.

Counterpart of ``apex_tpu/sharding/apply.py``.  In the port no rank holds
a global array: a sharded leaf is this rank's block.  So:

- :func:`train_mesh` builds the dp / dp x fsdp / dp x tp meshes over the
  initialised world (:func:`apex_tpu_torch.parallel.make_mesh`);
- :func:`shard_tree` cuts this rank's block out of every full leaf, and
  :func:`gather_tree` all-gathers the blocks back into full leaves;
- :func:`constrain_tree` has nothing to constrain (JAX's
  ``with_sharding_constraint`` hints a compiler): it checks that every
  leaf has the local shape its spec gives and raises otherwise;
- :func:`carry_spec_from_rules` makes a driver ``carry_spec`` from a
  table and a carry template;
- :func:`rules_outcome` records a sharding decision next to a
  checkpoint, and :func:`outcomes_differ` tells a restore whether the
  live table, mesh and mode still match the saved ones.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from apex_tpu_torch.sharding.rules import (
    RulesTable,
    _block_index,
    _dim_axes,
    _spec_leaves,
    make_shard_and_gather_fns,
    match_partition_rules,
    named_tree_paths,
    spec_str,
    tree_leaves,
    tree_unflatten,
)

__all__ = [
    "carry_spec_from_rules",
    "constrain_tree",
    "gather_tree",
    "mesh_axes",
    "outcomes_differ",
    "rules_outcome",
    "shard_tree",
    "train_mesh",
]

Tree = Any

OUTCOME_SCHEMA = "apex_tpu.sharding.outcome.v1"


def train_mesh(dp: int, tp: int = 1, fsdp: int = 1, *,
               dp_axis: str = "data", tp_axis: str = "model",
               fsdp_axis: str = "fsdp"):
    """``train_mesh(4)`` pure dp, ``train_mesh(2, tp=2)`` dp x tp,
    ``train_mesh(2, fsdp=2)`` dp x fsdp, over the initialised world;
    axes of size 1 are dropped, the fastest-varying axis last."""
    from apex_tpu_torch.parallel.mesh import make_mesh

    axes: List[Tuple[str, int]] = [(dp_axis, int(dp))]
    if int(fsdp) > 1:
        axes.append((fsdp_axis, int(fsdp)))
    if int(tp) > 1:
        axes.append((tp_axis, int(tp)))
    return make_mesh(axes)


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order: the mesh identity
    :func:`rules_outcome` records."""
    return {str(n): int(s) for n, s in zip(mesh.axis_names, mesh.shape)}


def _specs(tree: Tree, rules_or_specs, mesh) -> Tree:
    if isinstance(rules_or_specs, RulesTable):
        return rules_or_specs.match(tree, mesh=mesh)
    return rules_or_specs


def _apply(fns: Tree, tree: Tree) -> Tree:
    """Each leaf of ``tree`` through its function in ``fns``."""
    return tree_unflatten(tree, [f(x) for f, x in zip(tree_leaves(fns),
                                                      tree_leaves(tree))])


def shard_tree(tree: Tree, rules_or_specs, mesh) -> Tree:
    """This rank's block of every full leaf of ``tree`` under a rules
    table (matched here) or a spec tree."""
    shard, _ = make_shard_and_gather_fns(
        _specs(tree, rules_or_specs, mesh), mesh)
    return _apply(shard, tree)


def gather_tree(tree: Tree, rules_or_specs=None, mesh=None,
                to_host: bool = False) -> Tree:
    """Every leaf full again: this rank's blocks all-gathered over their
    specs' axes (with ``rules_or_specs`` and ``mesh``; without them the
    leaves are taken as full already), on the CPU with ``to_host``."""
    if rules_or_specs is not None:
        _, gather = make_shard_and_gather_fns(
            _specs(tree, rules_or_specs, mesh), mesh)
        tree = _apply(gather, tree)
    if to_host:
        tree = tree_unflatten(tree, [x.detach().cpu() if hasattr(x, "cpu")
                                     else x for x in tree_leaves(tree)])
    return tree


def constrain_tree(tree: Tree, rules: RulesTable, mesh, *,
                   full_shapes: Tree) -> Tree:
    """Check that every leaf of ``tree`` is this rank's block of the
    matching ``full_shapes`` leaf (a shape, or anything with
    ``.shape``) under ``rules`` on ``mesh``; returns ``tree``, or raises
    ``ValueError`` naming the leaves that are not."""
    specs = _spec_leaves(rules.match(tree, mesh=mesh))
    bad = []
    for (path, leaf), full, spec in zip(named_tree_paths(tree),
                                        tree_leaves(full_shapes), specs):
        want = list(getattr(full, "shape", full))
        for dim, entry in enumerate(spec.dims):
            axes = _dim_axes(entry)
            if axes:
                n, _ = _block_index(axes, mesh)
                want[dim] = want[dim] // n if want[dim] % n == 0 else -1
        if list(leaf.shape) != want:
            bad.append(f"{path}: {tuple(leaf.shape)}, {spec_str(spec)} "
                       f"gives {tuple(want)}")
    if bad:
        raise ValueError(f"table {rules.name!r}: leaves off their local "
                         f"shape: {bad[:8]}")
    return tree


def carry_spec_from_rules(rules: RulesTable, carry: Tree,
                          mesh=None) -> Tree:
    """A driver ``carry_spec`` from a table and a carry template (real
    tensors, or shapeless placeholders matched by path)."""
    return match_partition_rules(rules, carry, mesh=mesh)


# -- reshard-on-restore: the recorded rules outcome --------------------------


def rules_outcome(rules: RulesTable, tree: Tree, mesh, *,
                  mode: Optional[str] = None,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JSON record of a sharding decision: the table (name,
    fingerprint, rules), the mesh (ordered axes), the census, the leaf
    count and the reduction ``mode``, as the JAX package writes it."""
    doc: Dict[str, Any] = {
        "schema": OUTCOME_SCHEMA,
        "table": {
            "name": rules.name,
            "fingerprint": rules.fingerprint(),
            "rules": [[pat, spec_str(spec)] for pat, spec in rules.rules],
            "on_unmatched": rules.on_unmatched,
        },
        "mesh": mesh_axes(mesh),
        "census": rules.census(tree, mesh=mesh),
        "leaves": len(tree_leaves(tree)),
    }
    if mode is not None:
        doc["mode"] = str(mode)
    if extra:
        doc["extra"] = dict(extra)
    return doc


def outcomes_differ(saved: Optional[Dict[str, Any]],
                    current: Dict[str, Any]) -> bool:
    """Does a restore need the gather-then-reshard path?  True when the
    saved outcome is missing, or the mode, the mesh, the gang's world or
    the table's fingerprint changed."""
    if saved is None:
        return True
    if saved.get("mode") != current.get("mode"):
        return True
    if saved.get("mesh") != current.get("mesh"):
        return True
    if ((saved.get("gang") or {}).get("world")
            != (current.get("gang") or {}).get("world")):
        return True
    return ((saved.get("table") or {}).get("fingerprint")
            != (current.get("table") or {}).get("fingerprint"))
