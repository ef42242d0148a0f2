"""Declarative partition rules: regexes over named tree paths.

Counterpart of ``apex_tpu/sharding/rules.py``.  One ordered table of
``(regex, P)`` rules is matched over the ``/``-joined path names of any
tree (parameters, optimizer state, driver carries, KV caches): the first
match wins, leaves of one element never partition, and a leaf no rule
matches raises :class:`UnmatchedLeafError` by default.  ``filter_spec``
projects a spec onto a mesh, so that one table serves dp, dp x tp and
dp x fsdp meshes alike.

A tree is nested dicts, lists, tuples, NamedTuples and dataclasses;
``None`` is an empty subtree, and every other object is a leaf (a
tensor, an array, or a shapeless placeholder matched by its path
alone).  A dict key holding dots (a torch state-dict name such as
``layers.0.qkv.kernel``) contributes one path segment per dotted part,
so ``Dense`` kernels and biases read as in the flax tree
(``layers/0/qkv/kernel``); torch names that flax spells differently
(``wte.weight`` for ``wte/embedding``, LayerNorm ``weight`` for
``scale``) reach the catch-all.

The tables are the JAX package's, rule for rule, and
:meth:`RulesTable.to_json` writes the same bytes for the same table, so
the two fingerprints agree (specs print as JAX prints a
``PartitionSpec``).  The port reads no environment variable: the rules
are always on (JAX's ``APEX_TPU_SHARDING_RULES`` kill switch has no
counterpart), and the hand-built literal specs survive only as a test's
expected values.  ``make_shard_and_gather_fns`` works on this rank's
block: a shard function cuts this rank's block out of a full tensor,
and a gather function all-gathers the blocks back over the mesh axes.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from apex_tpu_torch.parallel.mesh import P

__all__ = [
    "DEFAULT_RULES",
    "RulesTable",
    "UnmatchedLeafError",
    "activation_rules",
    "default_rules",
    "filter_spec",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "named_tree_paths",
    "serve_cache_rules",
    "spec_census",
    "spec_str",
    "train_state_rules",
    "tree_leaves",
    "tree_unflatten",
]

Tree = Any


def spec_str(spec: P) -> str:
    """A spec as JAX prints a ``PartitionSpec``:
    ``PartitionSpec(None, 'model')``."""
    return f"PartitionSpec{spec.dims!r}"


def _spec_to_json(spec: P) -> list:
    """A spec as JSON: dims are ``None``, an axis name, or a list of
    axis names."""
    return [list(e) if isinstance(e, (tuple, list)) else e
            for e in spec.dims]


def _spec_from_json(dims: list) -> P:
    return P(*[tuple(e) if isinstance(e, list) else e for e in dims])


class _Leaf:
    """Shapeless placeholder of a spec template: the rules match it by
    path alone."""


class UnmatchedLeafError(ValueError):
    """A tree leaf no partition rule matched, under a table whose
    ``on_unmatched`` mode is ``"error"``: every offending path is named."""


# -- trees ------------------------------------------------------------------


def _children(tree) -> Optional[List[Tuple[List[str], Any]]]:
    """``[(path segments, child)]`` of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k).split("."), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [([f], v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [([str(i)], v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [([f.name], getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _walk(tree, prefix: Tuple[str, ...], out: list) -> None:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        out.append((prefix, tree))
        return
    for segs, child in kids:
        _walk(child, prefix + tuple(segs), out)


def named_tree_paths(tree: Tree, sep: str = "/") -> List[Tuple[str, Any]]:
    """``[(path, leaf)]``: dict keys (split at their dots), NamedTuple
    and dataclass fields, sequence indices, joined by ``sep``; the name
    space the rule regexes match against."""
    out: list = []
    _walk(tree, (), out)
    return [(sep.join(p), leaf) for p, leaf in out]


def tree_leaves(tree: Tree) -> list:
    """The leaves in :func:`named_tree_paths` order."""
    return [leaf for _, leaf in named_tree_paths(tree)]


def _rebuild(t, vals: list):
    """Container ``t`` of the same kind with its children ``vals``."""
    if isinstance(t, dict):
        return dict(zip(t.keys(), vals))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*vals)
    if isinstance(t, (list, tuple)):
        return type(t)(vals)
    return dataclasses.replace(
        t, **{f.name: v for f, v in zip(dataclasses.fields(t), vals)})


def _map_leaves(tree: Tree, values: Sequence[Any], is_leaf) -> Tree:
    it = iter(values)

    def go(t):
        if t is None:
            return None
        if is_leaf(t):
            return next(it)
        return _rebuild(t, [go(child) for _, child in _children(t)])

    return go(tree)


def tree_unflatten(tree: Tree, leaves: Sequence[Any]) -> Tree:
    """``tree``'s containers with its leaves replaced, in order, by
    ``leaves`` (``None`` subtrees stay ``None``)."""
    return _map_leaves(tree, leaves, lambda t: _children(t) is None)


def _spec_leaves(spec_tree: Tree) -> list:
    """The ``P`` leaves of a spec tree (a ``P`` is a leaf, not a
    container)."""
    if isinstance(spec_tree, P):
        return [spec_tree]
    out = []
    for _, child in _children(spec_tree) or []:
        if child is not None:
            out.extend(_spec_leaves(child))
    return out


def _is_scalar(leaf: Any) -> bool:
    """Leaves of at most one element never partition; placeholders
    without a ``.shape`` are left to the rules."""
    shape = getattr(leaf, "shape", None)
    if shape is None:
        return False
    return len(shape) == 0 or math.prod(shape) <= 1


def filter_spec(spec: Optional[P], axis_names: Sequence[str]) -> Optional[P]:
    """Project a spec onto a mesh: axis references the mesh does not
    carry become ``None``, and trailing ``None`` dims are dropped, so a
    dp-only mesh reads a clean ``P()``."""
    if spec is None:
        return None
    names = set(axis_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            if not kept:
                return None
            return kept if len(kept) > 1 else kept[0]
        return entry if entry in names else None

    dims = [keep(e) for e in spec.dims]
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


class RulesTable:
    """A validated, ordered partition-rule table.

    ``rules``: ``[(pattern, P), ...]``, matched top-down with
    ``re.search``; the first match wins.  ``name`` is recorded in
    checkpoint sidecars.  ``on_unmatched``: ``"error"`` (raise
    :class:`UnmatchedLeafError` naming every unmatched path) or
    ``"replicate"`` (unmatched leaves get ``P()``)."""

    def __init__(self, rules: Sequence[Tuple[str, P]], *,
                 name: str = "rules", on_unmatched: str = "error"):
        if on_unmatched not in ("error", "replicate"):
            raise ValueError("on_unmatched must be 'error' or 'replicate', "
                             f"got {on_unmatched!r}")
        compiled = []
        for i, (pattern, spec) in enumerate(rules):
            try:
                rx = re.compile(pattern)
            except re.error as e:
                raise ValueError(
                    f"rule {i} pattern {pattern!r} does not compile: {e}"
                ) from e
            if not isinstance(spec, P):
                raise TypeError(f"rule {i} ({pattern!r}): spec must be a P, "
                                f"got {type(spec).__name__}")
            compiled.append((pattern, rx, spec))
        self.name = str(name)
        self.on_unmatched = on_unmatched
        self._rules = tuple(compiled)

    @property
    def rules(self) -> Tuple[Tuple[str, P], ...]:
        return tuple((pat, spec) for pat, _, spec in self._rules)

    @property
    def catch_all(self) -> bool:
        """Does the table end in an explicit ``".*"`` rule?"""
        return bool(self._rules) and self._rules[-1][0] == ".*"

    def __len__(self) -> int:
        return len(self._rules)

    def __repr__(self) -> str:
        return (f"RulesTable({self.name!r}, {len(self._rules)} rules, "
                f"on_unmatched={self.on_unmatched!r})")

    def to_json(self) -> str:
        """The table (name, rules, mode) as JSON: the same bytes as the
        JAX package's for the same table."""
        return json.dumps({
            "schema": "apex_tpu.sharding.rules.v1",
            "name": self.name,
            "on_unmatched": self.on_unmatched,
            "rules": [[pat, _spec_to_json(spec)] for pat, spec in self.rules],
        }, sort_keys=True)

    @staticmethod
    def from_json(doc: str) -> "RulesTable":
        """Inverse of :meth:`to_json` (fingerprint-preserving)."""
        d = json.loads(doc)
        return RulesTable(
            [(pat, _spec_from_json(spec)) for pat, spec in d["rules"]],
            name=d.get("name", "rules"),
            on_unmatched=d.get("on_unmatched", "error"))

    def fingerprint(self) -> str:
        """Digest of (name, mode, patterns, specs): what a checkpoint's
        sidecar records, equal to the JAX package's for the same table."""
        h = hashlib.sha256()
        h.update(self.name.encode())
        h.update(self.on_unmatched.encode())
        for pat, _, spec in self._rules:
            h.update(pat.encode())
            h.update(spec_str(spec).encode())
        return h.hexdigest()[:16]

    def spec_for(self, path: str, leaf: Any = None,
                 axis_names: Optional[Sequence[str]] = None) -> Optional[P]:
        """The spec of one named leaf; None when no rule matched and the
        mode is ``"error"`` (:meth:`match` raises then)."""
        if leaf is not None and _is_scalar(leaf):
            return P() if axis_names is None else filter_spec(P(),
                                                              axis_names)
        for _, rx, spec in self._rules:
            if rx.search(path) is not None:
                if axis_names is not None:
                    return filter_spec(spec, axis_names)
                return spec
        if self.on_unmatched == "replicate":
            return P()
        return None

    def match(self, tree: Tree, mesh=None) -> Tree:
        """The spec tree of ``tree`` (its containers, a ``P`` a leaf),
        projected onto ``mesh``'s axes when one is given."""
        return match_partition_rules(self, tree, mesh=mesh)

    def census(self, tree: Tree, mesh=None) -> Dict[str, int]:
        """``{spec string: leaf count}`` over the matched tree."""
        return spec_census(self.match(tree, mesh=mesh))

    def describe(self, tree: Tree, mesh=None) -> List[Tuple[str, str]]:
        """``[(path, spec string)]``: the human-readable audit."""
        names = tuple(mesh.axis_names) if mesh is not None else None
        return [(path, str(None if s is None else spec_str(s)))
                for path, leaf in named_tree_paths(tree)
                for s in [self.spec_for(path, leaf, names)]]


def match_partition_rules(rules, tree: Tree, *, mesh=None,
                          on_unmatched: Optional[str] = None) -> Tree:
    """The spec tree of ``tree`` under ``rules`` (a :class:`RulesTable` or
    ``[(pattern, P)]``): first match wins, one-element leaves get
    ``P()``, and with a ``mesh`` every spec is projected onto its axis
    names.  Unmatched leaves raise (error mode) or replicate."""
    if not isinstance(rules, RulesTable):
        rules = RulesTable(rules, on_unmatched=on_unmatched or "error")
    elif on_unmatched is not None and on_unmatched != rules.on_unmatched:
        rules = RulesTable(rules.rules, name=rules.name,
                           on_unmatched=on_unmatched)
    names = tuple(mesh.axis_names) if mesh is not None else None
    flat = named_tree_paths(tree)
    unmatched = [path for path, leaf in flat
                 if not _is_scalar(leaf) and rules.spec_for(path) is None
                 and rules.on_unmatched == "error"]
    if unmatched:
        raise UnmatchedLeafError(
            f"table {rules.name!r}: no partition rule matched "
            f"{len(unmatched)} leaf(s): {unmatched[:8]}"
            + (" ..." if len(unmatched) > 8 else ""))
    specs = []
    for path, leaf in flat:
        spec = rules.spec_for(path, leaf, names)
        specs.append(P() if spec is None else spec)
    return tree_unflatten(tree, specs)


def spec_census(spec_tree: Tree) -> Dict[str, int]:
    """Leaves counted by spec string (``P`` itself is the leaf)."""
    census: Dict[str, int] = {}
    for leaf in _spec_leaves(spec_tree):
        key = spec_str(leaf)
        census[key] = census.get(key, 0) + 1
    return census


def _dim_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_index(axes: Sequence[str], mesh) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dim sharded over ``axes``,
    row-major as JAX lays a multi-axis dim out."""
    n, i = 1, 0
    for a in axes:
        ax = mesh[a]
        n, i = n * ax.size, i * ax.size + ax.index
    return n, i


def make_shard_and_gather_fns(partition_specs: Tree, mesh):
    """Trees of per-leaf ``shard_fn`` / ``gather_fn`` from a spec tree:
    ``shard_fn(x)`` is this rank's block of the full tensor ``x`` under
    its spec on ``mesh``; ``gather_fn(x)`` the full tensor again, the
    blocks all-gathered over the spec's axes (tagged ``gather``)."""
    from apex_tpu_torch.parallel.mesh import all_gather

    def make_shard_fn(spec: P):
        def shard_fn(x):
            for dim, entry in enumerate(spec.dims):
                axes = _dim_axes(entry)
                if not axes:
                    continue
                n, i = _block_index(axes, mesh)
                if x.shape[dim] % n:
                    raise ValueError(
                        f"dimension {dim} of {tuple(x.shape)} does not "
                        f"divide into {n} blocks over {axes}")
                size = x.shape[dim] // n
                x = x.narrow(dim, i * size, size)
            return x
        return shard_fn

    def make_gather_fn(spec: P):
        def gather_fn(x):
            for dim, entry in enumerate(spec.dims):
                for a in reversed(_dim_axes(entry)):  # the minor axis first
                    x = all_gather(x, mesh[a], dim, tag="gather")
            return x
        return gather_fn

    leaves = _spec_leaves(partition_specs)
    shard = tree_unflatten_specs(partition_specs,
                                 [make_shard_fn(s) for s in leaves])
    gather = tree_unflatten_specs(partition_specs,
                                  [make_gather_fn(s) for s in leaves])
    return shard, gather


def tree_unflatten_specs(spec_tree: Tree, values: Sequence[Any]) -> Tree:
    """``spec_tree``'s containers with its ``P`` leaves replaced, in
    order, by ``values``."""
    return _map_leaves(spec_tree, values, lambda t: isinstance(t, P))


# -- the canonical tables (the JAX package's, rule for rule) -----------------


def default_rules(tp_axis: str = "model",
                  fsdp_axis: str = "fsdp") -> RulesTable:
    """The model-parameter table: Megatron column-parallel on the fused
    qkv / MLP-in projections, row-parallel on attention-out / MLP-out,
    vocab and hidden on embeddings, conv output channels over tp, the
    ``fsdp`` axis on the other large dim, and a replicated catch-all."""
    tp, fs = tp_axis, fsdp_axis
    return RulesTable([
        (r"/(qkv|ffn_in)/kernel$", P(fs, tp)),
        (r"/in_proj_weight$", P(fs, tp)),
        (r"/(qkv|ffn_in)/bias$", P(tp)),
        (r"/in_proj_bias$", P(tp)),
        (r"/(proj|ffn_out)/kernel$", P(tp, fs)),
        (r"/out_proj_weight$", P(tp, fs)),
        (r"/embedding$", P(fs, tp)),
        (r"/(fc|mlm_transform|mlm_head|head)/kernel$", P(fs, tp)),
        (r"conv\w*/kernel$", P(None, None, fs, tp)),
        (r".*", P()),
    ], name="apex_tpu.default", on_unmatched="error")


#: the module-level instance consumers share (fingerprint-stable)
DEFAULT_RULES = default_rules()


def train_state_rules(axis_name: str = "data") -> RulesTable:
    """The driver-carry table: the flat master / moment / parameter
    shards of the ZeRO and FSDP policies and the int8 error-feedback
    residual (a row a rank) ride the dp axis; everything else
    replicates."""
    return RulesTable([
        (r"(^|/)(master|m|v|param)_shard$", P(axis_name)),
        (r"(^|/)ef_residual$", P(axis_name)),
        (r".*", P()),
    ], name=f"apex_tpu.train_state[{axis_name}]", on_unmatched="error")


def activation_rules(dp_axis: str = "data",
                     tp_axis: str = "model") -> RulesTable:
    """The activation table: ``act/hidden`` splits batch over dp and the
    hidden dim over tp, every other ``act/`` anchor the batch over dp,
    anything else replicates."""
    dp, tp = dp_axis, tp_axis
    return RulesTable([
        (r"(^|/)act/hidden$", P(dp, tp)),
        (r"(^|/)act/\w+$", P(dp)),
        (r".*", P()),
    ], name=f"apex_tpu.activations[{dp_axis}x{tp_axis}]",
        on_unmatched="error")


def serve_cache_rules(axis_name: str = "model") -> RulesTable:
    """The serve-cache table: the K/V pools and the int8 per-token scale
    arrays shard the head axis (dim 2 of ``[slots | pages, layers,
    heads, ...]``) over the tp axis; lengths and counters replicate."""
    head = P(None, None, axis_name)
    return RulesTable([
        (r"(^|/)(k|v)(_scale)?$", head),
        (r".*", P()),
    ], name=f"apex_tpu.serve_cache[{axis_name}]", on_unmatched="error")
