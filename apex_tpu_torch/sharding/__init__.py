"""apex_tpu_torch.sharding: the declarative partition-rule engine.

Counterpart of ``apex_tpu/sharding``: one ordered regex table maps named
parameter, optimizer, carry and cache trees to trees of
:class:`~apex_tpu_torch.parallel.mesh.P` (``rules``), and the mesh-aware
executors apply them to this rank's blocks (``apply``).  The ZeRO / FSDP
carry specs, the head-sharded serve cache specs and the checkpoint's
reshard record derive from the tables here.
"""
from apex_tpu_torch.sharding.apply import (  # noqa: F401
    carry_spec_from_rules,
    constrain_tree,
    gather_tree,
    mesh_axes,
    outcomes_differ,
    rules_outcome,
    shard_tree,
    train_mesh,
)
from apex_tpu_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    RulesTable,
    UnmatchedLeafError,
    activation_rules,
    default_rules,
    filter_spec,
    make_shard_and_gather_fns,
    match_partition_rules,
    named_tree_paths,
    serve_cache_rules,
    spec_census,
    spec_str,
    train_state_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "RulesTable",
    "UnmatchedLeafError",
    "activation_rules",
    "carry_spec_from_rules",
    "constrain_tree",
    "default_rules",
    "filter_spec",
    "gather_tree",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "mesh_axes",
    "named_tree_paths",
    "outcomes_differ",
    "rules_outcome",
    "serve_cache_rules",
    "shard_tree",
    "spec_census",
    "spec_str",
    "train_mesh",
    "train_state_rules",
]
