"""Parallelism across processes, over ``torch.distributed``.

Counterpart of ``apex_tpu/parallel`` (ref ``apex.parallel``): data
parallelism (``DistributedDataParallel``, ``Reducer``, ``SyncBatchNorm``,
``convert_syncbn_model``, ``create_syncbn_process_group`` -> ``syncbn_groups``
+ ``new_groups``, ``LARC``); meshes of several axes (``make_mesh``) with
their collectives; sequence parallelism (``ring_attention``,
``ulysses_attention``); tensor parallelism (``tensor_parallel``); and the
GPipe pipeline (``pipeline_apply``); and expert parallelism (``moe``).  A
mesh axis is a process group here and a JAX collective one call on it;
each module's docstring maps the JAX names to the port's.
"""
from apex_tpu_torch.optimizers.larc import LARC, larc  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    data_parallel_step,
    flatten_tree,
    unflatten_tree,
)
from apex_tpu_torch.parallel.mesh import (  # noqa: F401
    Axis,
    Mesh,
    P,
    Subgroups,
    all_gather,
    all_reduce,
    all_to_all,
    axis_index,
    axis_size,
    collective_counts,
    data_parallel_group,
    group_axis,
    grouped_all_reduce,
    make_mesh,
    new_groups,
    pmax,
    psum,
    reduce_scatter,
    replicate,
    reset_collective_counts,
    ring_shift,
    shard_batch,
    syncbn_groups,
    world_size,
)
from apex_tpu_torch.parallel.moe import (  # noqa: F401
    MoEMLP,
    moe_mlp_ref,
    top_k_routing,
)
from apex_tpu_torch.parallel.multiproc import (  # noqa: F401
    MultiprocError,
    TEARDOWN_RC,
    WorkerResult,
    init_distributed,
    launch,
)
from apex_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_apply,
    stack_stage_params,
)
from apex_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention,
    ring_attention_fwd,
    ring_attention_ref,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
)
from apex_tpu_torch.parallel.tensor_parallel import (  # noqa: F401
    ColumnParallelDense,
    RowParallelDense,
    TensorParallelMLP,
    TensorParallelSelfAttention,
    column_parallel_dense,
    replicated_loss,
    row_parallel_dense,
    split_column,
    split_row,
    sync_replicated_grads,
)
from apex_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401

__all__ = ["Axis", "ColumnParallelDense", "DistributedDataParallel", "LARC",
           "Mesh", "MoEMLP", "MultiprocError", "P", "Reducer",
           "RowParallelDense",
           "Subgroups", "SyncBatchNorm", "TEARDOWN_RC",
           "TensorParallelMLP", "TensorParallelSelfAttention",
           "WorkerResult", "all_gather", "all_reduce", "all_to_all",
           "axis_index", "axis_size", "collective_counts",
           "column_parallel_dense", "convert_syncbn_model",
           "data_parallel_group", "data_parallel_step", "flatten_tree",
           "group_axis", "grouped_all_reduce", "init_distributed", "larc",
           "launch", "make_mesh", "moe_mlp_ref", "new_groups",
           "pipeline_apply", "pmax", "psum",
           "reduce_scatter", "replicate", "replicated_loss",
           "reset_collective_counts", "ring_attention", "ring_attention_fwd",
           "ring_attention_ref", "ring_shift", "row_parallel_dense",
           "shard_batch", "split_column", "split_row", "stack_stage_params",
           "sync_replicated_grads", "syncbn_groups", "top_k_routing",
           "ulysses_attention",
           "unflatten_tree", "world_size"]
