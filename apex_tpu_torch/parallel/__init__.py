"""Data parallelism across processes, over ``torch.distributed``.

Counterpart of ``apex_tpu/parallel`` (ref ``apex.parallel``):
``DistributedDataParallel``, ``Reducer``, ``SyncBatchNorm``,
``convert_syncbn_model``, ``create_syncbn_process_group``
(-> ``syncbn_groups`` + ``new_groups``) and ``LARC``.  A mesh axis is a
process group here and a ``psum`` a SUM all-reduce; each module's
docstring maps the JAX names to the port's.  Not ported yet: the
sequence, tensor, expert and pipeline parallel layers and ``make_mesh``.
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
    Subgroups,
    all_reduce,
    collective_counts,
    data_parallel_group,
    grouped_all_reduce,
    new_groups,
    replicate,
    reset_collective_counts,
    shard_batch,
    syncbn_groups,
    world_size,
)
from apex_tpu_torch.parallel.multiproc import (  # noqa: F401
    MultiprocError,
    TEARDOWN_RC,
    WorkerResult,
    init_distributed,
    launch,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
)

__all__ = ["DistributedDataParallel", "LARC", "MultiprocError", "Reducer",
           "Subgroups", "SyncBatchNorm", "TEARDOWN_RC", "WorkerResult",
           "all_reduce", "collective_counts", "convert_syncbn_model",
           "data_parallel_group", "data_parallel_step", "flatten_tree",
           "grouped_all_reduce", "init_distributed", "larc", "launch",
           "new_groups", "replicate", "reset_collective_counts",
           "shard_batch", "syncbn_groups", "unflatten_tree", "world_size"]
