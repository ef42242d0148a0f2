"""contrib optimizers: the ZeRO-style sharded Adam and LAMB, and the
contrib ``FP16_Optimizer`` name (ref apex/contrib/optimizers).

Counterpart of ``apex_tpu/contrib/optimizers``; as there, the contrib
``FP16_Optimizer`` is the ``bf16_utils`` wrapper.
"""
from apex_tpu_torch.bf16_utils import BF16_Optimizer as FP16_Optimizer  # noqa: F401
from apex_tpu_torch.contrib.optimizers.distributed_fused import (  # noqa: F401
    DistributedFusedAdam,
    DistributedFusedLAMB,
    FlatSpec,
    ShardedOptState,
)

__all__ = ["DistributedFusedAdam", "DistributedFusedLAMB", "FP16_Optimizer",
           "FlatSpec", "ShardedOptState"]
