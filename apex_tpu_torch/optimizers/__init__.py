"""Optimizers of the port: the AMP-fused Adam and LAMB."""
from apex_tpu_torch.optimizers._common import AmpFusedTransformation  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState, fused_adam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)

__all__ = ["AmpFusedTransformation", "FusedAdamState", "FusedLAMB",
           "FusedLAMBState", "fused_adam", "fused_lamb"]
