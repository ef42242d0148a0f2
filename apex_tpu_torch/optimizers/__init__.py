"""Optimizers of the port: the AMP-fused Adam, LAMB and SGD, and LARC."""
from apex_tpu_torch.optimizers._common import (  # noqa: F401
    AmpFusedTransformation,
    Transformation,
)
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState, fused_adam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
    fused_sgd,
)
from apex_tpu_torch.optimizers.larc import LARC, LARCState, larc  # noqa: F401

__all__ = ["AmpFusedTransformation", "FusedAdamState", "FusedLAMB",
           "FusedLAMBState", "FusedSGD", "FusedSGDState", "LARC", "LARCState",
           "Transformation", "fused_adam", "fused_lamb", "fused_sgd", "larc"]
