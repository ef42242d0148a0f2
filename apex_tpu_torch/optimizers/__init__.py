"""Optimizers of the port: the AMP-fused Adam, LAMB, SGD, NovoGrad and
Adagrad, and LARC."""
from apex_tpu_torch.optimizers._common import (  # noqa: F401
    AmpFusedTransformation,
    Transformation,
)
from apex_tpu_torch.optimizers.fused_adagrad import (  # noqa: F401
    FusedAdagrad,
    FusedAdagradState,
    fused_adagrad,
)
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState, fused_adam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import (  # noqa: F401
    FusedLAMB,
    FusedLAMBState,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad,
    FusedNovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optimizers.fused_sgd import (  # noqa: F401
    FusedSGD,
    FusedSGDState,
    fused_sgd,
)
from apex_tpu_torch.optimizers.larc import LARC, LARCState, larc  # noqa: F401

__all__ = ["AmpFusedTransformation", "FusedAdagrad", "FusedAdagradState",
           "FusedAdamState", "FusedLAMB", "FusedLAMBState", "FusedNovoGrad",
           "FusedNovoGradState", "FusedSGD", "FusedSGDState", "LARC",
           "LARCState", "Transformation", "fused_adagrad", "fused_adam",
           "fused_lamb", "fused_novograd", "fused_sgd", "larc"]
