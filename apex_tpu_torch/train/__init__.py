"""Training drivers of the port."""
from apex_tpu_torch.train.accum import (  # noqa: F401
    ACCUM_DTYPES,
    MicrobatchedStep,
    amp_microbatch_step,
    build_opt_step,
)
from apex_tpu_torch.train.driver import (  # noqa: F401
    DEFAULT_STEPS_PER_DISPATCH,
    FusedTrainDriver,
    WindowResult,
    read_metrics,
)

__all__ = ["ACCUM_DTYPES", "DEFAULT_STEPS_PER_DISPATCH", "FusedTrainDriver",
           "MicrobatchedStep", "WindowResult", "amp_microbatch_step",
           "build_opt_step", "read_metrics"]
