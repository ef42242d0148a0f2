"""Training drivers of the port."""
from apex_tpu_torch.train.accum import (  # noqa: F401
    ACCUM_DTYPES,
    FsdpAmpState,
    FsdpOptState,
    MicrobatchedStep,
    ZeroAmpState,
    adasum_microbatch_step,
    amp_microbatch_step,
    build_opt_step,
    fsdp_init,
    fsdp_microbatch_step,
    fsdp_param_spec,
    fsdp_state_spec,
    fsdp_unflatten_params,
    zero_init,
    zero_microbatch_step,
    zero_state_spec,
)
from apex_tpu_torch.train.driver import (  # noqa: F401
    DEFAULT_STEPS_PER_DISPATCH,
    FusedTrainDriver,
    WindowResult,
    read_metrics,
)

__all__ = ["ACCUM_DTYPES", "DEFAULT_STEPS_PER_DISPATCH", "FsdpAmpState",
           "FsdpOptState", "FusedTrainDriver", "MicrobatchedStep",
           "WindowResult", "ZeroAmpState", "adasum_microbatch_step",
           "amp_microbatch_step", "build_opt_step", "fsdp_init",
           "fsdp_microbatch_step", "fsdp_param_spec", "fsdp_state_spec",
           "fsdp_unflatten_params", "read_metrics", "zero_init",
           "zero_microbatch_step", "zero_state_spec"]
