"""Training drivers of the port."""
from apex_tpu_torch.train.driver import (  # noqa: F401
    DEFAULT_STEPS_PER_DISPATCH,
    FusedTrainDriver,
    WindowResult,
    read_metrics,
)

__all__ = ["DEFAULT_STEPS_PER_DISPATCH", "FusedTrainDriver", "WindowResult",
           "read_metrics"]
