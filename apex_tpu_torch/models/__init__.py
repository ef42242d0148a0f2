"""Models of the port."""
from apex_tpu_torch.models.gpt import (  # noqa: F401
    GPTConfig,
    GPTLayer,
    GPTLM,
    init_params,
)

__all__ = ["GPTConfig", "GPTLayer", "GPTLM", "init_params"]
