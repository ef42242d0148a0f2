"""Optimizers of the port (the AMP-fused Adam so far)."""
from apex_tpu_torch.optimizers._common import AmpFusedTransformation  # noqa: F401
from apex_tpu_torch.optimizers.fused_adam import FusedAdamState, fused_adam  # noqa: F401

__all__ = ["AmpFusedTransformation", "FusedAdamState", "fused_adam"]
