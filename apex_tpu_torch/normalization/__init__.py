"""Normalization modules of the port."""
from apex_tpu_torch.normalization.fused_layer_norm import FusedLayerNorm  # noqa: F401

__all__ = ["FusedLayerNorm"]
