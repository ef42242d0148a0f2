"""apex_tpu_torch.mlp — the MLP module (ref apex/mlp/mlp.py)."""
from apex_tpu_torch.mlp.mlp import MLP  # noqa: F401
from apex_tpu_torch.ops.mlp import mlp  # noqa: F401

__all__ = ["MLP", "mlp"]
