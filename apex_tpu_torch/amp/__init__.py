"""Mixed-precision layers of the port (the policy tables come later)."""
from apex_tpu_torch.amp.layers import Dense  # noqa: F401

__all__ = ["Dense"]
