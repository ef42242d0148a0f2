"""Contrib modules of the port (``apex_tpu/contrib``): the fused
multihead-attention modules so far."""
