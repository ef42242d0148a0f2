"""Contrib modules of the port (``apex_tpu/contrib``): the fused
multihead-attention modules, the cross-entropy loss module and the NHWC
group BatchNorm."""
