"""Contrib modules of the port (``apex_tpu/contrib``): the fused
multihead-attention modules, the cross-entropy loss module, the NHWC
group BatchNorm and 2:4 structured sparsity (``sparsity``)."""
