"""2:4 structured sparsity (ASP, "automatic sparsity") over the port's
parameter dicts.

Counterpart of ``apex_tpu/contrib/sparsity`` (ref
apex/contrib/sparsity): the mask library (the valid 1d and 2d 4:2
pattern tables, the 1d-best, 2d-best and 2d-greedy masks) and ASP (the
eligible leaves, the masks, and :func:`sparsify`, which keeps masked
weights at 0 through an optimizer's updates).  As in the JAX package the
weights are masked, not stored sparse: the products stay dense.
"""
from apex_tpu_torch.contrib.sparsity.asp import (  # noqa: F401
    ASP,
    SparsityState,
    sparsify,
)
from apex_tpu_torch.contrib.sparsity.sparse_masklib import (  # noqa: F401
    create_mask,
)

__all__ = ["ASP", "SparsityState", "create_mask", "sparsify"]
