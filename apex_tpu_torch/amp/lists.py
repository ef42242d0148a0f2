"""Cast-policy tables for O1-style op-level mixed precision.

A copy of ``apex_tpu/amp/lists.py`` (pure data; the port imports nothing
of the JAX package).  ref:
apex/amp/lists/{functional_overrides,torch_overrides,tensor_overrides}.py

The reference expresses policy as *names of torch functions to patch*.  Here
the tables are keyed by the op names of
:mod:`apex_tpu_torch.amp.functional` (and consulted by the policy-aware
layers of :mod:`apex_tpu_torch.amp.layers`).  Categories, following the
reference exactly:

- HALF  : tensor-core/MXU ops -> compute in half (bf16)
          (ref torch_overrides.py FP16_FUNCS: conv*, matmul, mm, bmm, addmm,
          linear, prelu, ...)
- FP32  : numerically sensitive -> compute in fp32
          (ref FP32_FUNCS: softmax/log_softmax, norms, losses, exp/log/pow
          family, reductions like sum/mean/var/std/cumsum/prod)
- PROMOTE : multi-arg elementwise -> cast all args to the widest dtype
          (ref CASTS: add/mul/div/comparisons/addcdiv/...)
- SEQUENCE : ops over sequences of tensors -> promote the whole sequence
          (ref SEQUENCE_CASTS: cat/stack)
- BANNED : refuse under autocast with an actionable error
          (ref functional_overrides.py BANNED_FUNCS: binary_cross_entropy —
          the fix is *_with_logits, i.e. the fused sigmoid+bce)
"""

HALF_FUNCS = frozenset(
    {
        # matrix-unit ops
        "matmul",
        "dot",
        "dot_general",
        "einsum",
        "dense",
        "linear",
        "conv",
        "conv_general_dilated",
        "conv1d",
        "conv2d",
        "conv3d",
        "conv_transpose",
        "bmm",
        "mm",
        "mv",
        "addmm",
        "addbmm",
        "baddbmm",
        "matmul_t",
        "prelu",
        "mlp",
        "attention",
        "multi_head_attention",
        "rnn_cell",
        "lstm_cell",
        "gru_cell",
    }
)

FP32_FUNCS = frozenset(
    {
        # pointwise with precision hazards
        "acos",
        "asin",
        "cosh",
        "erfinv",
        "exp",
        "expm1",
        "log",
        "log10",
        "log1p",
        "log2",
        "reciprocal",
        "rsqrt",
        "sinh",
        "tan",
        "pow",
        "softplus",
        # reductions
        "sum",
        "prod",
        "cumsum",
        "cumprod",
        "mean",
        "var",
        "std",
        "norm",
        "logsumexp",
        "renorm",
        # softmax family
        "softmax",
        "log_softmax",
        "softmin",
        # normalization layers
        "layer_norm",
        "batch_norm",
        "sync_batch_norm",
        "group_norm",
        "instance_norm",
        "local_response_norm",
        "normalize",
        # losses
        "cross_entropy",
        "nll_loss",
        "l1_loss",
        "mse_loss",
        "smooth_l1_loss",
        "kl_div",
        "poisson_nll_loss",
        "hinge_embedding_loss",
        "margin_ranking_loss",
        "soft_margin_loss",
        "multi_margin_loss",
        "multilabel_margin_loss",
        "multilabel_soft_margin_loss",
        "cosine_embedding_loss",
        "triplet_margin_loss",
        "binary_cross_entropy_with_logits",
        # misc
        "softmax_cross_entropy",
        "gelu_fp32",
        "cdist",
        "dist",
        "pdist",
    }
)

PROMOTE_FUNCS = frozenset(
    {
        "add",
        "sub",
        "mul",
        "div",
        "true_divide",
        "addcdiv",
        "addcmul",
        "atan2",
        "cross",
        "bilinear",
        "dot_promote",
        "equal",
        "eq",
        "ne",
        "lt",
        "gt",
        "le",
        "ge",
        "maximum",
        "minimum",
        "where",
        "fmod",
        "remainder",
    }
)

SEQUENCE_FUNCS = frozenset({"cat", "concatenate", "stack"})

BANNED_FUNCS = {
    "binary_cross_entropy": (
        "amp does not work out-of-the-box with binary_cross_entropy on half "
        "inputs: a half log(sigmoid) loses all precision near saturation. "
        "Use apex_tpu_torch.amp.functional.binary_cross_entropy_with_logits "
        "(the fused, fp32-safe form), or compute this loss in fp32 outside "
        "autocast via amp.disable_casts()."
        # ref apex/amp/lists/functional_overrides.py:74-80
    )
}


def category(op_name: str) -> str:
    """Return 'half' | 'fp32' | 'promote' | 'sequence' | 'banned' | 'passthrough'."""
    if op_name in HALF_FUNCS:
        return "half"
    if op_name in FP32_FUNCS:
        return "fp32"
    if op_name in PROMOTE_FUNCS:
        return "promote"
    if op_name in SEQUENCE_FUNCS:
        return "sequence"
    if op_name in BANNED_FUNCS:
        return "banned"
    return "passthrough"
