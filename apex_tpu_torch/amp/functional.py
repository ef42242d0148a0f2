"""O1 autocast: policy-aware functional ops over the cast tables.

Counterpart of ``apex_tpu/amp/functional.py`` (ref
apex/amp/{amp.py,wrap.py,utils.py,handle.py:163-167}).  Code that should
follow O1's cast rules calls its ops from this module (the port's layers
and models do), and each op consults a thread-local policy stack::

    with amp.autocast(policy):
        y = F.dense(x, w, b)        # x, w, b cast to bf16: a bf16 product
        p = F.softmax(y)            # computed in fp32
    with amp.disable_casts():       # ref handle.py:163-167
        y = F.dense(x32, w32)       # no casting

The rules are :mod:`apex_tpu_torch.amp.lists`, keyed by this module's op
names: HALF ops cast every floating-point tensor argument to the policy's
compute dtype, FP32 ops to fp32, PROMOTE and SEQUENCE ops to the widest
floating dtype among the arguments, and a BANNED op raises.  Outside
autocast (no policy, a policy without ``autocast``, or
:func:`disable_casts`) an op runs on its arguments as they are, with
mixed operand dtypes promoted as numpy promotes them.  This is not
``torch.autocast``: that casts torch's own ops by lists of its own,
which differ between the CPU and CUDA; here the JAX package's tables
decide, on every device alike.

Every product (``matmul``, ``einsum``, ``dense``,
``conv_general_dilated``, ``conv_transpose``) adds one to
:func:`product_counts` under its op name and the dtype its operands had
when it ran, so a caller can show which products ran in half precision.

The decorators (``half_function``, ``float_function``,
``promote_function``) and their ``register_*`` forms (which rebind a
module attribute) are ref apex/amp/amp.py:30-64.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as torch_F

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.policy import O1, Policy

Padding = Union[str, Sequence[Tuple[int, int]]]

__all__ = [
    "add", "apply_cast_policy", "autocast", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "concatenate", "conv_general_dilated",
    "conv_nhwc", "cross_entropy", "current_policy", "dense", "disable_casts",
    "einsum", "exp", "float_function", "half_function", "l1_loss",
    "layer_norm", "log", "log_softmax", "logsumexp", "matmul", "mean",
    "mse_loss", "mul", "policy_stack", "pow", "product_counts",
    "promote_function", "register_float_function", "register_half_function",
    "register_promote_function", "reset_product_counts", "same_padding",
    "softmax", "stack", "sum", "use_policy_stack",
]

_tls = threading.local()
_products: collections.Counter = collections.Counter()


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_policy() -> Optional[Policy]:
    """The innermost live policy of this thread, or None (outside
    autocast, or inside :func:`disable_casts`)."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def autocast(policy: Optional[Policy] = None) -> Iterator[None]:
    """O1 op casting for the ops called inside the block (``policy``
    defaults to the O1 preset)."""
    st = _stack()
    st.append(policy if policy is not None else O1())
    try:
        yield
    finally:
        st.pop()


@contextlib.contextmanager
def disable_casts() -> Iterator[None]:
    """Suspend casting inside the block (ref apex/amp/handle.py:163-167)."""
    st = _stack()
    st.append(None)
    try:
        yield
    finally:
        st.pop()


def policy_stack() -> Tuple[Optional[Policy], ...]:
    """A snapshot of this thread's policy stack."""
    return tuple(_stack())


@contextlib.contextmanager
def use_policy_stack(stack: Tuple[Optional[Policy], ...]) -> Iterator[None]:
    """Run the block under a snapshot taken by :func:`policy_stack` (a
    recompute in the backward, outside the forward's ``autocast``), then
    put the thread's own stack back."""
    saved = _stack()
    _tls.stack = list(stack)
    try:
        yield
    finally:
        _tls.stack = saved


def _live(pol: Optional[Policy]) -> bool:
    return pol is not None and pol.enabled and pol.autocast


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def _cast_tree(tree, dtype: torch.dtype):
    if _is_float(tree):
        return tree if tree.dtype == dtype else tree.to(dtype)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree


def _float_leaves(tree) -> list:
    if _is_float(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _float_leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _float_leaves(t)]
    return []


def _widest_dtype(tree) -> Optional[torch.dtype]:
    dts = [t.dtype for t in _float_leaves(tree)]
    if not dts:
        return None
    return functools.reduce(torch.promote_types, dts)


def _apply_rule(category: str, pol: Policy, args, kwargs):
    if category == "half":
        dtype = pol.compute_dtype
    elif category == "fp32":
        dtype = torch.float32
    else:  # promote / sequence
        dtype = _widest_dtype((args, kwargs))
        if dtype is None:
            return args, kwargs
    return _cast_tree(args, dtype), _cast_tree(kwargs, dtype)


def apply_cast_policy(op_name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under the live policy's rule for
    ``op_name`` (the one interception point, in place of the reference's
    wrapper factories in apex/amp/wrap.py)."""
    pol = current_policy()
    if not _live(pol):
        return fn(*args, **kwargs)
    cat = lists.category(op_name)
    if cat == "banned":
        raise RuntimeError(lists.BANNED_FUNCS[op_name])
    if cat != "passthrough":
        args, kwargs = _apply_rule(cat, pol, args, kwargs)
    return fn(*args, **kwargs)


# --- decorator API (ref apex/amp/amp.py:30-64) ----------------------------

def _make_decorator(category: str):
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            pol = current_policy()
            if not _live(pol):
                return fn(*args, **kwargs)
            args, kwargs = _apply_rule(category, pol, args, kwargs)
            return fn(*args, **kwargs)
        return wrapper
    return decorator


half_function = _make_decorator("half")
float_function = _make_decorator("fp32")
promote_function = _make_decorator("promote")


def register_half_function(module, name: str) -> None:
    setattr(module, name, half_function(getattr(module, name)))


def register_float_function(module, name: str) -> None:
    setattr(module, name, float_function(getattr(module, name)))


def register_promote_function(module, name: str) -> None:
    setattr(module, name, promote_function(getattr(module, name)))


# --- the product counter ---------------------------------------------------

def _count(op: str, dtype: torch.dtype) -> None:
    _products[(op, str(dtype).replace("torch.", ""))] += 1


def product_counts() -> Dict[Tuple[str, str], int]:
    """Products run through this module since the last reset, by (op
    name, operand dtype)."""
    return dict(_products)


def reset_product_counts() -> None:
    _products.clear()


# --- the functional namespace ---------------------------------------------
# HALF ops return the compute dtype; FP32 ops compute and return fp32.

def _promote(*ts):
    dt = functools.reduce(torch.promote_types, [t.dtype for t in ts])
    return tuple(t.to(dt) for t in ts)


def matmul(a, b, *, out_dtype: Optional[torch.dtype] = None):
    """``a @ b``.  ``out_dtype`` is JAX's ``preferred_element_type``: a
    wider one (fp32 from bf16 operands) gives an fp32 product of the
    operands as they are (the bf16-rounded values, accumulated and
    returned in fp32); a narrower one rounds the product."""
    def _mm(a, b):
        a, b = _promote(a, b)
        _count("matmul", a.dtype)
        if out_dtype is None or out_dtype == a.dtype:
            return torch.matmul(a, b)
        if out_dtype.itemsize > a.dtype.itemsize:
            return torch.matmul(a.to(out_dtype), b.to(out_dtype))
        return torch.matmul(a, b).to(out_dtype)
    return apply_cast_policy("matmul", _mm, a, b)


def einsum(subscripts: str, *operands):
    def _es(*ops):
        ops = _promote(*ops)
        _count("einsum", ops[0].dtype)
        return torch.einsum(subscripts, *ops)
    return apply_cast_policy("einsum", _es, *operands)


def dense(x, kernel, bias=None):
    """Linear layer ``x @ kernel + bias``, ``kernel`` (in, out) (ref
    F.linear in FP16_FUNCS)."""
    def _dense(x, kernel, bias):
        x, kernel = _promote(x, kernel)
        _count("dense", x.dtype)
        y = torch.matmul(x, kernel)
        return y if bias is None else y + bias.to(y.dtype)
    return apply_cast_policy("dense", _dense, x, kernel, bias)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``"SAME"`` padding of one spatial axis: the output keeps
    ceil(size / stride) positions, and an odd total puts the extra pad at
    the high edge (a stride-2 3x3 conv on an even input pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
              strides: Tuple[int, int] = (1, 1), padding: Padding = "SAME"
              ) -> torch.Tensor:
    """``lax.conv_general_dilated`` with ("NHWC", "HWIO", "NHWC"): x (N, H,
    W, C), kernel (KH, KW, C, O) -> (N, H', W', O), operands promoted to
    one dtype.  Asymmetric padding is applied explicitly."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    x, kernel = x.to(dt), kernel.to(dt)
    kh, kw = kernel.shape[:2]
    if isinstance(padding, str):
        if padding == "SAME":
            pads = (same_padding(x.shape[1], kh, strides[0]),
                    same_padding(x.shape[2], kw, strides[1]))
        elif padding == "VALID":
            pads = ((0, 0), (0, 0))
        else:
            raise ValueError(f"padding must be 'SAME', 'VALID' or (lo, hi) "
                             f"pairs, got {padding!r}")
    else:
        pads = tuple((int(lo), int(hi)) for lo, hi in padding)
        if len(pads) != 2:
            raise ValueError(f"conv_nhwc takes two (lo, hi) pairs, got "
                             f"{padding!r}")
    xc = x.permute(0, 3, 1, 2)  # an NCHW view of NHWC memory: channels-last
    (ht, hb), (wl, wr) = pads
    if ht == hb and wl == wr:
        sym = (ht, wl)
    else:
        xc = torch_F.pad(xc, (wl, wr, ht, hb))
        sym = (0, 0)
    y = torch_F.conv2d(xc, kernel.permute(3, 2, 0, 1),
                       stride=tuple(strides), padding=sym)
    return y.permute(0, 2, 3, 1)


def conv_general_dilated(lhs, rhs, window_strides, padding):
    """NHWC activations, HWIO kernel (the only layout of the port), the
    padding as :func:`~apex_tpu_torch.amp.layers.conv_nhwc` takes it."""
    def _conv(lhs, rhs):
        lhs, rhs = _promote(lhs, rhs)
        _count("conv", lhs.dtype)
        return conv_nhwc(lhs, rhs, tuple(window_strides), padding)
    return apply_cast_policy("conv", _conv, lhs, rhs)


def conv_transpose_padding(k: int, stride: int, padding: str
                           ) -> Tuple[int, int]:
    """``lax.conv_transpose``'s (lo, hi) padding of one spatial axis of
    the stride-dilated input for ``"SAME"`` or ``"VALID"`` (jax's
    ``_conv_transpose_padding``): ``"SAME"`` gives ``size * stride``
    outputs, ``"VALID"`` ``(size - 1) * stride + k``."""
    if padding == "SAME":
        total = k + stride - 2
        lo = k - 1 if stride > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + stride - 2 + max(k - stride, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding must be 'SAME', 'VALID' or (lo, hi) "
                         f"pairs, got {padding!r}")
    return lo, total - lo


def conv_transpose_nhwc(x: torch.Tensor, kernel: torch.Tensor,
                        strides: Tuple[int, int] = (1, 1),
                        padding: Padding = "SAME") -> torch.Tensor:
    """``lax.conv_transpose`` with ("NHWC", "HWIO", "NHWC") and
    ``transpose_kernel=False``: x (N, H, W, I), kernel (KH, KW, I, O) ->
    (N, H', W', O), operands promoted to one dtype.

    That is a correlation, with the kernel as it is, of x dilated by the
    strides (stride - 1 zeros between neighbours) and padded by (lo, hi)
    a spatial axis (:func:`conv_transpose_padding` for ``"SAME"`` and
    ``"VALID"``, explicit pairs as given).  ``F.conv_transpose2d`` is the
    correlation of the same dilated input with the kernel flipped,
    padded by k - 1 - p at both edges plus ``output_padding`` at the high
    one; so the kernel goes in flipped, as (I, O, KH, KW), with p = k - 1
    - lo and output_padding = hi - lo where torch takes them (p >= 0, 0
    <= hi - lo < min(stride, k)), else the full transposed convolution (p
    = 0) is
    cropped or zero-padded to (lo, hi) by ``F.pad``."""
    dt = torch.promote_types(x.dtype, kernel.dtype)
    x, kernel = x.to(dt), kernel.to(dt)
    ks = tuple(kernel.shape[:2])
    if isinstance(padding, str):
        pads = tuple(conv_transpose_padding(k, s, padding)
                     for k, s in zip(ks, strides))
    else:
        pads = tuple((int(lo), int(hi)) for lo, hi in padding)
        if len(pads) != 2:
            raise ValueError(f"conv_transpose_nhwc takes two (lo, hi) pairs, "
                             f"got {padding!r}")
    w = kernel.permute(2, 3, 0, 1).flip(2, 3)
    xc = x.permute(0, 3, 1, 2)  # an NCHW view of NHWC memory
    # an output_padding of at least the kernel size (a 1x1 kernel at
    # stride 2, "VALID") corrupts the heap in the CPU backward of a
    # channels-last input (torch 2.13), so that case is padded by F.pad
    if all(0 <= hi - lo < min(s, k) and lo <= k - 1
           for (lo, hi), k, s in zip(pads, ks, strides)):
        y = torch_F.conv_transpose2d(
            xc, w, stride=tuple(strides),
            padding=tuple(k - 1 - lo for (lo, _), k in zip(pads, ks)),
            output_padding=tuple(hi - lo for lo, hi in pads))
    else:
        y = torch_F.conv_transpose2d(xc, w, stride=tuple(strides))
        (ht, hb), (wl, wr) = ((lo - (k - 1), hi - (k - 1))
                              for (lo, hi), k in zip(pads, ks))
        y = torch_F.pad(y, (wl, wr, ht, hb))
    return y.permute(0, 2, 3, 1)


def conv_transpose(lhs, rhs, strides, padding):
    """Transposed convolution under the conv rule (ref conv_transpose2d in
    FP16_FUNCS): NHWC activations, HWIO kernel, ``padding`` as
    :func:`conv_transpose_nhwc` takes it."""
    def _convt(lhs, rhs):
        lhs, rhs = _promote(lhs, rhs)
        _count("conv_transpose", lhs.dtype)
        return conv_transpose_nhwc(lhs, rhs, tuple(strides), padding)
    return apply_cast_policy("conv", _convt, lhs, rhs)


def softmax(x, axis: int = -1):
    return apply_cast_policy("softmax", lambda x: torch.softmax(x, axis), x)


def log_softmax(x, axis: int = -1):
    return apply_cast_policy("log_softmax",
                             lambda x: torch.log_softmax(x, axis), x)


def logsumexp(x, axis=None):
    def _lse(x):
        dims = tuple(range(x.dim())) if axis is None else axis
        return torch.logsumexp(x, dims)
    return apply_cast_policy("logsumexp", _lse, x)


def layer_norm(x, scale=None, bias=None, *, epsilon: float = 1e-5):
    """``(x - mean) / sqrt(var + eps)`` over the last axis, the variance
    ``E[(x - mean)^2]`` as ``jnp.var`` takes it, then the affine."""
    def _ln(x, scale, bias):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + epsilon)
        if scale is not None:
            y = y * scale
        if bias is not None:
            y = y + bias
        return y
    return apply_cast_policy("layer_norm", _ln, x, scale, bias)


def cross_entropy(logits, labels, *, axis: int = -1):
    """Integer-label softmax cross-entropy per example, in fp32 under
    autocast."""
    def _ce(logits):
        logp = torch.log_softmax(logits, axis)
        return -torch.gather(logp, axis, labels.long().unsqueeze(axis)
                             ).squeeze(axis)
    return apply_cast_policy("cross_entropy", _ce, logits)


def mse_loss(pred, target):
    return apply_cast_policy(
        "mse_loss", lambda p, t: torch.mean(torch.square(p - t)), pred,
        target)


def l1_loss(pred, target):
    return apply_cast_policy(
        "l1_loss", lambda p, t: torch.mean(torch.abs(p - t)), pred, target)


def binary_cross_entropy_with_logits(logits, targets):
    """The fused, numerically stable sigmoid + BCE (the reason plain BCE
    is banned under autocast)."""
    def _bce(logits, targets):
        return torch.mean(torch.clamp_min(logits, 0) - logits * targets
                          + torch.log1p(torch.exp(-torch.abs(logits))))
    return apply_cast_policy("binary_cross_entropy_with_logits", _bce,
                             logits, targets)


def binary_cross_entropy(probs, targets):
    return apply_cast_policy(
        "binary_cross_entropy",
        lambda p, t: -torch.mean(t * torch.log(p)
                                 + (1 - t) * torch.log(1 - p)),
        probs, targets)


def add(a, b):
    return apply_cast_policy("add", torch.add, a, b)


def mul(a, b):
    return apply_cast_policy("mul", torch.mul, a, b)


def concatenate(arrays, axis: int = 0):
    return apply_cast_policy(
        "concatenate", lambda *xs: torch.cat(_promote(*xs), axis), *arrays)


def stack(arrays, axis: int = 0):
    return apply_cast_policy(
        "stack", lambda *xs: torch.stack(_promote(*xs), axis), *arrays)


def exp(x):
    return apply_cast_policy("exp", torch.exp, x)


def log(x):
    return apply_cast_policy("log", torch.log, x)


def pow(x, y):  # noqa: A001 - the reference op name
    return apply_cast_policy("pow", torch.pow, x, y)


def sum(x, axis=None):  # noqa: A001 - the reference op name
    return apply_cast_policy(
        "sum", lambda x: torch.sum(x) if axis is None else torch.sum(x, axis),
        x)


def mean(x, axis=None):
    return apply_cast_policy(
        "mean",
        lambda x: torch.mean(x) if axis is None else torch.mean(x, axis), x)
