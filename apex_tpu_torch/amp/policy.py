"""Precision policies: the opt levels O0-O3 as immutable data.

Counterpart of ``apex_tpu/amp/policy.py`` (itself the re-design of
apex's ``Properties`` and opt levels): a :class:`Policy` is consulted by
:class:`apex_tpu_torch.amp.Amp` when it casts a model and builds its loss
scalers, and by the cast tables of :mod:`apex_tpu_torch.amp.functional`
while it is the live ``autocast`` policy (O1).  Dtypes are torch dtypes;
the validation rules are the JAX package's.  The optimizer always keeps
fp32 master weights (the JAX package's ``AmpOptimizer`` does too,
whatever ``master_weights`` says).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from apex_tpu_torch.amp.scaler import LossScaler

__all__ = ["O0", "O1", "O2", "O3", "Policy", "make_policy", "opt_levels"]

_VALID_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Immutable precision policy (ref apex/amp/frontend.py:7-97)."""

    opt_level: str
    enabled: bool = True
    cast_model_dtype: Optional[torch.dtype] = None  # None: params stay fp32
    keep_batchnorm_fp32: Optional[bool] = None
    loss_scale: Union[str, float] = 1.0
    # op-level casting through the cast tables (O1)
    autocast: bool = False
    # the dtype Amp.cast_output casts a model's float outputs to (None:
    # left as they are)
    cast_model_outputs: Optional[torch.dtype] = None
    # serving: the dtype KV caches are stored in (None: the compute
    # dtype); torch.int8 selects int8 pages with per-token fp32 scales
    kv_cache_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.cast_model_dtype not in (None, torch.bfloat16, torch.float16,
                                         torch.float32):
            raise ValueError(f"cast_model_dtype must be bfloat16/float16/"
                             f"float32/None, got {self.cast_model_dtype}")
        if self.keep_batchnorm_fp32 and \
                self.cast_model_dtype not in _VALID_HALF:
            raise ValueError(
                "keep_batchnorm_fp32=True requires cast_model_dtype=bfloat16/"
                "float16 (i.e. O2/O3); with O1 autocast, batchnorm already "
                "runs in fp32 via the op lists.")
        if isinstance(self.loss_scale, str) and self.loss_scale != "dynamic":
            raise ValueError("loss_scale must be a float or 'dynamic'")
        if self.kv_cache_dtype not in (None, torch.bfloat16, torch.float16,
                                       torch.float32, torch.int8):
            raise ValueError(
                "kv_cache_dtype must be bfloat16/float16/float32/int8/None, "
                f"got {self.kv_cache_dtype}")
        if self.autocast and self.cast_model_dtype in _VALID_HALF:
            raise ValueError(
                "autocast (O1-style op casting) and a half cast_model_dtype "
                "(O2/O3-style model cast) are mutually exclusive presets; "
                "pick one interception point.")

    @property
    def compute_dtype(self) -> torch.dtype:
        """dtype that matmul and convolution inputs are cast to under
        this policy: the half model dtype, bf16 under autocast, else
        fp32."""
        if self.cast_model_dtype in _VALID_HALF:
            return self.cast_model_dtype
        if self.autocast:
            return torch.bfloat16
        return torch.float32

    @property
    def cache_dtype(self) -> torch.dtype:
        """dtype serving KV caches are stored in under this policy: the
        explicit ``kv_cache_dtype`` when set, else the compute dtype."""
        if self.kv_cache_dtype is not None:
            return self.kv_cache_dtype
        return self.compute_dtype

    def make_scaler(self, **kw) -> LossScaler:
        return LossScaler(loss_scale=self.loss_scale, **kw)

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


def O0(**overrides) -> Policy:
    """FP32 training, the accuracy baseline (ref frontend.py:163-183)."""
    return Policy(opt_level="O0", cast_model_dtype=torch.float32,
                  keep_batchnorm_fp32=None,
                  loss_scale=1.0).replace(**overrides)


def O1(**overrides) -> Policy:
    """Op-level mixed precision through the cast tables of
    :mod:`apex_tpu_torch.amp.lists`, applied by
    :mod:`apex_tpu_torch.amp.functional` and the policy-aware layers;
    fp32 parameters, dynamic loss scale (ref frontend.py:121-140)."""
    return Policy(opt_level="O1", cast_model_dtype=None, autocast=True,
                  keep_batchnorm_fp32=None,
                  loss_scale="dynamic").replace(**overrides)


def O2(**overrides) -> Policy:
    """Half model, fp32 BN, fp32 master weights, dynamic loss scale
    (ref frontend.py:142-161)."""
    return Policy(opt_level="O2", cast_model_dtype=torch.bfloat16,
                  keep_batchnorm_fp32=True,
                  loss_scale="dynamic").replace(**overrides)


def O3(**overrides) -> Policy:
    """Pure half model, static loss scale 1 (ref frontend.py:104-119)."""
    return Policy(opt_level="O3", cast_model_dtype=torch.bfloat16,
                  keep_batchnorm_fp32=False,
                  loss_scale=1.0).replace(**overrides)


opt_levels = {"O0": O0, "O1": O1, "O2": O2, "O3": O3}


def make_policy(opt_level: str = "O1", **overrides) -> Policy:
    """Preset plus validated overrides (None overrides are dropped)."""
    if opt_level not in opt_levels:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r}; options are "
            "'O0', 'O1', 'O2', 'O3' (the letter O, not zero).")
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return opt_levels[opt_level](**overrides)
