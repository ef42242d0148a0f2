"""Carry weights and optimizer state from the JAX package to the port.

:func:`from_jax_params` maps a ``GPTLM`` params tree (nested dicts of
numpy arrays, or anything ``np.asarray`` takes) to a state dict of
:class:`apex_tpu_torch.models.GPTLM`, :func:`from_jax_bert_params` a
``BertForMLM`` (tied or untied) or ``BertEncoder`` tree to a state dict of
:class:`apex_tpu_torch.models.BertForMLM` or ``BertEncoder``
(:func:`to_jax_bert_params` back), :func:`from_jax_resnet_params` a
``ResNet`` tree with its ``batch_stats`` to a state dict of
:class:`apex_tpu_torch.models.ResNet` and its batch statistics, and
:func:`from_jax_dcgan_params` a DCGAN ``Generator`` or ``Discriminator``
tree the same way, and :func:`from_jax_rnn_params` an ``RNN`` stack
(``StackedRNN`` or ``BidirectionalRNN``) to a state dict of the port's
module, so both packages compute with the same numbers.
Dense kernels and the attention projections keep
their flax ``(in, out)`` layout and convolution kernels their HWIO one,
so no transpose happens on the way; a key the mapping does not know
raises, so nothing is silently dropped.  :func:`from_jax_opt_state` maps
an ``AmpOptState`` over any of these trees (FusedAdam's or FusedLAMB's
step, m and v, FusedSGD's step and momentum buffers, and each loss
scaler's state) to the port's, so both packages can also continue
training from the same optimizer state, sharded or not.  For tensor and
pipeline parallelism, :func:`from_jax_tp_params` gives a rank its local
shards of a JAX ``Stage`` tree (the partition-major fused QKV included;
a stage of a stacked tree), :func:`tp_shard_params` the same from the
port's own full weights, and :func:`qkv_partition_major` /
:func:`qkv_natural` convert the fused QKV's column order.  For expert
parallelism, :func:`from_jax_moe_params` gives a rank its block of a JAX
``MoEMLP``'s experts and the replicated router, and
:func:`from_jax_ef_state` a rank its row of the int8 error-feedback
residual.  Tensor-parallel serving needs no converter: its weights are
replicated, as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.amp import AmpOptState, LossScalerState
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.optimizers import (FusedAdamState, FusedLAMBState,
                                       FusedSGDState)

__all__ = ["from_jax_bert_params", "from_jax_dcgan_params",
           "from_jax_ef_state", "from_jax_moe_params", "from_jax_opt_state",
           "from_jax_params", "from_jax_resnet_params",
           "from_jax_rnn_params", "from_jax_tp_params", "jax_leaf_order",
           "qkv_natural", "qkv_partition_major", "tp_shard_params",
           "to_jax_bert_params"]

_DENSE = ("qkv", "proj", "ffn_in", "ffn_out")
_MHA = ("in_proj_weight", "in_proj_bias", "q_weight", "k_weight",
        "v_weight", "q_bias", "k_bias", "v_bias", "out_proj_weight",
        "out_proj_bias", "in_proj_weight_q", "in_proj_weight_kv",
        "in_proj_bias_q", "in_proj_bias_kv")


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``GPTLM`` params -> the port's ``GPTLM`` state dict (fp32,
    CPU); an untied head (``tie_word_embeddings=False``) maps to
    ``head.kernel``.  Raises on a tree with keys this mapping does not
    know, so nothing is silently dropped."""
    out = {
        "wte.weight": _t(tree["wte"]["embedding"]),
        "wpe.weight": _t(tree["wpe"]["embedding"]),
        "ln_f.weight": _t(tree["ln_f"]["scale"]),
        "ln_f.bias": _t(tree["ln_f"]["bias"]),
    }
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(layers):
        if name != f"layer_{i}":
            raise ValueError(f"layer keys not contiguous: {layers}")
        sub = tree[name]
        for ln in ("ln1", "ln2"):
            out[f"layers.{i}.{ln}.weight"] = _t(sub[ln]["scale"])
            out[f"layers.{i}.{ln}.bias"] = _t(sub[ln]["bias"])
        for dense in _DENSE:
            out[f"layers.{i}.{dense}.kernel"] = _t(sub[dense]["kernel"])
            out[f"layers.{i}.{dense}.bias"] = _t(sub[dense]["bias"])
        extra = set(sub) - {"ln1", "ln2", *_DENSE}
        if extra:
            raise ValueError(f"{name}: unmapped params {sorted(extra)}")
    if "head" in tree:
        _check_keys(tree["head"], ("kernel",), "head: ")
        out["head.kernel"] = _t(tree["head"]["kernel"])
    extra = set(tree) - {"wte", "wpe", "ln_f", "head", *layers}
    if extra:
        raise ValueError(f"unmapped params {sorted(extra)}")
    return out


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _ln(sub: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {_join(prefix, "weight"): _t(sub["scale"]),
            _join(prefix, "bias"): _t(sub["bias"])}


def _dense(sub: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {_join(prefix, "kernel"): _t(sub["kernel"]),
            _join(prefix, "bias"): _t(sub["bias"])}


def _check_keys(tree: Mapping[str, Any], known, where: str) -> None:
    extra = set(tree) - set(known)
    if extra:
        raise ValueError(f"{where}unmapped params {sorted(extra)}")


def _mha_state(sub: Mapping[str, Any], prefix: str
               ) -> Dict[str, torch.Tensor]:
    """A flax ``SelfMultiheadAttn`` or ``EncdecMultiheadAttn`` params
    dict -> the port's module state under ``prefix`` ('' for the module
    itself; the same names, ``lyr_nrm`` as a LayerNorm)."""
    _check_keys(sub, (*_MHA, "lyr_nrm"), f"{prefix}: ")
    out = {_join(prefix, k): _t(sub[k]) for k in _MHA if k in sub}
    if "lyr_nrm" in sub:
        out.update(_ln(sub["lyr_nrm"], _join(prefix, "lyr_nrm")))
    return out


def _bert_encoder(enc: Mapping[str, Any], pre: str
                  ) -> Dict[str, torch.Tensor]:
    layers = sorted((k for k in enc if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    _check_keys(enc, ("word_embeddings", "position_embeddings",
                      "token_type_embeddings", "embed_ln", *layers),
                f"{pre or 'encoder'}: ")
    out = {
        _join(pre, "word_embeddings.weight"):
            _t(enc["word_embeddings"]["embedding"]),
        _join(pre, "position_embeddings.weight"):
            _t(enc["position_embeddings"]["embedding"]),
        **_ln(enc["embed_ln"], _join(pre, "embed_ln")),
    }
    if "token_type_embeddings" in enc:
        out[_join(pre, "token_type_embeddings.weight")] = _t(
            enc["token_type_embeddings"]["embedding"])
    for i, name in enumerate(layers):
        if name != f"layer_{i}":
            raise ValueError(f"layer keys not contiguous: {layers}")
        sub, lpre = enc[name], _join(pre, f"layers.{i}")
        _check_keys(sub, ("self_attn", "attn_ln", "ffn_in", "ffn_out",
                          "ffn_ln"), f"{name}: ")
        out.update(_mha_state(sub["self_attn"], f"{lpre}.self_attn"))
        for ln in ("attn_ln", "ffn_ln"):
            out.update(_ln(sub[ln], f"{lpre}.{ln}"))
        for dense in ("ffn_in", "ffn_out"):
            out.update(_dense(sub[dense], f"{lpre}.{dense}"))
    return out


def from_jax_bert_params(tree: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """flax ``BertForMLM`` params -> the port's ``BertForMLM`` state dict
    (fp32, CPU): the tied head's ``mlm_bias`` or the untied
    ``mlm_head``.  A flax ``BertEncoder`` tree (``word_embeddings`` at
    its top, a ``token_type_embeddings`` table when it was called with
    token types) maps to a ``BertEncoder`` state dict.  Raises on a tree
    with keys this mapping does not know."""
    if "encoder" not in tree:
        return _bert_encoder(tree, "")
    _check_keys(tree, ("encoder", "mlm_transform", "mlm_ln", "mlm_bias",
                       "mlm_head"), "")
    out = _bert_encoder(tree["encoder"], "encoder")
    out.update(_dense(tree["mlm_transform"], "mlm_transform"))
    out.update(_ln(tree["mlm_ln"], "mlm_ln"))
    if "mlm_head" in tree:
        _check_keys(tree["mlm_head"], ("kernel", "bias"), "mlm_head: ")
        out.update(_dense(tree["mlm_head"], "mlm_head"))
    if "mlm_bias" in tree:
        out["mlm_bias"] = _t(tree["mlm_bias"])
    return out


def to_jax_bert_params(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_bert_params`: a port ``BertForMLM``
    (or ``BertEncoder``) state dict -> the flax params tree, as nested
    dicts of fp32 numpy arrays."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        parts = name.split(".")
        if "layers" in parts:  # layers.i -> layer_i
            i = parts.index("layers")
            parts[i:i + 2] = [f"layer_{parts[i + 1]}"]
        if len(parts) > 1 and parts[-2].endswith("embeddings"):
            parts[-1] = "embedding"
        elif len(parts) > 1 and parts[-2].endswith(("_ln", "lyr_nrm")):
            parts[-1] = "scale" if parts[-1] == "weight" else "bias"
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().float().cpu().numpy()
    return tree


_RESNET_LEAVES = {"conv": ("kernel",), "bn": ("scale", "bias")}
_BLOCK = ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3", "downsample_conv",
          "downsample_bn")


def _resnet_leaves(tree: Mapping[str, Any], leaves: Dict[str, Tuple],
                   where: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax ResNet tree ('.'-joined names), checking every
    module and leaf name against the model's; ``leaves`` maps a module
    kind (conv, bn, fc) to the leaf names it may hold."""
    out = {}
    for name, sub in tree.items():
        path = _join(where, name)
        if not where and name.startswith("stage"):
            if not isinstance(sub, Mapping):
                raise ValueError(f"unmapped params {path}")
            out.update(_resnet_leaves(sub, leaves, path))
            continue
        if where and name not in _BLOCK:
            raise ValueError(f"{where}: unmapped params {[name]}")
        if not where and name not in ("conv1", "bn1", "fc"):
            raise ValueError(f"unmapped params {[name]}")
        kind = "fc" if name == "fc" else (
            "bn" if name.endswith("bn") or name.startswith("bn") else "conv")
        allowed = leaves.get(kind, ())
        _check_keys(sub, allowed, f"{path}: ")
        out.update({_join(path, k): _t(v) for k, v in sub.items()})
    return out


def from_jax_resnet_params(params: Mapping[str, Any],
                           batch_stats: Optional[Mapping[str, Any]] = None):
    """flax ``ResNet`` ``params`` (and ``batch_stats``) -> the port's
    ``ResNet`` state dict (fp32, CPU; HWIO kernels as they are) and, with
    ``batch_stats``, the port's batch statistics, ``(state, stats)``.
    Raises on a module or leaf name the model does not have."""
    state = _resnet_leaves(params, {**_RESNET_LEAVES,
                                    "fc": ("kernel", "bias")})
    if batch_stats is None:
        return state
    stats = _resnet_leaves(batch_stats,
                           {"bn": ("running_mean", "running_var")})
    return state, stats


_DCGAN_LEAVES = {"ConvTranspose": ("kernel",), "Conv": ("kernel",),
                 "BatchNorm": ("scale", "bias")}


def _dcgan_leaves(tree: Mapping[str, Any], leaves: Mapping[str, Tuple]
                  ) -> Dict[str, torch.Tensor]:
    out = {}
    for name, sub in tree.items():
        kind, _, idx = name.rpartition("_")
        if kind not in leaves or not idx.isdigit():
            raise ValueError(f"unmapped params {[name]}")
        _check_keys(sub, leaves[kind], f"{name}: ")
        out.update({f"{name}.{k}": _t(v) for k, v in sub.items()})
    return out


def from_jax_dcgan_params(params: Mapping[str, Any],
                          batch_stats: Optional[Mapping[str, Any]] = None):
    """flax DCGAN ``Generator`` or ``Discriminator`` ``params`` (and
    ``batch_stats``) -> the port's state dict (fp32, CPU; HWIO kernels as
    they are, ``ConvTranspose_i.kernel``, ``BatchNorm_i.scale``, ...)
    and, with ``batch_stats``, its statistics (``BatchNorm_i.mean``,
    ``BatchNorm_i.var``), ``(state, stats)``.  Raises on a module or leaf
    name the models do not have."""
    state = _dcgan_leaves(params, _DCGAN_LEAVES)
    if batch_stats is None:
        return state
    return state, _dcgan_leaves(batch_stats, {"BatchNorm": ("mean", "var")})


_RNN_CELL = ("wi", "wh", "bi", "bh", "wmx", "wmh")


def from_jax_rnn_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``StackedRNN`` params (``layer_{i}/ScanRNNCell_0/...``) or
    ``BidirectionalRNN`` params (``fwd/...``, ``bwd/...``) -> the port's
    state dict (``layers.{i}.cell.*``, ``fwd.cell.*``, ``bwd.cell.*``;
    fp32, CPU: ``load_state_dict`` casts to a bf16 module's dtype
    exactly).  The weights keep their (in, out) layout.  Raises on a key
    this mapping does not know."""
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    for i, name in enumerate(layers):
        if name != f"layer_{i}":
            raise ValueError(f"layer keys not contiguous: {layers}")
    _check_keys(tree, ("fwd", "bwd", *layers), "")
    out = {}
    for name in tree:
        prefix = f"layers.{name.split('_')[1]}" if name in layers else name
        _check_keys(tree[name], ("ScanRNNCell_0",), f"{name}: ")
        cell = tree[name]["ScanRNNCell_0"]
        _check_keys(cell, _RNN_CELL, f"{name}/ScanRNNCell_0: ")
        out.update({f"{prefix}.cell.{k}": _t(cell[k]) for k in _RNN_CELL
                    if k in cell})
    return out


def _scalers(state, dev):
    return tuple(LossScalerState(
        loss_scale=torch.tensor(float(np.asarray(s.loss_scale)),
                                dtype=torch.float32, device=dev),
        unskipped=torch.tensor(int(np.asarray(s.unskipped)),
                               dtype=torch.int32, device=dev),
        overflows=torch.tensor(int(np.asarray(s.overflows)),
                               dtype=torch.int32, device=dev))
        for s in state.scaler)


def _sharded_opt_state(state: Any, dev, rank: Optional[int],
                       world: Optional[int]):
    """JAX ``ShardedOptState``, ``ZeroAmpState`` or ``FsdpAmpState``
    (flat shards as one global array, or this rank's) -> the port's, with
    rank ``rank`` of ``world``'s slice of each flat shard."""
    from apex_tpu_torch.contrib.optimizers import ShardedOptState
    from apex_tpu_torch.train.accum import (FsdpAmpState, FsdpOptState,
                                            ZeroAmpState)

    def shard(x):
        a = np.asarray(x, np.float32).reshape(-1)
        if rank is not None:
            n = a.size // world
            a = a[rank * n:(rank + 1) * n]
        return torch.from_numpy(a.copy()).to(dev)

    kind = type(state).__name__
    if kind == "ShardedOptState":
        return ShardedOptState(
            torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                         device=dev),
            shard(state.master_shard), shard(state.m_shard),
            shard(state.v_shard))
    inner = state.opt_state
    if kind == "ZeroAmpState":
        return ZeroAmpState(_sharded_opt_state(inner, dev, rank, world),
                            _scalers(state, dev))
    return FsdpAmpState(
        FsdpOptState(torch.tensor(int(np.asarray(inner.step)),
                                  dtype=torch.int32, device=dev),
                     shard(inner.m_shard), shard(inner.v_shard)),
        _scalers(state, dev))


def jax_leaf_order(tree: Mapping[str, Any], mapping=None) -> list:
    """The port's names of ``mapping(tree)`` (None:
    :func:`from_jax_params`) in the JAX leaf order of ``tree`` (dict keys
    sorted, depth first), which is the flat order of JAX's
    ``ShardedOptState``: a ZeRO carry taken over from JAX needs its
    ``make_spec`` over a parameter dict in this order."""
    counter = iter(range(1 << 30))

    def tag(t):
        if isinstance(t, Mapping):
            return {k: tag(t[k]) for k in sorted(t)}
        return np.full(np.shape(t), next(counter), np.float32)

    mapped = (mapping or from_jax_params)(tag(tree))
    return sorted(mapped, key=lambda k: float(mapped[k].reshape(-1)[0]))


def from_jax_opt_state(state: Any, device=None, *, rank: Optional[int] = None,
                       world: Optional[int] = None):
    """JAX ``AmpOptState(FusedAdamState | FusedLAMBState (step, m, v) |
    FusedSGDState (step, momentum_buf), scalers, stash)`` over a
    ``GPTLM``, ``BertForMLM`` or ``ResNet`` params tree -> the port's
    :class:`apex_tpu_torch.amp.AmpOptState` on ``device`` (None: the CUDA
    device), the per-parameter tensors (the stash's too) keyed like
    :func:`from_jax_params`, :func:`from_jax_bert_params` or
    :func:`from_jax_resnet_params`.

    The sharded states too: ``ShardedOptState`` (of
    ``DistributedFusedAdam``/``LAMB``), ``ZeroAmpState`` and
    ``FsdpAmpState`` map to the port's classes of those names; given the
    global arrays ``shard_map`` returns, ``rank`` and ``world`` pick this
    rank's slice of each flat shard.  The flat order is JAX's leaf order
    (:func:`jax_leaf_order`)."""
    dev = resolve_device(device)
    if type(state).__name__ in ("ShardedOptState", "ZeroAmpState",
                                "FsdpAmpState"):
        return _sharded_opt_state(state, dev, rank, world)
    inner = state.opt_state
    kinds = {"FusedAdamState": FusedAdamState,
             "FusedLAMBState": FusedLAMBState,
             "FusedSGDState": FusedSGDState}
    kind = kinds.get(type(inner).__name__)
    if kind is None:
        raise ValueError(f"optimizer state {type(inner).__name__} is not "
                         f"ported (expected one of {sorted(kinds)})")

    def scalar(x, dtype):
        return torch.tensor(np.asarray(x).item(), dtype=dtype, device=dev)

    def moments(tree):
        if "encoder" in tree:
            mapping = from_jax_bert_params
        elif "fc" in tree:
            mapping = from_jax_resnet_params
        else:
            mapping = from_jax_params
        return {k: v.to(dev) for k, v in mapping(tree).items()}

    step = scalar(inner.step, torch.int32)
    if kind is FusedSGDState:
        opt_state = kind(step=step, momentum_buf=moments(inner.momentum_buf))
    else:
        opt_state = kind(step=step, m=moments(inner.m), v=moments(inner.v))
    return AmpOptState(
        opt_state=opt_state,
        scaler=_scalers(state, dev),
        stash=None if state.stash is None else moments(state.stash))


# -- tensor-parallel shards, pipeline stages and the sharded optimizer states --

#: a tensor-parallel Stage's column-parallel and row-parallel layers
#: (``examples/transformer_parallel``): column kernels and biases split on
#: their last dimension, row kernels on their first; everything else,
#: the row biases included, is replicated
_TP_COLUMN = ("attn.qkv", "mlp.wi")
_TP_ROW = ("attn.proj", "mlp.wo")
_TP_STAGE = {"ln1": ("scale", "bias"), "ln2": ("scale", "bias"),
             "attn": ("qkv", "proj"), "mlp": ("wi", "wo")}


def qkv_partition_major(w: torch.Tensor, n: int) -> torch.Tensor:
    """A fused QKV kernel (in, 3 H hd) or bias (3 H hd,) with columns in
    the natural (3, H, hd) order, reordered partition-major, (n, 3,
    H / n, hd): the order in which n tensor-parallel ranks' local
    (3, h_local, hd) columns concatenate."""
    lead = w.shape[:-1]
    return (w.reshape(*lead, 3, n, -1).transpose(-3, -2)
            .reshape(*lead, -1).contiguous())


def qkv_natural(w: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of :func:`qkv_partition_major`."""
    lead = w.shape[:-1]
    return (w.reshape(*lead, n, 3, -1).transpose(-3, -2)
            .reshape(*lead, -1).contiguous())


def _tp_split(name: str, t: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    if any(f"{c}." in name for c in _TP_COLUMN):
        size = t.shape[-1] // n
        return t[..., rank * size:(rank + 1) * size].clone()
    if any(f"{r}.kernel" in name for r in _TP_ROW):
        size = t.shape[0] // n
        return t[rank * size:(rank + 1) * size].clone()
    return t.clone()


def tp_shard_params(full: Mapping[str, torch.Tensor], rank: int, n: int
                    ) -> Dict[str, torch.Tensor]:
    """Rank ``rank`` of ``n``'s local state dict of a tensor-parallel
    stage from its full weights, the fused QKV in the natural (3, H, hd)
    column order (:func:`qkv_partition_major` first, then the split)."""
    out = {}
    for name, t in full.items():
        if ".qkv." in name:
            t = qkv_partition_major(t, n)
        out[name] = _tp_split(name, t, rank, n)
    return out


def from_jax_tp_params(tree: Mapping[str, Any], rank: int, n: int, *,
                       stage: Optional[int] = None, prefix: str = "0"
                       ) -> Dict[str, torch.Tensor]:
    """A JAX tensor-parallel ``Stage`` tree (``ln1``, ``attn/{qkv,proj}``,
    ``ln2``, ``mlp/{wi,wo}``) holding FULL weights, as ``shard_map``'s
    ``out_specs`` gathers the ranks' local ones (the QKV partition-major
    already), -> rank ``rank`` of ``n``'s local state dict of the port's
    block ``prefix``: ``split_column``/``split_row`` of the full tree.
    ``stage`` picks one stage of a tree stacked by
    ``stack_stage_params`` (leading stage axis)."""
    _check_keys(tree, tuple(_TP_STAGE), "tp stage: ")
    out = {}
    for mod, subs in _TP_STAGE.items():
        for sub in subs:
            if mod.startswith("ln"):
                leaves = {("weight" if sub == "scale" else "bias"):
                          tree[mod][sub]}
                base = f"{prefix}.{mod}"
            else:
                _check_keys(tree[mod][sub], ("kernel", "bias"),
                            f"{mod}/{sub}: ")
                leaves = tree[mod][sub]
                base = f"{prefix}.{mod}.{sub}"
            for leaf, x in leaves.items():
                t = _t(x if stage is None else np.asarray(x)[stage])
                name = f"{base}.{leaf}"
                out[name] = _tp_split(name, t, rank, n)
    return out


# -- expert-parallel MoE and the error-feedback residual ------------------------


def from_jax_moe_params(params: Mapping[str, Any], *, rank: int = 0,
                        world: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX ``MoEMLP`` params tree (``router`` (d, E), ``wi`` and ``wo``
    with the experts of every device on their leading axis, as
    ``shard_map`` returns them over ``P("expert")``) -> rank ``rank`` of
    ``world``'s state dict of :class:`apex_tpu_torch.parallel.MoEMLP`:
    its block of ``E / world`` experts and the replicated router (fp32,
    CPU)."""
    _check_keys(params, ("router", "wi", "wo"), "MoEMLP")
    wi, wo = np.asarray(params["wi"]), np.asarray(params["wo"])
    if wi.shape[0] % world:
        raise ValueError(f"{wi.shape[0]} experts do not divide into {world} "
                         f"ranks")
    n = wi.shape[0] // world
    take = lambda a: _t(a[rank * n:(rank + 1) * n])  # noqa: E731
    return {"router": _t(params["router"]), "wi": take(wi), "wo": take(wo)}


def from_jax_ef_state(state: Any, *, rank: Optional[int] = None,
                      device=None):
    """A JAX ``EfState`` (the (world, L) error-feedback residual) ->
    the port's :class:`~apex_tpu_torch.train.compress.EfState` on
    ``device`` (None: the CUDA device): rank ``rank``'s (1, L) row, as
    its carry holds it, or every row with ``rank`` None."""
    from apex_tpu_torch.train.compress import EfState

    res = np.asarray(state.ef_residual, np.float32)
    if rank is not None:
        res = res[rank:rank + 1]
    return EfState(torch.from_numpy(res.copy()).to(resolve_device(device)))
