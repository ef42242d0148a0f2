"""Gradient accumulation over microbatches, on one device.

Counterpart of the single-device part of ``apex_tpu/train/accum.py``.  A
driver step becomes M microbatches: each one's gradient is added into an
fp32 buffer (or a bf16 Kahan pair) on the device, and the optimizer and
the loss scaler act once per accumulation boundary, on the mean
gradient.  AMP composes over the accumulated gradient: one inf/nan
check, one skip gate and one scale update per boundary, so an overflow
in any microbatch skips the whole accumulated update.  Pass the
:class:`MicrobatchedStep` to
:class:`~apex_tpu_torch.train.FusedTrainDriver`, whose batched windows
then carry a leading axis of K * M microbatches::

    def grad_fn(carry, microbatch):
        masters, state = carry[0], carry[1]
        _, loss = model(*microbatch, deterministic=False, generator=gen)
        grads = torch.autograd.grad(
            opt.amp.scale_loss(loss, state.scaler[0]), params)
        return dict(zip(names, grads)), {"loss": loss.detach()}

    step = amp_microbatch_step(grad_fn, opt, microbatches=4, model=model)
    driver = FusedTrainDriver(step, steps_per_dispatch=K)
    carry, res = driver.run_window(carry, batches)   # leading axis K * M

Gradients are dicts of tensors by parameter name, the port's convention.
Across processes (``ddp=``), each rank accumulates its own microbatches
with no collective (the reference's no-sync ``disable_allreduce``) and
each boundary makes one all-reduce, of one flat fp32 buffer.

Two more update policies shard over a data
:class:`~apex_tpu_torch.parallel.mesh.Axis`, with the same AMP semantics
(one overflow check over the accumulated gradient, agreed by every rank
through one scalar all-reduce, and one scale update a boundary):

- ZeRO (:func:`zero_microbatch_step`): the accumulated gradient goes to
  :class:`~apex_tpu_torch.contrib.optimizers.DistributedFusedAdam` or
  ``DistributedFusedLAMB``: one reduce-scatter, the update of this rank's
  shard of the masters and moments (:class:`ZeroAmpState`), one
  all-gather of the new parameters;
- FSDP (:func:`fsdp_microbatch_step`): the carry holds only this rank's
  flat master shard; the boundary's ``prepare_fn`` all-gathers it into
  the parameter dict once before the M gradient passes, and the update
  reduce-scatters the gradient and updates the owned shard.

:func:`zero_state_spec`, :func:`fsdp_param_spec` and
:func:`fsdp_state_spec` mark which carry leaves are rank-local shards
(``P(axis_name)``) for the driver's ``carry_spec``, derived from
:func:`apex_tpu_torch.sharding.train_state_rules`.

``compress=`` (:mod:`apex_tpu_torch.train.compress`) wraps the boundary
collective of the three policies in the bf16 or int8 codec; int8 carries
its error-feedback residual as ``carry[2]`` (an ``EfState`` holding this
rank's row), kept unchanged on a boundary that overflows.  ``compress=
None`` builds exactly the uncompressed step.  :func:`adasum_microbatch_step`
is the fourth policy: one flat all-gather a boundary and Adasum's
butterfly computed locally on every rank.

The canonical train state (:func:`train_state_canonical`,
:func:`carry_from_canonical`, :func:`save_train_state`,
:func:`restore_train_state`): the full parameters, moments, step and
scalers of a ZeRO or FSDP carry, from which either mode is rebuilt on a
mesh of another size.  No rank holds the whole state, so the canonical
form is all-gathered over the axis, or read from every source rank's
checkpoint directory when a restore's saved world differs from the
live one.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch import multi_tensor
from apex_tpu_torch.amp.scaler import apply_if_finite
from apex_tpu_torch.parallel.distributed import flatten_tree, unflatten_tree
from apex_tpu_torch.parallel.mesh import P, all_gather, group_axis, psum
from apex_tpu_torch.train.compress import (EfState, adasum_combine,
                                           compress_allreduce,
                                           compress_reduce_scatter,
                                           compression_default)

__all__ = ["ACCUM_DTYPES", "FsdpAmpState", "FsdpOptState",
           "MicrobatchedStep", "REDUCTION_MODES", "ZeroAmpState",
           "adasum_microbatch_step", "adasum_state_spec",
           "amp_microbatch_step", "build_opt_step", "carry_from_canonical",
           "fsdp_init", "fsdp_microbatch_step", "fsdp_param_spec",
           "fsdp_state_spec", "fsdp_unflatten_params",
           "reduction_carry_template", "restore_train_state",
           "save_train_state", "train_state_canonical", "zero_init",
           "zero_microbatch_step", "zero_state_spec"]

ACCUM_DTYPES = ("float32", "bf16_compensated")

Grads = Mapping[str, torch.Tensor]
#: ``(carry, microbatch) -> (scaled_grads, metrics)``: runs once per
#: microbatch with the same carry (the parameters do not move inside an
#: accumulation window).
GradFn = Callable[[Any, Any], Tuple[Grads, Dict[str, torch.Tensor]]]
#: ``(carry, accumulated fp32 grads) -> (carry, metrics)``: the optimizer
#: and scaler update, once per boundary.
UpdateFn = Callable[[Any, Grads], Tuple[Any, Dict[str, torch.Tensor]]]


class MicrobatchedStep(NamedTuple):
    """A driver step that consumes M microbatches per optimizer step.

    Build it with :func:`amp_microbatch_step`, :func:`zero_microbatch_step`
    or :func:`fsdp_microbatch_step`, or directly for a custom
    ``update_fn``.  ``prepare_fn`` (optional) maps the carry at rest to
    the view the M ``grad_fn`` calls read, once a boundary (FSDP's
    all-gather); ``update_fn`` gets the carry at rest."""

    grad_fn: GradFn
    update_fn: UpdateFn
    microbatches: int
    accum_dtype: str = "float32"
    prepare_fn: Optional[Callable[[Any], Any]] = None
    #: the boundary's compression policy (introspection only)
    compress: Optional[Any] = None


def _accum_validate(accum_dtype: str) -> None:
    if accum_dtype not in ACCUM_DTYPES:
        raise ValueError(f"accum_dtype must be one of {ACCUM_DTYPES}, got "
                         f"{accum_dtype!r}")


def _accum_init(grads: Grads, accum_dtype: str) -> Dict[str, Any]:
    """The buffer from the first microbatch's grads: fp32 copies, or
    (bf16 value, bf16 compensation) Kahan pairs."""
    if accum_dtype == "float32":
        return {n: g.to(torch.float32, copy=True) for n, g in grads.items()}
    return {n: (g.to(torch.bfloat16, copy=True),
                torch.zeros(g.shape, dtype=torch.bfloat16, device=g.device))
            for n, g in grads.items()}


def _accum_add(acc: Dict[str, Any], grads: Grads, accum_dtype: str) -> None:
    """Adds ``grads`` into the buffer in place: fp32 adds, or Kahan steps
    in bf16."""
    if accum_dtype == "float32":
        names = list(acc)
        torch._foreach_add_([acc[n] for n in names],
                            [grads[n].float() for n in names])
        return
    for n, (value, comp) in acc.items():
        y = grads[n].to(torch.bfloat16) - comp
        t = value + y
        comp.copy_((t - value) - y)
        value.copy_(t)


def _accum_final(acc: Dict[str, Any], accum_dtype: str) -> Dict[str, Any]:
    """The buffer read out as the fp32 accumulated gradient."""
    if accum_dtype == "float32":
        return acc
    return {n: value.float() - comp.float()
            for n, (value, comp) in acc.items()}


def _index(batches: Any, i: Any) -> Any:
    """``batches`` at ``i`` (an index or a slice) of the leading axis of
    every leaf (tensors in tuples, lists and dicts)."""
    if isinstance(batches, torch.Tensor):
        return batches[i]
    if isinstance(batches, Mapping):
        return {k: _index(v, i) for k, v in batches.items()}
    return type(batches)(_index(v, i) for v in batches)


def build_opt_step(step: MicrobatchedStep):
    """The driver's one-step function of a :class:`MicrobatchedStep`:
    ``opt_step(carry, xs) -> (carry, metrics)``, ``xs`` with a leading M
    axis on every leaf (or None for closure-captured data).  The M grad
    passes run one after the other; their metrics are meaned in fp32 and
    joined with the update's, a name on both sides raising
    ``ValueError``."""
    _accum_validate(step.accum_dtype)
    m = int(step.microbatches)
    if m < 1:
        raise ValueError(f"microbatches must be >= 1, got {m}")

    def opt_step(carry, xs):
        view = carry if step.prepare_fn is None else step.prepare_fn(carry)
        acc = None
        per_mb = []
        for i in range(m):
            grads, gm = step.grad_fn(view, None if xs is None
                                     else _index(xs, i))
            if not isinstance(gm, Mapping):
                raise TypeError("grad_fn must return (grads, metrics) with "
                                "metrics a dict of 0-d tensors; got "
                                f"{type(gm).__name__}")
            per_mb.append(gm)
            if acc is None:
                acc = _accum_init(grads, step.accum_dtype)
            else:
                _accum_add(acc, grads, step.accum_dtype)
            del grads  # freed before the next pass allocates its own
        del view
        carry, um = step.update_fn(carry, _accum_final(acc, step.accum_dtype))
        metrics = {n: torch.stack([mm[n].detach().float()
                                   for mm in per_mb]).mean()
                   for n in per_mb[0]}
        clash = sorted(set(metrics) & set(um))
        if clash:
            raise ValueError(f"metric names {clash} returned by both grad_fn "
                             "and update_fn: rename one side")
        metrics.update(um)
        return carry, metrics

    return opt_step


def amp_microbatch_step(grad_fn: GradFn, opt, *, microbatches: int = 1,
                        loss_id: int = 0, accum_dtype: str = "float32",
                        model: Optional[torch.nn.Module] = None, ddp=None,
                        grad_presum: Optional[Callable[[Grads], Grads]] = None,
                        compress=None) -> MicrobatchedStep:
    """The AMP accumulation step: M grad passes, then one optimizer and
    scaler update on the mean of the accumulated scaled gradients.

    ``opt`` is an :class:`~apex_tpu_torch.amp.AmpOptimizer`; the carry
    leads with ``(master_params, AmpOptState)`` and any further items pass
    through untouched.  The inf/nan check, the skip gate over the masters
    and the optimizer state, and the dynamic-scale update run once per
    boundary inside ``opt.step``, so an overflow in any microbatch skips
    the whole accumulated update and halves the scale once.  With
    ``model``, ``opt.step`` copies the new masters into it.  Metrics:
    ``scale`` (the loss scale after the update) and ``skipped`` (1.0 on a
    skipped boundary).

    ``ddp`` (a :class:`~apex_tpu_torch.parallel.DistributedDataParallel`)
    reduces the microbatch-mean gradient once per boundary: the whole
    tree flattened into one fp32 buffer (``flatten_tree``), one
    ``ddp.allreduce`` of it, unflattened.  ``grad_presum(acc)`` runs on
    the accumulated gradient before the division by M (in JAX a partial
    reduction over another mesh axis).

    ``compress`` (``"bf16"``, ``"int8"`` or a ``CompressionSpec``; needs
    ``ddp``, and not over grouped DDP) wraps that all-reduce in the
    codec, with DDP's scaling (the predivide, the SUM, the division by
    world over the predivide); int8 carries its residual as ``carry[2]``
    (``EfState``, this rank's (1, L) row), not updated on a boundary that
    overflows.  ``compress=None`` is exactly the uncompressed step."""
    m = int(microbatches)
    _accum_validate(accum_dtype)
    comp = compression_default(compress)
    if comp.enabled and ddp is None:
        raise ValueError(
            "gradient compression compresses the boundary DDP collective: "
            "pass ddp= (there is nothing to compress on one rank)")
    if comp.enabled and ddp.groups is not None:
        raise NotImplementedError(
            "gradient compression over grouped (hierarchical) DDP groups is "
            "not supported")
    axis = group_axis(ddp.group) if comp.enabled else None

    def update_fn(carry, acc):
        masters, state = carry[0], carry[1]
        if grad_presum is not None:
            acc = grad_presum(acc)
        grads = {n: a / m for n, a in acc.items()}
        new_res = None
        if ddp is not None:
            # one collective a boundary: the flat buffer (the reference's
            # flat bucket); the grads are fp32 already, so the flatten is
            # exact
            flat, spec = flatten_tree(grads)
            if comp.enabled:
                pre = ddp.gradient_predivide_factor
                x = flat / pre if pre != 1.0 else flat
                res = carry[2].ef_residual[0] if comp.error_feedback else None
                summed, new_res = compress_allreduce(x, axis, comp, res,
                                                     tag="ddp")
                if ddp.gradient_average:
                    summed = summed / (axis.size / pre)
                grads = unflatten_tree(summed, spec)
            else:
                grads = unflatten_tree(ddp.allreduce(flat), spec)
        masters, state, stats = opt.step(grads, state, masters,
                                         loss_id=loss_id, model=model)
        metrics = {"scale": stats.loss_scale,
                   "skipped": stats.found_inf.float()}
        return ((masters, state) + _ef_extras(comp, carry, new_res,
                                              stats.found_inf), metrics)

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype,
                            compress=comp)


def _ef_extras(comp, carry, new_res, found_inf) -> tuple:
    """The carry's items past the head: the new int8 residual (the old
    one kept on an overflowed boundary, or the poisoned error would
    replay forever) and the rest untouched."""
    if not comp.error_feedback:
        return tuple(carry[2:])
    old = carry[2].ef_residual[0]
    new_res = torch.where(found_inf, old, new_res)
    return (EfState(new_res[None]),) + tuple(carry[3:])


def adasum_state_spec(axis_name: str = "data") -> P:
    """The Adasum carry's spec: replicated, as the mean policy's (the
    combined gradient is the same on every rank)."""
    from apex_tpu_torch.sharding import train_state_rules
    from apex_tpu_torch.sharding.rules import _Leaf

    return train_state_rules(axis_name).match(_Leaf())


def adasum_microbatch_step(grad_fn: GradFn, opt, *, microbatches: int = 1,
                           axis=None, loss_id: int = 0,
                           accum_dtype: str = "float32",
                           grad_presum: Optional[Callable[[Grads], Grads]] = None,
                           model: Optional[torch.nn.Module] = None,
                           compress=None) -> MicrobatchedStep:
    """The Adasum accumulation step (arxiv 2006.02924): the ranks'
    microbatch-mean gradients combine pairwise by orthogonal projection
    instead of averaging.  One flat all-gather over ``axis`` (an
    :class:`~apex_tpu_torch.parallel.mesh.Axis`; None: the default
    process group) a boundary, then the log2(world) butterfly computed
    locally and identically on every rank, so the overflow gate inside
    ``opt.step`` agrees everywhere with no flag all-reduce.  The world
    must be a power of two.  The carry and overflow contract are
    :func:`amp_microbatch_step`'s.  ``compress`` must stay None: Adasum's
    coefficients need full-precision operands."""
    comp = compression_default(compress)
    if comp.enabled:
        raise NotImplementedError(
            "adasum combines full-precision gradients; compression composes "
            "with the mean/zero/fsdp policies instead")
    m = int(microbatches)
    _accum_validate(accum_dtype)

    def update_fn(carry, acc):
        masters, state = carry[0], carry[1]
        ax = group_axis() if axis is None else axis
        if grad_presum is not None:
            acc = grad_presum(acc)
        grads = {n: a / m for n, a in acc.items()}
        flat, spec = flatten_tree(grads)
        gathered = all_gather(flat[None], ax, 0, tag="adasum")  # (world, L)
        grads = unflatten_tree(adasum_combine(gathered), spec)
        masters, state, stats = opt.step(grads, state, masters,
                                         loss_id=loss_id, model=model)
        metrics = {"scale": stats.loss_scale,
                   "skipped": stats.found_inf.float()}
        return (masters, state) + tuple(carry[2:]), metrics

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype,
                            compress=comp)


# -- ZeRO: the sharded optimizer state --------------------------------------


class ZeroAmpState(NamedTuple):
    """AMP state of the ZeRO policy: the sharded optimizer state (1/world
    a rank) and the per-loss scaler states (the same on every rank);
    ``state.scaler[loss_id]`` reads as in :class:`~apex_tpu_torch.amp.
    AmpOptState`."""

    opt_state: Any  # contrib.optimizers.ShardedOptState
    scaler: Tuple


def zero_state_spec(axis_name: str = "data") -> ZeroAmpState:
    """The :class:`ZeroAmpState`'s spec tree for the driver's
    ``carry_spec``: the flat shards ride ``axis_name``, the step and the
    scalers are replicated (from
    :func:`apex_tpu_torch.sharding.train_state_rules`)."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState)
    from apex_tpu_torch.sharding import train_state_rules
    from apex_tpu_torch.sharding.rules import _Leaf

    return train_state_rules(axis_name).match(ZeroAmpState(
        ShardedOptState(_Leaf(), _Leaf(), _Leaf(), _Leaf()), _Leaf()))


def zero_init(zero_opt, amp_, params: Grads, spec) -> ZeroAmpState:
    """This rank's ZeRO state: ``zero_opt.init`` (its master shard and
    moments) and fresh scaler states on the parameters' device."""
    dev = next(iter(params.values())).device
    return ZeroAmpState(zero_opt.init(params, spec), amp_.init_state(dev))


def _agree(flag: torch.Tensor, axis) -> torch.Tensor:
    """One flag for every rank: True if any rank's is (one scalar
    all-reduce)."""
    return psum(flag.float(), axis, tag="zero_flag") > 0


def _boundary_inf(acc, inv, axis) -> torch.Tensor:
    """The overflow check of the unscaled accumulated gradient, agreed
    over ``axis``."""
    maxabs = multi_tensor.multi_tensor_l2norm(acc, max_norm=True)
    return _agree(torch.logical_not(torch.isfinite(maxabs * inv)), axis)


def _scalers(amp_, state, loss_id, found_inf):
    new = amp_.scalers[loss_id].update(state.scaler[loss_id], found_inf)
    return new, tuple(new if i == loss_id else s
                      for i, s in enumerate(state.scaler))


def zero_microbatch_step(grad_fn: GradFn, zero_opt, amp_, spec, *,
                         microbatches: int = 1, loss_id: int = 0,
                         accum_dtype: str = "float32",
                         grad_presum: Optional[Callable[[Grads], Grads]] = None,
                         model: Optional[torch.nn.Module] = None,
                         compress=None) -> MicrobatchedStep:
    """ZeRO accumulation step: M gradient passes, then one reduce-scatter,
    the shard's update and one all-gather a boundary.

    ``zero_opt`` is a :class:`~apex_tpu_torch.contrib.optimizers.
    DistributedFusedAdam` or ``DistributedFusedLAMB``, ``spec`` its
    ``make_spec(params)``; the carry leads with ``(master_params,
    ZeroAmpState)`` (:func:`zero_init`).  The unscale folds into the
    microbatch mean (one multiply by ``1 / (scale M)``); the overflow
    check runs over the accumulated gradient and is agreed by a scalar
    all-reduce; an overflow in the gathered parameters (finite locals
    whose sum overflows) joins the same gate; on overflow the masters and
    the state keep their values and the scale backs off once.  With
    ``model``, the new masters are copied into it.  ``grad_presum`` runs
    on the accumulated gradient first (the long-context recipe's
    sequence-axis sum).

    ``compress`` wraps the reduce-scatter in the bf16 or int8 codec (the
    parameters' all-gather stays fp32); int8's residual covers the padded
    flat gradient (``spec.padded`` long) and rides as ``carry[2]``.  The
    codec path runs Adam's shard update, so it takes
    ``DistributedFusedAdam`` only (LAMB's norms need the reduce-scatter
    that ``DistributedFusedLAMB.step`` makes itself)."""
    m = int(microbatches)
    _accum_validate(accum_dtype)
    comp = compression_default(compress)
    if comp.enabled:
        _adam_only(zero_opt, "zero_microbatch_step(compress=)")

    def update_fn(carry, acc):
        params, state = carry[0], carry[1]
        if grad_presum is not None:
            acc = grad_presum(acc)
        inv = 1.0 / (state.scaler[loss_id].loss_scale * m)
        found_inf = _boundary_inf(acc, inv, zero_opt.axis)
        master_grads = {k: a * inv for k, a in acc.items()}
        new_res = None
        if comp.enabled:
            res = carry[2].ef_residual[0] if comp.error_feedback else None
            g_shard, new_res = _compressed_reduce_scatter(
                zero_opt, master_grads, spec, comp, res)
            new_opt = zero_opt._shard_update(g_shard, state.opt_state,
                                             zero_opt.lr)
            new_params = zero_opt._gather(new_opt.master_shard, spec)
        else:
            new_params, new_opt = zero_opt.step(master_grads,
                                                state.opt_state, spec)
        found_inf = torch.logical_or(
            found_inf, torch.logical_not(multi_tensor.tree_finite(new_params)))
        new_params = apply_if_finite(found_inf, new_params, params)
        new_opt = apply_if_finite(found_inf, new_opt, state.opt_state)
        new_s, scalers = _scalers(amp_, state, loss_id, found_inf)
        if model is not None:
            from apex_tpu_torch.amp import AmpOptimizer
            AmpOptimizer.copy_to_model(model, new_params)
        metrics = {"scale": new_s.loss_scale, "skipped": found_inf.float()}
        return ((new_params, ZeroAmpState(new_opt, scalers))
                + _ef_extras(comp, carry, new_res, found_inf), metrics)

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype,
                            compress=comp)


def _compressed_reduce_scatter(opt, master_grads, spec, comp, res):
    """The sharded optimizer's gradient reduce-scatter with the codec
    spliced in: the predivide, the compressed SUM, the division by world
    over the predivide."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import _flatten

    flat_g = _flatten(master_grads, spec)
    pre = opt.gradient_predivide_factor
    if pre != 1.0:
        flat_g = flat_g / pre
    g_shard, new_res = compress_reduce_scatter(flat_g, opt.axis, comp, res,
                                               tag="zero_grads")
    if opt.gradient_average:
        g_shard = g_shard / (opt.axis.size / pre)
    return g_shard, new_res


# -- FSDP: the parameters sharded too ------------------------------------------


class FsdpOptState(NamedTuple):
    """Adam's moments over the owned flat shard and the step; the master
    shard itself is the carry's first item."""

    step: Any
    m_shard: Any
    v_shard: Any


class FsdpAmpState(NamedTuple):
    """AMP state of the FSDP policy, like :class:`ZeroAmpState`."""

    opt_state: FsdpOptState
    scaler: Tuple


def fsdp_param_spec(axis_name: str = "data") -> P:
    """The spec of the FSDP carry's first item: the flat master shard
    rides ``axis_name``."""
    return P(axis_name)


def fsdp_state_spec(axis_name: str = "data") -> FsdpAmpState:
    """The :class:`FsdpAmpState`'s spec tree: moment shards on
    ``axis_name``, the step and the scalers replicated (from
    ``train_state_rules``)."""
    from apex_tpu_torch.sharding import train_state_rules
    from apex_tpu_torch.sharding.rules import _Leaf

    return train_state_rules(axis_name).match(FsdpAmpState(
        FsdpOptState(_Leaf(), _Leaf(), _Leaf()), _Leaf()))


def _adam_only(opt, where: str) -> None:
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB

    if isinstance(opt, DistributedFusedLAMB):
        raise NotImplementedError(
            f"{where}: fsdp mode takes the DistributedFusedAdam family; "
            f"LAMB's per-tensor trust ratios need the gathered update (use "
            f"the zero policy for LAMB)")


def fsdp_init(fsdp_opt, amp_, params: Grads, spec):
    """The FSDP carry's head on this rank: ``(param_shard,
    FsdpAmpState)``, the flat fp32 master shard, zero moments and fresh
    scaler states."""
    _adam_only(fsdp_opt, "fsdp_init")
    st = fsdp_opt.init(params, spec)
    return st.master_shard, FsdpAmpState(
        FsdpOptState(st.step, st.m_shard, st.v_shard),
        amp_.init_state(st.master_shard.device))


def fsdp_unflatten_params(param_shard: torch.Tensor, spec, axis
                          ) -> Dict[str, torch.Tensor]:
    """The parameter dict from the flat master shards: one all-gather
    over ``axis`` (the boundary's prepare step)."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import _unflatten

    return _unflatten(all_gather(param_shard, axis, tag="fsdp_params"),
                      spec)


def fsdp_microbatch_step(grad_fn: GradFn, fsdp_opt, amp_, spec, *,
                         microbatches: int = 1, loss_id: int = 0,
                         accum_dtype: str = "float32",
                         grad_presum: Optional[Callable[[Grads], Grads]] = None,
                         model: Optional[torch.nn.Module] = None,
                         compress=None) -> MicrobatchedStep:
    """FSDP accumulation step: one all-gather of the parameters (the
    boundary's ``prepare_fn``), M gradient passes against them, then one
    reduce-scatter and the owned shard's update.

    The carry leads with ``(param_shard, FsdpAmpState)``
    (:func:`fsdp_init`); ``grad_fn`` reads ``carry[0]`` as the full
    parameter dict, as under the other policies, and with ``model`` the
    gathered parameters are copied into it before the passes.  The AMP
    gate is the ZeRO one, and an overflow in the reduce-scattered shard
    (finite locals, an overflowing sum) is agreed by a second scalar
    all-reduce, since the shards differ from rank to rank.  ``compress``
    wraps the reduce-scatter as :func:`zero_microbatch_step` does (the
    parameters' all-gather stays fp32: compressed weights would fork the
    replicas), int8's residual as ``carry[2]``."""
    _adam_only(fsdp_opt, "fsdp_microbatch_step")
    comp = compression_default(compress)
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState)

    m = int(microbatches)
    _accum_validate(accum_dtype)
    axis = fsdp_opt.axis

    def prepare_fn(carry):
        params = fsdp_unflatten_params(carry[0], spec, axis)
        if model is not None:
            from apex_tpu_torch.amp import AmpOptimizer
            AmpOptimizer.copy_to_model(model, params)
        return (params,) + tuple(carry[1:])

    def update_fn(carry, acc):
        shard, state = carry[0], carry[1]
        if grad_presum is not None:
            acc = grad_presum(acc)
        inv = 1.0 / (state.scaler[loss_id].loss_scale * m)
        found_inf = _boundary_inf(acc, inv, axis)
        master_grads = {k: a * inv for k, a in acc.items()}
        new_res = None
        if comp.enabled:
            res = carry[2].ef_residual[0] if comp.error_feedback else None
            g_shard, new_res = _compressed_reduce_scatter(
                fsdp_opt, master_grads, spec, comp, res)
        else:
            g_shard = fsdp_opt._reduce_scatter(master_grads, spec)
        o = state.opt_state
        new = fsdp_opt._shard_update(
            g_shard, ShardedOptState(o.step, shard, o.m_shard, o.v_shard),
            fsdp_opt.lr)
        post_inf = torch.logical_not(
            torch.all(torch.isfinite(new.master_shard)))
        found_inf = torch.logical_or(found_inf, _agree(post_inf, axis))
        new_shard = apply_if_finite(found_inf, new.master_shard, shard)
        new_opt = apply_if_finite(
            found_inf, FsdpOptState(new.step, new.m_shard, new.v_shard), o)
        new_s, scalers = _scalers(amp_, state, loss_id, found_inf)
        metrics = {"scale": new_s.loss_scale, "skipped": found_inf.float()}
        return ((new_shard, FsdpAmpState(new_opt, scalers))
                + _ef_extras(comp, carry, new_res, found_inf), metrics)

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype,
                            prepare_fn=prepare_fn, compress=comp)


# -- the canonical train state: ZeRO and FSDP across meshes --------------------
#
# A ZeRO carry saved by four ranks restores as FSDP on two, and the other
# way round, through the canonical form: the full parameters and moments
# as dicts in the parameters' order, the step and the scalers.  The flat
# layouts differ with the world (the padding) and the two modes keep
# different trees, so every reshard goes through it.  No rank holds a
# sharded carry whole: the canonical form is all-gathered over the axis
# from live carries, or read from every source rank's directory.

REDUCTION_MODES = ("zero", "fsdp")


def _mode(mode: str) -> str:
    if mode not in REDUCTION_MODES:
        raise ValueError(f"mode must be one of {REDUCTION_MODES}, got "
                         f"{mode!r}")
    return mode


def reduction_carry_template(mode: str, params: Grads, world: int, amp_, *,
                             device=None):
    """A rank's ``(params | shard, state)`` carry template for ``mode``
    on a ``world``-way axis: zeros of this layout's shard length
    (``padded / world``) and fresh scaler states on ``device`` (None:
    the parameters'); what a restore reads a saved rank's directory
    into."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState, _make_spec)

    _mode(mode)
    dev = next(iter(params.values())).device if device is None else device
    n = _make_spec(params, world).padded // int(world)
    flat = lambda: torch.zeros((n,), dtype=torch.float32,  # noqa: E731
                               device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    scaler = amp_.init_state(dev)
    if mode == "zero":
        return ({k: torch.zeros_like(v, device=dev)
                 for k, v in params.items()},
                ZeroAmpState(ShardedOptState(step, flat(), flat(), flat()),
                             scaler))
    return flat(), FsdpAmpState(FsdpOptState(step, flat(), flat()), scaler)


def _flats(carry, mode: str):
    """(master, m, v) flat shards, the step and the scalers of a
    carry."""
    st = carry[1].opt_state
    master = carry[0] if mode == "fsdp" else st.master_shard
    return (master, st.m_shard, st.v_shard), st.step, carry[1].scaler


def train_state_canonical(carry, params_template: Grads, world: int, *,
                          mode: str, axis=None) -> Dict[str, Any]:
    """A ZeRO or FSDP carry in its canonical full form: ``{"params",
    "m", "v", "step", "scaler"}``, the params and moments as dicts in
    ``params_template``'s order and dtypes (the moments fp32).
    ``carry`` is this rank's carry, its shards all-gathered over
    ``axis`` (tagged ``canonical``); or a list of every rank's carries in
    axis order (read from their directories), concatenated."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        _make_spec, _unflatten)

    _mode(mode)
    spec = _make_spec(params_template, world)
    if isinstance(carry, list):
        if len(carry) != world:
            raise ValueError(f"{len(carry)} source carries for a "
                             f"{world}-way layout")
        parts = [_flats(c, mode) for c in carry]
        flats = [torch.cat([p[0][i] for p in parts]) for i in range(3)]
        step, scaler = parts[0][1], parts[0][2]
    else:
        shards, step, scaler = _flats(carry, mode)
        flats = [all_gather(s, axis, 0, tag="canonical") for s in shards]
    if flats[0].shape != (spec.padded,):
        raise ValueError(
            f"flat master length {tuple(flats[0].shape)} does not match the "
            f"{world}-way layout ({spec.padded},): wrong world size for "
            f"this carry")
    moments = spec._replace(dtypes=(torch.float32,) * len(spec.names))
    return {"params": _unflatten(flats[0], spec),
            "m": _unflatten(flats[1], moments),
            "v": _unflatten(flats[2], moments),
            "step": step, "scaler": scaler}


def carry_from_canonical(canon: Dict[str, Any], *, mode: str, opt):
    """This rank's ``(params | shard, state)`` carry under ``mode`` on
    ``opt.axis`` (a ``DistributedFusedAdam`` or ``LAMB``), from the
    canonical form: the flat layout recomputed for this axis's world,
    this rank's block of each flat buffer, everything else copied."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState, _flatten, _make_spec)

    _mode(mode)
    spec = _make_spec(canon["params"], opt.axis.size)
    p, m, v = (opt._shard(_flatten(canon[k], spec), spec).clone()
               for k in ("params", "m", "v"))
    step = canon["step"].clone()
    scaler = tuple(type(s)(*(t.clone() for t in s)) for s in canon["scaler"])
    if mode == "zero":
        params = {k: t.clone() for k, t in canon["params"].items()}
        return params, ZeroAmpState(ShardedOptState(step, p, m, v), scaler)
    return p, FsdpAmpState(FsdpOptState(step, m, v), scaler)


def save_train_state(path: str, carry, step: int, *, mode: str, mesh,
                     table=None, axis_name: str = "data", **kw) -> str:
    """Checkpoint this rank's ZeRO or FSDP carry under its own directory
    (``checkpoint.save_checkpoint(process_local=True)``), with the rules
    outcome (the table's fingerprint, the mesh, the mode) as the step's
    sharding sidecar; every rank of the mesh calls it."""
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch import sharding as shd

    table = table or shd.train_state_rules(axis_name)
    outcome = shd.rules_outcome(table, carry, mesh, mode=_mode(mode))
    return checkpoint.save_checkpoint(path, carry, step, process_local=True,
                                      sharding_outcome=outcome, **kw)


def _source_rank(saved_mesh: Dict[str, int], axis_name: str, j: int) -> int:
    """The rank at index ``j`` of ``axis_name`` and 0 on every other axis
    of a saved mesh (row-major, as ``make_mesh`` lays ranks out)."""
    rank = 0
    for name, size in saved_mesh.items():
        rank = rank * int(size) + (j if name == axis_name else 0)
    return rank


def restore_train_state(path: str, params: Grads, *, opt, amp_, mode: str,
                        mesh, step: Optional[int] = None):
    """Restore a ZeRO or FSDP carry saved by :func:`save_train_state` as
    ``mode`` on ``opt.axis`` of ``mesh``; returns ``(carry, step)``.

    The sidecar (rank 0's) gives the saved mode and mesh.  Every source
    rank's directory along the axis is read (its carry template
    from :func:`reduction_carry_template`), the canonical form is
    concatenated from them, and this rank's carry is rebuilt under
    ``mode`` (:func:`carry_from_canonical`): the parameters bit for bit
    the gather of the source.  Every restore takes this one path, the
    same mode on the same mesh too.  A checkpoint without a sidecar is
    taken to match the live layout.  ``params`` is the parameter dict
    template (names, shapes, dtypes, device)."""
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.sharding import mesh_axes

    ax = opt.axis
    live = mesh_axes(mesh)
    saved = checkpoint.read_sharding_outcome(path, step, rank=0) or {}
    src_mode = saved.get("mode", mode)
    src_mesh = saved.get("mesh") or live
    src_world = int(src_mesh.get(ax.name, ax.size))
    dev = next(iter(params.values())).device
    carries, got = [], None
    for j in range(src_world):
        template = reduction_carry_template(src_mode, params, src_world,
                                            amp_, device=dev)
        c, got = checkpoint.restore_checkpoint(
            checkpoint.process_dir(path, _source_rank(src_mesh, ax.name, j)),
            template, step)
        carries.append(c)
    canon = train_state_canonical(carries, params, src_world, mode=src_mode)
    return carry_from_canonical(canon, mode=mode, opt=opt), got
