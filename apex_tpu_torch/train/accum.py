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
(``P(axis_name)``) for the driver's ``carry_spec``.  Not ported yet
(ROADMAP item 6, part 2): compressed boundary collectives
(``train/compress.py``; ``compress=`` raises ``NotImplementedError``) and
Adasum (:func:`adasum_microbatch_step` raises).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch import multi_tensor
from apex_tpu_torch.amp.scaler import apply_if_finite
from apex_tpu_torch.parallel.distributed import flatten_tree, unflatten_tree
from apex_tpu_torch.parallel.mesh import P, all_gather, psum

__all__ = ["ACCUM_DTYPES", "FsdpAmpState", "FsdpOptState",
           "MicrobatchedStep", "ZeroAmpState", "adasum_microbatch_step",
           "amp_microbatch_step", "build_opt_step", "fsdp_init",
           "fsdp_microbatch_step", "fsdp_param_spec", "fsdp_state_spec",
           "fsdp_unflatten_params", "zero_init", "zero_microbatch_step",
           "zero_state_spec"]

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
    reduction over another mesh axis).  ``compress`` (ROADMAP item 6,
    ``train/compress.py``) raises ``NotImplementedError``."""
    _no_compress("amp_microbatch_step", compress)
    m = int(microbatches)
    _accum_validate(accum_dtype)

    def update_fn(carry, acc):
        masters, state = carry[0], carry[1]
        if grad_presum is not None:
            acc = grad_presum(acc)
        grads = {n: a / m for n, a in acc.items()}
        if ddp is not None:
            # one collective a boundary: the flat buffer (the reference's
            # flat bucket); the grads are fp32 already, so the flatten is
            # exact
            flat, spec = flatten_tree(grads)
            grads = unflatten_tree(ddp.allreduce(flat), spec)
        masters, state, stats = opt.step(grads, state, masters,
                                         loss_id=loss_id, model=model)
        metrics = {"scale": stats.loss_scale,
                   "skipped": stats.found_inf.float()}
        return (masters, state) + tuple(carry[2:]), metrics

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype)


def _no_compress(where: str, compress) -> None:
    if compress is not None:
        raise NotImplementedError(
            f"{where}: compress= (the compressed boundary collective of "
            f"train/compress.py) is not ported yet: ROADMAP item 6, part 2")


def adasum_microbatch_step(*args, **kwargs):
    """Adasum's boundary combine (``train/compress.py``) is not ported
    yet: raises ``NotImplementedError`` (ROADMAP item 6, part 2)."""
    raise NotImplementedError(
        "adasum_microbatch_step: the Adasum combine of train/compress.py is "
        "not ported yet: ROADMAP item 6, part 2")


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
    scalers are replicated."""
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState)

    ax = P(axis_name)
    return ZeroAmpState(ShardedOptState(P(), ax, ax, ax), P())


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
    sequence-axis sum)."""
    _no_compress("zero_microbatch_step", compress)
    m = int(microbatches)
    _accum_validate(accum_dtype)

    def update_fn(carry, acc):
        params, state = carry[0], carry[1]
        if grad_presum is not None:
            acc = grad_presum(acc)
        inv = 1.0 / (state.scaler[loss_id].loss_scale * m)
        found_inf = _boundary_inf(acc, inv, zero_opt.axis)
        master_grads = {k: a * inv for k, a in acc.items()}
        new_params, new_opt = zero_opt.step(master_grads, state.opt_state,
                                            spec)
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
                + tuple(carry[2:]), metrics)

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype)


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
    ``axis_name``, the step and the scalers replicated."""
    ax = P(axis_name)
    return FsdpAmpState(FsdpOptState(P(), ax, ax), P())


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
    all-reduce, since the shards differ from rank to rank."""
    _adam_only(fsdp_opt, "fsdp_microbatch_step")
    _no_compress("fsdp_microbatch_step", compress)
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
        g_shard = fsdp_opt._reduce_scatter({k: a * inv
                                            for k, a in acc.items()}, spec)
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
                + tuple(carry[2:]), metrics)

    return MicrobatchedStep(grad_fn, update_fn, m, accum_dtype,
                            prepare_fn=prepare_fn)
