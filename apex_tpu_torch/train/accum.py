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
each boundary makes one all-reduce, of one flat fp32 buffer.  Not ported
yet (ROADMAP item 6): compressed boundary collectives
(``train/compress.py``), ZeRO and FSDP; ``compress=`` raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.parallel.distributed import flatten_tree, unflatten_tree

__all__ = ["ACCUM_DTYPES", "MicrobatchedStep", "amp_microbatch_step",
           "build_opt_step"]

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

    Build it with :func:`amp_microbatch_step` for the AMP update, or
    directly for a custom ``update_fn``."""

    grad_fn: GradFn
    update_fn: UpdateFn
    microbatches: int
    accum_dtype: str = "float32"


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
        acc = None
        per_mb = []
        for i in range(m):
            grads, gm = step.grad_fn(carry, None if xs is None
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
    if compress is not None:
        raise NotImplementedError(
            "amp_microbatch_step: compress= (the compressed boundary "
            "collective of train/compress.py) is not ported yet: ROADMAP "
            "item 6")
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
