"""ImageNet ResNet-50 mixed-precision training: AMP, fused SGD and DDP.

Port of ``examples/imagenet/main_amp.py`` (ref examples/imagenet/
main_amp.py): its flags and defaults (O1, the global batch ``-b``,
``--steps-per-dispatch`` 10, ``--sync_bn``, ``--data``, ``--prof``,
``--checkpoint``/``--resume``, ``--digest-file``), ``amp.initialize`` ->
``resnet50`` in the policy's model dtype -> ``AmpOptimizer(fused_sgd)``,
and its step: the forward under ``amp_.autocast()`` (live under O1), the
mean ``softmax_cross_entropy`` (the CUDA cross-entropy kernels on the
card), the scaled gradients reduced by ``DistributedDataParallel``, then
the optimizer step; the loss meter is the mean over the ranks.  K steps
run as one :class:`~apex_tpu_torch.train.FusedTrainDriver` window and
the meters are read once a window.

As in JAX the example always runs data parallel: it joins the process
group it was launched into, or makes one of a single process, and
destroys the group it made when it ends.  Every rank sees the global
window and the mesh driver steps it on its block of the batch.

Data: synthetic windows by default, drawn from ``numpy.random.
RandomState(--seed)`` exactly as the JAX example draws them; ``--data
<file>`` (``apex_tpu_torch.data.write_records``'s format: a uint8 HWC
``image`` and an int32 ``label``) runs ``NativeDataLoader(shuffle=True,
seed=--seed)`` -> ``window_batches`` -> ``DevicePrefetcher``, and the
uint8 images are normalised on the card after the copy
(:func:`normalize`, bit for bit JAX's host transform).  A run resumed
from ``--checkpoint`` by ``--resume`` continues an uninterrupted run
bit for bit only with ``--data``: the synthetic generator restarts from
its seed on resume, in JAX too.

    python -m apex_tpu_torch.examples.imagenet --opt-level O2 -b 128
    python -m apex_tpu_torch.examples.imagenet --data train.bin
    python -m apex_tpu_torch.parallel.multiproc \\
        -m apex_tpu_torch.examples.imagenet --sync_bn
    # on the CPU
    python -m apex_tpu_torch.examples.imagenet --device cpu \\
        --backend gloo --image-size 32 -b 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.checkpoint import restore_or_init
from apex_tpu_torch.data import DevicePrefetcher, NativeDataLoader
from apex_tpu_torch.data import window_batches
from apex_tpu_torch.models import ResNet, init_resnet_params, resnet50
from apex_tpu_torch.ops import softmax_cross_entropy
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    all_reduce,
    init_distributed,
    make_mesh,
    replicate,
)
from apex_tpu_torch.parallel.multiproc import free_port
from apex_tpu_torch.train import FusedTrainDriver, read_metrics

__all__ = ["ImageNet", "METRICS", "build", "fields", "main", "make_step",
           "normalize", "parse_args", "run", "windows"]

#: the window's meters, as the JAX example declares them
METRICS = {"loss": "mean", "scale": "last", "skipped": "sum"}
#: where ``--prof`` writes its Chrome trace
TRACE_FILE = "apex_tpu_torch_imagenet_trace.json"


def fields(image_size: int) -> Dict[str, Tuple[type, Tuple[int, ...]]]:
    """The record layout ``--data`` reads: a uint8 HWC image and an int32
    label."""
    return {"image": (np.uint8, (image_size, image_size, 3)),
            "label": (np.int32, ())}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--loss-scale", default=None,
                   help="float or 'dynamic' (ref --loss-scale)")
    p.add_argument("--keep-batchnorm-fp32", default=None,
                   type=lambda s: s == "True")
    p.add_argument("-b", "--batch-size", default=64, type=int,
                   help="GLOBAL batch size")
    p.add_argument("--lr", default=0.1, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--weight-decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--steps-per-epoch", default=30, type=int)
    p.add_argument("--image-size", default=224, type=int)
    p.add_argument("--num-classes", default=1000, type=int)
    p.add_argument("--sync_bn", action="store_true",
                   help="cross-process SyncBatchNorm (ref --sync_bn)")
    p.add_argument("--data", default=None,
                   help="fixed-record dataset (apex_tpu_torch.data."
                        "write_records format: uint8 image HWC + int32 "
                        "label); default synthetic random batches")
    p.add_argument("--prof", default=-1, type=int,
                   help="trace the window containing this step, then exit "
                        "(ref --prof)")
    p.add_argument("--steps-per-dispatch", default=10, type=int,
                   help="steps per window (K)")
    p.add_argument("--print-freq", default=10, type=int)
    p.add_argument("--digest-file", default=None,
                   help="write per-step loss digests (L1 compare harness)")
    p.add_argument("--resume", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default)")
    p.add_argument("--backend", default="nccl",
                   help="nccl (the card) or gloo (the CPU)")
    return p.parse_args(argv)


class AverageMeter:
    """ref main_amp.py AverageMeter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.sum = self.count = 0.0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


@dataclasses.dataclass
class ImageNet:
    """The AMP context, the model, its optimizer and the DDP policy."""

    amp: amp.Amp
    model: ResNet
    opt: amp.AmpOptimizer
    ddp: DistributedDataParallel


def build(opt_level: str = "O1", *, loss_scale=None,
          keep_batchnorm_fp32: Optional[bool] = None, lr: float = 0.1,
          momentum: float = 0.9, weight_decay: float = 1e-4,
          num_classes: int = 1000, sync_bn: bool = False, device=None,
          seed: int = 0, make: Callable[..., ResNet] = resnet50,
          params: Optional[Tuple[Dict, Dict]] = None):
    """The training objects and the first carry ``(masters, batch
    statistics, AmpOptState)`` on ``device`` (None: the card), in the
    initialised process group (the parameters are broadcast from its
    first rank).  ``make`` builds the model (``resnet50``; a test passes
    a narrow ``ResNet``); ``params`` is ``(state dict, batch
    statistics)``, else they are made from ``seed`` at flax's
    defaults."""
    dev = resolve_device(device)
    if loss_scale is not None and loss_scale != "dynamic":
        loss_scale = float(loss_scale)
    amp_ = amp.initialize(opt_level, loss_scale=loss_scale,
                          keep_batchnorm_fp32=keep_batchnorm_fp32)
    # O2/O3 cast the parameters and inputs to the half dtype; O1 keeps
    # the model fp32 and autocast casts the convolutions' and the
    # classifier's operands instead
    model = make(num_classes=num_classes,
                 compute_dtype=amp_.policy.cast_model_dtype or torch.float32,
                 sync_batchnorm=sync_bn)
    if params is None:
        params = init_resnet_params(
            model, torch.Generator(device=dev).manual_seed(seed))
    state_dict, stats = params
    state_dict = replicate({k: v.to(dev) for k, v in state_dict.items()})
    stats = replicate({k: v.to(dev) for k, v in stats.items()})
    model.load_state_dict(state_dict)
    model.to(dev)
    opt = amp.AmpOptimizer(fused_sgd(lr, momentum=momentum,
                                     weight_decay=weight_decay), amp_)
    masters = opt.attach(model)
    net = ImageNet(amp_, model, opt, DistributedDataParallel())
    return net, (masters, stats, opt.init(masters))


def make_step(net: ImageNet):
    """The driver's step (the JAX example's ``step``)."""
    amp_, model, opt, ddp = net.amp, net.model, net.opt, net.ddp
    names, ps = zip(*model.named_parameters())
    world = ddp.world()

    def step(carry, batch):
        masters, stats, state = carry
        x, y = batch
        with amp_.autocast():  # live under O1, no-op elsewhere
            logits, new_stats = model(x, stats, train=True)
        loss = softmax_cross_entropy(logits, y).mean()
        grads = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]),
                                    ps)
        grads = ddp.allreduce(dict(zip(names, grads)))
        masters, state, st = opt.step(grads, state, masters, model=model)
        # the loss meter is the mean over the ranks (JAX's pmean)
        mean = all_reduce(loss.detach().clone(), tag="loss_mean") / world
        return (masters, new_stats, state), {
            "loss": mean, "scale": st.loss_scale, "skipped": st.found_inf}

    return step


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 images -> fp32 ``(x - 127.5) / 127.5`` on their device, bit
    for bit the JAX example's numpy transform.  The divisor is a tensor
    on the images' device: a Python number would divide on the card
    through its reciprocal, one rounding away."""
    div = torch.full((), 127.5, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) - 127.5) / div


def windows(epoch: int, k: int, batch_size: int, image_size: int,
            num_classes: int, device, *, loader=None, rng=None,
            steps_per_epoch: int = 30):
    """One epoch's K-stacked ``(images, labels)`` windows on ``device``,
    each holding the global batch: with ``loader`` (a
    :class:`~apex_tpu_torch.data.NativeDataLoader`) its epoch through
    ``window_batches`` and ``DevicePrefetcher`` (the tail that does not
    fill a window dropped), the images normalised after the copy;
    without, ``steps_per_epoch`` steps drawn from ``rng``
    (``numpy.random.RandomState``) as the JAX example draws them."""
    if loader is None:
        done = 0
        while done < steps_per_epoch:
            kk = min(k, steps_per_epoch - done)
            x = rng.randn(kk, batch_size, image_size, image_size, 3)
            y = rng.randint(0, num_classes, size=(kk, batch_size))
            yield (torch.from_numpy(np.float32(x)).to(device),
                   torch.from_numpy(y.astype(np.int32)).to(device))
            done += kk
        return
    # window w + 1's copy is in flight while window w computes
    for images, labels in DevicePrefetcher(
            window_batches(loader.epoch(epoch), k, drop_last=True),
            transform=lambda b: (b["image"], b["label"]), device=device):
        yield normalize(images), labels


def _where_it_went(prof, cuda: bool, top: int = 10):
    """The profiled window's top ``top`` device kernels (host ops on the
    CPU) by time: ``[(name, ms, calls)]``."""
    from torch.autograd import DeviceType

    by_name: Dict[str, list] = {}
    if cuda:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                rec = by_name.setdefault(e.name, [0.0, 0])
                rec[0] += e.time_range.elapsed_us() / 1e3
                rec[1] += 1
    else:
        for e in prof.key_averages():
            by_name[e.key] = [e.self_cpu_time_total / 1e3, e.count]
    rows = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                  key=lambda r: -r[1])
    return rows[:top]


def run(args: argparse.Namespace, on_window=None) -> dict:
    """The example's training run.  ``on_window(epoch, w, carry, m)``
    follows each window's host read (a test's hook).  Returns
    ``{"digests", "windows", "images_per_s", "trace", "world"}``."""
    dev = resolve_device(args.device)
    made = not dist.is_initialized()
    if made and not init_distributed(args.backend):  # not launched
        init_distributed(args.backend,
                         init_method=f"tcp://127.0.0.1:{free_port()}",
                         rank=0, world_size=1)
    try:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return _train(args, dev, on_window)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, dev, on_window) -> dict:
    world = dist.get_world_size()
    if args.batch_size % world:
        raise ValueError(f"the global batch {args.batch_size} does not "
                         f"divide into {world} ranks")
    net, carry = build(
        args.opt_level, loss_scale=args.loss_scale,
        keep_batchnorm_fp32=args.keep_batchnorm_fp32, lr=args.lr,
        momentum=args.momentum, weight_decay=args.weight_decay,
        num_classes=args.num_classes, sync_bn=args.sync_bn, device=dev,
        seed=args.seed)
    rng = np.random.RandomState(args.seed)
    masters, stats, state = carry
    ckpt, start_epoch = restore_or_init(
        args.resume, {"params": masters, "batch_stats": stats,
                      "state": state})
    if start_epoch:
        masters, stats, state = (ckpt["params"], ckpt["batch_stats"],
                                 ckpt["state"])
        net.opt.copy_to_model(net.model, masters)
        amp.maybe_print(f"resumed from {args.resume} at epoch "
                        f"{start_epoch}")
    # K steps a window; the loss, scale and skip meters are read back
    # once a window, with the per-step losses for the digests
    driver = FusedTrainDriver(make_step(net),
                              steps_per_dispatch=args.steps_per_dispatch,
                              metrics=METRICS, per_step=("loss",),
                              mesh=make_mesh([("data", world)]))
    k = driver.steps_per_dispatch
    carry = (masters, stats, state)
    loader = None
    if args.data:
        loader = NativeDataLoader(args.data, fields(args.image_size),
                                  batch_size=args.batch_size, shuffle=True,
                                  seed=args.seed)
    batch_time, losses = AverageMeter(), AverageMeter()
    digests, records = [], []
    trace = None
    cuda = dev.type == "cuda"
    try:
        for epoch in range(start_epoch, args.epochs):
            for w, batch_w in enumerate(windows(
                    epoch, k, args.batch_size, args.image_size,
                    args.num_classes, dev, loader=loader, rng=rng,
                    steps_per_epoch=args.steps_per_epoch)):
                i = w * k  # the window's first step
                kk = batch_w[0].shape[0]
                prof = None
                # trace the whole window holding step --prof, then exit
                # (ref brackets iterations [prof, prof + N) with
                # cudaProfiler, main_amp.py:334-410)
                if args.prof >= 0 and i <= args.prof < i + kk:
                    from torch.profiler import ProfilerActivity, profile

                    prof = profile(activities=[ProfilerActivity.CPU]
                                   + ([ProfilerActivity.CUDA] if cuda
                                      else []))
                    prof.start()
                t0 = time.perf_counter()
                carry, res = driver.run_window(carry, batch_w)
                # ONE host read a window: the meters and the losses
                m = read_metrics({**res.metrics,
                                  "losses": res.per_step["loss"]})
                dt = time.perf_counter() - t0
                if prof is not None:
                    prof.stop()
                    trace = os.path.join(tempfile.gettempdir(), TRACE_FILE)
                    prof.export_chrome_trace(trace)
                    amp.maybe_print(f"profile written to {trace}")
                    for name, ms, calls in _where_it_went(prof, cuda):
                        amp.maybe_print(f"  {ms:10.3f} ms  {calls:5d}x  "
                                        f"{name[:90]}")
                    return {"digests": digests, "windows": records,
                            "images_per_s": None, "trace": trace,
                            "world": world}
                if w > 0:  # the first window warms up: not timed
                    batch_time.update(dt / kk, n=kk)
                losses.update(m["loss"], n=kk)
                digests.extend(m["losses"])
                records.append({"epoch": epoch, "window": w, "steps": kk,
                                "wall_s": dt, "loss": m["loss"],
                                "scale": m["scale"],
                                "skipped": m["skipped"]})
                if on_window is not None:
                    on_window(epoch, w, carry, m)
                if i % args.print_freq < kk:
                    speed = (args.batch_size / batch_time.avg
                             if batch_time.count else float("nan"))
                    amp.maybe_print(
                        f"Epoch [{epoch}][{i}/{args.steps_per_epoch}]  "
                        f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})  "
                        f"Speed {speed:.1f} img/s  "
                        f"Loss {losses.val:.4f} ({losses.avg:.4f})  "
                        f"scale {m['scale']:.0f}  "
                        f"skipped {m['skipped']:.0f}")
            if args.checkpoint:
                # epoch ends are window boundaries, so a resumed run's
                # scaler trajectory continues bit for bit
                masters, stats, state = carry
                driver.save(args.checkpoint,
                            {"params": masters, "batch_stats": stats,
                             "state": state}, step=epoch + 1)
                amp.maybe_print(f"checkpoint -> {args.checkpoint}/"
                                f"{epoch + 1}")
    finally:
        if loader is not None:
            loader.close()
    if args.digest_file and dist.get_rank() == 0:
        with open(args.digest_file, "w") as f:
            json.dump({"opt_level": args.opt_level, "losses": digests}, f)
        amp.maybe_print(f"digests -> {args.digest_file}")
    return {"digests": digests, "windows": records,
            "images_per_s": (args.batch_size / batch_time.avg
                             if batch_time.count else None),
            "trace": trace, "world": world}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
