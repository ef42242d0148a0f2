"""DCGAN with three loss scalers: two models, two optimizers, three losses.

Port of ``examples/dcgan/main_amp.py`` (ref examples/dcgan/main_amp.py):
``amp.initialize(opt_level, num_losses=3)`` gives each loss its own
dynamic scaler (errD_real ``loss_id=0``, errD_fake 1, errG 2).  D takes
two backward passes into one step — ``optD.accumulate(g_real,
loss_id=0)`` then ``optD.step(g_fake, loss_id=1)`` — and G one,
``optG.step(loss_id=2)``; the losses go through
``amp.F.binary_cross_entropy_with_logits`` and both optimizers are
``fused_adam(2e-4, betas=(0.5, 0.999))``.  As in the JAX example the
models run in the policy's compute dtype (bf16 under O1) through their
layers' ``dtype``, with no autocast block.

One G+D iteration is one :class:`~apex_tpu_torch.train.FusedTrainDriver`
step, the three scaler states ride in the carry, and the loss meters and
scales are read once a window.  The data is synthetic: 64 x 64 images
uniform in [-1, 1] and normal z, made on the device from a seed::

    python -m apex_tpu_torch.examples.dcgan [--opt-level O1] [--steps 20]
        [-b 16] [--nz 100] [--steps-per-dispatch 5] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, Optional, Tuple

import torch

from apex_tpu_torch import amp
from apex_tpu_torch.amp import F
from apex_tpu_torch.models.dcgan import (
    Discriminator,
    Generator,
    init_dcgan_params,
)
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train import FusedTrainDriver, read_metrics

__all__ = ["DCGAN", "METRICS", "build", "make_step", "synthetic_window"]

#: the window's meters: the last iteration's losses and the three scales
METRICS = {"errD": "last", "errG": "last", "scale_d_real": "last",
           "scale_d_fake": "last", "scale_g": "last"}


@dataclasses.dataclass
class DCGAN:
    """The two models, their optimizers and the one AMP context."""

    amp: amp.Amp
    netG: Generator
    netD: Discriminator
    optG: amp.AmpOptimizer
    optD: amp.AmpOptimizer


def build(opt_level: str = "O1", nz: int = 100, ngf: int = 64,
          ndf: int = 64, device=None, seed: int = 0,
          params: Optional[Tuple[Dict, Dict, Dict, Dict]] = None):
    """The models, optimizers and the first carry ``(G masters, G batch
    statistics, G state, D masters, D statistics, D state)`` on
    ``device`` (None: the card).  ``params`` is ``(G params, G stats, D
    params, D stats)`` as state dicts; without it they are made from
    ``seed`` at flax's defaults."""
    dev = resolve_device(device)
    amp_ = amp.initialize(opt_level, num_losses=3)
    dt = amp_.policy.compute_dtype
    netG = Generator(nz=nz, ngf=ngf, compute_dtype=dt)
    netD = Discriminator(ndf=ndf, compute_dtype=dt)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        gp, gs = init_dcgan_params(netG, gen)
        dp, ds = init_dcgan_params(netD, gen)
    else:
        gp, gs, dp, ds = params
    netG.load_state_dict(gp)
    netD.load_state_dict(dp)
    netG.to(dev)
    netD.to(dev)
    optG = amp.AmpOptimizer(fused_adam(2e-4, betas=(0.5, 0.999)), amp_)
    optD = amp.AmpOptimizer(fused_adam(2e-4, betas=(0.5, 0.999)), amp_)
    gm, dm = optG.attach(netG), optD.attach(netD)
    carry = (gm, {k: v.to(dev) for k, v in gs.items()}, optG.init(gm),
             dm, {k: v.to(dev) for k, v in ds.items()}, optD.init(dm))
    return DCGAN(amp_, netG, netD, optG, optD), carry


def make_step(gan: DCGAN):
    """The driver's step: one D step over two losses, then one G step."""
    amp_, netG, netD = gan.amp, gan.netG, gan.netD
    g_names, g_ps = zip(*netG.named_parameters())
    d_names, d_ps = zip(*netD.named_parameters())

    def d_grads(loss, scaler_state, loss_id):
        scaled = amp_.scale_loss(loss, scaler_state, loss_id=loss_id)
        return dict(zip(d_names, torch.autograd.grad(scaled, d_ps)))

    def step(carry, batch):
        gm, gstats, gstate, dm, dstats, dstate = carry
        real, z = batch
        # D: two backward passes with their own scalers (loss_id 0 and 1)
        with torch.no_grad():
            fake, _ = netG(z, gstats, train=True)
        out, dstats = netD(real, dstats, train=True)
        err_real = F.binary_cross_entropy_with_logits(out,
                                                      torch.ones_like(out))
        g_real = d_grads(err_real, dstate.scaler[0], 0)
        out, dstats = netD(fake, dstats, train=True)
        err_fake = F.binary_cross_entropy_with_logits(out,
                                                      torch.zeros_like(out))
        g_fake = d_grads(err_fake, dstate.scaler[1], 1)
        dstate = gan.optD.accumulate(g_real, dstate, loss_id=0)
        dm, dstate, _ = gan.optD.step(g_fake, dstate, dm, loss_id=1,
                                      model=netD)
        # G: one loss through the updated D (whose statistics it discards)
        fake, gstats = netG(z, gstats, train=True)
        out, _ = netD(fake, dstats, train=True)
        err_g = F.binary_cross_entropy_with_logits(out, torch.ones_like(out))
        scaled = amp_.scale_loss(err_g, gstate.scaler[2], loss_id=2)
        grads = dict(zip(g_names, torch.autograd.grad(scaled, g_ps)))
        gm, gstate, _ = gan.optG.step(grads, gstate, gm, loss_id=2,
                                      model=netG)
        return (gm, gstats, gstate, dm, dstats, dstate), {
            "errD": (err_real + err_fake).detach(),
            "errG": err_g.detach(),
            "scale_d_real": dstate.scaler[0].loss_scale,
            "scale_d_fake": dstate.scaler[1].loss_scale,
            "scale_g": gstate.scaler[2].loss_scale}

    return step


def synthetic_window(gen: torch.Generator, k: int, b: int, nz: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K iterations of data on the generator's device: images (K, b, 64,
    64, 3) uniform in [-1, 1] and z (K, b, 1, 1, nz) normal."""
    dev = gen.device
    real = torch.rand((k, b, 64, 64, 3), generator=gen, device=dev) * 2 - 1
    z = torch.randn((k, b, 1, 1, nz), generator=gen, device=dev)
    return real, z


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--opt-level", default="O1",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--steps", default=20, type=int)
    p.add_argument("-b", "--batch-size", default=16, type=int)
    p.add_argument("--nz", default=100, type=int)
    p.add_argument("--steps-per-dispatch", default=5, type=int,
                   help="G+D iterations per window (the print cadence: the "
                   "meters are read once a window)")
    p.add_argument("--device", default=None,
                   help="cpu, or the card (the default)")
    args = p.parse_args(argv)
    gan, carry = build(args.opt_level, nz=args.nz, device=args.device)
    driver = FusedTrainDriver(make_step(gan),
                              steps_per_dispatch=args.steps_per_dispatch,
                              metrics=METRICS)
    data = torch.Generator(device=resolve_device(args.device)).manual_seed(0)
    done, m = 0, {}
    while done < args.steps:
        k = min(args.steps_per_dispatch, args.steps - done)
        window = synthetic_window(data, k, args.batch_size, args.nz)
        carry, res = driver.run_window(carry, window)
        done += k
        m = read_metrics(res.metrics)  # one host read a window
        scales = [m["scale_d_real"], m["scale_d_fake"], m["scale_g"]]
        print(f"[{done}/{args.steps}] Loss_D {m['errD']:.4f} "
              f"Loss_G {m['errG']:.4f} scales {scales}")
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
