"""Where DCGAN's fp32 gradients leave float64 on the card: a probe.

    python3 apex_tpu_torch/tools/dcgan_probe.py

Run from the root of a checkout on a machine with a CUDA device.  With
``chip_smoke.py``'s weights and data for ``dcgan_parity`` (seeds 70 and
71, batch 8, TF32 off), it prints one JSON line each for:

- ``convs``: each of DCGAN's convolution shapes at batch 8 on the card in
  fp32 against the same call in float64 (y, dx and dw, relative L2);
- ``d_real``: the Discriminator's real-image loss, its forward and
  backward written out layer by layer, in fp32 on the card and on the
  CPU, each against float64 on the CPU: every activation's and its
  gradient's relative L2 error, and for each BatchNorm output the count
  of elements whose sign differs from float64's (a leaky ReLU after it
  then takes the other slope there).

The card's name and power limit come first.
"""
from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

SHAPES = (  # (name, transposed, x NHWC, kernel HWIO, strides, padding)
    ("G ConvTranspose_0", True, (8, 1, 1, 100), (4, 4, 100, 512), (1, 1),
     "VALID"),
    ("G ConvTranspose_1", True, (8, 4, 4, 512), (4, 4, 512, 256), (2, 2),
     "SAME"),
    ("G ConvTranspose_4", True, (8, 32, 32, 64), (4, 4, 64, 3), (2, 2),
     "SAME"),
    ("D Conv_0", False, (8, 64, 64, 3), (4, 4, 3, 64), (2, 2),
     ((1, 1), (1, 1))),
    ("D Conv_2", False, (8, 16, 16, 128), (4, 4, 128, 256), (2, 2),
     ((1, 1), (1, 1))),
    ("D Conv_3", False, (8, 8, 8, 256), (4, 4, 256, 512), (2, 2),
     ((1, 1), (1, 1))),
    ("D Conv_4", False, (8, 4, 4, 512), (4, 4, 512, 1), (1, 1), "VALID"))


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def convs() -> dict:
    from apex_tpu_torch.amp.functional import conv_nhwc, conv_transpose_nhwc
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, transposed, xs, ws, strides, pad in SHAPES:
        fn = conv_transpose_nhwc if transposed else conv_nhwc
        x = torch.randn(xs, device="cuda", generator=gen)
        w = 0.05 * torch.randn(ws, device="cuda", generator=gen)
        res = []
        for dt in (torch.float32, torch.float64):
            xg = x.to(dt).requires_grad_()
            wg = w.to(dt).requires_grad_()
            y = fn(xg, wg, strides, pad)
            cot = torch.randn(y.shape, device="cuda", generator=torch
                              .Generator(device="cuda").manual_seed(1))
            res.append((y, *torch.autograd.grad(y, [xg, wg], cot.to(dt))))
        out[name] = [_rel(a, b) for a, b in zip(*res)]
    return out


def _d_real(params, real, where, dt) -> dict:
    """The Discriminator's real-image loss layer by layer (the model's
    arithmetic, with every convolution a contiguous ``F.conv2d``):
    each activation and its gradient."""
    from apex_tpu_torch.models import Discriminator
    d = Discriminator()
    d.load_state_dict(params)
    d.to(where).to(dt)
    acts = {}

    def keep(name, t):
        t.retain_grad()
        acts[name] = t
        return t

    def conv(i, x):
        m = getattr(d, f"Conv_{i}")
        y = F.conv2d(x.permute(0, 3, 1, 2).contiguous(),
                     m.kernel.permute(3, 2, 0, 1).contiguous(),
                     stride=m.strides, padding=1 if i < 4 else 0)
        return y.permute(0, 2, 3, 1)

    def bn(i, x):
        m = getattr(d, f"BatchNorm_{i}")
        mean = x.mean((0, 1, 2))
        var = torch.clamp_min((x * x).mean((0, 1, 2)) - mean * mean, 0.0)
        return ((x - mean) * (torch.rsqrt(var + m.eps) * m.scale)
                + m.bias)

    h = F.leaky_relu(keep("c0", conv(0, real.to(where, dt))), 0.2)
    for i in range(1, 4):
        h = keep(f"c{i}", conv(i, h))
        h = F.leaky_relu(keep(f"b{i - 1}", bn(i - 1, h)), 0.2)
    logits = keep("c4", conv(4, h)).reshape(-1)
    loss = torch.mean(torch.clamp_min(logits, 0) - logits
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    loss.backward()
    return {k: (v.detach(), v.grad) for k, v in acts.items()}


def d_real() -> dict:
    from apex_tpu_torch.models import Discriminator, Generator
    from apex_tpu_torch.models.dcgan import init_dcgan_params
    with torch.device("meta"):
        shapes_g, shapes_d = Generator(nz=100), Discriminator()
    init = torch.Generator().manual_seed(70)
    init_dcgan_params(shapes_g, init)  # the same draws as chip_smoke's
    params, _ = init_dcgan_params(shapes_d, init)
    real = torch.rand((8, 64, 64, 3),
                      generator=torch.Generator().manual_seed(71)) * 2 - 1
    ref = _d_real(params, real, "cpu", torch.float64)
    out = {}
    for side, where in (("card", "cuda"), ("cpu", "cpu")):
        got = _d_real(params, real, where, torch.float32)
        out[side] = {k: {"value": _rel(v, ref[k][0]),
                         "grad": _rel(g, ref[k][1])}
                     for k, (v, g) in got.items()}
        for k in got:
            if k.startswith("b"):
                out[side][k]["sign_flips"] = int(
                    ((got[k][0].cpu() > 0) != (ref[k][0] > 0)).sum())
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as C
    if not torch.cuda.is_available():
        print("dcgan_probe: no CUDA device", file=sys.stderr)
        return 1
    C.fp32_precision()
    print(C.nvidia_smi_line(), flush=True)
    print(json.dumps({"convs_rel_l2_y_dx_dw": convs()}), flush=True)
    print(json.dumps({"d_real_vs_cpu_float64": d_real()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
