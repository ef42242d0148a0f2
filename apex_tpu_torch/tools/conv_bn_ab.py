"""Device time of the conv+BN kernels of two checkouts, in turns.

    python3 apex_tpu_torch/tools/conv_bn_ab.py TREE [TREE ...]

Run from the root of a checkout on a machine with a CUDA device: each
TREE (a directory holding a checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory, or a timing-only copy
with a kernel phase cut out or a constant moved) is timed in its own
process, with its own ``apex_tpu_torch`` and its own kernel build, in the
order given, so ``parent . . parent`` compares two commits on one card.
Each tree prints one JSON line: for every case, the device ms of one call
of ``matmul_stats``, ``matmul_bwd_dual`` and ``bn_relu_matmul`` (with
ReLU), summed over the call's kernels from a ``torch.profiler`` trace of
10 back-to-back calls after a warm-up (as ``chip_smoke.py``'s ``ms``),
and, where the tree has a design rule, the design each entry point took.
Beside them, timed the same way in the same process, the PyTorch
yardsticks of the three entry points (``library``: ``torch.matmul`` plus
the fp32 column sums and sums of squares for ``matmul_stats``; the
unfused BN, ReLU and cast, then the same, for ``bn_relu_matmul``; two
``torch.matmul`` s for the dual, as ``chip_smoke.py``'s
``library_ms``); the port never calls them.  The cases are RN50's eight batch-128 1x1
convolutions in bf16 (``chip_smoke.py``'s ``RN50_1X1``) and the ragged
(1000, 72, 200), with ``chip_smoke.py``'s input scales (x ~ 0.5 N(0, 1),
w ~ 0.05 N(0, 1), dy ~ 0.1 N(0, 1), the BN parameters) from seed 22.  A
case a tree refuses reads as the error it raised.  The first line is the
card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

CASES = ((128 * 56 * 56, 256, 64), (128 * 56 * 56, 64, 256),
         (128 * 28 * 28, 512, 128), (128 * 28 * 28, 128, 512),
         (128 * 14 * 14, 1024, 256), (128 * 14 * 14, 256, 1024),
         (128 * 7 * 7, 2048, 512), (128 * 7 * 7, 512, 2048),
         (1000, 72, 200))


def _device_ms(fn, iters: int = 10) -> float:
    """Device time of one ``fn()``: the durations of its kernels in a
    profiler trace of ``iters`` calls, or None where the profiler records
    no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3 if us > 0 else None


def _inputs(dev, gen, m, k, n):
    import torch

    bf = torch.bfloat16
    x = (0.5 * torch.randn(m, k, device=dev, generator=gen)).to(bf)
    w = (0.05 * torch.randn(k, n, device=dev, generator=gen)).to(bf)
    bn = (0.1 * torch.randn(k, device=dev, generator=gen),
          1.0 + torch.rand(k, device=dev, generator=gen),
          1.0 + 0.1 * torch.randn(k, device=dev, generator=gen),
          0.1 * torch.randn(k, device=dev, generator=gen))
    dy = (0.1 * torch.randn(m, n, device=dev, generator=gen)).to(bf)
    return x, w, bn, dy


def _lib_stats(x, w):
    y = x @ w
    y32 = y.float()
    return y, y32.sum(0), (y32 * y32).sum(0)


def _lib_bn(x, bn, w):
    mean, rstd, gamma, beta = bn
    a = ((x.float() - mean) * (rstd * gamma) + beta).clamp_min(0.0)
    return _lib_stats(a.to(w.dtype), w)


def time_tree() -> dict:
    """The timings of the ``apex_tpu_torch`` in the working directory."""
    sys.path.insert(0, os.getcwd())
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import conv_bn as cb

    _build.build(["conv_bn"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {"tree": os.getcwd(), "cases": {}}
    for m, k, n in CASES:
        x, w, bn, dy = _inputs(dev, gen, m, k, n)
        rec = {}
        for name, fn in (
                ("matmul_stats", lambda: cb.matmul_stats(x, w)),
                ("matmul_bwd_dual", lambda: cb.matmul_bwd_dual(x, dy, w)),
                ("bn_relu_matmul", lambda: cb.bn_relu_matmul(x, *bn, w))):
            try:
                rec[name] = _device_ms(fn)
            except (ValueError, RuntimeError) as e:
                rec[name] = f"not taken: {e}"
        rec["library"] = {
            "matmul_stats": _device_ms(lambda: _lib_stats(x, w)),
            "bn_relu_matmul": _device_ms(lambda: _lib_bn(x, bn, w)),
            "matmul_bwd_dual": _device_ms(
                lambda: (torch.matmul(dy, w.T), torch.matmul(x.T, dy)))}
        rule = getattr(cb, "_conv_bn_design", None)
        if rule is not None:
            try:  # an older rule takes ``bn`` (and keeps it on mma.sync)
                bn_code = rule("stats", x, w, bn=True)
            except TypeError:
                bn_code = rule("stats", x, w)
            rec["design"] = {
                "matmul_stats": cb.STATS_DESIGNS[rule("stats", x, w)],
                "bn_relu_matmul": cb.STATS_DESIGNS[bn_code],
                "matmul_bwd_dual": cb.DUAL_DESIGNS[rule("dual", x, w, dy)]}
        out["cases"][f"M={m} K={k} N={n}"] = rec
        del x, w, bn, dy
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    if trees == ["--here"]:
        print(json.dumps(time_tree()), flush=True)
        return 0
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    print(smi.stdout.strip(), flush=True)
    script = os.path.abspath(__file__)
    for tree in trees:
        subprocess.run([sys.executable, script, "--here"],
                       cwd=os.path.abspath(tree), check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())
