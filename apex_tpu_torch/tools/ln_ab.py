"""Device time of the LayerNorm backward of two checkouts, in turns.

    python3 apex_tpu_torch/tools/ln_ab.py TREE [TREE ...]

Run from the root of a checkout on a machine with a CUDA device: each
TREE (a directory holding a checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory, or a timing-only copy
with a constant moved) is timed in its own process, with its own
``apex_tpu_torch`` and its own kernel build, in the order given, so
``parent . . parent`` compares two commits on one card.  Each tree
prints one JSON line: for every case, the device ms of one call of
``layer_norm_bwd`` (the kernel and the dgamma/dbeta reduction), summed
over the call's kernels from a ``torch.profiler`` trace of 20
back-to-back calls after a warm-up (as ``chip_smoke.py``'s ``ms``), and,
beside it, timed the same way in the same process, PyTorch's
``aten::native_layer_norm_backward`` on the same inputs (the port never
calls it), the bound (x and dy read once, dx written once, w read and
dgamma/dbeta written once, at 3.35 TB/s), and where the tree has a
design rule, the design the call took.  The cases are
``chip_smoke.py``'s ``phase_layer_norm_bwd`` cases and GPT-2 medium's
(8192, 1024) fp32 x with bf16 w, the inputs made as there (x ~ 2 N(0,
1) + 0.5, dy ~ N(0, 1), w ~ 1 + 0.1 N(0, 1)) from seed 6.  A case a tree refuses reads as the error it raised.  The
first line is the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# (rows, n, x dtype, w dtype or None): chip_smoke.ln_bwd_cases, with
# GPT-2 medium's shape after BERT-large's
CASES = (
    (16384, 768, "float32", "bfloat16"), (16384, 768, "float32", "float32"),
    (16381, 768, "float32", "bfloat16"), (16384, 768, "bfloat16", "bfloat16"),
    (16384, 768, "float32", None), (6144, 1024, "float32", "bfloat16"),
    (6144, 1024, "float32", "float32"), (8192, 1024, "float32", "bfloat16"),
    (4099, 1021, "float32", "bfloat16"), (2050, 2304, "bfloat16", "float32"),
    (4097, 520, "bfloat16", "float32"), (4097, 1000, "bfloat16", "float32"),
    (3000, 1024, "bfloat16", "bfloat16"))


def _device_ms(fn, iters: int = 20) -> float:
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


def time_tree() -> dict:
    """The timings of the ``apex_tpu_torch`` in the working directory."""
    sys.path.insert(0, os.getcwd())
    import importlib

    import torch

    from apex_tpu_torch.ops import _build

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    _build.build(["layer_norm"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {"tree": os.getcwd(), "cases": {}}
    for rows, n, x_name, w_name in CASES:
        x_dt = getattr(torch, x_name)
        x = (2 * torch.randn(rows, n, device=dev, generator=gen)
             + 0.5).to(x_dt)
        dy = torch.randn(rows, n, device=dev, generator=gen).to(x_dt)
        w = None if w_name is None else (
            1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(
                getattr(torch, w_name))
        rec = {}
        try:
            rec["ms"] = _device_ms(lambda: ln.layer_norm_bwd(x, w, dy))
        except (ValueError, RuntimeError) as e:
            rec["ms"] = f"not taken: {e}"
        wl = torch.ones(n, device=dev, dtype=x_dt) if w is None \
            else w.to(x_dt)
        bl = torch.zeros(n, device=dev, dtype=x_dt)
        _, mean, rstd = torch.native_layer_norm(x, [n], wl, bl, 1e-5)
        mask = [True, w is not None, w is not None]
        rec["aten_ms"] = _device_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [n], mean, rstd, wl, bl, mask))
        w_bytes = 0 if w is None else 3 * n * w.element_size()
        rec["bound_ms"] = (3 * x.numel() * x.element_size() + w_bytes) \
            / 3.35e12 * 1e3
        rule = getattr(ln, "_ln_bwd_design", None)
        if rule is not None:
            rec["design"] = ln.LN_BWD_DESIGNS[rule(x, dy)]
        out["cases"][f"rows={rows} n={n} {x_name}/{w_name}"] = rec
        del x, dy, w, wl, bl, mean, rstd
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
