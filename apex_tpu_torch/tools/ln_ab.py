"""Device time of the LayerNorm forward and backward of two checkouts, in
turns.

    python3 apex_tpu_torch/tools/ln_ab.py TREE [TREE ...]

Run from the root of a checkout on a machine with a CUDA device: each
TREE (a directory holding a checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory, or a timing-only copy
with a constant moved) is timed in its own process, with its own
``apex_tpu_torch`` and its own kernel build, in the order given, so
``parent . . parent`` compares two commits on one card.  Each tree
prints one JSON line with the device ms of one call, summed over the
call's kernels from a ``torch.profiler`` trace of 20 back-to-back calls
after a warm-up (as ``chip_smoke.py``'s ``ms``), at every case, and,
beside it, timed the same way in the same process, PyTorch's own call
on the same inputs (the port never calls it), the bound at 3.35 TB/s,
and where the tree has a design rule, the design the call took; where
that is the block design (rows of n <= 8192 off the warp design),
``wide_ms`` is the same call forced through the wide design (the rule
patched for that call alone), the measurement that keeps both designs:

- ``fwd_cases``: ``layer_norm`` beside ``F.layer_norm`` (weight and bias
  cast to x's dtype), the bound x read and y written once, w and b read
  once; the cases of ``chip_smoke.py``'s ``phase_layer_norm`` (GPT-2
  medium's (8192, 1024) among them), the inputs made as there (x ~ 2 N(0,
  1) + 0.5, w ~ 1 + 0.1 N(0, 1), b ~ 0.1 N(0, 1)) from seed 1, and
  (2050, 2304) bf16 x with fp32 affine, the backward's second block-design
  case;
- ``cases``: ``layer_norm_bwd`` (the kernel and the dgamma/dbeta
  reduction) beside ``aten::native_layer_norm_backward``, the bound x
  and dy read once, dx written once, w read and dgamma/dbeta written
  once; ``chip_smoke.py``'s ``phase_layer_norm_bwd`` cases and GPT-2
  medium's (8192, 1024) fp32 x with bf16 w, the inputs made as there
  (x as above, dy ~ N(0, 1), w as above) from seed 6.

A case a tree refuses reads as the error it raised.  The first line is
the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# (rows, n, x dtype, w dtype, bytes x's base lies past a 16-byte
# boundary): chip_smoke.ln_fwd_cases, and the backward's (2050, 2304)
FWD_CASES = (
    (8, 768, "float32", "float32", 0), (8, 768, "bfloat16", "float32", 0),
    (128, 768, "float32", "float32", 0), (128, 768, "bfloat16", "float32", 0),
    (512, 768, "float32", "float32", 0),
    (16384, 768, "float32", "bfloat16", 0),
    (16384, 768, "float32", "float32", 0),
    (6144, 1024, "float32", "bfloat16", 0),
    (6144, 1024, "float32", "float32", 0),
    (8192, 1024, "float32", "bfloat16", 0),
    (4097, 520, "bfloat16", "bfloat16", 0),
    (3000, 1024, "bfloat16", "bfloat16", 0),
    (4097, 1024, "bfloat16", "float32", 0),
    (4099, 1021, "float32", "bfloat16", 0),
    (4096, 768, "float32", "bfloat16", 4),
    (2050, 2304, "bfloat16", "float32", 0),
    (1024, 12288, "float32", "bfloat16", 0),
    (1024, 16384, "bfloat16", "float32", 0))
# (rows, n, x dtype, w dtype or None): chip_smoke.ln_bwd_cases, with
# GPT-2 medium's shape after BERT-large's
CASES = (
    (16384, 768, "float32", "bfloat16"), (16384, 768, "float32", "float32"),
    (16381, 768, "float32", "bfloat16"), (16384, 768, "bfloat16", "bfloat16"),
    (16384, 768, "float32", None), (6144, 1024, "float32", "bfloat16"),
    (6144, 1024, "float32", "float32"), (8192, 1024, "float32", "bfloat16"),
    (4099, 1021, "float32", "bfloat16"), (2050, 2304, "bfloat16", "float32"),
    (4097, 520, "bfloat16", "float32"), (4097, 1000, "bfloat16", "float32"),
    (3000, 1024, "bfloat16", "bfloat16"), (1024, 12288, "float32", "bfloat16"),
    (1024, 16384, "bfloat16", "float32"))


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


def _wide_ms(ln, rule: str, code: int, fn):
    """Device ms of ``fn()`` with the tree's design rule ``rule`` patched
    to return ``code`` (the wrapper looks the rule up at each call)."""
    keep = getattr(ln, rule)
    setattr(ln, rule, lambda *t: code)
    try:
        return _device_ms(fn)
    finally:
        setattr(ln, rule, keep)


def time_tree() -> dict:
    """The timings of the ``apex_tpu_torch`` in the working directory."""
    sys.path.insert(0, os.getcwd())
    import importlib

    import torch

    from apex_tpu_torch.ops import _build

    import torch.nn.functional as F

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    _build.build(["layer_norm"])
    dev = torch.device("cuda")
    out = {"tree": os.getcwd(), "fwd_cases": {}, "cases": {}}
    gen = torch.Generator(device=dev).manual_seed(1)
    for rows, n, x_name, w_name, misalign in FWD_CASES:
        x_dt, w_dt = getattr(torch, x_name), getattr(torch, w_name)
        w = (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(w_dt)
        b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(w_dt)
        x = (2 * torch.randn(rows, n, device=dev, generator=gen)
             + 0.5).to(x_dt)
        if misalign:  # a copy whose base lies misalign bytes off 16
            es = x.element_size()
            buf = torch.empty(x.numel() + 16 // es, dtype=x_dt, device=dev)
            off = next(i for i in range(16 // es)
                       if (buf.data_ptr() + i * es) % 16 == misalign)
            x = buf[off:off + x.numel()].view(rows, n).copy_(x)
        rec = {}
        try:
            rec["ms"] = _device_ms(lambda: ln.layer_norm(x, w, b))
        except (ValueError, RuntimeError) as e:
            rec["ms"] = f"not taken: {e}"
        wd, bd = w.to(x_dt), b.to(x_dt)
        rec["library_ms"] = _device_ms(lambda: F.layer_norm(x, (n,), wd, bd))
        rec["bound_ms"] = (2 * x.numel() * x.element_size()
                           + 2 * n * w.element_size()) / 3.35e12 * 1e3
        rule = getattr(ln, "_ln_fwd_design", None)
        if rule is not None:
            rec["design"] = ln.LN_FWD_DESIGNS[rule(x)]
            if rule(x) == ln.LN_FWD_BLOCK:
                rec["wide_ms"] = _wide_ms(
                    ln, "_ln_fwd_design", ln.LN_FWD_WIDE,
                    lambda: ln.layer_norm(x, w, b))
        key = f"rows={rows} n={n} {x_name}/{w_name}"
        out["fwd_cases"][key + (f" misalign={misalign}" if misalign
                                else "")] = rec
        del x, w, b, wd, bd
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(6)
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
            if rule(x, dy) == ln.LN_BWD_BLOCK:
                rec["wide_ms"] = _wide_ms(
                    ln, "_ln_bwd_design", ln.LN_BWD_WIDE,
                    lambda: ln.layer_norm_bwd(x, w, dy))
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
