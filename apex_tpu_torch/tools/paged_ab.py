"""Device time of the paged-attention kernel of two checkouts, in turns.

    python3 apex_tpu_torch/tools/paged_ab.py [--serve] TREE [TREE ...]

Run from the root of a checkout on a machine with a CUDA device: each
TREE (a directory holding a checkout, such as the parent commit unpacked
with ``git archive`` into a git-ignored directory) is timed in its own
process, with its own ``apex_tpu_torch`` and its own kernel build, in the
order given, so ``parent . . parent`` compares two commits on one card.
The problems are this checkout's: every case of ``chip_smoke.py``'s
``phase_paged_attention`` (:func:`chip_smoke.paged_problems`, the same
seeded inputs) and the ``profile`` phase's decode shape (GPT-2 small,
T = 1, bf16 pages, eight 520-token histories).  Each tree prints one
JSON line of ms per call after a warm-up: ``ms`` is the device time of
the call's kernels (``torch.profiler``, as chip_smoke's ``ms``) calling
the same layer back to back (its pages stay in the 50 MB L2, as in
chip_smoke's timings), ``ms_12_layers`` the same walking the pool's 12
layers in turn, as a decode step does (151 MB of pages, past the L2);
``events_ms`` is CUDA-event time over back-to-back calls, which is the
host's enqueue time wherever the host is the slower side, and
``host_ms`` that host time alone (the wrapper's checks, allocations and
launch).  A case a tree refuses reads as the error it raised.  With
``--serve`` each tree also runs its own ``chip_smoke.py``'s serving
phases at their own sizes and seeds: ``phase_engine`` (GPT-2 small, 16
requests: tokens/s) and ``phase_profile`` (one K = 8 decode window:
wall, device-busy ms, and the paged kernel's device ms and launches in
the window).  The first line is the card's name and power limit.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROFILE_LENGTHS = (520,) * 8


def _host_ms(fn, iters: int = 50) -> float:
    """Host time of one call: the wall time of ``iters`` calls that only
    enqueue (few enough that the launch queue never fills)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def _serve(dev) -> dict:
    """The serving phases of the working directory's own chip_smoke."""
    import torch

    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)
    lines = []
    T.emit = lines.append
    T.fp32_precision()
    params = T.init_params(T.GPTConfig.small(),
                           torch.Generator().manual_seed(0))
    _, dec = T.phase_engine(dev, params)
    T.phase_profile(dec)
    eng = next(x for x in lines if x.get("phase") == "engine")
    prof = next(x for x in lines if x.get("phase") == "profile")
    paged = [k for k in prof["top_kernels"] if "paged" in k["name"]]
    return {"engine_tokens_per_s": eng["tokens_per_s"],
            "engine_wall_s": eng["wall_s"],
            "window_wall_ms": prof["wall_ms"],
            "window_unprofiled_wall_ms": prof["unprofiled_wall_ms"],
            "window_device_busy_ms": prof["device_busy_ms"],
            "window_paged_device_ms": prof.get(
                "paged_attention_device_ms",
                sum(k["device_ms"] for k in paged)),
            "window_paged_kernel_launches": prof.get(
                "paged_attention_kernel_launches",
                sum(k["calls"] for k in paged))}


def time_tree(serve: bool = False) -> dict:
    """The timings of the ``apex_tpu_torch`` in the working directory, on
    the problems of this file's checkout (and, with ``serve``, its own
    serving phases)."""
    sys.path.insert(0, os.getcwd())
    import torch

    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops.attention import paged_fused_attention

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    _build.build(["paged_attention"])
    dev = torch.device("cuda")
    problems = list(C.paged_problems(dev))
    gen = torch.Generator(device=dev).manual_seed(6)
    problems.append(("profile window: T=1 pool=bfloat16, 8 x 520 keys",
                     C._paged_problem(dev, gen, 1, torch.bfloat16, False,
                                      PROFILE_LENGTHS)))
    out = {"tree": os.getcwd(), "cases": {}}
    for name, p in problems:
        q, kn, vn = p["q"], p["k_new"], p["v_new"]
        kw = {k: v for k, v in p.items() if k not in ("q", "k_new", "v_new")}
        layers = p["pool_k"].shape[1]
        try:
            paged_fused_attention(q, kn, vn, **kw)
        except (ValueError, RuntimeError) as e:
            out["cases"][name] = f"not taken: {e}"
            continue
        calls = iter(range(1 << 30))
        out["cases"][name] = {
            "ms": C.device_ms(
                lambda: paged_fused_attention(q, kn, vn, **kw), iters=48),
            "ms_12_layers": C.device_ms(
                lambda: paged_fused_attention(
                    q, kn, vn, **dict(kw, layer=next(calls) % layers)),
                iters=48),
            "events_ms": C.time_ms(
                lambda: paged_fused_attention(q, kn, vn, **kw), iters=50),
            "host_ms": _host_ms(
                lambda: paged_fused_attention(q, kn, vn, **kw))}
    if serve:
        out["serve"] = _serve(dev)
    return out


def main(argv=None) -> int:
    trees = sys.argv[1:] if argv is None else argv
    serve = "--serve" in trees
    trees = [t for t in trees if t != "--serve"]
    if trees == ["--here"]:
        print(json.dumps(time_tree(serve)), flush=True)
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
        subprocess.run([sys.executable, script, "--here"]
                       + (["--serve"] if serve else []),
                       cwd=os.path.abspath(tree), check=True, timeout=900)
    return 0


if __name__ == "__main__":
    sys.exit(main())
