"""Does ``torch.profiler`` deliver a short session's device events as the
process goes on?

    python3 apex_tpu_torch/tools/profiler_probe.py [--out FILE]

Run from the root of a checkout on a machine with a CUDA device.  The
probe builds the kernels and then, at points in one process's life,
records the same short sessions: four sessions of 4 launches of a
1024 x 1024 fp32 product, unpadded and padded with 20 ms of idle host
time at each end (the device events each recorded); three padded
sessions of one product, the gemm kernel's start minus its ``aten::mm``
op's start (us, None when either is missing); ``chip_smoke``'s
sentinel-checked ``own_device_events``/``device_ms`` over 20 products;
the product's CUDA-event ms; and the ``device_ms`` of the script before
its sentinels (an unchecked session of 20 products).  The points: fresh;
after ``chip_smoke``'s cross-entropy at RN50's shapes and its two
input-pipeline phases (``data_loader``, ``imagenet_example``: the
profiled windows of the ImageNet example); after ``ddp_gloo_card``; once
a minute while idle until 540 s; after the input-pipeline phases again;
at the end.  Each record is one JSON line on stdout and in ``--out``
(default ``build/profiler_probe.log``); the phases' own checks are
recorded as ``CHECK_FAILED`` lines instead of ending the run.

``--dump`` instead records, in a fresh process, three sentinel-bracketed
sessions of 20 calls each of the LayerNorm backward at GPT-2 small's
(16384, 768) with bf16 weights, its plain version, the cross-entropy
forward at (4097, 50257) bf16, its plain version and the product: each
session's device events by name, the sentinels' times, the events
outside them and the streams, and whether ``own_device_events`` then
accepts a session.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profiler_probe.log")
    ap.add_argument("--dump", action="store_true",
                    help="dump sessions of five functions in a fresh process")
    args = ap.parse_args(argv)
    t_start = time.time()
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as C

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w")
    fails = []

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def check(ok, msg):
        if not ok:
            fails.append(msg)
            emit({"CHECK_FAILED": msg[:2000]})

    C.emit, C.check = emit, check
    C.fp32_precision()
    dev = torch.device("cuda")
    smi = C.nvidia_smi_line()
    t = time.time()
    C._build.build()
    emit({"built_s": time.time() - t, "smi": smi})
    a = torch.randn(1024, 1024, device=dev)

    def session(pad, launches):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(launches):
                a @ a
            torch.cuda.synchronize()
            time.sleep(pad)
        return prof

    def probe(tag):
        res = {}
        for pad in (0.0, 0.02):
            res[f"events_pad_{pad}"] = [
                len(C._kernel_events(session(pad, 4))) for _ in range(4)]
        offs = []
        for _ in range(3):
            prof = session(0.05, 1)
            cpu = [e for e in prof.events() if e.name == "aten::mm"]
            gpu = [e for e in C._kernel_events(prof) if "gemm" in e.name]
            offs.append(gpu[0].time_range.start - cpu[0].time_range.start
                        if cpu and gpu else None)
        res["gemm_start_minus_mm_start_us"] = offs
        got = C.own_device_events(lambda: a @ a, 20)
        res["own_events"] = None if got is None else len(got[0])
        res["device_ms"] = C.device_ms(lambda: a @ a)
        res["events_ms"] = C.time_ms(lambda: a @ a)
        prof = session(0.0, 20)
        res["old_device_ms"] = sum(e.time_range.elapsed_us()
                                   for e in C._kernel_events(prof)) / 20 / 1e3
        emit({"diag": tag, "age_s": time.time() - t_start, **res})

    def input_phases(tag):
        t = time.time()
        tmp = tempfile.mkdtemp(prefix="profiler_probe_")
        try:
            path = C.phase_data_loader(dev, tmp)
            launches = C.phase_imagenet_example(dev, path, 0.0, smi)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        emit({"diag": f"input_phases_{tag}", "age_s": time.time() - t_start,
              "seconds": time.time() - t, "launches": launches})

    if args.dump:
        dump(C, dev, emit)
        out.close()
        return 0
    probe("fresh")
    xe = C.phase_xent_rn50(dev)
    emit({"diag": "xent_rn50", "cases": [c[0]["case"] for c in xe]})
    input_phases("fresh")
    probe("after_input_fresh")
    torch.cuda.empty_cache()
    C.phase_ddp_gloo_card(dev)
    probe("after_gloo")
    while time.time() - t_start < 540:
        time.sleep(60)
        probe("idle")
    input_phases("aged")
    probe("end")
    emit({"diag": "done", "fails": len(fails),
          "age_s": time.time() - t_start})
    out.close()
    return 0


def dump(C, dev, emit) -> None:
    """The ``--dump`` records (see the module's docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                               layer_norm_bwd_ref)
    from apex_tpu_torch.ops.softmax_xentropy import (
        softmax_cross_entropy_fwd, softmax_cross_entropy_fwd_ref)

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16384, 768, device=dev, generator=g)
    w = (1 + 0.1 * torch.randn(768, device=dev, generator=g)).to(
        torch.bfloat16)
    dy = torch.randn(16384, 768, device=dev, generator=g)
    lg = (3 * torch.randn(4097, 50257, device=dev, generator=g)).to(
        torch.bfloat16)
    lab = torch.randint(0, 50257, (4097,), device=dev, generator=g)
    a = torch.randn(1024, 1024, device=dev)
    fns = {"ln_bwd": lambda: layer_norm_bwd(x, w, dy),
           "ln_bwd_ref": lambda: layer_norm_bwd_ref(x, w, dy),
           "xent_fwd": lambda: softmax_cross_entropy_fwd(lg, lab, 0.0),
           "xent_fwd_ref": lambda: softmax_cross_entropy_fwd_ref(lg, lab,
                                                                 0.0),
           "mm": lambda: a @ a}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        for trial in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
            ev = C._kernel_events(prof)
            marks = sorted((e for e in ev if C.SENTINEL in e.name),
                           key=lambda e: e.time_range.start)
            counts = {}
            for e in ev:
                counts[e.name[:50]] = counts.get(e.name[:50], 0) + 1
            rec = {"fn": name, "trial": trial, "n": len(ev),
                   "marks": [(m.time_range.start, m.time_range.end)
                             for m in marks], "counts": counts}
            if len(marks) == 2:
                lo, hi = marks[0].time_range.end, marks[1].time_range.start
                outside = [(e.name[:40], e.device_resource_id,
                            e.time_range.start - lo, hi - e.time_range.end)
                           for e in ev if C.SENTINEL not in e.name
                           and (e.time_range.start < lo
                                or e.time_range.end > hi)]
                rec["outside"] = outside[:20]
                rec["n_outside"] = len(outside)
            rec["streams"] = sorted({e.device_resource_id for e in ev})
            rec["own"] = (C.own_device_events(fn, 20) is not None
                          if trial == 2 else None)
            emit(rec)


if __name__ == "__main__":
    sys.exit(main())
