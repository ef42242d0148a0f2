#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit; it builds the kernels from ``apex_tpu_torch/csrc`` itself.
It prints one JSON line per phase and fails (non-zero exit, no result
line) on any failed check:

1. card: name and power limit (``nvidia-smi``), kernel build time;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the serving path's shapes, with its time, the plain
   version's time, one PyTorch library call's time as a yardstick and
   the least time the card could take (``bound_ms``);
3. parity: GPT-2 small at fp32 on the card against the same port on the
   CPU with the same seeded weights (one 64-token prefill chunk, one
   K=8 decode window, one more decode step);
4. engine: ``ServeEngine`` serving GPT-2 small (bf16 compute, bf16 page
   pool) through 16 seeded requests, with every kernel's launch count
   read from that run alone.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` summary and, as
the last line, ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with status 1 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from apex_tpu_torch import GPTConfig, GPTDecoder, ServeEngine, init_params
from apex_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from apex_tpu_torch.ops.attention import (
    paged_cached_attention,
    paged_fused_attention,
    quantize_kv,
)
from apex_tpu_torch.ops.layer_norm import layer_norm, layer_norm_ref

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12  # device memory
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
BF16_FLOPS = 989e12        # bf16 on the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back runs
    (CUDA events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_events(prof):
    """The device-side events (kernels, copies, fills) of a trace.  Only
    these are summed: ``key_averages()`` also gives every aten op the
    device time of the kernels it launched, which would count them
    twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: the durations of its device-side
    events from a ``torch.profiler`` trace of ``iters`` calls (host gaps
    excluded), or None when the profiler records none on this machine."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in _kernel_events(prof))
    return total_us / iters / 1e3 if total_us > 0 else None


def timings(fn, iters: int = 50) -> dict:
    """``ms``: device time per call (profiler); ``events_ms``: CUDA-event
    time per call over back-to-back calls, which includes the host's
    enqueue time wherever the host is the slower side."""
    ev = time_ms(fn, iters=iters)
    dev = device_ms(fn)
    return {"ms": ev if dev is None else dev, "events_ms": ev,
            "ms_source": "events" if dev is None else "profiler"}


def bf16_ulp_ok(got, want, ulps: int = 1, floor: float = 0.0) -> bool:
    """Every element within ``ulps`` bf16 ulps of the larger magnitude,
    plus an absolute ``floor``."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((g - w).abs() <= ulps * ulp + floor).all())


def _merge(kern: dict, plain: dict, lib: dict) -> dict:
    out = dict(kern)
    for prefix, d in (("plain_", plain), ("library_", lib)):
        out.update({prefix + k: v for k, v in d.items()})
    return out


# -- phase 2: kernels ------------------------------------------------------

def phase_layer_norm(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 768
    w = 1 + 0.1 * torch.randn(n, device=dev, generator=gen)
    b = 0.1 * torch.randn(n, device=dev, generator=gen)
    cases = []
    # rows: the decode step (8 slots x 1 token) and a prefill chunk (128)
    for rows in (8, 128):
        for dtype in (torch.float32, torch.bfloat16):
            x = (2 * torch.randn(rows, n, device=dev, generator=gen)
                 + 0.5).to(dtype)
            got = layer_norm(x, w, b)
            want = layer_norm_ref(x, w, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                check(err <= 1e-5, f"layer_norm fp32 rows={rows}: {err}")
            else:
                check(bf16_ulp_ok(got, want),
                      f"layer_norm bf16 rows={rows}: {err}")
            kern = timings(lambda: layer_norm(x, w, b))
            plain = timings(lambda: layer_norm_ref(x, w, b))
            wd, bd = w.to(dtype), b.to(dtype)
            lib = timings(lambda: F.layer_norm(x, (n,), wd, bd))
            nbytes = 2 * x.numel() * x.element_size() + 2 * n * 4
            flops = 8 * x.numel()
            bound = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            case = {"rows": rows, "n": n,
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": err,
                    "tol": "1e-5" if dtype == torch.float32 else "1 bf16 ulp",
                    **_merge(kern, plain, lib),
                    "bound_ms": bound,
                    "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                    >= flops / FP32_FLOPS else "operations"}
            emit({"phase": "kernel", "kernel": "layer_norm", **case})
            cases.append(case)
    return cases


def _paged_problem(dev, gen, t, pool_dtype, masked):
    """GPT-2-small paged read: B=8, H=12, D=64, page_len 16, 64 pages per
    slot, lengths across partial pages, the full 12-layer pool read at
    layer 5.  bf16/int8 pools go with bf16 q (int8 with fp32
    dequantized new keys, as the model passes them); fp32 with fp32.
    q ~ 2·N(0, 1) and k, v ~ N(0, 1) make scores of std 2: a peaked
    softmax whose outputs are of order 1, so that one key more or less
    moves them by far more than the check's tolerance."""
    b, h, d, page_len, pps, layers = 8, 12, 64, 16, 64, 12
    num_pages = 1 + b * pps
    shape = (num_pages, layers, h, page_len, d)
    pool_k = torch.randn(shape, device=dev, generator=gen)
    pool_v = torch.randn(shape, device=dev, generator=gen)
    ks = vs = None
    if pool_dtype == torch.int8:
        pool_k, ks = quantize_kv(pool_k)
        pool_v, vs = quantize_kv(pool_v)
    else:
        pool_k, pool_v = pool_k.to(pool_dtype), pool_v.to(pool_dtype)
    qdt = torch.float32 if pool_dtype == torch.float32 else torch.bfloat16
    perm = torch.randperm(num_pages - 1, device=dev, generator=gen) + 1
    table = perm.reshape(b, pps).to(torch.int32)
    lengths = torch.randint(1, pps * page_len - t + 1, (b,), device=dev,
                            generator=gen, dtype=torch.int32)
    positions = (lengths[:, None]
                 + torch.arange(t, device=dev, dtype=torch.int32))
    q = (2 * torch.randn(b, h, t, d, device=dev, generator=gen)).to(qdt)
    kn = torch.randn(b, h, t, d, device=dev, generator=gen)
    vn = torch.randn(b, h, t, d, device=dev, generator=gen)
    if pool_dtype == torch.int8:
        kq, kqs = quantize_kv(kn)
        vq, vqs = quantize_kv(vn)
        kn, vn = kq.float() * kqs[..., None], vq.float() * vqs[..., None]
    else:
        kn, vn = kn.to(qdt), vn.to(qdt)
    mask = None
    if masked:
        mask = torch.rand(t, t, device=dev, generator=gen) < 0.6
        mask.fill_diagonal_(True)
    return dict(q=q, k_new=kn, v_new=vn, positions=positions.contiguous(),
                pool_k=pool_k, pool_v=pool_v, page_table=table,
                cache_lengths=lengths, pool_k_scale=ks, pool_v_scale=vs,
                layer=5, block_mask=mask)


def _sdpa_yardstick(p):
    """The same attention as one ``F.scaled_dot_product_attention`` call
    on the gathered view (built outside the timed call)."""
    q = p["q"]
    b, h, t, d = q.shape
    table = p["page_table"].long()
    pk, pv = p["pool_k"][:, p["layer"]], p["pool_v"][:, p["layer"]]
    n_pages, page_len = table.shape[1], pk.shape[2]
    s = n_pages * page_len

    def view(pool, sc):
        g = pool[table].permute(0, 2, 1, 3, 4).reshape(b, h, s, d).float()
        if sc is not None:
            scl = sc[:, p["layer"]][table].permute(0, 2, 1, 3).reshape(b, h, s)
            g = g * scl[..., None]
        return g

    k = torch.cat([view(pk, p["pool_k_scale"]), p["k_new"].float()], 2)
    v = torch.cat([view(pv, p["pool_v_scale"]), p["v_new"].float()], 2)
    pos = p["positions"]
    j = torch.arange(s, device=q.device)
    vis_c = (j < p["cache_lengths"][:, None, None]) & (j <= pos[:, :, None])
    vis_n = pos[:, None, :] <= pos[:, :, None]
    if p["block_mask"] is not None:
        vis_n = vis_n & p["block_mask"][None]
    mask = torch.cat([vis_c, vis_n], -1)[:, None]
    k, v = k.to(q.dtype), v.to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _paged_bound(p):
    """Least time for this call's work: each visible K/V element (and
    scale) read once, q/k_new/v_new read and the output written once;
    QK and PV dots over the visible keys at the peak rate of q's type
    (bf16 tensor cores for bf16, fp32 outside them for fp32)."""
    q = p["q"]
    b, h, t, d = q.shape
    lens = p["cache_lengths"].long()
    pos = p["positions"].long()
    vis = torch.minimum(lens, pos.max(dim=1).values + 1)
    n_keys = int(vis.sum())
    per_tok = 2 * h * d * p["pool_k"].element_size()
    if p["pool_k_scale"] is not None:
        per_tok += 2 * h * 4
    nbytes = n_keys * per_tok
    nbytes += q.numel() * q.element_size() * 2  # q in, out
    nbytes += 2 * p["k_new"].numel() * p["k_new"].element_size()
    # scores: each query's visible cache keys plus its visible new keys
    vis_c = torch.minimum(lens[:, None], pos + 1)
    vis_n = pos[:, None, :] <= pos[:, :, None]
    if p["block_mask"] is not None:
        vis_n = vis_n & p["block_mask"][None]
    flops = 4 * h * d * (int(vis_c.sum()) + int(vis_n.sum()))
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _paged_close(got, want) -> bool:
    """fp32 output: within 2e-5 (the order of fp32 sums).  bf16 output:
    each element within 2 bf16 ulps of the larger magnitude plus 1e-5
    (fp32 summation order near zero), and within 2e-2 overall."""
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.float32:
        return err <= 2e-5
    return err <= 2e-2 and bf16_ulp_ok(got, want, ulps=2, floor=1e-5)


# planted faults the check must catch: the kernel skipping the last,
# partial page of the history, and a key mask one key short
_FAULTS = {
    "drop_last_partial_page": lambda lens: lens - lens % 16,
    "mask_one_key_short": lambda lens: lens - 1,
}


def phase_paged_attention(dev):
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    grid = [(t, pd, m) for t in (1, 128)
            for pd in (torch.bfloat16, torch.int8) for m in (False, True)]
    grid += [(1, torch.float32, False), (128, torch.float32, True)]
    for t, pool_dtype, masked in grid:
        p = _paged_problem(dev, gen, t, pool_dtype, masked)
        q, kn, vn = p["q"], p["k_new"], p["v_new"]
        kw = {k: v for k, v in p.items() if k not in ("q", "k_new", "v_new")}
        got = paged_fused_attention(q, kn, vn, **kw)
        want = paged_cached_attention(q, kn, vn, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ("2e-5" if q.dtype == torch.float32
               else "2 bf16 ulps + 1e-5, and 2e-2")
        name = (f"T={t} pool={str(pool_dtype).replace('torch.', '')} "
                f"masked={masked}")
        check(_paged_close(got, want),
              f"paged attention {name}: max abs err {err}")
        faults = {}
        for fault, lens_of in _FAULTS.items():
            bad = paged_fused_attention(
                q, kn, vn, **dict(kw, cache_lengths=lens_of(
                    p["cache_lengths"]).contiguous()))
            faults[fault] = (bad.float() - want.float()).abs().max().item()
            check(not _paged_close(bad, want),
                  f"paged attention {name}: the check misses {fault}")
        kern = timings(lambda: paged_fused_attention(q, kn, vn, **kw))
        plain = timings(lambda: paged_cached_attention(q, kn, vn, **kw),
                        iters=20)
        lib = timings(_sdpa_yardstick(p), iters=20)
        bound, by = _paged_bound(p)
        case = {"case": name, "B": q.shape[0], "H": q.shape[1], "T": t,
                "D": q.shape[3], "mean_len": float(p["cache_lengths"]
                                                   .float().mean()),
                "max_abs_err": err, "tol": tol,
                "planted_fault_errs": faults, **_merge(kern, plain, lib),
                "bound_ms": bound, "bound_by": by}
        emit({"phase": "kernel", "kernel": "paged_fused_attention", **case})
        cases.append(case)
    return cases


# -- phase 3: parity ---------------------------------------------------------

def phase_parity(params):
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    rng = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 50257, (1, 64), generator=rng,
                           dtype=torch.int32)
    out = {}
    for where in ("cuda", "cpu"):
        dec = GPTDecoder(cfg, params, cache_dtype=torch.float32,
                         tokens_per_dispatch=8, device=where)
        cache = dec.init_paged_cache(num_pages=65, slots=1, page_len=16)
        table = torch.arange(1, 65, dtype=torch.int32)[None]
        logits = dec.prefill_chunk(cache, table, [0], prompt, [0], [64])
        first = torch.argmax(logits, -1).to(torch.int32)
        toks = dec.paged_decode_window(cache, table, first, [True])
        with torch.no_grad():
            step = dec.model.paged_decode_step(
                toks[-1], cache.k, cache.v, table.to(dec.device),
                cache.lengths)
        out[where] = (logits.cpu(), toks.cpu()[:, 0], step.cpu(),
                      [int(first[0])] + toks.cpu()[:, 0].tolist())
        del dec, cache
    err_prefill = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    err_step = (out["cuda"][2] - out["cpu"][2]).abs().max().item()
    emit({"phase": "parity", "model": "GPT-2 small fp32",
          "prefill_logits_max_abs_err": err_prefill,
          "decode_logits_max_abs_err": err_step,
          "greedy_tokens_cuda": out["cuda"][3],
          "greedy_tokens_cpu": out["cpu"][3]})
    check(err_prefill <= 1e-3, f"prefill logits differ by {err_prefill}")
    check(err_step <= 1e-3, f"decode logits differ by {err_step}")
    check(out["cuda"][3] == out["cpu"][3], "greedy tokens differ")


# -- phase 4: engine ---------------------------------------------------------

def phase_engine(dev, params):
    cfg = GPTConfig.small()
    dec = GPTDecoder(cfg, params, compute_dtype=torch.bfloat16,
                     cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                     device=dev)
    eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                      prefill_chunk=128, seed=0)
    rng = torch.Generator().manual_seed(4)

    def toks(n):
        return torch.randint(0, 50257, (n,), generator=rng).tolist()

    # a 256-token shared prefix: the second request extends the first
    # through its partial tail page, so it maps the shared pages and its
    # first write copy-on-writes the shared tail
    shared = toks(256)
    first = shared + toks(8)
    second = first + toks(40)
    lens = torch.randint(64, 769, (14,), generator=rng).tolist()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(first, max_new_tokens=64)]
    while eng._prefilling or eng._queue:  # the first prompt's pages land
        eng.step()
    uids.append(eng.submit(second, max_new_tokens=64))
    uids += [eng.submit(toks(n), max_new_tokens=64) for n in lens]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    stats = eng.stats()
    n_tok = sum(len(out[u]) for u in uids)
    emit({"phase": "engine", "model": "GPT-2 small bf16, bf16 pages",
          "requests": len(uids), "prompt_lens": [len(first), len(second)]
          + lens, "generated_tokens": n_tok, "wall_s": wall,
          "tokens_per_s": n_tok / wall,
          "windows": stats["decode_dispatches"],
          "chunks": stats["prefill_dispatches"],
          "prefix_hits": stats["prefix_hits"],
          "prefix_hit_tokens": stats["prefix_hit_tokens"],
          "cow_copies": stats["cow_copies"],
          "preemptions": stats["preemptions"],
          "peak_pages_in_use": stats["peak_pages_in_use"],
          "launches": launches})
    check(all(len(out[u]) == 64 for u in uids), "a request fell short")
    check(all(0 <= t < cfg.vocab_size for u in uids for t in out[u]),
          "token out of range")
    check(stats["prefix_hits"] >= 1 and stats["cow_copies"] >= 1,
          "no prefix reuse / copy-on-write")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never launched: {launches}")
    return launches, dec


def phase_profile(dec):
    """Where a decode window's time goes: 8 slots with 512-token
    histories, one K=8 window under ``torch.profiler`` — wall time,
    device-busy share and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                      prefill_chunk=512, seed=1)
    rng = torch.Generator().manual_seed(5)
    for _ in range(8):
        eng.submit(torch.randint(0, 50257, (512,), generator=rng).tolist(),
                   max_new_tokens=32)
    while eng._prefilling or eng._queue or not eng._active:
        eng.step()
    eng.step()  # one warm window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # one window without the profiler's own host cost
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in _kernel_events(prof):
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "profile", "what": "one K=8 decode window, 8 slots, "
          "512-token histories, GPT-2 small bf16",
          "wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else None,
          "device_busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
          "top_kernels": [{"name": k[:90], "device_ms": ms, "calls": n}
                          for k, ms, n in rows[:8]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln]
             for name in _build.KERNEL_SOURCES}
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": built, "build_wall_s": time.perf_counter() - t0,
          "ptxas": ptxas})

    ln_cases = phase_layer_norm(dev)
    pa_cases = phase_paged_attention(dev)

    params = init_params(GPTConfig.small(), torch.Generator().manual_seed(0))
    phase_parity(params)
    launches, dec = phase_engine(dev, params)
    phase_profile(dec)

    # the summary rows: each kernel at the engine's decode-step shape
    ln = next(c for c in ln_cases if c["rows"] == 8 and c["dtype"] == "float32")
    pa = next(c for c in pa_cases if c["case"] == "T=1 pool=bfloat16 "
              "masked=False")
    rows = []
    for name, src, tpu, c in (
            ("layer_norm", "apex_tpu_torch/csrc/layer_norm.cu",
             "apex_tpu/ops/layer_norm.py:133", ln),
            ("paged_fused_attention", "apex_tpu_torch/csrc/paged_attention.cu",
             "apex_tpu/ops/attention.py:415", pa)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": c["max_abs_err"], "tol": c["tol"],
                     "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"],
                     "case": c.get("case") or f"rows={c['rows']} n={c['n']} "
                     f"{c['dtype']}"})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
