#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--log FILE]

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit; it builds the kernels from ``apex_tpu_torch/csrc`` itself.
It prints one JSON line per phase and fails (non-zero exit, no result
line) on any failed check:

1. card: name and power limit (``nvidia-smi``), kernel build time;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the serving path's shapes (LayerNorm forward also at
   the training shape, with O2's bf16 affine), with its time, the plain
   version's time, one PyTorch library call's time as a yardstick and
   the least time the card could take (``bound_ms``);
3. parity: GPT-2 small at fp32 on the card against the same port on the
   CPU with the same seeded weights (one 64-token prefill chunk, one
   K=8 decode window, one more decode step);
4. engine: ``ServeEngine`` serving GPT-2 small (bf16 compute, bf16 page
   pool) through 16 seeded requests, with every kernel's launch count
   read from that run alone; profile: one decode window under
   ``torch.profiler``;
5. training kernels: the LayerNorm backward, flash attention forward and
   backward and the fused cross-entropy forward and backward against
   their plain versions at the training shapes (GPT-2 small, batch
   16 x 1024) and, for flash attention, at a few other shapes, each with
   planted faults the check must reject, and the library yardsticks (``F.layer_norm``'s backward,
   ``F.scaled_dot_product_attention``, ``F.cross_entropy``);
6. train parity: GPT-2 small at fp32 (O0, TF32 off, no dropout), batch
   2 x 256, loss and gradients on the card against the port on the CPU;
7. train: O2 training of GPT-2 small at batch 16 x 1024 with dropout,
   ``AmpOptimizer(fused_adam(6e-4, weight_decay=0.1))`` driven by
   ``FusedTrainDriver`` at K = 10 steps per window: tokens/s, losses,
   peak memory, the launch counts of one window, and a planted overflow
   step that must be skipped; then one step under ``torch.profiler``.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` summary and, as
the last line, ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with status 1 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from apex_tpu_torch import (
    FusedTrainDriver,
    GPTConfig,
    GPTDecoder,
    GPTLM,
    ServeEngine,
    amp,
    init_params,
    read_metrics,
)
from apex_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from apex_tpu_torch.ops.attention import (
    _pack_seed,
    attention_ref,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    paged_cached_attention,
    paged_fused_attention,
    quantize_kv,
)
from apex_tpu_torch.ops.layer_norm import (
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_ref,
    layer_norm_ref,
)
from apex_tpu_torch.ops.softmax_xentropy import (
    softmax_cross_entropy_bwd,
    softmax_cross_entropy_bwd_ref,
    softmax_cross_entropy_fwd,
    softmax_cross_entropy_fwd_ref,
)
from apex_tpu_torch.optimizers import fused_adam

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


def _bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the bytes over the memory rate against the
    operations over the peak rate of their type (``ops`` maps a peak
    rate to the operations done at it; the times of the types add)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for rate, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _close(got, want, rtol: float, ulps: int = 0) -> bool:
    """Every element within ``rtol`` times the largest magnitude of
    ``want`` (the order of fp32 sums over the reduced axis), plus, for a
    bf16 result, ``ulps`` bf16 ulps of the larger magnitude (one rounding
    on each side)."""
    floor = rtol * want.float().abs().max().item()
    if got.dtype == torch.bfloat16:
        return bf16_ulp_ok(got, want, ulps=ulps, floor=floor)
    return _err(got, want) <= floor


def _dt(t) -> str:
    return str(t).replace("torch.", "")


# -- phase 2: kernels ------------------------------------------------------

def phase_layer_norm(dev):
    """LayerNorm forward at the serving shapes (the decode step, 8 slots x
    1 token, and a 128-token prefill chunk; fp32 and bf16 x with fp32
    affine) and at the training shape, (16384, 768) fp32 x with bf16
    affine (O2 casts every GPT parameter, LayerNorm's included) and with
    fp32 affine (O0).  fp32 output within 1e-5, bf16 within 1 bf16 ulp."""
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 768
    w32 = 1 + 0.1 * torch.randn(n, device=dev, generator=gen)
    b32 = 0.1 * torch.randn(n, device=dev, generator=gen)
    cases = []
    for rows, dtype, w_dt in ((8, torch.float32, torch.float32),
                              (8, torch.bfloat16, torch.float32),
                              (128, torch.float32, torch.float32),
                              (128, torch.bfloat16, torch.float32),
                              (16384, torch.float32, torch.bfloat16),
                              (16384, torch.float32, torch.float32)):
        w, b = w32.to(w_dt), b32.to(w_dt)
        x = (2 * torch.randn(rows, n, device=dev, generator=gen)
             + 0.5).to(dtype)
        got = layer_norm(x, w, b)
        want = layer_norm_ref(x, w, b)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            check(err <= 1e-5, f"layer_norm fp32 rows={rows} affine "
                  f"{_dt(w_dt)}: {err}")
        else:
            check(bf16_ulp_ok(got, want),
                  f"layer_norm bf16 rows={rows}: {err}")
        kern = timings(lambda: layer_norm(x, w, b))
        plain = timings(lambda: layer_norm_ref(x, w, b))
        wd, bd = w.to(dtype), b.to(dtype)
        lib = timings(lambda: F.layer_norm(x, (n,), wd, bd))
        bound, by = _bound(2 * x.numel() * x.element_size()
                           + 2 * n * w.element_size(),
                           {FP32_FLOPS: 8 * x.numel()})
        case = {"rows": rows, "n": n, "dtype": _dt(dtype),
                "w_dtype": _dt(w_dt), "max_abs_err": err,
                "tol": "1e-5" if dtype == torch.float32 else "1 bf16 ulp",
                **_merge(kern, plain, lib), "bound_ms": bound,
                "bound_by": by}
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
    serving = ("layer_norm", "paged_fused_attention")
    check(all(launches[n] > 0 for n in serving),
          f"a serving kernel never launched: {launches}")
    check(all(c == 0 for n, c in launches.items() if n not in serving),
          f"a training kernel launched while serving: {launches}")
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


# -- phase 5: training kernels ------------------------------------------------

def phase_layer_norm_bwd(dev, rows: int = 16384, n: int = 768):
    """LayerNorm backward at the training shape: (16384, 768) fp32 x and
    dy with bf16 (O2) and fp32 affine, a row count that is no multiple of
    the kernel's 16-row block, bf16 x, and no affine (the port of
    ``_ln_bwd_dx_kernel``: the same kernel without a weight).  dx within
    1e-5 of max|dx|
    (fp32) or 1 bf16 ulp; dgamma/dbeta within 1e-5 of their largest
    magnitude (16384-row fp32 sums in two orders), plus 1 bf16 ulp for
    bf16 weights.  Planted fault: the last row block dropped from
    dgamma."""
    gen = torch.Generator(device=dev).manual_seed(6)
    rpb = 16  # rows of one backward block (apex_ln_bwd_rows_per_block)
    cases = []
    for r, x_dt, w_dt in ((rows, torch.float32, torch.bfloat16),
                          (rows, torch.float32, torch.float32),
                          (rows - 3, torch.float32, torch.bfloat16),
                          (rows, torch.bfloat16, torch.bfloat16),
                          (rows, torch.float32, None)):
        x = (2 * torch.randn(r, n, device=dev, generator=gen)
             + 0.5).to(x_dt)
        dy = torch.randn(r, n, device=dev, generator=gen).to(x_dt)
        w = None if w_dt is None else (
            1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(w_dt)
        got = layer_norm_bwd(x, w, dy)
        want = layer_norm_bwd_ref(x, w, dy)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(got, want) if b is not None]
        errs = [_err(a, b) for a, b in pairs]
        check(_close(got[0], want[0], 1e-5, ulps=1),
              f"layer_norm_bwd dx rows={r} {x_dt}: {errs[0]}")
        faults = {}
        if w is not None:
            for name, a, b in (("dgamma", got[1], want[1]),
                               ("dbeta", got[2], want[2])):
                check(_close(a, b, 1e-5, ulps=1),
                      f"layer_norm_bwd {name} rows={r} {w_dt}: {_err(a, b)}")
            last = r % rpb or rpb
            bad = layer_norm_bwd(x[:r - last], w, dy[:r - last])[1]
            faults["last_row_block_dropped"] = _err(bad, want[1])
            check(not _close(bad, want[1], 1e-5, ulps=1),
                  f"layer_norm_bwd rows={r}: the check misses the last row "
                  f"block dropped from dgamma ({faults})")
        kern = timings(lambda: layer_norm_bwd(x, w, dy))
        plain = timings(lambda: layer_norm_bwd_ref(x, w, dy), iters=20)
        wl = torch.ones(n, device=dev, dtype=x_dt) if w is None \
            else w.to(x_dt)
        bl = torch.zeros(n, device=dev, dtype=x_dt)
        _, mean, rstd = torch.native_layer_norm(x, [n], wl, bl, 1e-5)
        mask = [True, w is not None, w is not None]
        lib = timings(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [n], mean, rstd, wl, bl, mask))
        w_bytes = 0 if w is None else 3 * n * w.element_size()
        bound, by = _bound(3 * x.numel() * x.element_size() + w_bytes,
                           {FP32_FLOPS: 12 * x.numel()})
        case = {"rows": r, "n": n, "x_dtype": _dt(x_dt),
                "w_dtype": _dt(w_dt) if w is not None else "none",
                "max_abs_err": max(errs), "errs_dx_dgamma_dbeta": errs,
                "tol": "1e-5 of max|want| (+1 bf16 ulp for bf16)",
                "planted_fault_errs": faults,
                **_merge(kern, plain, lib), "bound_ms": bound,
                "bound_by": by}
        emit({"phase": "kernel", "kernel": "layer_norm_bwd", **case})
        cases.append(case)
    return cases


def _strict_causal_bias(s: int, dev):
    """The planted fault 'causal mask one key short': key j visible to
    query i iff j < i (row 0 sees none: all -1e30, a uniform softmax)."""
    i = torch.arange(s, device=dev)
    return torch.where(i[None, :] < i[:, None], 0.0, -1e30)


def _flash_bound(bh: int, s: int, d: int, dt, backward: bool):
    """Visible (causal) query-key pairs; QK^T (and dO.V^T) at the rate
    of the inputs' type, the fp32 products (p.V; pd^T.dO, ds^T.Q, ds.K)
    at the fp32 rate; q, k, v, o (+ do, dq, dk, dv) and lse (+ delta)
    moved once."""
    pairs = bh * s * (s + 1) // 2
    el = torch.tensor([], dtype=dt).element_size()
    rate = BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS
    if backward:
        nbytes = 8 * bh * s * d * el + 2 * bh * s * 4
        ops = {rate: 2 * 2 * pairs * d}
        ops[FP32_FLOPS] = ops.get(FP32_FLOPS, 0) + 3 * 2 * pairs * d
    else:
        nbytes = 4 * bh * s * d * el + bh * s * 4
        ops = {rate: 2 * pairs * d}
        ops[FP32_FLOPS] = ops.get(FP32_FLOPS, 0) + 2 * pairs * d
    return _bound(nbytes, ops)


def phase_flash(dev, b: int = 16, h: int = 12, s: int = 1024,
                d: int = 64):
    """Flash attention at the training shape (B 16, H 12, S 1024, D 64,
    causal), bf16 and fp32, dropout 0 and 0.1; q ~ 2 N(0, 1), k, v, dO
    ~ N(0, 1), a peaked softmax with outputs of order 1.  Forward O and
    backward dQ/dK/dV within 1e-5 (fp32) of max|want| or 2 bf16 ulps
    plus 1e-4 of it (bf16: one rounding on each side, fp32 sums of up to
    1024 terms in two orders); lse within 1e-5 of max|lse|.  Planted
    faults: the causal mask one key short (the plain version with that
    mask) and the dropout mask shifted by one column (the kernel with
    the seed's column offset 1)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bh = b * h
    cases = []
    for dt, rate in ((torch.bfloat16, 0.1), (torch.bfloat16, 0.0),
                     (torch.float32, 0.0), (torch.float32, 0.1)):
        q = (2 * torch.randn(bh, s, d, device=dev, generator=gen)).to(dt)
        k = torch.randn(bh, s, d, device=dev, generator=gen).to(dt)
        v = torch.randn(bh, s, d, device=dev, generator=gen).to(dt)
        do = torch.randn(bh, s, d, device=dev, generator=gen).to(dt)
        seed_int = 123456789
        seed = _pack_seed(seed_int, device=dev)
        args = (seed, d ** -0.5, True, rate, (h, h))
        rtol_f, rtol_b = (1e-5, 1e-5) if dt == torch.float32 else (1e-4, 1e-4)
        o, lse = flash_attention_fwd(q, k, v, *args)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args)
        grads = flash_attention_bwd(q, k, v, o, lse, do, *args)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        err_o, err_lse = _err(o, o_ref), _err(lse, lse_ref)
        errs_b = [_err(a, w) for a, w in zip(grads, want)]
        name = f"{_dt(dt)} dropout={rate}"
        check(_close(o, o_ref, rtol_f, ulps=2), f"flash fwd {name}: {err_o}")
        check(_close(lse, lse_ref, 1e-5), f"flash lse {name}: {err_lse}")
        for gname, a, w, e in zip(("dq", "dk", "dv"), grads, want, errs_b):
            check(_close(a, w, rtol_b, ulps=2), f"flash {gname} {name}: {e}")
        # planted faults
        q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
        bias = _strict_causal_bias(s, dev).expand(b, s, s)
        faults = {}
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        bad = attention_ref(qg, kg, vg, bias=bias, causal=False,
                            dropout_rate=rate, dropout_seed=seed_int)
        bad_g = torch.autograd.grad(bad, (qg, kg, vg), do.reshape(b, h, s, d))
        bad = bad.detach().reshape(bh, s, d)
        faults["causal_one_key_short_fwd"] = _err(bad, o_ref)
        check(not _close(bad, o_ref, rtol_f, ulps=2),
              f"flash {name}: the check misses the causal mask one key short")
        faults["causal_one_key_short_bwd"] = _err(bad_g[0].reshape(bh, s, d),
                                                  want[0])
        check(not all(_close(a.reshape(bh, s, d), w, rtol_b, ulps=2)
                      for a, w in zip(bad_g, want)),
              f"flash {name}: the check misses the causal mask one key "
              f"short in the backward")
        del bad, bad_g, qg, kg, vg
        if rate > 0:
            shifted = (_pack_seed(seed_int, 0, 1, 0, device=dev),) + args[1:]
            bad_o, _ = flash_attention_fwd(q, k, v, *shifted)
            bad_g = flash_attention_bwd(q, k, v, o, lse, do, *shifted)
            torch.cuda.synchronize()
            faults["dropout_shifted_one_col_fwd"] = _err(bad_o, o_ref)
            faults["dropout_shifted_one_col_bwd"] = _err(bad_g[0], want[0])
            check(not _close(bad_o, o_ref, rtol_f, ulps=2),
                  f"flash {name}: the check misses the shifted dropout mask")
            check(not all(_close(a, w, rtol_b, ulps=2)
                          for a, w in zip(bad_g, want)),
                  f"flash {name}: the check misses the shifted dropout mask "
                  f"in the backward")
            del bad_o, bad_g
        kern_f = timings(lambda: flash_attention_fwd(q, k, v, *args), iters=20)
        plain_f = timings(lambda: flash_attention_fwd_ref(q, k, v, *args),
                          iters=5)
        kern_b = timings(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                     *args), iters=10)
        plain_b = timings(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                          *args), iters=3)
        lib_f = timings(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), iters=20)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        do4 = do.reshape(b, h, s, d)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        lib_fb = timings(sdpa_fwd_bwd, iters=10)
        base = {"case": name, "B": b, "H": h, "S": s, "D": d,
                "dtype": _dt(dt), "dropout": rate,
                "planted_fault_errs": faults}
        bound, by = _flash_bound(bh, s, d, dt, backward=False)
        fwd = {**base, "max_abs_err": max(err_o, err_lse),
               "errs_o_lse": [err_o, err_lse],
               "tol": f"{rtol_f} of max|want|" + (" + 2 bf16 ulps"
                                                  if dt == torch.bfloat16
                                                  else ""),
               **_merge(kern_f, plain_f, lib_f), "bound_ms": bound,
               "bound_by": by,
               "library": "F.scaled_dot_product_attention(is_causal=True), "
                          "no dropout"}
        emit({"phase": "kernel", "kernel": "flash_attention_fwd", **fwd})
        bound, by = _flash_bound(bh, s, d, dt, backward=True)
        bwd = {**base, "max_abs_err": max(errs_b), "errs_dq_dk_dv": errs_b,
               "tol": fwd["tol"], **_merge(kern_b, plain_b, lib_fb),
               "bound_ms": bound, "bound_by": by,
               "library": "F.scaled_dot_product_attention forward + "
                          "backward, no dropout"}
        emit({"phase": "kernel", "kernel": "flash_attention_bwd", **bwd})
        cases.append((fwd, bwd))
        del q, k, v, do, o, lse, o_ref, lse_ref, grads, want, qg, kg, vg
        torch.cuda.empty_cache()
    return cases


def phase_flash_shapes(dev, h: int = 12, d: int = 64):
    """Flash attention off the main path's shape, checked but not timed:
    a sequence that is no multiple of the 64-row tile (S 1000, causal,
    bf16, dropout 0.1), different query and key lengths without the
    causal mask (300 x 450, fp32, dropout 0.1), and more queries than
    keys with it (450 x 300, bf16).  Tolerances as in
    :func:`phase_flash`; with dropout, the mask shifted by one column
    must be rejected."""
    gen = torch.Generator(device=dev).manual_seed(12)
    for b, sq, sk, causal, dt, rate in (
            (2, 1000, 1000, True, torch.bfloat16, 0.1),
            (2, 300, 450, False, torch.float32, 0.1),
            (2, 450, 300, True, torch.bfloat16, 0.0)):
        bh = b * h
        q = (2 * torch.randn(bh, sq, d, device=dev, generator=gen)).to(dt)
        k = torch.randn(bh, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(bh, sk, d, device=dev, generator=gen).to(dt)
        do = torch.randn(bh, sq, d, device=dev, generator=gen).to(dt)
        args = (_pack_seed(987654321, device=dev), d ** -0.5, causal, rate,
                (h, h))
        rtol = 1e-5 if dt == torch.float32 else 1e-4
        o, lse = flash_attention_fwd(q, k, v, *args)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args)
        grads = flash_attention_bwd(q, k, v, o, lse, do, *args)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        name = (f"B={b} H={h} Sq={sq} Sk={sk} causal={causal} {_dt(dt)} "
                f"dropout={rate}")
        errs = [_err(o, o_ref), _err(lse, lse_ref)] + [
            _err(a, w) for a, w in zip(grads, want)]
        check(_close(o, o_ref, rtol, ulps=2) and _close(lse, lse_ref, 1e-5),
              f"flash fwd {name}: {errs[:2]}")
        check(all(_close(a, w, rtol, ulps=2) for a, w in zip(grads, want)),
              f"flash bwd {name}: {errs[2:]}")
        faults = {}
        if rate > 0:
            shifted = (_pack_seed(987654321, 0, 1, 0, device=dev),) + args[1:]
            bad_o, _ = flash_attention_fwd(q, k, v, *shifted)
            torch.cuda.synchronize()
            faults["dropout_shifted_one_col_fwd"] = _err(bad_o, o_ref)
            check(not _close(bad_o, o_ref, rtol, ulps=2),
                  f"flash {name}: the check misses the shifted dropout mask")
        emit({"phase": "kernel_check", "kernel": "flash_attention",
              "case": name, "errs_o_lse_dq_dk_dv": errs,
              "tol": f"{rtol} of max|want|" + (" + 2 bf16 ulps"
                                               if dt == torch.bfloat16
                                               else ""),
              "planted_fault_errs": faults})


def phase_xent(dev, rows: int = 16384, v: int = 50304):
    """Fused cross-entropy at the training shape (16384 x 50304 bf16
    logits), a ragged vocab (50257, rows not 16-byte aligned), label
    smoothing, a row count that is no multiple of any tile, and fp32
    logits; logits ~ 3 N(0, 1).  Loss and lse within 2e-6 of max|want|
    (fp32 sums of 50k exponentials in two orders); dlogits within 1 bf16
    ulp plus 1e-9 (bf16) or 1e-5 of max|want| (fp32).  Planted fault: the
    reference's last ragged vocab tile (past the last multiple of 2048)
    dropped from the lse (the kernel on that narrower view)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = []
    ragged = v - 47  # 50257: GPT-2's own vocabulary
    for r, vv, dt, sm in ((rows, v, torch.bfloat16, 0.0),
                          (rows, ragged, torch.bfloat16, 0.1),
                          (rows // 4 + 1, ragged, torch.bfloat16, 0.0),
                          (rows, v, torch.float32, 0.1)):
        logits = (3 * torch.randn(r, vv, device=dev, generator=gen)).to(dt)
        labels = torch.randint(0, vv, (r,), device=dev, generator=gen)
        g = torch.rand(r, device=dev, generator=gen)
        loss, lse = softmax_cross_entropy_fwd(logits, labels, sm)
        want_l, want_lse = softmax_cross_entropy_fwd_ref(logits, labels, sm)
        d = softmax_cross_entropy_bwd(logits, labels, lse, g, sm)
        want_d = softmax_cross_entropy_bwd_ref(logits, labels, lse, g, sm)
        torch.cuda.synchronize()
        errs = [_err(loss, want_l), _err(lse, want_lse), _err(d, want_d)]
        name = f"rows={r} V={vv} {_dt(dt)} smoothing={sm}"
        check(_close(loss, want_l, 2e-6), f"xent loss {name}: {errs[0]}")
        check(_close(lse, want_lse, 2e-6), f"xent lse {name}: {errs[1]}")
        d_ok = (bf16_ulp_ok(d, want_d, ulps=1, floor=1e-9)
                if dt == torch.bfloat16 else _close(d, want_d, 1e-5))
        check(d_ok, f"xent dlogits {name}: {errs[2]}")
        v_short = ((vv - 1) // 2048) * 2048
        bad_l, _ = softmax_cross_entropy_fwd(logits[:, :v_short],
                                             labels.clamp_max(v_short - 1), sm)
        torch.cuda.synchronize()
        fault = _err(bad_l, want_l)
        check(not _close(bad_l, want_l, 2e-6),
              f"xent {name}: the check misses the last vocab tile dropped")
        del bad_l
        kern_f = timings(lambda: softmax_cross_entropy_fwd(logits, labels, sm),
                         iters=20)
        plain_f = timings(lambda: softmax_cross_entropy_fwd_ref(logits, labels,
                                                                sm), iters=5)
        lib_f = timings(lambda: F.cross_entropy(
            logits, labels, reduction="none", label_smoothing=sm), iters=20)
        kern_b = timings(lambda: softmax_cross_entropy_bwd(logits, labels, lse,
                                                           g, sm), iters=20)
        plain_b = timings(lambda: softmax_cross_entropy_bwd_ref(
            logits, labels, lse, g, sm), iters=3)
        lg = logits.detach().requires_grad_()

        def ce_fwd_bwd():
            out = F.cross_entropy(lg, labels, reduction="none",
                                  label_smoothing=sm)
            torch.autograd.grad(out, lg, g)

        lib_fb = timings(ce_fwd_bwd, iters=10)
        el = logits.element_size()
        base = {"case": name, "rows": r, "V": vv, "dtype": _dt(dt),
                "smoothing": sm,
                "planted_fault_errs": {"last_vocab_tile_dropped": fault}}
        bound, by = _bound(r * vv * el + r * 16, {FP32_FLOPS: 4 * r * vv})
        fwd = {**base, "max_abs_err": max(errs[:2]),
               "errs_loss_lse": errs[:2], "tol": "2e-6 of max|want|",
               **_merge(kern_f, plain_f, lib_f), "bound_ms": bound,
               "bound_by": by,
               "library": "F.cross_entropy(reduction='none')"}
        emit({"phase": "kernel", "kernel": "softmax_xentropy_fwd", **fwd})
        bound, by = _bound(2 * r * vv * el + r * 16, {FP32_FLOPS: 4 * r * vv})
        bwd = {**base, "max_abs_err": errs[2],
               "tol": "1 bf16 ulp + 1e-9" if dt == torch.bfloat16
               else "1e-5 of max|want|",
               **_merge(kern_b, plain_b, lib_fb), "bound_ms": bound,
               "bound_by": by,
               "library": "F.cross_entropy forward + backward"}
        emit({"phase": "kernel", "kernel": "softmax_xentropy_bwd", **bwd})
        cases.append((fwd, bwd))
        del logits, labels, g, loss, lse, want_l, want_lse, d, want_d, lg
        torch.cuda.empty_cache()
    return cases


# -- phase 6: train parity ---------------------------------------------------

def phase_train_parity(params, b: int = 2, s: int = 256):
    """GPT-2 small at fp32 (O0, TF32 off, no dropout): the loss within
    1e-4 and the named gradients within 1e-3 relative L2 error, card
    against the port on the CPU, with the same weights and tokens."""
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    rng = torch.Generator().manual_seed(9)
    ids = torch.randint(0, 50257, (b, s), generator=rng)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100)], dim=1)
    names = ("wte.weight", "layers.0.qkv.kernel", "layers.11.ffn_out.kernel",
             "ln_f.weight")
    out = {}
    for where in ("cuda", "cpu"):
        model = GPTLM(cfg)
        model.load_state_dict(params)
        model.to(where)
        _, loss = model(ids.to(where), labels.to(where))
        ps = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, [ps[n] for n in names])
        out[where] = (float(loss.detach()), [g.cpu() for g in gs])
        del model, ps, gs
    rel = {n: float((a - c).norm() / c.norm())
           for n, a, c in zip(names, out["cuda"][1], out["cpu"][1])}
    err = abs(out["cuda"][0] - out["cpu"][0])
    emit({"phase": "train_parity", "model": "GPT-2 small fp32 O0",
          "batch": [b, s], "loss_cuda": out["cuda"][0],
          "loss_cpu": out["cpu"][0], "loss_abs_err": err,
          "grad_rel_l2": rel})
    check(err <= 1e-4, f"train parity: losses differ by {err}")
    check(all(r <= 1e-3 for r in rel.values()),
          f"train parity: gradients differ {rel}")


# -- phase 7: train ------------------------------------------------------------

def _train_setup(dev, params, b, s):
    amp_ = amp.initialize("O2")
    cfg = GPTConfig.small(compute_dtype=amp_.policy.compute_dtype)
    model = GPTLM(cfg)
    model.load_state_dict(params)
    model.to(dev)
    opt = amp.AmpOptimizer(fused_adam(6e-4, weight_decay=0.1), amp_)
    masters = opt.attach(model)
    state = opt.init(masters)
    data = torch.Generator(device=dev).manual_seed(10)
    ids = torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=data)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100, device=dev)],
                       dim=1)
    gen = torch.Generator(device=dev).manual_seed(11)
    names, ps = zip(*model.named_parameters())
    plant = {"inf": False}

    def step(carry, _batch):
        masters, state = carry
        _, loss = model(ids, labels, deterministic=False, generator=gen)
        grads = dict(zip(names, torch.autograd.grad(
            amp_.scale_loss(loss, state.scaler[0]), ps)))
        if plant["inf"]:
            g = grads["ln_f.weight"].clone()
            g[0] = float("inf")
            grads["ln_f.weight"] = g
        masters, state, stats = opt.step(grads, state, masters, model=model)
        return (masters, state), {"loss": loss.detach(),
                                  "loss_scale": stats.loss_scale,
                                  "skipped": stats.found_inf.float()}

    return cfg, step, (masters, state), plant


def phase_train(dev, params, b: int = 16, s: int = 1024, k: int = 10,
                timed: int = 3):
    """O2 training of GPT-2 small at batch 16 x 1024 with dropout 0.1
    (embedding, residual and attention), fused_adam(6e-4, weight decay
    0.1), FusedTrainDriver at K = 10: one warm window, then ``timed``
    windows, the first of them with the launch counts set to 0 before it
    and read after it.  Then one step with an inf planted in a gradient,
    which must be skipped."""
    cfg, step, carry, plant = _train_setup(dev, params, b, s)
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics={"loss": "last", "loss_scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry, res = driver.run_window(carry)
    warm = read_metrics(res)
    warm_s = time.perf_counter() - t0
    walls, windows, counted = [], [], None
    for i in range(timed):
        torch.cuda.synchronize()
        if i == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry)
        host = read_metrics(res)  # the window's one host read
        walls.append(time.perf_counter() - t0)
        windows.append(host)
        if i == 0:
            counted = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    layers = cfg.num_layers
    per_step = {"layer_norm": 2 * layers + 1, "layer_norm_bwd": 2 * layers + 1,
                "flash_attention_fwd": layers, "flash_attention_bwd": layers,
                "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1,
                "paged_fused_attention": 0}
    first, last = warm.per_step["loss"][0], windows[-1].metrics["loss"]
    emit({"phase": "train", "model": "GPT-2 small O2 (bf16 model, fp32 "
          "masters, dynamic loss scale), dropout 0.1, fused_adam(6e-4, "
          "wd 0.1)", "batch": [b, s], "steps_per_window": k,
          "warm_window_s": warm_s, "window_walls_s": walls,
          "median_window_s": med, "tokens_per_s": b * s * k / med,
          "loss_first_step": first, "loss_last_window": last,
          "losses_per_step": warm.per_step["loss"]
          + sum((w.per_step["loss"] for w in windows), []),
          "loss_scale": windows[-1].metrics["loss_scale"],
          "skipped_steps": warm.metrics["skipped"]
          + sum(w.metrics["skipped"] for w in windows),
          "max_memory_allocated_bytes": peak,
          "launches_one_window": counted,
          "launches_per_step_expected": per_step})
    losses = warm.per_step["loss"] + sum((w.per_step["loss"]
                                          for w in windows), [])
    check(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    check(last < first, f"train: loss did not fall ({first} -> {last})")
    check(counted == {n: k * c for n, c in per_step.items()},
          f"train: launch counts {counted} != K x {per_step}")
    # a planted overflow: masters, moments and step count unchanged, the
    # scale halved, the clean-step count reset
    masters, state = carry
    before = {n: t.clone() for n, t in masters.items()}
    m_before = {n: t.clone() for n, t in state.opt_state.m.items()}
    v_before = {n: t.clone() for n, t in state.opt_state.v.items()}
    step_before = int(state.opt_state.step)
    scale_before = float(state.scaler[0].loss_scale)
    plant["inf"] = True
    carry, m = step(carry, None)
    plant["inf"] = False
    masters, state = carry
    torch.cuda.synchronize()
    same = (all(torch.equal(masters[n], before[n]) for n in before)
            and all(torch.equal(state.opt_state.m[n], m_before[n])
                    for n in m_before)
            and all(torch.equal(state.opt_state.v[n], v_before[n])
                    for n in v_before)
            and int(state.opt_state.step) == step_before)
    scaler = state.scaler[0]
    emit({"phase": "train_overflow", "skipped": bool(m["skipped"]),
          "state_unchanged": same, "scale_before": scale_before,
          "scale_after": float(scaler.loss_scale),
          "unskipped_after": int(scaler.unskipped),
          "overflows": int(scaler.overflows)})
    check(bool(m["skipped"]) and same, "train: the overflow step was not "
          "skipped cleanly")
    check(float(scaler.loss_scale) == scale_before / 2
          and int(scaler.unskipped) == 0,
          "train: the overflow did not halve the scale and reset unskipped")
    return counted, step, carry


def phase_train_profile(step, carry):
    """Where one O2 training step's time goes: wall time, device-busy
    share and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    carry, _ = step(carry, None)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = step(carry, None)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = step(carry, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in _kernel_events(prof):
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "train_profile", "what": "one O2 step, GPT-2 small, "
          "batch 16 x 1024, dropout 0.1",
          "wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else None,
          "device_busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
          "device_busy_share_unprofiled":
              busy_ms / plain_wall_ms if busy_ms > 0 else None,
          "top_kernels": [{"name": k[:90], "device_ms": ms, "calls": n}
                          for k, ms, n in rows[:12]]})


class _Tee:
    """stdout that also writes to a log file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="also write every output line to this "
                    "file (the output can be longer than a terminal keeps)")
    args = ap.parse_args(argv)
    if args.log is None:
        return _run()
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    stdout = sys.stdout
    with open(args.log, "w") as fh:
        sys.stdout = _Tee(stdout, fh)
        try:
            return _run()
        finally:
            sys.stdout = stdout


def _run() -> int:
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
    del dec
    torch.cuda.empty_cache()

    lnb_cases = phase_layer_norm_bwd(dev)
    fl_cases = phase_flash(dev)
    phase_flash_shapes(dev)
    xe_cases = phase_xent(dev)
    phase_train_parity(params)
    train_launches, step, carry = phase_train(dev, params)
    phase_train_profile(step, carry)

    # the summary rows: the serving kernels at the engine's decode-step
    # shape with the engine run's launches, the training kernels at the
    # O2 training shapes with one training window's launches
    ln = next(c for c in ln_cases if c["rows"] == 8 and c["dtype"] == "float32")
    pa = next(c for c in pa_cases if c["case"] == "T=1 pool=bfloat16 "
              "masked=False")
    lnb = next(c for c in lnb_cases if c["rows"] == 16384
               and c["x_dtype"] == "float32" and c["w_dtype"] == "bfloat16")
    fl_f, fl_b = next(c for c in fl_cases
                      if c[0]["case"] == "bfloat16 dropout=0.1")
    xe_f, xe_b = next(c for c in xe_cases
                      if c[0]["case"] == "rows=16384 V=50304 bfloat16 "
                      "smoothing=0.0")
    rows = []
    for name, src, tpu, c, count in (
            ("layer_norm", "apex_tpu_torch/csrc/layer_norm.cu",
             "apex_tpu/ops/layer_norm.py:133", ln, launches),
            ("paged_fused_attention", "apex_tpu_torch/csrc/paged_attention.cu",
             "apex_tpu/ops/attention.py:415", pa, launches),
            ("layer_norm_bwd", "apex_tpu_torch/csrc/layer_norm.cu",
             "apex_tpu/ops/layer_norm.py:169", lnb, train_launches),
            ("flash_attention_fwd", "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:1027", fl_f, train_launches),
            ("flash_attention_bwd", "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:868", fl_b, train_launches),
            ("softmax_xentropy_fwd", "apex_tpu_torch/csrc/softmax_xentropy.cu",
             "apex_tpu/ops/softmax_xentropy.py:79", xe_f, train_launches),
            ("softmax_xentropy_bwd", "apex_tpu_torch/csrc/softmax_xentropy.cu",
             "apex_tpu/ops/softmax_xentropy.py:139", xe_b, train_launches)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": count[name],
                     "max_abs_err": c["max_abs_err"], "tol": c["tol"],
                     "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"],
                     "case": c.get("case") or f"rows={c['rows']} n={c['n']} "
                     f"{c.get('dtype') or c['x_dtype']}/{c['w_dtype']}"})
    # LayerNorm forward is on both paths: its row also carries the training
    # shape's case (O2's bf16 affine) and one training window's launches
    ln_train = next(c for c in ln_cases if c["rows"] == 16384
                    and c["w_dtype"] == "bfloat16")
    rows[0]["train_path"] = {
        "launches": train_launches["layer_norm"],
        "case": "rows=16384 n=768 float32/bfloat16",
        **{k: ln_train[k] for k in ("max_abs_err", "tol", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}}
    check(all(r["launches"] > 0 for r in rows)
          and rows[0]["train_path"]["launches"] > 0,
          f"a kernel never launched on its path: {rows}")
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
