"""apex_tpu_torch paged serving vs the JAX package, on the CPU.

- The port's ``ServeEngine`` streams the SAME greedy tokens as the JAX
  ``ServeEngine`` and as the JAX per-token full-recompute
  ``reference_generate`` at ``GPTConfig.tiny`` fp32 (weights carried
  across with ``from_jax_params``): a mixed queue longer than the slots
  with multi-chunk prefill, a duplicate prompt sharing physical pages, a
  mid-page divergence (copy-on-write), a pool small enough to preempt,
  chunked prefill interleaved with decode, and capacity truncation
  (mirroring tests/test_paged_kv.py).
- ``PagePool``/``SlotAllocator`` host bookkeeping.
- Entry points raise without CUDA unless a device is given; on CPU
  tensors the kernel wrappers take their plain versions and count no
  launch.
- The port's files import no ``jax``, ``flax`` or ``apex_tpu``.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.serve import GPTDecoder as JaxDecoder
from apex_tpu.serve import ServeEngine as JaxEngine
from apex_tpu.serve import reference_generate
from apex_tpu_torch import ops
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.ops._common import resolve_device, use_kernel
from apex_tpu_torch.serve import (
    GPTDecoder,
    PagePool,
    ServeEngine,
    SlotAllocator,
    auto_page_len,
    init_paged_cache,
    sample_tokens,
)
from apex_tpu_torch.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lm():
    """(jax cfg, flax params, token pool, cached reference_generate)."""
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 32))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    memo = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = reference_generate(cfg, params, prompt, n)
        return memo[key]

    return cfg, params, ids[0], ref


@pytest.fixture(scope="module")
def dec4(lm):
    """The port's K=4 fp32 decoder on the CPU."""
    _, params, _, _ = lm
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                      tokens_per_dispatch=4, device="cpu")


def paged_engine(dec, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("page_len", 8)
    kw.setdefault("prefill_chunk", 8)
    return ServeEngine(dec, **kw)


def _prompts(pool, specs):
    return [[int(t) for t in pool[s:s + n]] for s, n in specs]


class TestEngineParity:
    def test_mixed_queue_matches_jax_engine_and_reference(self, lm, dec4):
        cfg, params, pool, ref = lm
        prompts = _prompts(pool, [(0, 3), (2, 19), (5, 5), (1, 12), (7, 4)])
        budgets = [6, 9, 4, 7, 11]
        eng = paged_engine(dec4)
        uids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        out = eng.run()
        got = [out[u] for u in uids]
        jeng = JaxEngine(JaxDecoder(cfg, params, tokens_per_dispatch=4),
                         slots=2, max_len=64, paged=True, page_len=8,
                         prefill_chunk=8)
        juids = [jeng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, budgets)]
        jout = jeng.run()
        assert got == [jout[u] for u in juids]
        assert got == [ref(p, n) for p, n in zip(prompts, budgets)]
        s = eng.stats()
        assert s["prefill_dispatches"] > len(prompts)  # multi-chunk prefill
        assert s["pages_in_use"] == 0 and s["requests_done"] == 5

    def test_duplicate_prompt_shares_physical_pages(self, lm, dec4):
        _, _, pool, ref = lm
        a = [int(t) for t in pool[:11]]  # pages 8|3 at page_len 8
        eng = paged_engine(dec4, slots=3)
        ua = eng.submit(a, max_new_tokens=30)
        for _ in range(2):
            eng.step()
        a_pages = eng.pool.slot_pages(0)
        pre = eng.prefill_dispatches
        ub = eng.submit(list(a), max_new_tokens=6)
        eng.step()
        slot_b = next(s for s, r in eng._active.items() if r.uid == ub)
        assert eng.pool.tables[slot_b][0] == a_pages[0]  # shared full page
        assert eng.pool.tables[slot_b][1] != a_pages[1]  # tail was COWed
        assert eng.stats()["prefix_hit_tokens"] == len(a)
        assert eng.stats()["cow_copies"] >= 1
        assert eng.prefill_dispatches == pre + 1  # one 1-token resample
        out = eng.run()
        assert out[ua] == ref(a, 30)
        assert out[ub] == ref(a, 30)[:6]

    def test_mid_page_divergence_cow(self, lm, dec4):
        _, _, pool, ref = lm
        a = [int(t) for t in pool[:11]]
        b = a + [int(pool[20]), int(pool[21])]
        eng = paged_engine(dec4, slots=3)
        ua = eng.submit(a, max_new_tokens=30)
        for _ in range(2):
            eng.step()
        cow0 = eng.stats()["cow_copies"]
        ub = eng.submit(b, max_new_tokens=6)
        out = eng.run()
        assert eng.stats()["prefix_hit_tokens"] == len(a)
        assert eng.stats()["cow_copies"] > cow0
        assert out[ua] == ref(a, 30)
        assert out[ub] == ref(b, 6)

    def test_pool_exhaustion_preempts_and_recovers(self, lm, dec4):
        cfg, params, pool, ref = lm
        p1 = [int(t) for t in pool[:6]]
        p2 = [int(t) for t in pool[10:17]]
        eng = ServeEngine(dec4, slots=2, max_len=32, page_len=8,
                          num_pages=6, prefill_chunk=8)
        u1 = eng.submit(p1, max_new_tokens=20)
        u2 = eng.submit(p2, max_new_tokens=20)
        out = eng.run()
        assert eng.stats()["preemptions"] >= 1
        jeng = JaxEngine(JaxDecoder(cfg, params, tokens_per_dispatch=4),
                         slots=2, max_len=32, paged=True, page_len=8,
                         num_pages=6, prefill_chunk=8)
        j1 = jeng.submit(p1, max_new_tokens=20)
        j2 = jeng.submit(p2, max_new_tokens=20)
        jout = jeng.run()
        assert jeng.stats()["preemptions"] == eng.stats()["preemptions"]
        assert out[u1] == jout[j1] == ref(p1, 20)
        assert out[u2] == jout[j2] == ref(p2, 20)

    def test_chunked_prefill_interleaves_with_decode(self, lm, dec4):
        _, _, pool, ref = lm
        short = [int(t) for t in pool[:4]]
        long_p = [int(t) for t in pool[:28]]  # 4 chunks at chunk=8
        eng = paged_engine(dec4)
        us = eng.submit(short, max_new_tokens=24)
        eng.step()
        ul = eng.submit(long_p, max_new_tokens=6)
        interleaved = 0
        while eng._prefilling or eng._queue:
            before = eng.decode_dispatches
            eng.step()
            if eng._prefilling and eng.decode_dispatches > before:
                interleaved += 1
        assert interleaved >= 2
        out = eng.run()
        assert out[us] == ref(short, 24)
        assert out[ul] == ref(long_p, 6)

    def test_capacity_truncation(self, lm, dec4):
        _, _, pool, ref = lm
        prompt = [int(t) for t in pool[:5]]
        eng = ServeEngine(dec4, slots=1, max_len=16, page_len=8,
                          prefill_chunk=8)
        uid = eng.submit(prompt, max_new_tokens=50)
        out = eng.run()
        assert eng.results[uid].truncated
        assert out[uid] == ref(prompt, 16 - 5 + 1)

    def test_sampled_requests_stay_in_vocab(self, lm, dec4):
        _, _, pool, _ = lm
        eng = paged_engine(dec4, seed=3)
        uids = [eng.submit([int(t) for t in pool[:6]], max_new_tokens=9,
                           temperature=0.8, top_k=20, top_p=0.9),
                eng.submit([int(t) for t in pool[3:8]], max_new_tokens=5)]
        out = eng.run()
        assert [len(out[u]) for u in uids] == [9, 5]
        assert all(0 <= t < 1024 for u in uids for t in out[u])


class TestSampling:
    def test_filters_keep_the_documented_support(self):
        rng = np.random.RandomState(5)
        logits = torch.from_numpy(rng.randn(2, 40).astype(np.float32) * 3)
        gen = torch.Generator().manual_seed(0)
        t = np.asarray([1.0, 0.7], np.float32)
        k = np.asarray([6, 0], np.int32)
        p = np.asarray([1.0, 0.5], np.float32)
        mp = np.asarray([0.0, 0.05], np.float32)
        draws = np.stack([
            sample_tokens(logits, gen, t, top_k=k, top_p=p, min_p=mp).numpy()
            for _ in range(300)])
        for row in range(2):
            lt = logits[row].numpy() / t[row]
            order = np.argsort(-lt, kind="stable")
            srt = lt[order]
            kk = k[row] if k[row] > 0 else len(srt)
            pr = np.exp(srt[:kk] - srt[0])
            pr /= pr.sum()
            keep = (np.cumsum(pr) - pr < p[row]) | (p[row] >= 1.0)
            keep &= pr >= mp[row] * pr[0]
            support = set(order[:kk][keep].tolist())
            seen = set(draws[:, row].tolist())
            assert seen <= support and len(seen) >= min(2, len(support))

    def test_greedy_and_degenerate_filters_are_argmax(self):
        rng = np.random.RandomState(6)
        logits = torch.from_numpy(rng.randn(3, 50).astype(np.float32))
        best = logits.argmax(-1).to(torch.int32)
        gen = torch.Generator().manual_seed(1)
        assert torch.equal(sample_tokens(logits, gen, 0.0), best)
        for kw in ({"top_k": 1}, {"top_p": 1e-6}, {"min_p": 1.0}):
            assert torch.equal(sample_tokens(logits, gen, 1.0, **kw), best)


class TestPagePool:
    def test_alloc_refcount_release(self):
        pool = PagePool(num_pages=5, page_len=4, slots=2, pages_per_slot=4)
        assert pool.n_free == 4 and pool.in_use == 0  # page 0 reserved
        assert pool.ensure_writable(0, 0, 9) == []  # 3 fresh allocs
        assert pool.in_use == 3 and pool.peak_in_use == 3
        assert all(pool.tables[0][:3] > 0) and pool.tables[0][3] == 0
        pool.release_slot(0)
        assert pool.in_use == 0 and pool.n_free == 4
        assert not pool.tables[0].any()

    def test_exhaustion_returns_none(self):
        pool = PagePool(num_pages=3, page_len=4, slots=2, pages_per_slot=2)
        assert pool.ensure_writable(0, 0, 8) == []
        assert pool.ensure_writable(1, 0, 1) is None
        pool.release_slot(0)
        assert pool.ensure_writable(1, 0, 1) == []

    def test_too_small_pool_rejected(self):
        with pytest.raises(ValueError):
            PagePool(num_pages=4, page_len=4, slots=1, pages_per_slot=4)

    def test_share_cow_and_registry(self):
        pool = PagePool(num_pages=9, page_len=4, slots=2, pages_per_slot=4)
        prompt = list(range(100, 111))  # 11 tokens: pages 4|4|3
        assert pool.ensure_writable(0, 0, 11) == []
        pool.register(0, prompt)
        pages, n = pool.match_prefix(prompt)
        assert n == 11 and pages == pool.slot_pages(0)
        pages, n = pool.match_prefix(prompt[:8] + [999])
        assert n == 8 and len(pages) == 2
        pages, n = pool.match_prefix(prompt + [999])
        assert n == 11 and len(pages) == 3
        pool.share(1, pages, n)
        assert pool.ref[pages[2]] == 2
        copies = pool.ensure_writable(1, 11, 12)
        assert len(copies) == 1 and copies[0][0] == pages[2]
        assert pool.tables[1][2] == copies[0][1] != pages[2]
        assert pool.ref[pages[2]] == 1
        pool.release_slot(0)
        assert pool.match_prefix(prompt)[1] == 8
        pool.release_slot(1)
        assert pool.in_use == 0
        assert pool.match_prefix(prompt)[1] == 0

    def test_reserve_and_unreserve(self):
        pool = PagePool(num_pages=6, page_len=4, slots=1, pages_per_slot=2)
        held = pool.reserve(3)
        assert len(held) == 3 and pool.n_free == 2
        rest = pool.reserve(9)  # takes what is left, no more
        assert len(rest) == 2 and pool.n_free == 0
        assert pool.ensure_writable(0, 0, 1) is None  # pressure is real
        pool.release_slot(0)
        pool.unreserve(held + rest)
        assert pool.n_free == 5 and pool.in_use == 0

    def test_slot_allocator_and_auto_page_len(self):
        alloc = SlotAllocator(2)
        assert [alloc.allocate(), alloc.allocate(), alloc.allocate()] == [
            0, 1, None]
        alloc.free(0)
        with pytest.raises(ValueError):
            alloc.free(0)
        assert auto_page_len(64) == 16
        assert auto_page_len(12) == 4
        assert auto_page_len(7) == 1


class TestDevicesAndKernels:
    def test_entry_points_raise_without_cuda(self, lm, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = GPTConfig.tiny(compute_dtype=torch.float32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_paged_cache(cfg, 4, 1, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GPTDecoder(cfg, {})
        assert resolve_device("cpu") == torch.device("cpu")

    def test_cpu_run_takes_plain_paths_and_counts_no_launch(self, lm, dec4):
        _, _, pool, ref = lm
        ops.reset_launch_counts()
        eng = paged_engine(dec4)
        uid = eng.submit([int(t) for t in pool[:9]], max_new_tokens=5)
        out = eng.run()
        assert out[uid] == ref([int(t) for t in pool[:9]], 5)
        zeros = {name: 0 for name in ops.KERNELS}
        assert {"layer_norm", "paged_fused_attention"} <= set(zeros)
        assert eng.stats()["kernel_launches"] == zeros
        assert ops.launch_counts() == zeros

    def test_dispatch_rule(self):
        cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")
        assert use_kernel(cpu, None) is False
        with pytest.raises(ValueError):
            use_kernel(cpu, meta)
        with pytest.raises(ValueError):
            use_kernel(meta)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(REPO, "apex_tpu_torch")):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return out


def _banned(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "apex_tpu")


class TestImportHygiene:
    def test_no_jax_imports_in_the_port_sources(self):
        files = _port_files()
        assert len(files) > 10
        for path in files:
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                bad = [n for n in names if _banned(n)]
                assert not bad, (path, node.lineno, bad)

    def test_importing_the_port_loads_no_jax(self):
        code = (
            "import sys\n"
            "before = set(sys.modules)\n"
            "import apex_tpu_torch, apex_tpu_torch.ops._build, chip_smoke\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'apex_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
