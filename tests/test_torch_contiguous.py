"""apex_tpu_torch's contiguous KV-cache serving path vs the JAX package,
on the CPU at ``GPTConfig.tiny`` fp32 (weights carried across with
``from_jax_params``).

- ``KVCache``/``init_cache``: shapes, dtypes, the ``max_position`` and
  int8 checks, and ``cache_bytes_per_slot`` against JAX's.
- ``GPTDecoder.prefill``: logits and the written cache against JAX's.
- ``GPTDecoder.decode_window``: tokens, lengths and the token meter
  against JAX's, with an inactive slot.
- ``ServeEngine(paged=False)``: a mixed queue longer than the slots with
  backfill, equal to JAX's ``reference_generate`` and to the JAX engine
  with ``paged=False``; capacity truncation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.serve import GPTDecoder as JaxDecoder
from apex_tpu.serve import ServeEngine as JaxEngine
from apex_tpu.serve import cache_bytes_per_slot as jax_cache_bytes
from apex_tpu.serve import reference_generate
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.serve import (
    GPTDecoder,
    KVCache,
    ServeEngine,
    cache_bytes_per_slot,
    init_cache,
)
from apex_tpu_torch.weights import from_jax_params

SLOTS, MAX_LEN, K = 3, 64, 4


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


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
def decs(lm):
    """The port's and JAX's K=4 fp32 decoders (JAX's programs compiled
    once for the module)."""
    cfg, params, _, _ = lm
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return (GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                       tokens_per_dispatch=K, device="cpu"),
            JaxDecoder(cfg, params, tokens_per_dispatch=K))


def _prompts(pool, specs):
    return [[int(t) for t in pool[s:s + n]] for s, n in specs]


def _prefilled(decs, prompts):
    """The same padded prompt batch prefilled into slots 0.. of the
    port's cache and of JAX's; returns both caches and both logits."""
    dec, jdec = decs
    p = max(len(x) for x in prompts)
    ids = np.zeros((len(prompts), p), np.int32)
    for i, x in enumerate(prompts):
        ids[i, :len(x)] = x
    lens = np.asarray([len(x) for x in prompts], np.int32)
    slots = np.arange(len(prompts), dtype=np.int32)
    cache = dec.init_cache(SLOTS, MAX_LEN)
    logits = dec.prefill(cache, slots, ids, lens)
    jcache, jlogits = jdec.prefill(jdec.init_cache(SLOTS, MAX_LEN), slots,
                                   ids, lens)
    return cache, jcache, logits, np.asarray(jlogits)


class TestCache:
    def test_init_cache_shapes_and_checks(self):
        cfg = GPTConfig.tiny(compute_dtype=torch.float32)
        c = init_cache(cfg, 3, 40, device="cpu")
        assert isinstance(c, KVCache)
        assert tuple(c.k.shape) == (3, 2, 2, 40, 64) == tuple(c.v.shape)
        assert (c.slots, c.layers, c.heads, c.max_len, c.head_dim) == (
            3, 2, 2, 40, 64)
        assert c.k.dtype == torch.float32 and not c.k.any()
        assert c.lengths.dtype == torch.int32 and not c.lengths.any()
        assert c.decoded.dtype == torch.int64 and int(c.decoded) == 0
        assert init_cache(cfg, 1, 8, dtype=torch.bfloat16,
                          device="cpu").v.dtype == torch.bfloat16
        with pytest.raises(ValueError, match="max_position"):
            init_cache(cfg, 1, cfg.max_position + 1, device="cpu")
        with pytest.raises(ValueError, match="paged-only"):
            init_cache(cfg, 1, 8, dtype=torch.int8, device="cpu")

    @pytest.mark.parametrize("name", ["tiny", "small"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bytes_per_slot_match_jax(self, name, dtype):
        cfg = getattr(GPTConfig, name)(compute_dtype=getattr(torch, dtype))
        jcfg = getattr(JaxConfig, name)(compute_dtype=getattr(jnp, dtype))
        want = jax_cache_bytes(jcfg, 48)
        assert cache_bytes_per_slot(cfg, 48) == want
        if name == "tiny":
            assert init_cache(cfg, 2, 48,
                              device="cpu").bytes_per_slot == want


class TestDecoder:
    def test_prefill_matches_jax(self, lm, decs):
        _, _, pool, _ = lm
        prompts = _prompts(pool, [(0, 5), (3, 11)])
        cache, jcache, logits, jlogits = _prefilled(decs, prompts)
        np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4,
                                   rtol=0)
        assert cache.lengths.tolist() == [5, 11, 0]
        assert np.asarray(jcache.lengths).tolist() == [5, 11, 0]
        for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)

    def test_decode_window_matches_jax(self, lm, decs):
        dec, jdec = decs
        _, _, pool, _ = lm
        prompts = _prompts(pool, [(2, 7), (6, 4)])
        cache, jcache, logits, jlogits = _prefilled(decs, prompts)
        first = np.zeros((SLOTS,), np.int32)
        first[:2] = np.argmax(jlogits, -1)
        active = np.asarray([True, True, False])
        toks = dec.decode_window(cache, first, active)
        jcache, jtoks = jdec.decode_window(jcache, first, active,
                                           jax.random.PRNGKey(0))
        assert toks.shape == (K, SLOTS)
        assert toks[:, :2].tolist() == np.asarray(jtoks)[:, :2].tolist()
        assert cache.lengths.tolist() == np.asarray(jcache.lengths).tolist()
        assert cache.lengths.tolist() == [7 + K, 4 + K, 0]
        assert int(cache.decoded) == int(jcache.decoded) == 2 * K


class TestEngine:
    def test_mixed_queue_backfill_matches_jax_and_reference(self, lm, decs):
        dec, jdec = decs
        _, _, pool, ref = lm
        prompts = _prompts(pool, [(0, 3), (2, 9), (5, 5), (1, 12), (7, 4)])
        budgets = [6, 13, 4, 9, 11]
        eng = ServeEngine(dec, slots=2, max_len=MAX_LEN, paged=False)
        uids = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
        out = eng.run()
        got = [out[u] for u in uids]
        jeng = JaxEngine(jdec, slots=2, max_len=MAX_LEN, paged=False)
        juids = [jeng.submit(p, max_new_tokens=n)
                 for p, n in zip(prompts, budgets)]
        jout = jeng.run()
        assert got == [jout[u] for u in juids]
        assert got == [ref(p, n) for p, n in zip(prompts, budgets)]
        s, js = eng.stats(), jeng.stats()
        for key in ("decoded_tokens", "decode_dispatches",
                    "prefill_dispatches", "requests_done",
                    "cache_bytes_per_slot"):
            assert s[key] == js[key], key
        assert s["prefill_dispatches"] >= 3  # backfill admitted later
        assert "pages_in_use" not in s and not hasattr(eng, "pool")

    def test_capacity_truncation(self, lm, decs):
        dec, _ = decs
        _, _, pool, ref = lm
        prompt = [int(t) for t in pool[:5]]
        eng = ServeEngine(dec, slots=1, max_len=16, paged=False)
        uid = eng.submit(prompt, max_new_tokens=50)
        out = eng.run()
        assert eng.results[uid].truncated
        assert out[uid] == ref(prompt, 16 - 5 + 1)
        assert int(eng.cache.lengths[0]) == 16
