"""apex_tpu_torch's chain self-speculative decoding vs the JAX package,
on the CPU at ``GPTConfig.tiny`` fp32 (weights carried across with
``from_jax_params``; the JAX decoders are shared by the module, so each
of their programs compiles once).

- ``propose_ngram`` equal to JAX's for drafts 1-7 on seeded histories
  (-1 padding, periodic rows, dead rows) and on JAX's pinned rows.
- The verify blocks and the truncated (shallow-exit) steps, paged and
  contiguous, against JAX's model methods: logits within 1e-4, the
  written pools and caches within 1e-5.
- One spec window of each layout and proposer from the same cache state
  as JAX's: candidate tokens, accepted counts, lengths and the token
  meter equal.
- Mixed queues larger than the slots through the paged and contiguous
  spec engines with both proposers: the tokens of JAX's
  ``reference_generate`` and of the JAX non-spec engine, and
  ``stats()["spec"]`` equal to the JAX spec engine's; preemption in the
  middle of speculation; capacity inside a verify block; shared-prefix
  copy-on-write under speculation; a bf16 spec engine equal to the
  port's bf16 non-spec engine.
- The sampling epilogue on (B, T, V) verify logits with B != T, the
  paged write horizon, argument validation (the tree's configuration
  errors among them) and the raise without CUDA.
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
from apex_tpu.serve import propose_ngram as jax_propose_ngram
from apex_tpu.serve import reference_generate as jax_reference
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.serve import (
    GPTDecoder,
    SamplingParams,
    ServeEngine,
    init_cache,
    propose_ngram,
    reference_generate,
)
from apex_tpu_torch.serve.decode import _sample_params
from apex_tpu_torch.weights import from_jax_params

SLOTS, MAX_LEN, PAGE_LEN, K = 2, 64, 8, 4
#: (name, spec_tokens, proposer, exit layers): the n-gram decoder's
#: write horizon equals K (1 step of 4), the shallow one's exceeds it
#: (2 steps of 3 = 6 positions past a slot's length)
SPEC = {"ngram": (3, "ngram", None), "shallow": (2, "shallow", 1)}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture(scope="module")
def lm():
    """(jax cfg, flax params, the port's state dict, token pool, cached
    JAX ``reference_generate``)."""
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 32))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    memo = {}

    def ref(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = jax_reference(cfg, params, prompt, n)
        return memo[key]

    return cfg, params, sd, ids[0], ref


@pytest.fixture(scope="module")
def decs(lm):
    """{name: (port decoder, JAX decoder)} for "plain" and each of
    :data:`SPEC`, all at K = 4."""
    cfg, params, sd, _, _ = lm
    out = {"plain": (
        GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                   tokens_per_dispatch=K, device="cpu"),
        JaxDecoder(cfg, params, tokens_per_dispatch=K))}
    for name, (d, prop, e) in SPEC.items():
        kw = dict(tokens_per_dispatch=K, spec_tokens=d, spec_proposer=prop,
                  spec_exit_layers=e)
        out[name] = (
            GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                       device="cpu", **kw),
            JaxDecoder(cfg, params, **kw))
    return out


def _prompts(pool, specs):
    return [[int(t) for t in pool[s:s + n]] for s, n in specs]


def _engine(cls, dec, paged, **kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    if paged:
        kw.setdefault("page_len", PAGE_LEN)
        kw.setdefault("prefill_chunk", 8)
    return cls(dec, paged=paged, **kw)


def _run(eng, prompts, budgets):
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    out = eng.run()
    return [out[u] for u in uids]


# -- the proposer ------------------------------------------------------------

def _histories(seed, b=24, h=12):
    """Seeded (b, h) histories over a 5-token vocabulary (so bigrams
    recur), with left -1 padding on some rows, periodic rows and rows
    dead but for their last token."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, 5, size=(b, h)).astype(np.int32)
    for r in range(0, b, 4):
        hist[r, :rng.randint(1, h - 1)] = -1
    for r, p in zip(range(1, b, 4), (2, 3, 4, 5, 1, 6)):
        hist[r] = np.resize(rng.randint(0, 50, size=p), h)
    hist[2::8, :-1] = -1
    return hist


class TestProposeNgram:
    def test_pinned_rows(self):
        hist = np.asarray([[7, 8, 9, 7, 8, 9, 7, 8],
                           [-1, -1, -1, -1, -1, -1, -1, 5]], np.int32)
        got = propose_ngram(torch.from_numpy(hist), 4)
        assert got.dtype == torch.int32
        assert got.tolist() == [[9, 7, 8, 9], [5, 5, 5, 5]]
        assert got.tolist() == np.asarray(
            jax_propose_ngram(jnp.asarray(hist), 4)).tolist()

    @pytest.mark.parametrize("draft", range(1, 8))
    def test_matches_jax(self, draft):
        hist = _histories(draft)
        got = propose_ngram(torch.from_numpy(hist), draft).numpy()
        want = np.asarray(jax_propose_ngram(jnp.asarray(hist), draft))
        np.testing.assert_array_equal(got, want)


# -- the verify blocks and truncated steps -----------------------------------

def _pool_state(seed, b=3, pps=4, page_len=8, layers=2, heads=2, d=64):
    """Random pools with distinct physical pages per row (page 0 the
    trash page), and lengths that leave room for a 4-token block."""
    rng = np.random.RandomState(seed)
    n_pages = 1 + b * pps
    shape = (n_pages, layers, heads, page_len, d)
    pk = (0.5 * rng.randn(*shape)).astype(np.float32)
    pv = (0.5 * rng.randn(*shape)).astype(np.float32)
    tables = (1 + rng.permutation(b * pps)).reshape(b, pps).astype(np.int32)
    lengths = np.asarray([5, 17, 26], np.int32)[:b]
    return pk, pv, tables, lengths


def _cache_state(seed, b=3, s=32, layers=2, heads=2, d=64):
    rng = np.random.RandomState(seed)
    shape = (b, layers, heads, s, d)
    ck = (0.5 * rng.randn(*shape)).astype(np.float32)
    cv = (0.5 * rng.randn(*shape)).astype(np.float32)
    return ck, cv, np.asarray([5, 17, 26], np.int32)[:b]


BLOCK_CASES = {
    # name: (paged, block length T or None for a step, n_layers)
    "paged_block_T4": (True, 4, None),
    "paged_block_T2": (True, 2, None),
    "paged_step_E1": (True, None, 1),
    "block_T4": (False, 4, None),
    "block_T3": (False, 3, None),
    "step_E1": (False, None, 1),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_and_truncated_step_match_jax(lm, decs, case):
    cfg, params, _, pool, _ = lm
    model = decs["plain"][0].model
    paged, t, n_layers = BLOCK_CASES[case]
    rng = np.random.RandomState(11)
    ids = rng.randint(0, cfg.vocab_size, size=(3, t or 1)).astype(np.int32)
    jm = JaxGPTLM(cfg)
    if paged:
        a, b, tables, lengths = _pool_state(3)
        extra = (tables,)
    else:
        a, b, lengths = _cache_state(4)
        extra = ()
    ta, tb = torch.from_numpy(a.copy()), torch.from_numpy(b.copy())
    targs = (ta, tb) + tuple(torch.from_numpy(x) for x in extra) + (
        torch.from_numpy(lengths),)
    jargs = (jnp.asarray(a), jnp.asarray(b)) + tuple(
        jnp.asarray(x) for x in extra) + (jnp.asarray(lengths),)
    prefix = "paged_" if paged else ""
    with torch.no_grad():
        if t is None:
            meth = prefix + "decode_step"
            got = getattr(model, meth)(torch.from_numpy(ids[:, 0]), *targs,
                                       n_layers=n_layers)
            want, ja, jb = jm.apply({"params": params}, jnp.asarray(ids[:, 0]),
                                    *jargs, n_layers=n_layers,
                                    method=getattr(JaxGPTLM, meth))
        else:
            meth = prefix + "decode_block"
            got = getattr(model, meth)(torch.from_numpy(ids), *targs)
            want, ja, jb = jm.apply({"params": params}, jnp.asarray(ids),
                                    *jargs, method=getattr(JaxGPTLM, meth))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=0)
    # the writes landed: the new tokens' columns changed
    assert not np.array_equal(ta.numpy(), a)


# -- one spec window from the same state as JAX's ----------------------------

def _hist(ctx_rows, h):
    out = np.full((len(ctx_rows), h), -1, np.int32)
    for i, ctx in enumerate(ctx_rows):
        tail = ctx[-h:]
        out[i, h - len(tail):] = tail
    return out


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("name", sorted(SPEC))
def test_one_spec_window_matches_jax(lm, decs, name, paged):
    _, _, _, pool, _ = lm
    dec, jdec = decs[name]
    a, b = int(pool[0]), int(pool[1])
    prompts = [[a, b] * 3 + [a], _prompts(pool, [(3, 5)])[0]]
    key = jax.random.PRNGKey(0)
    if paged:
        pps = MAX_LEN // PAGE_LEN
        cache = dec.init_paged_cache(1 + SLOTS * pps, SLOTS, PAGE_LEN)
        jcache = jdec.init_paged_cache(1 + SLOTS * pps, SLOTS, PAGE_LEN)
        tables = (1 + np.arange(SLOTS * pps)).reshape(SLOTS, pps).astype(
            np.int32)
        first = []
        for s, p in enumerate(prompts):
            ids = np.zeros((1, 8), np.int32)
            ids[0, :len(p)] = p
            args = (tables[s][None], np.asarray([s], np.int32), ids,
                    np.asarray([0], np.int32),
                    np.asarray([len(p)], np.int32))
            dec.prefill_chunk(cache, *args)
            jcache, lg = jdec.prefill_chunk(jcache, *args)
            first.append(int(np.argmax(np.asarray(lg)[0])))
    else:
        cache = dec.init_cache(SLOTS, MAX_LEN)
        ids = np.zeros((SLOTS, 8), np.int32)
        for s, p in enumerate(prompts):
            ids[s, :len(p)] = p
        lens = np.asarray([len(p) for p in prompts], np.int32)
        slots = np.arange(SLOTS, dtype=np.int32)
        dec.prefill(cache, slots, ids, lens)
        jcache, lg = jdec.prefill(jdec.init_cache(SLOTS, MAX_LEN), slots,
                                  ids, lens)
        first = np.argmax(np.asarray(lg), -1).tolist()
    tok = np.asarray(first, np.int32)
    hist = _hist([p + [f] for p, f in zip(prompts, first)], dec.spec_hist)
    active = np.asarray([True, True])
    if paged:
        buf = dec.paged_spec_decode_window(cache, tables, tok, active, hist)
        jcache, jt, ja = jdec.paged_spec_decode_window(
            jcache, tables, tok, active, hist, key)
    else:
        buf = dec.spec_decode_window(cache, tok, active, hist)
        jcache, jt, ja = jdec.spec_decode_window(jcache, tok, active, hist,
                                                 key)
    d = dec.spec_tokens
    assert buf.dtype == torch.int32
    assert tuple(buf.shape) == (dec.spec_steps, SLOTS, d + 2)
    assert buf[..., :-1].tolist() == np.asarray(jt).tolist()
    assert buf[..., -1].tolist() == np.asarray(ja).tolist()
    assert cache.lengths.tolist() == np.asarray(jcache.lengths).tolist()
    assert int(cache.decoded) == int(jcache.decoded)


# -- engines -----------------------------------------------------------------

@pytest.fixture(scope="module")
def queue(lm, decs):
    """A mixed queue longer than the slots (one prompt a period-2
    repetition) and the JAX non-spec paged engine's tokens for it."""
    _, _, _, pool, _ = lm
    a, b = int(pool[0]), int(pool[1])
    prompts = _prompts(pool, [(0, 3), (2, 9), (5, 5), (1, 12)]) + [[a, b] * 6]
    budgets = [6, 13, 4, 9, 20]
    jeng = _engine(JaxEngine, decs["plain"][1], True)
    return prompts, budgets, _run(jeng, prompts, budgets)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("name", sorted(SPEC))
def test_engine_matches_jax_and_reference(lm, decs, queue, name, paged):
    ref = lm[4]
    prompts, budgets, plain = queue
    dec, jdec = decs[name]
    eng = _engine(ServeEngine, dec, paged)
    got = _run(eng, prompts, budgets)
    assert got == plain
    assert got == [ref(p, n) for p, n in zip(prompts, budgets)]
    jeng = _engine(JaxEngine, jdec, paged)
    assert _run(jeng, prompts, budgets) == got
    spec = eng.stats()["spec"]
    assert spec == jeng.stats()["spec"]
    assert spec["draft_tokens"] > 0 and spec["accepted_draft_tokens"] > 0
    assert sum(spec["accepted_per_step_hist"].values()) > 0
    for key in ("decoded_tokens", "decode_dispatches", "prefill_dispatches"):
        assert eng.stats()[key] == jeng.stats()[key], key


def test_repetitive_prompt_accepts_drafts(lm, decs):
    """On a period-2 prompt the n-gram drafts land: more tokens a window
    than verify steps."""
    _, _, _, pool, ref = lm
    a, b = int(pool[0]), int(pool[1])
    eng = _engine(ServeEngine, decs["ngram"][0], True, slots=1)
    uid = eng.submit([a, b] * 6, max_new_tokens=24)
    assert eng.run()[uid] == ref([a, b] * 6, 24)
    s = eng.stats()
    assert s["spec"]["acceptance_rate"] > 0.2, s["spec"]
    assert (s["spec"]["mean_tokens_per_dispatch"]
            > s["spec"]["steps_per_dispatch"]), s["spec"]


@pytest.mark.parametrize("name", sorted(SPEC))
def test_preemption_mid_speculation(lm, decs, name):
    ref = lm[4]
    prompts = _prompts(lm[3], [(0, 9), (4, 9)])
    eng = _engine(ServeEngine, decs[name][0], True, max_len=32, page_len=4,
                  num_pages=9)
    got = _run(eng, prompts, [14, 14])
    assert eng.preemptions >= 1
    assert got == [ref(p, 14) for p in prompts]
    assert eng.stats()["pages_in_use"] == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("name", sorted(SPEC))
def test_capacity_inside_a_verify_block(lm, decs, name, paged):
    """A 16-column slot fills in the middle of a verify block: the block's
    last positions clamp to column 15, the accepted count is cut at the
    capacity, and the request retires truncated with the reference's
    tokens."""
    ref = lm[4]
    a, b = int(lm[3][0]), int(lm[3][1])
    prompts = [[a, b] * 2 + [a], _prompts(lm[3], [(3, 6)])[0]]
    eng = _engine(ServeEngine, decs[name][0], paged, max_len=16)
    uids = [eng.submit(p, max_new_tokens=50) for p in prompts]
    out = eng.run()
    for uid, p in zip(uids, prompts):
        assert eng.results[uid].truncated
        assert out[uid] == ref(p, 16 - len(p) + 1)
    assert eng.cache.lengths.max().item() <= 16


@pytest.mark.parametrize("name", sorted(SPEC))
def test_shared_prefix_cow_under_speculation(lm, decs, name):
    """Duplicate prompts share prefix pages and copy-on-write while
    speculating; the tokens equal the reference's and the port's
    non-spec engine's."""
    _, _, _, pool, ref = lm
    base = [int(t) for t in pool[:11]]
    prompts = [base, [int(t) for t in pool[3:8]], list(base), base + [7, 9]]
    budgets = [10, 6, 10, 7]
    eng = _engine(ServeEngine, decs[name][0], True, slots=3)
    got = _run(eng, prompts, budgets)
    assert eng.pool.prefix_hits >= 1 and eng.pool.cow_copies >= 1
    assert got == [ref(p, n) for p, n in zip(prompts, budgets)]
    assert got == _run(_engine(ServeEngine, decs["plain"][0], True, slots=3),
                       prompts, budgets)


def test_bf16_spec_engine_equals_bf16_plain_engine(lm):
    sd = lm[2]
    cfg = GPTConfig.tiny(compute_dtype=torch.bfloat16)
    prompts = _prompts(lm[3], [(0, 5), (4, 9), (9, 6)])
    a, b = int(lm[3][0]), int(lm[3][1])
    prompts.append([a, b] * 5)
    budgets = [9, 7, 12, 16]
    outs = []
    for kw in ({}, dict(spec_tokens=2), dict(spec_tokens=3,
                                             spec_proposer="shallow",
                                             spec_exit_layers=1)):
        dec = GPTDecoder(cfg, sd, tokens_per_dispatch=3, device="cpu", **kw)
        outs.append(_run(_engine(ServeEngine, dec, True), prompts, budgets))
    assert outs[1] == outs[0] and outs[2] == outs[0]


def test_reference_generate_matches_jax(lm):
    cfg, _, sd, pool, ref = lm
    prompt = [int(t) for t in pool[:7]]
    got = reference_generate(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                             prompt, 9, device="cpu")
    assert got == ref(prompt, 9)
    with pytest.raises(ValueError, match="pad_to"):
        reference_generate(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                           prompt, 9, pad_to=8, device="cpu")


# -- the sampling epilogue, the write horizon, validation --------------------

@pytest.mark.parametrize("b, t", [(3, 5), (5, 3), (4, 1)])
def test_sampling_epilogue_on_verify_blocks(b, t):
    """Per-slot params over (B, T, V) logits: greedy rows and top_k = 1
    rows give the argmax at every position; a top-k row stays in its
    top k at every position."""
    rng = np.random.RandomState(b * 10 + t)
    logits = torch.from_numpy((3 * rng.randn(b, t, 40)).astype(np.float32))
    temps = [0.0, 2.0] + [0.8] * (b - 2)
    top_k = [0, 1] + [4] * (b - 2)
    samp = SamplingParams.make(b, temps, top_k, device="cpu")
    assert not samp.all_greedy
    gen = torch.Generator().manual_seed(0)
    best = logits.argmax(-1)
    top4 = torch.topk(logits, 4, dim=-1).indices
    for _ in range(20):
        got = _sample_params(logits, gen, samp)
        assert got.dtype == torch.int32 and tuple(got.shape) == (b, t)
        assert torch.equal(got[:2], best[:2].to(torch.int32))
        assert (got[2:, :, None].long() == top4[2:]).any(-1).all()


def test_write_horizon_pages_are_writable(lm, decs):
    """The shallow decoder's window writes up to 6 positions past a slot's
    length (2 verify steps of 3), more than K = 4: the engine makes all
    of them writable before the window."""
    dec, jdec = decs["shallow"]
    assert (dec.spec_steps, dec.write_horizon(), dec.max_write_horizon) == (
        2, 6, 6)
    assert dec.write_horizon(1) == jdec.write_horizon(1) == 4
    assert dec.write_horizon() == jdec.write_horizon()
    assert dec.max_write_horizon == jdec.max_write_horizon
    assert dec.max_tokens_per_dispatch == jdec.max_tokens_per_dispatch
    assert decs["plain"][0].write_horizon() == K
    eng = _engine(ServeEngine, dec, True, slots=1, max_len=32, page_len=4)
    eng.submit([int(t) for t in lm[3][:7]], max_new_tokens=20)
    while not eng._active:
        eng._admit_paged()
        eng._prefill_chunks()
    assert int(eng._slot_len[0]) == 7
    eng._prepare_decode_pages()
    # positions 7 .. 12 lie on pages 1, 2 and 3 (page_len 4)
    assert all(eng.pool.tables[0, :4] != 0) and eng.pool.tables[0, 4] == 0


def test_validation_and_devices(lm, monkeypatch):
    sd = lm[2]
    cfg = GPTConfig.tiny(compute_dtype=torch.float32)

    def make(**kw):
        return GPTDecoder(cfg, sd, device="cpu", **kw)

    with pytest.raises(ValueError, match="spec_hist"):
        make(spec_tokens=2, spec_hist=3)
    make(spec_hist=3)  # speculation off: the history is unused
    with pytest.raises(ValueError, match="spec_proposer"):
        make(spec_tokens=2, spec_proposer="tree")
    with pytest.raises(ValueError, match="spec_exit_layers"):
        make(spec_tokens=2, spec_exit_layers=3)
    with pytest.raises(ValueError, match="spec_tokens"):
        make(spec_tokens=-1)
    # tree speculation's configuration errors, as in the JAX package
    with pytest.raises(ValueError, match="spec_tree needs speculation"):
        make(spec_tree=2)
    with pytest.raises(ValueError, match="'ngram' proposer"):
        make(spec_tokens=2, spec_tree=2, spec_proposer="shallow",
             spec_exit_layers=1)
    with pytest.raises(ValueError, match="requires the paged cache"):
        ServeEngine(make(spec_tokens=2, spec_tree=2), slots=1, max_len=32,
                    paged=False)
    dec = make(spec_tokens=2, tokens_per_dispatch=4)
    cache = dec.init_cache(1, 16)
    pcache = dec.init_paged_cache(3, 1, 8)
    hist = np.full((1, dec.spec_hist), -1, np.int32)
    for d in (0, 3):
        with pytest.raises(ValueError, match="draft override"):
            dec.spec_decode_window(cache, [1], [True], hist, draft=d)
        with pytest.raises(ValueError, match="draft override"):
            dec.paged_spec_decode_window(pcache, [[1, 2]], [1], [True], hist,
                                         draft=d)
    buf = dec.spec_decode_window(cache, [1], [True], hist, draft=1)
    assert tuple(buf.shape) == (2, 1, 3)  # ceil(4 / 2) steps of 1 + 1
    with pytest.raises(ValueError):
        make(spec_tokens=0).spec_decode_window(cache, [1], [True], hist)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTDecoder(cfg, sd, spec_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reference_generate(cfg, sd, [1, 2], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SamplingParams.make(2)
