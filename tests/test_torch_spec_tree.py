"""apex_tpu_torch's tree self-speculative decoding, the draft-depth
auto-tuner, the policy's KV-cache dtype and the untied head vs the JAX
package, on the CPU at ``GPTConfig.tiny`` fp32 (weights carried across
with ``from_jax_params``; the JAX decoders are shared by the module, so
each of their programs compiles once).

- ``propose_ngram_tree`` equal to JAX's for W 2-4 and D 1-4 on seeded
  histories with -1 padding; branch 0 equal to ``propose_ngram``.
- ``paged_decode_tree_block`` with fp32 and int8 pools against JAX's:
  logits within 1e-4, the written int8 pools and scales within 1e-6,
  fp32 pools within 1e-5.
- ``_tree_compact`` (int8 scales too) equal to JAX's, bit for bit.
- One tree window from the same cache state as JAX's, and the
  poisoned-history case where branch 1 must win: tokens, accepted
  counts, branches, lengths and the token meter equal.
- Tree engines with a shared prefix under copy-on-write and with a
  preemption: the tokens of JAX's tree engine, the port's chain engine
  and ``reference_generate``; ``stats()["spec"]`` (the tree counts
  among them) equal to JAX's.
- ``write_horizon``/``max_write_horizon`` over a grid, the tuner's walk,
  and auto-tuned chain and tree engines against JAX's (tokens and the
  trajectory).
- ``Policy(kv_cache_dtype=)`` and the decoder's cache-dtype resolution;
  an fp16 cache computing on the CPU; the untied head's logits and O0
  loss against JAX's ``tie_word_embeddings=False``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.policy import Policy as JaxPolicy
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.serve import GPTDecoder as JaxDecoder
from apex_tpu.serve import ServeEngine as JaxEngine
from apex_tpu.serve import reference_generate as jax_reference
from apex_tpu.serve.decode import propose_ngram_tree as jax_propose_tree
from apex_tpu.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from apex_tpu_torch.amp import Policy, make_policy
from apex_tpu_torch.models import GPTConfig, GPTLM
from apex_tpu_torch.ops.attention import quantize_kv
from apex_tpu_torch.serve import (
    GPTDecoder,
    PagedKVCache,
    ServeEngine,
    propose_ngram,
    propose_ngram_tree,
)
from apex_tpu_torch.weights import from_jax_params

SLOTS, MAX_LEN, PAGE_LEN, K = 2, 64, 8, 4
#: (name, spec_tokens, spec_tree): the tree decoders the module shares
TREES = {"w2d2": (2, 2), "w3d3": (3, 3)}


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


def _port(sd, **kw):
    kw.setdefault("tokens_per_dispatch", K)
    return GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                      device="cpu", **kw)


def _jax(cfg, params, **kw):
    kw.setdefault("tokens_per_dispatch", K)
    kw.setdefault("spec_tokens", 0)
    kw.setdefault("spec_tree", 0)
    kw.setdefault("kv_int8", False)
    kw.setdefault("paged_fused", False)
    return JaxDecoder(cfg, params, **kw)


@pytest.fixture(scope="module")
def decs(lm):
    """{name: (port decoder, JAX decoder)}: the tree decoders of
    :data:`TREES`, the n-gram chain at D = 2 and the plain decoder."""
    cfg, params, sd, _, _ = lm
    out = {name: (_port(sd, spec_tokens=d, spec_tree=w),
                  _jax(cfg, params, spec_tokens=d, spec_tree=w))
           for name, (w, d) in TREES.items()}
    out["chain"] = (_port(sd, spec_tokens=2),
                    _jax(cfg, params, spec_tokens=2))
    out["plain"] = (_port(sd), _jax(cfg, params))
    return out


def _prompts(pool, specs):
    return [[int(t) for t in pool[s:s + n]] for s, n in specs]


def _engine(cls, dec, **kw):
    kw.setdefault("slots", SLOTS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("page_len", PAGE_LEN)
    kw.setdefault("prefill_chunk", 8)
    return cls(dec, paged=True, **kw)


def _run(eng, prompts, budgets):
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    out = eng.run()
    return [out[u] for u in uids]


# -- the proposer ------------------------------------------------------------

def _histories(seed, b=24, h=16):
    """Seeded (b, h) histories over a 4-token vocabulary (so bigrams
    recur several times), with left -1 padding on some rows, periodic
    rows and rows dead but for their last token."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, 4, size=(b, h)).astype(np.int32)
    for r in range(0, b, 4):
        hist[r, :rng.randint(1, h - 1)] = -1
    for r, p in zip(range(1, b, 4), (2, 3, 4, 5, 1, 6)):
        hist[r] = np.resize(rng.randint(0, 50, size=p), h)
    hist[2::8, :-1] = -1
    return hist


@pytest.mark.parametrize("width", [2, 3, 4])
@pytest.mark.parametrize("draft", [1, 2, 3, 4])
def test_propose_ngram_tree_matches_jax(width, draft):
    hist = _histories(10 * width + draft)
    got = propose_ngram_tree(torch.from_numpy(hist), draft, width)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (hist.shape[0], width, draft)
    want = np.asarray(jax_propose_tree(jnp.asarray(hist), draft, width))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got[:, 0], propose_ngram(torch.from_numpy(hist), draft))


def test_propose_ngram_tree_pinned_rows():
    """Three matches of (7, 8), latest first; one match, then the
    fallback in the spare branch; no match at all."""
    hist = np.asarray([[7, 8, 1, 7, 8, 2, 7, 8, 3, 7, 8],
                       [-1, -1, -1, -1, -1, 5, 6, 9, 4, 5, 6],
                       [-1, -1, -1, -1, -1, -1, -1, -1, -1, 3, 4]], np.int32)
    got = propose_ngram_tree(torch.from_numpy(hist), 2, 3).tolist()
    assert got == [[[3, 7], [2, 7], [1, 7]],
                   [[9, 4], [6, 6], [6, 6]],
                   [[4, 4], [4, 4], [4, 4]]]
    assert got == np.asarray(
        jax_propose_tree(jnp.asarray(hist), 2, 3)).tolist()


# -- the tree block ----------------------------------------------------------

def _pool_state(seed, int8, b=3, pps=4, page_len=8, layers=2, heads=2, d=64):
    """Random pools with distinct physical pages per row (page 0 the
    trash page) and lengths 5, 17 and 26 (the last row's parking slots
    clamp at the table's last column); int8 pools with their scales."""
    rng = np.random.RandomState(seed)
    n_pages = 1 + b * pps
    shape = (n_pages, layers, heads, page_len, d)
    pk = (0.5 * rng.randn(*shape)).astype(np.float32)
    pv = (0.5 * rng.randn(*shape)).astype(np.float32)
    tables = (1 + rng.permutation(b * pps)).reshape(b, pps).astype(np.int32)
    lengths = np.asarray([5, 17, 26], np.int32)[:b]
    if not int8:
        return [pk, pv], tables, lengths
    (qk, sk), (qv, sv) = (quantize_kv(torch.from_numpy(x)) for x in (pk, pv))
    return [qk.numpy(), qv.numpy(), sk.numpy(), sv.numpy()], tables, lengths


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("width, depth", [(2, 3), (3, 2)])
def test_tree_block_matches_jax(lm, decs, int8, width, depth):
    cfg, params, _, _, _ = lm
    model = decs["plain"][0].model
    arrays, tables, lengths = _pool_state(7, int8)
    t = 1 + width * depth
    ids = np.random.RandomState(12).randint(
        0, cfg.vocab_size, size=(3, t)).astype(np.int32)
    ta = [torch.from_numpy(x.copy()) for x in arrays]
    scales = dict(k_scale=ta[2], v_scale=ta[3]) if int8 else {}
    with torch.no_grad():
        got = model.paged_decode_tree_block(
            torch.from_numpy(ids), ta[0], ta[1], torch.from_numpy(tables),
            torch.from_numpy(lengths), width=width, depth=depth, **scales)
    jscales = (dict(k_scale=jnp.asarray(arrays[2]),
                    v_scale=jnp.asarray(arrays[3])) if int8 else {})
    want, *jarrays = JaxGPTLM(cfg).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(arrays[0]),
        jnp.asarray(arrays[1]), jnp.asarray(tables), jnp.asarray(lengths),
        width=width, depth=depth, method=JaxGPTLM.paged_decode_tree_block,
        **jscales)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (3, t, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # fp32 pools: the chain blocks' 1e-5 (the qkv products' fp32 sums
    # alone move layer 0's K/V up to 1.5e-6 apart); int8 codes and
    # scales: 1e-6
    tol = 1e-6 if int8 else 1e-5
    for mine, theirs, before in zip(ta, jarrays, arrays):
        np.testing.assert_allclose(mine.numpy().astype(np.float32),
                                   np.asarray(theirs).astype(np.float32),
                                   atol=tol, rtol=0)
        assert not np.array_equal(mine.numpy(), before)  # the writes landed
    with pytest.raises(ValueError, match="wants T"):
        model.paged_decode_tree_block(
            torch.from_numpy(ids[:, :-1]), ta[0], ta[1],
            torch.from_numpy(tables), torch.from_numpy(lengths),
            width=width, depth=depth, **scales)


def test_tree_layout_made_once(decs):
    """The branch mask is made once per (W, D), contiguous bool: a query
    sees the root and its own branch."""
    model = decs["plain"][0].model
    depths, mask = model._tree(2, 2, torch.device("cpu"))
    assert depths.tolist() == [[0, 1, 2, 1, 2]]
    assert mask.dtype == torch.bool and mask.is_contiguous()
    assert mask.int().tolist() == [[1, 0, 0, 0, 0], [1, 1, 1, 0, 0],
                                   [1, 1, 1, 0, 0], [1, 0, 0, 1, 1],
                                   [1, 0, 0, 1, 1]]
    assert model._tree(2, 2, torch.device("cpu"))[1] is mask


# -- compaction --------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_tree_compact_moves_winning_branch(int8):
    """The port of JAX's unit test, with a second row and int8 scales:
    branch ``rstar``'s parked slots move into the chain slots, nothing
    else changes, and rstar == 0 or inactive rows are the identity; the
    result equals JAX's ``_tree_compact`` bit for bit."""
    layers, heads, page_len, d, pps, b = 1, 2, 4, 2, 4, 2
    shape = (1 + b * pps, layers, heads, page_len, d)
    k = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    arrays = dict(k=k, v=k + 1000.0)
    if int8:
        arrays = dict(k=(k % 100).astype(np.int8),
                      v=(k % 50).astype(np.int8),
                      k_scale=k[..., 0] + 0.5, v_scale=k[..., 0] + 0.25)
    tables = (1 + np.arange(b * pps, dtype=np.int32)).reshape(b, pps)
    draft = 2
    for rstar, active, n_eff in (([1, 1], [True, True], [3, 2]),
                                 ([0, 1], [True, False], [3, 3])):
        args = [np.asarray([2, 5], np.int32), np.asarray(rstar, np.int32),
                np.asarray(n_eff, np.int32), np.asarray(active)]
        cache = PagedKVCache(
            lengths=torch.tensor([2, 5], dtype=torch.int32),
            decoded=torch.zeros((), dtype=torch.int64),
            **{n: torch.from_numpy(a.copy()) for n, a in arrays.items()})
        GPTDecoder._tree_compact(cache, torch.from_numpy(tables),
                                 *map(torch.from_numpy, args), draft)
        jc = JaxDecoder._tree_compact(
            JaxPagedKVCache(lengths=jnp.asarray([2, 5], jnp.int32),
                            decoded=jnp.int32(0),
                            **{n: jnp.asarray(a) for n, a in arrays.items()}),
            jnp.asarray(tables), *map(jnp.asarray, args), draft)
        for n in arrays:
            np.testing.assert_array_equal(getattr(cache, n).numpy(),
                                          np.asarray(getattr(jc, n)))
        got = cache.k.numpy()

        def slot(arr, row, s):
            return arr[tables[row, s // page_len], :, :, s % page_len]

        if rstar == [1, 1]:
            # row 0: n_eff 3, slots 3, 4 <- parked 5, 6; row 1: n_eff 2,
            # slot 6 <- parked 8, slot 7 stays
            for row, dst, src in ((0, 3, 5), (0, 4, 6), (1, 6, 8)):
                np.testing.assert_array_equal(slot(got, row, dst),
                                              slot(arrays["k"], row, src))
            np.testing.assert_array_equal(slot(got, 1, 7),
                                          slot(arrays["k"], 1, 7))
            assert not np.array_equal(got, arrays["k"])
        else:
            np.testing.assert_array_equal(got, arrays["k"])


# -- one tree window from the same state as JAX's ----------------------------

def _hist(ctx_rows, h):
    out = np.full((len(ctx_rows), h), -1, np.int32)
    for i, ctx in enumerate(ctx_rows):
        tail = ctx[-h:]
        out[i, h - len(tail):] = tail
    return out


def _prefilled(dec, jdec, prompts):
    """Both decoders' paged caches after the same prompt prefills (slot
    s holds prompt s), the tables and the first greedy tokens."""
    pps = MAX_LEN // PAGE_LEN
    cache = dec.init_paged_cache(1 + SLOTS * pps, SLOTS, PAGE_LEN)
    jcache = jdec.init_paged_cache(1 + SLOTS * pps, SLOTS, PAGE_LEN)
    tables = (1 + np.arange(SLOTS * pps)).reshape(SLOTS, pps).astype(np.int32)
    first = []
    for s, p in enumerate(prompts):
        ids = np.zeros((1, 8), np.int32)
        ids[0, :len(p)] = p
        args = (tables[s][None], np.asarray([s], np.int32), ids,
                np.asarray([0], np.int32), np.asarray([len(p)], np.int32))
        lg = dec.prefill_chunk(cache, *args)
        jcache, jlg = jdec.prefill_chunk(jcache, *args)
        first.append(int(torch.argmax(lg[0])))
        assert first[-1] == int(np.argmax(np.asarray(jlg)[0]))
    return cache, jcache, tables, first


def _window_pair(dec, jdec, cache, jcache, tables, tok, active, hist, draft):
    buf = dec.paged_tree_spec_decode_window(cache, tables, tok, active, hist,
                                            draft=draft)
    jcache, jt, ja, jb = jdec.paged_tree_spec_decode_window(
        jcache, tables, tok, active, hist, jax.random.PRNGKey(0),
        draft=draft)
    d = dec.spec_tokens if draft is None else draft
    assert buf.dtype == torch.int32
    assert tuple(buf.shape) == (dec._spec_steps_for(d), SLOTS, d + 3)
    assert buf[..., :d + 1].tolist() == np.asarray(jt).tolist()
    assert buf[..., d + 1].tolist() == np.asarray(ja).tolist()
    assert buf[..., d + 2].tolist() == np.asarray(jb).tolist()
    assert cache.lengths.tolist() == np.asarray(jcache.lengths).tolist()
    assert int(cache.decoded) == int(jcache.decoded)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5, rtol=0)
    return buf


@pytest.mark.parametrize("name, draft", [("w2d2", None), ("w3d3", None),
                                         ("w3d3", 2)])
def test_one_tree_window_matches_jax(lm, decs, name, draft):
    """A period-2 prompt (every branch drafts its continuation) beside a
    seeded one, from the same prefilled state as JAX's."""
    _, _, _, pool, _ = lm
    dec, jdec = decs[name]
    a, b = int(pool[0]), int(pool[1])
    prompts = [[a, b] * 3 + [a], _prompts(pool, [(3, 5)])[0]]
    cache, jcache, tables, first = _prefilled(dec, jdec, prompts)
    hist = _hist([p + [f] for p, f in zip(prompts, first)], dec.spec_hist)
    _window_pair(dec, jdec, cache, jcache, tables,
                 np.asarray(first, np.int32), np.asarray([True, True]), hist,
                 draft)


def test_forced_branch_win_tokens_exact(lm, decs):
    """The port of JAX's test: a poisoned history makes branch 0 (the
    chain's draft) propose a wrong token while branch 1 proposes the
    model's own greedy tokens; branch 1 must win with 3 tokens accepted,
    its K/V compacted, and the next step, which reads those slots, must
    still match the reference.  Every output equals JAX's window."""
    cfg, _, _, pool, ref = lm
    dec, jdec = decs["w2d2"]
    prompt = [int(t) for t in pool[:8]]
    want = ref(prompt, 10)
    cache, jcache, tables, first = _prefilled(dec, jdec, [prompt])
    tok0 = first[0]
    assert tok0 == want[0]
    wrong = (want[1] + 1) % cfg.vocab_size
    poison = [prompt[-1], tok0, want[1], want[2],
              prompt[-1], tok0, wrong, prompt[-1], tok0]
    hist = np.full((SLOTS, dec.spec_hist), -1, np.int32)
    hist[0, -len(poison):] = poison
    buf = _window_pair(dec, jdec, cache, jcache, tables,
                       np.asarray([tok0, 0], np.int32),
                       np.asarray([True, False]), hist, None)
    assert buf[0, 0, -1] == 1 and buf[0, 0, -2] == 3, buf[:, 0]
    out = [tok0]
    for i in range(buf.shape[0]):
        out.extend(buf[i, 0, :int(buf[i, 0, -2])].tolist())
    assert out == want[:len(out)]


# -- engines -----------------------------------------------------------------

ENGINE_CASES = {
    # name: (prompt specs, budgets, engine kwargs)
    "shared_prefix_cow": ("cow", [10, 6, 10, 7], dict(slots=3)),
    "preemption": ([(0, 9), (4, 9)], [14, 14],
                   dict(max_len=32, page_len=4, num_pages=9)),
}


def _case_prompts(pool, specs):
    if specs == "cow":
        base = [int(t) for t in pool[:11]]
        return [base, [int(t) for t in pool[3:8]], list(base), base + [7, 9]]
    return _prompts(pool, specs)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_tree_engine_matches_jax_chain_and_reference(lm, decs, case):
    _, _, _, pool, ref = lm
    specs, budgets, kw = ENGINE_CASES[case]
    prompts = _case_prompts(pool, specs)
    dec, jdec = decs["w2d2"]
    eng = _engine(ServeEngine, dec, **kw)
    got = _run(eng, prompts, budgets)
    assert got == [ref(p, n) for p, n in zip(prompts, budgets)]
    assert got == _run(_engine(ServeEngine, decs["chain"][0], **kw), prompts,
                       budgets)
    jeng = _engine(JaxEngine, jdec, **kw)
    assert _run(jeng, prompts, budgets) == got
    spec = eng.stats()["spec"]
    assert spec == jeng.stats()["spec"]
    assert spec["tree"]["width"] == 2 and spec["tree"]["verify_steps"] > 0
    for key in ("decoded_tokens", "decode_dispatches", "prefill_dispatches",
                "preemptions", "prefix_hits", "cow_copies"):
        assert eng.stats()[key] == jeng.stats()[key], key
    if case == "preemption":
        assert eng.preemptions >= 1
        assert eng.stats()["pages_in_use"] == 0
    else:
        assert eng.pool.prefix_hits >= 1 and eng.pool.cow_copies >= 1


def test_tree_accepts_at_least_the_chain(lm, decs):
    """On a repetitive prompt the tree's tokens equal the chain's and it
    banks at least as many tokens a window (branch 0 is the chain's
    draft)."""
    _, _, _, pool, _ = lm
    prompts = [[int(pool[0]), int(pool[1])] * 4]
    chain = _engine(ServeEngine, decs["chain"][0])
    tree = _engine(ServeEngine, decs["w2d2"][0])
    assert _run(tree, prompts, [18]) == _run(chain, prompts, [18])
    st, sc = tree.stats()["spec"], chain.stats()["spec"]
    assert st["mean_tokens_per_dispatch"] >= sc["mean_tokens_per_dispatch"]


# -- geometry, the tuner -----------------------------------------------------

@pytest.mark.parametrize("width", [0, 2, 4])
def test_write_horizon_grid_matches_jax(lm, width):
    cfg, params, sd, _, _ = lm
    for k in (1, 3, 4, 8):
        for d in (1, 2, 3, 5):
            kw = dict(tokens_per_dispatch=k, spec_tokens=d, spec_tree=width)
            dec, jdec = _port(sd, **kw), _jax(cfg, params, **kw)
            assert dec.spec_tree_width == jdec.spec_tree_width
            assert dec.max_write_horizon == jdec.max_write_horizon, kw
            for dd in range(1, d + 1):
                assert dec.write_horizon(dd) == jdec.write_horizon(dd), kw
            assert dec.write_horizon() == jdec.write_horizon()
    tree = _port(sd, spec_tokens=3, spec_tree=2)
    assert tree.write_horizon() == (tree.spec_steps - 1) * 4 + 1 + 2 * 3


def test_tuner_walks_draft(decs):
    """The port of JAX's unit test: saturation deepens, collapse
    shallows, both clamp to [1, spec_tokens], a window short of the
    period does not move it, and every move lands in the trajectory."""
    dec = decs["w3d3"][0]
    eng = _engine(ServeEngine, dec, spec_autotune=True)
    assert eng._auto_draft == 3 and eng._dispatch_draft() == 3
    eng._auto_draft = 2
    for window, want in (([3] * 8, 3), ([3] * 8, 3), ([1] * 8, 2),
                         ([1] * 7, 2), ([1] * 8, 1), ([1] * 8, 1)):
        eng._auto_window = list(window)
        eng._autotune_update()
        assert eng._auto_draft == want
    assert [d for _, d in eng._auto_traj] == [3, 2, 1]
    assert not ServeEngine(decs["plain"][0], slots=1, max_len=32,
                           spec_autotune=True).spec_autotune


@pytest.mark.parametrize("name", ["chain", "w2d2"])
def test_autotuned_engine_matches_jax(lm, decs, name):
    """Auto-tuned engines change the windows' depth only: the tokens are
    the reference's, and the trajectory and statistics JAX's.  Both
    tuners start at depth 1 (the tiny model's greedy streams repeat, so
    drafts land and the walk deepens)."""
    _, _, _, pool, ref = lm
    prompts = [[int(pool[0]), int(pool[1])] * 4, _prompts(pool, [(4, 5)])[0]]
    dec, jdec = decs[name]
    engines = [_engine(cls, d, spec_autotune=True)
               for cls, d in ((ServeEngine, dec), (JaxEngine, jdec))]
    for e in engines:
        e._auto_draft = 1
    eng, jeng = engines
    got = _run(eng, prompts, [24, 24])
    assert got == [ref(p, 24) for p in prompts]
    assert _run(jeng, prompts, [24, 24]) == got
    spec = eng.stats()["spec"]
    assert spec == jeng.stats()["spec"]
    assert spec["autotune"]["trajectory"]  # the walk moved
    assert all(1 <= d <= dec.spec_tokens
               for _, d in spec["autotune"]["trajectory"])


# -- the cache dtype, an fp16 cache, the untied head --------------------------

def test_policy_kv_cache_dtype_and_resolution(lm):
    sd = lm[2]
    pairs = ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
             (torch.float32, jnp.float32), (torch.int8, jnp.int8),
             (None, None))
    for tdt, jdt in pairs:
        for level, cast in (("O0", jnp.float32), ("O2", jnp.bfloat16)):
            p = make_policy(level, kv_cache_dtype=tdt)
            jp = JaxPolicy(opt_level=level, cast_model_dtype=cast,
                           kv_cache_dtype=jdt)
            assert str(p.cache_dtype).split(".")[-1] == \
                jnp.dtype(jp.cache_dtype).name
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        Policy(opt_level="O2", kv_cache_dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        JaxPolicy(opt_level="O2", kv_cache_dtype=jnp.int32)
    o2 = make_policy("O2")
    assert _port(sd, policy=o2).cache_dtype == torch.bfloat16
    assert _port(sd, policy=make_policy("O0")).cache_dtype == torch.float32
    assert _port(sd).cache_dtype == torch.float32  # the compute dtype
    assert _port(sd, policy=o2, cache_dtype=torch.float32).cache_dtype == \
        torch.float32  # explicit first
    dec = _port(sd, policy=make_policy("O2", kv_cache_dtype=torch.int8))
    assert dec.kv_int8 and dec.init_paged_cache(3, 1, 8).quantized
    dec = _port(sd, policy=o2, kv_int8=True)
    assert dec.init_paged_cache(3, 1, 8).k.dtype == torch.int8
    assert dec.init_cache(1, 8).k.dtype == torch.bfloat16


def test_fp16_cache_computes_on_the_cpu(lm, monkeypatch):
    """An fp16 page pool and contiguous cache run the plain versions on
    the CPU, with the reference's greedy tokens on this short run; the
    kernel's wrapper refuses fp16 and names ROADMAP B.2 (its checks run
    before any launch, so the CPU shows them with the dispatch rule
    forced to the kernel)."""
    _, _, sd, pool, ref = lm
    prompts = _prompts(pool, [(0, 6), (5, 9)])
    for paged in (True, False):
        dec = _port(sd, policy=make_policy("O0", kv_cache_dtype=torch.float16),
                    spec_tokens=2)
        assert dec.cache_dtype == torch.float16
        eng = ServeEngine(dec, slots=SLOTS, max_len=MAX_LEN, paged=paged,
                          page_len=PAGE_LEN, prefill_chunk=8)
        assert eng.cache.k.dtype == torch.float16
        got = _run(eng, prompts, [8, 8])
        assert got == [ref(p, 8) for p in prompts]
    from apex_tpu_torch.ops import attention
    pool = torch.zeros((3, 1, 2, 8, 64), dtype=torch.float16)
    q = torch.zeros((1, 2, 1, 64))
    monkeypatch.setattr(attention, "use_kernel", lambda *t: True)
    with pytest.raises(ValueError, match="B.2"):
        attention.paged_fused_attention(
            q, q, q, positions=torch.zeros((1, 1), dtype=torch.int32),
            pool_k=pool, pool_v=pool,
            page_table=torch.ones((1, 2), dtype=torch.int32),
            cache_lengths=torch.zeros((1,), dtype=torch.int32))


@pytest.fixture(scope="module")
def untied(lm):
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0, tie_word_embeddings=False)
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, size=(2, 24))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(3),
                                jnp.asarray(ids))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    tcfg = GPTConfig.tiny(compute_dtype=torch.float32, dropout_rate=0.0,
                          attn_dropout_rate=0.0, tie_word_embeddings=False)
    model = GPTLM(tcfg)
    model.load_state_dict(sd)
    return cfg, params, sd, tcfg, model, ids


def test_untied_head_logits_and_loss_match_jax(untied):
    cfg, params, sd, _, model, ids = untied
    assert tuple(sd["head.kernel"].shape) == (cfg.hidden_size,
                                              cfg.vocab_size)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -3:] = -1
    with torch.no_grad():
        logits = model(torch.from_numpy(ids))
        _, loss = model(torch.from_numpy(ids), torch.from_numpy(labels))
    jm = JaxGPTLM(cfg)
    want = jm.apply({"params": params}, jnp.asarray(ids))
    _, jloss = jm.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(labels))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-4, rtol=0)


def test_untied_head_serves_like_jax(untied):
    """The untied head on the serving path: a paged decoder's greedy
    tokens equal JAX's ``reference_generate`` on the untied model."""
    cfg, params, sd, tcfg, _, ids = untied
    prompt = [int(t) for t in ids[0, :7]]
    dec = GPTDecoder(tcfg, sd, tokens_per_dispatch=K, spec_tokens=2,
                     spec_tree=2, device="cpu")
    assert dec.model._head is None
    eng = _engine(ServeEngine, dec, slots=1)
    assert _run(eng, [prompt], [9]) == [jax_reference(cfg, params, prompt, 9)]
