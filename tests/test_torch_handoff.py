"""apex_tpu_torch's KV handoff, streamed handoff, prefix migration and
live weight swaps vs the JAX package, on the CPU at ``GPTConfig.tiny``
fp32 (weights carried across with ``from_jax_params``).

- The wire, both ways: seeded containers at fp32, bf16 (``ml_dtypes`` on
  the JAX side) and int8 with scales, for both schemas, with and without
  a correlation id: the port's ``to_bytes`` is JAX's byte for byte, the
  port parses JAX's blobs without ``ml_dtypes`` and JAX parses the
  port's.
- JAX's ``TestHandoff`` (tests/test_paged_kv.py) on both frameworks: a
  prefill-only source holding an anchor and a duplicate whose slot maps
  shared, copy-on-written and partial pages; export, bytes, adopt,
  detach.  The headers equal apart from ``crc32``, the pages within
  1e-5, the refcounts and the tokens equal, and JAX's blob adopted by
  the port's engine decodes to JAX's ``reference_generate`` tokens.
  Damaged bytes raise; another geometry and a full destination return
  None with nothing imported.
- The streamed handoff: JAX's chunk sequence and None points, the
  commit's tokens, an abort, an out-of-order chunk, a damaged chunk and
  a swap during staging.
- Prefix migration: pool counts and refcounts after each call, JAX's
  refusals (unaligned, already registered, headroom), the prefix hit.
- ``swap_weights``: JAX's summaries apart from the digest and JAX's
  tokens; a leaf of the wrong shape raises before anything changes.
- The spans, instants and flight-recorder dumps of these scenarios equal
  JAX's (the dumps byte for byte).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import obs as jobs
from apex_tpu import serve as jserve
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.serve import handoff as jhandoff
from apex_tpu_torch import obs, serve
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.weights import from_jax_params

SLOTS, MAX_LEN, PAGE_LEN, K = 2, 64, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """See tests/test_torch_spec.py: one throwaway ``torch.exp``."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _seeded_params(cfg, seed: int):
    """GPT-2's init (normal(0, 0.02) kernels and embeddings, zero biases,
    unit LayerNorm scales) from a numpy seed over the JAX tree's shapes
    (``eval_shape``: nothing compiles)."""
    shapes = jax.eval_shape(JaxGPTLM(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            return jnp.zeros(s.shape, s.dtype)
        if name.endswith("['scale']"):
            return jnp.ones(s.shape, s.dtype)
        return jnp.asarray(0.02 * rng.randn(*s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def lm():
    """The JAX config, two seeded JAX weight trees (the served and the
    swapped-in), their state dicts, the token pool, and per-framework
    decoders and ``reference_generate`` (memoized)."""
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 64))
    params = [_seeded_params(cfg, s) for s in (0, 1)]
    sds = [from_jax_params(jax.tree_util.tree_map(np.asarray, p))
           for p in params]
    pcfg = GPTConfig.tiny(compute_dtype=torch.float32)
    memo = {}

    def ref(which, prompt, n):
        key = (which, tuple(prompt), n)
        if key not in memo:
            # one padded width: one compiled forward for every call
            memo[key] = jserve.reference_generate(
                cfg, params[which], list(prompt), n, pad_to=MAX_LEN)
        return memo[key]

    return {"cfg": cfg, "params": params, "sds": sds, "pool": ids[0],
            "ref": ref,
            "jax": jserve.GPTDecoder(cfg, params[0], tokens_per_dispatch=K),
            "port": serve.GPTDecoder(pcfg, sds[0], tokens_per_dispatch=K,
                                     device="cpu")}


SIDES = {"jax": (jserve, jobs, jhandoff), "port": (serve, obs, serve)}


def _engine(side, dec, **kw):
    pkg = SIDES[side][0]
    for key, val in (("slots", SLOTS), ("max_len", MAX_LEN),
                     ("page_len", PAGE_LEN), ("prefill_chunk", PAGE_LEN)):
        kw.setdefault(key, val)
    return pkg.ServeEngine(dec, paged=True, **kw)


def _telemetry(side):
    o = SIDES[side][1]
    return {"tracer": o.Tracer(enabled=True),
            "flightrec": o.FlightRecorder(capacity=4096, enabled=True)}


def _np(a):
    """A container array as numpy (fp32 here)."""
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _header(blob: bytes) -> dict:
    import json
    return json.loads(blob[:blob.index(b"\n")].decode())


def _slot_of(eng, uid):
    return next(s for s, r in eng._active.items() if r.uid == uid)


def _toks(pool, start, n):
    return [int(t) for t in pool[start:start + n]]


# -- the scenarios, each run on both frameworks ---------------------------------


def _prefilled_pair(side, dec, pool, tel):
    """JAX's ``TestHandoff._prefilled_pair``: a prefill-only source with an
    anchor prompt and a duplicate that maps shared full pages, a
    copy-on-written tail and a partial tail."""
    prompt = _toks(pool, 0, 11)  # pages 8 | 3: a partial tail
    src = _engine(side, dec, prefill_only=True, **tel)
    ua = src.submit(prompt, max_new_tokens=8)
    for _ in range(3):
        src.step()
    ub = src.submit(list(prompt), max_new_tokens=8)
    for _ in range(3):
        src.step()
    return src, prompt, ua, ub


def _monolithic(side, dec, pool):
    tel = _telemetry(side)
    src, prompt, ua, ub = _prefilled_pair(side, dec, pool, tel)
    pages_b = src.pool.slot_pages(_slot_of(src, ub))
    refs_before = [int(src.pool.ref[p]) for p in pages_b]
    ho = src.export_handoff(ub)
    refs_after = [int(src.pool.ref[p]) for p in pages_b]
    blob = ho.to_bytes()
    back = SIDES[side][2].KVHandoff.from_bytes(blob)
    dst = _engine(side, dec, **tel)
    iu = dst.adopt(back, max_new_tokens=8)
    pages_d = dst.pool.slot_pages(_slot_of(dst, iu))
    dst_refs = [int(dst.pool.ref[p]) for p in pages_d]
    src.detach(ub)
    anchor_refs = [int(src.pool.ref[p])
                   for p in src.pool.slot_pages(_slot_of(src, ua))]
    out = dst.run()
    tel["tracer"].close()
    return {"prompt": prompt, "blob": blob, "k": _np(ho.k), "v": _np(ho.v),
            "n_pages": ho.n_pages, "length": ho.length,
            "seed": list(ho.seed_tokens), "refs": (refs_before, refs_after),
            "dst_refs": dst_refs, "anchor_refs": anchor_refs,
            "tokens": out[iu], "src_windows": src.decode_dispatches,
            "dst_chunks": dst.prefill_dispatches,
            "prefix_hits": src.pool.prefix_hits,
            "cow": src.pool.cow_copies, **tel}


def _streamed(side, dec, pool, new_sd):
    """A 40-token prompt (5 pages) chunk-prefilled 8 tokens a boundary on
    a prefill-only source, each full page streamed as it lands (the last
    held back for the tail), staged and committed on the destination;
    then the planted faults and a swap during staging."""
    tel = _telemetry(side)
    hp = SIDES[side][2]
    prompt = _toks(pool, 10, 40)
    src = _engine(side, dec, prefill_only=True, **tel)
    uid = src.submit(prompt, max_new_tokens=6)
    trace, chunks, nxt, seq = [], [], 0, 0
    for step in range(12):
        src.step()
        prog = src.prefill_progress(uid)
        c = src.export_prefill_chunk(uid, nxt, seq)
        if c is None:
            trace.append((step, prog, None))
        else:
            trace.append((step, prog, (c.seq, c.page_offset, c.n_pages)))
            chunks.append(c)
            nxt += c.n_pages
            seq += 1
        if prog is None:
            break
    tail = src.export_handoff_tail(uid, nxt, seq)
    dst = _engine(side, dec, **tel)
    stage = dst.adopt_stage_begin()
    staged = [dst.adopt_stage_chunk(
        stage, hp.KVHandoffChunk.from_bytes(c.to_bytes())) for c in chunks]
    in_use_staged = dst.pool.in_use
    iu = dst.adopt_stage_commit(
        stage, hp.KVHandoffChunk.from_bytes(tail.to_bytes()),
        max_new_tokens=6)
    tokens = dst.run()[iu]
    # planted: a damaged chunk, an out-of-order chunk, an abort
    blob = bytearray(chunks[0].to_bytes())
    blob[-5] ^= 0x01
    try:
        hp.KVHandoffChunk.from_bytes(bytes(blob))
        damaged = "parsed"
    except hp.HandoffError as e:
        damaged = str(e)
    before = dst.pool.in_use
    stage = dst.adopt_stage_begin()
    out_of_order = dst.adopt_stage_chunk(stage, chunks[1])
    first = dst.adopt_stage_chunk(stage, chunks[0])
    repeated = dst.adopt_stage_chunk(stage, chunks[0])
    mid = dst.pool.in_use
    dst.adopt_stage_abort(stage)
    aborted = (before, mid, dst.pool.in_use, dst.alloc.n_free)
    tel["tracer"].close()
    # a swap to changed weights aborts the stage in flight (an engine of
    # its own: the swap's instant and record carry the digest, which
    # differs between the frameworks)
    dst = _engine(side, dec)
    stage = dst.adopt_stage_begin()
    dst.adopt_stage_chunk(stage, chunks[0])
    staged_in_use = dst.pool.in_use
    summary = dst.swap_weights(new_sd)
    summary.pop("digest")
    return {"prompt": prompt, "trace": trace, "staged": staged,
            "in_use_staged": in_use_staged, "tokens": tokens,
            "tail": (tail.seq, tail.page_offset, tail.n_pages, tail.length,
                     list(tail.seed_tokens)),
            "chunk_k": [_np(c.k) for c in chunks] + [_np(tail.k)],
            "damaged": damaged, "out_of_order": out_of_order,
            "first": first, "repeated": repeated, "aborted": aborted,
            "swap": (staged_in_use, summary, dst.pool.in_use,
                     dst.alloc.n_free, dict(dst._staging)), **tel}


def _prefix(side, dec, pool):
    """A request with a 16-token (2-page) prefix on the source, its
    prefix exported while it is live and imported on the destination
    ahead of demand, the refusals, a request that hits it there, and the
    anchor's release."""
    tel = _telemetry(side)
    prefix = _toks(pool, 20, 16)
    src = _engine(side, dec, **tel)
    src.submit(prefix + _toks(pool, 40, 4), max_new_tokens=30)
    while not src._active:
        src.step()
    chunk = src.export_prefix(prefix)
    unaligned_export = src.export_prefix(prefix[:12])
    dst = _engine(side, dec, **tel)
    pool0 = (dst.pool.in_use, dst.pool.n_free)
    pages = dst.import_prefix(chunk, prefix)
    after = (dst.pool.in_use, dst.pool.n_free,
             [int(dst.pool.ref[p]) for p in pages])
    again = dst.import_prefix(chunk, prefix)
    unaligned = dst.import_prefix(chunk, prefix[:12])
    tight = _engine(side, dec, num_pages=1 + MAX_LEN // PAGE_LEN + 1, **tel)
    headroom = tight.import_prefix(chunk, prefix)
    prompt = prefix + _toks(pool, 50, 5)
    uid = dst.submit(prompt, max_new_tokens=5)
    tokens = dst.run()[uid]
    hits = (dst.pool.prefix_hits, dst.pool.prefix_hit_tokens)
    held = (dst.pool.in_use, [int(dst.pool.ref[p]) for p in pages])
    dst.release_prefix(pages)
    released = (dst.pool.in_use, dst.pool.n_free)
    tel["tracer"].close()
    return {"pages": len(pages), "k": _np(chunk.k), "pool0": pool0,
            "after": after, "again": again, "unaligned": unaligned,
            "unaligned_export": unaligned_export, "headroom": headroom,
            "tight_free": tight.pool.n_free, "prompt": prompt,
            "tokens": tokens, "hits": hits, "held": held,
            "released": released, **tel}


SWAP_PROMPTS = [(0, 10, 12), (3, 17, 10), (5, 4, 6)]  # (start, len, budget)


def _swap(side, dec, pool, same, new):
    """Three requests on two slots: an identical-digest swap after two
    boundaries, a changed-weights swap two boundaries later (the tokens
    so far of each request then), the run to the end."""
    eng = _engine(side, dec)
    uids = [eng.submit(_toks(pool, s, n), max_new_tokens=b)
            for s, n, b in SWAP_PROMPTS]
    for _ in range(2):
        eng.step()
    s_same = eng.swap_weights(same)
    for _ in range(2):
        eng.step()
    before = {u: list(t) for u, (t, _) in eng.progress().items()}
    inflight = len(eng._active) + len(eng._prefilling)
    s_new = eng.swap_weights(new)
    out = eng.run()
    return {"same": s_same, "new": s_new, "inflight": inflight,
            "before": [before[u] for u in uids],
            "tokens": [out[u] for u in uids],
            "swaps": eng.obs_registry.snapshot()}


@pytest.fixture(scope="module")
def runs(lm):
    """Every scenario on both frameworks: {(scenario, side): result}."""
    out = {}
    for side in ("jax", "port"):
        dec = lm[side]
        same, new = ((lm["params"][0], lm["params"][1]) if side == "jax"
                     else (lm["sds"][0], lm["sds"][1]))
        out["mono", side] = _monolithic(side, dec, lm["pool"])
        out["stream", side] = _streamed(side, dec, lm["pool"], new)
        out["prefix", side] = _prefix(side, dec, lm["pool"])
        out["swap", side] = _swap(side, dec, lm["pool"], same, new)
    return out


def _events(tracer):
    return [(kind, name, payload) for _, kind, name, payload in tracer.events]


def _spans(tracer):
    return [(sp.name, sp.depth, sp.attrs) for sp in tracer.spans]


# -- the wire ------------------------------------------------------------------


def _seeded_arrays(dtype: str, shape=(3, 2, 4, 8, 16)):
    """(JAX's numpy arrays, the port's tensors) with the same bytes: k,
    v, and the scales on int8."""
    rng = np.random.RandomState({"float32": 1, "bfloat16": 2, "int8": 3}
                                [dtype])
    out_j, out_p = [], []
    for _ in range(2):
        a = rng.randn(*shape).astype(np.float32)
        if dtype == "bfloat16":
            bits = (a.view(np.uint32) >> 16).astype(np.uint16)
            out_j.append(bits.view(ml_dtypes.bfloat16))
            out_p.append(torch.from_numpy(bits.view(np.int16).copy())
                         .view(torch.bfloat16))
        elif dtype == "int8":
            x = rng.randint(-127, 128, size=shape).astype(np.int8)
            out_j.append(x)
            out_p.append(torch.from_numpy(x.copy()))
        else:
            out_j.append(a)
            out_p.append(torch.from_numpy(a.copy()))
    if dtype == "int8":
        for _ in range(2):
            s = rng.rand(*shape[:4]).astype(np.float32) + 0.1
            out_j.append(s)
            out_p.append(torch.from_numpy(s.copy()))
    else:
        out_j += [None, None]
        out_p += [None, None]
    return out_j, out_p


def _container(mod, schema, arrays, corr):
    k, v, ks, vs = arrays
    if schema == "handoff":
        return mod.KVHandoff([5, 6, 7], [8, 9], 40, 16, k, v, ks, vs,
                             corr=corr)
    return mod.KVHandoffChunk(3, 2, 16, k, v, ks, vs, tokens=[1, 2],
                              seed_tokens=[4], length=70, corr=corr)


def _bytes_of(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


class TestWire:
    @pytest.mark.parametrize("corr", [None, "req-7"])
    @pytest.mark.parametrize("schema", ["handoff", "chunk"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    def test_bytes_equal_jax_both_ways(self, dtype, schema, corr, recwarn):
        aj, ap = _seeded_arrays(dtype)
        jblob = _container(jhandoff, schema, aj, corr).to_bytes()
        pc = _container(serve, schema, ap, corr)
        assert pc.to_bytes() == jblob
        cls = serve.KVHandoff if schema == "handoff" else serve.KVHandoffChunk
        parsed = cls.from_bytes(jblob)
        assert parsed.to_bytes() == jblob
        assert parsed.k.dtype == pc.k.dtype and parsed.corr == corr
        assert parsed.payload_bytes == pc.payload_bytes
        jcls = (jhandoff.KVHandoff if schema == "handoff"
                else jhandoff.KVHandoffChunk)
        back = jcls.from_bytes(pc.to_bytes())
        for got, want in zip((back.k, back.v, back.k_scale, back.v_scale),
                             aj):
            assert _bytes_of(got) == _bytes_of(want)
            if want is not None:
                assert got.dtype == want.dtype and got.shape == want.shape
        assert str(back.k.dtype) == dtype
        assert not [w for w in recwarn if "not writable" in str(w.message)]

    @pytest.mark.parametrize("side", ["port", "jax"])
    @pytest.mark.parametrize("schema", ["handoff", "chunk"])
    def test_damage_raises(self, schema, side):
        mod = SIDES[side][2]
        arrays = _seeded_arrays("int8")[side == "port"]
        blob = _container(mod, schema, arrays, None).to_bytes()
        cls = mod.KVHandoff if schema == "handoff" else mod.KVHandoffChunk
        other = mod.KVHandoffChunk if schema == "handoff" else mod.KVHandoff
        with pytest.raises(mod.HandoffError, match="CRC"):
            cls.from_bytes(blob[:-8] + b"XXXXXXXX")
        with pytest.raises(mod.HandoffError):
            cls.from_bytes(blob[:len(blob) // 2])
        with pytest.raises(mod.HandoffError, match="schema"):
            other.from_bytes(blob)
        with pytest.raises(mod.HandoffError):
            cls.from_bytes(b"not a handoff at all")

    def test_validation_raises_where_jax_does(self):
        _, (k, v, _, _) = _seeded_arrays("float32")
        for kw in ({"k": k, "v": v[:2]}, {"k": k, "v": v, "length": 0},
                   {"k": k, "v": v, "length": 49},
                   {"k": k, "v": v, "seed_tokens": []}):
            args = dict(tokens=[1], seed_tokens=[2], length=40, page_len=16)
            args.update(kw)
            with pytest.raises(serve.HandoffError):
                serve.KVHandoff(**args)
        for kw in ({"seq": -1}, {"k": k[:0], "v": v[:0]},
                   {"length": 1, "seed_tokens": None},
                   {"length": 3 * 16 + 1, "seed_tokens": [1]}):
            args = dict(seq=0, page_offset=0, page_len=16, k=k, v=v)
            args.update(kw)
            with pytest.raises(serve.HandoffError):
                serve.KVHandoffChunk(**args)
        # a final chunk may carry no page
        last = serve.KVHandoffChunk(4, 3, 16, k[:0], v[:0], tokens=[1],
                                    seed_tokens=[2], length=40)
        assert serve.KVHandoffChunk.from_bytes(last.to_bytes()).n_pages == 0


# -- the monolithic handoff ------------------------------------------------------


class TestHandoff:
    def test_round_trip_shared_cow_partial(self, runs, lm):
        got, want = runs["mono", "port"], runs["mono", "jax"]
        assert got["prefix_hits"] == 1 and got["cow"] >= 1
        assert got["refs"][0] == got["refs"][1] == want["refs"][0]
        assert got["length"] == len(got["prompt"]) and got["n_pages"] == 2
        assert got["seed"] == want["seed"] and len(got["seed"]) == 1
        assert got["dst_refs"] == want["dst_refs"] == [1, 1]
        assert got["anchor_refs"] == want["anchor_refs"] == [1, 1]
        assert got["tokens"] == want["tokens"] == \
            lm["ref"](0, got["prompt"], 8)

    def test_headers_and_pages_equal_jax(self, runs):
        got, want = runs["mono", "port"], runs["mono", "jax"]
        hg, hw = _header(got["blob"]), _header(want["blob"])
        hg.pop("crc32"), hw.pop("crc32")
        assert hg == hw and hg["dtype"] == "float32"
        for kv in ("k", "v"):
            np.testing.assert_allclose(got[kv], want[kv], atol=1e-5, rtol=0)

    def test_prefill_only_never_decodes(self, runs):
        for side in ("port", "jax"):
            r = runs["mono", side]
            assert r["src_windows"] == 0 and r["dst_chunks"] == 0, side

    def test_jax_blob_adopted_by_the_port(self, runs, lm):
        want = runs["mono", "jax"]
        ho = serve.KVHandoff.from_bytes(want["blob"])
        dst = _engine("port", lm["port"])
        uid = dst.adopt(ho, max_new_tokens=8)
        assert uid is not None
        assert dst.run()[uid] == lm["ref"](0, want["prompt"], 8)
        assert dst.obs_registry.snapshot()["serve.adoptions"]["value"] == 1

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_geometry_mismatch_falls_back(self, runs, lm, side):
        ho = SIDES[side][2].KVHandoff.from_bytes(runs["mono", side]["blob"])
        for kw in ({"page_len": 16}, {}):
            dst = _engine(side, lm[side], **kw)
            if not kw:  # the right page_len, a pool of another dtype
                if side == "port":
                    dst.cache.k = dst.cache.k.to(torch.bfloat16)
                else:
                    dst.cache = dst.cache._replace(
                        k=dst.cache.k.astype(jnp.bfloat16))
            assert dst.adopt(ho, max_new_tokens=8) is None
            assert dst.pool.in_use == 0 and dst.alloc.n_free == SLOTS
        dst = _engine(side, lm[side])
        assert dst.adopt(ho, max_new_tokens=1) is None  # the seed spends it
        assert dst.adopt(ho, max_new_tokens=8, corr="c9") is not None
        assert dst._active[0].corr == "c9"

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_capacity_exhaustion_falls_back(self, runs, lm, side):
        ho = SIDES[side][2].KVHandoff.from_bytes(runs["mono", side]["blob"])
        pool = lm["pool"]
        dst = _engine(side, lm[side])
        dst.submit(_toks(pool, 0, 9), max_new_tokens=30)
        dst.submit(_toks(pool, 9, 11), max_new_tokens=30)
        dst.step()  # both slots taken
        assert dst.adopt(ho, max_new_tokens=8) is None
        dst2 = _engine(side, lm[side])
        reserved = dst2.pool.reserve(dst2.pool.n_free - 1)
        in_use = dst2.pool.in_use
        assert dst2.adopt(ho, max_new_tokens=8) is None
        assert dst2.pool.in_use == in_use and dst2.alloc.n_free == SLOTS
        dst2.pool.unreserve(reserved)


# -- the streamed handoff --------------------------------------------------------


class TestStreamed:
    def test_chunk_sequence_and_none_points_equal_jax(self, runs):
        got, want = runs["stream", "port"], runs["stream", "jax"]
        assert got["trace"] == want["trace"]
        assert [t[2] for t in got["trace"] if t[2]] == \
            [(0, 0, 1), (1, 1, 1), (2, 2, 1), (3, 3, 1)]
        assert got["tail"] == want["tail"] and got["tail"][:3] == (4, 4, 1)
        for a, b in zip(got["chunk_k"], want["chunk_k"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)

    def test_commit_tokens_equal_jax_and_reference(self, runs, lm):
        got, want = runs["stream", "port"], runs["stream", "jax"]
        assert got["staged"] == want["staged"] == [True] * 4
        assert got["in_use_staged"] == want["in_use_staged"] == 4
        assert got["tokens"] == want["tokens"] == \
            lm["ref"](0, got["prompt"], 6)

    def test_planted_faults_and_abort(self, runs):
        got, want = runs["stream", "port"], runs["stream", "jax"]
        assert "CRC" in got["damaged"] and "CRC" in want["damaged"]
        assert (got["out_of_order"], got["first"], got["repeated"]) == \
            (want["out_of_order"], want["first"], want["repeated"]) == \
            (False, True, False)
        assert got["aborted"] == want["aborted"] == (0, 1, 0, SLOTS)

    def test_swap_during_staging_aborts(self, runs):
        got, want = runs["stream", "port"], runs["stream", "jax"]
        assert got["swap"] == want["swap"]
        staged, summary, in_use, free, staging = got["swap"]
        assert staged == 1 and in_use == 0 and free == SLOTS and not staging
        assert not summary["identical"] and summary["recomputed"] == 0


# -- prefix migration -------------------------------------------------------------


class TestPrefixMigration:
    def test_pool_counts_equal_jax(self, runs):
        got, want = runs["prefix", "port"], runs["prefix", "jax"]
        for key in ("pages", "pool0", "after", "held", "released",
                    "tight_free", "hits"):
            assert got[key] == want[key], key
        assert got["after"] == (2, 2 * 8 - 2, [1, 1])
        assert got["held"] == (2, [1, 1])  # the anchor outlives the request
        assert got["released"] == got["pool0"]
        np.testing.assert_allclose(got["k"], want["k"], atol=1e-5, rtol=0)

    def test_refusals_equal_jax(self, runs):
        for side in ("port", "jax"):
            r = runs["prefix", side]
            assert r["again"] is None and r["unaligned"] is None, side
            assert r["headroom"] is None and r["unaligned_export"] is None

    def test_hit_and_tokens(self, runs, lm):
        got, want = runs["prefix", "port"], runs["prefix", "jax"]
        assert got["hits"] == (1, 16)
        assert got["tokens"] == want["tokens"] == \
            lm["ref"](0, got["prompt"], 5)


# -- live weight swaps ------------------------------------------------------------


def _without_digest(s):
    return {k: v for k, v in s.items() if k != "digest"}


class TestSwapWeights:
    def test_summaries_equal_jax(self, runs):
        got, want = runs["swap", "port"], runs["swap", "jax"]
        assert _without_digest(got["same"]) == _without_digest(want["same"])
        assert _without_digest(got["new"]) == _without_digest(want["new"])
        assert got["same"]["identical"] and got["same"]["recomputed"] == 0
        assert not got["new"]["identical"]
        assert got["new"]["recomputed"] == got["inflight"] >= 1
        assert got["new"]["kept"] == 0
        assert got["same"]["digest"] != got["new"]["digest"]
        for name in ("serve.weight_swaps", "serve.swap_recomputed"):
            assert got["swaps"][name] == want["swaps"][name], name

    def test_tokens_equal_jax_and_the_new_weights(self, runs, lm):
        got, want = runs["swap", "port"], runs["swap", "jax"]
        assert got["before"] == want["before"]
        assert got["tokens"] == want["tokens"]
        for (s, n, b), before, tokens in zip(SWAP_PROMPTS, got["before"],
                                             got["tokens"]):
            prompt = _toks(lm["pool"], s, n)
            assert tokens[:len(before)] == before
            assert tokens[len(before):] == lm["ref"](
                1, prompt + before, b - len(before))

    def test_identical_swap_keeps_tokens(self, runs, lm):
        # the identical swap moved nothing: up to the changed swap the
        # requests streamed the served weights' tokens
        for (s, n, b), before in zip(SWAP_PROMPTS,
                                     runs["swap", "port"]["before"]):
            assert before == lm["ref"](0, _toks(lm["pool"], s, n), b)[
                :len(before)]

    @pytest.mark.parametrize("side", ["port", "jax"])
    def test_bad_leaf_raises_before_any_change(self, lm, side):
        dec = lm[side]
        eng = _engine(side, dec)
        for s, n, b in SWAP_PROMPTS:
            eng.submit(_toks(lm["pool"], s, n), max_new_tokens=b)
        for _ in range(3):
            eng.step()
        digest, queued = eng.weights_digest, len(eng._queue)
        active = {s: r.uid for s, r in eng._active.items()}
        if side == "port":
            bad = dict(lm["sds"][1])
            name = sorted(bad)[3]
            bad[name] = torch.zeros(tuple(bad[name].shape) + (1,))
            missing = {k: v for k, v in lm["sds"][1].items() if k != name}
            messages = ("geometry change", "keys differ")
        else:
            bad = jax.tree_util.tree_map(lambda x: x, lm["params"][1])
            bad["wpe"]["embedding"] = jnp.zeros((MAX_LEN, 1), jnp.float32)
            missing = {k: v for k, v in lm["params"][1].items()
                       if k != "wpe"}
            messages = ("geometry change", "structure differs")
        for tree, msg in zip((bad, missing), messages):
            with pytest.raises(ValueError, match=msg):
                eng.swap_weights(tree)
        assert eng.weights_digest == digest and len(eng._queue) == queued
        assert {s: r.uid for s, r in eng._active.items()} == active
        assert eng.decoder is dec
        assert eng.obs_registry.snapshot()["serve.weight_swaps"]["value"] == 0

    def test_with_params_clones(self, lm):
        dec = lm["port"]
        clone = dec.with_params(lm["sds"][1])
        assert clone.model is not dec.model and clone.params is lm["sds"][1]
        assert dec.params is lm["sds"][0]
        for name, want in lm["sds"][1].items():  # fp32: no cast
            assert torch.equal(clone.model.state_dict()[name], want), name
            assert torch.equal(dec.model.state_dict()[name],
                               lm["sds"][0][name]), name


# -- telemetry ---------------------------------------------------------------------


class TestTelemetry:
    @pytest.mark.parametrize("scenario", ["mono", "stream", "prefix"])
    def test_spans_instants_and_dumps_equal_jax(self, runs, scenario,
                                                 tmp_path):
        got, want = runs[scenario, "port"], runs[scenario, "jax"]
        assert _spans(got["tracer"]) == _spans(want["tracer"])
        assert _events(got["tracer"]) == _events(want["tracer"])
        a = got["flightrec"].dump(str(tmp_path / "port.jsonl"),
                                  reason=scenario)
        b = want["flightrec"].dump(str(tmp_path / "jax.jsonl"),
                                   reason=scenario)
        assert open(a).read() == open(b).read()
        kinds = got["flightrec"].kinds()
        want_kinds = {"mono": ("serve/adopt", "serve/detach"),
                      "stream": ("serve/adopt", "serve/adopt_abort"),
                      "prefix": ("serve/prefix_adopt",)}[scenario]
        assert all(kinds.get(k) for k in want_kinds), kinds
        names = got["tracer"].span_names()
        assert names.get("serve/handoff_export") or \
            names.get("serve/prefix_export")
