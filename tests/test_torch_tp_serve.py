"""Tensor-parallel serving in the port vs the JAX package, on the CPU at
``GPTConfig.tiny`` fp32 (weights carried across with ``from_jax_params``).

One gang of two gloo processes (this file run as a script, started by
the module fixture ``gang`` in a thread while the JAX side runs; one
thread a rank, a ``file://`` rendezvous, no JAX in the workers, a 120 s
join timeout), each rank running ``GPTDecoder(mesh=serve_mesh(2))`` on its
head shard, against JAX's ``GPTDecoder(mesh=serve_mesh(2))`` under
``shard_map`` on the conftest's virtual CPU devices:

- one mixed queue, larger than the slots, through the paged, contiguous,
  chain (n-gram, D = 3), tree ((2, 2)) and int8-paged engines: every
  rank's greedy tokens equal JAX's tensor-parallel engine's (and the
  port's one-rank engine's on the same rank);
- two chunks of a paged prefill: the logits within 1e-4 of JAX's, each
  rank's pool shard within 1e-5 of JAX's pool on that rank's heads;
- the collectives: exactly ``num_layers`` head all-reduces a forward
  (prefill chunks and window steps) and nothing else, and
  ``stats()["tensor_parallel"]`` a window's share; each rank's pool
  bytes exactly half the one-rank pool's;
- ``num_heads`` that do not divide by the axis raise, as in JAX;
- the KV handoff both ways: a rank-sharded prefill-only source exports
  every head (its head blocks all-gathered, counted under
  ``tp_handoff``) to a one-rank decode engine, and a one-rank source's
  containers are adopted by a rank-sharded decode engine, each rank
  taking its head block.  The tokens equal JAX's tensor-parallel
  handoff's both ways, the containers' headers equal JAX's apart from
  the CRC and their pages within 1e-5, and the sharded source's blobs
  are the one-rank source's byte for byte.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

W = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
SLOTS, MAX_LEN, PAGE_LEN, K, CHUNK = 2, 64, 8, 4, 8
QUEUE = [(0, 3), (2, 9), (5, 5), (1, 12)]   # (start, length) in the pool
BUDGETS = [6, 13, 4, 9]
#: engine name -> decoder keywords (on top of K) and ServeEngine(paged=)
ENGINES = {
    "paged": ({}, True),
    "contiguous": ({}, False),
    "chain": ({"spec_tokens": 3}, True),
    "tree": ({"spec_tokens": 2, "spec_tree": 2}, True),
    "int8": ({"kv_int8": True}, True),
}

if __name__ != "__main__":  # the gang's workers import no JAX
    import jax
    import jax.numpy as jnp

    from apex_tpu.models.gpt import GPTConfig as JaxConfig
    from apex_tpu.models.gpt import GPTLM as JaxGPTLM
    from apex_tpu.serve import GPTDecoder as JaxDecoder
    from apex_tpu.serve import KVHandoff as JaxKVHandoff
    from apex_tpu.serve import ServeEngine as JaxEngine
    from apex_tpu.serve import serve_mesh as jax_serve_mesh
    from apex_tpu_torch.weights import from_jax_params


def _prompts(pool):
    return [[int(t) for t in pool[s:s + n]] for s, n in QUEUE]


def _engine(cls, dec, paged):
    kw = dict(slots=SLOTS, max_len=MAX_LEN, paged=paged)
    if paged:
        kw.update(page_len=PAGE_LEN, prefill_chunk=CHUNK)
    return cls(dec, **kw)


def _run(eng, prompts):
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, BUDGETS)]
    out = eng.run()
    return [out[u] for u in uids]


def _handoff(eng_cls, ho_cls, src_dec, dst_dec, prompts):
    """Each prompt chunk-prefilled on a prefill-only source, exported
    whole through bytes and detached there, and adopted by a decode
    engine (whose windows run while its slots are full); then the decode
    engine drains.  Returns (the blobs, the tokens by prompt)."""
    src = eng_cls(src_dec, slots=SLOTS, max_len=MAX_LEN, paged=True,
                  page_len=PAGE_LEN, prefill_chunk=CHUNK, prefill_only=True)
    dst = _engine(eng_cls, dst_dec, True)
    blobs, uids = [], []
    for p, n in zip(prompts, BUDGETS):
        u = src.submit(p, max_new_tokens=n)
        while not src._active:
            src.step()
        blobs.append(src.export_handoff(u).to_bytes())
        src.detach(u)
        for _ in range(64):
            uid = dst.adopt(ho_cls.from_bytes(blobs[-1]), max_new_tokens=n)
            if uid is not None:
                break
            dst.step()
        uids.append(uid)
    out = dst.run()
    return blobs, [out[u] for u in uids]


def _chunks(pool):
    """Two chunks of a paged prefill of two slots: ids (2, C), base and
    valid a chunk."""
    ids = np.asarray(pool[:2 * 2 * CHUNK], np.int32).reshape(2, 2, CHUNK)
    return [(ids[:, 0], [0, 0], [CHUNK, CHUNK - 3]),
            (ids[:, 1], [CHUNK, CHUNK - 3], [5, CHUNK])]


# -- the gang's side: each rank, torch only ------------------------------------


def _case_engines(sd, pool, mesh):
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.parallel import (collective_counts,
                                         reset_collective_counts)
    from apex_tpu_torch.serve import GPTDecoder, ServeEngine
    cfg = GPTConfig.tiny(compute_dtype=torch.float32)
    out = {}
    for name, (kw, paged) in ENGINES.items():
        dec = GPTDecoder(cfg, sd, tokens_per_dispatch=K, device="cpu",
                         mesh=mesh, **kw)
        one = GPTDecoder(cfg, sd, tokens_per_dispatch=K, device="cpu", **kw)
        reset_collective_counts()
        eng = _engine(ServeEngine, dec, paged)
        tokens = _run(eng, _prompts(pool))
        counts = collective_counts()
        one_eng = _engine(ServeEngine, one, paged)
        st = eng.stats()
        out[name] = {
            "tokens": tokens, "one_rank": _run(one_eng, _prompts(pool)),
            "counts": counts, "tp": st["tensor_parallel"],
            "prefill_dispatches": st["prefill_dispatches"],
            "decode_dispatches": st["decode_dispatches"],
            "bytes": (eng.cache.k.numel() * eng.cache.k.element_size(),
                      one_eng.cache.k.numel()
                      * one_eng.cache.k.element_size()),
            "spec_steps": dec.spec_steps if dec.spec_enabled else K}
    return out


def _case_chunks(sd, pool, mesh):
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.serve import GPTDecoder
    dec = GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                     device="cpu", mesh=mesh)
    cache = dec.init_paged_cache(1 + 2 * 4, 2, PAGE_LEN)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    logits = [dec.prefill_chunk(cache, tables, [0, 1], ids, base, valid)
              .numpy().copy() for ids, base, valid in _chunks(pool)]
    return {"logits": logits, "k": cache.k.numpy().copy(),
            "v": cache.v.numpy().copy()}


def _case_handoff(sd, pool, mesh):
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.parallel import (collective_counts,
                                         reset_collective_counts)
    from apex_tpu_torch.serve import GPTDecoder, KVHandoff, ServeEngine
    cfg = GPTConfig.tiny(compute_dtype=torch.float32)
    tp = GPTDecoder(cfg, sd, tokens_per_dispatch=K, device="cpu", mesh=mesh)
    one = GPTDecoder(cfg, sd, tokens_per_dispatch=K, device="cpu")
    out = {}
    for name, src, dst in (("tp_to_one", tp, one), ("one_to_tp", one, tp)):
        reset_collective_counts()
        blobs, tokens = _handoff(ServeEngine, KVHandoff, src, dst,
                                 _prompts(pool))
        out[name] = {"blobs": blobs, "tokens": tokens,
                     "counts": collective_counts()}
    return out


def _case_raise(sd, mesh):
    import dataclasses
    from apex_tpu_torch.models import GPTConfig
    from apex_tpu_torch.serve import GPTDecoder
    cfg = dataclasses.replace(GPTConfig.tiny(compute_dtype=torch.float32),
                              num_heads=1)
    try:
        GPTDecoder(cfg, sd, device="cpu", mesh=mesh)
    except ValueError as err:
        return str(err)
    return None


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import init_distributed
    from apex_tpu_torch.serve import serve_mesh
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    sd, pool = inp["sd"], inp["pool"]
    mesh = serve_mesh(W)
    results = {"engines": _case_engines(sd, pool, mesh),
               "chunks": _case_chunks(sd, pool, mesh),
               "handoff": _case_handoff(sd, pool, mesh),
               "raise": _case_raise(sd, mesh)}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang beside JAX -------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """See tests/test_torch_spec.py: one throwaway ``torch.exp``."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture(scope="module")
def lm():
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 40))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return cfg, params, sd, ids[0]


@pytest.fixture(scope="module")
def both(tmp_path_factory, lm):
    """(the gang's results by rank, JAX's) — the gang runs in a thread
    while JAX compiles and runs its engines."""
    from apex_tpu_torch.parallel import launch
    cfg, params, sd, pool = lm
    out = tmp_path_factory.mktemp("tp_serve_gang")
    torch.save({"sd": sd, "pool": pool}, out / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    err = []

    def go():
        try:
            launch([os.path.abspath(__file__), str(out)], W, env=env,
                   timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
        except Exception as e:  # raised again below, in the test thread
            err.append(e)

    th = threading.Thread(target=go)
    th.start()
    mesh = jax_serve_mesh(W)
    want = {}
    for name, (kw, paged) in ENGINES.items():
        dec = JaxDecoder(cfg, params, tokens_per_dispatch=K, mesh=mesh, **kw)
        want[name] = _run(_engine(JaxEngine, dec, paged), _prompts(pool))
    dec = JaxDecoder(cfg, params, mesh=mesh)
    cache = dec.init_paged_cache(1 + 2 * 4, 2, PAGE_LEN)
    tables = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    logits = []
    for ids, base, valid in _chunks(pool):
        cache, lg = dec.prefill_chunk(cache, tables, [0, 1], ids, base,
                                      valid)
        logits.append(np.asarray(lg))
    want["chunks"] = {"logits": logits, "k": np.asarray(cache.k),
                      "v": np.asarray(cache.v)}
    tp = JaxDecoder(cfg, params, tokens_per_dispatch=K, mesh=mesh)
    one = JaxDecoder(cfg, params, tokens_per_dispatch=K)
    want["handoff"] = {
        name: _handoff(JaxEngine, JaxKVHandoff, src, dst, _prompts(pool))
        for name, src, dst in (("tp_to_one", tp, one), ("one_to_tp", one,
                                                        tp))}
    th.join()
    if err:
        raise err[0]
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(W)]
    return got, want


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_tokens_equal_jax_tensor_parallel(both, name):
    got, want = both
    for r in range(W):
        assert got[r]["engines"][name]["tokens"] == want[name], (name, r)
        assert got[r]["engines"][name]["one_rank"] == want[name], (name, r)


def test_prefill_logits_and_pool_shards_match_jax(both):
    got, want = both
    w = want["chunks"]
    heads = w["k"].shape[2] // W
    for r in range(W):
        g = got[r]["chunks"]
        for a, b in zip(g["logits"], w["logits"]):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
        for kv in ("k", "v"):
            assert g[kv].shape[2] == heads
            np.testing.assert_allclose(
                g[kv], w[kv][:, :, r * heads:(r + 1) * heads], atol=1e-5,
                rtol=0)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_head_all_reduces_are_exact(both, name):
    """num_layers all-reduces a forward: a prefill chunk, a plain
    window's K steps, a spec window's verify steps; nothing else."""
    layers = 2
    for r in range(W):
        e = both[0][r]["engines"][name]
        per_window = layers * e["spec_steps"]
        forwards = e["prefill_dispatches"]  # one forward a dispatch
        assert set(e["counts"]) == {"tp_heads"}
        assert e["tp"]["all_reduces_last_window"] == per_window
        assert e["tp"]["all_reduces_windows"] == \
            per_window * e["decode_dispatches"]
        assert e["counts"]["tp_heads"] == \
            layers * forwards + per_window * e["decode_dispatches"]
        assert e["tp"]["degree"] == W


def test_pool_bytes_are_half_a_rank(both):
    for r in range(W):
        for name, e in both[0][r]["engines"].items():
            assert e["bytes"][0] * W == e["bytes"][1], name


def _header(blob: bytes) -> dict:
    import json
    head = json.loads(blob[:blob.index(b"\n")].decode())
    head.pop("crc32")
    return head


@pytest.mark.parametrize("leg", ["tp_to_one", "one_to_tp"])
def test_handoff_equals_jax_tensor_parallel(both, leg):
    got, want = both
    blobs, tokens = want["handoff"][leg]
    for r in range(W):
        g = got[r]["handoff"][leg]
        assert g["tokens"] == tokens, (leg, r)
        assert g["blobs"] == got[0]["handoff"][leg]["blobs"]
        for a, b in zip(g["blobs"], blobs):
            assert _header(a) == _header(b)
            ha, hb = JaxKVHandoff.from_bytes(a), JaxKVHandoff.from_bytes(b)
            assert ha.k.shape[2] == 2  # every head of the model
            for x, y in ((ha.k, hb.k), (ha.v, hb.v)):
                np.testing.assert_allclose(x, y, atol=1e-5, rtol=0)
    assert tokens == want["paged"]  # JAX's handoff: its engine's tokens
    # a sharded source's containers are the one-rank source's bit for bit
    assert got[0]["handoff"]["tp_to_one"]["blobs"] == \
        got[0]["handoff"]["one_to_tp"]["blobs"]


def test_handoff_collectives_have_their_own_tag(both):
    """Each sharded export all-gathers k and v once (``tp_handoff``); the
    one-rank source exports with none, and the head all-reduces stay
    ``tp_heads``."""
    for r in range(W):
        e = both[0][r]["handoff"]
        assert e["tp_to_one"]["counts"]["tp_handoff"] == 2 * len(QUEUE)
        assert "tp_handoff" not in e["one_to_tp"]["counts"]
        assert set(e["one_to_tp"]["counts"]) == {"tp_heads"}


def test_heads_that_do_not_divide_raise(both):
    for r in range(W):
        assert "not divisible" in both[0][r]["raise"]


if __name__ == "__main__":
    _worker(sys.argv[1])
