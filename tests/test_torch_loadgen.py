"""apex_tpu_torch's load generator and engine telemetry vs the JAX
package, on the CPU.

- ``TrafficPlan.from_seed(...).to_json()`` is byte-identical between the
  two packages, for three seeds (bursty with shared prefixes and
  size-assigned priorities; Poisson with deadlines; bursty with weighted
  priorities).
- The slice test: one 12-request plan through JAX's ``ServeEngine`` and
  the port's, on a ``VirtualClock``, with the same carried
  ``GPTConfig.tiny`` fp32 weights, under FIFO and under SLO-aware
  admission (a 3-slot engine on a 9-page pool, tight TTFT and ITL
  objectives: the run overtakes a starved head, yields prefill
  boundaries and preempts).  The ``LoadReport``s are equal byte for
  byte (no field differs by design), so are the tokens per uid, the
  flight-recorder dumps, the spans (names, depth, attrs, in order), the
  instants and counters, the metrics registries' whole snapshots, and
  the ``stats()`` keys both engines have.
  SLO-aware admission streams FIFO's tokens per uid.
- Two port runs of a plan give byte-identical reports; the harness
  refuses an engine on another clock and targets whose modules are not
  ported yet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import obs as jobs
from apex_tpu import serve as jserve
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu_torch import obs, serve
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.weights import from_jax_params

#: the SLO leg: objectives every TTFT past 2 boundaries and every
#: inter-token gap violates, so both alerts trip early
SLO_OBJECTIVES = ("ttft_ms p99 < 12 over 0.5s", "itl_ms p90 < 1 over 0.5s")


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture(scope="module")
def decoders():
    """(JAX cfg, JAX K=4 decoder, the port's K=4 decoder on the CPU) with
    the same weights."""
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 16))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    port = serve.GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                            tokens_per_dispatch=4, device="cpu")
    return cfg, jserve.GPTDecoder(cfg, params, tokens_per_dispatch=4), port


def _plan(pkg, seed=5, **kw):
    base = dict(requests=12, rate_rps=150.0, arrival="bursty",
                burst_factor=6.0, burst_on_s=0.1, burst_off_s=0.3,
                vocab_size=97, n_prefixes=3, prefix_len=6, zipf_s=1.2,
                shared_frac=0.5, prompt_min=2, prompt_scale=4.0,
                prompt_alpha=1.2, prompt_cap=30, output_min=2,
                output_scale=3.0, output_alpha=1.3, output_cap=10,
                priorities=(0, 2), priority_weights=(0.8, 0.2))
    base.update(kw)
    return pkg.TrafficPlan.from_seed(seed, **base)


def _leg(pkg, o, dec, vocab, slo_on):
    """One run of the slice plan: (report, engine, tracer, recorder)."""
    gen = pkg.LoadGen(_plan(pkg, vocab_size=vocab), step_cost_ms=5.0)
    tracker = (o.SloTracker(list(SLO_OBJECTIVES), clock=gen.clock,
                            enabled=True) if slo_on else None)
    tracer = o.Tracer(enabled=True)
    fr = o.FlightRecorder(capacity=4096, enabled=True)
    eng = pkg.ServeEngine(dec, slots=3, max_len=64, paged=True, page_len=8,
                          num_pages=9, prefill_chunk=16, clock=gen.clock,
                          slo_tracker=tracker, slo_admission=slo_on,
                          registry=o.MetricsRegistry(), tracer=tracer,
                          flightrec=fr)
    rep = gen.run(eng)
    tracer.close()
    return rep, eng, tracer, fr


@pytest.fixture(scope="module")
def legs(decoders):
    """{(package, policy): leg} for both packages under FIFO and SLO."""
    cfg, jdec, pdec = decoders
    out = {}
    for policy, slo_on in (("fifo", False), ("slo", True)):
        out["jax", policy] = _leg(jserve, jobs, jdec, cfg.vocab_size, slo_on)
        out["port", policy] = _leg(serve, obs, pdec, cfg.vocab_size, slo_on)
    return out


def _events(tracer):
    return [(kind, name, payload) for _, kind, name, payload in tracer.events]


def _spans(tracer):
    return [(sp.name, sp.depth, sp.attrs) for sp in tracer.spans]


class TestTrafficPlan:
    @pytest.mark.parametrize("seed,kw", [
        (5, {"interactive_max_prompt": 12, "priority_weights": None}),
        (6, {"arrival": "poisson", "deadline_frac": 0.5,
             "deadline_ms": 40.0}),
        (7, {"n_prefixes": 4, "shared_frac": 0.8, "burst_factor": 4.0}),
    ])
    def test_plan_json_is_byte_identical_to_jax(self, seed, kw):
        port, ref = _plan(serve, seed, **kw), _plan(jserve, seed, **kw)
        assert port.to_json() == ref.to_json()
        assert port.stats() == ref.stats()
        again = serve.TrafficPlan.from_json(ref.to_json(indent=1))
        assert again.to_json() == ref.to_json()

    def test_bad_arrival_raises(self):
        with pytest.raises(ValueError):
            _plan(serve, arrival="weird")


class TestSliceParity:
    @pytest.mark.parametrize("policy", ["fifo", "slo"])
    def test_load_report_equals_jax(self, legs, policy):
        rep, ref = legs["port", policy][0], legs["jax", policy][0]
        got, want = rep.to_dict(), ref.to_dict()
        assert [k for k in want if got[k] != want[k]] == []
        assert rep.to_json() == ref.to_json()
        assert rep.completed == 12 and rep.ttft_ms["count"] == 12

    def test_slo_admission_streams_fifo_tokens(self, legs):
        fifo, slo = legs["port", "fifo"][0], legs["port", "slo"][0]
        assert slo.tokens == fifo.tokens
        # the SLO leg exercised every decision of the policy
        assert slo.slo_overtakes >= 1 and slo.slo_yields >= 1
        assert slo.preemptions >= 1
        assert slo.slo["objectives"][0]["trips"] >= 1
        assert fifo.slo is None and fifo.slo_yields == 0

    @pytest.mark.parametrize("policy", ["fifo", "slo"])
    def test_telemetry_equals_jax(self, legs, policy, tmp_path):
        _, eng, tracer, fr = legs["port", policy]
        _, jeng, jtracer, jfr = legs["jax", policy]
        assert _spans(tracer) == _spans(jtracer)
        assert _events(tracer) == _events(jtracer)
        for name in ("serve/admit", "serve/prefix_match",
                     "serve/prefill_chunk", "serve/cow_plan",
                     "serve/decode_window"):
            assert tracer.span_names()[name] > 0
        # the flight recorders' logical stamps: byte-identical dumps
        a = fr.dump(str(tmp_path / "port.jsonl"), reason=policy)
        b = jfr.dump(str(tmp_path / "jax.jsonl"), reason=policy)
        assert open(a).read() == open(b).read()
        assert fr.kinds()["serve/retire"] == 12
        # the registries hold the same metrics, with the same values
        assert eng.obs_registry.snapshot() == jeng.obs_registry.snapshot()

    @pytest.mark.parametrize("policy", ["fifo", "slo"])
    def test_shared_stats_equal_jax(self, legs, policy):
        s = legs["port", policy][1].stats()
        js = legs["jax", policy][1].stats()
        shared = set(s) & set(js)
        assert set(js) <= shared  # every JAX key is also the port's
        assert {k: s[k] for k in shared} == {k: js[k] for k in shared}
        assert set(s) - shared == {"kernel_launches"}
        assert s["requests_done"] == 12 and s["pages_in_use"] == 0


class TestWindowTables:
    def test_a_yielded_prefill_writes_no_shared_page(self, decoders,
                                                     monkeypatch):
        """Every slot decodes in a window and writes its K/V at its
        device length through the table row it is given.  A slot whose
        first chunk yields keeps the device length of the request that
        left it: here 11, inside the second page of a prompt it shares
        with a decoding request.  Before, that window's garbage
        overwrote the shared page (on an H100, three requests of
        chip_smoke's SLO leg changed tokens); each window now gets the
        trash page in every inactive row, and the shared pages keep
        their bits."""
        cfg, _, pdec = decoders
        tracker = obs.SloTracker([obs.SloObjective("itl_ms", 0.9, 1e-9, 1e6)],
                                 enabled=True)
        eng = serve.ServeEngine(pdec, slots=2, max_len=64, page_len=8,
                                prefill_chunk=16, slo_tracker=tracker,
                                slo_admission=True,
                                registry=obs.MetricsRegistry())
        rng = np.random.RandomState(5)
        shared = [int(t) for t in rng.randint(0, cfg.vocab_size, size=16)]
        eng.submit(shared, max_new_tokens=40)
        eng.submit([1, 2, 3], max_new_tokens=7)  # leaves length 11
        while len(eng.results) < 1:
            eng.step()
        assert eng._active and tracker.burning("itl_ms")
        free = next(s for s in range(2) if s not in eng._active)
        assert int(eng.cache.lengths[free]) == 11
        eng.submit(shared + [5, 6], max_new_tokens=3)
        pages = eng.pool.tables[1 - free, :2].copy()
        real = pdec.paged_decode_window
        seen = []

        def spy(cache, tables, tokens, active, *a, **kw):
            before = cache.k[pages].clone(), cache.v[pages].clone()
            out = real(cache, tables, tokens, active, *a, **kw)
            seen.append((np.asarray(tables)[free].tolist(),
                         torch.equal(cache.k[pages], before[0])
                         and torch.equal(cache.v[pages], before[1])))
            return out

        monkeypatch.setattr(pdec, "paged_decode_window", spy)
        eng.step()  # admits the third request, yields its prefill
        assert eng._prefilling and eng.stats()["slo"]["prefill_yields"] == 1
        mapped = eng.pool.tables[free, :2]
        assert (mapped == pages).all() and (eng.pool.ref[pages] == 2).all()
        assert seen == [([serve.TRASH_PAGE] * 8, True)]


class TestHarness:
    def test_port_runs_are_byte_replayable(self, decoders, legs):
        cfg, _, pdec = decoders
        again = _leg(serve, obs, pdec, cfg.vocab_size, True)[0]
        assert again.to_json() == legs["port", "slo"][0].to_json()

    def test_virtual_clock(self):
        c = serve.VirtualClock(5)
        c.advance_ms(1.5)
        assert c() == 1_500_005 and c.now_ms == 1.500005
        c.advance_to_ms(1.0)  # never backwards
        assert c() == 1_500_005
        c.advance_to_ms(3.0)
        assert c() == 3_000_000

    def test_engine_on_another_clock_is_refused(self, decoders):
        _, _, pdec = decoders
        gen = serve.LoadGen(_plan(serve), step_cost_ms=5.0)
        eng = serve.ServeEngine(pdec, slots=2, max_len=64, page_len=8)
        with pytest.raises(ValueError, match="virtual clock"):
            gen.run(eng)
        with pytest.raises(ValueError):
            serve.LoadGen(_plan(serve), step_cost_ms=0.0)

    @pytest.mark.parametrize("attr,module", [("hosts", "fleet"),
                                             ("registry", "resilience")])
    def test_unported_targets_raise(self, attr, module):
        target = type("Target", (), {attr: {}})()
        with pytest.raises(TypeError, match=module):
            serve.LoadGen(_plan(serve)).run(target)
