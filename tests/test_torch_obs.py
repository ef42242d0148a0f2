"""apex_tpu_torch.obs and its wiring vs the JAX package, on the CPU.

- The same operations on JAX's and the port's ``MetricsRegistry`` give
  identical snapshots, decimation past ``max_samples`` included.
- The same observation stream on a synthetic clock gives the same
  ``SloReport`` (and ``WindowedHistogram`` snapshots, alert trips and
  clears, OpenMetrics text) from both ``SloTracker``s; with ``labels=``
  (a fleet host's ``host`` and ``role``) the OpenMetrics text and file
  are JAX's byte for byte.
- Each package's ``read_flightrec`` and ``read_jsonl`` read the other's
  files; the same events dump byte-identically; the Chrome trace has
  JAX's keys.
- The tracer's hook on ``ops/_build.py``: a library built or loaded
  inside nested spans counts on the innermost one.
- With obs off the ambient tracer and recorder are no-ops and the engine
  keeps no lifecycle but still counts, with the same tokens.
- The contiguous engine's spans, instants and recorder events equal
  JAX's over one run with cancellations in each place.
- ``FusedTrainDriver``'s dispatch and checkpoint spans, registry
  entries and recorder events equal JAX's (``TestDriverObs`` in
  tests/test_obs.py) in names, counts and order.
"""
import _ctypes
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import obs as jobs
from apex_tpu import serve as jserve
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.train import FusedTrainDriver as JaxDriver
from apex_tpu.train import read_metrics as jax_read_metrics
from apex_tpu_torch import obs, serve
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.ops import _build
from apex_tpu_torch.train import FusedTrainDriver, read_metrics
from apex_tpu_torch.weights import from_jax_params

MS = 1_000_000  # ns


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture
def clean_default():
    """Both packages' ambient tracer, registry and recorder fresh, obs
    on, and left so."""
    for o in (obs, jobs):
        o.reset_default()
        o.reset_default_flightrec()
    obs.set_enabled(True)
    jobs.set_enabled_override(True)
    yield
    obs.set_enabled(True)
    jobs.set_enabled_override(None)
    for o in (obs, jobs):
        o.reset_default()
        o.reset_default_flightrec()


class _Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _feed_registry(o, max_samples):
    reg = o.MetricsRegistry()
    rng = np.random.RandomState(3)
    reg.counter("serve.decode_dispatches").inc()
    reg.counter("serve.decode_dispatches").inc(4)
    reg.counter("x.float").inc(0.25)
    reg.gauge("serve.peak_live_tokens").set_max(7)
    reg.gauge("serve.peak_live_tokens").set_max(3)
    reg.gauge("g").set(5)
    reg.gauge("g").set(2)
    h = reg.histogram("serve.ttft_ms", max_samples=max_samples)
    for v in rng.exponential(20.0, size=1000):
        h.observe(float(v))
    reg.histogram("empty")
    return reg


class TestMetrics:
    @pytest.mark.parametrize("max_samples", [8, 64, 65536])
    def test_snapshots_equal_jax(self, max_samples):
        reg, ref = _feed_registry(obs, max_samples), _feed_registry(
            jobs, max_samples)
        assert reg.snapshot() == ref.snapshot()
        assert reg.to_json() == ref.to_json()
        h = reg.get("serve.ttft_ms")
        assert h.exact == (max_samples > 1000) and h.count == 1000
        for q in (0.0, 0.5, 0.99, 1.0):
            assert h.quantile(q) == ref.get("serve.ttft_ms").quantile(q)
        assert obs.to_openmetrics(reg) == jobs.to_openmetrics(ref)

    def test_type_clash_and_bounds(self):
        reg = obs.MetricsRegistry()
        reg.counter("a")
        with pytest.raises(TypeError):
            reg.gauge("a")
        with pytest.raises(ValueError):
            obs.Histogram("h", max_samples=1)
        assert math.isnan(obs.Histogram("h").quantile(0.5))


# ---------------------------------------------------------------------------
# SLO tracking
# ---------------------------------------------------------------------------

def _slo_stream(o):
    """One observation stream with queries in between; returns the
    tracker, the answers of the queries, and the windowed histogram."""
    clk = _Clock()
    tr = o.SloTracker(["ttft_ms p99 < 50 over 2s",
                       o.SloObjective("itl_ms", 0.9, 5.0, 1000.0)],
                      clock=clk, enabled=True)
    wh = o.WindowedHistogram("w", window_ms=400.0, sub_windows=4,
                             max_samples=16, clock=clk)
    rng = np.random.RandomState(7)
    answers = []
    for i in range(400):
        clk.t = i * 25 * MS
        hot = 120 <= i < 220  # a burst of slow requests, then recovery
        tr.observe("ttft_ms", float(rng.exponential(80.0 if hot else 10.0)))
        tr.observe("itl_ms", float(rng.exponential(9.0 if hot else 1.0)))
        wh.observe(float(rng.rand()))
        if i % 10 == 0:
            answers.append((tr.burning("ttft_ms"), tr.burning("itl_ms"),
                            tr.burning(), json.dumps(wh.snapshot())))
    clk.t = 400 * 25 * MS + 5000 * MS  # quiet time clears the alerts
    return tr, answers, wh


class TestSlo:
    def test_report_equals_jax(self):
        tr, answers, wh = _slo_stream(obs)
        ref, ref_answers, ref_wh = _slo_stream(jobs)
        assert answers == ref_answers
        life = {"completed": 3, "goodput_tokens_per_s": 1.5}
        rep = tr.report(lifecycle=life)
        want = ref.report(lifecycle=life)
        assert rep.to_json() == want.to_json()
        assert all(r["trips"] >= 1 and r["clears"] >= 1
                   for r in rep.objectives)
        assert rep.alerting() == []
        assert wh.snapshot() == ref_wh.snapshot()
        assert (obs.SloReport.from_json(want.to_json()).to_json()
                == want.to_json())
        assert (obs.to_openmetrics(None, rep)
                == jobs.to_openmetrics(None, want))

    @pytest.mark.parametrize("labels", [
        {"host": "3", "role": "prefill"}, {"host": 'a"b\\c'}, {}])
    def test_labeled_openmetrics_equals_jax(self, labels, tmp_path):
        """``labels=``: a fleet host's ``host``/``role`` stamped on every
        series of the registry, the SLO objectives and the lifecycle
        gauges, merged with the per-series labels, byte for byte JAX's
        (text and file)."""
        reg, ref = _feed_registry(obs, 64), _feed_registry(jobs, 64)
        tr, ref_tr = _slo_stream(obs)[0], _slo_stream(jobs)[0]
        life = {"completed": 3, "goodput_tokens_per_s": 1.5}
        rep, want = tr.report(lifecycle=life), ref_tr.report(lifecycle=life)
        text = obs.to_openmetrics(reg, rep, labels=labels)
        assert text == jobs.to_openmetrics(ref, want, labels=labels)
        if labels:  # every series carries them
            assert all(line.startswith("#") or '{host="' in line
                       for line in text.splitlines())
        a = obs.write_openmetrics(str(tmp_path / "p.txt"), reg, rep,
                                  labels=labels)
        b = jobs.write_openmetrics(str(tmp_path / "j.txt"), ref, want,
                                   labels=labels)
        assert open(a).read() == open(b).read() == text

    def test_objectives_parse_like_jax(self):
        for spec in ("ttft_ms p99 < 50 over 15s", "itl_ms p99.9 < 2.5",
                     "queue_delay_ms p50<100 over 0.5s"):
            got, want = obs.parse_objective(spec), jobs.parse_objective(spec)
            assert (got.name, got.describe(), got.budget) == (
                want.name, want.describe(), want.budget)
        for bad in ("ttft p99", "ttft_ms p100 < 5"):
            with pytest.raises(ValueError):
                obs.parse_objective(bad)
        with pytest.raises(ValueError):
            obs.SloTracker([], fast_burn=1.0, clear_burn=2.0)

    def test_disabled_tracker_is_inert(self):
        tr = obs.SloTracker(["ttft_ms p99 < 1"], enabled=False)
        tr.observe("ttft_ms", 100.0, 0)
        assert tr.observations == 0 and not tr.burning("ttft_ms", 0)


# ---------------------------------------------------------------------------
# the flight recorder and the exporters
# ---------------------------------------------------------------------------

def _record(o, tmp_path, name):
    fr = o.FlightRecorder(capacity=8, enabled=True)
    for i in range(11):
        fr.record("serve/boundary", active=i, queued=2 * i)
    fr.record("train/checkpoint_save", step=3)
    fr.record("fault", kind="crash")  # an attr may reuse the name
    return fr, fr.dump(str(tmp_path / name), reason="test",
                       extra_meta={"host": 1})


def _traced(o, clk):
    tr = o.Tracer(enabled=True, clock=clk, monitor_compiles=False)
    with tr.span("serve/admit"):
        clk.t += 2 * MS
        with tr.span("serve/prefix_match", uid=3):
            clk.t += MS
    tr.instant("serve/retire", uid=3, tokens=4)
    tr.counter("serve/pages_in_use", 5)
    with tr.span("serve/decode_window", k=8, active=2):
        clk.t += 3 * MS
    return tr


class TestFilesAcrossPackages:
    def test_flightrec_dumps_read_across(self, tmp_path):
        fr, path = _record(obs, tmp_path, "port/flightrec.jsonl")
        jfr, jpath = _record(jobs, tmp_path, "jax/flightrec.jsonl")
        assert open(path).read() == open(jpath).read()
        assert fr.dropped == 5 and fr.kinds() == jfr.kinds()
        assert jobs.read_flightrec(path) == obs.read_flightrec(jpath)
        meta, events = obs.read_flightrec(str(tmp_path / "jax"))
        assert meta["schema"] == obs.SCHEMA and meta["host"] == 1
        assert [e["seq"] for e in events] == list(range(5, 13))
        assert events[-1]["attrs"] == {"kind": "crash"}
        assert obs.FlightRecorder(enabled=True).dump() is None  # no dir
        assert obs.FlightRecorder(enabled=False).dump(str(path)) is None

    def test_jsonl_and_chrome_read_across(self, tmp_path):
        clk, jclk = _Clock(), _Clock()
        tr, jtr = _traced(obs, clk), _traced(jobs, jclk)
        reg, jreg = _feed_registry(obs, 64), _feed_registry(jobs, 64)
        slo = obs.SloTracker(["ttft_ms p99 < 5"], clock=clk, enabled=True)
        jslo = jobs.SloTracker(["ttft_ms p99 < 5"], clock=jclk,
                               enabled=True)
        slo.observe("ttft_ms", 9.0)
        jslo.observe("ttft_ms", 9.0)
        fr, _ = _record(obs, tmp_path, "a.jsonl")
        jfr, _ = _record(jobs, tmp_path, "b.jsonl")
        p = obs.write_jsonl(tr, str(tmp_path / "port.jsonl"), registry=reg,
                            slo_report=slo.report(), flightrec=fr)
        jp = jobs.write_jsonl(jtr, str(tmp_path / "jax.jsonl"),
                              registry=jreg, slo_report=jslo.report(),
                              flightrec=jfr)
        assert open(p).read() == open(jp).read()
        assert jobs.read_jsonl(p) == obs.read_jsonl(jp)
        events, metrics = obs.read_jsonl(jp)
        assert metrics == reg.snapshot()
        assert [e["type"] for e in events] == [
            "meta", "span", "span", "span", "instant", "counter", "slo",
            "flightrec"]
        obs.write_slo_line(p, slo.report())
        obs.write_flightrec_line(p, fr)
        jobs.write_slo_line(jp, jslo.report())
        jobs.write_flightrec_line(jp, jfr)
        assert open(p).read() == open(jp).read()
        c = json.load(open(tr.export_chrome(str(tmp_path / "c.json"),
                                            registry=reg)))
        jc = json.load(open(jtr.export_chrome(str(tmp_path / "jc.json"),
                                              registry=jreg)))
        assert c == jc
        assert sorted(c) == ["displayTimeUnit", "otherData", "traceEvents"]
        assert {e["ph"] for e in c["traceEvents"]} == {"X", "i", "C"}

    def test_openmetrics_file(self, tmp_path):
        reg = _feed_registry(obs, 64)
        text = open(obs.write_openmetrics(str(tmp_path / "m.txt"),
                                          reg)).read()
        assert text.endswith("# EOF\n")
        assert "apex_tpu_serve_decode_dispatches_total 5" in text


# ---------------------------------------------------------------------------
# the tracer's hook on the kernel build
# ---------------------------------------------------------------------------

class TestBuildHook:
    def test_build_lands_on_the_innermost_span(self):
        tr = obs.Tracer(enabled=True)
        with tr.span("outer") as outer:
            with tr.span("inner") as inner:
                _build._notify("build", "layer_norm")
                _build._notify("load", "layer_norm")
            _build._notify("load", "paged_attention")
        _build._notify("build", "conv_bn")  # no span open
        assert (inner.compiles, outer.compiles, tr.compiles) == (2, 1, 4)
        assert inner.compiled and [sp.name for sp in tr.compiled_spans()] \
            == ["inner", "outer"]
        assert tr.spans[0].to_dict()["compiles"] == 2
        tr.close()
        _build._notify("build", "x")
        assert tr.compiles == 4

    def test_a_real_load_notifies(self, monkeypatch):
        # a shared library that exists wherever Python runs stands in
        stand_in = Path(_ctypes.__file__)
        monkeypatch.setattr(_build, "library_path", lambda name: stand_in)
        monkeypatch.setattr(_build, "_loaded", {})
        tr = obs.Tracer(enabled=True)
        with tr.span("serve/decode_window") as sp:
            _build.load("stand_in")
            _build.load("stand_in")  # loaded once: heard once
        assert sp.compiles == 1
        tr.close()

    def test_listeners_are_weak_or_removable(self):
        n = len(_build._listeners)
        tr = obs.Tracer(enabled=True)
        assert len(_build._listeners) == n + 1
        del tr
        _build._notify("build", "x")  # prunes the dead listener
        assert len(_build._listeners) == n
        heard = []

        def fn(kind, name):
            heard.append((kind, name))

        _build.add_build_listener(fn)
        _build._notify("load", "y")
        _build.remove_build_listener(fn)
        _build._notify("load", "z")
        assert heard == [("load", "y")] and len(_build._listeners) == n
        assert not obs.Tracer(enabled=False)._listening


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 16))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    port = serve.GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                            tokens_per_dispatch=4, device="cpu")
    return cfg, jserve.GPTDecoder(cfg, params, tokens_per_dispatch=4), port


def _prompts(vocab):
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(0, vocab, size=n)]
            for n in (5, 9, 3, 12, 7)]


def _cancel_run(pkg, o, dec, vocab):
    """A contiguous 2-slot engine: cancel a queued request, run a
    boundary, cancel an active one, drain.  Returns (engine, tracer,
    recorder, tokens by uid)."""
    tracer = o.Tracer(enabled=True)
    fr = o.FlightRecorder(capacity=1024, enabled=True)
    eng = pkg.ServeEngine(dec, slots=2, max_len=32, paged=False, seed=0,
                          registry=o.MetricsRegistry(), tracer=tracer,
                          flightrec=fr, clock=_Clock())
    uids = [eng.submit(p, max_new_tokens=6, corr=f"c{i}")
            for i, p in enumerate(_prompts(vocab))]
    assert eng.cancel(uids[4]) == []
    eng.step()
    assert len(eng.cancel(uids[0])) == 5  # prefill token + a window
    out = eng.run()
    assert eng.cancel(uids[1]) == out[uids[1]]  # finished: a no-op
    tracer.close()
    return eng, tracer, fr, out


class TestEngines:
    def test_contiguous_engine_and_cancel_match_jax(self, decoders):
        cfg, jdec, pdec = decoders
        eng, tr, fr, out = _cancel_run(serve, obs, pdec, cfg.vocab_size)
        jeng, jtr, jfr, jout = _cancel_run(jserve, jobs, jdec,
                                           cfg.vocab_size)
        assert out == jout
        assert ([(sp.name, sp.attrs) for sp in tr.spans]
                == [(sp.name, sp.attrs) for sp in jtr.spans])
        assert ([e[1:] for e in tr.events] == [e[1:] for e in jtr.events])
        assert fr.events() == jfr.events()
        assert fr.kinds()["serve/cancel"] == 1  # the queued one
        assert eng.lifecycle_summary() == jeng.lifecycle_summary()
        assert eng.lifecycle_summary()["abandoned"] == 2
        assert eng.obs_registry.get("serve.requests_cancelled").value == 2
        with pytest.raises(KeyError):
            eng.cancel(99)
        s, js = eng.stats(), jeng.stats()
        assert {k: s[k] for k in js} == js
        assert eng.slo_report() is None

    def test_obs_off_still_counts_with_the_same_tokens(self, decoders,
                                                       clean_default):
        cfg, _, pdec = decoders

        def run():
            eng = serve.ServeEngine(pdec, slots=2, max_len=64, page_len=8,
                                    prefill_chunk=8)
            uids = [eng.submit(p, max_new_tokens=5)
                    for p in _prompts(cfg.vocab_size)]
            out = eng.run()
            return eng, [out[u] for u in uids]

        on, on_tokens = run()
        obs.set_enabled(False)
        assert obs.default_tracer() is obs.NULL_TRACER
        assert obs.default_flightrec() is obs.NULL_FLIGHTREC
        off, off_tokens = run()
        assert off_tokens == on_tokens
        s = off.stats()
        assert s["decode_dispatches"] == on.stats()["decode_dispatches"] > 0
        assert s["requests_done"] == 5
        snap = off.obs_registry.snapshot()
        assert "serve.ttft_ms" not in snap  # the lifecycle was off
        assert off.lifecycle_summary()["completed"] == 0
        assert on.lifecycle_summary()["completed"] == 5
        assert on.obs_registry.get("serve.ttft_ms").count == 5
        assert obs.default_tracer().span("x").__enter__().compiles == 0
        # the ambient tracer of the obs-on run saw its spans
        obs.set_enabled(True)
        assert obs.default_tracer().span_names()["serve/decode_window"] > 0
        assert obs.default_flightrec().kinds()["serve/retire"] == 5


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

def _driver_run(tmp_path, jax_side: bool):
    """JAX's ``TestDriverObs`` scenario on either package: two K = 3
    windows with a meter read into the ambient registry, then a K = 2
    window saved and restored.  Returns (span names in order, the
    ambient registry's entries, recorder kinds in order, the restored
    carry and step)."""
    o = jobs if jax_side else obs
    if jax_side:
        arr, zeros, read, driver_cls = jnp.asarray, jnp.zeros, \
            jax_read_metrics, JaxDriver
    else:
        arr, zeros, read, driver_cls = torch.as_tensor, torch.zeros, \
            read_metrics, FusedTrainDriver

    def step(carry, _):
        return carry + 1.0, {"loss": (carry * 2.0).sum()}

    driver = driver_cls(step, steps_per_dispatch=3, metrics={"loss": "last"})
    carry = zeros(())
    losses = []
    for _ in range(2):
        carry, res = driver.run_window(carry)
        losses.append(read(res.metrics, registry=o.default_registry()))

    def wstep(carry, _):
        w = carry["w"] + 1.0
        return {"w": w}, {"loss": w.sum()}

    d2 = driver_cls(wstep, steps_per_dispatch=2)
    c2, _ = d2.run_window({"w": zeros((4,))})
    path = str(tmp_path / ("jax" if jax_side else "port"))
    d2.save(path, c2, 2)
    restored, at = d2.restore(path, {"w": zeros((4,))})
    tracer, reg = o.default_tracer(), o.default_registry()
    spans = [(sp.name, sp.attrs) for sp in tracer.spans]
    entries = {n: (m.count if hasattr(m, "count") else m.value)
               for n, m in ((n, reg.get(n)) for n in reg.names())}
    kinds = [e["kind"] for e in o.default_flightrec().events()]
    attrs = [e.get("attrs") for e in o.default_flightrec().events()]
    return (spans, entries, kinds, attrs, losses,
            np.asarray(restored["w"]).tolist(), at,
            driver.last_window_k)


class TestDriverObs:
    def test_spans_registry_and_records_match_jax(self, tmp_path,
                                                  clean_default):
        got = _driver_run(tmp_path, jax_side=False)
        want = _driver_run(tmp_path, jax_side=True)
        assert got == want
        spans, entries, kinds = got[:3]
        assert [n for n, _ in spans] == [
            "train/dispatch", "train/dispatch", "train/dispatch",
            "train/checkpoint_save", "train/checkpoint_restore"]
        assert entries == {"train.dispatch_ms": 3, "train.dispatches": 3,
                           "train.loss": 2, "train.steps": 8}
        assert kinds == ["train/dispatch"] * 3 + [
            "train/checkpoint_save", "train/checkpoint_restore"]
        # the port's dispatches ran no kernel build or load on the CPU
        assert all(sp.compiles == 0 for sp in obs.default_tracer().spans)

    def test_obs_off_window_is_the_same(self, clean_default):
        def step(carry, _):
            return carry * 1.5 + 1.0, {"loss": carry.sum()}

        driver = FusedTrainDriver(step, steps_per_dispatch=4,
                                  per_step=("loss",))
        on = read_metrics(driver.run_window(torch.ones(3))[1])
        obs.set_enabled(False)
        off = read_metrics(driver.run_window(torch.ones(3))[1])
        assert on == off
        assert obs.default_registry().get("train.dispatches").value == 1
        assert driver.last_dispatch_ms is not None
