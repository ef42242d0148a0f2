"""apex_tpu_torch's serving fleet against the JAX package's, on the CPU.

Both fleets serve ``GPTConfig.tiny`` at fp32 with the same weights
(``apex_tpu_torch/weights.py`` carries JAX's across), K = 4, hosts of 2
slots over 8-token pages.  JAX's router admits through a gate that
returns a passing report (its own ``run_preflight`` fails in this
container: ROADMAP C); the port's runs its own ``preflight=True``.  Each
host's decode-window clock and each router's clock are a tick clock that
advances 1 ms a read, the same on both sides, so the wall-clock stats
(``decode_p99_ms``, stragglers, ``recovery_ms``) are compared too.

- ``_Ring`` and ``_stable_hash`` give JAX's points and lookups;
- per request, the tokens and the final host; ``stats()``,
  ``routing_attribution()``, the router's registry snapshot and its
  trace (spans, instants with their router-clock stamps) equal JAX's for
  a clean fleet, two seeded host-chaos plans
  (``FaultPlan.from_seed(..., hosts=2)``), prefix affinity off and on,
  prefill/decode roles (whole, streamed, and with every handoff's bytes
  corrupted), and an autoscaled fleet under ``LoadGen``;
- the flight-recorder dump after a host loss and after the autoscale
  run equals JAX's byte for byte;
- ``PreflightReport.to_json`` equals JAX's for the same checks; the
  port's ``run_preflight`` passes on a clean CPU decoder, fails each
  planted fault (a half ``exp``, a pool reallocated every window, a
  library loaded on a warm window) as a FAIL of its own check alone,
  and the router then refuses the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import obs as jobs
from apex_tpu import resilience as jres
from apex_tpu import serve as jserve
from apex_tpu.fleet import FleetHost as JaxHost
from apex_tpu.fleet import FleetRouter as JaxRouter
from apex_tpu.fleet import FleetUnavailable as JaxUnavailable
from apex_tpu.fleet import PreflightCheck as JaxCheck
from apex_tpu.fleet import PreflightReport as JaxReport
from apex_tpu.fleet import serve as jfleet
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.serve import handoff as jhandoff
from apex_tpu_torch import obs, resilience, serve
from apex_tpu_torch.fleet import (
    FleetHost,
    FleetRouter,
    FleetUnavailable,
    PreflightCheck,
    PreflightReport,
    run_preflight,
)
from apex_tpu_torch.fleet import serve as pfleet
from apex_tpu_torch.models import GPTConfig
from apex_tpu_torch.ops import _build
from apex_tpu_torch.serve import handoff as phandoff
from apex_tpu_torch.weights import from_jax_params

CFG = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                     attn_dropout_rate=0.0)
ENG_KW = dict(slots=2, max_len=64, paged=True, page_len=8, prefill_chunk=16)
CHECKS = ("precision", "transfers", "donation", "warm_compile")
CHAOS = {
    # JAX's own seeded chaos test (tests/test_fleet.py)
    "seed21": dict(seed=21, rates={"host_loss": 0.12,
                                   "heartbeat_drop": 0.15,
                                   "restart": 0.3}),
    # stalls too: evictions, then readmissions through the gate
    "seed3_stalls": dict(seed=3, rates={"host_loss": 0.12,
                                        "host_stall": 0.1,
                                        "heartbeat_drop": 0.15,
                                        "restart": 0.3}),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture(scope="module")
def decoders():
    """{"jax": JAX's K=4 decoder, "port": the port's, on the CPU} with the
    same weights."""
    ids = np.random.RandomState(0).randint(0, CFG.vocab_size, size=(1, 16))
    params = JaxGPTLM(CFG).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    port = serve.GPTDecoder(GPTConfig.tiny(compute_dtype=torch.float32), sd,
                            tokens_per_dispatch=4, device="cpu")
    return {"jax": jserve.GPTDecoder(CFG, params, tokens_per_dispatch=4),
            "port": port}


class _Tick:
    """A ns clock that advances 1 ms at every read."""

    def __init__(self):
        self.t = 0

    def __call__(self) -> int:
        self.t += 1_000_000
        return self.t


def _jax_gate(host):
    return JaxReport(host_id=host.host_id,
                     checks=[JaxCheck(n, True) for n in CHECKS])


_PKG = {
    "jax": dict(host=JaxHost, router=JaxRouter, obs=jobs, serve=jserve,
                res=jres, gate=_jax_gate),
    "port": dict(host=FleetHost, router=FleetRouter, obs=obs, serve=serve,
                 res=resilience, gate=True),
}


def _prompts():
    """JAX's fleet tests' five prompts (a duplicate shares pages)."""
    rng = np.random.RandomState(3)
    pool = [int(t) for t in rng.randint(0, CFG.vocab_size, size=(48,))]
    ps = [pool[0:5], pool[3:14], pool[7:15], pool[2:18]]
    ps.append(list(ps[1]))
    return [(p, 10) for p in ps]


def _long_prompts():
    """Prompts of 2-3 prefill chunks (16 tokens a chunk), so a streamed
    handoff ships finished pages while prefill still runs."""
    rng = np.random.RandomState(4)
    pool = [int(t) for t in rng.randint(0, CFG.vocab_size, size=(160,))]
    return [(pool[0:40], 10), (pool[40:52], 10), (pool[52:85], 10),
            (pool[85:121], 10)]


def _staggered_shared_traffic():
    """JAX's affinity A/B traffic: two prefix families on distinct ring
    arcs, each with a long-lived anchor, short sharers and one unique
    request."""
    rng = np.random.RandomState(0)
    pool = [int(t) for t in rng.randint(0, CFG.vocab_size, size=(64,))]
    pa, pb = pool[:8], pool[8:16]
    return [(pa + pool[16:20], 24), (pb + pool[20:24], 24),
            (pa + pool[24:29], 6), (pb + pool[29:33], 6),
            (pool[33:43], 6), (pa + pool[43:46], 6),
            (pb + pool[46:50], 6), (pa + pool[16:20], 6)]


def _fleet(pkg, dec, roles=("mixed", "mixed"), plan=None, fr=None,
           clock=None, standby=0, **router_kw):
    m = _PKG[pkg]
    eng = dict(ENG_KW)
    if clock is not None:
        eng["clock"] = clock
    hosts = [m["host"](i, dec, role=r, **eng) for i, r in enumerate(roles)]
    spare = [m["host"](len(hosts) + i, dec, role="mixed", **eng)
             for i in range(standby)]
    for h in hosts + spare:
        h._clock = _Tick()
    if plan is not None:
        plan = m["res"].FaultPlan.from_seed(
            plan["seed"], horizon=10, hosts=len(roles), rates=plan["rates"])
    return m["router"](
        hosts, standby=spare, fault_plan=plan,
        registry=m["obs"].MetricsRegistry(),
        tracer=m["obs"].Tracer(enabled=True),
        flightrec=fr or m["obs"].FlightRecorder(capacity=512, enabled=True),
        clock=clock or _Tick(), preflight=m["gate"], **router_kw)


def _record(router, uids, error=None) -> dict:
    """Everything the two packages' runs are compared on."""
    out = router.results()
    router.tracer.close()
    return {
        "tokens": [out[u] for u in uids],
        "hosts": [router._records[u].host_id for u in uids],
        "stats": router.stats(),
        "attribution": router.routing_attribution(),
        "registry": router.registry.snapshot(),
        "spans": [(sp.name, sp.depth, sp.attrs) for sp in router.tracer.spans],
        "events": [(k, n, a) for _, k, n, a in router.tracer.events],
        "error": error,
    }


def _drain(router, reqs) -> dict:
    uids = [router.submit(p, max_new_tokens=n) for p, n in reqs]
    try:
        router.run()
    except (FleetUnavailable, JaxUnavailable) as e:
        return _record(router, uids, str(e))
    return _record(router, uids)


def _corrupt(mod):
    """Every whole handoff's last 4 bytes overwritten on the wire."""
    real = mod.KVHandoff.from_bytes.__func__
    return classmethod(lambda cls, blob: real(cls, blob[:-4] + b"XXXX"))


SCENARIOS = ("clean", "chaos_seed21", "chaos_seed3_stalls",
             "chaos_seed3_stalls_unavailable", "affinity_off", "affinity_on",
             "roles", "roles_streamed", "roles_corrupt")


def _scenario(name, pkg, dec, tmp, monkeypatch):
    if name.startswith("chaos_"):
        fr = _PKG[pkg]["obs"].FlightRecorder(capacity=512, enabled=True,
                                             dump_dir=str(tmp / pkg))
        # 16 new tokens: the stall plan's loss of the last host lands
        # while requests are outstanding
        n = 16 if name.endswith("_unavailable") else 10
        plan = CHAOS[name[6:].replace("_unavailable", "")]
        rec = _drain(_fleet(pkg, dec, plan=plan, fr=fr),
                     [(p, n) for p, _ in _prompts()])
        path = tmp / pkg / "flightrec.jsonl"
        rec["dump"] = path.read_bytes() if path.exists() else None
        return rec
    if name.startswith("affinity_"):
        return _drain(_fleet(pkg, dec, affinity=name == "affinity_on"),
                      _staggered_shared_traffic())
    if name.startswith("roles"):
        if name == "roles_corrupt":
            mod = jhandoff if pkg == "jax" else phandoff
            monkeypatch.setattr(mod.KVHandoff, "from_bytes", _corrupt(mod))
        return _drain(_fleet(pkg, dec, roles=("prefill", "decode", "decode"),
                             stream_handoff=name == "roles_streamed"),
                      _long_prompts())
    return _drain(_fleet(pkg, dec), _prompts())


@pytest.fixture(scope="module")
def runs(decoders, tmp_path_factory):
    """{scenario: {package: record}}, computed on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            tmp = tmp_path_factory.mktemp(name)
            with pytest.MonkeyPatch.context() as mp:
                cache[name] = {pkg: _scenario(name, pkg, decoders[pkg], tmp,
                                              mp)
                               for pkg in ("jax", "port")}
        return cache[name]

    return get


class TestRing:
    @pytest.mark.parametrize("ids,vnodes", [((0, 1), 8), ((0, 1, 2), 8),
                                            ((3, 7, 11, 12, 40), 4)])
    def test_points_and_lookups_equal_jax(self, ids, vnodes):
        ring = pfleet._Ring.from_ids(ids, vnodes)
        want = jfleet._Ring.from_ids(ids, vnodes)
        assert ring.points() == want.points()
        keys = [tuple(range(n)) for n in range(1, 40, 3)] + ["a", (5, "x")]
        assert [ring.lookup(k) for k in keys] == [want.lookup(k)
                                                  for k in keys]
        ring.remove(ids[0])
        want.remove(ids[0])
        assert ring.points() == want.points()
        assert ring.points() == pfleet._Ring.from_ids(ids[1:],
                                                      vnodes).points()
        assert pfleet._Ring().lookup((1,)) is None

    def test_stable_hash_equals_jax(self):
        objs = [("vnode", 3, 7), (1, 2, 3), "prefix", (), 0, ("a", (1, 2))]
        assert [pfleet._stable_hash(o) for o in objs] == [
            jfleet._stable_hash(o) for o in objs]


class TestFleetParity:
    @pytest.mark.parametrize("name", SCENARIOS)
    def test_run_equals_jax(self, runs, name):
        got, want = runs(name)["port"], runs(name)["jax"]
        for key in ("tokens", "hosts", "stats", "attribution", "registry",
                    "spans", "events", "error", "dump"):
            assert got.get(key) == want.get(key), key
        assert (got["error"] is None) != name.endswith("_unavailable")

    def test_chaos_recovers_the_clean_tokens(self, runs):
        clean = runs("clean")["port"]
        rec = runs("chaos_seed21")["port"]
        assert rec["tokens"] == clean["tokens"]
        st = rec["stats"]
        assert st["host_losses"] >= 1 and st["readmissions"] >= 1
        assert st["requests_recovered"] >= 1
        assert rec["dump"] is not None and b'"host_loss"' in rec["dump"]
        rec = runs("chaos_seed3_stalls")["port"]
        assert rec["tokens"] == clean["tokens"]
        assert rec["stats"]["evictions"] >= 1

    def test_every_host_down_raises_not_hangs(self, runs):
        rec = runs("chaos_seed3_stalls_unavailable")["port"]
        assert rec["error"].startswith("all 2 hosts unhealthy with ")
        assert "(states: evicted=1, lost=1; 0=evicted, 1=lost)" \
            in rec["error"]

    def test_affinity_and_roles_keep_the_tokens(self, runs):
        off, on = runs("affinity_off")["port"], runs("affinity_on")["port"]
        assert on["tokens"] == off["tokens"]
        assert on["stats"]["fleet_prefix_hit_rate"] \
            > off["stats"]["fleet_prefix_hit_rate"]
        whole = runs("roles")["port"]
        for name in ("roles_streamed", "roles_corrupt"):
            assert runs(name)["port"]["tokens"] == whole["tokens"]
        assert whole["stats"]["handoffs"] == 4
        assert whole["attribution"]["0"]["role"] == "prefill"
        assert whole["attribution"]["0"]["handoffs_out"] == 4
        st = runs("roles_streamed")["port"]["stats"]
        assert st["handoffs"] == 4 and st["handoff_chunks"] >= 1
        st = runs("roles_corrupt")["port"]["stats"]
        assert st["handoffs"] == 0 and st["handoff_fallbacks"] == 4


def _autoscale(pkg, dec, tmp):
    """JAX's autoscale postmortem run (tests/test_flightrec.py): one host
    and two standby under a bursty plan on the virtual clock."""
    m = _PKG[pkg]
    plan = m["serve"].TrafficPlan.from_seed(
        17, requests=36, rate_rps=60.0, arrival="bursty", burst_factor=10.0,
        burst_on_s=0.3, burst_off_s=1.2, vocab_size=CFG.vocab_size,
        n_prefixes=2, prefix_len=8, zipf_s=1.2, shared_frac=0.5,
        prompt_min=2, prompt_scale=4.0, prompt_alpha=1.3, prompt_cap=24,
        output_min=2, output_scale=4.0, output_alpha=1.2, output_cap=12)
    gen = m["serve"].LoadGen(plan, step_cost_ms=4.0)
    fr = m["obs"].FlightRecorder(capacity=256, enabled=True,
                                 dump_dir=str(tmp / pkg))
    tracker = m["obs"].SloTracker(
        [m["obs"].SloObjective("ttft_ms", 0.9, 12.0, 64.0)], clock=gen.clock)
    router = _fleet(pkg, dec, roles=("mixed",), fr=fr, clock=gen.clock,
                    standby=2, autoscale=True, autoscale_tracker=tracker,
                    scale_cooldown_rounds=2, drain_after_rounds=3)
    rep = gen.run(router)
    fr.dump(reason="autoscale_audit")
    return rep, _record(router, []), (tmp / pkg / "flightrec.jsonl").read_bytes()


class TestAutoscale:
    def test_autoscale_under_loadgen_equals_jax(self, decoders, tmp_path):
        rep, rec, dump = _autoscale("port", decoders["port"], tmp_path)
        jrep, jrec, jdump = _autoscale("jax", decoders["jax"], tmp_path)
        assert rep.to_json() == jrep.to_json()
        for key in ("stats", "attribution", "registry", "spans", "events"):
            assert rec[key] == jrec[key], key
        assert dump == jdump
        st = rec["stats"]
        assert st["scale_ups"] >= 1 and st["drains"] >= 1
        assert rep.completed == rep.submitted == 36
        for kind in (b'"fleet/scale_up"', b'"fleet/drain"',
                     b'"fleet/drained"'):
            assert kind in dump


class TestPreflight:
    def test_report_json_equals_jax(self):
        checks = [("precision", True, ""),
                  ("donation", False, "pool tensor k reallocated"),
                  ("warm_compile", True, "")]
        rep = PreflightReport(host_id=3, wall_s=0.123456,
                              checks=[PreflightCheck(*c) for c in checks])
        want = JaxReport(host_id=3, wall_s=0.123456,
                         checks=[JaxCheck(*c) for c in checks])
        assert rep.to_json() == want.to_json()
        assert repr(rep) == repr(want)
        back = PreflightReport.from_json(want.to_json())
        assert back.checks == rep.checks and not back.passed
        assert [c.name for c in back.failures()] == ["donation"]

    def test_clean_decoder_passes_and_is_cached(self, decoders):
        dec = decoders["port"]
        rep = run_preflight(dec, host_id=0, slots=2, max_len=64, page_len=8)
        assert rep.passed, rep.to_json()
        assert [c.name for c in rep.checks] == list(CHECKS)
        assert "cpu" in rep.checks[1].detail  # transfers: nothing to read
        again = run_preflight(dec, host_id="h2", slots=2, max_len=64,
                              page_len=8)
        assert again.host_id == "h2" and again.checks == rep.checks
        # a clone for new weights qualifies afresh
        clone = dec.with_params(dict(dec.params))
        assert clone.__dict__["_preflight_cache"]["model"] is not clone.model
        assert run_preflight(clone, slots=2, max_len=64, page_len=8,
                             warm_check=False).passed

    @pytest.mark.parametrize("fault", ["precision", "donation",
                                       "warm_compile"])
    def test_planted_fault_fails_its_own_check(self, decoders, fault):
        dec = decoders["port"]
        bad = _planted(dec, fault)
        rep = run_preflight(bad, host_id="planted", slots=2, max_len=64,
                            page_len=8)
        assert [c.name for c in rep.failures()] == [fault], rep.to_json()
        assert rep.failures()[0].detail
        if fault == "precision":
            assert rep.failures()[0].detail.startswith("half-softmax: exp on "
                                                       "bfloat16")
            assert "test_torch_fleet.py:" in rep.failures()[0].detail
        router = FleetRouter([FleetHost(0, bad, **ENG_KW)],
                             registry=obs.MetricsRegistry(),
                             flightrec=obs.FlightRecorder(enabled=True))
        assert router.admitted() == [] and router.hosts[0].state == "new"
        assert router.stats()["preflight_failures"] == 1
        with pytest.raises(FleetUnavailable, match="no admitted hosts"):
            router.submit([1, 2, 3])


def _planted(dec, fault):
    """A copy of ``dec`` (its own qualification cache) whose paged window
    takes ``exp`` of a bf16 tensor, reallocates the pool, or loads a
    kernel library (the event ``ops._build.load`` sends)."""
    import copy

    bad = copy.copy(dec)
    bad.__dict__.pop("_preflight_cache", None)
    real = dec.paged_decode_window

    def window(cache, *args, **kwargs):
        if fault == "donation":
            cache.k = cache.k.clone()
            cache.v = cache.v.clone()
        buf = real(cache, *args, **kwargs)
        if fault == "precision":
            torch.exp(buf.to(torch.bfloat16))
        elif fault == "warm_compile":
            _build._notify("load", "paged_attention")
        return buf

    bad.paged_decode_window = window
    return bad
