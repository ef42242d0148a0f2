"""apex_tpu_torch.resilience vs the JAX package, on the CPU.

- Plans: ``FaultPlan.from_seed(...).to_json()`` is JAX's byte for byte
  for several seeds and rate sets (host and gang sites included); a plan
  serialised by either package loads in the other; ``poll``,
  ``poll_at`` and ``reset`` give JAX's event sequences; the injector's
  counters and sleeps are JAX's.
- Train: JAX's ``_train_setup`` (tests/test_resilience.py: O2,
  ``fused_sgd(0.05, momentum=0.9)``, K = 2, 6 windows) on both packages.
  Under JAX's five-event chaos plan the port's final carry is its clean
  run's bit for bit, with JAX's retries, rollbacks and restarts; the
  port's clean run is within 1e-3 of JAX's; the watchdog, the retry
  budget and the pass-through.  Then GPT tiny O2 with dropout: the
  generator in the carry and ``on_restore`` calling ``copy_to_model``
  give the clean run bit for bit, and the same plan without
  ``on_restore`` (the planted fault) does not.
- Serve (``GPTConfig.tiny`` fp32, page_len 8, prefill_chunk 16, JAX's
  prompts): every plan of JAX's ``TestResilientServe`` gives JAX's tokens
  per uid and JAX's restarts, retries, deadline and backpressure counts
  (deadlines on a virtual clock); a crash after ``swap_weights``
  recovers onto the swapped weights; a stage token or prefix anchor
  taken before a crash is refused after it.
- Flight recorder: two runs of the seeded chaos plan dump the same bytes,
  which are JAX's dump's bytes; the train rollback and retry exhaustion
  dump their reasons.
- Load harness: ``LoadGen`` over a ``ResilientServeEngine`` with
  deadlines on the virtual clock gives JAX's ``LoadReport`` byte for
  byte, twice; ``ServeEngine``, ``ResilientServeEngine`` and JAX stream
  the same tokens on one plan.
- The engine with no injector: the tokens, kernel calls and recorder
  events of an engine with an empty plan's injector, and JAX's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
import apex_tpu.resilience as jres
from apex_tpu import obs as jobs
from apex_tpu import serve as jserve
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
from apex_tpu.train import FusedTrainDriver as JaxDriver
from apex_tpu_torch import amp, obs, resilience as pres, serve
from apex_tpu_torch.checkpoint import _flatten
from apex_tpu_torch.models import GPTConfig, GPTLM
from apex_tpu_torch.models import gpt as gpt_mod
from apex_tpu_torch.normalization import fused_layer_norm
from apex_tpu_torch.optimizers import fused_adam, fused_sgd
from apex_tpu_torch.resilience import (DISPATCH_ERROR, ENGINE_CRASH,
                                       EXCHANGE_STALL, HOST_LOSS, HOST_STALL,
                                       LOADER_STALL, NAN_METERS,
                                       PAGE_PRESSURE, PREEMPTION, RANK_LOSS,
                                       STRAGGLER, FaultEvent, FaultPlan)
from apex_tpu_torch.train import FusedTrainDriver
from apex_tpu_torch.weights import from_jax_params

ENGINE_KW = dict(slots=2, max_len=64, paged=True, page_len=8,
                 prefill_chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """See tests/test_torch_spec.py: one throwaway ``torch.exp``.  Then
    one intra-op thread for this module's tiny shapes (put back after
    it): under ``pytest -n 6`` the default thread pools of six workers
    contend for the cores, and this module's many small CPU ops then ran
    about 40 times slower than alone."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(pkg, plan_or_events):
    """A plan of either package from ``(site, index, kind, value)``."""
    return pkg.FaultPlan([pkg.FaultEvent(*e) for e in plan_or_events])


# ---------------------------------------------------------------------------
# plans and the injector
# ---------------------------------------------------------------------------

SEEDED = [
    (3, dict(horizon=16, rates={DISPATCH_ERROR: 0.2, ENGINE_CRASH: 0.1})),
    (1, dict(horizon=12, stall_s=0.0,
             rates={DISPATCH_ERROR: 0.10, ENGINE_CRASH: 0.12})),
    (7, dict(horizon=32, rates={k: 0.15 for k in (
        DISPATCH_ERROR, PREEMPTION, ENGINE_CRASH, NAN_METERS, LOADER_STALL,
        STRAGGLER, PAGE_PRESSURE)}, pressure_pages=6)),
    (13, dict(horizon=16, hosts=2,
              rates={DISPATCH_ERROR: 0.2, ENGINE_CRASH: 0.1,
                     HOST_LOSS: 0.1, HOST_STALL: 0.2})),
    (11, dict(horizon=16, gang_ranks=3, gang_stall_s=0.25,
              rates={RANK_LOSS: 0.2, EXCHANGE_STALL: 0.25})),
    (0, dict(horizon=8, sites={STRAGGLER: ("serve/prefill",)},
             rates={STRAGGLER: 0.5})),
]


class TestFaultPlan:
    @pytest.mark.parametrize("seed,kw", SEEDED)
    def test_from_seed_is_jax_byte_for_byte(self, seed, kw):
        got = FaultPlan.from_seed(seed, **kw).to_json()
        assert got == jres.FaultPlan.from_seed(seed, **kw).to_json()
        assert len(FaultPlan.from_seed(seed, **kw)) > 0

    def test_pre_gang_seed_digest_is_jax_pin(self):
        """JAX pins this plan's SHA-256 (drawn before the gang kinds
        existed); the port draws the same bytes."""
        import hashlib

        plan = FaultPlan.from_seed(
            13, horizon=16, rates={DISPATCH_ERROR: 0.2, ENGINE_CRASH: 0.1},
            hosts=2)
        assert hashlib.sha256(plan.to_json().encode()).hexdigest() == (
            "95eff7659749c4a11aa10b6bc506564a"
            "5078607fbf49e746fadfa84621f0a2f8")

    @pytest.mark.parametrize("seed,kw", SEEDED[:4])
    def test_json_loads_across_packages(self, seed, kw):
        port = FaultPlan.from_seed(seed, **kw)
        jax_plan = jres.FaultPlan.from_seed(seed, **kw)
        assert jres.FaultPlan.from_json(port.to_json()).to_json() == \
            port.to_json()
        back = FaultPlan.from_json(jax_plan.to_json())
        assert back.to_json() == jax_plan.to_json()
        assert back.seed == seed and len(back) == len(jax_plan)

    def test_poll_poll_at_and_reset_match_jax(self):
        evs = [("a", 0, DISPATCH_ERROR, 0.0), ("a", 2, NAN_METERS, 0.0),
               ("b", 1, PREEMPTION, 0.0), ("a", 2, STRAGGLER, 0.5),
               (pres.gang_site(2), 3, RANK_LOSS, 0.0)]
        script = [("poll", "a"), ("poll", "a"), ("poll", "b"),
                  ("poll", "a"), ("poll", "b"), ("poll_at", "a", 2),
                  ("poll_at", pres.gang_site(2), 3),
                  ("poll_at", pres.gang_site(2), 0), ("peek", "a"),
                  ("peek", pres.gang_site(2)), ("reset",), ("poll", "a"),
                  ("poll", "c")]

        def run(pkg):
            plan = _events(pkg, evs)
            out = []
            for op, *args in script:
                if op == "reset":
                    plan.reset()
                    out.append(len(plan.fired))
                elif op == "peek":
                    out.append(plan.peek_count(*args))
                else:
                    got = getattr(plan, op)(*args)
                    out.append([(e.site, e.index, e.kind, e.value)
                                for e in got])
            out.append([(e.site, e.index, e.kind) for e in plan.fired])
            return out

        assert run(pres) == run(jres)

    def test_bad_events_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultEvent("a", 0, "meteor_strike")
        with pytest.raises(ValueError, match="negative"):
            FaultEvent("a", -1, DISPATCH_ERROR)

    def test_kinds_and_sites_are_jax(self):
        assert pres.FAULT_KINDS == jres.FAULT_KINDS
        assert pres.HOST_FAULT_KINDS == jres.HOST_FAULT_KINDS
        assert pres.GANG_FAULT_KINDS == jres.GANG_FAULT_KINDS
        assert pres.host_site(3) == jres.host_site(3)
        assert pres.gang_site(1) == jres.gang_site(1)
        assert sorted(pres.__all__) == sorted(jres.__all__)
        assert pres.resilience_default() is True
        assert pres.resilience_default(False) is False

    def test_injector_counters_and_sleeps_match_jax(self):
        """Every hook of both injectors over one plan: the sleeps, the
        raised kinds, the poisoned meters, the page reservations and
        releases, and the registry snapshots."""
        evs = [("x", 0, STRAGGLER, 0.25), ("x", 1, DISPATCH_ERROR, 0.0),
               ("x", 2, PREEMPTION, 0.0), ("x", 3, NAN_METERS, 0.0),
               ("m", 1, NAN_METERS, 0.0), ("m", 2, STRAGGLER, 0.5),
               ("serve/boundary", 0, PAGE_PRESSURE, 3.0),
               ("serve/boundary", 1, LOADER_STALL, 0.125),
               ("serve/boundary", 2, ENGINE_CRASH, 0.0),
               ("serve/boundary", 3, DISPATCH_ERROR, 0.0),
               ("serve/boundary", 4, PAGE_PRESSURE, 0.0),
               (pres.host_site(0), 0, HOST_LOSS, 0.0)]

        class Pool:
            def __init__(self):
                self.n_free, self.log = 5, []

            def reserve(self, n):
                got = list(range(100, 100 + min(n, self.n_free)))
                self.n_free -= len(got)
                self.log.append(("reserve", n, got))
                return got

            def unreserve(self, pages):
                self.n_free += len(pages)
                self.log.append(("unreserve", list(pages)))

        def run(pkg, o):
            naps, out = [], []
            reg = o.MetricsRegistry()
            inj = pkg.FaultInjector(_events(pkg, evs), registry=reg,
                                    tracer=o.NULL_TRACER, sleep=naps.append)
            eng = type("Eng", (), {"pool": Pool()})()

            def call(fn, *args):
                try:
                    return fn(*args)
                except pkg.InjectedFault as e:
                    return type(e).__name__, e.event.kind, str(e)

            for _ in range(4):
                out.append(call(inj.before_dispatch, "x"))
            for _ in range(3):
                out.append(call(inj.corrupt_meters, "m",
                                {"loss": 1.0, "gnorm": 2.0, "a": 3.0}))
            for _ in range(6):
                out.append(call(inj.at_boundary, eng))
            out.append([(e.kind, e.site) for e in
                        inj.poll_site(pres.host_site(0))])
            inj.release_pressure()
            return out, naps, eng.pool.log, reg.snapshot()

        got, want = run(pres, obs), run(jres, jobs)
        assert repr(got[:3]) == repr(want[:3])  # NaN meters: by repr
        assert got[3] == want[3]
        assert got[1] == [0.25, 0.125]  # the straggler at "m" is inert
        assert got[3]["resilience.faults_injected"]["value"] == len(evs)


# ---------------------------------------------------------------------------
# train self-healing
# ---------------------------------------------------------------------------

TRAIN_CHAOS = [("train/dispatch", 1, DISPATCH_ERROR, 0.0),
               ("train/meters", 3, NAN_METERS, 0.0),
               ("train/dispatch", 6, PREEMPTION, 0.0),
               ("train/loader", 2, LOADER_STALL, 0.001),
               ("train/dispatch", 8, STRAGGLER, 0.001)]


def _jax_train_setup():
    """tests/test_resilience.py::_train_setup, verbatim."""
    amp_ = jamp.initialize("O2")
    opt = jamp.AmpOptimizer(jax_fused_sgd(0.05, momentum=0.9), amp_)
    rng = np.random.RandomState(0)
    xs = jnp.asarray(rng.randn(16, 64).astype(np.float32))
    ys = jnp.asarray(rng.randn(16, 32).astype(np.float32))

    def step(carry, _):
        params, state = carry

        def scaled(mp):
            loss = jnp.mean(jnp.square(xs @ mp["w"] - ys))
            return amp_.scale_loss(loss, state.scaler[0]), loss

        grads, loss = jax.grad(scaled, has_aux=True)(params)
        params, state, _ = opt.step(grads, state, params)
        return (params, state), {"loss": loss}

    def fresh_carry():
        p = {"w": jnp.asarray(
            np.random.RandomState(1).randn(64, 32).astype(np.float32) * 0.1)}
        return (p, opt.init(p))

    return step, fresh_carry


def _port_train_setup():
    """The same set-up on the port: the fp32 masters are the carry's
    params, the gradient of the scaled loss is taken with respect to
    them, and ``AmpOptimizer.step`` updates them in place."""
    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_sgd(0.05, momentum=0.9), amp_)
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(16, 64).astype(np.float32))
    ys = torch.from_numpy(rng.randn(16, 32).astype(np.float32))

    def step(carry, _):
        params, state = carry
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean(torch.square(xs @ w - ys))
        g, = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]), w)
        params, state, _ = opt.step({"w": g}, state, params)
        return (params, state), {"loss": loss.detach()}

    def fresh_carry():
        p = {"w": torch.from_numpy(
            np.random.RandomState(1).randn(64, 32).astype(np.float32) * 0.1)}
        return (p, opt.init(p))

    return step, fresh_carry


def _run_resilient(pkg, plan_events, ckpt_dir, n_windows=6, **kw):
    """One ``ResilientTrainDriver`` run of either package: (carry,
    report, registry, plan)."""
    if pkg is pres:
        (step, fresh), o, drv = _port_train_setup(), obs, FusedTrainDriver
    else:
        (step, fresh), o, drv = _jax_train_setup(), jobs, JaxDriver
    plan = None if plan_events is None else _events(pkg, plan_events)
    reg = o.MetricsRegistry()
    driver = drv(step, steps_per_dispatch=2, metrics={"loss": "last"})
    r = pkg.ResilientTrainDriver(driver, ckpt_dir, fault_plan=plan,
                                 registry=reg, backoff_s=0.001, **kw)
    carry, rep = r.run(fresh(), n_windows)
    return carry, rep, reg, plan


def _leaves(tree):
    """Every leaf of a carry of either package as numpy, by position."""
    if isinstance(tree, (dict, tuple, list)) or hasattr(tree, "_fields"):
        if isinstance(tree, dict):
            items = [tree[k] for k in sorted(tree)]
        else:
            items = list(tree)
        return [x for v in items for x in _leaves(v)]
    if tree is None:
        return []
    if isinstance(tree, torch.Generator):
        return [tree.get_state().numpy()]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return [(t.view(torch.int16) if t.dtype == torch.bfloat16
                 else t).numpy()]
    return [np.asarray(tree)]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """``get(package, leg)``: the clean or chaos run, each computed once
    a process and only when a test asks (the JAX legs compile)."""
    d = tmp_path_factory.mktemp("train")
    memo = {}

    def get(name, leg):
        if (name, leg) not in memo:
            memo[name, leg] = _run_resilient(
                pres if name == "port" else jres,
                None if leg == "clean" else TRAIN_CHAOS,
                str(d / f"{name}{leg}"))
        return memo[name, leg]

    return get


class TestResilientTrain:
    def test_chaos_run_is_clean_run_bit_for_bit(self, train_runs):
        clean, rep0, _, _ = train_runs("port", "clean")
        faulted, rep, reg, plan = train_runs("port", "chaos")
        assert rep0["retries"] == rep0["rollbacks"] == rep0["restarts"] == 0
        assert rep["retries"] >= 1 and rep["rollbacks"] >= 1 \
            and rep["restarts"] >= 1
        assert len(plan.fired) == 5
        a, b = _leaves(clean), _leaves(faulted)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        snap = reg.snapshot()
        assert snap["resilience.rollbacks"]["value"] == rep["rollbacks"]
        assert snap["resilience.recovery_ms"]["count"] >= 2

    def test_recovery_counts_and_clean_run_are_jax(self, train_runs):
        """JAX's reports and ``resilience.*`` counters under the chaos
        plan, and the clean run within 1e-3 of JAX's (the optimizer
        rule)."""
        for leg in ("clean", "chaos"):
            assert train_runs("port", leg)[1] == train_runs("jax", leg)[1]
        got = train_runs("port", "chaos")[2].snapshot()
        want = train_runs("jax", "chaos")[2].snapshot()
        counters = sorted(n for n, v in want.items()
                          if n.startswith("resilience.") and "value" in v)
        assert len(counters) >= 8
        assert [got[n]["value"] for n in counters] == \
            [want[n]["value"] for n in counters]
        assert got["resilience.recovery_ms"]["count"] == \
            want["resilience.recovery_ms"]["count"]
        got = train_runs("port", "clean")[0]
        want = train_runs("jax", "clean")[0]
        w, wj = got[0]["w"].numpy(), np.asarray(want[0]["w"])
        assert np.max(np.abs(w - wj)) <= 1e-3 * np.max(np.abs(wj))
        assert float(got[1].scaler[0].loss_scale) == \
            float(want[1].scaler[0].loss_scale)

    def test_watchdog_trips_on_slow_dispatch(self, tmp_path):
        _, rep, _, _ = _run_resilient(pres, None, str(tmp_path / "w"),
                                      n_windows=2, watchdog_s=1e-9)
        assert rep["watchdog_trips"] == 2  # every dispatch beats 1 ns

    def test_retry_budget_exhaustion_raises(self, tmp_path):
        evs = [("train/dispatch", i, DISPATCH_ERROR, 0.0) for i in range(4)]
        rec = obs.FlightRecorder(capacity=64, enabled=True,
                                 dump_dir=str(tmp_path / "fr"))
        with pytest.raises(pres.RetryBudgetExceeded):
            _run_resilient(pres, evs, str(tmp_path / "x"), max_retries=2,
                           flightrec=rec)
        meta, events = obs.read_flightrec(str(tmp_path / "fr"))
        assert meta["reason"] == "retry_budget_exceeded"
        assert [e["kind"] for e in events].count("resilience/retry") == 2

    def test_pass_through_propagates_faults(self, tmp_path):
        evs = [("train/dispatch", 0, DISPATCH_ERROR, 0.0)]
        with pytest.raises(pres.DispatchFailure):
            _run_resilient(pres, evs, str(tmp_path / "k"), enabled=False)
        assert not os.path.exists(str(tmp_path / "k"))  # no checkpoint
        evs = [("train/meters", 1, NAN_METERS, 0.0)]
        with pytest.raises(pres.NonFiniteMeters):
            _run_resilient(pres, evs, str(tmp_path / "k"), enabled=False)
        _, rep, _, _ = _run_resilient(pres, None, str(tmp_path / "k"),
                                      n_windows=2, enabled=False)
        assert rep["checkpoint_saves"] == 0
        assert not os.path.exists(str(tmp_path / "k"))

    def test_bad_arguments_raise(self, tmp_path):
        step, _ = _port_train_setup()
        driver = FusedTrainDriver(step, steps_per_dispatch=2)
        with pytest.raises(ValueError, match="checkpoint_every"):
            pres.ResilientTrainDriver(driver, str(tmp_path),
                                      checkpoint_every=0)
        with pytest.raises(ValueError, match="max_retries"):
            pres.ResilientTrainDriver(driver, str(tmp_path), max_retries=-1)

    def test_reset_programs_keeps_the_driver_working(self):
        step, fresh = _port_train_setup()
        driver = FusedTrainDriver(step, steps_per_dispatch=2)
        carry, _ = driver.run_window(fresh())
        assert driver.last_window_k == 2
        driver.reset_programs()
        assert driver.last_dispatch_ms is None and driver.last_window_k == 0
        driver.run_window(carry)
        assert driver.last_window_k == 2


# -- GPT tiny O2 with dropout: the generator in the carry, on_restore -------

DROPOUT_CHAOS = [("train/dispatch", 1, DISPATCH_ERROR, 0.0),
                 ("train/meters", 2, NAN_METERS, 0.0),
                 ("train/dispatch", 5, PREEMPTION, 0.0),
                 ("train/loader", 1, LOADER_STALL, 0.001)]


def _seeded_params(cfg, seed: int = 0):
    """GPT-2's init (normal(0, 0.02) kernels and embeddings, zero biases,
    unit LayerNorm scales) from a numpy seed over the JAX tree's shapes
    (``eval_shape``: nothing compiles)."""
    shapes = jax.eval_shape(JaxGPTLM(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            return np.zeros(s.shape, s.dtype)
        if name.endswith("['scale']"):
            return np.ones(s.shape, s.dtype)
        return (0.02 * rng.randn(*s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def tiny_params():
    """JAX's GPT tiny fp32 config, seeded weights as a numpy tree, and
    their state dict for the port."""
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    params = _seeded_params(cfg)
    return cfg, params, from_jax_params(params)


@pytest.fixture(scope="module")
def tiny_sd(tiny_params):
    return tiny_params[2]


def _dropout_setup(sd):
    """GPT tiny O2 (bf16 model) with dropout 0.1, ``fused_adam``: the
    carry is (masters, state, the dropout generator), and the step reads
    the generator from the carry."""
    amp_ = amp.initialize("O2")
    model = GPTLM(GPTConfig.tiny(compute_dtype=torch.bfloat16,
                                 dropout_rate=0.1, attn_dropout_rate=0.1))
    model.load_state_dict(sd)
    opt = amp.AmpOptimizer(fused_adam(1e-3, weight_decay=0.1), amp_)
    masters = opt.attach(model)
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(0, 1024, size=(2, 32)))
    labels = torch.cat([ids[:, 1:], torch.full((2, 1), -100)], dim=1)
    names, ps = zip(*model.named_parameters())

    def step(carry, _):
        masters, state, gen = carry
        _, loss = model(ids, labels, deterministic=False, generator=gen)
        grads = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]),
                                    ps)
        masters, state, _ = opt.step(dict(zip(names, grads)), state,
                                     masters, model=model)
        return (masters, state, gen), {"loss": loss.detach()}

    carry = (masters, opt.init(masters), torch.Generator().manual_seed(11))
    return model, opt, step, carry


def _dropout_run(sd, ckpt_dir, plan_events, restore_hook: bool):
    model, opt, step, carry = _dropout_setup(sd)
    driver = FusedTrainDriver(step, steps_per_dispatch=2,
                              metrics={"loss": "last"})
    hook = (lambda c: opt.copy_to_model(model, c[0])) if restore_hook \
        else None
    r = pres.ResilientTrainDriver(
        driver, ckpt_dir, registry=obs.MetricsRegistry(), backoff_s=0.001,
        fault_plan=None if plan_events is None
        else _events(pres, plan_events), on_restore=hook)
    carry, rep = r.run(carry, 4)
    half = {n: p.detach().clone() for n, p in model.named_parameters()}
    return _leaves(carry) + _leaves(half), rep


@pytest.fixture(scope="module")
def dropout_runs(tiny_sd, tmp_path_factory):
    """``get(name)``: the clean, chaos or planted run, computed once a
    process and only when asked."""
    d = tmp_path_factory.mktemp("dropout")
    legs = {"clean": (None, True), "chaos": (DROPOUT_CHAOS, True),
            "planted": (DROPOUT_CHAOS, False)}
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _dropout_run(tiny_sd, str(d / name), *legs[name])
        return memo[name]

    return get


def _bits_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


class TestResilientTrainDropout:
    def test_chaos_with_on_restore_is_bit_for_bit(self, dropout_runs):
        clean, rep0 = dropout_runs("clean")
        got, rep = dropout_runs("chaos")
        assert rep0["rollbacks"] == rep0["restarts"] == 0
        assert (rep["retries"], rep["rollbacks"], rep["restarts"]) == \
            (1, 1, 1)
        # masters, Adam moments and step, scaler state, generator state,
        # the model's bf16 half copy
        assert _bits_equal(got, clean)

    def test_planted_missing_on_restore_differs(self, dropout_runs):
        """Without ``copy_to_model`` after the restores the replayed
        windows run on the stale half copy: the check must fail."""
        clean, _ = dropout_runs("clean")
        got, rep = dropout_runs("planted")
        assert rep["rollbacks"] == 1
        assert not _bits_equal(got, clean)

    def test_template_aliases_no_live_tensor(self, tiny_sd):
        from apex_tpu_torch.resilience.train import restore_template

        _, _, _, carry = _dropout_setup(tiny_sd)
        tmpl = restore_template(carry)
        live = {id(x.untyped_storage()) for _, x in _flatten(carry)
                if isinstance(x, torch.Tensor)}
        for (p, x), (q, y) in zip(_flatten(carry), _flatten(tmpl)):
            assert p == q
            if isinstance(x, torch.Generator):
                assert y is x
            else:
                assert (y.shape, y.dtype, y.device) == \
                    (x.shape, x.dtype, x.device)
                assert id(y.untyped_storage()) not in live
                assert y.untyped_storage().nbytes() == x.element_size()


# ---------------------------------------------------------------------------
# serve self-healing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm(tiny_params):
    """The JAX config, the port's state dict, and decoders of both
    packages over the same seeded weights, each built at first use (a
    JAX decoder compiles its programs at its first call)."""
    cfg, params, sd = tiny_params
    pcfg = GPTConfig.tiny(compute_dtype=torch.float32)
    decs = {}

    def dec(pkg, name):
        kw = {"dec4": dict(tokens_per_dispatch=4),
              "full": dict(tokens_per_dispatch=8, spec_tokens=2,
                           kv_int8=True)}[name]
        if (pkg, name) not in decs:
            decs[pkg, name] = (
                jserve.GPTDecoder(cfg, params, **kw) if pkg == "jax"
                else serve.GPTDecoder(pcfg, sd, device="cpu", **kw))
        return decs[pkg, name]

    return cfg, sd, dec


def _prompts():
    rng = np.random.RandomState(3)
    pool = [int(t) for t in rng.randint(0, 1024, size=(48,))]
    ps = [pool[0:5], pool[3:14], pool[7:15], pool[2:18]]
    ps.append(list(ps[1]))  # a duplicate prompt: shared-prefix pages
    return ps


def _drain(pkg, dec, plan_events=None, prompts=None, new_tokens=8,
           clock=None, deadlines=None, **kw):
    """JAX's ``_drain`` on either package; ``clock`` a virtual clock the
    loop advances 5 ms a boundary.  Returns (engine, {uid: tokens})."""
    o = obs if pkg is pres else jobs
    plan = None if plan_events is None else _events(pkg, plan_events)
    eng = pkg.ResilientServeEngine(dec, fault_plan=plan,
                                   registry=o.MetricsRegistry(),
                                   clock=clock, **{**ENGINE_KW, **kw})
    prompts = _prompts() if prompts is None else prompts
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=new_tokens,
                   deadline_ms=None if deadlines is None else deadlines[i])
    if clock is None:
        return eng, eng.run()
    while eng.step():
        clock.advance_ms(5.0)
    return eng, eng.results()


def _counts(eng):
    return (eng.restarts, eng.retries, eng.deadline_exceeded,
            eng.backpressure_deferred)


SERVE_PLANS = {
    # name: (decoder, events, engine kwargs, submit kwargs)
    "crash_retry_spec_int8": (
        "full", [("serve/boundary", 2, ENGINE_CRASH, 0.0),
                 ("serve/boundary", 4, ENGINE_CRASH, 0.0),
                 ("serve/decode_window", 1, DISPATCH_ERROR, 0.0)], {}, {}),
    "decode_retry": (
        "dec4", [("serve/decode_window", 0, DISPATCH_ERROR, 0.0),
                 ("serve/decode_window", 2, DISPATCH_ERROR, 0.0)], {}, {}),
    "prefill_retries": (
        "dec4", [("serve/prefill", 0, DISPATCH_ERROR, 0.0),
                 ("serve/prefill_chunk", 1, DISPATCH_ERROR, 0.0),
                 ("serve/prefill", 3, STRAGGLER, 0.0)], {}, {}),
    "page_pressure": (
        "dec4", [("serve/boundary", 1, PAGE_PRESSURE, 64.0),
                 ("serve/boundary", 2, PAGE_PRESSURE, 64.0)], {}, {}),
    "pressure_and_crash": (
        "dec4", [("serve/boundary", 2, PAGE_PRESSURE, 12.0),
                 ("serve/boundary", 2, ENGINE_CRASH, 0.0)], {}, {}),
    "backpressure": (
        "dec4", None, dict(num_pages=9, backpressure=0.5),
        dict(prompts=_prompts()[:4], new_tokens=6)),
    "deadline_at_submit": (
        "dec4", None, {}, dict(prompts=[_prompts()[1], _prompts()[0]],
                               new_tokens=40, deadlines=[0.0, None])),
    "deadline_mid_stream": (
        "dec4", None, {}, dict(prompts=[_prompts()[3], _prompts()[2]],
                               new_tokens=24, deadlines=[12.0, 60.0])),
    "pass_through": ("dec4", None, dict(enabled=False), {}),
}


def _plan_run(pkg, dec, name):
    """One plan of :data:`SERVE_PLANS` through either package: (tokens,
    counts, pool pages in use at the end, the wrapper); the deadline
    plans on a virtual clock."""
    dname, evs, ekw, skw = SERVE_PLANS[name]
    clock = ((serve if pkg is pres else jserve).VirtualClock()
             if "deadline" in name else None)
    eng, toks = _drain(pkg, dec("port" if pkg is pres else "jax", dname),
                       evs, clock=clock, **{**skw, **ekw})
    return toks, _counts(eng), eng.engine.pool.in_use, eng


@pytest.fixture(scope="module")
def serve_runs(lm):
    """``get(plan)``: the port's run of a plan, computed once a process."""
    _, _, dec = lm
    memo = {}

    def get(name):
        if name not in memo:
            memo[name] = _plan_run(pres, dec, name)
        return memo[name]

    return get


class TestResilientServe:
    def test_every_plan_gives_jax_tokens_and_counters(self, lm, serve_runs):
        """Each plan of JAX's ``TestResilientServe`` (and three more):
        the tokens per uid, the restarts, retries, deadline and
        backpressure counts, and an empty pool at the end, as JAX's."""
        _, _, dec = lm
        for name in sorted(SERVE_PLANS):
            got, want = serve_runs(name), _plan_run(jres, dec, name)
            assert got[0] == want[0], name
            assert got[1] == want[1], name
            assert got[2] == want[2] == 0, name

    @pytest.mark.parametrize("name,counts", [
        ("crash_retry_spec_int8", (2, 1, 0, 0)),
        ("decode_retry", (0, 2, 0, 0)),
        ("prefill_retries", (0, 2, 0, 0)),
        ("page_pressure", (0, 0, 0, 0)),
        ("pressure_and_crash", (1, 0, 0, 0)),
        ("pass_through", (0, 0, 0, 0))])
    def test_faulted_run_is_the_clean_run(self, lm, serve_runs, name,
                                          counts):
        _, _, dec = lm
        dname = SERVE_PLANS[name][0]
        _, want = _drain(pres, dec("port", dname))
        assert serve_runs(name)[0] == want
        assert serve_runs(name)[1] == counts

    def test_backpressure_defers_then_drains(self, serve_runs):
        toks, counts, _, eng = serve_runs("backpressure")
        assert counts[3] >= 1
        assert all(len(t) == 6 for t in toks.values())
        assert not eng._deferred
        assert eng.registry.snapshot()[
            "resilience.backpressure_deferred"]["value"] == counts[3]

    def test_deadlines_abandon_with_partial_tokens(self, lm, serve_runs):
        toks, counts, _, eng = serve_runs("deadline_at_submit")
        assert counts[2] == 1 and eng.request(0).abandoned
        assert len(toks[0]) < 40 and len(toks[1]) == 40
        toks, counts, _, eng = serve_runs("deadline_mid_stream")
        _, _, dec = lm
        _, full = _drain(pres, dec("port", "dec4"),
                         prompts=[_prompts()[3]], new_tokens=24)
        assert counts[2] >= 1 and eng.request(0).abandoned
        assert 0 < len(toks[0]) < 24
        assert toks[0] == full[0][:len(toks[0])]  # a prefix of the stream

    def test_pressure_released_into_the_dead_pool(self, lm, monkeypatch):
        """A reservation made at the crashing boundary goes back to the
        dead engine's pool before the new engine exists; the new pool
        is never touched by it."""
        from apex_tpu_torch.serve.kv_cache import PagePool

        _, _, dec = lm
        log = []
        unreserve = PagePool.unreserve

        def logged(pool, pages):
            log.append((pool, list(pages)))
            return unreserve(pool, pages)

        monkeypatch.setattr(PagePool, "unreserve", logged)
        eng = pres.ResilientServeEngine(
            dec("port", "dec4"), registry=obs.MetricsRegistry(),
            fault_plan=_events(pres, SERVE_PLANS["pressure_and_crash"][1]),
            **ENGINE_KW)
        for p in _prompts():
            eng.submit(p, max_new_tokens=8)
        eng.step()
        eng.step()
        dead = eng.engine.pool
        free = dead.n_free
        eng.step()  # boundary 2: 12 pages reserved, then the crash
        assert eng.restarts == 1 and eng.engine.pool is not dead
        assert [(p is dead, len(pages)) for p, pages in log] == \
            [(True, min(12, free))]
        assert dead.n_free == free and not eng.injector._reserved
        assert eng.engine.pool.n_free + eng.engine.pool.in_use == \
            eng.engine.pool.num_pages - 1
        eng.run()
        assert len(log) == 1 and eng.engine.pool.in_use == 0

    def test_pass_through_propagates_a_crash(self, lm):
        _, _, dec = lm
        with pytest.raises(pres.HostPreemption):
            _drain(pres, dec("port", "dec4"),
                   [("serve/boundary", 1, ENGINE_CRASH, 0.0)],
                   prompts=_prompts()[:1], enabled=False)

    def test_retry_budget_exhaustion_dumps(self, lm, tmp_path):
        _, _, dec = lm
        rec = obs.FlightRecorder(capacity=64, enabled=True,
                                 dump_dir=str(tmp_path))
        plan = _events(pres, [("serve/decode_window", i, DISPATCH_ERROR, 0.0)
                              for i in (1, 2, 3)])
        eng = pres.ResilientServeEngine(
            dec("port", "dec4"), fault_plan=plan,
            registry=obs.MetricsRegistry(), flightrec=rec, max_retries=1,
            backoff_s=0.0, **ENGINE_KW)
        eng.submit(_prompts()[0], max_new_tokens=8)
        with pytest.raises(pres.RetryBudgetExceeded):
            eng.run()
        meta, events = obs.read_flightrec(str(tmp_path))
        assert meta["reason"] == "retry_budget_exceeded"
        assert any(e["kind"] == "resilience/retry" for e in events)

    def test_crash_after_swap_recovers_onto_swapped_weights(self, lm):
        """Swap to reseeded weights mid-stream, then crash: the tokens
        are those of the same swap without a crash.  The planted fault
        (the wrapper's rebuild template put back to the old decoder)
        must give other tokens."""
        _, sd, dec = lm
        gen = torch.Generator().manual_seed(1)
        new_sd = {n: (t + 0.05 * torch.randn(t.shape, generator=gen))
                  if t.dim() == 2 else t.clone() for n, t in sd.items()}

        def run(evs, plant=False):
            eng = pres.ResilientServeEngine(
                dec("port", "dec4"), registry=obs.MetricsRegistry(),
                fault_plan=None if evs is None else _events(pres, evs),
                **ENGINE_KW)
            for p in _prompts():
                eng.submit(p, max_new_tokens=12)
            for _ in range(3):
                eng.step()
            summary = eng.swap_weights(new_sd)
            digest = eng.weights_digest
            if plant:
                eng.decoder = dec("port", "dec4")
            out = eng.run()
            return out, eng, summary, digest

        want, _, summary, digest = run(None)
        assert not summary["identical"]
        crash = [("serve/boundary", 5, ENGINE_CRASH, 0.0)]
        got, eng, _, _ = run(crash)
        assert eng.restarts == 1
        assert got == want
        assert eng.weights_digest == digest
        assert eng.decoder is eng.engine.decoder
        planted, eng, _, _ = run(crash, plant=True)
        assert eng.restarts == 1 and planted != want

    def test_stage_and_prefix_tokens_refused_after_a_crash(self, lm):
        _, _, dec = lm
        d = dec("port", "dec4")
        src = serve.ServeEngine(d, prefill_only=True, **ENGINE_KW)
        prompt = [int(t) for t in np.random.RandomState(9).randint(
            0, 1024, size=(40,))]
        uid = src.submit(prompt, max_new_tokens=4)
        chunk = None
        while chunk is None:
            src.step()
            chunk = src.export_prefill_chunk(uid, 0)
        shared = prompt[:16]
        s2 = serve.ServeEngine(d, **ENGINE_KW)
        u2 = s2.submit(prompt, max_new_tokens=30)
        while not s2._active:
            s2.step()
        prefix = s2.export_prefix(shared)
        assert prefix is not None and s2.results.get(u2) is None

        eng = pres.ResilientServeEngine(
            d, registry=obs.MetricsRegistry(),
            fault_plan=_events(pres, [("serve/boundary", 0, ENGINE_CRASH,
                                       0.0)]), **ENGINE_KW)
        anchor = eng.import_prefix(prefix, shared)  # needs a free slot
        live = eng.adopt_stage_begin()
        stale = eng.adopt_stage_begin()
        assert live is not None and stale is not None and anchor is not None
        assert eng.adopt_stage_chunk(live, chunk)  # accepted before
        eng.step()  # the crash: a fresh engine
        assert eng.restarts == 1
        assert eng.adopt_stage_chunk(stale, chunk) is False
        assert eng.adopt_stage_commit(stale, chunk, 4) is None
        eng.adopt_stage_abort(stale)  # a no-op
        eng.release_prefix(anchor)    # a no-op
        assert eng.engine.pool.in_use == 0
        fresh = eng.adopt_stage_begin()
        assert eng.adopt_stage_chunk(fresh, chunk)

    def test_handoff_pass_throughs(self, lm):
        """export_handoff/adopt/detach through two wrappers: the adopted
        request streams the source engine's tokens."""
        _, _, dec = lm
        d = dec("port", "dec4")
        src = pres.ResilientServeEngine(d, registry=obs.MetricsRegistry(),
                                        prefill_only=True, **ENGINE_KW)
        dst = pres.ResilientServeEngine(d, registry=obs.MetricsRegistry(),
                                        **ENGINE_KW)
        uid = src.submit(_prompts()[3], max_new_tokens=10)
        while not src.engine._active:
            src.step()
        ho = src.export_handoff(uid)
        new = dst.adopt(serve.KVHandoff.from_bytes(ho.to_bytes()), 10)
        seed = src.detach(uid)
        out = dst.run()
        _, want = _drain(pres, d, prompts=[_prompts()[3]], new_tokens=10)
        assert seed and want[0][:len(seed)] == seed
        assert out[new] == want[0]
        assert dst.request(new).prompt == [int(t) for t in ho.tokens]
        with pytest.raises(KeyError):
            src.export_handoff(uid)


# ---------------------------------------------------------------------------
# the flight recorder's postmortems
# ---------------------------------------------------------------------------

def _chaos_run(pkg, dec, dump_dir):
    """tests/test_flightrec.py's ``_chaos_run`` on either package."""
    o = obs if pkg is pres else jobs
    rec = o.FlightRecorder(capacity=64, enabled=True, dump_dir=str(dump_dir))
    eng = pkg.ResilientServeEngine(
        dec, fault_plan=pkg.FaultPlan.from_seed(
            1, horizon=12, stall_s=0.0,
            rates={DISPATCH_ERROR: 0.10, ENGINE_CRASH: 0.12}),
        registry=o.MetricsRegistry(), flightrec=rec, **ENGINE_KW)
    for p in _prompts()[:4]:
        eng.submit(p, max_new_tokens=8)
    return eng, eng.run()


class TestPostmortem:
    def test_seeded_chaos_leaves_deterministic_dump(self, lm, tmp_path):
        _, _, dec = lm
        ea, oa = _chaos_run(pres, dec("port", "dec4"), tmp_path / "a")
        eb, ob = _chaos_run(pres, dec("port", "dec4"), tmp_path / "b")
        assert ea.restarts >= 1 and oa == ob
        pa, pb = (tmp_path / n / "flightrec.jsonl" for n in "ab")
        assert pa.read_bytes() == pb.read_bytes()
        meta, events = obs.read_flightrec(str(pa))
        assert meta["reason"] == "engine_crash"
        fault = [i for i, e in enumerate(events) if e["kind"] == "fault"
                 and e["attrs"]["kind"] == ENGINE_CRASH]
        assert fault
        assert any(e["kind"] == "serve/boundary"
                   for e in events[:fault[-1]])
        assert events[fault[-1] - 1]["kind"] == "serve/boundary"
        seqs = [e["seq"] for e in events]
        assert seqs == sorted(seqs)

    def test_chaos_dump_is_jax_byte_for_byte(self, lm, tmp_path):
        """The event sequence, kinds and attrs, is JAX's: the same
        bytes, the same tokens and recovery counts."""
        _, _, dec = lm
        ep, op = _chaos_run(pres, dec("port", "dec4"), tmp_path / "p")
        ej, oj = _chaos_run(jres, dec("jax", "dec4"), tmp_path / "j")
        assert op == oj
        assert (ep.retries, ep.restarts) == (ej.retries, ej.restarts)
        assert (tmp_path / "p" / "flightrec.jsonl").read_bytes() == \
            (tmp_path / "j" / "flightrec.jsonl").read_bytes()

    def test_train_rollback_dumps_nan_rollback(self, tmp_path):
        xs = torch.from_numpy(np.random.RandomState(0).randn(8, 16)
                              .astype(np.float32))
        ys = xs[:, :8] * 2.0

        def step(carry, _):
            w = carry["w"].detach().requires_grad_(True)
            loss = torch.mean(torch.square(xs @ w - ys))
            g, = torch.autograd.grad(loss, w)
            return {"w": (w - 0.05 * g).detach()}, {"loss": loss.detach()}

        rec = obs.FlightRecorder(capacity=64, enabled=True,
                                 dump_dir=str(tmp_path))
        driver = FusedTrainDriver(step, steps_per_dispatch=2,
                                  metrics={"loss": "last"})
        r = pres.ResilientTrainDriver(
            driver, str(tmp_path / "ckpt"),
            fault_plan=_events(pres, [("train/meters", 2, NAN_METERS, 0.0)]),
            registry=obs.MetricsRegistry(), flightrec=rec, backoff_s=0.001)
        w0 = {"w": torch.from_numpy(np.random.RandomState(1).randn(16, 8)
                                    .astype(np.float32))}
        _, rep = r.run(w0, 4)
        assert rep["rollbacks"] == 1
        meta, events = obs.read_flightrec(str(tmp_path))
        assert meta["reason"] == "nan_rollback"
        assert any(e["kind"] == "fault" and e["attrs"]["kind"] == NAN_METERS
                   for e in events)
        assert rec.kinds()["resilience/rollback"] == 1

    def test_wrapper_records_engine_boundaries(self, lm):
        _, _, dec = lm
        rec = obs.FlightRecorder(capacity=128, enabled=True)
        eng = pres.ResilientServeEngine(
            dec("port", "dec4"), registry=obs.MetricsRegistry(),
            flightrec=rec, **ENGINE_KW)
        eng.submit(_prompts()[0], max_new_tokens=6)
        eng.run()
        kinds = rec.kinds()
        assert {"serve/boundary", "serve/decode_window",
                "serve/retire"} <= set(kinds)


# ---------------------------------------------------------------------------
# the load harness
# ---------------------------------------------------------------------------

def _slo_plan(pkg, **kw):
    """tests/test_slo.py's ``_mkplan``."""
    base = dict(requests=12, rate_rps=150.0, arrival="bursty",
                burst_factor=6.0, burst_on_s=0.1, burst_off_s=0.3,
                vocab_size=97, n_prefixes=3, prefix_len=6, zipf_s=1.2,
                shared_frac=0.5, prompt_min=2, prompt_scale=4.0,
                prompt_alpha=1.2, prompt_cap=30, output_min=2,
                output_scale=3.0, output_alpha=1.3, output_cap=10,
                priorities=(0, 2), interactive_max_prompt=12)
    base.update(kw)
    return pkg.TrafficPlan.from_seed(5, **base)


def _loadgen_leg(pkg, dec, resilient=True, **plan_kw):
    spkg, o = (serve, obs) if pkg is pres else (jserve, jobs)
    gen = spkg.LoadGen(_slo_plan(spkg, **plan_kw), step_cost_ms=5.0)
    if resilient:
        eng = pkg.ResilientServeEngine(dec, clock=gen.clock,
                                       registry=o.MetricsRegistry(),
                                       **ENGINE_KW)
    else:
        eng = spkg.ServeEngine(dec, clock=gen.clock,
                               registry=o.MetricsRegistry(), **ENGINE_KW)
    return gen.run(eng)


class TestLoadGen:
    DEADLINES = dict(deadline_frac=1.0, deadline_ms=30.0, output_cap=16)

    def test_deadline_run_is_replayable(self, lm):
        _, _, dec = lm
        a = _loadgen_leg(pres, dec("port", "dec4"), **self.DEADLINES)
        b = _loadgen_leg(pres, dec("port", "dec4"), **self.DEADLINES)
        assert a.to_json() == b.to_json()
        assert a.abandoned > 0 and a.completed > 0
        assert a.abandonment_rate == pytest.approx(
            a.abandoned / (a.abandoned + a.completed), abs=1e-3)

    def test_reports_and_streams_are_jax(self, lm):
        """The deadline run's report is JAX's byte for byte (abandoned and
        completed counts, tokens per uid included); without deadlines
        ``ServeEngine``, ``ResilientServeEngine`` and JAX stream the same
        tokens."""
        _, _, dec = lm
        got = _loadgen_leg(pres, dec("port", "dec4"), **self.DEADLINES)
        want = _loadgen_leg(jres, dec("jax", "dec4"), **self.DEADLINES)
        assert (got.abandoned, got.completed, got.tokens) == \
            (want.abandoned, want.completed, want.tokens)
        assert got.to_json() == want.to_json()
        plain = _loadgen_leg(pres, dec("port", "dec4"), resilient=False)
        wrapped = _loadgen_leg(pres, dec("port", "dec4"))
        want = _loadgen_leg(jres, dec("jax", "dec4"))
        assert plain.completed == 12
        assert plain.tokens == wrapped.tokens == want.tokens
        assert wrapped.to_json() == want.to_json()


# ---------------------------------------------------------------------------
# the engine with no injector
# ---------------------------------------------------------------------------

class _KernelCalls:
    """Counts the decoder's calls of the LayerNorm and paged-attention
    wrappers (on CPU tensors the wrappers' own launch counts stay 0)."""

    def __init__(self, monkeypatch):
        self.n = {"layer_norm": 0, "paged_fused_attention": 0}
        ln, pa = fused_layer_norm.layer_norm, \
            gpt_mod._attn.paged_fused_attention

        def count_ln(*a, **k):
            self.n["layer_norm"] += 1
            return ln(*a, **k)

        def count_pa(*a, **k):
            self.n["paged_fused_attention"] += 1
            return pa(*a, **k)

        monkeypatch.setattr(fused_layer_norm, "layer_norm", count_ln)
        monkeypatch.setattr(gpt_mod._attn, "paged_fused_attention",
                            count_pa)


def test_engine_without_injector_is_unchanged(lm, monkeypatch):
    """One plan of requests through the engine with no injector, with an
    empty plan's injector and through JAX's engine: the same tokens, the
    same recorder events (byte for byte JAX's dump), and per forward
    exactly 2L + 1 LayerNorms and L paged calls, both runs alike."""
    _, _, dec = lm
    calls = _KernelCalls(monkeypatch)
    out = {}
    for leg in ("none", "empty", "jax"):
        pkg, o, spkg = ((jres, jobs, jserve) if leg == "jax"
                        else (pres, obs, serve))
        fr = o.FlightRecorder(capacity=4096, enabled=True)
        inj = (pkg.FaultInjector(pkg.FaultPlan([]), registry=o
                                 .MetricsRegistry(), tracer=o.NULL_TRACER,
                                 flightrec=fr) if leg == "empty" else None)
        eng = spkg.ServeEngine(dec("jax" if leg == "jax" else "port",
                                   "dec4"), registry=o.MetricsRegistry(),
                               flightrec=fr, fault_injector=inj,
                               **ENGINE_KW)
        for p in _prompts():
            eng.submit(p, max_new_tokens=8)
        before = dict(calls.n)
        toks = eng.run()
        forwards = eng.prefill_dispatches + 4 * eng.decode_dispatches
        out[leg] = (toks, fr.events(), {k: v - before[k]
                                        for k, v in calls.n.items()},
                    forwards)
    assert out["none"][0] == out["empty"][0] == out["jax"][0]
    assert out["none"][1] == out["empty"][1] == out["jax"][1]
    assert out["none"][2] == out["empty"][2] == {
        "layer_norm": 5 * out["none"][3],
        "paged_fused_attention": 2 * out["none"][3]}
    assert out["none"][3] == out["jax"][3]
