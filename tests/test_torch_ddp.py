"""apex_tpu_torch's data-parallel layer vs the JAX package, on the CPU.

Four gloo processes (one gang, spawned once by the module fixture
``gang``: this file run as a script) hold one replica each and take rows
``[r n / 4, (r + 1) n / 4)`` of one numpy-seeded global batch; JAX runs
the same on a 4-device sub-mesh (``data_parallel_mesh(4)``) of the
conftest's 8 virtual CPU devices, whose ``P("data")`` split is the same.
Every worker case writes its results to the gang's directory, and the
tests below read them, so each case counts as a test.  The workers
import no JAX and run on one thread; the gang has a 120 s join timeout
and rendezvouses through a file, never a fixed port.

Tolerances (ROADMAP's cross-framework ones): fp32 results within 1e-5
of the largest magnitude of JAX's; bf16 results within one bf16 ulp of
each element or 1e-2 of the largest magnitude; the O2 toy model (bf16
products, fp32 masters) within 1e-2 relative L2 of JAX's masters after
20 steps and its losses (of bf16 predictions) by the bf16 rule;
collective counts exact;
world 1 (each rank its own subgroup of one) bit for bit the run without
DDP.  ``LARC`` (clip and scale, 7 steps, and one O2 ``AmpOptimizer``
route with a skipped step) and the flatten round trip run in the test
process, fp32 within 1e-5.  The launcher's failure reporting runs gangs
of bare Python processes, without torch.
"""
import os
import sys

import numpy as np
import pytest
import torch

W = 4                       # ranks, and devices of the JAX sub-mesh
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120

if __name__ != "__main__":  # the gang's workers import no JAX
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import apex_tpu.amp as jamp
    from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
    from apex_tpu.optimizers.larc import larc as jax_larc
    from apex_tpu.parallel import DistributedDataParallel as JaxDDP
    from apex_tpu.parallel import Reducer as JaxReducer
    from apex_tpu.parallel import data_parallel_mesh
    from apex_tpu.parallel import flatten_tree as jax_flatten_tree
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu.train import FusedTrainDriver as JaxDriver
    from apex_tpu.train import amp_microbatch_step as jax_microbatch_step

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import fused_sgd, larc
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    Reducer,
    data_parallel_step,
    flatten_tree,
    new_groups,
    replicate,
    shard_batch,
    syncbn_groups,
    unflatten_tree,
)
from apex_tpu_torch.train import FusedTrainDriver, amp_microbatch_step

# -- inputs, made from numpy seeds on both sides -------------------------------

#: allreduce cases: (DDP keyword arguments, leaf "b" in bf16, enabled,
#: subgroups of 2)
ALLREDUCE = {
    "average": ({}, False, True, False),
    "sum": ({"gradient_average": False}, False, True, False),
    "predivide_4": ({"gradient_predivide_factor": 4.0}, False, True, False),
    "predivide_4_sum": ({"gradient_predivide_factor": 4.0,
                         "gradient_average": False}, False, True, False),
    "bf16_leaves": ({}, True, True, False),
    "always_fp32_bf16": ({"allreduce_always_fp32": True}, True, True, False),
    "no_sync": ({}, False, False, False),
    "groups_of_2": ({}, False, True, True),
}


def _tree_inputs(seed: int):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(W, 37).astype(np.float32),
            "b": (1.0 + rng.randn(W, 3, 5)).astype(np.float32)}


def _race_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(W, 4).astype(np.float32) for _ in range(5)]


def _toy_inputs():
    """The O2 toy model of tests/test_parallel_ddp.py:130-168."""
    rng = np.random.RandomState(0)
    w = rng.randn(8, 4).astype(np.float32) * 0.3
    x = rng.randn(64, 8).astype(np.float32)
    y = x @ rng.randn(8, 4).astype(np.float32)
    return w, x, y


def _accum_inputs():
    """The linear model of tests/test_accum_driver.py: 8 microbatches of
    32 rows."""
    rng = np.random.RandomState(0)
    w = rng.randn(16, 4).astype(np.float32) * 0.3
    xs = rng.randn(8, 32, 16).astype(np.float32)
    ys = rng.randn(8, 32, 4).astype(np.float32)
    return w, xs, ys


TOY_STEPS = 20
ACCUM_M = 2

# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    """A copy (the masters are updated in place)."""
    return t.detach().float().numpy().copy()


def _case_allreduce(rank, name):
    kw, bf16, enabled, grouped = ALLREDUCE[name]
    if grouped:
        kw = dict(kw, groups=new_groups(syncbn_groups(W, 2)))
    tree = {k: torch.from_numpy(v[rank]) for k, v in
            _tree_inputs(1).items()}
    if bf16:
        tree["b"] = tree["b"].to(torch.bfloat16)
    out = DistributedDataParallel(**kw).allreduce(tree, enabled=enabled)
    return {k: _np(v) for k, v in out.items()} | {
        "dtypes": {k: str(v.dtype) for k, v in out.items()}}


def _case_reducer(rank, average):
    tree = {"w": torch.from_numpy(_tree_inputs(2)["a"][rank])}
    return {"w": _np(Reducer(average=average).reduce(tree)["w"])}


def _case_race(rank):
    ddp = DistributedDataParallel(gradient_average=False)
    p = torch.zeros(4)
    seen = []
    for x in _race_inputs():
        xr = torch.from_numpy(x[rank]).requires_grad_()
        q = p.clone().requires_grad_()
        (g,) = torch.autograd.grad((q * xr).sum(), [q])
        p = p + ddp.allreduce({"p": g})["p"]
        seen.append(_np(p))
    return {"params": np.stack(seen)}


def _toy_run(ddp, x, y, steps=TOY_STEPS):
    """The O2 toy step, ``steps`` times: masters and losses."""
    w0, _, _ = _toy_inputs()
    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_sgd(0.1, momentum=0.9), amp_)
    masters = {"w": torch.from_numpy(w0.copy())}
    state = opt.init(masters)
    losses = []
    for _ in range(steps):
        mp = {k: v.detach().requires_grad_()
              for k, v in opt.model_params(masters).items()}
        pred = x.to(torch.bfloat16) @ mp["w"]
        loss = (pred.float() - y).square().mean()
        (g,) = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]),
                                   [mp["w"]])
        grads = {"w": g} if ddp is None else ddp.allreduce({"w": g})
        masters, state, _ = opt.step(grads, state, masters)
        losses.append(loss.detach())
    return masters, state, torch.stack(losses)


def _case_toy(rank):
    _, x, y = _toy_inputs()
    x, y = shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    ddp = DistributedDataParallel(allreduce_always_fp32=True)
    masters, state, losses = _toy_run(ddp, x, y)
    mean_losses = Reducer(average=True).reduce(losses)
    return {"w": _np(masters["w"]), "losses": _np(mean_losses),
            "scale": float(state.scaler[0].loss_scale)}


def _accum_setup():
    w0, _, _ = _accum_inputs()
    amp_ = amp.initialize("O2")
    opt = amp.AmpOptimizer(fused_sgd(0.05, momentum=0.9), amp_)

    def grad_fn(carry, batch):
        masters, state = carry
        x, y = batch
        mp = {k: v.detach().requires_grad_()
              for k, v in opt.model_params(masters).items()}
        pred = x.to(torch.bfloat16) @ mp["w"]
        loss = (pred.float() - y).square().mean()
        (g,) = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]),
                                   [mp["w"]])
        return {"w": g}, {"loss": loss.detach()}

    def fresh():
        m = {"w": torch.from_numpy(w0.copy())}
        return (m, opt.init(m))

    return grad_fn, opt, fresh


def _accum_run(ddp, rows):
    """Two windows of 2 steps of M microbatches on this rank's ``rows``."""
    _, xs, ys = _accum_inputs()
    xs, ys = torch.from_numpy(xs[:, rows]), torch.from_numpy(ys[:, rows])
    grad_fn, opt, fresh = _accum_setup()
    step = amp_microbatch_step(grad_fn, opt, microbatches=ACCUM_M, ddp=ddp)
    driver = FusedTrainDriver(step, steps_per_dispatch=2,
                              metrics={"scale": "last", "skipped": "sum"})
    carry = fresh()
    for w in range(2):
        sl = slice(w * 2 * ACCUM_M, (w + 1) * 2 * ACCUM_M)
        carry, _ = driver.run_window(carry, (xs[sl], ys[sl]))
    return carry


def _case_accum(rank):
    rows = slice(rank * 8, (rank + 1) * 8)
    masters, state = _accum_run(
        DistributedDataParallel(allreduce_always_fp32=True), rows)
    return {"w": _np(masters["w"]),
            "scale": float(state.scaler[0].loss_scale)}


def _case_world1(rank):
    """Each rank its own subgroup of one: DDP at world 1 against no DDP,
    on this rank's rows, bit for bit (toy O2 steps and the accumulation
    step)."""
    solo = DistributedDataParallel(groups=new_groups([[r] for r in
                                                      range(W)]))
    _, x, y = _toy_inputs()
    x, y = torch.from_numpy(x[rank::W]), torch.from_numpy(y[rank::W])
    m1, s1, l1 = _toy_run(solo, x, y)
    m0, s0, l0 = _toy_run(None, x, y)
    rows = slice(rank * 8, (rank + 1) * 8)
    a1, a0 = _accum_run(solo, rows), _accum_run(None, rows)
    return {"toy_equal": bool(torch.equal(m1["w"], m0["w"])
                              and torch.equal(l1, l0)
                              and torch.equal(s1.opt_state.momentum_buf["w"],
                                              s0.opt_state.momentum_buf["w"])),
            "accum_equal": bool(torch.equal(a1[0]["w"], a0[0]["w"])
                                and torch.equal(
                                    a1[1].opt_state.momentum_buf["w"],
                                    a0[1].opt_state.momentum_buf["w"]))}


def _case_dp_step(rank):
    mean = Reducer(average=True)

    def step(state, batch):
        g = mean.reduce(batch.mean())
        return state + g, {"g": g}

    batch = torch.arange(16, dtype=torch.float32)
    s1, m1 = data_parallel_step(step)(torch.zeros(()), shard_batch(batch))
    two = torch.stack([batch, 100 + batch])
    s2, m2 = data_parallel_step(step, steps_per_dispatch=2)(
        torch.zeros(()), two[:, rank * 4:(rank + 1) * 4])
    return {"k1": [float(s1), float(m1["g"])],
            "k2": [float(s2), _np(m2["g"]).tolist()]}


def _case_replicate(rank):
    tree = {"a": torch.full((3,), float(rank)),
            "b": [torch.arange(4) * (rank + 1)]}
    replicate(tree)
    rows = shard_batch(torch.arange(8))
    try:
        shard_batch(torch.arange(7))
        raised = False
    except ValueError:
        raised = True
    return {"a": _np(tree["a"]), "b": tree["b"][0].tolist(),
            "rows": rows.tolist(), "ragged_raises": raised}


def _case_example(rank):
    from apex_tpu_torch.examples.distributed_data_parallel import train

    return {"losses": train(device="cpu", log_every=0)}


WORKER_CASES = {
    **{f"allreduce_{n}": (lambda r, n=n: _case_allreduce(r, n))
       for n in ALLREDUCE},
    "reducer_sum": lambda r: _case_reducer(r, False),
    "reducer_mean": lambda r: _case_reducer(r, True),
    "race": _case_race,
    "toy_o2": _case_toy,
    "accum": _case_accum,
    "world1": _case_world1,
    "dp_step": _case_dp_step,
    "replicate": _case_replicate,
    "example": _case_example,
}


def _worker(out_dir: str) -> None:
    import torch.distributed as dist

    from apex_tpu_torch.parallel import (collective_counts,
                                         init_distributed,
                                         reset_collective_counts)

    torch.set_num_threads(1)
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    results = {}
    for name, fn in WORKER_CASES.items():
        reset_collective_counts()
        results[name] = fn(rank)
        results[name]["collectives"] = collective_counts()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang, then JAX --------------------------------------


def _launch_gang(script: str, out_dir) -> list:
    from apex_tpu_torch.parallel import launch

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([script, str(out_dir)], W, env=env, timeout_s=GANG_TIMEOUT_S,
           echo_stderr=False, check=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(W)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    return _launch_gang(os.path.abspath(__file__),
                        tmp_path_factory.mktemp("ddp_gang"))


@pytest.fixture(scope="module")
def mesh4():
    return data_parallel_mesh(W)


def _shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs, check_vma=False))


def _bf16_ulp(x):
    big = np.maximum(np.abs(x), 1e-30)
    return np.exp2(np.floor(np.log2(big)) - 7)


def _close(got, want, bf16=False) -> bool:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    if bf16:
        return bool(np.all(np.abs(got - want)
                           <= np.maximum(_bf16_ulp(want), 1e-2 * top)))
    return bool(np.abs(got - want).max() <= 1e-5 * top)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", sorted(ALLREDUCE))
def test_allreduce_matches_jax(gang, mesh4, name):
    """Each policy of ``DistributedDataParallel.allreduce`` against JAX's
    on the 4-device mesh, with one collective per gradient dtype."""
    kw, bf16, enabled, grouped = ALLREDUCE[name]
    if grouped:
        kw = dict(kw, axis_index_groups=syncbn_groups(W, 2))
    ddp = JaxDDP(axis_name="data", **kw)
    inputs = _tree_inputs(1)
    tree = {"a": jnp.asarray(inputs["a"]),
            "b": jnp.asarray(inputs["b"],
                             jnp.bfloat16 if bf16 else jnp.float32)}
    f = _shmap(lambda t: ddp.allreduce(t, enabled=enabled), mesh4,
               (P("data"),), P("data"))
    want = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32),
                                  f(tree))
    for rank, res in enumerate(gang):
        got = res[f"allreduce_{name}"]
        assert got["dtypes"] == {"a": "torch.float32",
                                 "b": "torch.bfloat16" if bf16
                                 else "torch.float32"}
        assert _close(got["a"], want["a"][rank]), (rank, "a")
        assert _close(got["b"], want["b"][rank], bf16), (rank, "b")
        assert got["collectives"] == ({"ddp": 1 + bf16} if enabled else {})


@pytest.mark.parametrize("average", [False, True])
def test_reducer_matches_jax(gang, mesh4, average):
    r = JaxReducer(axis_name="data", average=average)
    x = jnp.asarray(_tree_inputs(2)["a"])
    want = np.asarray(_shmap(lambda t: r.reduce({"w": t})["w"], mesh4,
                             (P("data"),), P("data"))(x))
    for rank, res in enumerate(gang):
        got = res["reducer_mean" if average else "reducer_sum"]
        assert _close(got["w"], want[rank])
        assert got["collectives"] == {"ddp": 1}


def test_exact_sums_over_five_iterations(gang, mesh4):
    """tests/test_parallel_ddp.py:100-128: the summed gradient of
    sum(p * x) after each iteration is the running total of x."""
    ddp = JaxDDP(axis_name="data", gradient_average=False)

    def step(params, x):
        g = jax.grad(lambda p: jnp.sum(p * x))(params)
        return params + ddp.allreduce({"p": g})["p"]

    f = _shmap(step, mesh4, (P(), P("data")), P())
    params, total = jnp.zeros((4,), jnp.float32), 0.0
    for it, x in enumerate(_race_inputs()):
        params = f(params, jnp.asarray(x))
        total = total + x.sum(axis=0)
        for res in gang:
            got = res["race"]["params"][it]
            np.testing.assert_allclose(got, total, rtol=1e-5, atol=1e-6)
            assert _close(got, np.asarray(params))
    assert all(res["race"]["collectives"] == {"ddp": 5} for res in gang)


def _jax_toy():
    w0, x, y = _toy_inputs()
    amp_ = jamp.initialize("O2")
    opt = jamp.AmpOptimizer(jax_fused_sgd(0.1, momentum=0.9), amp_)
    ddp = JaxDDP(axis_name="data", allreduce_always_fp32=True)

    def step(carry, batch):
        params, state = carry
        xb, yb = batch

        def scaled(mp):
            pred = xb.astype(jnp.bfloat16) @ opt.model_params(mp)["w"]
            loss = jnp.mean(jnp.square(pred.astype(jnp.float32) - yb))
            return amp_.scale_loss(loss, state.scaler[0]), loss

        grads, loss = jax.grad(scaled, has_aux=True)(params)
        params, state, _ = opt.step(ddp.allreduce(grads), state, params)
        return (params, state), jax.lax.pmean(loss, "data")

    params = {"w": jnp.asarray(w0)}
    return step, (params, opt.init(params)), (jnp.asarray(x),
                                              jnp.asarray(y))


def test_o2_toy_step_twenty_steps_matches_jax(gang, mesh4):
    """The O2 DDP toy step of tests/test_parallel_ddp.py:130-168 (fp32
    all-reduce of bf16 grads, fused_sgd with momentum), 20 steps: the
    masters within 1e-2 relative L2 of JAX's, each step's mean loss by
    the bf16 rule, every rank's masters identical."""
    step, carry, batch = _jax_toy()
    f = _shmap(step, mesh4, ((P(), P()), P("data")), ((P(), P()), P()))
    losses = []
    for _ in range(TOY_STEPS):
        carry, loss = f(carry, batch)
        losses.append(float(loss))
    want_w = np.asarray(carry[0]["w"])
    ranks = [res["toy_o2"] for res in gang]
    assert all(np.array_equal(r["w"], ranks[0]["w"]) for r in ranks)
    got = ranks[0]
    assert _rel_l2(got["w"], want_w) <= 1e-2, _rel_l2(got["w"], want_w)
    # the losses of bf16 predictions: the bf16 rule
    assert _close(got["losses"], losses, bf16=True), (got["losses"], losses)
    assert got["losses"][-1] < 0.1 * got["losses"][0]
    assert got["scale"] == float(carry[1].scaler[0].loss_scale)
    # one collective a step for the grads (one dtype) plus the losses'
    assert got["collectives"] == {"ddp": TOY_STEPS + 1}


def test_microbatch_step_with_ddp_matches_jax(gang, mesh4):
    """``amp_microbatch_step(ddp=)`` at M = 2, two windows of two steps
    each, against JAX's driver over the mesh: the masters within 1e-2
    relative L2, the scale equal, and exactly one all-reduce a
    boundary."""
    w0, xs, ys = _accum_inputs()
    jamp_ = jamp.initialize("O2")
    jopt = jamp.AmpOptimizer(jax_fused_sgd(0.05, momentum=0.9), jamp_)

    def grad_fn(carry, batch):
        params, state = carry
        x, y = batch

        def scaled(mp):
            pred = x.astype(jnp.bfloat16) @ jopt.model_params(mp)["w"]
            loss = jnp.mean(jnp.square(pred.astype(jnp.float32) - y))
            return jamp_.scale_loss(loss, state.scaler[0]), loss

        grads, loss = jax.grad(scaled, has_aux=True)(params)
        return grads, {"loss": loss}

    ddp = JaxDDP(axis_name="data", allreduce_always_fp32=True)
    step = jax_microbatch_step(grad_fn, jopt, ddp=ddp, microbatches=ACCUM_M)
    driver = JaxDriver(step, steps_per_dispatch=2, mesh=mesh4,
                       check_vma=False)
    params = {"w": jnp.asarray(w0)}
    carry = (params, jopt.init(params))
    for w in range(2):
        sl = slice(w * 2 * ACCUM_M, (w + 1) * 2 * ACCUM_M)
        carry, _ = driver.run_window(carry, (jnp.asarray(xs[sl]),
                                             jnp.asarray(ys[sl])))
    want = np.asarray(carry[0]["w"])
    for res in gang:
        got = res["accum"]
        assert _rel_l2(got["w"], want) <= 1e-2, _rel_l2(got["w"], want)
        assert np.array_equal(got["w"], gang[0]["accum"]["w"])
        assert got["scale"] == float(carry[1].scaler[0].loss_scale)
        assert got["collectives"] == {"ddp": 4}  # 2 windows x 2 steps


@pytest.mark.parametrize("what", ["toy_equal", "accum_equal"])
def test_world_one_is_bitwise_no_ddp(gang, what):
    assert all(res["world1"][what] for res in gang)


def test_data_parallel_step(gang):
    """K = 1 keeps the step; K = 2 runs two steps and stacks the
    per-step metrics (tests/test_parallel_ddp.py's wrapper test: the mean
    of arange(16) is 7.5)."""
    for res in gang:
        assert res["dp_step"]["k1"] == [7.5, 7.5]
        assert res["dp_step"]["k2"] == [7.5 + 107.5, [7.5, 107.5]]


def test_replicate_and_shard_batch(gang):
    for rank, res in enumerate(gang):
        got = res["replicate"]
        assert got["a"].tolist() == [0.0] * 3 and got["b"] == [0, 1, 2, 3]
        assert got["rows"] == [2 * rank, 2 * rank + 1]
        assert got["ragged_raises"]
        assert got["collectives"] == {"broadcast": 2}


def test_example_trains_and_replicas_agree(gang):
    losses = [res["example"]["losses"] for res in gang]
    assert len(losses[0]) == 50 and all(l == losses[0] for l in losses)
    assert losses[0][-1] < losses[0][0]  # the example's own exit check


# -- in the test process: flatten, LARC, the launcher, the policy ---------------


def test_flatten_round_trip_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(7).astype(np.float32)
    c = rng.randn(2, 2).astype(np.float32)
    tree = {"a": torch.from_numpy(a), "b": [torch.from_numpy(b),
                                            torch.from_numpy(c).bfloat16()]}
    flat, spec = flatten_tree(tree)
    assert flat.dim() == 1 and flat.dtype == torch.float32
    jflat, _ = jax_flatten_tree({"a": jnp.asarray(a),
                                 "b": [jnp.asarray(b),
                                       jnp.asarray(c, jnp.bfloat16)]})
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    back = unflatten_tree(flat, spec)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"][0], tree["b"][0])
    assert back["b"][1].dtype == torch.bfloat16
    assert torch.equal(back["b"][1], tree["b"][1])


def test_grad_presum_sees_the_microbatch_sum():
    """``grad_presum`` runs on the accumulated gradient before the
    division by M (off-mesh: ``ddp=None``)."""
    grad_fn, opt, fresh = _accum_setup()
    _, xs, ys = _accum_inputs()
    xs, ys = torch.from_numpy(xs[:2]), torch.from_numpy(ys[:2])
    seen = []

    def presum(acc):
        seen.append(acc["w"].clone())
        return acc

    step = amp_microbatch_step(grad_fn, opt, microbatches=2,
                               grad_presum=presum)
    FusedTrainDriver(step, steps_per_dispatch=1).run_window(fresh(),
                                                            (xs, ys))
    carry = fresh()
    g0, _ = grad_fn(carry, (xs[0], ys[0]))
    g1, _ = grad_fn(carry, (xs[1], ys[1]))
    assert len(seen) == 1
    assert torch.equal(seen[0], g0["w"].float() + g1["w"].float())


LARC_SHAPES = {"p0": (37,), "p1": (11, 13), "p2": (1,)}
LARC_CASES = {"clip": dict(clip=True, trust_coefficient=0.02),
              "scale": dict(clip=False, trust_coefficient=0.02,
                            weight_decay=1e-2)}


def _larc_inputs(steps=7):
    rng = np.random.RandomState(3)
    params = {k: rng.randn(*s).astype(np.float32)
              for k, s in LARC_SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32)
              for k, s in LARC_SHAPES.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("case", sorted(LARC_CASES))
def test_larc_matches_jax_over_seven_steps(case):
    lr = 0.1
    kw = LARC_CASES[case]
    params, grads = _larc_inputs()
    jtx = jax_larc(jax_fused_sgd(lr, momentum=0.9), learning_rate=lr, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jtx.init(jp)
    jstep = jax.jit(jtx.update)
    tx = larc(fused_sgd(lr, momentum=0.9), learning_rate=lr, **kw)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    for g in grads:
        upd, jstate = jstep({k: jnp.asarray(v) for k, v in g.items()},
                            jstate, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        u, state = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                             state, tp)
        tp = {k: tp[k] + u[k] for k in tp}
    assert int(state.step) == int(jstate.step) == len(grads)
    for k in tp:
        assert _close(tp[k].numpy(), np.asarray(jp[k])), k


def test_larc_through_amp_optimizer_skips_an_overflow():
    """O2 ``AmpOptimizer`` over LARC (the unfused route): three steps of
    the same scaled grads as JAX's, the second with an inf that both
    skip, the scaler state equal and the masters within 1e-5."""
    lr = 0.1
    params, grads = _larc_inputs(3)
    jopt = jamp.AmpOptimizer(jax_larc(jax_fused_sgd(lr, momentum=0.9),
                                      learning_rate=lr), jamp.initialize("O2"))
    opt = amp.AmpOptimizer(larc(fused_sgd(lr, momentum=0.9),
                                learning_rate=lr), amp.initialize("O2"))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for i, g in enumerate(grads):
        g = {k: v * 65536.0 for k, v in g.items()}
        if i == 1:
            g["p1"] = g["p1"].copy()
            g["p1"][3, 4] = np.inf
        jp, jstate, jst = jopt.step({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
        tp, state, st = opt.step({k: torch.from_numpy(v) for k, v in
                                  g.items()}, state, tp)
        assert bool(st.found_inf) == bool(jst.found_inf) == (i == 1)
        assert float(st.loss_scale) == float(jst.loss_scale)
        assert int(state.opt_state.step) == int(jstate.opt_state.step)
    for k in tp:
        assert _close(tp[k].numpy(), np.asarray(jp[k])), k


def test_delay_allreduce_warns_once(capsys):
    amp._warned_once.discard("ddp.delay_allreduce")
    DistributedDataParallel(delay_allreduce=True)
    assert "delay_allreduce" in capsys.readouterr().out
    DistributedDataParallel(delay_allreduce=True)
    assert "delay_allreduce" not in capsys.readouterr().out


def test_init_distributed_without_a_world_does_nothing(monkeypatch):
    from apex_tpu_torch.parallel import init_distributed

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed("gloo") is False
    with pytest.raises(ValueError, match="world_size"):
        init_distributed("gloo", rank=0)
    # NCCL is the default and never falls back to gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        init_distributed(rank=0, world_size=1)


def test_launch_surfaces_the_failing_rank():
    """A rank that raises fails the gang with its stderr tail; its peer,
    killed on teardown, is no guilty rank."""
    from apex_tpu_torch.parallel import (MultiprocError, TEARDOWN_RC,
                                         launch)

    code = ("import os, sys, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    raise ValueError('rank one gave up')\n"
            "time.sleep(60)\n")
    with pytest.raises(MultiprocError) as err:
        launch(["-c", code], 2, timeout_s=30, echo_stderr=False, check=True)
    assert "rank one gave up" in str(err.value)
    assert err.value.guilty_ranks() == [1]
    assert err.value.results[0].returncode == TEARDOWN_RC


def test_launch_times_out_a_hung_gang():
    from apex_tpu_torch.parallel import MultiprocError, launch

    with pytest.raises(MultiprocError, match="timed out") as err:
        launch(["-c", "import time; time.sleep(60)"], 2, timeout_s=1.0,
               echo_stderr=False, check=True)
    assert err.value.guilty_ranks() == []


if __name__ == "__main__":
    _worker(sys.argv[1])
