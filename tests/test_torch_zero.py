"""ZeRO and FSDP in the port vs the JAX package, on the CPU:
``DistributedFusedAdam``/``LAMB``, ``zero_microbatch_step``,
``fsdp_microbatch_step`` and the driver's ``mesh``/``carry_spec`` mode.

One gang of four gloo processes (this file run as a script, spawned once
by the module fixture ``gang``; one thread, a ``file://`` rendezvous, no
JAX in the workers, a 120 s join timeout).  Both sides get the same
per-rank scaled gradients, made from a numpy seed, over seven optimizer
steps of M = 2 microbatches (the second microbatch of step 4 holds an inf
on rank 1), through ``FusedTrainDriver(mesh=, batch_spec=P("data"),
carry_spec=...)`` on both sides: JAX under ``shard_map`` on a 4-device
sub-mesh of the conftest's virtual CPU devices.  Tolerances (ROADMAP's
optimizer rule): each step's movement of the masters within 1e-3
relative L2 of JAX's; the state shards within 1e-3 relative L2, 1/4 of
the padded flat length a rank; the skip flags, the loss scale, the
clean-step count and the overflow count exact; the collectives a
boundary exact.  The optimizers alone (no AMP, seven steps) are held the
same way.  ``driver.save``/``restore`` of a ZeRO carry round-trip bit for
bit through one directory a rank, and ``weights.from_jax_opt_state``
gives each rank exactly the shards JAX's device holds.
"""
import os
import sys

import numpy as np
import pytest
import torch

W = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120

if __name__ != "__main__":  # the gang's workers import no JAX
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    import apex_tpu.amp as jamp
    from apex_tpu.contrib.optimizers import (
        DistributedFusedAdam as JaxAdam,
        DistributedFusedLAMB as JaxLAMB,
    )
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu.train import FusedTrainDriver as JaxDriver
    from apex_tpu.train import accum as jaccum

SHAPES = {"a": (16,), "b": (3, 5), "c": (7,)}   # 38 elements, padded to 40
K, M = 7, 2
LR = 1e-2
INF_STEP, INF_MB, INF_RANK = 3, 1, 1
MODES = ("adam", "lamb", "fsdp")
OPTS = ("adam", "lamb")


def _params():
    rng = np.random.RandomState(0)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _window():
    """Scaled gradients (K * M, W, *shape) by name; one inf."""
    rng = np.random.RandomState(1)
    g = {k: (rng.randn(K * M, W, *s) * 1000.0).astype(np.float32)
         for k, s in SHAPES.items()}
    g["b"][INF_STEP * M + INF_MB, INF_RANK, 0, 0] = np.inf
    return g


def _opt_grads():
    rng = np.random.RandomState(2)
    return {k: rng.randn(K, W, *s).astype(np.float32)
            for k, s in SHAPES.items()}


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    return t.detach().float().numpy().copy()


def _tree_np(tree):
    return {k: _np(v) for k, v in tree.items()}


def _scaler(s):
    return [float(s.loss_scale), int(s.unskipped), int(s.overflows)]


def _port_opt(mode, axis):
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    cls = DistributedFusedLAMB if mode == "lamb" else DistributedFusedAdam
    return cls(axis, lr=LR)


def _case_step(rank, mode, out_dir):
    from apex_tpu_torch import amp
    from apex_tpu_torch.parallel import (P, collective_counts, make_mesh,
                                         reset_collective_counts)
    from apex_tpu_torch.train import (FusedTrainDriver, fsdp_init,
                                      fsdp_microbatch_step, fsdp_param_spec,
                                      fsdp_state_spec, fsdp_unflatten_params,
                                      zero_init, zero_microbatch_step,
                                      zero_state_spec)
    mesh = make_mesh([("data", W)])
    data = mesh["data"]
    amp_ = amp.initialize("O2")
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    opt = _port_opt(mode, data)
    spec = opt.make_spec(params)

    def grad_fn(carry, mb):
        return {k: v[0] for k, v in mb.items()}, {"loss": torch.zeros(())}

    if mode == "fsdp":
        step = fsdp_microbatch_step(grad_fn, opt, amp_, spec, microbatches=M)
        carry = fsdp_init(opt, amp_, params, spec)
        cspec = (fsdp_param_spec(), fsdp_state_spec())
    else:
        step = zero_microbatch_step(grad_fn, opt, amp_, spec, microbatches=M)
        carry = (params, zero_init(opt, amp_, params, spec))
        cspec = (P(), zero_state_spec())
    driver = FusedTrainDriver(step, steps_per_dispatch=K, mesh=mesh,
                              batch_spec=P("data"), carry_spec=cspec,
                              per_step=("skipped", "scale"))
    window = {k: torch.from_numpy(v) for k, v in _window().items()}
    reset_collective_counts()
    carry, res = driver.run_window(carry, window)
    counts = collective_counts()
    state = carry[1]
    if mode == "fsdp":
        full = fsdp_unflatten_params(carry[0], spec, data)
        shards = {"master_shard": carry[0], "m_shard": state.opt_state.m_shard,
                  "v_shard": state.opt_state.v_shard}
    else:
        full = carry[0]
        o = state.opt_state
        shards = {"master_shard": o.master_shard, "m_shard": o.m_shard,
                  "v_shard": o.v_shard}
    out = {"params": _tree_np(full), "shards": _tree_np(shards),
           "step": int(state.opt_state.step), "scaler": _scaler(
               state.scaler[0]), "counts": counts,
           "skipped": res.per_step["skipped"].tolist(),
           "scale": res.per_step["scale"].tolist()}
    if mode == "adam":
        ck = os.path.join(out_dir, "ckpt")
        driver.save(ck, carry, K)
        zeros = (params, zero_init(opt, amp_, params, spec))
        restored, at = driver.restore(ck, zeros)
        from apex_tpu_torch.multi_tensor import tree_map
        same = []
        tree_map(lambda a, b: same.append(torch.equal(a, b)), restored, carry)
        out["restore"] = {"step": at, "equal": all(same), "n": len(same),
                          "dir": os.path.isdir(os.path.join(
                              ck, f"process_{rank}", str(K)))}
    return out


def _case_opt(rank, mode):
    from apex_tpu_torch.parallel import make_mesh
    data = make_mesh([("data", W)])["data"]
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    opt = _port_opt(mode, data)
    spec = opt.make_spec(params)
    state = opt.init(params, spec)
    grads = _opt_grads()
    for i in range(K):
        params, state = opt.step({k: torch.from_numpy(v[i, rank])
                                  for k, v in grads.items()}, state, spec)
    return {"params": _tree_np(params), "master_shard": _np(
        state.master_shard), "m_shard": _np(state.m_shard),
            "v_shard": _np(state.v_shard), "step": int(state.step)}


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    results = {("step", m): _case_step(rank, m, out_dir) for m in MODES}
    results.update({("opt", m): _case_opt(rank, m) for m in OPTS})
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang, then JAX --------------------------------------


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from apex_tpu_torch.parallel import launch
    out = tmp_path_factory.mktemp("zero_gang")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([os.path.abspath(__file__), str(out)], W, env=env,
           timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("data",))


def _jax_opt(mode):
    return (JaxLAMB if mode == "lamb" else JaxAdam)(lr=LR, axis_name="data")


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's runs of the three policies: the final carry and metrics."""
    mesh = _mesh()
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    window = {k: jnp.asarray(v) for k, v in _window().items()}
    out = {}
    for mode in MODES:
        amp_ = jamp.initialize("O2")
        opt = _jax_opt("adam" if mode == "fsdp" else mode)
        spec = opt.make_spec(params, W)

        def grad_fn(carry, mb):
            return ({k: v[0] for k, v in mb.items()},
                    {"loss": jnp.float32(0)})

        if mode == "fsdp":
            step = jaccum.fsdp_microbatch_step(grad_fn, opt, amp_, spec,
                                               microbatches=M)
            carry = jaccum.fsdp_init(opt, amp_, params, spec, mesh)
            cspec = (jaccum.fsdp_param_spec(), jaccum.fsdp_state_spec())
        else:
            step = jaccum.zero_microbatch_step(grad_fn, opt, amp_, spec,
                                               microbatches=M)
            carry = (params, jaccum.zero_init(opt, amp_, params, spec, mesh))
            cspec = (JP(), jaccum.zero_state_spec())
        driver = JaxDriver(step, steps_per_dispatch=K, mesh=mesh,
                           batch_spec=JP("data"), carry_spec=cspec,
                           check_vma=False, per_step=("skipped", "scale"),
                           donate=False)
        carry, res = driver.run_window(carry, window)
        if mode == "fsdp":
            full = jax.jit(shard_map_compat(
                lambda s: jaccum.fsdp_unflatten_params(s, spec),
                mesh=mesh, in_specs=(JP("data"),), out_specs=JP(),
                check_vma=False))(carry[0])
        else:
            full = carry[0]
        out[mode] = {"carry": carry, "params": jax.tree_util.tree_map(
            np.asarray, full), "per_step": jax.tree_util.tree_map(
                np.asarray, res.per_step)}
    return out


def _rel(got, want, base):
    d = np.asarray(want, np.float64) - base
    return np.linalg.norm(np.asarray(got, np.float64) - base - d) \
        / max(np.linalg.norm(d), 1e-30)


def _shards(mode, carry):
    state = carry[1]
    if mode == "fsdp":
        return {"master_shard": carry[0], "m_shard": state.opt_state.m_shard,
                "v_shard": state.opt_state.v_shard}
    o = state.opt_state
    return {"master_shard": o.master_shard, "m_shard": o.m_shard,
            "v_shard": o.v_shard}


@pytest.mark.parametrize("mode", MODES)
def test_policy_matches_jax(gang, jax_steps, mode):
    want = jax_steps[mode]
    p0 = _params()
    for r in range(W):
        got = gang[r]["step", mode]
        for k in SHAPES:
            assert _rel(got["params"][k], want["params"][k], p0[k]) <= 1e-3
        np.testing.assert_array_equal(got["skipped"],
                                      want["per_step"]["skipped"])
        np.testing.assert_array_equal(got["scale"], want["per_step"]["scale"])


@pytest.mark.parametrize("mode", MODES)
def test_policy_state_is_a_quarter_a_rank(gang, jax_steps, mode):
    carry = jax_steps[mode]["carry"]
    shards = {k: np.asarray(v) for k, v in _shards(mode, carry).items()}
    padded = 40
    for r in range(W):
        got = gang[r]["step", mode]["shards"]
        for k, full in shards.items():
            assert full.shape == (padded,)
            assert got[k].shape == (padded // W,)
            want = full[r * padded // W:(r + 1) * padded // W]
            base = 0.0 if k != "master_shard" else np.concatenate(
                [v.reshape(-1) for v in _params().values()] + [np.zeros(2)]
            )[r * padded // W:(r + 1) * padded // W]
            assert _rel(got[k], want, base) <= 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_policy_scaler_state_is_exact(gang, jax_steps, mode):
    carry = jax_steps[mode]["carry"]
    s = carry[1].scaler[0]
    want = [float(s.loss_scale), int(s.unskipped), int(s.overflows)]
    assert want[2] == 1  # the planted inf was skipped once
    step = int(np.asarray(carry[1].opt_state.step))
    assert step == K - 1
    for r in range(W):
        got = gang[r]["step", mode]
        assert got["scaler"] == want
        assert got["step"] == step


@pytest.mark.parametrize("mode", MODES)
def test_policy_collectives_a_boundary(gang, mode):
    """ZeRO: the flag all-reduce, the reduce-scatter and the all-gather
    (LAMB: two small all-reduces more); FSDP: the parameters' all-gather,
    the reduce-scatter and two flag all-reduces."""
    want = {"adam": {"zero_flag": 1, "zero_grads": 1, "zero_params": 1},
            "lamb": {"zero_flag": 1, "zero_grads": 1, "zero_params": 1,
                     "zero_norm": 2},
            "fsdp": {"fsdp_params": 1, "zero_flag": 2, "zero_grads": 1}}[mode]
    for r in range(W):
        assert gang[r]["step", mode]["counts"] == {
            k: K * v for k, v in want.items()}


@pytest.mark.parametrize("mode", OPTS)
def test_optimizer_alone_matches_jax(gang, mode):
    mesh = _mesh()
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    grads = {k: jnp.asarray(v) for k, v in _opt_grads().items()}
    opt = _jax_opt(mode)
    spec = opt.make_spec(params, W)

    def body(p, g):
        state = opt.init(p, spec)
        for i in range(K):
            p, state = opt.step({k: v[i, 0] for k, v in g.items()}, state,
                                spec)
        return p, state
    sspec = jaccum.zero_state_spec().opt_state
    p, state = jax.jit(shard_map_compat(
        body, mesh=mesh, in_specs=(JP(), JP(None, "data")),
        out_specs=(JP(), sspec), check_vma=False))(params, grads)
    p0 = _params()
    for r in range(W):
        got = gang[r]["opt", mode]
        assert got["step"] == K
        for k in SHAPES:
            assert _rel(got["params"][k], p[k], p0[k]) <= 1e-3
        for k in ("m_shard", "v_shard"):
            want = np.asarray(getattr(state, k))[r * 10:(r + 1) * 10]
            assert _rel(got[k], want, 0.0) <= 1e-3


def test_zero_checkpoint_round_trips_a_rank(gang):
    for r in range(W):
        got = gang[r]["step", "adam"]["restore"]
        assert got["step"] == K and got["dir"]
        assert got["equal"] and got["n"] == 3 + 4 + 3


@pytest.mark.parametrize("mode", MODES)
def test_from_jax_opt_state_gives_each_rank_its_shards(jax_steps, mode):
    from apex_tpu_torch.weights import from_jax_opt_state
    carry = jax_steps[mode]["carry"]
    state = carry[1]
    shards = _shards(mode, carry)
    for r in range(W):
        got = from_jax_opt_state(state, "cpu", rank=r, world=W)
        assert type(got).__name__ == type(state).__name__
        for k, arr in shards.items():
            # what JAX's device r holds of the flat shard
            held = next(np.asarray(s.data) for s in arr.addressable_shards
                        if s.device == jax.devices()[r])
            if k == "master_shard" and mode == "fsdp":
                continue  # the fsdp master shard is the carry's head
            t = getattr(got.opt_state, k)
            np.testing.assert_array_equal(t.numpy(), held)
        s = state.scaler[0]
        assert [float(got.scaler[0].loss_scale), int(got.scaler[0].unskipped),
                int(got.scaler[0].overflows)] == [
                    float(s.loss_scale), int(s.unskipped), int(s.overflows)]


def test_jax_leaf_order_is_the_flat_order():
    """A ZeRO carry taken over from JAX needs its flat layout in JAX's
    leaf order: ``jax_leaf_order`` names the port's parameters in it (11
    layers, so that the sorted keys put layer_10 before layer_2)."""
    from apex_tpu_torch.weights import from_jax_params, jax_leaf_order
    rng = np.random.RandomState(4)
    h = 8
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    dense = lambda i, o: {"kernel": f(i, o), "bias": f(o)}  # noqa: E731
    ln = lambda: {"scale": f(h), "bias": f(h)}  # noqa: E731
    tree = {"wte": {"embedding": f(16, h)}, "wpe": {"embedding": f(8, h)},
            "ln_f": ln()}
    for i in range(11):
        tree[f"layer_{i}"] = {"ln1": ln(), "ln2": ln(),
                              "qkv": dense(h, 3 * h), "proj": dense(h, h),
                              "ffn_in": dense(h, 4 * h),
                              "ffn_out": dense(4 * h, h)}
    order = jax_leaf_order(tree)
    mapped = from_jax_params(tree)
    leaves = jax.tree_util.tree_leaves(tree)
    assert sorted(order) == sorted(mapped)
    for name, leaf in zip(order, leaves):
        np.testing.assert_array_equal(mapped[name].numpy(), leaf)


def test_stack_stage_params_stacks_by_name():
    from apex_tpu_torch.parallel import stack_stage_params
    stages = [{"w": torch.full((2, 3), float(i)), "b": torch.full((3,),
                                                                -float(i))}
              for i in range(3)]
    got = stack_stage_params(stages)
    assert list(got) == ["w", "b"] and got["w"].shape == (3, 2, 3)
    assert all(torch.equal(got[k][i], stages[i][k]) for k in got
               for i in range(3))
    with pytest.raises(ValueError, match="different parameter names"):
        stack_stage_params([{"w": torch.zeros(1)}, {"v": torch.zeros(1)}])


def _port_step_fn():
    return lambda carry, mb: ({}, {})


def test_compress_and_adasum_raise_naming_item_6():
    """Item 6 part 2 is ported: compress= builds on every policy; what
    still raises is compression with Adasum (full-precision operands) and
    with LAMB on the ZeRO codec path (LAMB's norms need its own step)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                                   DistributedFusedLAMB)
    from apex_tpu_torch.parallel import Axis
    from apex_tpu_torch.train import (adasum_microbatch_step,
                                      fsdp_microbatch_step,
                                      zero_microbatch_step)
    opt = DistributedFusedAdam(Axis.single("data"))
    spec = opt.make_spec({"a": torch.zeros(3)})
    amp_ = amp.initialize("O2")
    for fn in (zero_microbatch_step, fsdp_microbatch_step):
        step = fn(_port_step_fn(), opt, amp_, spec, compress="bf16")
        assert step.compress.mode == "bf16"
    with pytest.raises(NotImplementedError, match="full-precision"):
        adasum_microbatch_step(_port_step_fn(), opt, compress="int8")
    lamb = DistributedFusedLAMB(Axis.single("data"))
    with pytest.raises(NotImplementedError, match="DistributedFusedAdam"):
        zero_microbatch_step(_port_step_fn(), lamb, amp_, spec,
                             compress="int8")


def test_fsdp_refuses_lamb():
    from apex_tpu_torch import amp
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.parallel import Axis
    from apex_tpu_torch.train import fsdp_microbatch_step
    opt = DistributedFusedLAMB(Axis.single("data"))
    spec = opt.make_spec({"a": torch.zeros(3)})
    with pytest.raises(NotImplementedError, match="DistributedFusedAdam"):
        fsdp_microbatch_step(_port_step_fn(), opt, amp.initialize("O2"),
                             spec)


def test_rules_table_carry_spec_raises_naming_item_6():
    """The port's RulesTable is a carry_spec now (matched over the carry
    it is given); a JAX table is no tree of P and raises."""
    from apex_tpu.sharding import train_state_rules as jax_rules
    from apex_tpu_torch.parallel import P, Mesh
    from apex_tpu_torch.sharding import train_state_rules
    from apex_tpu_torch.train import FusedTrainDriver
    mesh = Mesh(("data",), (1,), ())
    driver = FusedTrainDriver(_port_step_fn(), mesh=mesh,
                              carry_spec=train_state_rules("data"))
    carry = ({"a": torch.zeros(3)}, {"master_shard": torch.zeros(4)})
    assert driver.carry_spec_for(carry) == ({"a": P()},
                                            {"master_shard": P("data")})
    with pytest.raises(TypeError, match="tree of P"):
        FusedTrainDriver(_port_step_fn(), mesh=mesh,
                         carry_spec=jax_rules("data"))
    with pytest.raises(TypeError, match="tree of P"):
        FusedTrainDriver(_port_step_fn(), mesh=mesh, carry_spec="data")
    with pytest.raises(ValueError, match="need a mesh"):
        FusedTrainDriver(_port_step_fn(), carry_spec=())


if __name__ == "__main__":
    _worker(sys.argv[1])
