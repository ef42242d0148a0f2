"""Compressed boundary collectives, Adasum and the canonical train state in
the port vs the JAX package, on the CPU (``apex_tpu_torch.train.compress``
and ``train.accum`` against ``apex_tpu.train``).

One gang of four gloo processes (this file run as a script, started by
the module fixture ``both`` in a thread while the JAX side runs; one
thread a rank, a ``file://`` rendezvous, no JAX in the workers, a 120 s
join timeout), against JAX under ``shard_map`` on four of the
conftest's virtual CPU devices:

- the codecs on the same per-rank flat gradient and residual (dyadic
  values, whose fp32 sums are exact in any order, so a plain sum is
  comparable bit for bit): ``none`` exact; ``bf16``, summed in bf16 in
  each framework's own order, within (W - 1) / 2 bf16 ulps of sum |x_i|
  of the exact sum on both sides (W - 1 roundings of a partial sum; the
  two differ by up to 4 ulps at the largest summand's magnitude here);
  ``int8``'s payload exact, its scale within one fp32 ulp, the decoded
  sum and the residual within (|payload| + 1) of the scale's ulps twice
  over, for the all-reduce and the reduce-scatter;
- the mean (``amp_microbatch_step(ddp=)`` over ``AmpOptimizer(
  fused_adam)``), ZeRO and FSDP policies with ``bf16`` and ``int8``, seven
  steps of M = 2 microbatches with an inf in step 4 on rank 1, the
  driver's ``carry_spec`` the ``train_state_rules`` table: the masters'
  movement within 1e-3 relative L2 of JAX's for int8 and 2e-2 for bf16
  (summed in bf16 in another order), the skip flags, the scale and the
  scaler state exact, the int8 residual and the params unchanged across
  the skipped boundary, the collectives a boundary exact (``pmax`` once
  for int8, no ``[host]`` staging on the CPU).  JAX's int8 codec clips
  an inf to ``qmax``, so its mean policy never skips the planted inf;
  the port's decodes a non-finite shared max as itself and skips, so the
  mean int8 run is held against JAX on the window without the inf;
- ``adasum_combine`` within 1e-6 of JAX's, its power-of-two rule, and
  three Adasum steps against JAX's policy (1e-3 relative L2);
- a ZeRO carry saved by four ranks restored as FSDP on (data 2, model
  2), and an FSDP carry of that mesh restored as ZeRO on four: the
  parameters and moments bit for bit the gather of the source, the
  sidecar equal to JAX's ``rules_outcome`` of the same carry; the ZeRO
  carry restored as ZeRO on four, with its sidecar and without one, leaf
  for leaf this rank's carry; the rules'
  ``shard_tree``/``gather_tree`` round trip and ``constrain_tree``'s
  local-shape check on that mesh;
- ``weights.from_jax_ef_state`` gives each rank its row exactly.
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

W = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
SHAPES = {"a": (16,), "b": (3, 5), "c": (7,)}   # 38 elements, padded to 40
L_FLAT = 38
K, M = 7, 2
LR = 1e-2
INF_STEP, INF_MB, INF_RANK = 3, 1, 1
POLICIES = [(p, c) for p in ("amp", "zero", "fsdp") for c in ("bf16", "int8")]
CODEC_L = 64
ADASUM_K = 3

if __name__ != "__main__":  # the gang's workers import no JAX
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    import apex_tpu.amp as jamp
    import apex_tpu.sharding as jshd
    from apex_tpu.contrib.optimizers import DistributedFusedAdam as JaxZero
    from apex_tpu.optimizers import fused_adam as jax_fused_adam
    from apex_tpu.parallel import DistributedDataParallel as JaxDDP
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu.train import FusedTrainDriver as JaxDriver
    from apex_tpu.train import accum as jaccum
    from apex_tpu.train import compress as jcompress


def _params():
    rng = np.random.RandomState(0)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _window(k=K, inf=True):
    """The first ``k`` steps of the scaled gradients (K * M, W, *shape) by
    name; with ``inf``, one inf in step INF_STEP."""
    rng = np.random.RandomState(1)
    g = {n: (rng.randn(K * M, W, *s) * 1000.0).astype(np.float32)
         for n, s in SHAPES.items()}
    if inf:
        g["b"][INF_STEP * M + INF_MB, INF_RANK, 0, 0] = np.inf
    return {n: v[:k * M] for n, v in g.items()}


def _codec_inputs():
    """Dyadic per-rank flats and residuals: exact fp32 sums in any
    order."""
    rng = np.random.RandomState(2)
    flat = rng.randint(-4096, 4096, size=(W, CODEC_L)) / 64.0
    res = rng.randint(-64, 64, size=(W, CODEC_L)) / 1024.0
    return flat.astype(np.float32), res.astype(np.float32)


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    return t.detach().float().numpy().copy()


def _scaler(s):
    return [float(s.loss_scale), int(s.unskipped), int(s.overflows)]


def _case_codecs(rank, axis):
    from apex_tpu_torch.train import (compress_allreduce,
                                      compress_reduce_scatter,
                                      compression_default)
    from apex_tpu_torch.train.compress import _int8_quantize
    flat, res = (torch.from_numpy(a[rank]) for a in _codec_inputs())
    q, scale, _ = _int8_quantize(flat + res, axis, W)
    out = {"q": (q.numpy().copy(), float(scale))}
    for mode in ("none", "bf16", "int8"):
        spec = compression_default(mode)
        r = res if mode == "int8" else None
        s, nr = compress_allreduce(flat, axis, spec, r)
        g, gr = compress_reduce_scatter(flat, axis, spec, r)
        out[mode] = {"sum": _np(s), "shard": _np(g),
                     "res": None if nr is None else _np(nr),
                     "res_rs": None if gr is None else _np(gr)}
    return out


def _run_policy(policy, comp, mesh, k=K, adasum=False, inf=True):
    """One window of ``k`` steps of a policy; returns the final full
    params, per-step flags and scales, the scaler, the residual and the
    collectives."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import (DistributedDataParallel, P,
                                         collective_counts,
                                         reset_collective_counts)
    from apex_tpu_torch.sharding import train_state_rules
    from apex_tpu_torch.train import (FusedTrainDriver, adasum_microbatch_step,
                                      amp_microbatch_step, ef_init, fsdp_init,
                                      fsdp_microbatch_step,
                                      fsdp_unflatten_params, zero_init,
                                      zero_microbatch_step)
    data = mesh["data"]
    amp_ = amp.initialize("O2")
    params = {n: torch.from_numpy(v) for n, v in _params().items()}

    def grad_fn(carry, mb):
        return {n: v[0] for n, v in mb.items()}, {"loss": torch.zeros(())}

    length = L_FLAT
    if policy == "amp":
        opt = amp.AmpOptimizer(fused_adam(LR), amp_)
        if adasum:
            step = adasum_microbatch_step(grad_fn, opt, microbatches=M,
                                          axis=data)
        else:
            step = amp_microbatch_step(grad_fn, opt, microbatches=M,
                                       ddp=DistributedDataParallel(),
                                       compress=comp)
        carry = (params, opt.init(params))
    else:
        opt = DistributedFusedAdam(data, lr=LR)
        spec = opt.make_spec(params)
        length = spec.padded
        fn = zero_microbatch_step if policy == "zero" else fsdp_microbatch_step
        step = fn(grad_fn, opt, amp_, spec, microbatches=M, compress=comp)
        carry = ((params, zero_init(opt, amp_, params, spec))
                 if policy == "zero" else fsdp_init(opt, amp_, params, spec))
    if comp == "int8":
        carry = carry + (ef_init(length),)
    driver = FusedTrainDriver(step, steps_per_dispatch=k, mesh=mesh,
                              batch_spec=P("data"),
                              carry_spec=train_state_rules("data"),
                              per_step=("skipped", "scale"))
    window = {n: torch.from_numpy(v) for n, v in _window(k, inf).items()}
    reset_collective_counts()
    carry, res = driver.run_window(carry, window)
    counts = collective_counts()
    full = (fsdp_unflatten_params(carry[0], spec, data) if policy == "fsdp"
            else carry[0])
    return {"params": {n: _np(v) for n, v in full.items()},
            "skipped": res.per_step["skipped"].tolist(),
            "scale": res.per_step["scale"].tolist(),
            "scaler": _scaler(carry[1].scaler[0]), "counts": counts,
            "res": _np(carry[2].ef_residual) if comp == "int8" else None}


def _case_restore(rank, out_dir):
    """ZeRO over data 4 saved, restored as FSDP on (data 2, model 2), and
    that FSDP carry saved and restored as ZeRO over data 4."""
    import torch.distributed as dist
    from apex_tpu_torch import amp, checkpoint
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.parallel import make_mesh
    from apex_tpu_torch.sharding import (constrain_tree, gather_tree,
                                         shard_tree, train_state_rules)
    from apex_tpu_torch.train import (fsdp_unflatten_params,
                                      restore_train_state, save_train_state,
                                      train_state_canonical, zero_init,
                                      zero_microbatch_step)
    mesh4 = make_mesh([("data", W)])
    mesh22 = make_mesh([("data", 2), ("model", 2)])
    amp_ = amp.initialize("O2")
    params = {n: torch.from_numpy(v) for n, v in _params().items()}
    zopt = DistributedFusedAdam(mesh4["data"], lr=LR)
    spec4 = zopt.make_spec(params)
    step = zero_microbatch_step(
        lambda c, mb: ({n: v for n, v in mb.items()}, {}), zopt, amp_, spec4)
    from apex_tpu_torch.train import build_opt_step
    run = build_opt_step(step)
    carry = (params, zero_init(zopt, amp_, params, spec4))
    g = _window(2)
    for i in range(2):  # two steps: nonzero moments
        carry, _ = run(carry, {n: torch.from_numpy(v[i * M:i * M + 1, rank])
                               for n, v in g.items()})
    src = train_state_canonical(carry, params, W, mode="zero",
                                axis=mesh4["data"])
    zdir = os.path.join(out_dir, "zero4")
    save_train_state(zdir, carry, 2, mode="zero", mesh=mesh4)
    dist.barrier()
    fopt = DistributedFusedAdam(mesh22["data"], lr=LR)
    fcarry, at = restore_train_state(zdir, params, opt=fopt, amp_=amp_,
                                     mode="fsdp", mesh=mesh22)
    spec2 = fopt.make_spec(params)
    got = fsdp_unflatten_params(fcarry[0], spec2, mesh22["data"])
    canon = train_state_canonical(fcarry, params, 2, mode="fsdp",
                                  axis=mesh22["data"])
    fdir = os.path.join(out_dir, "fsdp22")
    save_train_state(fdir, fcarry, 3, mode="fsdp", mesh=mesh22)
    dist.barrier()
    zcarry, at2 = restore_train_state(fdir, params, opt=zopt, amp_=amp_,
                                      mode="zero", mesh=mesh4)
    canon2 = train_state_canonical(zcarry, params, W, mode="zero",
                                   axis=mesh4["data"])
    # the same mode on the same mesh, with the sidecar and without one
    bare = os.path.join(out_dir, "zero4_bare")
    checkpoint.save_checkpoint(bare, carry, 2, process_local=True)
    dist.barrier()
    same = {}
    for name, where in (("sidecar", zdir), ("bare", bare)):
        c, at_same = restore_train_state(where, params, opt=zopt, amp_=amp_,
                                         mode="zero", mesh=mesh4)
        same[name] = (at_same, _same_leaves(c, carry))
    # shard and gather under the rules: a round trip on the 2 x 2 mesh
    table = train_state_rules("data")
    flat = {"master_shard": torch.arange(8.0), "step": torch.zeros(())}
    local = shard_tree(flat, table, mesh22)
    back = gather_tree(local, table, mesh22)
    checked = constrain_tree(local, table, mesh22, full_shapes=flat) is local
    try:  # a full leaf where this rank's block belongs
        constrain_tree(flat, table, mesh22, full_shapes=flat)
        refused = False
    except ValueError:
        refused = True
    eq = lambda a, b: all(torch.equal(a[n], b[n]) for n in a)  # noqa: E731
    return {
        "at": (at, at2),
        "params_fsdp": eq(got, src["params"]),
        "moments_fsdp": eq(canon["m"], src["m"]) and eq(canon["v"],
                                                         src["v"]),
        "params_zero": eq(zcarry[0], src["params"])
        and eq(canon2["params"], src["params"]),
        "moments_zero": eq(canon2["m"], src["m"]) and eq(canon2["v"],
                                                          src["v"]),
        "step_scaler": (int(zcarry[1].opt_state.step),
                        _scaler(zcarry[1].scaler[0]),
                        int(src["step"]), _scaler(src["scaler"][0])),
        "outcome": checkpoint.read_sharding_outcome(zdir, rank=0),
        "outcome_fsdp": checkpoint.read_sharding_outcome(fdir, rank=0),
        "own_dir": os.path.isdir(checkpoint.process_dir(zdir, rank)),
        "shard_round_trip": (local["master_shard"].tolist(),
                             torch.equal(back["master_shard"],
                                         flat["master_shard"])),
        "constrain": (checked, refused),
        "same_layout": same,
        "bare_outcome": checkpoint.read_sharding_outcome(bare, rank=0),
    }


def _same_leaves(a, b) -> bool:
    """Every leaf of two carries equal bit for bit, tensor or number."""
    from apex_tpu_torch.sharding.rules import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import init_distributed, make_mesh
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    mesh = make_mesh([("data", W)])
    results = {"codecs": _case_codecs(rank, mesh["data"]),
               "adasum": _run_policy("amp", None, mesh, k=ADASUM_K,
                                     adasum=True)}
    for policy, comp in POLICIES:
        results[policy, comp] = _run_policy(policy, comp, mesh)
    # the int8 residual at the planted inf: the window through the skipped
    # step leaves params and residual as the window before it did
    for policy in ("amp", "zero", "fsdp"):
        results[policy, "gate"] = [
            _run_policy(policy, "int8", mesh, k=k)
            for k in (INF_STEP, INF_STEP + 1)]
    results["amp", "int8_clean"] = _run_policy("amp", "int8", mesh,
                                               inf=False)
    results["restore"] = _case_restore(rank, out_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang beside JAX -------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """See tests/test_torch_spec.py: one throwaway ``torch.exp``."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _mesh():
    return Mesh(np.array(jax.devices()[:W]), ("data",))


def _shmap(fn, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=_mesh(), in_specs=in_specs,
                                    out_specs=out_specs, check_vma=False))


def _jax_codecs():
    flat, res = _codec_inputs()
    row = JP("data")

    def quant(f, r):
        q, scale = jcompress._int8_quantize(f[0] + r[0], "data", W)
        return q[None], scale[None]

    q, scale = _shmap(quant, (row, row), (row, row))(flat, res)
    out = {"q": (np.asarray(q), np.asarray(scale))}
    for mode in ("none", "bf16", "int8"):
        spec = jcompress.compression_default(mode)

        def body(f, r):
            rr = r[0] if mode == "int8" else None
            s, nr = jcompress.compress_allreduce(f[0], "data", spec, rr)
            g, gr = jcompress.compress_reduce_scatter(f[0], "data", spec, rr)
            z = jnp.zeros_like(f[0])
            return (s[None], g[None], (z if nr is None else nr)[None],
                    (z if gr is None else gr)[None])

        s, g, nr, gr = _shmap(body, (row, row), (row,) * 4)(flat, res)
        out[mode] = {"sum": np.asarray(s), "shard": np.asarray(g),
                     "res": np.asarray(nr), "res_rs": np.asarray(gr)}
    return out


def _jax_policy(policy, comp, k=K, adasum=False, inf=True):
    mesh = _mesh()
    params = {n: jnp.asarray(v) for n, v in _params().items()}
    window = {n: jnp.asarray(v) for n, v in _window(k, inf).items()}
    amp_ = jamp.initialize("O2")

    def grad_fn(carry, mb):
        return {n: v[0] for n, v in mb.items()}, {"loss": jnp.float32(0)}

    length = L_FLAT
    if policy == "amp":
        opt = jamp.AmpOptimizer(jax_fused_adam(LR), amp_)
        if adasum:
            step = jaccum.adasum_microbatch_step(grad_fn, opt,
                                                 microbatches=M)
        else:
            step = jaccum.amp_microbatch_step(grad_fn, opt, microbatches=M,
                                              ddp=JaxDDP(), compress=comp)
        carry = (params, opt.init(params))
        cspec = (JP(), JP())
    else:
        opt = JaxZero(lr=LR, axis_name="data")
        spec = opt.make_spec(params, W)
        length = spec.padded
        if policy == "zero":
            step = jaccum.zero_microbatch_step(grad_fn, opt, amp_, spec,
                                               microbatches=M, compress=comp)
            carry = (params, jaccum.zero_init(opt, amp_, params, spec, mesh))
            cspec = (JP(), jaccum.zero_state_spec())
        else:
            step = jaccum.fsdp_microbatch_step(grad_fn, opt, amp_, spec,
                                               microbatches=M, compress=comp)
            carry = jaccum.fsdp_init(opt, amp_, params, spec, mesh)
            cspec = (jaccum.fsdp_param_spec(), jaccum.fsdp_state_spec())
    if comp == "int8":
        carry = carry + (jcompress.ef_place(jcompress.ef_init(length, W),
                                            mesh),)
        cspec = cspec + (jcompress.ef_state_spec(),)
    driver = JaxDriver(step, steps_per_dispatch=k, mesh=mesh,
                       batch_spec=JP("data"), carry_spec=cspec,
                       check_vma=False, per_step=("skipped", "scale"),
                       donate=False)
    carry, res = driver.run_window(carry, window)
    if policy == "fsdp":
        full = _shmap(lambda s: jaccum.fsdp_unflatten_params(s, spec),
                      (JP("data"),), JP())(carry[0])
    else:
        full = carry[0]
    s = carry[1].scaler[0]
    return {"params": jax.tree_util.tree_map(np.asarray, full),
            "skipped": np.asarray(res.per_step["skipped"]).tolist(),
            "scale": np.asarray(res.per_step["scale"]).tolist(),
            "scaler": [float(s.loss_scale), int(s.unskipped),
                       int(s.overflows)],
            "res": (np.asarray(carry[2].ef_residual) if comp == "int8"
                    else None)}


def _jax_outcome(mode):
    mesh = _mesh() if mode == "zero" else Mesh(
        np.array(jax.devices()[:W]).reshape(2, 2), ("data", "model"))
    params = {n: jnp.asarray(v) for n, v in _params().items()}
    amp_ = jamp.initialize("O2")
    world = 4 if mode == "zero" else 2
    opt = JaxZero(lr=LR, axis_name="data")
    spec = opt.make_spec(params, world)
    carry = ((params, jaccum.zero_init(opt, amp_, params, spec, mesh))
             if mode == "zero" else jaccum.fsdp_init(opt, amp_, params,
                                                     spec, mesh))
    return jshd.rules_outcome(jshd.train_state_rules("data"), carry, mesh,
                              mode=mode)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from apex_tpu_torch.parallel import launch
    out = tmp_path_factory.mktemp("compress_gang")
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
    want = {"codecs": _jax_codecs(),
            "adasum": _jax_policy("amp", None, k=ADASUM_K, adasum=True),
            "outcome": _jax_outcome("zero"),
            "outcome_fsdp": _jax_outcome("fsdp")}
    for policy, comp in POLICIES:
        # JAX's int8 codec clips an inf to qmax, so its mean policy never
        # skips it (the module docstring of train/compress.py): the mean
        # int8 run is held against JAX on the window without the inf
        want[policy, comp] = _jax_policy(
            policy, comp, inf=(policy, comp) != ("amp", "int8"))
    th.join()
    if err:
        raise err[0]
    got = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(W)]
    return got, want


def _rel(got, want, base):
    d = np.asarray(want, np.float64) - base
    return np.linalg.norm(np.asarray(got, np.float64) - base - d) \
        / max(np.linalg.norm(d), 1e-30)


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_codecs_match_jax(both, mode):
    got, want = both
    w = want["codecs"][mode]
    n = CODEC_L // W
    for r in range(W):
        g = got[r]["codecs"][mode]
        if mode == "none":
            np.testing.assert_array_equal(g["sum"], w["sum"][r])
            np.testing.assert_array_equal(g["shard"], w["shard"][r])
            assert g["res"] is None
        elif mode == "bf16":
            # each side sums the bf16 summands in bf16, in its own order:
            # W - 1 roundings of half an ulp of a partial sum, whose
            # magnitude is at most sum |x_i|; so each side lies within
            # (W - 1) / 2 such ulps of the exact sum
            b = torch.from_numpy(_codec_inputs()[0]).to(torch.bfloat16)
            exact = b.double().sum(0).numpy()
            ulp = _bf16_ulp(b.double().abs().sum(0).numpy())
            for key, sl in (("sum", slice(None)),
                            ("shard", slice(r * n, (r + 1) * n))):
                for side in (g[key], w[key][r]):
                    err = np.abs(side - exact[sl]) / ulp[sl]
                    assert (err <= (W - 1) / 2).all(), (key, err.max())
        else:
            # the payload exact; the scale within one fp32 ulp (XLA divides
            # by the constant qmax as a multiply by its reciprocal), which
            # moves the decoded sum and the residual by |q| such ulps
            gq, gs = got[r]["codecs"]["q"]
            wq, ws = want["codecs"]["q"]
            np.testing.assert_array_equal(gq, wq[r])
            assert abs(gs - float(ws[r])) <= np.spacing(np.float32(ws[r]))
            ulp = 2 * np.spacing(np.float32(ws[r]))
            qsum = np.abs(wq.astype(np.int32).sum(axis=0)) + 1
            qown = np.abs(wq[r].astype(np.int32)) + 1
            bounds = {"sum": qsum, "shard": qsum[r * n:(r + 1) * n],
                      "res": qown, "res_rs": qown}
            for key, qb in bounds.items():
                assert (np.abs(g[key] - w[key][r]) <= qb * ulp).all(), key
        assert g["shard"].shape == (n,)


@pytest.mark.parametrize("policy,comp", POLICIES)
def test_compressed_policy_matches_jax(both, policy, comp):
    """bf16 sums in each framework's own order (test_codecs_match_jax), a
    few bf16 ulps apart, so its movement is held at 2e-2 (measured up to
    8.3e-3); int8's payload is exact, so it is held at 1e-3."""
    got, want = both
    w = want[policy, comp]
    p0 = _params()
    tol = 2e-2 if comp == "bf16" else 1e-3
    clean = (policy, comp) == ("amp", "int8")
    for r in range(W):
        g = got[r][policy, "int8_clean" if clean else comp]
        for n in SHAPES:
            assert _rel(g["params"][n], w["params"][n], p0[n]) <= tol, n
        assert g["skipped"] == w["skipped"]
        assert g["scale"] == w["scale"]
        assert g["scaler"] == w["scaler"]
        if comp == "int8":
            assert g["res"].shape == (1, w["res"].shape[1])
            np.testing.assert_allclose(g["res"][0], w["res"][r], atol=1e-3,
                                       rtol=0)
        g = got[r][policy, comp]
        assert g["skipped"][INF_STEP] == 1.0 and sum(g["skipped"]) == 1.0


@pytest.mark.parametrize("policy", ["amp", "zero", "fsdp"])
def test_int8_residual_is_kept_at_the_skipped_boundary(both, policy):
    for r in range(W):
        before, through = both[0][r][policy, "gate"]
        assert through["skipped"][INF_STEP] == 1.0
        np.testing.assert_array_equal(through["res"], before["res"])
        for n in SHAPES:
            np.testing.assert_array_equal(through["params"][n],
                                          before["params"][n])


@pytest.mark.parametrize("policy,comp", POLICIES)
def test_compressed_policy_collectives(both, policy, comp):
    base = {"amp": {"ddp": 1},
            "zero": {"zero_flag": 1, "zero_grads": 1, "zero_params": 1},
            "fsdp": {"fsdp_params": 1, "zero_flag": 2,
                     "zero_grads": 1}}[policy]
    if comp == "int8":
        base = dict(base, pmax=1)
    for r in range(W):
        assert both[0][r][policy, comp]["counts"] == {
            k: K * v for k, v in base.items()}


def test_adasum_combine_matches_jax():
    from apex_tpu_torch.train import adasum_combine
    g = np.random.RandomState(4).randn(W, 33).astype(np.float32)
    g[2] = 0.0  # a zero block takes coefficient 1
    got = adasum_combine(torch.from_numpy(g)).numpy()
    want = np.asarray(jcompress.adasum_combine(jnp.asarray(g)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="power-of-two"):
        adasum_combine(torch.zeros(3, 4))


def test_adasum_policy_matches_jax(both):
    got, want = both
    w = want["adasum"]
    p0 = _params()
    for r in range(W):
        g = got[r]["adasum"]
        for n in SHAPES:
            assert _rel(g["params"][n], w["params"][n], p0[n]) <= 1e-3, n
        assert g["skipped"] == w["skipped"] and g["scaler"] == w["scaler"]
        assert g["counts"] == {"adasum": ADASUM_K}


def test_zero_restores_as_fsdp_and_back_bit_for_bit(both):
    got, want = both
    for r in range(W):
        g = got[r]["restore"]
        assert g["at"] == (2, 3)
        assert g["params_fsdp"] and g["moments_fsdp"]
        assert g["params_zero"] and g["moments_zero"]
        step, scaler, src_step, src_scaler = g["step_scaler"]
        assert (step, scaler) == (src_step, src_scaler) and step == 2
        assert g["own_dir"]
        assert g["outcome"] == want["outcome"]
        assert g["outcome"]["mode"] == "zero"
        assert g["outcome"]["mesh"] == {"data": W}
        assert g["outcome_fsdp"] == want["outcome_fsdp"]
        data_index = r // 2  # (data 2, model 2), row-major
        assert g["constrain"] == (True, True)
        assert g["shard_round_trip"] == (
            [float(x) for x in range(data_index * 4, data_index * 4 + 4)],
            True)


def test_zero_restores_as_zero_on_the_same_mesh_bit_for_bit(both):
    got, _ = both
    for r in range(W):
        g = got[r]["restore"]
        # this rank's carry back leaf for leaf (params, the master, m and
        # v shards, the step, the scaler), from the sidecar's layout and
        # from a checkpoint without one (the live layout taken)
        assert g["same_layout"] == {"sidecar": (2, True), "bare": (2, True)}
        assert g["bare_outcome"] is None


def test_ef_state_crosses_over_exactly():
    from apex_tpu_torch.weights import from_jax_ef_state
    st = jcompress.EfState(np.random.RandomState(5).randn(W, 9).astype(
        np.float32))
    for r in range(W):
        row = from_jax_ef_state(st, rank=r, device="cpu").ef_residual
        np.testing.assert_array_equal(row.numpy(), st.ef_residual[r:r + 1])
    whole = from_jax_ef_state(st, device="cpu").ef_residual
    np.testing.assert_array_equal(whole.numpy(), st.ef_residual)


if __name__ == "__main__":
    _worker(sys.argv[1])
