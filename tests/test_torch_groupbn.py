"""apex_tpu_torch's ``BatchNorm2d_NHWC`` (contrib groupbn) vs the JAX
package's, on the CPU.

One gang of four gloo processes (this file run as a script, spawned once
by the module fixture ``gang``, as in tests/test_torch_sync_batchnorm_
dist.py: no JAX in the workers, one thread, a file rendezvous, a 120 s
join timeout), each with rows ``[2 r, 2 r + 2)`` of one numpy-seeded
global batch, against JAX's ``BatchNorm2d_NHWC(world_size=4)`` under
``shard_map`` on a 4-device sub-mesh: ``bn_group`` 1 (each rank's own
statistics, no collective), 2 and 4 (aligned blocks of ranks), the fused
add + ReLU with the residual ``z`` at ``bn_group`` 2, and another eps
and momentum.  y, dx, dz and each rank's dscale and dbias within 1e-5 of
their largest magnitude, the running statistics within 1e-6, and one
all-reduce forward and one backward for ``bn_group`` > 1 (none for 1).
Also, in the test process: ``z`` without ``fuse_relu`` and ``bn_group``
> 1 without ``world_size`` raise, and the CUDA grid knobs warn once.
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
    from jax.sharding import PartitionSpec as P

    from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JaxGroupBN
    from apex_tpu.parallel import data_parallel_mesh
    from apex_tpu.parallel.mesh import shard_map_compat

from apex_tpu_torch import amp
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

C = 8
SHAPE = (2 * W, 5, 5, C)  # the global batch: 2 rows a rank
#: case -> module keywords (world_size added for bn_group > 1)
CASES = {
    "group1": dict(bn_group=1),
    "group2": dict(bn_group=2),
    "group4": dict(bn_group=4),
    "group2_add_relu": dict(bn_group=2, fuse_relu=True),
    "group2_eps_momentum": dict(bn_group=2, eps=1e-3, momentum=0.3),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _inputs(seed=5):
    rng = np.random.RandomState(seed)
    return {"x": (2.0 + 1.5 * rng.randn(*SHAPE)).astype(np.float32),
            "z": rng.randn(*SHAPE).astype(np.float32),
            "cot": rng.randn(*SHAPE).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.randn(C)).astype(np.float32),
            "bias": (0.1 * rng.randn(C)).astype(np.float32),
            "running_mean": (0.3 * rng.randn(C)).astype(np.float32),
            "running_var": (1.0 + rng.rand(C)).astype(np.float32)}


def _kw(case):
    kw = dict(CASES[case])
    if kw["bn_group"] > 1:
        kw["world_size"] = W
    return kw


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    return None if t is None else t.detach().float().numpy().copy()


def _case(case, rank):
    inputs, rows = _inputs(), slice(2 * rank, 2 * rank + 2)
    m = BatchNorm2d_NHWC(C, **_kw(case))
    m.load_state_dict({"bn.scale": torch.from_numpy(inputs["scale"]),
                       "bn.bias": torch.from_numpy(inputs["bias"])})
    x = torch.from_numpy(inputs["x"][rows]).requires_grad_()
    z = (torch.from_numpy(inputs["z"][rows]).requires_grad_()
         if CASES[case].get("fuse_relu") else None)
    stats = (torch.from_numpy(inputs["running_mean"]),
             torch.from_numpy(inputs["running_var"]))
    y, new = m(x, z, stats)
    (y * torch.from_numpy(inputs["cot"][rows])).sum().backward()
    return {"y": _np(y), "dx": _np(x.grad),
            "dz": _np(None if z is None else z.grad),
            "dscale": _np(m.bn.scale.grad), "dbias": _np(m.bn.bias.grad),
            "running_mean": _np(new[0]), "running_var": _np(new[1])}


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import (collective_counts, init_distributed,
                                         reset_collective_counts)
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    results = {}
    for case in CASES:
        reset_collective_counts()
        results[case] = _case(case, rank)
        results[case]["collectives"] = collective_counts()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang, then JAX --------------------------------------


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from apex_tpu_torch.parallel import launch
    out = tmp_path_factory.mktemp("groupbn_gang")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([os.path.abspath(__file__), str(out)], W, env=env,
           timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


def _jax_case(case):
    """JAX's module over the mesh: y, dx, dz by rows, each device's
    dscale, dbias and running statistics."""
    inputs = _inputs()
    fuse = CASES[case].get("fuse_relu", False)
    jbn = JaxGroupBN(num_features=C, **_kw(case))
    params = {"bn": {"scale": jnp.asarray(inputs["scale"]),
                     "bias": jnp.asarray(inputs["bias"])}}
    stats = {"bn": {k: jnp.asarray(inputs[k])
                    for k in ("running_mean", "running_var")}}

    def f(p, x, z, cot):
        def loss(p, x, z):
            out, upd = jbn.apply({"params": p, "batch_stats": stats}, x,
                                 z if fuse else None, mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, upd)
        (_, (out, upd)), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(p, x, z)
        per_device = jax.tree_util.tree_map(lambda t: t[None],
                                            (upd["batch_stats"], g[0]))
        return (out, g[1], g[2]) + per_device

    fn = jax.jit(shard_map_compat(
        f, mesh=data_parallel_mesh(W),
        in_specs=(P(), P("data"), P("data"), P("data")),
        out_specs=(P("data"),) * 5, check_vma=False))
    out, dx, dz, new, partial = fn(params, jnp.asarray(inputs["x"]),
                                   jnp.asarray(inputs["z"]),
                                   jnp.asarray(inputs["cot"]))
    return {"y": np.asarray(out), "dx": np.asarray(dx), "dz": np.asarray(dz),
            "dscale": np.asarray(partial["bn"]["scale"]),
            "dbias": np.asarray(partial["bn"]["bias"]),
            "running_mean": np.asarray(new["bn"]["running_mean"]),
            "running_var": np.asarray(new["bn"]["running_var"])}


def _within(got, want) -> bool:
    return bool(np.abs(np.asarray(got) - want).max()
                <= 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_batchnorm_matches_jax_mesh(gang, case):
    want = _jax_case(case)
    for rank, res in enumerate(gang):
        got, rows = res[case], slice(2 * rank, 2 * rank + 2)
        for k in ("y", "dx") + (("dz",) if CASES[case].get("fuse_relu")
                                else ()):
            assert _within(got[k], want[k][rows]), (rank, k)
        for k in ("dscale", "dbias"):
            assert _within(got[k], want[k][rank]), (rank, k)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k][rank], rtol=0,
                                       atol=1e-6)
        assert got["collectives"] == (
            {} if CASES[case]["bn_group"] == 1
            else {"sync_bn_fwd": 1, "sync_bn_bwd": 1})


def test_residual_requires_fuse_relu_and_groups_need_world_size():
    m = BatchNorm2d_NHWC(C)
    x = torch.randn(2, 3, 3, C)
    with pytest.raises(ValueError, match="fuse_relu"):
        m(x, torch.zeros_like(x), m.init_stats("cpu"))
    with pytest.raises(ValueError, match="world_size"):
        BatchNorm2d_NHWC(C, bn_group=2)


def test_cuda_tuning_knobs_warn_once(capsys, monkeypatch):
    monkeypatch.setattr(amp, "_warned_once", set())
    BatchNorm2d_NHWC(C)
    assert "no effect" not in capsys.readouterr().out
    BatchNorm2d_NHWC(C, max_cta_per_sm=4)
    BatchNorm2d_NHWC(C, multi_stream=True)
    assert capsys.readouterr().out.count("no effect") == 1


if __name__ == "__main__":
    _worker(sys.argv[1])
