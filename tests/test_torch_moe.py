"""The expert-parallel MoE layer in the port vs the JAX package, on the
CPU (``apex_tpu_torch.parallel.moe`` against ``apex_tpu.parallel.moe``).

- ``top_k_routing`` on seeded logits with and without drops: dispatch
  exact, combine and the aux loss within 1e-6; a planted tie (two equal
  gates) routes as ``jax.lax.top_k`` does, to the lower expert index
  (the port ranks by a stable sort; ``torch.topk`` promises no order);
- ``MoEMLP`` over a (data 2, expert 2) mesh: one gang of four gloo
  processes (this file run as a script, spawned by the module fixture
  ``gang``; one thread, a ``file://`` rendezvous, no JAX in the workers,
  a 120 s join timeout) against JAX's layer under ``shard_map`` on four
  of the conftest's virtual CPU devices, fp32, capacity factor 1.25 (so
  some tokens drop): each rank's output within 1e-5 of its largest
  magnitude and the aux loss within 1e-6, and the gradients of the
  router, the local experts and the input (of ``sum(y * cot) + aux``)
  within 1e-4 of their largest; the same layer at n = 1 on the rank's
  tokens with every expert gives the same output; the two all-to-alls
  a forward and two a backward counted exactly;
- ``weights.from_jax_moe_params`` of JAX's expert-parallel tree gives
  each rank exactly its device's expert block and the router;
- ``num_experts`` that do not divide by the axis raise.
"""
import os
import sys

import numpy as np
import pytest
import torch

W = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT_S = 120
E, D, DFF, T, KTOP, CF = 4, 16, 32, 24, 2, 1.25

if __name__ != "__main__":  # the gang's workers import no JAX
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.parallel import moe as jmoe
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu_torch.weights import from_jax_moe_params


def _inputs():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(W * T, D).astype(np.float32),
            "cot": rng.randn(W * T, D).astype(np.float32)}


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    return t.detach().float().numpy().copy()


def _layer(sd, axis):
    from apex_tpu_torch.parallel import MoEMLP
    mod = MoEMLP(E, D, DFF, axis, k=KTOP, capacity_factor=CF)
    mod.load_state_dict(sd)
    return mod


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import (collective_counts, init_distributed,
                                         make_mesh, reset_collective_counts)
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    mesh = make_mesh([("data", 2), ("expert", 2)])
    expert = mesh["expert"]
    sd = inp["sd"][expert.index]
    x = torch.from_numpy(inp["x"][rank * T:(rank + 1) * T]).requires_grad_()
    cot = torch.from_numpy(inp["cot"][rank * T:(rank + 1) * T])
    mod = _layer(sd, expert)
    reset_collective_counts()
    y, aux = mod(x)
    fwd = collective_counts()
    ((y * cot).sum() + aux).backward()
    res = {"y": _np(y), "aux": float(aux), "dx": _np(x.grad),
           "grads": {k: _np(p.grad) for k, p in mod.named_parameters()},
           "fwd_counts": fwd, "counts": collective_counts()}
    # the same layer at n = 1 with every expert, on this rank's tokens
    one = _layer(inp["full"], None)
    y1, aux1 = one(x.detach())
    res["one_rank"] = {"y": _np(y1), "aux": float(aux1)}
    try:
        from apex_tpu_torch.parallel import MoEMLP
        MoEMLP(3, D, DFF, expert)
        res["raise"] = None
    except ValueError as err:
        res["raise"] = str(err)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: JAX, then the gang -------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """See tests/test_torch_spec.py: one throwaway ``torch.exp``."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _mesh():
    return Mesh(np.array(jax.devices()[:W]).reshape(2, 2),
                ("data", "expert"))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's layer under shard_map: per-device params (router replicated,
    the experts by expert index), output, aux and gradients."""
    mesh = _mesh()
    inp = _inputs()
    mod = jmoe.MoEMLP(num_experts=E, d_ff=DFF, num_partitions=2,
                      expert_axis="expert", k=KTOP, capacity_factor=CF)
    tok = JP(("data", "expert"))
    pspec = {"router": JP(), "wi": JP("expert"), "wo": JP("expert")}
    init = jax.jit(shard_map_compat(
        lambda x: mod.init(jax.random.PRNGKey(0), x)["params"], mesh=mesh,
        in_specs=(tok,), out_specs=pspec, check_vma=False))
    params = init(jnp.asarray(inp["x"]))

    def body(p, x, cot):
        def loss(p, x):
            y, aux = mod.apply({"params": p}, x)
            return jnp.sum(y * cot) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(p, x)
        return y, aux[None], gx, jax.tree_util.tree_map(lambda g: g[None],
                                                        gp)

    gspec = {k: JP(("data", "expert")) for k in pspec}
    run = jax.jit(shard_map_compat(
        body, mesh=mesh, in_specs=(pspec, tok, tok),
        out_specs=(tok, tok, tok, gspec), check_vma=False))
    y, aux, dx, grads = run(params, jnp.asarray(inp["x"]),
                            jnp.asarray(inp["cot"]))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": to_np(params), "y": np.asarray(y),
            "aux": np.asarray(aux), "dx": np.asarray(dx),
            "grads": to_np(grads)}


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_side):
    from apex_tpu_torch.parallel import launch
    from apex_tpu_torch.weights import _t
    out = tmp_path_factory.mktemp("moe_gang")
    p = jax_side["params"]
    inp = dict(_inputs(), sd=[from_jax_moe_params(p, rank=e, world=2)
                              for e in range(2)],
               full={k: _t(v) for k, v in p.items()})
    torch.save(inp, out / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([os.path.abspath(__file__), str(out)], W, env=env,
           timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("k,cap", [(2, 16), (2, 5), (1, 3)])
def test_routing_matches_jax(k, cap):
    from apex_tpu_torch.parallel import top_k_routing
    logits = np.random.RandomState(k * 10 + cap).randn(32, 6).astype(
        np.float32) * 2.0
    d1, c1, a1 = jmoe.top_k_routing(jnp.asarray(logits), k, cap)
    d2, c2, a2 = top_k_routing(torch.from_numpy(logits), k, cap)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), atol=1e-6, rtol=0)
    assert abs(float(a2) - float(a1)) <= 1e-6


def test_planted_tie_routes_to_the_lower_index():
    from apex_tpu_torch.parallel import top_k_routing
    logits = np.random.RandomState(3).randn(8, 6).astype(np.float32)
    logits[:, 1] = logits[:, 4] = 9.0   # every token: a tie for first
    logits[2, 0] = logits[2, 5] = 9.0   # a three-way tie on token 2
    for k in (1, 2):
        d1, _, _ = jmoe.top_k_routing(jnp.asarray(logits), k, 16)
        d2, _, _ = top_k_routing(torch.from_numpy(logits), k, 16)
        np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    first = d2.numpy().sum(axis=2)  # k = 2: the two tied experts win
    assert (first[[0, 1, 3], :][:, [1, 4]] == 1).all()
    assert first[2].tolist() == [1, 1, 0, 0, 0, 0]


def test_moe_layer_matches_jax(gang, jax_side):
    for r in range(W):
        g = gang[r]
        sl = slice(r * T, (r + 1) * T)
        _close(g["y"], jax_side["y"][sl], 1e-5)
        assert abs(g["aux"] - float(jax_side["aux"][r])) <= 1e-6
        _close(g["dx"], jax_side["dx"][sl], 1e-4)
        for k in ("router", "wi", "wo"):
            _close(g["grads"][k], jax_side["grads"][k][r], 1e-4)


def test_moe_layer_equals_one_rank_with_every_expert(gang):
    for r in range(W):
        g = gang[r]
        _close(g["y"], g["one_rank"]["y"], 1e-6)
        assert g["aux"] == g["one_rank"]["aux"]


def test_moe_all_to_alls_are_exact(gang):
    for r in range(W):
        assert gang[r]["fwd_counts"] == {"moe_dispatch": 1, "moe_combine": 1}
        assert gang[r]["counts"] == {"moe_dispatch": 2, "moe_combine": 2}


def test_from_jax_moe_params_is_each_devices_block(jax_side):
    """JAX's expert-parallel tree (the experts of both expert indices on
    the leading axis): each rank's state dict is its device's block."""
    p = jax_side["params"]
    for e in range(2):
        sd = from_jax_moe_params(p, rank=e, world=2)
        np.testing.assert_array_equal(sd["router"].numpy(), p["router"])
        for k in ("wi", "wo"):
            np.testing.assert_array_equal(sd[k].numpy(),
                                          p[k][e * E // 2:(e + 1) * E // 2])
    with pytest.raises(ValueError, match="do not divide"):
        from_jax_moe_params(p, rank=0, world=3)


def test_indivisible_experts_raise(gang):
    for r in range(W):
        assert "divisible" in gang[r]["raise"]


if __name__ == "__main__":
    _worker(sys.argv[1])
