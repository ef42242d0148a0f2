"""Meshes, their collectives and sequence parallelism (ring and Ulysses
attention, a ring ``GPTLayer`` stack) in the port vs the JAX package, on
the CPU.

One gang of four gloo processes (this file run as a script, spawned once
by the module fixture ``gang``; one thread, a ``file://`` rendezvous, no
JAX in the workers, a 120 s join timeout).  Inputs are made from numpy
seeds; each worker takes its block and writes its results to the gang's
directory; the tests hold them against JAX under ``shard_map`` on a
4-device sub-mesh of the conftest's virtual CPU devices, with JAX's plain
paths (``use_pallas=False``).

Tolerances:

- ``make_mesh``'s coordinates and axis slices, and every collective
  (``psum``, ``all_gather``, ``reduce_scatter``, ``ring_shift`` by +1 and
  -1, ``all_to_all``, each over one axis of a (2, 2) mesh and over the
  whole 4-rank axis), forward and their gradients: exact (integer-valued
  fp32); the collective counts exact;
- ring and Ulysses attention at fp32, causal and not, with dropout 0.1:
  the output within 1e-5 and the q, k, v gradients within 1e-4 of their
  largest magnitude; the dropout mask is JAX's hash, so the comparison
  holds with it; ring attention on an axis of one member bit for bit
  ``flash_attention``, forward and gradients; the two planted ring faults
  (a wrong column offset, the causal mask off the diagonal) must miss
  the output by more than 1e-3 of its largest magnitude;
- two fp32 ``GPTLayer(attention_fn=ring)`` layers over four sequence
  shards, deterministic: the output within 1e-5 and every parameter
  gradient (the ranks' partials summed) within 1e-4 of its largest
  magnitude;
- ``examples/gpt_long_context`` (ring over seq, ZeRO over data, two
  microbatches, remat, attention dropout) on a (data 2, seq 2) mesh
  against itself on one rank: two O0 steps' losses within 1e-5 relative
  and each master's movement within 1e-4 relative L2; the collectives
  counted exactly.
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

    from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
    from apex_tpu.models.gpt import GPTLayer as JaxGPTLayer
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu.parallel.ring_attention import ring_attention as jax_ring
    from apex_tpu.parallel.ulysses import ulysses_attention as jax_ulysses

B, H, S, D = 2, 4, 64, 16        # attention: S / 4 = 16 a rank
RATE, SEED = 0.1, 7
CX = (4, 8)                      # a collective's per-rank block
HIDDEN, HEADS, LAYERS = 128, 2, 2
SX = 32                          # the stack's global sequence
LC_B = 1                         # the long-context recipe's rows a rank
ATTN_CASES = [(fn, causal) for fn in ("ring", "ulysses")
              for causal in (False, True)]
AXES = ("seq", "data", "all")    # the (2, 2) mesh's axes, and all four
OPS = ("psum", "all_gather", "reduce_scatter", "shift_fwd", "shift_bwd",
       "all_to_all")
_DENSE = ("qkv", "proj", "ffn_in", "ffn_out")


def _attn_inputs():
    rng = np.random.RandomState(0)
    return [rng.randn(B, H, S, D).astype(np.float32) * 0.5
            for _ in range(4)]  # q, k, v, the output cotangent


def _coll_inputs():
    rng = np.random.RandomState(1)
    x = rng.randint(-8, 9, size=(W,) + CX).astype(np.float32)
    cot = rng.randint(-4, 5, size=(W,) + CX).astype(np.float32)
    return x, cot


def _stack_inputs():
    rng = np.random.RandomState(2)
    x = rng.randn(B, SX, HIDDEN).astype(np.float32)
    cot = rng.randn(B, SX, HIDDEN).astype(np.float32)
    return x, cot


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    return t.detach().float().numpy().copy()


def _port_op(op, x, axis):
    from apex_tpu_torch.parallel import (all_gather, all_to_all, psum,
                                         reduce_scatter, ring_shift)
    if op == "psum":
        return psum(x, axis)
    if op == "all_gather":
        return all_gather(x, axis, dim=1)
    if op == "reduce_scatter":
        return reduce_scatter(x, axis, dim=1)
    if op == "shift_fwd":
        return ring_shift(x, axis, 1)
    if op == "shift_bwd":
        return ring_shift(x, axis, -1)
    return all_to_all(x, axis, 1, 0)


def _case_mesh(rank):
    from apex_tpu_torch.parallel import make_mesh
    out = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = make_mesh([("a", shape[0]), ("b", shape[1])])
        out[shape] = {"coords": mesh.coords,
                      "ranks": {a.name: a.ranks for a in mesh.axes}}
    return out


def _case_collectives(rank):
    from apex_tpu_torch.parallel import (collective_counts, make_mesh,
                                         reset_collective_counts)
    x_all, cot_all = _coll_inputs()
    mesh = make_mesh([("data", 2), ("seq", 2)])
    whole = make_mesh([("all", W)])
    out = {}
    for name in AXES:
        axis = whole["all"] if name == "all" else mesh[name]
        for op in OPS:
            reset_collective_counts()
            x = torch.from_numpy(x_all[rank]).requires_grad_()
            y = _port_op(op, x, axis)
            cot = torch.from_numpy(np.resize(cot_all[rank], y.shape))
            (y * cot).sum().backward()
            out[name, op] = {"y": _np(y), "dx": _np(x.grad),
                             "counts": collective_counts()}
    return out


def _case_attention(rank):
    from apex_tpu_torch.parallel import (collective_counts, make_mesh,
                                         reset_collective_counts,
                                         ring_attention, ulysses_attention)
    seq = make_mesh([("seq", W)])["seq"]
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs())
    rows = slice(rank * S // W, (rank + 1) * S // W)
    out = {}
    for fn, causal in ATTN_CASES:
        reset_collective_counts()
        f = ring_attention if fn == "ring" else ulysses_attention
        qs, ks, vs = (t[:, :, rows].clone().requires_grad_()
                      for t in (q, k, v))
        o = f(qs, ks, vs, seq, causal=causal, dropout_rate=RATE,
              dropout_seed=SEED)
        (o * do[:, :, rows]).sum().backward()
        out[fn, causal] = {"o": _np(o), "dq": _np(qs.grad),
                           "dk": _np(ks.grad), "dv": _np(vs.grad),
                           "counts": collective_counts()}
    for name, fault in (("col", {"col": 3}), ("mask_all", {"mask_all": True})):
        qs, ks, vs = (t[:, :, rows].clone() for t in (q, k, v))
        out["fault", name] = _np(ring_attention(
            qs, ks, vs, seq, causal=True, dropout_rate=RATE,
            dropout_seed=SEED, _fault=fault))
    return out


def _case_single(rank):
    """Ring attention on an axis of one member against flash_attention,
    bit for bit."""
    from apex_tpu_torch.ops.attention import flash_attention
    from apex_tpu_torch.parallel import Axis, ring_attention
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs())
    res = []
    for f in (lambda a, b, c: ring_attention(a, b, c, Axis.single("seq"),
                                             causal=True, dropout_rate=RATE,
                                             dropout_seed=SEED),
              lambda a, b, c: flash_attention(a, b, c, causal=True,
                                              dropout_rate=RATE,
                                              dropout_seed=SEED)):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        o = f(qs, ks, vs)
        (o * do).sum().backward()
        res.append([o.detach(), qs.grad, ks.grad, vs.grad])
    return {"equal": all(torch.equal(a, b) for a, b in zip(*res))}


def _case_stack(rank, weights):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTLayer
    from apex_tpu_torch.parallel import (make_mesh, ring_attention,
                                         sync_replicated_grads)
    seq = make_mesh([("seq", W)])["seq"]
    cfg = GPTConfig(hidden_size=HIDDEN, num_heads=HEADS,
                    compute_dtype=torch.float32)

    def attend(q, k, v, *, dropout_rate, dropout_seed):
        return ring_attention(q, k, v, seq, causal=True,
                              dropout_rate=dropout_rate,
                              dropout_seed=dropout_seed)

    layers = torch.nn.ModuleList(GPTLayer(cfg, attend) for _ in range(LAYERS))
    layers.load_state_dict({k: torch.from_numpy(v)
                            for k, v in weights.items()})
    x, cot = _stack_inputs()
    rows = slice(rank * SX // W, (rank + 1) * SX // W)
    h = torch.from_numpy(x[:, rows])
    for layer in layers:
        h = layer(h)
    (h * torch.from_numpy(cot[:, rows])).sum().backward()
    grads = {n: p.grad for n, p in layers.named_parameters()}
    sync_replicated_grads(grads, seq)
    return {"out": _np(h), "grads": {n: _np(g) for n, g in grads.items()}}


def _long_context(mesh, seq, data, layers_seed=0):
    """Two O0 steps of examples/gpt_long_context (M = 2, dropout 0.1,
    dots_saveable, ZeRO) on ``mesh``, or on one rank without it: the
    per-step losses and the final masters."""
    from apex_tpu_torch.examples import gpt_long_context as lc
    from apex_tpu_torch.models.gpt import GPTConfig
    from apex_tpu_torch.parallel import P
    from apex_tpu_torch.train import FusedTrainDriver
    cfg = GPTConfig(hidden_size=HIDDEN, num_heads=HEADS, dropout_rate=0.0,
                    attn_dropout_rate=RATE, compute_dtype=torch.float32)
    attend = (None if mesh is None else
              lc.sequence_attention("ring", seq, data.index * LC_B))
    layers = lc.make_layers(cfg, LAYERS, attend, device="cpu",
                            seed=layers_seed)
    gen = torch.Generator().manual_seed(1)
    step, carry, cspec = lc.build(
        layers, seq, data, opt_level="O0", microbatches=2,
        generator=gen, grad_factor=1.0 if mesh is not None else 2.0)
    driver = FusedTrainDriver(step, steps_per_dispatch=2, mesh=mesh,
                              batch_spec=None if mesh is None
                              else P("data", "seq"),
                              carry_spec=None if mesh is None else cspec,
                              per_step=("loss",))
    x, y = lc.synthetic_data(cfg, 2 * LC_B, SX)
    window = (x.expand(4, *x.shape), y.expand(4, *y.shape))
    start = {k: _np(v) for k, v in carry[0].items()}
    carry, res = driver.run_window(carry, window)
    return {"losses": res.per_step["loss"].tolist(), "start": start,
            "masters": {k: _np(v) for k, v in carry[0].items()}}


def _case_long_context(rank):
    from apex_tpu_torch.parallel import (Axis, collective_counts, make_mesh,
                                         reset_collective_counts)
    mesh = make_mesh([("data", 2), ("seq", 2)])
    reset_collective_counts()
    gang = _long_context(mesh, mesh["seq"], mesh["data"])
    gang["counts"] = collective_counts()
    one = _long_context(None, Axis.single("seq"), Axis.single("data"))
    return {"gang": gang, "one": one}


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    weights = torch.load(os.path.join(out_dir, "inputs.pt"),
                         weights_only=False)
    results = {"mesh": _case_mesh(rank),
               "collectives": _case_collectives(rank),
               "attention": _case_attention(rank),
               "single": _case_single(rank),
               "stack": _case_stack(rank, weights),
               "long_context": _case_long_context(rank)}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang, then JAX --------------------------------------


def _layer_state(tree, i):
    """A flax GPTLayer tree -> the port's names under ``{i}.``."""
    out = {}
    for ln in ("ln1", "ln2"):
        out[f"{i}.{ln}.weight"] = np.asarray(tree[ln]["scale"])
        out[f"{i}.{ln}.bias"] = np.asarray(tree[ln]["bias"])
    for dense in _DENSE:
        out[f"{i}.{dense}.kernel"] = np.asarray(tree[dense]["kernel"])
        out[f"{i}.{dense}.bias"] = np.asarray(tree[dense]["bias"])
    return out


def _perturb(tree, rng):
    """Random biases and LayerNorm parameters, so that a misplaced
    gradient shows."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a + 0.05 * rng.randn(*a.shape)
                              .astype(np.float32)), tree)


@pytest.fixture(scope="module")
def jax_layers():
    cfg = JaxGPTConfig.tiny(compute_dtype=jnp.float32)
    x, _ = _stack_inputs()
    rng = np.random.RandomState(3)
    return [_perturb(JaxGPTLayer(cfg).init(jax.random.PRNGKey(i),
                                           jnp.asarray(x[:, :8]))["params"],
                     rng) for i in range(LAYERS)]


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_layers):
    from apex_tpu_torch.parallel import launch
    out = tmp_path_factory.mktemp("seq_gang")
    weights = {}
    for i, tree in enumerate(jax_layers):
        weights.update(_layer_state(tree, i))
    torch.save(weights, out / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([os.path.abspath(__file__), str(out)], W, env=env,
           timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:W]).reshape(shape), names)


def _shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs, check_vma=False))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_make_mesh_matches_jax_layout(gang, shape):
    """Rank r sits where device r sits in JAX's reshaped device array, and
    each axis slice holds the ranks that vary along that axis."""
    grid = np.arange(W).reshape(shape)
    for r in range(W):
        got = gang[r]["mesh"][shape]
        i, j = (int(c[0]) for c in np.nonzero(grid == r))
        assert got["coords"] == {"a": i, "b": j}
        assert got["ranks"] == {"a": tuple(int(v) for v in grid[:, j]),
                                "b": tuple(int(v) for v in grid[i])}


def _jax_op(op, name):
    ax = "data" if name == "all" else name

    def f(x):
        x = x[0]
        if op == "psum":
            y = jax.lax.psum(x, ax)
        elif op == "all_gather":
            y = jax.lax.all_gather(x, ax, axis=1, tiled=True)
        elif op == "reduce_scatter":
            y = jax.lax.psum_scatter(x, ax, scatter_dimension=1, tiled=True)
        elif op in ("shift_fwd", "shift_bwd"):
            n = jax.lax.psum(1, ax)
            s = 1 if op == "shift_fwd" else -1
            y = jax.lax.ppermute(x, ax, [(j, (j + s) % n) for j in range(n)])
        else:
            y = jax.lax.all_to_all(x, ax, 1, 0, tiled=True)
        return y[None]
    return f


@pytest.mark.parametrize("name", AXES)
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_jax(gang, op, name):
    """Each collective and its gradient, exactly JAX's under shard_map,
    one collective a direction."""
    x_all, cot_all = _coll_inputs()
    if name == "all":
        mesh, spec = _mesh((W,), ("data",)), JP("data")
    else:
        mesh, spec = _mesh((2, 2), ("data", "seq")), JP(("data", "seq"))
    f = _shmap(_jax_op(op, name), mesh, (spec,), spec)
    y = np.asarray(f(jnp.asarray(x_all)))
    cot = np.stack([np.resize(cot_all[r], y.shape[1:]) for r in range(W)])
    dx = np.asarray(jax.grad(lambda a: jnp.sum(f(a) * cot))(
        jnp.asarray(x_all)))
    for r in range(W):
        got = gang[r]["collectives"][name, op]
        np.testing.assert_array_equal(got["y"], y[r])
        np.testing.assert_array_equal(got["dx"], dx[r])
        tag = {"psum": "all_reduce", "shift_fwd": "ring_shift",
               "shift_bwd": "ring_shift"}.get(op, op)
        assert got["counts"] == {tag: 2}


def _jax_attention(fn, causal):
    q, k, v, do = (jnp.asarray(a) for a in _attn_inputs())
    mesh = _mesh((W,), ("seq",))
    spec = JP(None, None, "seq")
    impl = jax_ring if fn == "ring" else jax_ulysses

    def body(a, b, c):
        return impl(a, b, c, axis_name="seq", causal=causal,
                    dropout_rate=RATE, dropout_seed=jnp.int32(SEED),
                    use_pallas=False)
    f = _shmap(body, mesh, (spec, spec, spec), spec)
    o = f(q, k, v)
    grads = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) * do),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("fn,causal", ATTN_CASES)
def test_sequence_attention_matches_jax(gang, fn, causal):
    o, (dq, dk, dv) = _jax_attention(fn, causal)
    for r in range(W):
        got = gang[r]["attention"][fn, causal]
        rows = slice(r * S // W, (r + 1) * S // W)
        _close(got["o"], o[:, :, rows], 1e-5)
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            _close(got[name], want[:, :, rows], 1e-4)


@pytest.mark.parametrize("fn,causal", ATTN_CASES)
def test_sequence_attention_counts(gang, fn, causal):
    """Ring: n - 1 shifts of K and of V forward; n - 1 of K and V and n
    of dK and dV backward.  Ulysses: four all-to-alls each way."""
    want = {"ring": 2 * (W - 1) + 2 * (W - 1) + 2 * W}.get(fn, 8)
    for r in range(W):
        assert gang[r]["attention"][fn, causal]["counts"] == {fn: want}


@pytest.mark.parametrize("fault", ["col", "mask_all"])
def test_planted_ring_faults_are_rejected(gang, fault):
    o, _ = _jax_attention("ring", True)
    for r in range(1, W):  # rank 0 holds the diagonal block alone
        rows = slice(r * S // W, (r + 1) * S // W)
        got = gang[r]["attention"]["fault", fault]
        assert np.abs(got - o[:, :, rows]).max() > 1e-3 * np.abs(o).max()


def test_ring_on_one_member_is_flash_attention(gang):
    assert all(gang[r]["single"]["equal"] for r in range(W))


def test_ring_gpt_stack_matches_jax(gang, jax_layers):
    cfg = JaxGPTConfig.tiny(compute_dtype=jnp.float32)
    x, cot = (jnp.asarray(a) for a in _stack_inputs())
    mesh = _mesh((W,), ("seq",))

    def attend(q, k, v, *, dropout_rate, dropout_seed):
        return jax_ring(q, k, v, axis_name="seq", causal=True,
                        dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                        use_pallas=False)

    layer = JaxGPTLayer(cfg, attention_fn=attend)

    def body(params, xb):
        for p in params:
            xb = layer.apply({"params": p}, xb, True)
        return xb
    spec = JP(None, "seq")
    f = _shmap(body, mesh, (JP(), spec), spec)
    out = f(jax_layers, x)
    grads = jax.grad(lambda p: jnp.sum(f(p, x) * cot))(jax_layers)
    want = {}
    for i, g in enumerate(grads):
        want.update(_layer_state(g, i))
    for r in range(W):
        got = gang[r]["stack"]
        rows = slice(r * SX // W, (r + 1) * SX // W)
        _close(got["out"], np.asarray(out)[:, rows], 1e-5)
        assert set(got["grads"]) == set(want)
        for n, g in want.items():
            _close(got["grads"][n], g, 1e-4)


def test_long_context_gang_is_the_one_rank_run(gang):
    """examples/gpt_long_context on (data 2, seq 2), two O0 steps of two
    microbatches with attention dropout, against the same recipe on one
    rank over the whole batch and sequence (its loss taken n_seq times
    for the gradient, JAX's convention): the losses within 1e-5
    relative and each master's movement within 1e-4 relative L2."""
    for r in range(W):
        got, one = gang[r]["long_context"]["gang"], \
            gang[r]["long_context"]["one"]
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        for k, v in one["masters"].items():
            moved = np.linalg.norm(v - one["start"][k])
            assert np.linalg.norm(got["masters"][k] - v) <= 1e-4 * moved


def test_long_context_collectives_a_step(gang):
    """A boundary: the presum all-reduce over seq, ZeRO's flag
    all-reduce, reduce-scatter and all-gather over data; a microbatch:
    the loss's psum over seq each way and its data mean, and each of the
    two layers' ring forward twice (the remat recompute) and backward
    once."""
    n = 2
    ring_fwd, ring_bwd = 2 * (n - 1), 2 * (n - 1) + 2 * n
    per_mb = {"loss": 2 + 1, "ring": LAYERS * (2 * ring_fwd + ring_bwd)}
    per_step = {"seq_presum": 1, "zero_flag": 1, "zero_grads": 1,
                "zero_params": 1}
    want = {k: 2 * 2 * v for k, v in per_mb.items()}
    want.update({k: 2 * v for k, v in per_step.items()})
    for r in range(W):
        assert gang[r]["long_context"]["gang"]["counts"] == want


if __name__ == "__main__":
    _worker(sys.argv[1])
