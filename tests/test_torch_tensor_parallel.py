"""Tensor and pipeline parallelism in the port vs the JAX package, on the
CPU: the TP dense layers, MLP and attention, the fused QKV's layout and
``weights.from_jax_tp_params``, ``pipeline_apply``, and three steps of
``examples/transformer_parallel``.

One gang of four gloo processes (this file run as a script, spawned once
by the module fixture ``gang``; one thread, a ``file://`` rendezvous, no
JAX in the workers, a 120 s join timeout), against JAX under
``shard_map`` on a 4-device sub-mesh of the conftest's virtual CPU
devices, plain paths (``use_pallas=False``).  Inputs and weights come from
numpy seeds; the TP weights from JAX's own per-shard initialisers.

Tolerances (fp32):

- on a (data 2, model 2) mesh, column-parallel (with and without the
  output gather), row-parallel, the MLP and causal attention: the output
  within 1e-5 and every gradient (the local weights', the input's) under
  ``replicated_loss`` and ``sync_replicated_grads`` within 1e-4 of its
  largest magnitude; a row-parallel backward without the cotangent sum
  (planted) must miss by more; TP attention with dropout (a port
  addition) within 1e-5 of the unsharded attention's output;
- ``from_jax_tp_params`` of a full JAX Stage tree (what ``shard_map``
  gathers), for either stage of a stacked tree, equals each JAX rank's
  local leaves exactly, and ``tp_shard_params`` of the natural QKV order
  equals it too;
- ``pipeline_apply`` over four stages, three microbatches: the output
  within 1e-5 and each stage's gradients within 1e-4; the shifts and the
  psum counted exactly;
- ``transformer_parallel`` on (pipe 2, model 2), three O0 steps: each
  loss within 1e-5 relative and each rank's masters' movement within
  1e-3 relative L2 of JAX's (the key third of the fused QKV bias left
  out: its gradient is zero but for rounding, which Adam's first steps
  turn into +-lr on either side); at O2, the first loss within 1e-2
  relative.
"""
import importlib.util
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
    from apex_tpu.optimizers import fused_adam as jax_fused_adam
    from apex_tpu.parallel import tensor_parallel as jtp
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu.parallel.pipeline import pipeline_apply as jax_pipeline

B, S, DM, DFF, NH, HD = 2, 8, 16, 32, 4, 4   # the TP layer cases
LAYERS = ("column", "column_gather", "row", "mlp", "attention")
PD, PMB, PM = 8, 4, 3                        # the pipeline case
STEPS = 3
# the JAX example's sizes (examples/transformer_parallel/main_amp.py)
EX = dict(d_model=32, d_ff=64, heads=4, head_dim=8, mb=4, m=4, seq=16)


def _tp_inputs():
    rng = np.random.RandomState(0)
    f = lambda *s: (rng.randn(*s) * 0.5).astype(np.float32)  # noqa: E731
    return {"x": f(B, S, DM), "x_wide": f(B, S, DFF),
            "w_col": f(DM, DFF), "b_col": f(DFF), "w_row": f(DFF, DM),
            "b_row": f(DM), "wqkv": f(DM, 3 * NH * HD), "bqkv": f(3 * NH * HD),
            "wproj": f(NH * HD, DM), "bproj": f(DM), "cot": f(B, S, DM),
            "cot_wide": f(B, S, DFF)}


def _pipe_inputs():
    rng = np.random.RandomState(1)
    return {"w": (rng.randn(W, PD, PD) * 0.4).astype(np.float32),
            "b": (rng.randn(W, PD) * 0.1).astype(np.float32),
            "x": rng.randn(PM, PMB, PD).astype(np.float32),
            "cot": rng.randn(PM, PMB, PD).astype(np.float32)}


def _example_data():
    rng = np.random.RandomState(0)
    shape = (EX["m"], EX["mb"], EX["seq"], EX["d_model"])
    return (rng.randn(*shape).astype(np.float32) * 0.5,
            rng.randn(*shape).astype(np.float32) * 0.5)


def _load_jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_transformer_parallel",
        os.path.join(ROOT, "examples", "transformer_parallel",
                     "main_amp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    return t.detach().float().numpy().copy()


def _tp_layer(name, inp, model, *, fault=False):
    """One TP layer case on this rank's data block: the output, and the
    gradients of the local weights and the input under replicated_loss
    (sync_replicated_grads for the replicated ones)."""
    from apex_tpu_torch.parallel import (ColumnParallelDense, RowParallelDense,
                                         TensorParallelMLP,
                                         TensorParallelSelfAttention,
                                         replicated_loss, split_column,
                                         split_row, sync_replicated_grads)
    from apex_tpu_torch.weights import qkv_partition_major
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    wide = name == "row"
    if name.startswith("column"):
        mod = ColumnParallelDense(DM, DFF, model,
                                  gather_output=name == "column_gather")
        sd = {"kernel": split_column(t["w_col"], model),
              "bias": split_column(t["b_col"], model)}
    elif name == "row":
        mod = RowParallelDense(DFF, DM, model)
        sd = {"kernel": split_row(t["w_row"], model), "bias": t["b_row"]}
    elif name == "mlp":
        mod = TensorParallelMLP(DM, DFF, model)
        sd = {"wi.kernel": split_column(t["w_col"], model),
              "wi.bias": split_column(t["b_col"], model),
              "wo.kernel": split_row(t["w_row"], model),
              "wo.bias": t["b_row"]}
    else:
        mod = TensorParallelSelfAttention(DM, NH, HD, model, causal=True)
        sd = {"qkv.kernel": split_column(qkv_partition_major(t["wqkv"], 2),
                                         model),
              "qkv.bias": split_column(qkv_partition_major(t["bqkv"], 2),
                                       model),
              "proj.kernel": split_row(t["wproj"], model),
              "proj.bias": t["bproj"]}
    mod.load_state_dict({k: v.contiguous() for k, v in sd.items()})
    if fault:
        mod._fault = True
    x = t["x_wide" if wide else "x"].clone()
    if wide:  # the row layer's input is feature-sharded
        x = split_column(x, model).contiguous()
    x.requires_grad_()
    y = mod(x)
    cot = t["cot"]
    if name == "column":
        cot = split_column(t["cot_wide"], model)
    elif name == "column_gather":
        cot = t["cot_wide"]
    loss = replicated_loss((y * cot).sum(), model)
    names, params = zip(*mod.named_parameters())
    gx, *gp = torch.autograd.grad(loss, [x, *params])
    grads = dict(zip(names, gp))
    if not wide:  # a model-replicated input: its gradient is a partial
        sync_replicated_grads(gx, model)
    sync_replicated_grads([g for k, g in grads.items() if k.endswith("bias")
                           and ("proj" in k or "wo" in k or wide)], model)
    return {"y": _np(y), "dx": _np(gx),
            "grads": {k: _np(g) for k, g in grads.items()}}


def _case_tp(rank):
    from apex_tpu_torch.parallel import (Axis, TensorParallelSelfAttention,
                                         collective_counts, make_mesh,
                                         reset_collective_counts)
    mesh = make_mesh([("data", 2), ("model", 2)])
    inp = {k: v for k, v in _tp_inputs().items()}
    rows = slice(mesh["data"].index, mesh["data"].index + 1)
    for k in ("x", "x_wide", "cot", "cot_wide"):
        inp[k] = np.ascontiguousarray(inp[k][rows])
    out = {}
    for name in LAYERS:
        reset_collective_counts()
        out[name] = _tp_layer(name, inp, mesh["model"])
        out[name]["counts"] = collective_counts()
    out["row_fault"] = _tp_layer("row", inp, mesh["model"], fault=True)
    # dropout on the local heads against the unsharded module, same seed
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    from apex_tpu_torch.parallel import split_column, split_row
    from apex_tpu_torch.weights import qkv_partition_major
    ys = []
    for axis in (mesh["model"], Axis.single("model")):
        mod = TensorParallelSelfAttention(DM, NH, HD, axis, causal=True,
                                          dropout_rate=0.25)
        mod.load_state_dict({
            "qkv.kernel": split_column(qkv_partition_major(
                t["wqkv"], axis.size), axis).contiguous(),
            "qkv.bias": split_column(qkv_partition_major(
                t["bqkv"], axis.size), axis).contiguous(),
            "proj.kernel": split_row(t["wproj"], axis).contiguous(),
            "proj.bias": t["bproj"]})
        ys.append(_np(mod(t["x"], dropout_seed=11)))
    out["dropout"] = ys
    return out


def _case_pipeline(rank):
    from apex_tpu_torch.parallel import (collective_counts, make_mesh,
                                         pipeline_apply, replicated_loss,
                                         reset_collective_counts)
    pipe = make_mesh([("pipe", W)])["pipe"]
    inp = {k: torch.from_numpy(v) for k, v in _pipe_inputs().items()}
    w = inp["w"][rank].clone().requires_grad_()
    b = inp["b"][rank].clone().requires_grad_()
    reset_collective_counts()
    out = pipeline_apply(lambda p, x: torch.tanh(x @ p[0] + p[1]), (w, b),
                         inp["x"], pipe)
    loss = replicated_loss((out * inp["cot"]).sum(), pipe)
    gw, gb = torch.autograd.grad(loss, (w, b))
    return {"out": _np(out), "gw": _np(gw), "gb": _np(gb),
            "counts": collective_counts()}


def _case_example(rank, trees, level):
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import transformer_parallel as ex
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import make_mesh
    from apex_tpu_torch.weights import from_jax_tp_params
    mesh = make_mesh([("data", 1), ("pipe", 2), ("model", 2)])
    data, pipe, model = mesh["data"], mesh["pipe"], mesh["model"]
    amp_ = amp.initialize(level)
    stage = ex.make_stage(1, EX["d_model"], EX["d_ff"], EX["heads"],
                          EX["head_dim"], model, amp_.policy.compute_dtype)
    stage.load_state_dict(from_jax_tp_params(trees, model.index, 2,
                                             stage=pipe.index))
    opt = amp.AmpOptimizer(fused_adam(ex.LR), amp_)
    masters = opt.attach(stage)
    state = opt.init(masters)
    step = ex.make_step(stage, amp_, opt, pipe, model, data)
    x, y = (torch.from_numpy(a) for a in _example_data())
    losses = []
    for _ in range(STEPS if level == "O0" else 1):
        masters, state, loss = step(masters, state, x, y)
        losses.append(float(loss))
    return {"losses": losses,
            "masters": {k: _np(v) for k, v in masters.items()}}


def _worker(out_dir: str) -> None:
    import torch.distributed as dist
    from apex_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    trees = torch.load(os.path.join(out_dir, "inputs.pt"),
                       weights_only=False)
    results = {"tp": _case_tp(rank), "pipeline": _case_pipeline(rank),
               "O0": _case_example(rank, trees, "O0"),
               "O2": _case_example(rank, trees, "O2")}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang, then JAX --------------------------------------


def _mesh(shape, names):
    return Mesh(np.array(jax.devices()[:W]).reshape(shape), names)


def _shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs, check_vma=False))


#: a Stage leaf's kind: column-parallel, row-parallel kernel, replicated
def _kind(path):
    if path[:2] in (("attn", "qkv"), ("mlp", "wi")):
        return "col"
    if path[:2] in (("attn", "proj"), ("mlp", "wo")) and path[2] == "kernel":
        return "row"
    return "rep"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@pytest.fixture(scope="module")
def jax_stages():
    """Two Stage trees from JAX's per-shard initialisers on a (pipe 2,
    model 2) mesh: the local leaves of each rank and the full (gathered)
    trees stacked over the stage, small noise added to every leaf."""
    ex = _load_jax_example()
    mesh = _mesh((1, 2, 2), ("data", "pipe", "model"))
    stage = ex.Stage(compute_dtype=jnp.float32)
    x0 = jnp.zeros((EX["mb"], EX["seq"], EX["d_model"]))

    def init(key):
        key = jax.random.fold_in(key, jax.lax.axis_index("pipe"))
        p = stage.init(key, x0)["params"]
        return jax.tree_util.tree_map(lambda a: a[None, None], p)

    local = _shmap(init, mesh, (JP(),), JP("pipe", "model"))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    local = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.randn(*a.shape[2:]).astype(
            np.float32)[None, None], local)
    full = {}
    for path, a in _leaves(local):
        kind = _kind(path)
        if kind == "col":
            f = np.concatenate([a[:, 0], a[:, 1]], axis=-1)
        elif kind == "row":
            f = np.concatenate([a[:, 0], a[:, 1]], axis=1)
        else:
            f = a[:, 0]
        _set(full, path, f)
    return ex, local, full


@pytest.fixture(scope="module")
def gang(tmp_path_factory, jax_stages):
    from apex_tpu_torch.parallel import launch
    _, _, full = jax_stages
    out = tmp_path_factory.mktemp("tp_gang")
    torch.save(full, out / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([os.path.abspath(__file__), str(out)], W, env=env,
           timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _jax_tp(name):
    """JAX's output and gradients of one TP layer case, per rank."""
    inp = {k: jnp.asarray(v) for k, v in _tp_inputs().items()}
    mesh = _mesh((2, 2), ("data", "model"))
    wqkv_pm = jnp.asarray(_pm(np.asarray(inp["wqkv"])))
    bqkv_pm = jnp.asarray(_pm(np.asarray(inp["bqkv"])))

    def body(x, xw, cot, cotw):
        col = lambda w: jtp.split_column(w, "model")  # noqa: E731
        row = lambda w: jtp.split_row(w, "model")  # noqa: E731
        if name.startswith("column"):
            params = {"kernel": col(inp["w_col"]), "bias": col(inp["b_col"])}
            gather = name == "column_gather"
            fn = lambda p, a: jtp.column_parallel_dense(  # noqa: E731
                a, p["kernel"], p["bias"], axis_name="model",
                gather_output=gather)
            a, c = x, (cotw if gather else col(cotw))
        elif name == "row":
            params = {"kernel": row(inp["w_row"]), "bias": inp["b_row"]}
            fn = lambda p, a: jtp.row_parallel_dense(  # noqa: E731
                a, p["kernel"], p["bias"], axis_name="model")
            a, c = col(xw), cot
        elif name == "mlp":
            params = {"wi": {"kernel": col(inp["w_col"]),
                             "bias": col(inp["b_col"])},
                      "wo": {"kernel": row(inp["w_row"]),
                             "bias": inp["b_row"]}}
            mod = jtp.TensorParallelMLP(d_ff=DFF, num_partitions=2)
            fn = lambda p, a: mod.apply({"params": p}, a)  # noqa: E731
            a, c = x, cot
        else:
            params = {"qkv": {"kernel": col(wqkv_pm), "bias": col(bqkv_pm)},
                      "proj": {"kernel": row(inp["wproj"]),
                               "bias": inp["bproj"]}}
            mod = jtp.TensorParallelSelfAttention(
                num_heads=NH, head_dim=HD, num_partitions=2, causal=True,
                use_pallas=False)
            fn = lambda p, a: mod.apply({"params": p}, a)  # noqa: E731
            a, c = x, cot

        def loss(p, a):
            return jtp.replicated_loss(jnp.sum(fn(p, a) * c), "model")
        y = fn(params, a)
        gp, ga = jax.grad(loss, argnums=(0, 1))(params, a)
        if name != "row":
            ga = jtp.sync_replicated_grads(ga, "model")
        if name in ("row", "mlp", "attention"):
            key = {"row": None, "mlp": "wo", "attention": "proj"}[name]
            if key is None:
                gp = dict(gp, bias=jtp.sync_replicated_grads(gp["bias"],
                                                             "model"))
            else:
                gp = dict(gp, **{key: dict(gp[key], bias=jtp.
                                           sync_replicated_grads(
                                               gp[key]["bias"], "model"))})
        flat = {".".join(p): v for p, v in _leaves(gp)}
        return jax.tree_util.tree_map(lambda v: v[None, None],
                                      (y, ga, flat))

    spec = JP("data")
    f = _shmap(body, mesh, (spec,) * 4, JP("data", "model"))
    y, ga, flat = f(inp["x"], inp["x_wide"], inp["cot"], inp["cot_wide"])
    return np.asarray(y), np.asarray(ga), {k: np.asarray(v)
                                           for k, v in flat.items()}


def _pm(w):
    from apex_tpu_torch.weights import qkv_partition_major
    return qkv_partition_major(torch.from_numpy(w.copy()), 2).numpy()


@pytest.mark.parametrize("name", LAYERS)
def test_tp_layer_matches_jax(gang, name):
    y, ga, grads = _jax_tp(name)
    for r in range(W):
        d, m = divmod(r, 2)
        got = gang[r]["tp"][name]
        _close(got["y"], y[d, m], 1e-5)
        _close(got["dx"], ga[d, m], 1e-4)
        assert set(got["grads"]) == set(grads)
        for k, g in grads.items():
            _close(got["grads"][k], g[d, m], 1e-4)


@pytest.mark.parametrize("name", LAYERS)
def test_tp_layer_collectives(gang, name):
    """One all-reduce forward and one backward a row-parallel layer,
    none for a column-parallel one (with the gather: a gather forward and
    a reduce-scatter backward), and one flat all-reduce a gradient sync
    (the input's, the replicated biases')."""
    want = {"column": {"tp_sync": 1},
            "column_gather": {"tp_gather": 2, "tp_sync": 1},
            "row": {"tp_psum": 2, "tp_sync": 1},
            "mlp": {"tp_psum": 2, "tp_sync": 2},
            "attention": {"tp_psum": 2, "tp_sync": 2}}[name]
    for r in range(W):
        assert gang[r]["tp"][name]["counts"] == want


def test_row_backward_without_the_sum_is_rejected(gang):
    _, _, grads = _jax_tp("row")
    for r in range(W):
        d, m = divmod(r, 2)
        got = gang[r]["tp"]["row_fault"]["grads"]["kernel"]
        want = grads["kernel"][d, m]
        assert np.abs(got - want).max() > 1e-4 * np.abs(want).max()


def test_tp_attention_dropout_is_the_unsharded_mask(gang):
    for r in range(W):
        sharded, whole = gang[r]["tp"]["dropout"]
        _close(sharded, whole, 1e-5)


def test_qkv_layout_round_trips():
    from apex_tpu_torch.weights import qkv_natural, qkv_partition_major
    w = torch.arange(3 * 4 * 2 * 5, dtype=torch.float32).reshape(5, 24)
    pm = qkv_partition_major(w, 2)
    # partition 0's columns are q, k, v of heads 0-1 in (3, 2, 2) order
    assert pm[0, :12].tolist() == [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18,
                                   19]
    assert torch.equal(qkv_natural(pm, 2), w)


@pytest.mark.parametrize("stage", [0, 1])
def test_from_jax_tp_params_is_each_ranks_shard(jax_stages, stage):
    from apex_tpu_torch.weights import (from_jax_tp_params, qkv_natural,
                                        tp_shard_params)
    _, local, full = jax_stages
    for m in range(2):
        got = from_jax_tp_params(full, m, 2, stage=stage)
        natural = {}
        for path, a in _leaves(local):
            name = "0." + (".".join(path).replace("ln1.scale", "ln1.weight")
                           .replace("ln2.scale", "ln2.weight"))
            np.testing.assert_array_equal(got[name].numpy(), a[stage, m])
        for k, v in from_jax_tp_params(full, 0, 1, stage=stage).items():
            natural[k] = qkv_natural(v, 2) if ".qkv." in k else v
        for k, v in tp_shard_params(natural, m, 2).items():
            assert torch.equal(v, got[k])


def test_pipeline_matches_jax(gang):
    inp = {k: jnp.asarray(v) for k, v in _pipe_inputs().items()}
    mesh = _mesh((W,), ("pipe",))

    def body(w, b, x, cot):
        def loss(p):
            out = jax_pipeline(lambda q, a: jnp.tanh(a @ q[0] + q[1]),
                               p, x, axis_name="pipe")
            return jtp.replicated_loss(jnp.sum(out * cot), "pipe"), out
        (_, out), g = jax.value_and_grad(loss, has_aux=True)((w[0], b[0]))
        return out[None], g[0][None], g[1][None]

    f = _shmap(body, mesh, (JP("pipe"), JP("pipe"), JP(), JP()),
               (JP("pipe"), JP("pipe"), JP("pipe")))
    out, gw, gb = f(inp["w"], inp["b"], inp["x"], inp["cot"])
    for r in range(W):
        got = gang[r]["pipeline"]
        _close(got["out"], out[r], 1e-5)
        _close(got["gw"], gw[r], 1e-4)
        _close(got["gb"], gb[r], 1e-4)
        # m + n - 2 shifts each way (the last tick's is not made), one
        # psum each way
        assert got["counts"] == {"pipe_shift": 2 * (PM + W - 2),
                                 "pipe_psum": 2}


def _jax_example(ex, full, level):
    """The JAX example's step on (pipe 2, model 2), from the given full
    stage trees: the losses and each rank's local masters."""
    mesh = _mesh((1, 2, 2), ("data", "pipe", "model"))
    amp_ = jamp.initialize(level)
    stage = ex.Stage(compute_dtype=amp_.policy.compute_dtype)
    opt = jamp.AmpOptimizer(jax_fused_adam(3e-3), amp_)
    x, y = (jnp.asarray(a)[None] for a in _example_data())
    specs = {}
    for path, _ in _leaves(full):
        kind = _kind(path)
        nd = np.ndim(_get(full, path))
        if kind == "col":
            s = JP("pipe", *([None] * (nd - 2)), "model")
        elif kind == "row":
            s = JP("pipe", "model", None)
        else:
            s = JP("pipe")
        _set(specs, path, s)
    steps = STEPS if level == "O0" else 1

    def body(tree, xb, yb):
        params = jax.tree_util.tree_map(lambda a: a[0], tree)
        state = opt.init(params)
        x_mb, y_mb = xb[0], yb[0]
        losses = []
        for _ in range(steps):
            def loss_fn(mp):
                out = jax_pipeline(
                    lambda p, a: stage.apply({"params": p}, a),
                    opt.model_params(mp), x_mb, axis_name="pipe")
                loss = jnp.mean((out.astype(jnp.float32) - y_mb) ** 2)
                loss = jtp.replicated_loss(
                    jtp.replicated_loss(loss, "model"), "pipe")
                return amp_.scale_loss(loss, state.scaler[0]), loss
            grads, loss = jax.grad(loss_fn, has_aux=True)(params)
            sync = lambda g: jtp.sync_replicated_grads(g, "model")  # noqa
            grads = dict(
                grads, ln1=sync(grads["ln1"]), ln2=sync(grads["ln2"]),
                attn=dict(grads["attn"], proj=dict(
                    grads["attn"]["proj"],
                    bias=sync(grads["attn"]["proj"]["bias"]))),
                mlp=dict(grads["mlp"], wo=dict(
                    grads["mlp"]["wo"], bias=sync(grads["mlp"]["wo"]["bias"]
                                                  ))))
            params, state, _ = opt.step(grads, state, params)
            losses.append(loss * 4)
        return (jnp.stack(losses),
                jax.tree_util.tree_map(lambda a: a[None, None], params))

    f = _shmap(body, mesh, (specs, JP(), JP()), (JP(), JP("pipe", "model")))
    losses, masters = f(jax.tree_util.tree_map(jnp.asarray, full), x, y)
    return np.asarray(losses), masters


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_transformer_parallel_matches_jax(gang, jax_stages, level):
    ex, local, full = jax_stages
    losses, masters = _jax_example(ex, full, level)
    for r in range(W):
        p, m = divmod(r, 2)
        got = gang[r][level]
        tol = 1e-5 if level == "O0" else 1e-2
        np.testing.assert_allclose(got["losses"], losses, rtol=tol)
        if level != "O0":
            continue
        for path, start in _leaves(local):
            name = "0." + (".".join(path).replace("ln1.scale", "ln1.weight")
                           .replace("ln2.scale", "ln2.weight"))
            want = np.asarray(_get(masters, path))[p, m]
            base = start[p, m]
            mine = got["masters"][name]
            if name.endswith("qkv.bias"):
                # the key bias adds q.b_k to a whole row of scores: its
                # gradient is 0 but for rounding, which Adam's first steps
                # blow up to +-lr on either side, so it is left out
                third = want.shape[-1] // 3
                keep = np.r_[0:third, 2 * third:3 * third]
                want, base, mine = want[keep], base[keep], mine[keep]
            d = want - base
            err = np.linalg.norm(mine - base - d)
            assert err <= 1e-3 * np.linalg.norm(d), (name, err)


if __name__ == "__main__":
    _worker(sys.argv[1])
