"""Cross-process SyncBatchNorm and ResNet with DDP + SyncBN vs the JAX
package, on the CPU.

One gang of four gloo processes (this file run as a script, spawned once
by the module fixture ``gang``), each with rows ``[r n / 4,
(r + 1) n / 4)`` of one numpy-seeded global batch, against JAX's
``SyncBatchNorm(axis_name="data")`` and ``ResNet(sync_batchnorm=True)``
on a 4-device sub-mesh (``data_parallel_mesh(4)``) of the conftest's
virtual CPU devices.  The workers import no JAX, run on one thread and
rendezvous through a file; the gang has a 120 s join timeout.  The
ResNet weights come from flax's initialiser in the test process and
reach the workers through the gang's directory.

Tolerances (those of tests/test_torch_resnet.py, ROADMAP's
cross-framework ones):

- ``SyncBatchNorm`` (training and eval mode, subgroups of 2, the fused
  residual + ReLU variant, ``fuse_relu``, bf16 input): y, dx, the
  residual's gradient and each rank's partial dscale and dbias within
  1e-5 of their largest magnitude (bf16: one bf16 ulp of it), the running
  statistics within 1e-6; one all-reduce forward and one backward in
  training, none in eval;
- unequal local batches (1, 2, 3 and 2 rows) against numpy in float64 over
  the concatenated batch, within 1e-5 of the largest magnitude;
- the narrow ResNet of tests/test_torch_resnet.py (``stage_sizes=(1, 1, 1,
  1)``, width 8, 64 x 64 images, one a rank) with ``sync_batchnorm=True``
  and ``DistributedDataParallel``, ``fused_sgd(0.1, momentum 0.9, wd
  1e-4)``: at O0 (fp32) three steps on each side's own gradients, each
  step's mean loss within rtol 1e-4 and the logits within 1e-4 of the
  largest, the first step's movement of each master (the reduced
  gradient) within 1e-4 of its largest, the running statistics within
  1e-5; at O2 the first forward and backward on each side's own, the
  logits and the loss within 5e-2 and the reduced gradients as close to
  JAX's fp32 ones as JAX's O2 ones are (the ratio of the two relative L2
  distances: median within [0.9, 1.1], each within [0.5, 1.6]; JAX's O2
  gradients compiled without XLA's excess precision, which would drop
  the bf16 rounding of the casts' cotangents), then three steps on JAX's
  local scaled gradients (fp32, as JAX reduces them) with a planted inf
  in the second, which both skip: the scaler state and step count
  exactly JAX's, the masters and momentum untouched by the skip, each
  master's movement within 1e-5 relative L2 of JAX's;
- ``convert_syncbn_model`` bit for bit ``sync_batchnorm=True``, with one
  all-reduce a BatchNorm each way; RN50 has 53 BatchNorms.
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

    import apex_tpu.amp as jamp
    from apex_tpu.models.resnet import ResNet as JaxResNet
    from apex_tpu.ops import softmax_cross_entropy as jax_xent
    from apex_tpu.optimizers import fused_sgd as jax_fused_sgd
    from apex_tpu.parallel import DistributedDataParallel as JaxDDP
    from apex_tpu.parallel import data_parallel_mesh
    from apex_tpu.parallel.mesh import shard_map_compat
    from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as JaxBN

from apex_tpu_torch import amp
from apex_tpu_torch.models import ResNet, resnet50
from apex_tpu_torch.ops import softmax_cross_entropy
from apex_tpu_torch.optimizers import fused_sgd
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    Reducer,
    SyncBatchNorm,
    convert_syncbn_model,
    data_parallel_group,
    new_groups,
    shard_batch,
    syncbn_groups,
)
from apex_tpu_torch.weights import from_jax_resnet_params

C = 8
BN_SHAPE = (2 * W, 5, 5, C)          # the global batch: 2 rows a rank
UNEQUAL_ROWS = (1, 2, 3, 2)
#: SyncBatchNorm cases: module keywords, bf16 input, residual, eval, groups
BN_CASES = {
    "fp32": dict(),
    "bf16": dict(bf16=True),
    "groups_of_2": dict(groups=True),
    "residual": dict(residual=True),
    "residual_bf16": dict(residual=True, bf16=True),
    "fuse_relu": dict(kw=dict(fuse_relu=True)),
    "eval": dict(eval=True),
}
ARCH = dict(stage_sizes=(1, 1, 1, 1), width=8, num_classes=10)
HW, LR = 64, 0.1
SGD = dict(momentum=0.9, weight_decay=1e-4)
STEPS = 3
LEVELS = ("O0", "O2")


def _bn_inputs(shape=BN_SHAPE, seed=5):
    rng = np.random.RandomState(seed)
    return {"x": (2.0 + 1.5 * rng.randn(*shape)).astype(np.float32),
            "res": rng.randn(*shape).astype(np.float32),
            "cot": rng.randn(*shape).astype(np.float32),
            "scale": (1.0 + 0.1 * rng.randn(C)).astype(np.float32),
            "bias": (0.1 * rng.randn(C)).astype(np.float32),
            "running_mean": (0.3 * rng.randn(C)).astype(np.float32),
            "running_var": (1.0 + rng.rand(C)).astype(np.float32)}


def _resnet_batch():
    rng = np.random.RandomState(0)
    x = rng.randn(W, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, ARCH["num_classes"], size=(W,))
    return x, y


# -- the gang's side: each rank, torch only ------------------------------------


def _np(t):
    """A copy (the masters are updated in place)."""
    return None if t is None else t.detach().float().numpy().copy()


def _bn_run(case, rank, inputs, rows, group):
    """One SyncBatchNorm forward and backward on ``rows`` of the global
    batch: y, the new running statistics, and the gradients."""
    c = BN_CASES[case]
    dt = torch.bfloat16 if c.get("bf16") else torch.float32
    kw = dict(c.get("kw", {}))
    if c.get("groups"):
        kw["groups"] = new_groups(syncbn_groups(W, 2))
    else:
        kw["group"] = group
    bn = SyncBatchNorm(C, **kw)
    bn.load_state_dict({k: torch.from_numpy(inputs[k])
                        for k in ("scale", "bias")})
    x = torch.from_numpy(inputs["x"][rows]).to(dt).requires_grad_()
    res = (torch.from_numpy(inputs["res"][rows]).to(dt).requires_grad_()
           if c.get("residual") else None)
    stats = (torch.from_numpy(inputs["running_mean"]),
             torch.from_numpy(inputs["running_var"]))
    y, new = bn(x, stats, residual=res, use_running_average=c.get("eval",
                                                                  False))
    (y.float() * torch.from_numpy(inputs["cot"][rows])).sum().backward()
    return {"y": _np(y), "y_dtype": str(y.dtype),
            "running_mean": _np(new[0]), "running_var": _np(new[1]),
            "dx": _np(x.grad), "dres": _np(None if res is None else res.grad),
            "dscale": _np(bn.scale.grad), "dbias": _np(bn.bias.grad)}


def _case_bn(rank, case):
    rows = slice(rank * 2, rank * 2 + 2)
    return _bn_run(case, rank, _bn_inputs(), rows, data_parallel_group())


def _case_unequal(rank):
    start = sum(UNEQUAL_ROWS[:rank])
    rows = slice(start, start + UNEQUAL_ROWS[rank])
    inputs = _bn_inputs((sum(UNEQUAL_ROWS), 5, 5, C), seed=9)
    return _bn_run("fp32", rank, inputs, rows, data_parallel_group())


def _load_resnet(inputs, level, sync=True):
    model = ResNet(**ARCH, compute_dtype=(torch.bfloat16 if level == "O2"
                                          else torch.float32),
                   sync_batchnorm=sync)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in inputs["params"].items()})
    stats = {k: torch.from_numpy(v) for k, v in inputs["stats"].items()}
    return model, stats


def _resnet_opt(level):
    amp_ = amp.initialize(level)
    return amp_, amp.AmpOptimizer(fused_sgd(LR, **SGD), amp_)


def _own_step(model, stats, amp_, state, x, y):
    """One forward and backward of this rank's image, the grads reduced:
    the rank-mean loss, the logits, the new statistics, the grads."""
    names, ps = zip(*model.named_parameters())
    logits, stats = model(x, stats, train=True)
    loss = softmax_cross_entropy(logits, y).mean()
    grads = torch.autograd.grad(amp_.scale_loss(loss, state.scaler[0]), ps)
    grads = DistributedDataParallel().allreduce(dict(zip(names, grads)))
    return (float(Reducer(average=True).reduce(loss.detach())), _np(logits),
            stats, grads)


def _case_resnet_o0(rank, inputs):
    """Three fp32 DDP + SyncBN SGD steps on this rank's image, each on
    the port's own gradients."""
    model, stats = _load_resnet(inputs, "O0")
    amp_, opt = _resnet_opt("O0")
    masters = opt.attach(model)
    state = opt.init(masters)
    x, y = _resnet_batch()
    x, y = shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    losses, logits_seen, after = [], [], []
    for _ in range(STEPS):
        loss, logits, stats, grads = _own_step(model, stats, amp_, state,
                                               x, y)
        masters, state, _ = opt.step(grads, state, masters, model=model)
        losses.append(loss)
        logits_seen.append(logits)
        after.append({k: _np(v) for k, v in masters.items()})
    return {"masters": after, "stats": {k: _np(v) for k, v in stats.items()},
            "losses": losses, "logits": logits_seen}


def _case_resnet_o2(rank, inputs):
    """O2: one forward and backward of the port's own (logits, loss, the
    reduced grads), then three DDP SGD steps on JAX's local scaled grads
    of this rank's device, the second with a planted inf."""
    model, stats = _load_resnet(inputs, "O2")
    amp_, opt = _resnet_opt("O2")
    masters = opt.attach(model)
    state = opt.init(masters)
    x, y = _resnet_batch()
    x, y = shard_batch((torch.from_numpy(x), torch.from_numpy(y)))
    loss, logits, _, grads = _own_step(model, stats, amp_, state, x, y)
    own = {"loss": loss, "logits": logits,
           "loss_scale": float(state.scaler[0].loss_scale),
           "grads": {k: _np(v) for k, v in grads.items()}}
    ddp = DistributedDataParallel()
    after, skipped, kept = [], [], []
    for local in inputs["o2_local_grads"]:
        # JAX's gradients of its fp32 masters are fp32 (bf16 values), and
        # its psum sums them in fp32: so do these
        grads = {k: torch.from_numpy(v[rank]) for k, v in local.items()}
        before = {k: v.clone() for k, v in masters.items()}
        buf = {k: v.clone() for k, v in state.opt_state.momentum_buf.items()}
        masters, state, st = opt.step(ddp.allreduce(grads), state, masters,
                                      model=model)
        skipped.append(bool(st.found_inf))
        kept.append(all(torch.equal(masters[k], before[k]) for k in before)
                    and all(torch.equal(state.opt_state.momentum_buf[k],
                                        buf[k]) for k in buf))
        after.append({k: _np(v) for k, v in masters.items()})
    sc = state.scaler[0]
    return {"own": own, "masters": after, "skipped": skipped,
            "unchanged": kept,
            "scaler": [float(sc.loss_scale), int(sc.unskipped),
                       int(sc.overflows)],
            "sgd_step": int(state.opt_state.step)}


def _case_convert(rank, inputs):
    """A model built without sync, converted, against one built with it:
    the logits and running statistics bit for bit."""
    from apex_tpu_torch.parallel import (collective_counts,
                                         reset_collective_counts)

    x, y = _resnet_batch()
    x = shard_batch(torch.from_numpy(x))
    out = {}
    for how in ("built", "converted"):
        model, stats = _load_resnet(inputs, "O0", sync=how == "built")
        if how == "converted":
            convert_syncbn_model(model, data_parallel_group())
        reset_collective_counts()
        logits, new = model(x, stats, train=True)
        logits.sum().backward()
        out[how] = (logits.detach(), new, collective_counts())
    (lb, nb, cb), (lc, nc, cc) = out["built"], out["converted"]
    return {"equal": bool(torch.equal(lb, lc)
                          and all(torch.equal(nb[k], nc[k]) for k in nb)),
            "counts": cc}


def _worker(out_dir: str) -> None:
    import torch.distributed as dist

    from apex_tpu_torch.parallel import (collective_counts,
                                         init_distributed,
                                         reset_collective_counts)

    torch.set_num_threads(1)
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see test_torch_resnet
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GANG_TIMEOUT_S)
    rank = dist.get_rank()
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    cases = {**{f"bn_{n}": (lambda r, n=n: _case_bn(r, n))
                for n in BN_CASES},
             "unequal": _case_unequal,
             "resnet_O0": lambda r: _case_resnet_o0(r, inputs),
             "resnet_O2": lambda r: _case_resnet_o2(r, inputs),
             "convert": lambda r: _case_convert(r, inputs)}
    results = {}
    for name, fn in cases.items():
        reset_collective_counts()
        results[name] = fn(rank)
        results[name]["collectives"] = collective_counts()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test process: the gang, then JAX --------------------------------------


def _perturb(tree, rng):
    def go(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = go(v)
            elif k == "scale":
                out[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "bias":
                out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return go(tree)


@pytest.fixture(scope="module")
def resnet_init():
    """flax-initialised weights of the narrow ResNet (BN scales and biases
    perturbed so a misplaced gradient shows) and its batch statistics."""
    x, _ = _resnet_batch()
    variables = JaxResNet(**ARCH).init(jax.random.PRNGKey(0),
                                       jnp.asarray(x[:1]))
    params = _perturb(variables["params"], np.random.RandomState(1))
    bstats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return params, bstats


@pytest.fixture(scope="module")
def gang(tmp_path_factory, resnet_init, jax_resnet):
    from apex_tpu_torch.parallel import launch

    out = tmp_path_factory.mktemp("syncbn_gang")
    state, stats = from_jax_resnet_params(*resnet_init)
    torch.save({"params": {k: v.numpy() for k, v in state.items()},
                "stats": {k: v.numpy() for k, v in stats.items()},
                "o2_local_grads": jax_resnet["O2"]["local_grads"]},
               out / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    launch([os.path.abspath(__file__), str(out)], W, env=env,
           timeout_s=GANG_TIMEOUT_S, echo_stderr=False, check=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(W)]


@pytest.fixture(scope="module")
def mesh4():
    return data_parallel_mesh(W)


def _shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs, check_vma=False))


def _within(got, want, bf16=False) -> bool:
    """Within 1e-5 of want's largest magnitude (bf16: one bf16 ulp of
    it)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = (2.0 ** -7 if bf16 else 1e-5) * np.abs(want).max()
    return bool(np.abs(got - want).max() <= tol)


def _jax_bn(case, mesh4):
    """JAX's SyncBatchNorm over the mesh: y, dx, dres (rows by device),
    each device's dscale and dbias, the running statistics."""
    c = BN_CASES[case]
    inputs = _bn_inputs()
    jdt = jnp.bfloat16 if c.get("bf16") else jnp.float32
    groups = syncbn_groups(W, 2) if c.get("groups") else None
    jbn = JaxBN(axis_name="data", axis_index_groups=groups, **c.get("kw", {}))
    params = {"scale": jnp.asarray(inputs["scale"]),
              "bias": jnp.asarray(inputs["bias"])}
    stats = {k: jnp.asarray(inputs[k]) for k in ("running_mean",
                                                 "running_var")}
    train = not c.get("eval", False)
    x = jnp.asarray(inputs["x"]).astype(jdt)
    res = (jnp.asarray(inputs["res"]).astype(jdt) if c.get("residual")
           else jnp.zeros_like(x))

    def f(p, xx, rr, cot):
        def loss(p, xx, rr):
            out, upd = jbn.apply(
                {"params": p, "batch_stats": stats}, xx,
                residual=rr if c.get("residual") else None,
                use_running_average=not train, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32) * cot), (out, upd)

        (_, (out, upd)), g = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(p, xx, rr)
        new = upd.get("batch_stats", stats) if train else stats
        # per device: subgroups hold their own statistics, and dscale and
        # dbias are each device's partials
        per_device = jax.tree_util.tree_map(lambda t: t[None], (new, g[0]))
        return (out, g[1], g[2]) + per_device

    fn = _shmap(f, mesh4, (P(), P("data"), P("data"), P("data")),
                (P("data"),) * 5)
    out, dx, dres, new, partial = fn(params, x, res,
                                     jnp.asarray(inputs["cot"]))
    as_np = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32))  # noqa
    return {"y": as_np(out), "dx": as_np(dx), "dres": as_np(dres),
            "dscale": as_np(partial["scale"]),
            "dbias": as_np(partial["bias"]),
            "running_mean": as_np(new["running_mean"]),
            "running_var": as_np(new["running_var"])}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_sync_batchnorm_matches_jax_mesh(gang, mesh4, case):
    c = BN_CASES[case]
    bf16 = bool(c.get("bf16"))
    want = _jax_bn(case, mesh4)
    for rank, res in enumerate(gang):
        got = res[f"bn_{case}"]
        rows = slice(rank * 2, rank * 2 + 2)
        assert got["y_dtype"] == ("torch.bfloat16" if bf16
                                  else "torch.float32")
        assert _within(got["y"], want["y"][rows], bf16), (rank, "y")
        assert _within(got["dx"], want["dx"][rows], bf16), (rank, "dx")
        if c.get("residual"):
            assert _within(got["dres"], want["dres"][rows], bf16), rank
        for k in ("dscale", "dbias"):
            assert _within(got[k], want[k][rank]), (rank, k)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k][rank], rtol=0,
                                       atol=1e-6)
        assert got["collectives"] == ({} if c.get("eval") else
                                      {"sync_bn_fwd": 1, "sync_bn_bwd": 1})


def test_unequal_local_batches_match_global_numpy(gang):
    """Ranks with 1, 2, 3 and 2 rows normalise with the global count:
    y, dx, each rank's dscale and dbias, and the running statistics
    against float64 numpy over the concatenated batch."""
    inputs = _bn_inputs((sum(UNEQUAL_ROWS), 5, 5, C), seed=9)
    x = inputs["x"].astype(np.float64)
    dy = inputs["cot"].astype(np.float64)
    scale, bias = inputs["scale"], inputs["bias"]
    axes = (0, 1, 2)
    n = x.size // C
    mean, var = x.mean(axis=axes), x.var(axis=axes)
    xhat = (x - mean) / np.sqrt(var + 1e-5)
    y = xhat * scale + bias
    dxhat = dy * scale
    dx = (dxhat - dxhat.mean(axis=axes)
          - xhat * (dxhat * xhat).mean(axis=axes)) / np.sqrt(var + 1e-5)
    r_mean = 0.9 * inputs["running_mean"] + 0.1 * mean
    r_var = 0.9 * inputs["running_var"] + 0.1 * var * n / (n - 1)
    start = 0
    for rank, res in enumerate(gang):
        got = res["unequal"]
        rows = slice(start, start + UNEQUAL_ROWS[rank])
        start += UNEQUAL_ROWS[rank]
        assert _within(got["y"], y[rows]), rank
        assert _within(got["dx"], dx[rows]), rank
        assert _within(got["dscale"], (dy * xhat)[rows].sum(axis=axes))
        assert _within(got["dbias"], dy[rows].sum(axis=axes))
        np.testing.assert_allclose(got["running_mean"], r_mean, atol=1e-6)
        np.testing.assert_allclose(got["running_var"], r_var, atol=1e-6)


def _port_names(tree):
    """A flax ResNet tree (of any leading axes) by the port's names."""
    return {k: v.numpy() for k, v in from_jax_resnet_params(
        jax.tree_util.tree_map(lambda t: np.asarray(t, np.float32),
                               tree)).items()}


def _jax_resnet_run(params, bstats, level, mesh4):
    """JAX's DDP + SyncBN SGD steps over the mesh.  O0: three steps on
    its own gradients.  O2: its own first forward and backward, then three
    steps on its local scaled gradients, the second's with an inf planted
    in device 0's ``bn1.scale``; those local gradients go to the port."""
    model = JaxResNet(**ARCH, sync_batchnorm=True,
                      compute_dtype=jnp.bfloat16 if level == "O2"
                      else jnp.float32)
    jamp_ = jamp.initialize(level)
    opt = jamp.AmpOptimizer(jax_fused_sgd(LR, **SGD), jamp_)
    ddp = JaxDDP(axis_name="data")

    def grads(carry, batch):
        p32, bs, state = carry
        x, y = batch

        def loss_fn(mp):
            logits, upd = model.apply(
                {"params": opt.model_params(mp), "batch_stats": bs}, x,
                train=True, mutable=["batch_stats"])
            loss = jnp.mean(jax_xent(logits, y))
            return (jamp_.scale_loss(loss, state.scaler[0]),
                    (loss, logits, upd["batch_stats"]))

        g, (loss, logits, new_bs) = jax.grad(loss_fn, has_aux=True)(p32)
        local = jax.tree_util.tree_map(lambda t: t[None], g)
        return (jax.lax.pmean(loss, "data"), logits, new_bs, local,
                ddp.allreduce(g))

    def update(carry, local):
        p32, bs, state = carry
        g = jax.tree_util.tree_map(lambda t: t[0], local)
        p32, state, st = opt.step(ddp.allreduce(g), state, p32)
        return (p32, bs, state), st.found_inf

    x, y = _resnet_batch()
    batch = (jnp.asarray(x), jnp.asarray(y))
    carry = (params, bstats, opt.init(params))
    # XLA may drop the bf16 round trip of a cast's cotangent ("excess
    # precision"); without it the O2 gradients are rounded where the
    # port's (and JAX's own eager ones) are
    f_grads = _shmap(grads, mesh4, ((P(), P(), P()), P("data")),
                     (P(), P("data"), P(), P("data"), P())).lower(
        carry, batch).compile(
            compiler_options={"xla_allow_excess_precision": False})
    f_update = _shmap(update, mesh4, ((P(), P(), P()), P("data")),
                      ((P(), P(), P()), P()))
    out = {"losses": [], "logits": [], "masters": [], "local_grads": [],
           "skipped": []}
    for i in range(STEPS):
        loss, logits, new_bs, local, reduced = f_grads(carry, batch)
        if i == 0:
            out["reduced_grads"] = _port_names(reduced)
            out["first_loss_scale"] = float(carry[2].scaler[0].loss_scale)
        if level == "O2" and i == 1:
            local = dict(local, bn1=dict(
                local["bn1"], scale=local["bn1"]["scale"].at[0, 2].set(
                    jnp.inf)))
        carry, skipped = f_update((carry[0], new_bs, carry[2]), local)
        out["losses"].append(float(loss))
        out["logits"].append(np.asarray(logits, np.float32))
        out["masters"].append(_port_names(carry[0]))
        out["local_grads"].append(_port_names(local))
        out["skipped"].append(bool(skipped))
    _, stats = from_jax_resnet_params(carry[0], jax.tree_util.tree_map(
        np.asarray, carry[1]))
    sc = carry[2].scaler[0]
    out.update(stats={k: v.numpy() for k, v in stats.items()},
               scaler=[float(sc.loss_scale), int(sc.unskipped),
                       int(sc.overflows)],
               sgd_step=int(carry[2].opt_state.step))
    return out


@pytest.fixture(scope="module")
def jax_resnet(resnet_init, mesh4):
    return {lv: _jax_resnet_run(*resnet_init, lv, mesh4) for lv in LEVELS}


def _start(resnet_init):
    return {k: v.numpy() for k, v in
            from_jax_resnet_params(resnet_init[0]).items()}


def test_resnet_o0_ddp_syncbn_three_sgd_steps_match_jax(gang, jax_resnet,
                                                        resnet_init):
    """fp32, each side on its own gradients: each step's mean loss (rtol
    1e-4) and every rank's logits (1e-4 of the largest), the masters'
    first movement (-lr times the reduced gradient and the decay: the
    file's gradient tolerance, 1e-4 of the largest), the running
    statistics after three steps (1e-5); every rank alike."""
    want, start = jax_resnet["O0"], _start(resnet_init)
    runs = [res["resnet_O0"] for res in gang]
    got = runs[0]
    for r in runs[1:]:
        assert all(np.array_equal(r["masters"][-1][k], got["masters"][-1][k])
                   for k in got["masters"][-1])
        assert all(np.array_equal(r["stats"][k], got["stats"][k])
                   for k in got["stats"])
    for i in range(STEPS):
        np.testing.assert_allclose(got["losses"][i], want["losses"][i],
                                   rtol=1e-4)
        for rank, r in enumerate(runs):
            w = want["logits"][i][rank:rank + 1]
            assert np.abs(r["logits"][i] - w).max() <= \
                1e-4 * np.abs(w).max(), (i, rank)
    for k, v in got["masters"][0].items():
        w = want["masters"][0][k] - start[k]
        assert np.abs(v - start[k] - w).max() <= 1e-4 * np.abs(w).max(), k
    for k, v in got["stats"].items():
        w = want["stats"][k]
        assert np.abs(v - w).max() <= 1e-5 * max(1.0, np.abs(w).max()), k


def test_resnet_o2_ddp_syncbn_forward_and_grads_match_jax(gang, jax_resnet):
    """O2, the first forward and backward on each side's own: every
    rank's logits within 5e-2 of the largest, the mean loss within 5e-2,
    and the reduced gradients as close to JAX's fp32 ones as JAX's O2
    ones are (median ratio of the distances within [0.9, 1.1], each
    within [0.5, 1.6]: the file's train-mode O2 gradient rule)."""
    want, ref = jax_resnet["O2"], jax_resnet["O0"]["reduced_grads"]
    scale = gang[0]["resnet_O2"]["own"]["loss_scale"]
    assert scale == want["first_loss_scale"] == 2.0 ** 16
    for rank, res in enumerate(gang):
        own = res["resnet_O2"]["own"]
        w = want["logits"][0][rank:rank + 1]
        assert np.abs(own["logits"] - w).max() <= 5e-2 * np.abs(w).max()
        assert abs(own["loss"] - want["losses"][0]) <= 5e-2

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    own = gang[0]["resnet_O2"]["own"]["grads"]
    ratios = {k: rel(v / scale, ref[k]) / rel(
        want["reduced_grads"][k] / scale, ref[k]) for k, v in own.items()}
    assert 0.9 <= np.median(list(ratios.values())) <= 1.1, ratios
    assert 0.5 <= min(ratios.values()) and max(ratios.values()) <= 1.6, ratios


def test_resnet_o2_ddp_three_sgd_steps_on_jax_grads(gang, jax_resnet,
                                                    resnet_init):
    """tests/test_torch_resnet.py's three O2 SGD steps, across processes:
    each rank reduces JAX's local scaled gradients of its device and
    steps; the planted inf of step 2 is skipped with the masters and
    momentum untouched, the scaler state and step count exactly JAX's,
    each master's movement within 1e-5 relative L2 of JAX's."""
    want, start = jax_resnet["O2"], _start(resnet_init)
    assert want["skipped"] == [False, True, False]
    for res in gang:
        got = res["resnet_O2"]
        assert got["skipped"] == want["skipped"]
        assert got["unchanged"][1]
        assert got["scaler"] == want["scaler"]
        assert got["sgd_step"] == want["sgd_step"] == STEPS - 1
        for i in range(STEPS):
            for k, v in got["masters"][i].items():
                w = want["masters"][i][k] - start[k]
                moved = v - start[k]
                assert np.linalg.norm(moved - w) <= 1e-5 * np.linalg.norm(
                    w), (i, k)


def test_convert_syncbn_model_equals_sync_batchnorm(gang):
    """17 BatchNorms in the narrow ResNet: one all-reduce each forward and
    backward."""
    for res in gang:
        assert res["convert"]["equal"]
        assert res["convert"]["counts"] == {"sync_bn_fwd": 17,
                                            "sync_bn_bwd": 17}


def test_convert_syncbn_model_rejects_torch_batchnorm():
    model = torch.nn.Sequential(SyncBatchNorm(4),
                                torch.nn.Sequential(torch.nn.BatchNorm2d(4)))
    with pytest.raises(TypeError, match="1.0"):
        convert_syncbn_model(model, group=object())
    assert model[0].group is None  # nothing changed


def test_rn50_has_53_batchnorms_and_sync_needs_a_group():
    with torch.device("meta"):
        model = resnet50()
    assert sum(isinstance(m, SyncBatchNorm) for m in model.modules()) == 53
    with pytest.raises(RuntimeError, match="init_distributed"):
        ResNet(**ARCH, sync_batchnorm=True)


if __name__ == "__main__":
    _worker(sys.argv[1])
