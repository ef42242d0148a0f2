"""The ImageNet example at its learning rate, JAX's against the port's.

At lr 0.1 from a fresh start the example's loss climbs over its first
window (on an H100 at O1, -b 64: from 7.4 to 12.7) before it falls.  This
script shows whether the JAX example, the reference, climbs the same
way on the same inputs, and whether the port's update is JAX's at that
learning rate.  Both run ResNet-50 (1000 classes, 224 x 224) at O0 on
the CPU from JAX's ``model.init(PRNGKey(seed))`` weights (carried over by
``from_jax_resnet_params``), on the synthetic ``RandomState(seed)``
window both examples draw, at lr 0.1, momentum 0.9, weight decay 1e-4:

- one window of K steps: the JAX example's ``--digest-file`` losses
  (``examples/imagenet/main_amp.py``, run as a program) against the
  port's example's (its ``build``, ``make_step`` and ``windows`` on one
  process group of gloo);
- one step: each parameter's update (after - before), the JAX example's
  from its ``--checkpoint``, against the port's, as a relative L2 error
  per leaf and the cosine of the two updates.

The batch is cut from the example's 64 to ``-b`` (8 by default) to keep
the CPU's memory to a few GB.  Prints one JSON object.  Run from the
root of the repo:

    JAX_PLATFORMS=cpu python tests/witness_imagenet_lr.py [-b 8] [-k 10]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HW, CLASSES, SEED, LR = 224, 1000, 0, 0.1


def jax_example(argv, cwd):
    """Runs the JAX example as a program; its output on failure."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "imagenet",
                                      "main_amp.py"), *argv],
        cwd=cwd, capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT})
    if proc.returncode:
        raise RuntimeError(f"{argv}: {proc.stdout[-2000:]}"
                           f"{proc.stderr[-3000:]}")


def jax_init():
    """The JAX example's initial variables and optimizer state."""
    import jax
    import jax.numpy as jnp

    import apex_tpu.amp as jamp
    from apex_tpu.models.resnet import resnet50
    from apex_tpu.optimizers import fused_sgd

    model = resnet50(num_classes=CLASSES, compute_dtype=jnp.float32)
    variables = model.init(jax.random.PRNGKey(SEED),
                           jnp.zeros((2, HW, HW, 3), jnp.float32))
    opt = jamp.AmpOptimizer(fused_sgd(LR, momentum=0.9, weight_decay=1e-4),
                            jamp.initialize("O0"))
    params, bstats = jax.tree_util.tree_map(
        np.asarray, (variables["params"], variables["batch_stats"]))
    return params, bstats, opt.init(params)


def port_run(params, bstats, b, k, steps):
    """The port's example over ``steps`` synthetic steps in windows of
    ``k``: (per-step losses, the masters after)."""
    import torch

    from apex_tpu_torch.examples import imagenet as example
    from apex_tpu_torch.parallel import make_mesh
    from apex_tpu_torch.train import FusedTrainDriver, read_metrics
    from apex_tpu_torch.weights import from_jax_resnet_params

    net, carry = example.build(
        "O0", lr=LR, num_classes=CLASSES,
        device="cpu", params=from_jax_resnet_params(params, bstats))
    driver = FusedTrainDriver(example.make_step(net), steps_per_dispatch=k,
                              metrics=example.METRICS, per_step=("loss",),
                              mesh=make_mesh([("data", 1)]))
    losses = []
    for batch in example.windows(0, k, b, HW, CLASSES, "cpu",
                                 rng=np.random.RandomState(SEED),
                                 steps_per_epoch=steps):
        carry, res = driver.run_window(carry, batch)
        losses += read_metrics({**res.metrics,
                                "losses": res.per_step["loss"]})["losses"]
    return losses, {n: t.double().numpy() for n, t in carry[0].items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-b", type=int, default=8, help="the global batch")
    ap.add_argument("-k", type=int, default=10, help="steps in the window")
    args = ap.parse_args(argv)
    import jax
    import torch
    import torch.distributed as dist

    from apex_tpu.checkpoint import restore_or_init
    from apex_tpu_torch.parallel import init_distributed
    from apex_tpu_torch.weights import from_jax_resnet_params

    t0 = time.perf_counter()
    common = ["--opt-level", "O0", "-b", str(args.b), "--image-size",
              str(HW), "--num-classes", str(CLASSES), "--lr", str(LR),
              "--seed", str(SEED), "--epochs", "1", "--print-freq", "1"]
    out = {"batch": args.b, "k": args.k, "lr": LR, "opt_level": "O0",
           "torch_threads": torch.get_num_threads()}
    with tempfile.TemporaryDirectory() as tmp:
        jax_example(common + ["--steps-per-dispatch", str(args.k),
                              "--steps-per-epoch", str(args.k),
                              "--digest-file", "window.json"], tmp)
        jax_example(common + ["--steps-per-dispatch", "1",
                              "--steps-per-epoch", "1",
                              "--checkpoint", os.path.join(tmp, "ckpt")],
                    tmp)
        with open(os.path.join(tmp, "window.json")) as fh:
            jax_losses = json.load(fh)["losses"]
        params, bstats, state = jax_init()
        ckpt, epoch = restore_or_init(
            os.path.join(tmp, "ckpt"),
            {"params": params, "batch_stats": bstats, "state": state})
        assert epoch == 1, epoch
        ckpt = {k: jax.tree_util.tree_map(np.asarray, ckpt[k])
                for k in ("params", "batch_stats")}
    out["jax_s"] = time.perf_counter() - t0
    before = {n: t.double().numpy() for n, t in
              from_jax_resnet_params(params, bstats)[0].items()}
    jax_after = {n: t.double().numpy() for n, t in from_jax_resnet_params(
        ckpt["params"], ckpt["batch_stats"])[0].items()}
    init_distributed("gloo", init_method="file://" + tempfile.mktemp(),
                     rank=0, world_size=1)
    try:
        t1 = time.perf_counter()
        losses, _ = port_run(params, bstats, args.b, args.k, args.k)
        _, after = port_run(params, bstats, args.b, 1, 1)
        out["port_s"] = time.perf_counter() - t1
    finally:
        dist.destroy_process_group()

    errs, cos = {}, {}
    for n, b0 in before.items():
        want, got = jax_after[n] - b0, after[n] - b0
        norm = np.linalg.norm(want)
        if norm > 0:
            errs[n] = float(np.linalg.norm(got - want) / norm)
            cos[n] = float((got * want).sum() / norm / np.linalg.norm(got))
    worst = max(errs, key=errs.get)

    rel = [abs(a - w) / abs(w) for a, w in zip(losses, jax_losses)]
    out.update({
        "jax_losses": jax_losses, "port_losses": losses,
        "loss_rel_err": rel,
        "first_loss_rel_err": rel[0],
        "jax_climbs": max(jax_losses) > jax_losses[0],
        "port_climbs": max(losses) > losses[0],
        "one_step_update": {
            "max_rel_l2": errs[worst], "at": worst,
            "median_rel_l2": float(np.median(list(errs.values()))),
            "min_cosine": min(cos.values())},
        "seconds": time.perf_counter() - t0})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
