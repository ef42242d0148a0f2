"""GPT-2 small's first training steps in the JAX package and in the port,
from the same weights on the same batch, on the CPU.

    JAX_PLATFORMS=cpu python tests/_gpt_trajectory.py [B S STEPS]

fp32 (O0), dropout off, ``AmpOptimizer(fused_adam(6e-4,
weight_decay=0.1))`` on both sides, one numpy-seeded batch stepped on
again and again (as ``chip_smoke.py``'s GPT training set-ups do), the
weights flax's init carried to the port by ``from_jax_params``.  Prints
each step's loss on both sides and how far the masters are apart: the
key third of each ``qkv.bias`` apart (its gradient is 0 in exact
arithmetic, so each side's Adam step on it follows rounding noise, and
it does not change the output), and every other leaf.  Defaults 4 x
256, 5 steps: about a minute and 3 GB.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import apex_tpu.amp as jamp  # noqa: E402
from apex_tpu.models.gpt import GPTConfig as JaxConfig  # noqa: E402
from apex_tpu.models.gpt import GPTLM as JaxGPTLM  # noqa: E402
from apex_tpu.optimizers import fused_adam as jax_fused_adam  # noqa: E402
from apex_tpu_torch import amp  # noqa: E402
from apex_tpu_torch.models import GPTConfig, GPTLM  # noqa: E402
from apex_tpu_torch.optimizers import fused_adam  # noqa: E402
from apex_tpu_torch.weights import from_jax_params  # noqa: E402


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def main(b: int = 4, s: int = 256, steps: int = 5) -> None:
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))  # see the test files
    cfg = JaxConfig.small(compute_dtype=jnp.float32)
    rng = np.random.RandomState(10)
    ids = rng.randint(0, cfg.vocab_size, size=(b, s))
    labels = np.concatenate([ids[:, 1:], np.full((b, 1), -100)], axis=1)
    jmodel = JaxGPTLM(cfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray(ids[:1, :16]))["params"]

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            labels=jnp.asarray(labels),
                            deterministic=True)[1]

    jopt = jamp.AmpOptimizer(jax_fused_adam(6e-4, weight_decay=0.1),
                             jamp.initialize("O0"))
    jgrad, jstep = jax.jit(jax.value_and_grad(jloss)), jax.jit(jopt.step)
    jp, js = params, jopt.init(params)
    model = GPTLM(GPTConfig.small(compute_dtype=torch.float32))
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    opt = amp.AmpOptimizer(fused_adam(6e-4, weight_decay=0.1),
                           amp.initialize("O0"))
    masters = opt.attach(model)
    state = opt.init(masters)
    names, ps = zip(*model.named_parameters())
    ti, tl = torch.from_numpy(ids), torch.from_numpy(labels)
    h = cfg.hidden_size
    for i in range(steps):
        jl, g = jgrad(jp)
        jp, js, _ = jstep(g, js, jp)
        _, loss = model(ti, tl)
        grads = dict(zip(names, torch.autograd.grad(loss, ps)))
        masters, state, _ = opt.step(grads, state, masters, model=model)
        want = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
        key_bias = max(_rel(masters[k][h:2 * h], want[k][h:2 * h])
                       for k in want if k.endswith("qkv.bias"))
        others = max(
            [_rel(masters[k], want[k]) for k in want
             if not k.endswith("qkv.bias")]
            + [_rel(masters[k][sl], want[k][sl]) for k in want
               if k.endswith("qkv.bias")
               for sl in (slice(0, h), slice(2 * h, 3 * h))])
        print(f"step {i + 1}: loss jax {float(jl):.6f} port "
              f"{float(loss.detach()):.6f} (|diff| "
              f"{abs(float(jl) - float(loss.detach())):.2e}); masters "
              f"apart (relative L2): key bias {key_bias:.2e}, every other "
              f"leaf <= {others:.2e}", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
