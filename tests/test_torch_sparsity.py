"""apex_tpu_torch.contrib.sparsity vs the JAX package's, on the CPU.

``tests/test_sparsity.py`` case by case, each held against JAX on the
same numpy-seeded weights:

- the valid 1d and 2d pattern tables, equal in content and row order
  (the order decides argmax ties);
- the 1d-best, 2d-best and 2d-greedy masks equal bit for bit in every
  layout (torch, flax Dense ``io``, flax Conv ``hwio``, torch conv
  ``oihw``, rank 1 and 3), with padded columns, exact ties and a bf16
  tensor, and their m:n properties;
- ASP's eligibility (the ``kernel`` name, the size gates, the allow and
  deny regexes on the layer path) on the reference's MLP tree and on
  GPT and BERT tiny, the JAX paths mapped to the port's names by
  ``weights.py``'s rules, with the masks bit for bit;
- ``sparsify`` over ``fused_adam``, ``fused_lamb`` and LARC over
  ``fused_sgd``: five updates within 1e-6 (relative L2) of JAX's, pruned
  weights exactly 0; the same through ``AmpOptimizer`` (O2, the unfused
  route), where a planted overflow leaves the masters, the optimizer
  state and the masks bit for bit;
- the restore stash, disabled by default, ``is_sparsity_enabled``'s
  three outcomes;
- the checkpoint round trip: masks bit for bit into an enabled
  template, and a restore into a fresh ``tx.init`` (masks all None)
  raising instead of quietly dropping them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.contrib.sparsity import ASP as JaxASP
from apex_tpu.contrib.sparsity import sparse_masklib as jml
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForMLM as JaxBertForMLM
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.optimizers import fused_adam as jax_adam
from apex_tpu.optimizers import fused_lamb as jax_lamb
from apex_tpu.optimizers import fused_sgd as jax_sgd
from apex_tpu.optimizers import larc as jax_larc
from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.contrib.sparsity import ASP, SparsityState, sparsify
from apex_tpu_torch.contrib.sparsity import sparse_masklib as tml
from apex_tpu_torch.multi_tensor import tree_leaves
from apex_tpu_torch.optimizers import fused_adam, fused_lamb, fused_sgd, larc
from apex_tpu_torch.weights import from_jax_bert_params, from_jax_params

# the AMP-fused transforms gate themselves under sparsify; LARC over SGD
# is a plain transform, which sparsify gates
OPTIMIZERS = {
    "fused_adam": (lambda: jax_adam(1e-2), lambda: fused_adam(1e-2)),
    "fused_lamb": (lambda: jax_lamb(1e-2, weight_decay=0.01),
                   lambda: fused_lamb(1e-2, weight_decay=0.01)),
    "larc_sgd": (lambda: jax_larc(jax_sgd(0.1, momentum=0.9),
                                  learning_rate=0.1),
                 lambda: larc(fused_sgd(0.1, momentum=0.9),
                              learning_rate=0.1)),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flat(tree, prefix=""):
    """A nested JAX dict -> {'a.b.kernel': array}, the port's names for
    the MLP tree."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _weights(shape, seed, ties=False):
    rng = np.random.RandomState(seed)
    w = rng.randn(*shape).astype(np.float32)
    # rounded to halves: many groups hold equal magnitudes exactly
    return np.round(w * 2) / 2 if ties else w


# -- the mask library ---------------------------------------------------------

@pytest.mark.parametrize("m,n", [(4, 2), (4, 1), (8, 4)])
def test_valid_1d_patterns_equal_jax(m, n):
    got = tml.compute_valid_1d_patterns(m, n)
    np.testing.assert_array_equal(got, jml.compute_valid_1d_patterns(m, n))
    assert (got.sum(axis=1) == n).all()


def test_valid_2d_patterns_equal_jax_in_order():
    got = tml.compute_valid_2d_patterns(4, 2)
    assert got.shape == (90, 4, 4)  # rows exactly 2:4, cols <= 2
    np.testing.assert_array_equal(got, jml.compute_valid_2d_patterns(4, 2))


MASK_CASES = {
    "1d torch (8, 16)": ("m4n2_1d", (8, 16), None, False),
    "1d padded (4, 10)": ("m4n2_1d", (4, 10), None, False),
    "1d padded (4, 13), ties": ("m4n2_1d", (4, 13), None, True),
    "1d ties (32, 64)": ("m4n2_1d", (32, 64), None, True),
    "1d io (16, 8)": ("m4n2_1d", (16, 8), "io", False),
    "1d io (64, 48)": ("m4n2_1d", (64, 48), "io", False),
    "1d hwio (3, 3, 16, 8)": ("m4n2_1d", (3, 3, 16, 8), "hwio", False),
    "1d oihw (8, 16, 3, 3)": ("m4n2_1d", (8, 16, 3, 3), "oihw", False),
    "1d rank 3 (5, 7, 12)": ("m4n2_1d", (5, 7, 12), None, False),
    "1d rank 1 (13,)": ("m4n2_1d", (13,), None, False),
    "2d best (16, 16)": ("m4n2_2d_best", (16, 16), None, False),
    "2d best io (64, 32)": ("m4n2_2d_best", (64, 32), "io", False),
    "2d best ties (32, 32)": ("m4n2_2d_best", (32, 32), None, True),
    "2d best hwio (3, 3, 16, 8)": ("m4n2_2d_best", (3, 3, 16, 8), "hwio",
                                   False),
    "2d greedy (16, 16)": ("m4n2_2d_greedy", (16, 16), None, False),
    "2d greedy ragged (18, 22)": ("m4n2_2d_greedy", (18, 22), None, False),
    "2d greedy io (32, 16)": ("m4n2_2d_greedy", (32, 16), "io", False),
}


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_mask_equals_jax_bit_for_bit(case):
    pattern, shape, layout, ties = MASK_CASES[case]
    w = _weights(shape, len(case), ties)
    got = tml.create_mask(torch.from_numpy(w), pattern, layout=layout)
    want = np.asarray(jml.create_mask(jnp.asarray(w), pattern, layout=layout))
    assert got.shape == w.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _groups_of_4_have_2(rows):
    return bool((np.asarray(rows).reshape(-1, 4).sum(axis=1) == 2).all())


def test_mask_properties():
    """The reference's properties, on the port's masks: 1d keeps the top
    two magnitudes of each group of four; 2d-best is 2:4 along rows and
    columns; greedy never over-fills a row or column of a block; the
    flax layouts prune the input axis; a bf16 tensor gets a bf16 mask."""
    w = _weights((8, 16), 0)
    mask = tml.create_mask(torch.from_numpy(w), "m4n2_1d").numpy()
    assert _groups_of_4_have_2(mask)
    for g, k in zip(np.abs(w).reshape(-1, 4), mask.reshape(-1, 4)):
        assert set(np.argsort(g)[-2:]) == set(np.nonzero(k)[0])
    best = tml.m4n2_2d_best(torch.from_numpy(_weights((16, 16), 1))).numpy()
    assert _groups_of_4_have_2(best) and _groups_of_4_have_2(best.T)
    greedy = tml.m4n2_2d_greedy(torch.from_numpy(_weights((16, 16), 2)))
    blocks = greedy.numpy().reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)
    assert (blocks.sum(axis=3) <= 2).all() and (blocks.sum(axis=2) <= 2).all()
    dense = tml.create_mask(torch.from_numpy(_weights((16, 8), 3)),
                            layout="io").numpy()
    assert _groups_of_4_have_2(dense.T)
    conv = tml.create_mask(torch.from_numpy(_weights((3, 3, 16, 8), 4)),
                           layout="hwio").numpy()
    assert _groups_of_4_have_2(conv.transpose(0, 1, 3, 2).reshape(-1, 16))
    wb = torch.from_numpy(_weights((8, 16), 5)).to(torch.bfloat16)
    mb = tml.create_mask(wb)
    assert mb.dtype == torch.bfloat16
    want = jml.create_mask(jnp.asarray(wb.float().numpy()).astype(
        jnp.bfloat16))
    np.testing.assert_array_equal(mb.float().numpy(),
                                  np.asarray(want, np.float32))
    with pytest.raises(ValueError, match="divisible"):
        tml.m4n2_2d_best(torch.zeros(6, 8))
    with pytest.raises(ValueError, match="unknown sparsity pattern"):
        tml.create_mask(torch.zeros(8, 16), "m4n1_3d")


# -- ASP ----------------------------------------------------------------------

def _mlp_params(rng):
    """The JAX package's test tree (tests/test_sparsity.py)."""
    return {
        "dense1": {"kernel": jnp.asarray(rng.randn(32, 64).astype(np.float32)),
                   "bias": jnp.zeros((64,), jnp.float32)},
        "dense2": {"kernel": jnp.asarray(rng.randn(64, 16).astype(np.float32)),
                   "bias": jnp.zeros((16,), jnp.float32)},
        "tiny": {"kernel": jnp.asarray(rng.randn(3, 5).astype(np.float32))},
    }


def _seeded(model, seed):
    """The model's params tree (shapes by ``jax.eval_shape``, no compile)
    filled with numpy-seeded N(0, 1) values."""
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), ids)["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.randn(*s.shape).astype(np.float32)), shapes)


def _jax_gpt():
    jparams = _seeded(JaxGPTLM(JaxGPTConfig.tiny()), 1)
    return jparams, from_jax_params(jparams)


def _jax_bert():
    jparams = _seeded(JaxBertForMLM(JaxBertConfig.tiny()), 2)
    return jparams, from_jax_bert_params(jparams)


def _gpt_name(path):
    """A JAX GPT path -> the port's name (``weights.from_jax_params``)."""
    parts = path.split("/")
    if parts[0].startswith("layer_"):
        parts[0:1] = ["layers", parts[0].split("_")[1]]
    return ".".join(parts)


def _bert_name(path):
    """A JAX BERT path -> the port's name (``weights.from_jax_bert_params``:
    ``layer_i`` -> ``layers.i``)."""
    parts = []
    for p in path.split("/"):
        parts += ["layers", p.split("_")[1]] if p.startswith("layer_") else [p]
    return ".".join(parts)


def _jax_masks(jparams, **kw):
    masks, _ = JaxASP(**kw).compute_sparse_masks(jparams)
    flat = jax.tree_util.tree_flatten_with_path(
        masks, is_leaf=lambda x: x is None)[0]
    return {"/".join(str(k.key) for k in p): m for p, m in flat}


# name -> (model, JAX ASP kwargs, port ASP kwargs)
TREES = {
    "mlp": ("mlp", {}, {}),
    "mlp deny dense2": ("mlp", dict(disallowed_layer_names=("dense2",)),
                        dict(disallowed_layer_names=("dense2",))),
    "gpt": ("gpt", {}, {}),
    "gpt deny ffn_out": ("gpt", dict(disallowed_layer_names=("ffn_out",)),
                         dict(disallowed_layer_names=("ffn_out",))),
    "gpt allow layer 1": ("gpt", dict(allowed_layer_names=[r"^layer_1/"]),
                          dict(allowed_layer_names=[r"^layers\.1\."])),
    "bert": ("bert", {}, {}),
    "bert deny mlm_transform": (
        "bert", dict(disallowed_layer_names=("mlm_transform",)),
        dict(disallowed_layer_names=("mlm_transform",))),
    "bert 2d best": ("bert", dict(mask_calculator="m4n2_2d_best"),
                     dict(mask_calculator="m4n2_2d_best")),
}


@pytest.mark.parametrize("case", list(TREES))
def test_eligibility_and_masks_match_jax(case, rng):
    model, jkw, tkw = TREES[case]
    if model == "mlp":
        jparams = _mlp_params(rng)
        tparams = {k: _t(v) for k, v in _flat(jparams).items()}
        to_port = lambda p: p.replace("/", ".")  # noqa: E731
    elif model == "gpt":
        jparams, tparams = _jax_gpt()
        to_port = _gpt_name
    else:
        jparams, tparams = _jax_bert()
        to_port = _bert_name
    want = {to_port(p): m for p, m in _jax_masks(jparams, **jkw).items()
            if m is not None}
    got, stash = ASP(**tkw).compute_sparse_masks(tparams)
    assert set(got) == set(tparams)
    assert all(s is None for s in stash.values())
    sparse = sorted(k for k, m in got.items() if m is not None)
    assert sparse == sorted(want)
    assert sparse and all(k.endswith(".kernel") for k in sparse)
    for k in sparse:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if model == "mlp":
        assert got["dense1.bias"] is None and got["tiny.kernel"] is None
        assert (got["dense2.kernel"] is None) == ("deny" in case)
    if "deny" in case:
        assert not any(jkw["disallowed_layer_names"][0] in k for k in sparse)
    if "allow" in case:
        assert all(k.startswith("layers.1.") for k in sparse)


def _steps_pair(name, rng, n_steps=5):
    """The MLP tree pruned by each package's ASP and five updates of
    each package's ``sparsify(tx)`` on the same seeded grads."""
    jtx, ttx = OPTIMIZERS[name]
    jparams = _mlp_params(rng)
    jp, jtxs, js = JaxASP().prune_trained_model(jparams, jtx())
    tp, ttxs, ts = ASP().prune_trained_model(
        {k: _t(v) for k, v in _flat(jparams).items()}, ttx())
    grads = [{k: rng.randn(*np.shape(v)).astype(np.float32)
              for k, v in _flat(jparams).items()} for _ in range(n_steps)]
    return jp, jtxs, js, tp, ttxs, ts, grads


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_sparsify_updates_match_jax(name, rng):
    jp, jtx, js, tp, ttx, ts, grads = _steps_pair(name, rng)
    assert ASP.is_sparsity_enabled(ts.masks)
    zero = {k: (v == 0) for k, v in tp.items() if ts.masks[k] is not None}
    assert all(z.float().mean() == 0.5 for z in zero.values())
    for g in grads:
        jg = jax.tree_util.tree_map(
            jnp.asarray, {k1: {k2: g[f"{k1}.{k2}"] for k2 in sub}
                          for k1, sub in jp.items()})
        ju, js = jtx.update(jg, js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tu, ts = ttx.update({k: _t(v) for k, v in g.items()}, ts, tp)
        tp = {k: p + tu[k] for k, p in tp.items()}
        want = _flat(jp)
        for k in tp:
            assert _rel_l2(tp[k].numpy(), want[k]) <= 1e-6, k
    for k, z in zero.items():
        assert (tp[k][z] == 0).all(), k
    assert (tp["dense1.bias"] != 0).any()


def _state_leaves(state):
    """Every tensor of an optimizer state (NamedTuples of tensors and
    dicts), in a fixed order."""
    if isinstance(state, torch.Tensor):
        return [state]
    parts = tree_leaves(state) if isinstance(state, dict) else list(state)
    return [t for part in parts for t in _state_leaves(part)]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_sparsify_through_amp_unfused_route(name, rng):
    """O2 ``AmpOptimizer`` over ``sparsify(tx)``: a plain transform, so
    both packages take the unfused route; five steps against JAX, the
    third with an inf in a pruned position of a sparse leaf's grads,
    which must leave the masters, the inner state and the masks bit for
    bit (the fused transforms gate themselves, LARC's state is gated by
    ``sparsify``)."""
    jtx, ttx = OPTIMIZERS[name]
    jparams = _mlp_params(rng)
    jp, jwrapped, jstate = JaxASP().prune_trained_model(jparams, jtx())
    tp, twrapped, tstate = ASP().prune_trained_model(
        {k: _t(v) for k, v in _flat(jparams).items()}, ttx())
    jopt = jamp.AmpOptimizer(jwrapped, jamp.initialize("O2"))
    opt = amp.AmpOptimizer(twrapped, amp.initialize("O2"))
    js = jopt.init(jp)._replace(opt_state=jstate)
    ts = opt.init(tp)._replace(opt_state=tstate)
    masks = ts.opt_state.masks
    pruned_at = tuple(int(i) for i in
                      (masks["dense1.kernel"] == 0).nonzero()[0])
    for i in range(5):
        g = {k: rng.randn(*np.shape(v)).astype(np.float32) * 2.0 ** 10
             for k, v in _flat(jparams).items()}
        plant = i == 2
        if plant:
            g["dense1.kernel"][pruned_at] = np.inf
            before = {k: v.clone() for k, v in tp.items()}
            inner_before = [t.clone() for t in _state_leaves(
                ts.opt_state.inner)]
        jg = {k1: {k2: jnp.asarray(g[f"{k1}.{k2}"]).astype(jnp.bfloat16)
                   for k2 in sub} for k1, sub in jp.items()}
        tg = {k: _t(v).to(torch.bfloat16) for k, v in g.items()}
        jp, js, jstats = jopt.step(jg, js, jp)
        tp, ts, stats = opt.step(tg, ts, tp)
        assert bool(stats.found_inf) == bool(jstats.found_inf) == plant
        assert float(ts.scaler[0].loss_scale) == float(js.scaler[0].loss_scale)
        assert ts.opt_state.masks is masks
        if plant:
            assert all(torch.equal(tp[k], before[k]) for k in tp)
            after = _state_leaves(ts.opt_state.inner)
            assert len(after) == len(inner_before)
            assert all(torch.equal(a, b) for a, b in zip(after, inner_before))
        assert int(ts.opt_state.inner.step) == int(js.opt_state.inner.step)
        want = _flat(jp)
        for k in tp:
            assert _rel_l2(tp[k].numpy(), want[k]) <= 1e-6, (i, k)
    for k, m in masks.items():
        if m is not None:
            assert (tp[k][m == 0] == 0).all(), k


def test_allow_recompute_restore(rng):
    params = {k: _t(v) for k, v in _flat(_mlp_params(rng)).items()}
    asp = ASP(allow_recompute_mask=True)
    masks, pruned = asp.compute_sparse_masks(params)
    sparse = asp.apply_masks(params, masks)
    assert pruned["dense1.kernel"] is not None
    assert pruned["dense1.bias"] is None
    dense = asp.restore_pruned_weights(sparse, pruned)
    assert all(torch.equal(dense[k], params[k]) for k in params)
    again, _ = asp.compute_sparse_masks(sparse, pruned)
    assert all((again[k] is None) == (masks[k] is None)
               and (again[k] is None or torch.equal(again[k], masks[k]))
               for k in masks)


def test_disabled_by_default(rng):
    params = {k: _t(v) for k, v in _flat(_mlp_params(rng)).items()}
    tx = sparsify(fused_adam(1e-2))
    state = tx.init(params)
    assert isinstance(state, SparsityState)
    assert all(m is None for m in state.masks.values())
    updates, state = tx.update({k: torch.ones_like(v)
                                for k, v in params.items()}, state, params)
    assert not ASP.is_sparsity_enabled(state.masks)
    assert (updates["dense1.kernel"] != 0).all()


def test_is_sparsity_enabled_outcomes(rng):
    """No masks, all-ones masks, half-dense masks, and a mix that raises,
    as the JAX package answers them."""
    jparams = _mlp_params(rng)
    jmasks, _ = JaxASP().compute_sparse_masks(jparams)
    tmasks, _ = ASP().compute_sparse_masks(
        {k: _t(v) for k, v in _flat(jparams).items()})
    none = {k: None for k in tmasks}
    ones = {k: None if m is None else torch.ones_like(m)
            for k, m in tmasks.items()}
    mixed = dict(tmasks, **{"dense2.kernel": ones["dense2.kernel"]})
    jones = jax.tree_util.tree_map(jnp.ones_like, jmasks)
    jmixed = dict(jmasks, dense2=dict(jmasks["dense2"],
                                      kernel=jones["dense2"]["kernel"]))
    for t, j, want in ((none, {}, False), (ones, jones, False),
                       (tmasks, jmasks, True)):
        assert ASP.is_sparsity_enabled(t) is want
        assert JaxASP.is_sparsity_enabled(j) is want
    with pytest.raises(AssertionError, match="Inconsistent"):
        ASP.is_sparsity_enabled(mixed)
    with pytest.raises(AssertionError, match="Inconsistent"):
        JaxASP.is_sparsity_enabled(jmixed)


def test_masks_survive_checkpoint_roundtrip(rng, tmp_path):
    """Saved after two steps and restored into an enabled template: the
    masks, the params' zeros and the inner state bit for bit.  Into a
    fresh ``tx.init`` (every mask None) the restore raises, with the
    checksum (the stored leaves are not the template's) and without it
    (``_rebuild`` refuses stored leaves under a None)."""
    params = {k: _t(v) for k, v in _flat(_mlp_params(rng)).items()}
    params, tx, state = ASP().prune_trained_model(params, fused_lamb(1e-2))
    for _ in range(2):
        g = {k: torch.randn(v.shape, generator=torch.Generator()
                            .manual_seed(7)) for k, v in params.items()}
        u, state = tx.update(g, state, params)
        params = {k: p + u[k] for k, p in params.items()}
    carry = {"params": params, "opt": state}
    checkpoint.save_checkpoint(str(tmp_path), carry, 2)

    fresh = tx.init(params)
    other = ASP().compute_sparse_masks(
        {k: torch.randn(v.shape) for k, v in params.items()})[0]
    template = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
                "opt": ASP.enable(fresh, other)}
    got, step = checkpoint.restore_checkpoint(str(tmp_path), template)
    assert step == 2
    assert ASP.is_sparsity_enabled(got["opt"].masks)
    for k, m in state.masks.items():
        assert (m is None) == (got["opt"].masks[k] is None)
        if m is not None:
            assert torch.equal(got["opt"].masks[k], m)
            assert (got["params"][k][m == 0] == 0).all()
    assert all(torch.equal(got["params"][k], params[k]) for k in params)
    assert all(torch.equal(got["opt"].inner.m[k], state.inner.m[k])
               for k in params)

    dense_template = {"params": template["params"], "opt": tx.init(params)}
    with pytest.raises(checkpoint.CheckpointIntegrityError):
        checkpoint.restore_checkpoint(str(tmp_path), dense_template, step=2)
    with pytest.raises(ValueError, match="template has None"):
        checkpoint.restore_checkpoint(str(tmp_path), dense_template,
                                      verify=False)
