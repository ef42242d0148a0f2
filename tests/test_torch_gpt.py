"""apex_tpu_torch GPT serving forward vs the JAX package, on the CPU.

The flax params of a ``GPTConfig.tiny`` model go through
``from_jax_params``; then the port's ``paged_prefill_chunk`` and
``paged_decode_step`` run beside the JAX methods of the same names on
the same numpy-seeded tokens, page tables and pools (fp32, bf16 and
int8).  Tolerances: logits atol 1e-4 at fp32 compute (summation order
only); atol 5e-2 at bf16 compute, where both sides round activations to
bf16 at the same places but their fp32 sums can land on different sides
of a bf16 rounding boundary.  Written pools are compared the same way
(int8 pages exactly where the fp32 inputs agree to the last bit is not
guaranteed, so within one quantization step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.amp.layers import Dense as JaxDense
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.serve.kv_cache import init_paged_cache as jax_init_paged_cache
from apex_tpu_torch.amp import Dense
from apex_tpu_torch.models import GPTConfig, GPTLM, init_params
from apex_tpu_torch.serve.kv_cache import init_paged_cache
from apex_tpu_torch.weights import from_jax_params

COMPUTE = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
POOL = {"fp32": (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16),
        "int8": (jnp.int8, torch.int8)}


@pytest.fixture(scope="module")
def flax_params():
    cfg = JaxConfig.tiny(compute_dtype=jnp.float32, dropout_rate=0.0,
                         attn_dropout_rate=0.0)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(1, 16))
    params = JaxGPTLM(cfg).init(jax.random.PRNGKey(0),
                                jnp.asarray(ids))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _models(flax_params, compute):
    jdt, tdt = COMPUTE[compute]
    jcfg = JaxConfig.tiny(compute_dtype=jdt, dropout_rate=0.0,
                          attn_dropout_rate=0.0)
    tcfg = GPTConfig.tiny(compute_dtype=tdt)
    model = GPTLM(tcfg)
    model.load_state_dict(from_jax_params(flax_params))
    model.requires_grad_(False)
    return jcfg, JaxGPTLM(jcfg), model


def test_converter_maps_every_param(flax_params):
    sd = from_jax_params(flax_params)
    model = GPTLM(GPTConfig.tiny(compute_dtype=torch.float32))
    assert set(sd) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert sd[name].shape == t.shape and sd[name].dtype == torch.float32
    np.testing.assert_array_equal(
        sd["layers.1.qkv.kernel"].numpy(),
        flax_params["layer_1"]["qkv"]["kernel"])  # (in, out), untransposed
    np.testing.assert_array_equal(sd["ln_f.weight"].numpy(),
                                  flax_params["ln_f"]["scale"])
    np.testing.assert_array_equal(sd["wpe.weight"].numpy(),
                                  flax_params["wpe"]["embedding"])


def test_converter_rejects_unmapped_params(flax_params):
    """An unknown top-level key and a head with a leaf the port's head
    does not have (a bias) both raise; a bare ``head.kernel`` is the
    untied head, which maps."""
    z = np.zeros((2, 2), np.float32)
    for tree in (dict(flax_params, lm_head={"kernel": z}),
                 dict(flax_params, head={"kernel": z, "bias": z[0]})):
        with pytest.raises(ValueError, match="unmapped"):
            from_jax_params(tree)
    assert "head.kernel" in from_jax_params(dict(flax_params,
                                                 head={"kernel": z}))


@pytest.mark.parametrize("dtype", [None, "fp32", "bf16"])
def test_dense_matches_flax_layout_and_casts(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 16).astype(np.float32)
    kern = rng.randn(16, 24).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    jdt, tdt = (None, None) if dtype is None else COMPUTE[dtype]
    want = JaxDense(24, dtype=jdt).apply(
        {"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x))
    layer = Dense(16, 24, dtype=tdt)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(kern))
        layer.bias.copy_(torch.from_numpy(bias))
        got = layer(torch.from_numpy(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    atol = 5e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def _pools(jcfg, tcfg, pool, num_pages, slots, page_len):
    jdt, tdt = POOL[pool]
    jc = jax_init_paged_cache(jcfg, num_pages, slots, page_len, dtype=jdt)
    tc = init_paged_cache(tcfg, num_pages, slots, page_len, dtype=tdt,
                          device="cpu")
    return jc, tc


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("compute,pool", [("fp32", "fp32"),
                                          ("bf16", "bf16"),
                                          ("fp32", "int8"),
                                          ("bf16", "int8")])
def test_paged_prefill_and_decode_match_jax(flax_params, compute, pool):
    """Two rows prefill in two chunks (the second ragged and padded),
    then decode three steps, one row inactive on the trash page for the
    last step; logits and written pools agree with the JAX methods."""
    jcfg, jmodel, model = _models(flax_params, compute)
    tcfg = model.cfg
    page_len, pps, slots = 8, 4, 2
    num_pages = 1 + slots * pps
    jc, tc = _pools(jcfg, tcfg, pool, num_pages, slots, page_len)
    rng = np.random.RandomState(1)
    table = rng.permutation(np.arange(1, num_pages)).astype(
        np.int32).reshape(slots, pps)
    jvars = {"params": flax_params}
    quant = pool == "int8"
    jk, jv, jks, jvs = jc.k, jc.v, jc.k_scale, jc.v_scale
    atol = 5e-2 if compute == "bf16" else 1e-4

    def jax_call(*args, method):
        out = jmodel.apply(jvars, *args, k_scale=jks, v_scale=jvs,
                           method=method)
        return out if quant else (*out, None, None)

    valid_total = np.asarray([13, 9], np.int32)
    ids = rng.randint(0, jcfg.vocab_size, size=(slots, 16)).astype(np.int32)
    for base, width in ((0, 8), (8, 8)):
        valid = np.clip(valid_total - base, 0, width).astype(np.int32)
        chunk = np.where(np.arange(width)[None] < valid[:, None],
                         ids[:, base:base + width], 0).astype(np.int32)
        basev = np.full((slots,), base, np.int32)
        jl, jk, jv, jks, jvs = jax_call(
            jnp.asarray(chunk), jnp.asarray(basev), jnp.asarray(valid),
            jk, jv, jnp.asarray(table), method=JaxGPTLM.paged_prefill_chunk)
        with torch.no_grad():
            tl = model.paged_prefill_chunk(
                torch.from_numpy(chunk).long(), torch.from_numpy(basev),
                torch.from_numpy(valid), tc.k, tc.v,
                torch.from_numpy(table), k_scale=tc.k_scale,
                v_scale=tc.v_scale)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=atol)

    lengths = valid_total.copy()
    tok = np.asarray([5, 17], np.int32)
    tables = table.copy()
    for step in range(3):
        if step == 2:  # row 1 retires: its table row points at the trash
            tables[1] = 0
        jl, jk, jv, jks, jvs = jax_call(
            jnp.asarray(tok), jk, jv, jnp.asarray(tables),
            jnp.asarray(lengths), method=JaxGPTLM.paged_decode_step)
        with torch.no_grad():
            tl = model.paged_decode_step(
                torch.from_numpy(tok), tc.k, tc.v, torch.from_numpy(tables),
                torch.from_numpy(lengths), k_scale=tc.k_scale,
                v_scale=tc.v_scale)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=atol)
        tok = np.argmax(_np(jl), axis=-1).astype(np.int32)
        lengths = lengths + np.asarray([1, 1 if step < 2 else 0], np.int32)

    # the pools hold the same K/V on every real page
    real = np.arange(1, num_pages)
    if quant:
        deq = lambda p, s: _np(p)[real] * _np(s)[real][..., None]  # noqa: E731
        for jp, js, tp, ts in ((jk, jks, tc.k, tc.k_scale),
                               (jv, jvs, tc.v, tc.v_scale)):
            step = _np(js)[real].max()
            np.testing.assert_allclose(deq(tp, ts), deq(jp, js), rtol=0,
                                       atol=atol + 1.01 * step)
    else:
        np.testing.assert_allclose(_np(tc.k)[real], _np(jk)[real], rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(_np(tc.v)[real], _np(jv)[real], rtol=0,
                                   atol=atol)


def test_init_params_is_seeded_and_complete():
    cfg = GPTConfig.tiny(compute_dtype=torch.float32)
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = init_params(cfg, torch.Generator().manual_seed(3))
    model = GPTLM(cfg)
    model.load_state_dict(a)  # strict: every parameter present
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["ln_f.weight"], torch.ones(cfg.hidden_size))
    assert not a["layers.0.qkv.bias"].any()
    assert 0.015 < a["wte.weight"].std().item() < 0.025


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
def test_cast_for_serving_keeps_the_logits(compute):
    """Casting the dense weights and the head once gives bit-identical
    logits; embeddings and LayerNorm weights stay fp32."""
    cfg = GPTConfig.tiny(compute_dtype=COMPUTE[compute][1])
    params = init_params(cfg, torch.Generator().manual_seed(4))
    models = []
    for cast in (False, True):
        model = GPTLM(cfg)
        model.load_state_dict(params)
        model.requires_grad_(False)
        if cast:
            model.cast_for_serving()
        models.append(model)
    dense = models[1].layers[0].ffn_in
    assert dense.kernel.dtype == dense.bias.dtype == cfg.compute_dtype
    assert models[1].ln_f.weight.dtype == models[1].wte.weight.dtype \
        == torch.float32
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 8)))
    tables = torch.arange(1, 5, dtype=torch.int32).reshape(2, 2)
    out = []
    for model in models:
        cache = init_paged_cache(cfg, 5, 2, 8, dtype=cfg.compute_dtype,
                                 device="cpu")
        with torch.no_grad():
            pre = model.paged_prefill_chunk(
                ids, torch.zeros(2, dtype=torch.int32),
                torch.tensor([8, 5], dtype=torch.int32), cache.k, cache.v,
                tables)
            step = model.paged_decode_step(
                torch.tensor([3, 9], dtype=torch.int32), cache.k, cache.v,
                tables, torch.tensor([8, 5], dtype=torch.int32))
        out.append((pre, step))
    for a, b in zip(*out):
        assert torch.equal(a, b)
