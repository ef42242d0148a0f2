"""The port's partition-rule engine (``apex_tpu_torch.sharding``) vs the
JAX package's (``apex_tpu.sharding``), on the CPU, no process group.

- Every canonical table (``default_rules``, ``train_state_rules``,
  ``activation_rules``, ``serve_cache_rules``): ``to_json`` byte for
  byte and ``fingerprint`` equal to JAX's, and ``from_json`` round trips;
- ``default_rules`` over the GPT, BERT and ResNet parameter trees (the
  flax trees' shapes, from ``jax.eval_shape``) on dp, dp x tp and
  dp x fsdp meshes: every leaf's spec, printed as JAX prints a
  ``PartitionSpec``, equals JAX's, and so do the census and ``describe``;
- the carry trees: ``zero_state_spec``, ``fsdp_state_spec``,
  ``ef_state_spec``, ``adasum_state_spec`` and the serve caches' specs
  equal JAX's and the hand-built literals (kept here as expected
  values), as do a real ZeRO carry's specs matched by the driver's
  ``RulesTable`` ``carry_spec``;
- ``UnmatchedLeafError`` names the paths, scalars never partition,
  ``filter_spec`` projects onto a mesh, ``rules_outcome`` equals JAX's
  and ``outcomes_differ`` reads mode, mesh and table changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import apex_tpu.sharding as jshd
from apex_tpu.models.bert import BertConfig as JaxBertConfig
from apex_tpu.models.bert import BertForMLM as JaxBert
from apex_tpu.models.gpt import GPTConfig as JaxGPTConfig
from apex_tpu.models.gpt import GPTLM as JaxGPT
from apex_tpu.models.resnet import ResNet as JaxResNet
import apex_tpu_torch.sharding as shd
from apex_tpu_torch.parallel import P, Mesh

TABLES = ("default_rules", "train_state_rules", "activation_rules",
          "serve_cache_rules")
MESHES = {"dp": (("data",), (4,)), "dp_tp": (("data", "model"), (2, 2)),
          "dp_fsdp": (("data", "fsdp"), (2, 2))}


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """See tests/test_torch_spec.py: one throwaway ``torch.exp``."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


def _shapes(tree):
    """A flax params tree of ``ShapeDtypeStruct`` -> zeros of the shapes
    (numpy), for both engines."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  tree)


@pytest.fixture(scope="module")
def trees():
    key = jax.random.PRNGKey(0)
    gpt = JaxGPT(JaxGPTConfig.tiny(tie_word_embeddings=False))
    bert = JaxBert(JaxBertConfig.tiny())
    ids = jnp.zeros((1, 8), jnp.int32)
    rn = JaxResNet(stage_sizes=(1, 1, 1, 1), num_classes=10, width=8)
    img = jnp.zeros((1, 32, 32, 3), jnp.float32)
    return {
        "gpt": _shapes(jax.eval_shape(gpt.init, key, ids)["params"]),
        "bert": _shapes(jax.eval_shape(bert.init, key, ids)["params"]),
        "resnet": _shapes(jax.eval_shape(
            lambda k: rn.init(k, img, train=False), key)["params"]),
    }


def _jax_mesh(names, shape):
    n = int(np.prod(shape))
    return JaxMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _port_mesh(names, shape):
    return Mesh(names, shape, ())  # only the axis names are read


def _strs(spec_tree, is_port):
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    leaves = (shd.rules._spec_leaves(spec_tree) if is_port else
              jax.tree_util.tree_leaves(spec_tree, is_leaf=is_spec))
    return [shd.spec_str(s) if is_port else str(s) for s in leaves]


@pytest.mark.parametrize("name", TABLES)
def test_json_and_fingerprint_are_jax_bytes(name):
    port, jx = getattr(shd, name)(), getattr(jshd, name)()
    assert port.to_json() == jx.to_json()
    assert port.fingerprint() == jx.fingerprint()
    back = shd.RulesTable.from_json(jx.to_json())
    assert back.fingerprint() == jx.fingerprint()
    assert back.rules == port.rules and back.catch_all


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("model", ["gpt", "bert", "resnet"])
def test_default_rules_match_jax_over_model_trees(trees, model, mesh):
    tree = trees[model]
    names, shape = MESHES[mesh]
    got = shd.DEFAULT_RULES.match(tree, mesh=_port_mesh(names, shape))
    want = jshd.DEFAULT_RULES.match(tree, mesh=_jax_mesh(names, shape))
    assert _strs(got, True) == _strs(want, False)
    paths = [p for p, _ in shd.named_tree_paths(tree)]
    assert paths == [p for p, _ in jshd.named_tree_paths(tree)]
    assert shd.DEFAULT_RULES.census(tree, mesh=_port_mesh(names, shape)) \
        == jshd.DEFAULT_RULES.census(tree, mesh=_jax_mesh(names, shape))
    assert shd.DEFAULT_RULES.describe(tree, _port_mesh(names, shape)) \
        == jshd.DEFAULT_RULES.describe(tree, _jax_mesh(names, shape))


def test_carry_specs_match_jax_and_the_literals():
    import apex_tpu.serve.sharding as jserve
    import apex_tpu.train.accum as jaccum
    import apex_tpu.train.compress as jcompress
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState)
    from apex_tpu_torch.serve import cache_pspec, paged_cache_pspec
    from apex_tpu_torch.serve.kv_cache import KVCache, PagedKVCache
    from apex_tpu_torch.train import (EfState, FsdpAmpState, FsdpOptState,
                                      ZeroAmpState, adasum_state_spec,
                                      ef_state_spec, fsdp_state_spec,
                                      zero_state_spec)
    ax = P("data")
    kv = P(None, None, "model")
    literal = {
        "zero": ZeroAmpState(ShardedOptState(P(), ax, ax, ax), P()),
        "fsdp": FsdpAmpState(FsdpOptState(P(), ax, ax), P()),
        "ef": EfState(ax),
        "adasum": P(),
        "cache": KVCache(kv, kv, P(), P()),
        "paged": PagedKVCache(kv, kv, P(), P(), None, None),
        "paged_int8": PagedKVCache(kv, kv, P(), P(), kv, kv),
    }
    port = {"zero": zero_state_spec(), "fsdp": fsdp_state_spec(),
            "ef": ef_state_spec(), "adasum": adasum_state_spec(),
            "cache": cache_pspec(), "paged": paged_cache_pspec(),
            "paged_int8": paged_cache_pspec(quantized=True)}
    jax_ = {"zero": jaccum.zero_state_spec(),
            "fsdp": jaccum.fsdp_state_spec(),
            "ef": jcompress.ef_state_spec(),
            "adasum": jaccum.adasum_state_spec(),
            "cache": jserve.cache_pspec(),
            "paged": jserve.paged_cache_pspec(),
            "paged_int8": jserve.paged_cache_pspec(quantized=True)}
    for k in literal:
        assert port[k] == literal[k], k
        assert _strs(port[k], True) == _strs(jax_[k], False), k


def test_driver_rules_carry_spec_over_a_zero_carry():
    from apex_tpu_torch import amp as tamp
    from apex_tpu_torch.contrib.optimizers.distributed_fused import (
        ShardedOptState)
    from apex_tpu_torch.train import (FusedTrainDriver, ZeroAmpState,
                                      zero_state_spec)
    mesh = _port_mesh(("data",), (1,))
    params = {"a": torch.zeros(3, 2), "b": torch.zeros(5)}
    carry = (params, ZeroAmpState(
        ShardedOptState(torch.zeros((), dtype=torch.int32), torch.zeros(12),
                        torch.zeros(12), torch.zeros(12)),
        tamp.initialize("O2").init_state("cpu")))
    driver = FusedTrainDriver(lambda c, b: (c, {}), mesh=mesh,
                              carry_spec=shd.train_state_rules("data"))
    got = driver.carry_spec_for(carry)
    assert got[0] == {"a": P(), "b": P()}
    want = zero_state_spec()
    assert got[1].opt_state == want.opt_state
    # the scalers' 0-d leaves never partition
    assert all(s == P() for s in shd.rules._spec_leaves(got[1].scaler))


def test_unmatched_scalars_filter_and_census():
    table = shd.RulesTable([(r"/kernel$", P("fsdp", "model"))],
                           name="t")
    tree = {"dense": {"kernel": np.zeros((4, 4)), "bias": np.zeros(4)},
            "step": np.zeros(())}
    with pytest.raises(shd.UnmatchedLeafError, match="dense/bias"):
        table.match(tree)
    jtable = jshd.RulesTable([(r"/kernel$", jax.sharding.PartitionSpec(
        "fsdp", "model"))], name="t")
    with pytest.raises(jshd.UnmatchedLeafError, match="dense/bias"):
        jtable.match(tree)
    rep = shd.RulesTable(table.rules, name="t", on_unmatched="replicate")
    specs = rep.match(tree)
    assert specs == {"dense": {"kernel": P("fsdp", "model"), "bias": P()},
                     "step": P()}
    assert rep.census(tree) == jshd.RulesTable(
        jtable.rules, name="t", on_unmatched="replicate").census(tree)
    assert shd.filter_spec(P("fsdp", "model"), ("data", "model")) == \
        P(None, "model")
    assert shd.filter_spec(P(("data", "fsdp"), None), ("data",)) == P("data")
    assert shd.filter_spec(P("fsdp"), ("data",)) == P()
    with pytest.raises(TypeError, match="must be a P"):
        shd.RulesTable([(".*", "data")])
    with pytest.raises(ValueError, match="does not compile"):
        shd.RulesTable([("(", P())])
    # a state-dict name's dots are path segments
    assert [p for p, _ in shd.named_tree_paths(
        {"layers.0.qkv.kernel": 1})] == ["layers/0/qkv/kernel"]


def test_rules_outcome_equals_jax_and_differ():
    tree = {"master_shard": np.zeros((8,)), "step": np.zeros(())}
    table, jtable = shd.train_state_rules(), jshd.train_state_rules()
    got = shd.rules_outcome(table, tree, _port_mesh(("data",), (4,)),
                            mode="zero")
    want = jshd.rules_outcome(jtable, tree, _jax_mesh(("data",), (4,)),
                              mode="zero")
    assert got == want
    other = dict(got, mesh={"data": 2})
    assert shd.outcomes_differ(got, other)
    assert shd.outcomes_differ(got, dict(got, mode="fsdp"))
    assert shd.outcomes_differ(None, got)
    assert not shd.outcomes_differ(got, dict(got))
