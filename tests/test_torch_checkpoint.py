"""apex_tpu_torch.checkpoint and ``FusedTrainDriver.save``/``restore``, on
the CPU.

The contract of ``tests/test_checkpoint.py``, case for case, on the
port's ``torch.save`` checkpoints: bitwise resume of GPT tiny O2 after a
restore into a state built from another seed, the scaler round trip, a
missing path, the sidecar and ``keep`` >= 2, the digest's sensitivity
(content, path, dtype, shape, bf16 and generators included), the newest
step corrupted falling back to the one before, an explicit corrupted
step raising, a step without a sidecar used only when nothing verifies,
``verified_latest_step``, ``restore_or_init``, and a save that raises
midway leaving the earlier steps restorable and no step listed.

Then the driver: GPT tiny O2 with dropout and its generator in the
carry, saved after one window and restored into a carry built from
another seed, resumes bit for bit (losses, scale state, masters, Adam
moments, the generator's state); and a deterministic resumed run holds
its trajectory against JAX's unbroken ``FusedTrainDriver`` run from the
same weights: each of the 7 losses within ROADMAP's 1e-3 (relative) of
JAX's, the scale state exact.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.amp as jamp
from apex_tpu.models.gpt import GPTConfig as JaxConfig
from apex_tpu.models.gpt import GPTLM as JaxGPTLM
from apex_tpu.optimizers import fused_adam as jax_fused_adam
from apex_tpu.train import FusedTrainDriver as JaxDriver
from apex_tpu.train import read_metrics as jax_read_metrics
from apex_tpu_torch import amp, checkpoint
from apex_tpu_torch.checkpoint import (
    CHECKSUM_FILE,
    CheckpointIntegrityError,
    latest_step,
    restore_checkpoint,
    restore_or_init,
    save_checkpoint,
    state_digest,
    verified_latest_step,
)
from apex_tpu_torch.models import GPTConfig, GPTLM
from apex_tpu_torch.optimizers import fused_adam
from apex_tpu_torch.train import FusedTrainDriver, read_metrics
from apex_tpu_torch.weights import from_jax_params

B, S = 2, 64
LR, WD = 6e-4, 0.1


@pytest.fixture(autouse=True, scope="module")
def _warm_torch_exp():
    """With torch 2.13.0+cpu the first multi-threaded ``torch.exp`` of a
    process has returned values 1.5e-4 off (relative); later calls are
    exact to an ulp.  One throwaway call before the tests."""
    torch.exp(torch.linspace(-8.0, 8.0, 1 << 16))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 1024, size=(B, S))
    labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100)], axis=1)
    init = jax.jit(JaxGPTLM(JaxConfig.tiny(compute_dtype=jnp.float32)).init)
    params = [jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(seed), jnp.asarray(ids[:1, :16]))["params"])
        for seed in (0, 1)]
    return torch.from_numpy(ids), torch.from_numpy(labels), params


def _setup(params, seed=11, scale_window=2000):
    """GPT tiny O2 + fused_adam; the carry is (masters, state, generator)
    and the step reads the generator from the carry."""
    amp_ = amp.initialize("O2")
    amp_ = dataclasses.replace(amp_, scalers=tuple(
        dataclasses.replace(s, scale_window=scale_window)
        for s in amp_.scalers))
    opt = amp.AmpOptimizer(fused_adam(LR, weight_decay=WD), amp_)
    model = GPTLM(GPTConfig.tiny(compute_dtype=torch.bfloat16))
    model.load_state_dict(from_jax_params(params))
    masters = opt.attach(model)
    carry = (masters, opt.init(masters), torch.Generator().manual_seed(seed))
    return opt, model, carry


def _step_fn(opt, model, ids, labels, deterministic=False):
    names, ps = zip(*model.named_parameters())

    def step(carry, _batch):
        masters, state, gen = carry
        _, loss = model(ids, labels, deterministic=deterministic,
                        generator=gen)
        grads = torch.autograd.grad(
            opt.amp.scale_loss(loss, state.scaler[0]), ps)
        masters, state, stats = opt.step(dict(zip(names, grads)), state,
                                         masters, model=model)
        return (masters, state, gen), {"loss": loss.detach(),
                                       "scale": stats.loss_scale}
    return step


def _driver(step, k):
    return FusedTrainDriver(step, steps_per_dispatch=k,
                            metrics={"loss": "last", "scale": "last"},
                            per_step=("loss",))


def _equal_trees(a, b) -> bool:
    fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            return False
    return True


# --- the checkpoint module, case for case --------------------------------

def test_bitwise_resume(tmp_path, data):
    """Six steps unbroken against three, save, restore into a state
    built from other weights, three more."""
    ids, labels, params = data
    opt, model, carry = _setup(params[0])
    step = _step_fn(opt, model, ids, labels, deterministic=True)
    ref_losses = []
    for _ in range(6):
        carry, m = step(carry, None)
        ref_losses.append(float(m["loss"]))
    ref = carry

    opt, model, carry = _setup(params[0])
    step = _step_fn(opt, model, ids, labels, deterministic=True)
    for _ in range(3):
        carry, _ = step(carry, None)
    save_checkpoint(str(tmp_path / "ckpt"), {"masters": carry[0],
                                             "opt": carry[1]}, step=3)
    assert latest_step(str(tmp_path / "ckpt")) == 3

    opt2, model2, fresh = _setup(params[1])
    restored, rstep = restore_checkpoint(
        str(tmp_path / "ckpt"), {"masters": fresh[0], "opt": fresh[1]})
    assert rstep == 3
    opt2.copy_to_model(model2, restored["masters"])
    carry = (restored["masters"], restored["opt"], fresh[2])
    step2 = _step_fn(opt2, model2, ids, labels, deterministic=True)
    losses = []
    for _ in range(3):
        carry, m = step2(carry, None)
        losses.append(float(m["loss"]))
    assert losses == ref_losses[3:]
    assert _equal_trees(carry[:2], ref[:2])


def test_scaler_state_round_trips(tmp_path, data):
    opt, _, carry = _setup(data[2][0])
    state = carry[1]._replace(scaler=(amp.LossScalerState(
        torch.tensor(2.0 ** 13), torch.tensor(7, dtype=torch.int32),
        torch.tensor(3, dtype=torch.int32)),))
    save_checkpoint(str(tmp_path / "c2"), {"opt": state}, step=2)
    restored, _ = restore_checkpoint(str(tmp_path / "c2"),
                                     {"opt": opt.init(carry[0])})
    got = restored["opt"].scaler[0]
    assert opt.amp.scalers[0].state_dict(got) == {
        "loss_scale": 2.0 ** 13, "unskipped": 7, "overflows": 3}
    assert got.unskipped.dtype == torch.int32


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope_but_mkdir"), {})


def _two_steps(path):
    s1 = {"w": torch.arange(8.0), "b": torch.ones(3, dtype=torch.bfloat16)}
    s2 = {"w": torch.arange(8.0) * 2,
          "b": torch.ones(3, dtype=torch.bfloat16) * 5}
    save_checkpoint(path, s1, 1, keep=1)  # keep clamps to 2
    save_checkpoint(path, s2, 2, keep=1)
    return s1, s2


def _corrupt_digest(path, step):
    side = os.path.join(path, str(step), CHECKSUM_FILE)
    doc = json.load(open(side))
    doc["digest"] = "0" * 64
    json.dump(doc, open(side, "w"))


def test_save_writes_sidecar_and_keeps_previous(tmp_path):
    p = str(tmp_path / "c")
    _two_steps(p)
    assert latest_step(p) == 2
    for step in (1, 2):
        doc = json.load(open(os.path.join(p, str(step), CHECKSUM_FILE)))
        assert doc["step"] == step and len(doc["digest"]) == 64
        assert doc["schema"] == "apex_tpu_torch.checkpoint.checksum.v1"
    save_checkpoint(p, {"w": torch.zeros(8), "b": torch.zeros(
        3, dtype=torch.bfloat16)}, 3, keep=1)
    assert sorted(os.listdir(p)) == ["2", "3"]  # pruned after the commit
    with pytest.raises(FileExistsError):
        save_checkpoint(p, {"w": torch.zeros(8)}, 3, overwrite=False)


def test_state_digest_is_content_sensitive():
    a = {"w": torch.arange(4.0)}
    assert state_digest(a) == state_digest({"w": torch.arange(4.0)})
    assert state_digest(a) != state_digest({"w": torch.arange(4.0) + 1})
    assert state_digest(a) != state_digest({"x": torch.arange(4.0)})
    assert state_digest(a) != state_digest(
        {"w": torch.arange(4.0).reshape(2, 2)})
    assert state_digest(a) != state_digest({"w": torch.arange(4.0).double()})
    h = {"w": torch.arange(4.0).bfloat16()}
    assert state_digest(h) == state_digest({"w": torch.arange(4.0).bfloat16()})
    assert state_digest(h) != state_digest(
        {"w": (torch.arange(4.0) + 0.01).bfloat16()})
    assert state_digest(h) != state_digest({"w": torch.arange(4.0).half()})
    g = {"g": torch.Generator().manual_seed(1)}
    assert state_digest(g) == state_digest(
        {"g": torch.Generator().manual_seed(1)})
    assert state_digest(g) != state_digest(
        {"g": torch.Generator().manual_seed(2)})
    with pytest.raises(TypeError, match="only tensors"):
        state_digest({"w": 1.0})


def test_corrupted_latest_falls_back_to_previous_last_good(tmp_path):
    p = str(tmp_path / "c")
    s1, _ = _two_steps(p)
    _corrupt_digest(p, 2)
    restored, step = restore_checkpoint(p, s1)
    assert step == 1
    assert torch.equal(restored["w"], torch.arange(8.0))
    # corrupted bytes in the state file itself, too
    _two_steps(p)
    f = os.path.join(p, "2", checkpoint.STATE_FILE)
    raw = bytearray(open(f, "rb").read())
    for i in range(len(raw) // 2, len(raw) // 2 + 64):
        raw[i] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    restored, step = restore_checkpoint(p, s1)
    assert step == 1 and torch.equal(restored["w"], torch.arange(8.0))


def test_explicit_corrupted_step_raises(tmp_path):
    p = str(tmp_path / "c")
    s1, _ = _two_steps(p)
    _corrupt_digest(p, 2)
    with pytest.raises(CheckpointIntegrityError, match="checksum"):
        restore_checkpoint(p, s1, step=2)
    # verify=False is the escape hatch (the raw bytes)
    restored, step = restore_checkpoint(p, s1, step=None, verify=False)
    assert step == 2 and torch.equal(restored["w"], torch.arange(8.0) * 2)
    open(os.path.join(p, "2", checkpoint.STATE_FILE), "wb").write(b"torn")
    with pytest.raises(CheckpointIntegrityError, match="cannot be read"):
        restore_checkpoint(p, s1, step=2)


def test_sidecar_less_step_restores_only_when_nothing_verifies(tmp_path):
    p = str(tmp_path / "c")
    s1, _ = _two_steps(p)
    # the newest step has no sidecar: the verified step before it wins
    os.remove(os.path.join(p, "2", CHECKSUM_FILE))
    assert restore_checkpoint(p, s1)[1] == 1
    # no sidecars anywhere: the newest step
    os.remove(os.path.join(p, "1", CHECKSUM_FILE))
    assert restore_checkpoint(p, s1)[1] == 2


def test_verified_latest_step_requires_the_sidecar(tmp_path):
    p = str(tmp_path / "c")
    _two_steps(p)
    assert verified_latest_step(p) == 2
    os.remove(os.path.join(p, "2", CHECKSUM_FILE))
    assert latest_step(p) == 2
    assert verified_latest_step(p) == 1
    with open(os.path.join(p, "1", CHECKSUM_FILE), "w") as f:
        f.write('{"step": 1, "dig')
    assert verified_latest_step(p) is None
    assert verified_latest_step(str(tmp_path / "nope")) is None


def test_restore_or_init(tmp_path):
    target = {"w": torch.zeros(8), "b": torch.zeros(3, dtype=torch.bfloat16)}
    assert restore_or_init(None, target) == (target, 0)
    assert restore_or_init(str(tmp_path / "none"), target) == (target, 0)
    p = str(tmp_path / "c")
    _, s2 = _two_steps(p)
    state, step = restore_or_init(p, target)
    assert step == 2 and all(torch.equal(state[k], s2[k]) for k in s2)
    with pytest.raises(ValueError, match="template"):
        restore_checkpoint(p, {"w": torch.zeros(4), "b": target["b"]})


def test_a_save_that_raises_midway_leaves_no_step(tmp_path, monkeypatch):
    p = str(tmp_path / "c")
    s1, _ = _two_steps(p)
    real = torch.save

    def torn(obj, f):
        real({"w": obj["['w']"]}, f)  # part of the state, then a crash
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(p, {"w": torch.ones(8), "b": s1["b"]}, 3)
    monkeypatch.undo()
    assert sorted(os.listdir(p)) == ["1", "2"]
    # a temporary directory a killed process left is never a step
    os.makedirs(os.path.join(p, ".tmp-4-123"))
    assert latest_step(p) == 2 and verified_latest_step(p) == 2
    restored, step = restore_checkpoint(p, s1)
    assert step == 2 and torch.equal(restored["w"], torch.arange(8.0) * 2)
    assert restore_checkpoint(p, s1, step=1)[0]["w"].equal(torch.arange(8.0))


# --- FusedTrainDriver.save / restore ---------------------------------------

def test_driver_resumes_bit_for_bit_with_dropout(tmp_path, data):
    """Two windows of K = 2 unbroken against one window, ``save``,
    ``restore`` into a carry from another seed (weights and generator),
    ``copy_to_model``, the second window: the losses, scale state,
    masters, Adam moments and the generator's state equal."""
    ids, labels, params = data
    k = 2
    opt, model, carry = _setup(params[0])
    driver = _driver(_step_fn(opt, model, ids, labels), k)
    carry, w1 = driver.run_window(carry)
    carry, w2 = driver.run_window(carry)
    ref, ref_losses = carry, (read_metrics(w1).per_step["loss"]
                              + read_metrics(w2).per_step["loss"])

    opt, model, carry = _setup(params[0])
    driver = _driver(_step_fn(opt, model, ids, labels), k)
    carry, w1 = driver.run_window(carry)
    driver.save(str(tmp_path / "run"), carry, k)
    opt2, model2, fresh = _setup(params[1], seed=99)
    carry, step = driver.restore(str(tmp_path / "run"), fresh)
    assert step == k and carry[2] is fresh[2]  # the template's generator
    opt2.copy_to_model(model2, carry[0])
    driver2 = _driver(_step_fn(opt2, model2, ids, labels), k)
    carry, w2 = driver2.run_window(carry)
    losses = read_metrics(w1).per_step["loss"] + read_metrics(
        w2).per_step["loss"]
    assert losses == ref_losses
    assert _equal_trees(carry, ref)
    # without copy_to_model the stale half copy gives other numbers
    opt3, model3, fresh = _setup(params[1], seed=99)
    carry, _ = driver.restore(str(tmp_path / "run"), fresh, step=k)
    carry, w3 = _driver(_step_fn(opt3, model3, ids, labels), k).run_window(
        carry)
    assert read_metrics(w3).per_step["loss"] != ref_losses[k:]


def test_resumed_trajectory_matches_jax_unbroken(tmp_path, data):
    """Deterministic GPT tiny O2 with a scale window of 2 (the scale grows
    across the restore): three steps, save, restore, four steps, against
    JAX's unbroken seven-step window from the same weights."""
    ids, labels, params = data
    jamp_ = jamp.initialize("O2")
    jamp_ = dataclasses.replace(jamp_, scalers=tuple(
        dataclasses.replace(s, scale_window=2) for s in jamp_.scalers))
    jopt = jamp.AmpOptimizer(jax_fused_adam(LR, weight_decay=WD), jamp_)
    jmodel = JaxGPTLM(JaxConfig.tiny(compute_dtype=jnp.bfloat16))
    jids, jlabels = jnp.asarray(ids.numpy()), jnp.asarray(labels.numpy())

    def jstep(carry, _batch):
        mp, st = carry

        def scaled(mp):
            loss = jmodel.apply({"params": jopt.model_params(mp)}, jids,
                                labels=jlabels, deterministic=True)[1]
            return jamp_.scale_loss(loss, st.scaler[0]), loss
        grads, loss = jax.grad(scaled, has_aux=True)(mp)
        mp, st, stats = jopt.step(grads, st, mp)
        return (mp, st), {"loss": loss, "scale": stats.loss_scale}

    jparams = jax.tree_util.tree_map(jnp.asarray, params[0])
    jcarry = (jparams, jopt.init(jparams))
    jdriver = JaxDriver(jstep, steps_per_dispatch=7,
                        metrics={"loss": "last", "scale": "last"},
                        per_step=("loss",))
    jcarry, jres = jdriver.run_window(jcarry)
    jlosses = list(np.asarray(jax_read_metrics(jres).per_step["loss"]))

    opt, model, carry = _setup(params[0], scale_window=2)
    step = _step_fn(opt, model, ids, labels, deterministic=True)
    carry, r1 = _driver(step, 3).run_window(carry)
    _driver(step, 3).save(str(tmp_path / "run"), carry, 3)
    opt2, model2, fresh = _setup(params[1], scale_window=2)
    carry, _ = _driver(step, 3).restore(str(tmp_path / "run"), fresh)
    opt2.copy_to_model(model2, carry[0])
    carry, r2 = _driver(_step_fn(opt2, model2, ids, labels,
                                 deterministic=True), 4).run_window(carry)
    losses = read_metrics(r1).per_step["loss"] + read_metrics(
        r2).per_step["loss"]
    rel = np.abs(np.asarray(losses) - np.asarray(jlosses)) / np.abs(
        np.asarray(jlosses))
    assert rel.max() <= 1e-3, (losses, jlosses)
    st, sj = carry[1].scaler[0], jcarry[1].scaler[0]
    assert float(st.loss_scale) == float(sj.loss_scale) == 2.0 ** 19
    assert int(st.unskipped) == int(sj.unskipped)
    assert int(st.overflows) == int(sj.overflows) == 0
    assert int(carry[1].opt_state.step) == int(jcarry[1].opt_state.step) == 7
