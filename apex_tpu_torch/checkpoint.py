"""Checkpoint and resume: train state saved with ``torch.save``.

Counterpart of ``apex_tpu/checkpoint.py``, with its contract and without
orbax.  A state is any tree of nested dicts, lists, tuples and
NamedTuples whose leaves are tensors, ``torch.Generator`` objects (saved
through ``get_state()``) or None.  A step is the directory
``path/<step>`` holding ``state.pt`` (a flat mapping of leaf path ->
tensor) and the checksum sidecar; restoring rebuilds the structure from
the caller's template, as orbax restores into a template, so
``torch.load`` runs with ``weights_only=True``.

Crash safety, as in the JAX package:

- :func:`save_checkpoint` writes the step into a temporary directory
  beside ``path/<step>``, fsyncs it and commits it with ``os.replace``:
  a process killed mid-save never publishes a half-written step, and a
  leftover temporary directory is never listed as a step;
- it then commits the SHA-256 sidecar (``apex_tpu.checksum.json``: path,
  dtype, shape and bytes of every leaf) with the same tmp-then-replace
  discipline;
- ``keep`` is clamped to at least 2, and old steps are pruned only after
  the new step commits, so the previous good step survives every save;
- :func:`restore_checkpoint` verifies the digest; ``step=None`` walks
  from the newest step down past corrupted ones, and uses a step without
  a sidecar only when no step verifies.

Resuming an O2 run: the model's half copy of the masters is not saved;
call :meth:`apex_tpu_torch.amp.AmpOptimizer.copy_to_model` after the
restore and before the first step.

Sharded state: ``process_local=True`` keeps this rank's state in a
directory of its own, ``path/process_<rank>/<step>``
(:func:`process_dir`), since no rank holds a sharded carry whole (JAX's
``process_local`` scopes orbax to one process instead; the driver and
:mod:`apex_tpu_torch.train.accum`'s train-state checkpoints both use this
layout).  ``sharding_outcome`` commits the rules engine's record of how
the state was sharded (:func:`apex_tpu_torch.sharding.rules_outcome`) as
the step's :data:`SHARDING_FILE` sidecar, read back by
:func:`read_sharding_outcome`.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = [
    "CHECKSUM_FILE", "CheckpointIntegrityError", "SHARDING_FILE",
    "latest_step", "process_dir", "read_sharding_outcome",
    "restore_checkpoint", "restore_or_init", "save_checkpoint",
    "state_digest", "verified_latest_step",
]

CHECKSUM_FILE = "apex_tpu.checksum.json"
SHARDING_FILE = "apex_tpu.sharding.json"
STATE_FILE = "state.pt"
_CHECKSUM_SCHEMA = "apex_tpu_torch.checkpoint.checksum.v1"
_TMP = ".tmp-"


class CheckpointIntegrityError(RuntimeError):
    """A step's bytes do not match its recorded digest, or cannot be read
    at all (torn write, bit rot, or a template of another structure)."""


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(str(path)))


def process_dir(path: str, rank: Optional[int] = None) -> str:
    """``path/process_<rank>``: a rank's own checkpoint directory (rank
    None: this process's rank in the default process group)."""
    if rank is None:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
    return os.path.join(_abspath(path), f"process_{int(rank)}")


def _root(path: str, process_local: bool) -> str:
    return process_dir(path) if process_local else _abspath(path)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in a fixed order: dict keys sorted,
    sequences by index, NamedTuple fields by name; None leaves dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name, v in zip(tree._fields, tree)
                for pair in _flatten(v, f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{prefix}[{i}]")]
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        return [(prefix, tree)]
    raise TypeError(f"checkpoint leaf {prefix or '<root>'} is a "
                    f"{type(tree).__name__}: only tensors, torch.Generator "
                    "objects and None are saved")


def _stored(leaf) -> torch.Tensor:
    """The tensor a leaf is stored as, on the CPU (a view is copied out
    of its storage: ``torch.save`` would write the whole storage)."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state()
    t = leaf.detach().cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone()
    return t


def _digest(entries) -> str:
    """SHA-256 over ``(path, is_generator, stored tensor)`` entries: each
    leaf's path, kind or dtype and shape, and raw bytes (bf16 included)."""
    h = hashlib.sha256()
    for path, is_gen, t in entries:
        h.update(path.encode())
        if is_gen:
            h.update(b"torch.Generator")
        else:
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def state_digest(state: Any) -> str:
    """SHA-256 over the state's leaves: path, dtype, shape and bytes of
    every tensor (a generator by its ``get_state()``), so corrupted
    bytes, a renamed or reordered leaf and a reshaped one all change
    it."""
    return _digest((p, isinstance(x, torch.Generator), _stored(x))
                   for p, x in _flatten(state))


def _steps(path: str) -> List[int]:
    """Committed steps under ``path``, newest first (temporary
    directories are not steps)."""
    if not os.path.isdir(path):
        return []
    return sorted((int(n) for n in os.listdir(path)
                   if n.isdigit() and os.path.isdir(os.path.join(path, n))),
                  reverse=True)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json(target: str, doc: dict) -> None:
    """Atomic JSON commit: tmp file, fsync, ``os.replace``."""
    tmp = f"{target}{_TMP}{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, target)


def _read_checksum(path: str, step: int) -> Optional[dict]:
    try:
        with open(os.path.join(path, str(step), CHECKSUM_FILE)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        # a missing or torn sidecar: the step is unverifiable, not fatal
        return None


def save_checkpoint(path: str, state: Any, step: int, *, keep: int = 3,
                    overwrite: bool = True, checksum: bool = True,
                    process_local: bool = False,
                    sharding_outcome: Optional[dict] = None) -> str:
    """Write ``state`` under ``path/<step>`` and return that directory.

    The newest ``keep`` steps are kept (at least 2), pruned only after
    this one commits.  ``overwrite=False`` refuses to replace an existing
    step.  With ``checksum``, the digest sidecar is committed into the
    step.  ``process_local`` writes under this rank's own directory
    (:func:`process_dir`); ``sharding_outcome`` is committed as the
    step's :data:`SHARDING_FILE` sidecar."""
    path = _root(path, process_local)
    keep = max(2, int(keep))
    step = int(step)
    final = os.path.join(path, str(step))
    if os.path.exists(final) and not overwrite:
        raise FileExistsError(f"checkpoint step {final} exists "
                              "(overwrite=False)")
    pairs = _flatten(state)
    flat = {p: _stored(x) for p, x in pairs}
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{_TMP}{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        old = None
        if os.path.exists(final):
            old = f"{final}{_TMP}old-{os.getpid()}"
            os.replace(final, old)
        os.replace(tmp, final)
        _fsync_dir(path)
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if checksum:
        _write_json(os.path.join(final, CHECKSUM_FILE), {
            "schema": _CHECKSUM_SCHEMA, "step": step, "leaves": len(pairs),
            "digest": _digest((p, isinstance(x, torch.Generator), flat[p])
                              for p, x in pairs)})
    if sharding_outcome is not None:
        _write_json(os.path.join(final, SHARDING_FILE), sharding_outcome)
    for old_step in _steps(path)[keep:]:
        shutil.rmtree(os.path.join(path, str(old_step)), ignore_errors=True)
    return final


def latest_step(path: str, process_local: bool = False) -> Optional[int]:
    """The newest committed step under ``path`` (this rank's directory
    with ``process_local``), or None."""
    steps = _steps(_root(path, process_local))
    return steps[0] if steps else None


def read_sharding_outcome(path: str, step: Optional[int] = None,
                          process_local: bool = False,
                          rank: Optional[int] = None) -> Optional[dict]:
    """The sharding outcome a step was saved with, or None (no sidecar,
    or a torn one: the restore then takes the conservative path).
    ``step`` None reads the newest step's; ``process_local`` reads from
    this rank's directory, or ``rank``'s."""
    root = (process_dir(path, rank) if process_local or rank is not None
            else _abspath(path))
    if step is None:
        steps = _steps(root)
        if not steps:
            return None
        step = steps[0]
    try:
        with open(os.path.join(root, str(step), SHARDING_FILE)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verified_latest_step(path: str) -> Optional[int]:
    """The newest step whose checksum sidecar is present and complete,
    or None: a step still without its sidecar (mid-commit, or a crash
    between the commit and the sidecar) is not reported.  The digest
    itself is checked only by :func:`restore_checkpoint`."""
    path = _abspath(path)
    for s in _steps(path):
        doc = _read_checksum(path, s)
        if doc is not None and doc.get("digest"):
            return s
    return None


def _load(path: str, step: int) -> Dict[str, torch.Tensor]:
    """The step's flat state; :class:`CheckpointIntegrityError` when the
    committed step's file is missing, torn or not a state (the unpickler
    of a corrupted file can raise almost anything)."""
    step_dir = os.path.join(path, str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no checkpoint step {step_dir}")
    try:
        with open(os.path.join(step_dir, STATE_FILE), "rb") as f:
            flat = torch.load(f, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 - any failure is a corrupt step
        raise CheckpointIntegrityError(
            f"checkpoint {step_dir} cannot be read ({type(e).__name__}: "
            f"{e}); restore with step=None to fall back to the previous "
            "good step") from e
    if not isinstance(flat, dict) or not all(
            isinstance(v, torch.Tensor) for v in flat.values()):
        raise CheckpointIntegrityError(f"{step_dir}: not a checkpoint state")
    return flat


def _verify(path: str, step: int, pairs, flat) -> Optional[bool]:
    """True: the digest matches; False: it does not, or the stored leaves
    are not the template's; None: no sidecar."""
    doc = _read_checksum(path, step)
    if doc is None:
        return None
    if set(flat) != {p for p, _ in pairs}:
        return False
    return doc.get("digest") == _digest(
        (p, isinstance(x, torch.Generator), flat[p]) for p, x in pairs)


def _rebuild(tree: Any, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """The template's structure with its leaves taken from ``flat``:
    tensors on the template leaf's device (dtype and shape must match),
    generators set to the stored state.  A ``None`` of the template
    with stored leaves beneath it raises: restoring a ``sparsify`` state
    into a fresh ``tx.init`` (its masks all ``None``) must not quietly
    turn sparsity off."""
    if tree is None:
        stored = [p for p in flat if p == prefix
                  or p.startswith((prefix + "[", prefix + "."))]
        if stored:
            raise ValueError(
                f"checkpoint holds {len(stored)} leaves under {prefix} "
                f"(first {stored[0]}) where the template has None; build "
                "the template with them (for sparsity masks: "
                "ASP.enable(tx.init(params), masks))")
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, flat, f"{prefix}.{n}")
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if prefix not in flat:
        raise ValueError(f"checkpoint has no leaf {prefix}")
    t = flat[prefix]
    if isinstance(tree, torch.Generator):
        tree.set_state(t)
        return tree
    if t.dtype != tree.dtype or t.shape != tree.shape:
        raise ValueError(
            f"checkpoint leaf {prefix} is {t.dtype} {tuple(t.shape)}, the "
            f"template's {tree.dtype} {tuple(tree.shape)}")
    return t.to(tree.device)


def restore_checkpoint(path: str, target: Any, step: Optional[int] = None,
                       *, verify: bool = True,
                       process_local: bool = False) -> Tuple[Any, int]:
    """Restore into the structure of ``target`` (a like-built state, the
    reference's "amp.initialize first, then load_state_dict"); returns
    ``(state, step)``.

    Tensors land on the template's devices with its dtypes and shapes
    (a mismatch raises); the template's generators get ``set_state``.
    With ``verify``, an explicit ``step`` that fails its checksum (or
    cannot be read) raises :class:`CheckpointIntegrityError`;
    ``step=None`` walks newest first past corrupted steps, and uses a
    step without a sidecar only when no step verifies.  ``process_local``
    reads this rank's own directory."""
    path = _root(path, process_local)
    pairs = _flatten(target)
    if step is not None:
        flat = _load(path, step)
        if verify and _verify(path, step, pairs, flat) is False:
            raise CheckpointIntegrityError(
                f"checkpoint {path}/{step} failed its checksum: torn write "
                "or corruption; restore with step=None to fall back to the "
                "previous good step")
        return _rebuild(target, flat), step
    steps = _steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    if not verify:
        return _rebuild(target, _load(path, steps[0])), steps[0]
    fallback, corrupted = None, []
    for s in steps:
        try:
            flat = _load(path, s)
        except CheckpointIntegrityError:
            corrupted.append(s)
            continue
        ok = _verify(path, s, pairs, flat)
        if ok:
            return _rebuild(target, flat), s
        if ok is None and fallback is None:
            fallback = (flat, s)
        elif ok is False:
            corrupted.append(s)
    if fallback is not None:
        return _rebuild(target, fallback[0]), fallback[1]
    raise CheckpointIntegrityError(
        f"every checkpoint under {path} failed verification (corrupted "
        f"steps: {corrupted})")


def restore_or_init(path: Optional[str], target: Any) -> Tuple[Any, int]:
    """Resume from ``path`` when it holds a checkpoint, else start fresh:
    ``(restored state, its step)`` or ``(target, 0)``."""
    if not path or latest_step(path) is None:
        return target, 0
    return restore_checkpoint(path, target)
