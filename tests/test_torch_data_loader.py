"""apex_tpu_torch.data vs apex_tpu.data, on the CPU, on the same files.

- ``write_records``: the same bytes as JAX's from numpy arrays and from
  CPU tensors; a wrong shape raises ``ValueError`` in both;
- ``NativeDataLoader`` over 23 records of three fields (a size that is
  not a batch multiple) at batch 4: every batch of epochs 0 and 1 the
  same bytes as JAX's, with shuffle on and off, 1 and 3 workers, two
  seeds; then JAX's own semantics: drop-last (5 batches, 3 records
  left out), every record at most once, the same order for the same
  (seed, epoch) under any worker count and another for the next epoch,
  ``FileNotFoundError`` on a missing file;
- ``window_batches``: dict and tuple trees stacked as JAX stacks them,
  the short tail kept or dropped, ``ValueError`` for k < 1;
- ``DevicePrefetcher(device="cpu")``: the order, ``depth`` batches
  staged ahead of the consumer, the transform applied on the host batch,
  the same ``train/prefetch`` spans with the same ``depth`` attrs as
  JAX's prefetcher records, ``ValueError`` for depth < 1, and no CUDA
  device: ``device=None`` raises;
- the loader library: built with g++ under ``build/apex_tpu_torch/``
  (keyed on the source and the flags, not the CUDA headers), the build
  heard by a build listener, and a source that does not compile raising
  with g++'s output.
"""
import numpy as np
import pytest
import torch

import apex_tpu.obs as jobs
from apex_tpu.data import DevicePrefetcher as JaxPrefetcher
from apex_tpu.data import NativeDataLoader as JaxLoader
from apex_tpu.data import window_batches as jax_window_batches
from apex_tpu.data import write_records as jax_write_records
from apex_tpu_torch import obs
from apex_tpu_torch.data import (
    DevicePrefetcher,
    NativeDataLoader,
    window_batches,
    write_records,
)
from apex_tpu_torch.ops import _build

FIELDS = {"image": (np.uint8, (5, 4, 3)), "label": (np.int32, ()),
          "weight": (np.float32, (2,))}
N, BATCH = 23, 4


def _samples(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randint(0, 256, (5, 4, 3)).astype(np.uint8),
             "label": np.int32(i),
             "weight": rng.randn(2).astype(np.float32)} for i in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    port, jax_ = str(d / "port.bin"), str(d / "jax.bin")
    assert write_records(port, _samples(), FIELDS) == N
    assert jax_write_records(jax_, _samples(), FIELDS) == N
    return port, jax_


def test_write_records_is_byte_identical(files, tmp_path):
    port, jax_ = files
    with open(port, "rb") as a, open(jax_, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert len(data) == N * (60 + 4 + 8)
    # CPU tensors write the same bytes as numpy arrays
    as_tensors = [{k: torch.as_tensor(v) for k, v in s.items()}
                  for s in _samples()]
    path = str(tmp_path / "tensors.bin")
    write_records(path, as_tensors, FIELDS)
    with open(path, "rb") as f:
        assert f.read() == data


def test_write_records_rejects_a_wrong_shape(tmp_path):
    bad = [dict(_samples(1)[0], image=np.zeros((4, 5, 3), np.uint8))]
    for write in (write_records, jax_write_records):
        with pytest.raises(ValueError, match="image"):
            write(str(tmp_path / "bad.bin"), bad, FIELDS)


def _batches(loader, epoch):
    return [{k: np.asarray(v).copy() for k, v in b.items()}
            for b in loader.epoch(epoch)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("workers", [1, 3])
def test_every_batch_matches_jax(files, shuffle, workers):
    port, jax_ = files
    for seed in (0, 7):
        ours = NativeDataLoader(port, FIELDS, BATCH, shuffle=shuffle,
                                seed=seed, num_workers=workers)
        theirs = JaxLoader(jax_, FIELDS, BATCH, shuffle=shuffle, seed=seed,
                           num_workers=workers)
        try:
            assert len(ours) == len(theirs) == N
            assert ours.batches_per_epoch == theirs.batches_per_epoch == 5
            for epoch in (0, 1):
                got, want = _batches(ours, epoch), _batches(theirs, epoch)
                assert len(got) == len(want) == 5
                for g, w in zip(got, want):
                    assert set(g) == set(w) == set(FIELDS)
                    for k in FIELDS:
                        assert g[k].dtype == w[k].dtype
                        assert g[k].shape == w[k].shape
                        assert g[k].tobytes() == w[k].tobytes(), (epoch, k)
        finally:
            ours.close()
            theirs.close()


def test_batches_are_cpu_tensors_that_own_their_memory(files):
    loader = NativeDataLoader(files[0], FIELDS, BATCH, shuffle=True)
    batches = list(loader.epoch(0))
    loader.close()
    b = batches[0]
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in b.values())
    assert b["image"].dtype == torch.uint8
    assert tuple(b["image"].shape) == (BATCH, 5, 4, 3)
    assert b["label"].dtype == torch.int32 and b["label"].shape == (BATCH,)
    assert b["weight"].dtype == torch.float32
    # the ring buffers were recycled while the copies stay distinct
    labels = torch.cat([x["label"] for x in batches])
    assert len(set(labels.tolist())) == 5 * BATCH


def _order(path, seed, epoch, workers=2, shuffle=True):
    loader = NativeDataLoader(path, FIELDS, BATCH, shuffle=shuffle,
                              seed=seed, num_workers=workers)
    try:
        return [int(i) for b in loader.epoch(epoch) for i in b["label"]]
    finally:
        loader.close()


def test_loader_semantics_follow_jax(files):
    port = files[0]
    plain = _order(port, 0, 0, shuffle=False)
    assert plain == list(range(5 * BATCH))  # drop-last, in file order
    order = _order(port, 3, 0)
    assert len(order) == len(set(order)) == 5 * BATCH  # each at most once
    assert set(order) <= set(range(N)) and order != plain
    for workers in (1, 4):  # any worker count: the same order
        assert _order(port, 3, 0, workers=workers) == order
    assert _order(port, 3, 1) != order  # the next epoch reshuffles
    assert _order(port, 4, 0) != order  # and so does another seed
    with pytest.raises(FileNotFoundError):
        NativeDataLoader(port + ".missing", FIELDS, BATCH)
    with pytest.raises(FileNotFoundError):
        JaxLoader(port + ".missing", FIELDS, BATCH)


@pytest.mark.parametrize("drop_last", [True, False])
def test_window_batches_stack_as_jax_does(files, drop_last):
    port, jax_ = files
    ours = NativeDataLoader(port, FIELDS, BATCH, shuffle=True, seed=1)
    theirs = JaxLoader(jax_, FIELDS, BATCH, shuffle=True, seed=1)
    try:
        got = list(window_batches(ours.epoch(0), 2, drop_last=drop_last))
        want = list(jax_window_batches(theirs.epoch(0), 2,
                                       drop_last=drop_last))
    finally:
        ours.close()
        theirs.close()
    assert len(got) == len(want) == (2 if drop_last else 3)
    assert [int(w["label"].shape[0]) for w in got] == [
        2, 2] + ([] if drop_last else [1])
    for g, w in zip(got, want):
        for k in FIELDS:
            assert isinstance(g[k], torch.Tensor) and g[k].is_contiguous()
            assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes()
    # tuple trees, numpy leaves
    pairs = [(np.full((2, 3), i, np.float32), np.int32(i)) for i in range(5)]
    wins = list(window_batches(iter(pairs), 2, drop_last=False))
    assert [tuple(w[0].shape) for w in wins] == [(2, 2, 3), (2, 2, 3),
                                                 (1, 2, 3)]
    assert isinstance(wins[0], tuple) and wins[2][1].tolist() == [4]
    for k in (0, -1):
        with pytest.raises(ValueError):
            list(window_batches(iter(pairs), k))
        with pytest.raises(ValueError):
            list(jax_window_batches(iter(pairs), k))


class _Source:
    """A batch source that counts how many batches were pulled."""

    def __init__(self, n):
        self.n, self.pulled = n, 0

    def __iter__(self):
        for i in range(self.n):
            self.pulled += 1
            yield {"x": np.full((2,), i, np.float32),
                   "y": np.int32(i)}


def _prefetch_spans(tracer, n0):
    return [(sp.name, dict(sp.attrs or {})) for sp in tracer.spans[n0:]
            if sp.name == "train/prefetch"]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_stages_depth_ahead_like_jax(depth):
    n = 5
    src = _Source(n)
    transform = lambda b: {"x": b["x"] * 2, "y": b["y"]}  # noqa: E731
    tracer = obs.default_tracer()
    n0 = len(tracer.spans)
    got = []
    for i, b in enumerate(DevicePrefetcher(src, transform=transform,
                                           device="cpu", depth=depth)):
        # batch i is handed over once batch i + depth is staged
        assert src.pulled == min(i + depth + 1, n)
        assert b["x"].device.type == "cpu"
        got.append((b["x"].tolist(), int(b["y"])))
    assert got == [([2.0 * i] * 2, i) for i in range(n)]
    ours = _prefetch_spans(tracer, n0)
    jtracer = jobs.default_tracer()
    j0 = len(jtracer.spans)
    jgot = [(np.asarray(b["x"]).tolist(), int(b["y"])) for b in
            JaxPrefetcher(_Source(n), transform=transform, depth=depth)]
    assert jgot == got
    assert ours == _prefetch_spans(jtracer, j0)
    assert [a["depth"] for _, a in ours] == [min(i, depth)
                                             for i in range(n)]


def test_prefetcher_rejects_and_needs_a_device(monkeypatch):
    for depth in (0, -1):
        with pytest.raises(ValueError):
            DevicePrefetcher([], device="cpu", depth=depth)
        with pytest.raises(ValueError):
            JaxPrefetcher([], depth=depth)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrefetcher([])


def test_loader_library_builds_with_gxx_into_the_build_dir(tmp_path,
                                                           monkeypatch):
    path = _build.library_path("loader")
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "apex_tpu_torch")
    assert path.name.startswith("loader-") and path.suffix == ".so"
    assert (_build.CSRC_DIR / "loader.cpp").read_bytes() == (
        _build.CSRC_DIR.parent.parent / "apex_tpu" / "data" / "_native"
        / "loader.cpp").read_bytes()
    # a fresh build directory: the build runs and a listener hears it
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    heard = []
    listener = lambda kind, name: heard.append((kind, name))  # noqa: E731
    _build.add_build_listener(listener)
    try:
        took = _build.build(["loader"])
    finally:
        _build.remove_build_listener(listener)
    assert heard == [("build", "loader")] and took["loader"] > 0
    assert _build.library_path("loader").exists()
    assert _build.library_path("loader").name == path.name
    assert _build.build(["loader"]) == {"loader": 0.0}  # reused
    # the host library's key leaves out the CUDA headers
    (tmp_path / "csrc").mkdir()
    for f in _build.CSRC_DIR.iterdir():
        if f.suffix in (".cpp", ".cu", ".cuh"):
            (tmp_path / "csrc" / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    cuda_before = _build.library_path("layer_norm").name
    (tmp_path / "csrc" / "extra.cuh").write_text("// a new header\n")
    assert _build.library_path("loader").name == path.name
    assert _build.library_path("layer_norm").name != cuda_before
    # a source that does not compile raises with g++'s output
    (tmp_path / "csrc" / "loader.cpp").write_text("int broken(\n")
    with pytest.raises(RuntimeError, match=r"g\+\+ loader\.cpp") as err:
        _build.build(["loader"])
    assert "error" in str(err.value)
