"""Serialized KV-page handoff: the wire between a prefill-only engine and
a decode engine.

Counterpart of ``apex_tpu/serve/handoff.py``, with the same wire format
byte for byte.  A prefill engine chunk-prefills a request and hands its
finished KV pages to a decode engine as a :class:`KVHandoff`: the
context the pages encode, the sampled-but-uncommitted seed tokens, the
valid length, the geometry, and the page contents the source decoder
gathered (``GPTDecoder.gather_pages``).  :class:`KVHandoffChunk` is the
streamed variant, one page-aligned slice of a slot at a time, whose
final chunk carries the resume metadata.

The wire: one JSON header line (``sort_keys=True``; the schema, the
geometry, the dtype name, the payload's CRC32) and the raw payload, the
segments k, v and, on int8 pools, k_scale and v_scale.  A damaged,
truncated or foreign blob raises :class:`HandoffError` at parse time, so
the caller falls back to recompute instead of importing garbage K/V.

A container is host data: its arrays are CPU torch tensors (JAX's are
numpy arrays, whose bf16 needs ``ml_dtypes``), named on the wire by
:data:`DTYPE_NAMES` and parsed with ``torch.frombuffer``.  The import
path is the decode engine's: ``PagePool.import_slot`` maps fresh pages
of refcount 1 (shared and copy-on-write source pages arrive as plain
content), ``GPTDecoder.adopt_pages`` scatters the contents and sets the
slot's length on the device, and ``ServeEngine.adopt`` resumes decoding
from the last seed token.
"""
from __future__ import annotations

import dataclasses
import json
import math
import zlib
from typing import List, Optional, Tuple

import torch

__all__ = ["CHUNK_SCHEMA", "DTYPE_NAMES", "HANDOFF_SCHEMA", "HandoffError",
           "KVHandoff", "KVHandoffChunk"]

HANDOFF_SCHEMA = "apex_tpu.kv_handoff.v1"
CHUNK_SCHEMA = "apex_tpu.kv_handoff_chunk.v1"

#: the page dtypes a container carries, by their wire name (numpy's)
DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
               torch.int8: "int8", torch.float16: "float16"}
_BY_NAME = {name: dt for dt, name in DTYPE_NAMES.items()}


class HandoffError(RuntimeError):
    """A handoff container failed validation (truncated bytes, CRC
    mismatch, schema or geometry disagreement), raised at parse or
    import time so the caller can fall back to recompute."""


def _dtype_name(dtype: torch.dtype) -> str:
    try:
        return DTYPE_NAMES[dtype]
    except KeyError:
        raise HandoffError(f"page dtype {dtype} has no wire name") from None


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _payload(c) -> bytes:
    """The raw segments k, v (and k_scale, v_scale on int8 pools)."""
    segs = [c.k, c.v]
    if c.k_scale is not None:
        segs += [c.k_scale, c.v_scale]
    return b"".join(s.contiguous().view(torch.uint8).numpy().tobytes()
                    for s in segs)


def _frame(header: dict, payload: bytes) -> bytes:
    header["crc32"] = zlib.crc32(payload) & 0xFFFFFFFF
    return json.dumps(header, sort_keys=True).encode() + b"\n" + payload


def _unframe(blob: bytes, schema: str, what: str):
    """``(header, payload bytes as a writable uint8 tensor)``; raises on a
    missing terminator, an unparseable header, another schema or a CRC
    mismatch."""
    nl = blob.find(b"\n")
    if nl < 0:
        raise HandoffError(f"truncated {what}: no header terminator")
    try:
        header = json.loads(blob[:nl].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise HandoffError(f"unparseable {what} header: {e}") from e
    if not isinstance(header, dict) or header.get("schema") != schema:
        got = header.get("schema") if isinstance(header, dict) else None
        raise HandoffError(f"unknown {what} schema {got!r}")
    view = memoryview(blob)[nl + 1:]
    if (zlib.crc32(view) & 0xFFFFFFFF) != header.get("crc32"):
        raise HandoffError(f"{what} payload CRC mismatch — page contents "
                           "were corrupted in transit")
    buf = bytearray(view)  # the one copy: a writable buffer to view
    u8 = (torch.frombuffer(buf, dtype=torch.uint8) if buf
          else torch.empty(0, dtype=torch.uint8))
    return header, u8


def _segment(u8: torch.Tensor, off: int, shape, dtype: torch.dtype):
    """``shape`` elements of ``dtype`` at byte ``off`` of the payload (a
    short payload raises; a misaligned slice is copied first)."""
    size = torch.empty((), dtype=dtype).element_size()
    n = math.prod(shape) * size
    seg = u8[off:off + n]
    if seg.numel() != n:
        raise ValueError(f"payload holds {seg.numel()} of the {n} bytes "
                         f"at offset {off}")
    if off % size:
        seg = seg.clone()
    return seg.view(dtype).reshape(shape)


def _arrays(header: dict, u8: torch.Tensor):
    """``(k, v, k_scale, v_scale)`` of a parsed header and payload."""
    shape = tuple(int(s) for s in header["shape"])
    name = header["dtype"]
    if name not in _BY_NAME:
        raise ValueError(f"unknown page dtype {name!r}")
    dtype = _BY_NAME[name]
    per = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    k = _segment(u8, 0, shape, dtype)
    v = _segment(u8, per, shape, dtype)
    k_scale = v_scale = None
    if header.get("quantized"):
        sshape = shape[:4]
        sper = math.prod(sshape) * 4
        k_scale = _segment(u8, 2 * per, sshape, torch.float32)
        v_scale = _segment(u8, 2 * per + sper, sshape, torch.float32)
    return k, v, k_scale, v_scale


@dataclasses.dataclass
class KVHandoff:
    """One slot's KV pages in transit between engines.

    ``tokens`` is the context the pages encode (positions ``[0,
    length)``: the prompt and any generated tokens whose K/V is
    written); ``seed_tokens`` the sampled-but-uncommitted tokens riding
    along (at least the first token the prefill engine sampled; its K/V
    is written by the destination's next decode window).  ``k``/``v``
    are CPU tensors ``(n_pages, layers, heads, page_len, head_dim)`` in
    logical page order, every head of the model; int8 pools carry their
    per-token fp32 scales in ``k_scale``/``v_scale``.  ``corr`` is the
    correlation id stamped into the header, so both engines' telemetry
    carries it.
    """

    tokens: List[int]
    seed_tokens: List[int]
    length: int
    page_len: int
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    corr: Optional[str] = None

    @property
    def n_pages(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def payload_bytes(self) -> int:
        return (_nbytes(self.k) + _nbytes(self.v) + _nbytes(self.k_scale)
                + _nbytes(self.v_scale))

    def __post_init__(self):
        if self.k.shape != self.v.shape:
            raise HandoffError(
                f"k/v shape mismatch: {tuple(self.k.shape)} vs "
                f"{tuple(self.v.shape)}")
        if self.length < 1 or self.length > self.n_pages * self.page_len:
            raise HandoffError(
                f"length {self.length} outside the {self.n_pages} page(s) "
                f"of {self.page_len} the handoff carries")
        if not self.seed_tokens:
            raise HandoffError(
                "a handoff needs at least one uncommitted seed token (the "
                "sampled continuation the destination resumes from)")

    def to_bytes(self) -> bytes:
        """JSON header line + raw page payload (the header pins the
        payload's CRC32 and layout)."""
        header = {
            "schema": HANDOFF_SCHEMA,
            "tokens": [int(t) for t in self.tokens],
            "seed_tokens": [int(t) for t in self.seed_tokens],
            "length": int(self.length),
            "page_len": int(self.page_len),
            "shape": list(self.k.shape),
            "dtype": _dtype_name(self.k.dtype),
            "quantized": self.k_scale is not None,
        }
        if self.corr is not None:
            header["corr"] = str(self.corr)
        return _frame(header, _payload(self))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "KVHandoff":
        """Parse and validate; any damage raises :class:`HandoffError`."""
        header, u8 = _unframe(blob, HANDOFF_SCHEMA, "handoff")
        try:
            k, v, k_scale, v_scale = _arrays(header, u8)
            return cls(
                tokens=[int(t) for t in header["tokens"]],
                seed_tokens=[int(t) for t in header["seed_tokens"]],
                length=int(header["length"]),
                page_len=int(header["page_len"]),
                k=k, v=v, k_scale=k_scale, v_scale=v_scale,
                corr=header.get("corr"))
        except HandoffError:
            raise
        except Exception as e:  # short payload, bad shape, ...
            raise HandoffError(f"malformed handoff payload: {e}") from e

    def compatible_with(self, cache, heads: Optional[int] = None
                        ) -> Tuple[bool, str]:
        """``(ok, why)`` against a destination ``PagedKVCache``; ``heads``
        is the model's head count where the cache holds a tensor-parallel
        rank's share (None: the cache's own)."""
        return _geometry_check(self, cache, heads)


def _geometry_check(container, cache, heads: Optional[int] = None
                    ) -> Tuple[bool, str]:
    """The geometry check of :class:`KVHandoff` and
    :class:`KVHandoffChunk` against a destination ``PagedKVCache``: a
    container always carries every head, so a rank-local cache is held
    against the model's ``heads``."""
    want = (cache.layers, cache.heads if heads is None else int(heads),
            cache.page_len, cache.head_dim)
    have = tuple(container.k.shape[1:])
    if have != want:
        return False, f"page geometry {have} != cache {want}"
    if container.page_len != cache.page_len:
        return False, f"page_len {container.page_len} != {cache.page_len}"
    if container.k.dtype != cache.k.dtype:
        return False, (f"dtype {DTYPE_NAMES.get(container.k.dtype)} != "
                       f"{DTYPE_NAMES.get(cache.k.dtype)}")
    if container.quantized != (cache.k_scale is not None):
        return False, "quantization mode mismatch"
    return True, ""


@dataclasses.dataclass
class KVHandoffChunk:
    """One page-aligned slice of a slot's KV in transit: the streamed
    handoff's wire unit.

    A stream is a sequence of chunks with consecutive ``seq`` numbers
    carrying pages ``[page_offset, page_offset + n_pages)`` in logical
    order; the final chunk also carries the resume metadata
    (``tokens``/``seed_tokens``/``length``).  Chunks share
    :class:`KVHandoff`'s framing, so a damaged chunk raises
    :class:`HandoffError` instead of importing garbage mid-stream.
    """

    seq: int
    page_offset: int
    page_len: int
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    # the final chunk's resume metadata (None on interior chunks)
    tokens: Optional[List[int]] = None
    seed_tokens: Optional[List[int]] = None
    length: Optional[int] = None
    corr: Optional[str] = None

    @property
    def n_pages(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def final(self) -> bool:
        return self.length is not None

    @property
    def payload_bytes(self) -> int:
        return (_nbytes(self.k) + _nbytes(self.v) + _nbytes(self.k_scale)
                + _nbytes(self.v_scale))

    def __post_init__(self):
        if self.k.shape != self.v.shape:
            raise HandoffError(
                f"k/v shape mismatch: {tuple(self.k.shape)} vs "
                f"{tuple(self.v.shape)}")
        if self.seq < 0 or self.page_offset < 0:
            raise HandoffError(
                f"negative chunk coordinates (seq {self.seq}, page_offset "
                f"{self.page_offset})")
        if not self.final and self.n_pages < 1:
            raise HandoffError("interior chunk carries no pages")
        if self.final:
            if not self.seed_tokens:
                raise HandoffError(
                    "final chunk needs at least one uncommitted seed token "
                    "(the sampled continuation)")
            total = (self.page_offset + self.n_pages) * self.page_len
            if self.length is None or self.length < 1 \
                    or self.length > total:
                raise HandoffError(
                    f"final-chunk length {self.length} outside the {total} "
                    f"position(s) the stream covers")

    def to_bytes(self) -> bytes:
        """:meth:`KVHandoff.to_bytes`'s framing."""
        header = {
            "schema": CHUNK_SCHEMA,
            "seq": int(self.seq),
            "page_offset": int(self.page_offset),
            "page_len": int(self.page_len),
            "shape": list(self.k.shape),
            "dtype": _dtype_name(self.k.dtype),
            "quantized": self.k_scale is not None,
        }
        if self.final:
            header["tokens"] = [int(t) for t in self.tokens]
            header["seed_tokens"] = [int(t) for t in self.seed_tokens]
            header["length"] = int(self.length)
        if self.corr is not None:
            header["corr"] = str(self.corr)
        return _frame(header, _payload(self))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "KVHandoffChunk":
        """Parse and validate; any damage raises :class:`HandoffError`."""
        header, u8 = _unframe(blob, CHUNK_SCHEMA, "chunk")
        try:
            k, v, k_scale, v_scale = _arrays(header, u8)
            tokens = header.get("tokens")
            seeds = header.get("seed_tokens")
            return cls(
                seq=int(header["seq"]),
                page_offset=int(header["page_offset"]),
                page_len=int(header["page_len"]),
                k=k, v=v, k_scale=k_scale, v_scale=v_scale,
                tokens=None if tokens is None else [int(t) for t in tokens],
                seed_tokens=(None if seeds is None
                             else [int(t) for t in seeds]),
                length=(None if header.get("length") is None
                        else int(header["length"])),
                corr=header.get("corr"))
        except HandoffError:
            raise
        except Exception as e:  # short payload, bad shape, ...
            raise HandoffError(f"malformed chunk payload: {e}") from e

    def compatible_with(self, cache, heads: Optional[int] = None
                        ) -> Tuple[bool, str]:
        return _geometry_check(self, cache, heads)
