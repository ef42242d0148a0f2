"""KV caches — the contiguous slot cache, and the global page pool with
its host-side allocator.

Counterpart of ``apex_tpu/serve/kv_cache.py``.  :class:`KVCache` is the
contiguous layout: every slot owns ``max_len`` columns of every layer,
``(slots, layers, heads, max_len, head_dim)``, for its lifetime.  In the
paged layout K/V live in a global pool of fixed-size pages
``(num_pages, layers, heads, page_len, head_dim)`` on the device; a
host-side :class:`PagePool` maps each slot's logical positions to
physical pages and hands the ``(slots, pages_per_slot)`` int32 page
table to every dispatch.  Page :data:`TRASH_PAGE` is never allocated:
free and unmapped table entries point at it, so inactive slots' masked
writes land in a sink.

Where the JAX caches are immutable pytrees donated through each
dispatch, :class:`KVCache` and :class:`PagedKVCache` hold device tensors
that the prefill, decode and copy programs update IN PLACE.  Int8 pools carry per-token
fp32 scales (``k_scale``/``v_scale``) beside the pages.  Under
tensor-parallel serving (``cfg.decode_tp_axis``) each rank's caches hold
its ``num_heads / tp`` heads (``GPTConfig.local_heads``): the head axis,
dim 2, sharded as ``serve.sharding.cache_pspec`` says.  The allocator
classes are host code with no framework in them; the port keeps its
own copy rather than importing the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.ops._common import resolve_device

__all__ = [
    "TRASH_PAGE",
    "KVCache",
    "PagePool",
    "PagedKVCache",
    "SlotAllocator",
    "auto_page_len",
    "cache_bytes_per_slot",
    "init_cache",
    "init_paged_cache",
]

TRASH_PAGE = 0  # physical page 0 is never allocated (see module docs)


@dataclasses.dataclass
class KVCache:
    """Device state of the contiguous decode engine, updated in place."""

    k: torch.Tensor        # (slots, layers, heads, max_len, head_dim)
    v: torch.Tensor        # (slots, layers, heads, max_len, head_dim)
    lengths: torch.Tensor  # (slots,) int32 valid prefix per slot
    decoded: torch.Tensor  # () int64 total generated tokens (device meter)

    @property
    def slots(self) -> int:
        return self.k.shape[0]

    @property
    def layers(self) -> int:
        return self.k.shape[1]

    @property
    def heads(self) -> int:
        return self.k.shape[2]

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @property
    def bytes_per_slot(self) -> int:
        """K+V bytes one slot pins for its lifetime."""
        per = self.layers * self.heads * self.max_len * self.head_dim
        return 2 * per * self.k.element_size()


def cache_bytes_per_slot(cfg, max_len: int,
                         dtype: Optional[torch.dtype] = None) -> int:
    """Shape-only K+V bytes a slot of :class:`KVCache` pins (``dtype``
    None: the config's compute dtype); no tensor is made."""
    d = cfg.hidden_size // cfg.num_heads
    per = cfg.num_layers * cfg.local_heads * max_len * d
    return 2 * per * (dtype or cfg.compute_dtype).itemsize


def init_cache(
    cfg,
    slots: int,
    max_len: int,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> KVCache:
    """A zeroed contiguous cache for ``slots`` sequences on ``device``
    (None: the CUDA device).  ``dtype`` None -> ``cfg.compute_dtype``;
    ``max_len`` must fit the learned positions (``cfg.max_position``),
    and int8 storage is for the page pool only."""
    if max_len > cfg.max_position:
        raise ValueError(
            f"max_len {max_len} exceeds cfg.max_position {cfg.max_position}")
    dtype = cfg.compute_dtype if dtype is None else dtype
    if dtype == torch.int8:
        raise ValueError("int8 KV storage is paged-only: use "
                         "init_paged_cache, or keep the contiguous cache at "
                         "bf16/fp32")
    dev = resolve_device(device)
    shape = (slots, cfg.num_layers, cfg.local_heads, max_len,
             cfg.hidden_size // cfg.num_heads)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=dev),
        decoded=torch.zeros((), dtype=torch.int64, device=dev),
    )


@dataclasses.dataclass
class PagedKVCache:
    """Device state of the paged decode engine, updated in place."""

    k: torch.Tensor        # (num_pages, layers, heads, page_len, head_dim)
    v: torch.Tensor        # (num_pages, layers, heads, page_len, head_dim)
    lengths: torch.Tensor  # (slots,) int32 valid prefix per slot
    decoded: torch.Tensor  # () int64 total generated tokens (device meter)
    k_scale: Optional[torch.Tensor] = None  # (num_pages, layers, heads, page_len)
    v_scale: Optional[torch.Tensor] = None

    @property
    def layers(self) -> int:
        return self.k.shape[1]

    @property
    def heads(self) -> int:
        return self.k.shape[2]

    @property
    def page_len(self) -> int:
        return self.k.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k.shape[4]

    @property
    def slots(self) -> int:
        return self.lengths.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def bytes_per_page(self) -> int:
        """K+V bytes one physical page pins while allocated (including
        the per-token scales in int8 mode)."""
        per = self.layers * self.heads * self.page_len * self.head_dim
        n = 2 * per * self.k.element_size()
        if self.k_scale is not None:
            n += 2 * self.layers * self.heads * self.page_len * 4
        return n


def auto_page_len(max_len: int, preferred: int = 16) -> int:
    """Largest power-of-two page length <= ``preferred`` dividing
    ``max_len``."""
    p = preferred
    while p > 1 and max_len % p:
        p //= 2
    return p


def init_paged_cache(
    cfg,
    num_pages: int,
    slots: int,
    page_len: int,
    dtype: Optional[torch.dtype] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> PagedKVCache:
    """A zeroed page pool (page 0 is the trash page) on ``device`` (None:
    the CUDA device).  ``dtype`` None -> ``cfg.compute_dtype``;
    ``torch.int8`` adds per-token scales, initialised to 1."""
    if num_pages < 2:
        raise ValueError("need at least one real page beyond the trash page")
    if page_len < 1:
        raise ValueError("page_len must be >= 1")
    dev = resolve_device(device)
    dtype = cfg.compute_dtype if dtype is None else dtype
    shape = (num_pages, cfg.num_layers, cfg.local_heads, page_len,
             cfg.hidden_size // cfg.num_heads)
    quant = dtype == torch.int8
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        lengths=torch.zeros((slots,), dtype=torch.int32, device=dev),
        decoded=torch.zeros((), dtype=torch.int64, device=dev),
        k_scale=torch.ones(shape[:4], device=dev) if quant else None,
        v_scale=torch.ones(shape[:4], device=dev) if quant else None,
    )


class SlotAllocator:
    """Host-side FIFO free list over the cache's slot axis."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def allocate(self) -> Optional[int]:
        """Pop a free slot id, or None when every slot is taken."""
        if not self._free:
            return None
        return self._free.pop(0)

    def free(self, slot: int) -> None:
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        self._free.append(slot)


class PagePool:
    """Host-side allocator over the physical page axis: free list,
    refcounts, per-slot page tables and the shared-prefix registry.

    - a physical page may back the same logical page of several slots
      (refcount > 1) when their prompts agree on every token up to the
      end of that page's coverage — prefix reuse;
    - appends need exclusive ownership: :meth:`ensure_writable` maps
      fresh pages for unmapped logical pages and splits shared ones
      copy-on-write, returning the ``(src, dst)`` page copies the caller
      runs on the device before its write;
    - freeing decrements refcounts; a page back on the free list leaves
      the prefix registry;
    - a handoff exports a slot's pages as content (:meth:`export_slot`)
      and imports them into fresh pages of refcount 1
      (:meth:`import_slot`, :meth:`import_pages`); a migrated prefix is
      anchored in the registry without a slot (:meth:`adopt_prefix`).

    Registry keys are full token prefixes: causal attention makes a
    page's K/V a function of every token up to its coverage, so equal
    keys mean equal pages.
    """

    def __init__(self, num_pages: int, page_len: int, slots: int,
                 pages_per_slot: int):
        if num_pages - 1 < pages_per_slot:
            raise ValueError(
                f"pool of {num_pages} pages (1 reserved) cannot hold even "
                f"one full-length sequence ({pages_per_slot} pages)")
        self.num_pages = num_pages
        self.page_len = page_len
        self.pages_per_slot = pages_per_slot
        self._free: List[int] = list(range(1, num_pages))
        self.ref = np.zeros((num_pages,), np.int32)
        self.tables = np.zeros((slots, pages_per_slot), np.int32)
        self._prefix: Dict[Tuple[int, ...], int] = {}
        self._rev: Dict[int, Tuple[int, ...]] = {}
        self.peak_in_use = 0
        self.cow_copies = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def _alloc(self) -> Optional[int]:
        if not self._free:
            return None
        page = self._free.pop(0)
        self.ref[page] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return page

    def _decref(self, page: int) -> None:
        self.ref[page] -= 1
        if self.ref[page] < 0:
            raise ValueError(f"page {page} refcount underflow")
        if self.ref[page] == 0:
            key = self._rev.pop(page, None)
            if key is not None:
                self._prefix.pop(key, None)
            self._free.append(page)

    # -- prefix sharing -------------------------------------------------

    def match_prefix(self, prompt: List[int]) -> Tuple[List[int], int]:
        """Longest registered prefix of ``prompt``: the shared physical
        pages in logical order and the tokens they cover.  Full pages
        match greedily, then at most one trailing partial page (the
        longest registered tail)."""
        pl = self.page_len
        pages: List[int] = []
        pos = 0
        while pos + pl <= len(prompt):
            page = self._prefix.get(tuple(prompt[: pos + pl]))
            if page is None:
                break
            pages.append(page)
            pos += pl
        rem = min(pl - 1, len(prompt) - pos)
        for m in range(rem, 0, -1):
            page = self._prefix.get(tuple(prompt[: pos + m]))
            if page is not None:
                pages.append(page)
                pos += m
                break
        return pages, pos

    def share(self, slot: int, pages: List[int], tokens: int) -> None:
        """Map ``pages`` (from :meth:`match_prefix`) as the first logical
        pages of ``slot``, increffing each."""
        for i, page in enumerate(pages):
            if self.tables[slot, i]:
                raise ValueError(f"slot {slot} logical page {i} occupied")
            self.tables[slot, i] = page
            self.ref[page] += 1
        if pages:
            self.prefix_hits += 1
            self.prefix_hit_tokens += tokens

    def register(self, slot: int, prompt: List[int]) -> None:
        """Publish ``slot``'s prefilled prompt pages for reuse: one key
        per full page plus the partial tail."""
        pl = self.page_len
        n = len(prompt)
        for i in range((n + pl - 1) // pl):
            key = tuple(prompt[: min((i + 1) * pl, n)])
            page = int(self.tables[slot, i])
            if page == TRASH_PAGE or key in self._prefix:
                continue
            if page in self._rev:  # a page holds at most one key
                continue
            self._prefix[key] = page
            self._rev[page] = key

    # -- write ownership ------------------------------------------------

    def ensure_writable(self, slot: int, start: int, end: int):
        """Make positions ``[start, end)`` of ``slot`` exclusively
        writable.  Returns the ``(src, dst)`` page copies to run on the
        device before the write, or None when the pool is exhausted
        (pages allocated so far stay mapped; :meth:`release_slot`
        reclaims them)."""
        pl = self.page_len
        end = min(end, self.pages_per_slot * pl)
        copies: List[Tuple[int, int]] = []
        if start >= end:
            return copies
        for pidx in range(start // pl, (end - 1) // pl + 1):
            cur = int(self.tables[slot, pidx])
            if cur == TRASH_PAGE:
                page = self._alloc()
                if page is None:
                    return None
                self.tables[slot, pidx] = page
            elif self.ref[cur] > 1:
                page = self._alloc()
                if page is None:
                    return None
                copies.append((cur, page))
                self.tables[slot, pidx] = page
                self._decref(cur)
                self.cow_copies += 1
        return copies

    def release_slot(self, slot: int) -> None:
        """Decref every page the slot maps and point its table row back
        at the trash page."""
        for pidx in range(self.pages_per_slot):
            page = int(self.tables[slot, pidx])
            if page != TRASH_PAGE:
                self._decref(page)
        self.tables[slot, :] = TRASH_PAGE

    def slot_pages(self, slot: int) -> List[int]:
        """Physical pages currently mapped by ``slot``."""
        return [int(p) for p in self.tables[slot] if p != TRASH_PAGE]

    # -- disaggregated handoff ------------------------------------------

    def export_slot(self, slot: int, n_pages: int) -> List[int]:
        """The slot's first ``n_pages`` physical pages in logical order:
        the page-table half of a handoff's export.  A pure read: the
        refcounts and the registry stay (the source keeps serving the
        pages until the transfer lands; shared and copy-on-write pages
        export their content, never their ownership)."""
        pages = []
        for pidx in range(int(n_pages)):
            page = int(self.tables[slot, pidx])
            if page == TRASH_PAGE:
                raise ValueError(f"slot {slot} logical page {pidx} unmapped "
                                 f"— cannot export {n_pages} page(s)")
            pages.append(page)
        return pages

    def import_slot(self, slot: int, n_pages: int) -> Optional[List[int]]:
        """Map ``n_pages`` fresh pages of refcount 1 as the slot's first
        logical pages (the caller scatters the transferred contents into
        them).  All or nothing: None, with the pool as it was, when the
        free list cannot supply the run."""
        if any(self.tables[slot, :]):
            raise ValueError(f"slot {slot} already mapped")
        if n_pages < 1 or n_pages > self.pages_per_slot:
            raise ValueError(f"import of {n_pages} page(s) outside [1, "
                             f"{self.pages_per_slot}]")
        pages: List[int] = []
        for pidx in range(int(n_pages)):
            page = self._alloc()
            if page is None:
                for p in pages:  # roll back: nothing stays half-mapped
                    self._decref(p)
                self.tables[slot, :] = TRASH_PAGE
                return None
            self.tables[slot, pidx] = page
            pages.append(page)
        return pages

    def import_pages(self, slot: int, start_pidx: int,
                     n_pages: int) -> Optional[List[int]]:
        """The streamed variant of :meth:`import_slot`: map ``n_pages``
        fresh pages at logical indices ``[start_pidx, start_pidx +
        n_pages)`` of ``slot``, whose earlier chunks stay mapped.  All or
        nothing for this chunk: None (this chunk rolled back) when the
        free list runs dry; the caller aborts the stage."""
        if n_pages < 1 or start_pidx < 0 \
                or start_pidx + n_pages > self.pages_per_slot:
            raise ValueError(f"chunk of {n_pages} page(s) at {start_pidx} "
                             f"outside [0, {self.pages_per_slot})")
        if any(self.tables[slot, start_pidx:start_pidx + n_pages]):
            raise ValueError(f"slot {slot} logical pages [{start_pidx}, "
                             f"{start_pidx + n_pages}) already mapped")
        pages: List[int] = []
        for pidx in range(start_pidx, start_pidx + int(n_pages)):
            page = self._alloc()
            if page is None:
                for i, p in enumerate(pages):
                    self.tables[slot, start_pidx + i] = TRASH_PAGE
                    self._decref(p)
                return None
            self.tables[slot, pidx] = page
            pages.append(page)
        return pages

    # -- prefix migration -----------------------------------------------

    def adopt_prefix(self, tokens: List[int]) -> Optional[List[int]]:
        """Allocate fresh anchor pages for a page-aligned token prefix and
        publish them in the registry without mapping them to a slot (the
        destination half of a prefix migration): later arrivals
        :meth:`match_prefix` into them, and :meth:`release_prefix` drops
        the anchor.  Returns the pages (the caller scatters the contents
        into them), or None when the prefix is already registered or the
        free list cannot supply the run (nothing mapped)."""
        pl = self.page_len
        if not tokens or len(tokens) % pl:
            raise ValueError(f"adopt_prefix needs a page-aligned prefix, got "
                             f"{len(tokens)} token(s) at page_len {pl}")
        keys = [tuple(tokens[:(i + 1) * pl]) for i in range(len(tokens) // pl)]
        if any(k in self._prefix for k in keys):
            return None
        pages: List[int] = []
        for _ in keys:
            page = self._alloc()
            if page is None:
                for p in pages:
                    self._decref(p)
                return None
            pages.append(page)
        for key, page in zip(keys, pages):
            self._prefix[key] = page
            self._rev[page] = key
        return pages

    def release_prefix(self, pages: List[int]) -> None:
        """Drop the anchor refs of :meth:`adopt_prefix` (pages that live
        slots still share survive until their last reader)."""
        for page in pages:
            self._decref(int(page))

    def drop_prefixes(self) -> int:
        """Unpublish every registry key; returns how many.  After a swap
        to changed weights the cached pages encode the old weights, so no
        later prompt may match into them; pages that slots or anchors
        hold keep their refs."""
        n = len(self._prefix)
        self._prefix.clear()
        self._rev.clear()
        return n

    # -- out-of-band reservations ---------------------------------------

    def reserve(self, n: int) -> List[int]:
        """Take up to ``n`` pages out of circulation without mapping them
        (page pressure on demand, or a static headroom reservation).
        Give them back with :meth:`unreserve`."""
        pages: List[int] = []
        for _ in range(max(0, int(n))):
            page = self._alloc()
            if page is None:
                break
            pages.append(page)
        return pages

    def unreserve(self, pages: List[int]) -> None:
        for page in pages:
            self._decref(int(page))
