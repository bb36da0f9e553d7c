"""Block-table paged KV layout for the serving engine, port of
``repro.serve.paging``.

Physical per-token cache storage is a pool of fixed-size pages
(``[n_pages, page_size, ...]`` per layer, see ``transformer.cache_shapes(
page_size=..., n_pages=...)``); each slot owns a row of a page table mapping
logical page -> physical page. A request reserves pages for its own
``prompt + max_new`` tokens instead of ``cache_len`` per slot, and a
finished request's pages return to the pool at once.

Host side, ``PageManager`` is a free-list allocator over the physical pool.
Device side, unallocated table entries hold the sentinel ``n_pages`` (one
past the pool): decode writes through them are skipped and gathers clamp to
an arbitrary page whose rows the per-slot length mask discards.

``make_insert`` builds the prefill-insert step: a batch-1 *dense* prefill
cache is copied into the slot's pages (per-token leaves) or slot row
(per-slot state), driven by the cache ``Spec`` axes: "kv_pages" leaves
page-scatter, "batch" leaves slot-insert. The copy is in place.

On a mesh (``plan``) the pool is a ``ShardTree``: a leaf whose resolved
spec splits "kv_pages" over "model" holds pages ``[r*NP/m, (r+1)*NP/m)``
on rank r, a "batch" leaf split over "data" its rank's slots, and the
insert writes only what this rank holds. A pool leaf that resolves to a
head split ("kv_heads", when "model" does not divide the pages) stays
whole on every rank: the head split comes with tensor parallelism,
ROADMAP.md Queue A item 14i.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.common import leaf, part, spec_leaves


class OutOfPagesError(RuntimeError):
    """Raised when a request cannot be admitted even on an idle engine."""


@dataclasses.dataclass(frozen=True)
class PagingSpec:
    page_size: int
    n_pages: int

    def __post_init__(self):
        if self.page_size <= 0 or self.n_pages <= 0:
            raise ValueError(f"invalid paging spec {self}")

    def pages_for(self, n_tokens: int) -> int:
        return int(math.ceil(n_tokens / self.page_size))


class PageManager:
    """Free-list page allocator with per-slot page tables.

    ``table`` is [n_slots, pages_per_slot] int32; unallocated entries hold
    the sentinel ``n_pages``. Allocation is all-at-admission: a request's
    full page budget (prompt + max_new tokens) is claimed up front, so
    decode never needs a mid-flight extend, and ``release`` returns the
    whole row to the free list (lowest-numbered pages are handed out first,
    so physical reuse is deterministic given the request order)."""

    def __init__(self, n_slots: int, pages_per_slot: int, spec: PagingSpec):
        self.spec = spec
        self.n_slots = n_slots
        self.table = np.full((n_slots, pages_per_slot), spec.n_pages,
                             np.int32)
        self.lengths = np.zeros((n_slots,), np.int32)
        self._free = list(range(spec.n_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_alloc(self, n_tokens: int) -> bool:
        need = self.spec.pages_for(n_tokens)
        return need <= len(self._free) and need <= self.table.shape[1]

    def alloc(self, slot: int, n_tokens: int) -> None:
        need = self.spec.pages_for(n_tokens)
        if need > self.table.shape[1]:
            raise OutOfPagesError(
                f"request needs {need} pages > pages_per_slot "
                f"{self.table.shape[1]} (n_tokens={n_tokens}, "
                f"page_size={self.spec.page_size})")
        if need > len(self._free):
            raise OutOfPagesError(
                f"request needs {need} pages, only {len(self._free)} free "
                f"of {self.spec.n_pages}")
        assert (self.table[slot] == self.spec.n_pages).all(), \
            f"slot {slot} still holds pages"
        for i in range(need):
            self.table[slot, i] = self._free.pop()
        self.lengths[slot] = n_tokens

    def release(self, slot: int) -> None:
        row = self.table[slot]
        freed = sorted(int(p) for p in row if p < self.spec.n_pages)
        # keep the free list sorted descending so .pop() hands out the
        # lowest page first: deterministic physical placement
        self._free = sorted(set(self._free) | set(freed), reverse=True)
        self.table[slot] = self.spec.n_pages
        self.lengths[slot] = 0

    def device_table(self, device) -> torch.Tensor:
        return torch.as_tensor(self.table, device=device)


def _leaf_kind(spec) -> tuple[str, int]:
    """('paged', axis of n_pages) or ('slot', axis of batch) for one cache
    Spec (stacked leaves carry a leading 'layers' axis)."""
    if "kv_pages" in spec.axes:
        return "paged", spec.axes.index("kv_pages")
    if "batch" in spec.axes:
        return "slot", spec.axes.index("batch")
    raise ValueError(f"cache spec with neither kv_pages nor batch: {spec}")


def make_insert(paged_specs, page_size: int, plan=None):
    """Build ``insert(paged_cache, dense_cache, slot, table_row)``: copy a
    batch-1 dense prefill cache (whole on every rank) into ``slot``'s
    pages / slot row, in place. ``table_row`` is the slot's
    ``[pages_per_slot]`` row of the page table (a tensor on the cache's
    device). Under ``plan`` ``paged_cache`` is this rank's ``ShardTree``
    and only its own pages and slots are written."""
    leaves = [(path, _leaf_kind(s)) for path, s in spec_leaves(paged_specs)]
    if plan is not None:
        sizes, coords = plan.shape(), plan.coords()

    def first(path, ax, paged_cache) -> int:
        """The first page or slot this rank holds along ``ax``."""
        if plan is None:
            return 0
        ps = leaf(paged_cache.pspecs, path)
        dims = ps[ax] if ax < len(ps) else None
        return part(dims, sizes, coords)[0] * leaf(paged_cache,
                                                   path).shape[ax]

    def insert(paged_cache, dense_cache, slot: int, table_row):
        for path, (kind, ax) in leaves:
            big, small = leaf(paged_cache, path), leaf(dense_cache, path)
            lo = first(path, ax, paged_cache)
            lead = (slice(None),) * ax
            if kind == "paged":
                # big [..., NP, ps, tail], small [..., 1, CL, tail]: logical
                # row p goes to physical (table[p // ps], p % ps); rows past
                # the slot's allocated pages hit the sentinel and drop, and
                # pages another rank holds are skipped
                p = torch.arange(small.shape[ax + 1], device=big.device)
                page = table_row.long()[p // page_size] - lo
                keep = (page >= 0) & (page < big.shape[ax])
                rows = small.select(ax, 0).to(big.dtype)
                big[lead + (page[keep], (p % page_size)[keep])] = \
                    rows[lead + (keep,)]
            elif 0 <= slot - lo < big.shape[ax]:
                big[lead + (slot - lo,)] = small[lead + (0,)].to(big.dtype)
        return paged_cache

    return insert
