"""Host-side paged-KV bookkeeping: fixed-size pages with REFCOUNTS, per-request
block tables with copy-on-write, alloc/share/free/fragmentation stats.

The PyTorch port's copy of ``repro/serve/paged_cache.py``, unchanged: it is
pure host-side Python.  The engine's prefix cache drives ``share`` /
``adopt`` / ``first_shared_block`` / ``replace``; ``shrink`` waits for
speculative decoding.  ``page_bytes`` is the bytes one page holds across
every layer's pools, scale pools included (the engine computes it).

The device arrays live in the model cache (``model.init_paged_cache``); this
module owns WHICH physical page each logical block of each request maps to —
and, since the prefix cache (``serve/prefix_cache.py``) landed, HOW MANY
owners each page has:

* every allocated page carries a refcount (1 at ``alloc``); ``share`` adds
  an owner (a prefix-cache entry, or a request whose block table maps a
  cached prefix) and ``free`` removes one — a page returns to the free list
  only when its last owner lets go.  Freeing a page that is already free
  raises loudly: with sharing in play a double-free would silently hand the
  same page to two requests and corrupt both streams.
* ``BlockTable`` supports copy-on-write: a table may ``adopt`` shared pages
  (a prefix hit mapping cached KV into a new request), and before a lane
  writes into a block the engine asks ``first_shared_block`` — a shared
  page must first be replaced by a private copy (device rows copied via
  ``model.copy_paged_pages``) so the write can never leak into another
  sharer's history.

Page 0 is a scratch page owned by no request — masked lanes of padded
prefill chunks are redirected there (attention.paged_scatter), so it is
never handed out by the allocator.

``metrics`` (optional ``repro_torch.obs.metrics.MetricsRegistry``) mirrors the bookkeeping
into the observability layer: ``pages_alloc_total`` / ``pages_free_total`` /
``pages_shared_total`` counters and ``pages_in_use`` / ``pages_shared``
gauges, so page pressure AND sharing show up next to the engine's latency
series.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def pages_needed(n_tokens: int, page_size: int) -> int:
    return max(0, -(-n_tokens // page_size))


class PageAllocator:
    """Refcounted free-list allocator over pages 1..num_pages-1 (page 0 =
    scratch).  ``alloc`` hands out pages at refcount 1; ``share`` adds an
    owner; ``free`` removes one and recycles the page at refcount 0.
    ``_free`` and ``_ref`` are private — all consumers go through
    alloc/share/free (CI greps for direct access)."""

    def __init__(self, num_pages: int, page_size: int, metrics=None,
                 page_bytes: int = 0):
        assert num_pages >= 2, "need >= 1 allocatable page + scratch page 0"
        self.num_pages = num_pages
        self.page_size = page_size
        # HBM bytes one page costs across every layer's pools (quantized
        # engines: narrow K/V pages + fp32 scale rows); 0 = unknown.
        # Turns page pressure into byte pressure so capacity comparisons
        # across kv_dtype are apples-to-apples (requests per HBM byte)
        self.page_bytes = page_bytes
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}     # page -> owner count (allocated)
        self.n_allocs = 0
        self.n_frees = 0
        self.n_shares = 0
        self.peak_in_use = 0
        self.metrics = metrics

    def _observe(self):
        if self.metrics is None:
            return
        site = "serve/paged_cache.py"
        self.metrics.gauge("pages_in_use", unit="pages",
                           site=site).set(self.in_use)
        self.metrics.gauge("pages_shared", unit="pages",
                           site=site).set(self.shared_pages)
        if self.page_bytes:
            self.metrics.gauge("engine_kv_bytes_in_use", unit="bytes",
                               site=site).set(self.in_use * self.page_bytes)

    @property
    def capacity(self) -> int:
        return self.num_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def shared_pages(self) -> int:
        """Pages with more than one owner (tree + tables, or table + table)."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, page: int) -> int:
        """Owner count of ``page`` (0 = free)."""
        return self._ref.get(page, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages at refcount 1, or None if the pool can't cover them (no
        partial grabs)."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._ref[pg] = 1
        self.n_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        if self.metrics is not None:
            self.metrics.counter("pages_alloc_total", unit="pages",
                                 site="serve/paged_cache.py").inc(n)
            self._observe()
        return pages

    def share(self, pages: List[int]) -> None:
        """Add an owner to each (already-allocated) page.  A prefix-cache
        entry and every request whose block table maps it each hold one
        reference; the page recycles only when the last one frees."""
        for pg in pages:
            if pg not in self._ref:
                raise RuntimeError(
                    f"share of free page {pg}: only allocated pages can gain "
                    f"owners")
            self._ref[pg] += 1
        self.n_shares += len(pages)
        if self.metrics is not None:
            self.metrics.counter("pages_shared_total", unit="pages",
                                 site="serve/paged_cache.py").inc(len(pages))
            self._observe()

    def free(self, pages: List[int]) -> None:
        """Drop one owner per page; recycle at refcount 0.  Freeing a page
        that is already free raises: under refcounted sharing a double-free
        would hand the same page to two requests (silent KV corruption), so
        the allocator fails loudly instead."""
        for pg in pages:
            assert 0 < pg < self.num_pages, pg
            if pg not in self._ref:
                raise RuntimeError(
                    f"double free of page {pg}: page is not allocated "
                    f"(refcounted sharing would silently corrupt KV)")
        for pg in pages:
            self._ref[pg] -= 1
            if self._ref[pg] == 0:
                del self._ref[pg]
                self._free.append(pg)
        self.n_frees += len(pages)
        if self.metrics is not None:
            self.metrics.counter("pages_free_total", unit="pages",
                                 site="serve/paged_cache.py").inc(len(pages))
            self._observe()

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "in_use": self.in_use,
            "free": self.free_pages,
            "shared": self.shared_pages,
            "peak_in_use": self.peak_in_use,
            "allocs": self.n_allocs,
            "frees": self.n_frees,
            "shares": self.n_shares,
            "utilization": self.in_use / max(self.capacity, 1),
            "page_bytes": self.page_bytes,
            "bytes_in_use": self.in_use * self.page_bytes,
            "peak_bytes_in_use": self.peak_in_use * self.page_bytes,
        }


class BlockTable:
    """Per-request logical-block -> physical-page map with COW support.

    A table's pages come from two sources: private pages it allocated
    (``ensure``) and shared pages it adopted from the prefix cache
    (``adopt`` — the caller holds the extra refcount before handing them
    over).  ``release`` drops one reference per page either way; shared
    pages survive in their other owners' hands.  Before a lane writes into
    a block, the engine must confirm the page is private
    (``first_shared_block`` returns None) — a shared page is first
    replaced by a private device copy (copy-on-write)."""

    def __init__(self, allocator: PageAllocator, max_blocks: int):
        self.alloc = allocator
        self.max_blocks = max_blocks
        self.pages: List[int] = []

    def adopt(self, pages: List[int]) -> None:
        """Seed a fresh table with already-shared pages (the caller bumped
        their refcounts via ``allocator.share``; this table now owns those
        references and ``release`` will drop them)."""
        assert not self.pages, "adopt only seeds an empty table"
        self.pages = list(pages)

    def ensure(self, seq_len: int) -> bool:
        """Grow to cover ``seq_len`` tokens.  All-or-nothing: on failure the
        table is unchanged and the caller decides (preempt / queue)."""
        need = pages_needed(seq_len, self.alloc.page_size)
        if need > self.max_blocks:
            return False
        grow = need - len(self.pages)
        if grow <= 0:
            return True
        got = self.alloc.alloc(grow)
        if got is None:
            return False
        self.pages.extend(got)
        return True

    def first_shared_block(self, start_tok: int, end_tok: int) -> Optional[int]:
        """First block index in the token write range [start_tok, end_tok)
        whose page has other owners (refcount > 1) — the COW trigger: the
        engine copies that page's device KV rows to a fresh page and swaps
        the entry before any write lands.  None = whole range is private."""
        if end_tok <= start_tok:
            return None
        ps = self.alloc.page_size
        for blk in range(start_tok // ps, (end_tok - 1) // ps + 1):
            if blk < len(self.pages) and self.alloc.refcount(
                    self.pages[blk]) > 1:
                return blk
        return None

    def replace(self, blk: int, new_page: int) -> int:
        """Swap block ``blk``'s entry for ``new_page`` (the COW copy),
        dropping this table's reference on the old page.  Returns the old
        page (still owned by its remaining sharers)."""
        old = self.pages[blk]
        self.pages[blk] = new_page
        self.alloc.free([old])
        return old

    def shrink(self, seq_len: int) -> int:
        """Drop trailing pages beyond what ``seq_len`` tokens need — the
        speculative-decode rollback: a tick that grew the table for n
        proposed tokens but accepted fewer rewinds the growth here.  Only
        THIS table's references are dropped (free decrements refcounts),
        so pages still owned by the prefix cache or another sharer
        survive untouched.  Returns the number of references dropped."""
        keep = pages_needed(seq_len, self.alloc.page_size)
        tail = self.pages[keep:]
        if tail:
            self.pages = self.pages[:keep]
            self.alloc.free(tail)
        return len(tail)

    def release(self) -> None:
        if self.pages:
            self.alloc.free(self.pages)
            self.pages = []

    def as_row(self, width: Optional[int] = None) -> np.ndarray:
        """Padded int32 row for the device block-table tensor (pad = scratch
        page 0; positions there are never read thanks to the seq-len mask)."""
        width = self.max_blocks if width is None else width
        row = np.zeros((width,), np.int32)
        row[:len(self.pages)] = self.pages
        return row

    def internal_fragmentation(self, seq_len: int) -> int:
        """Allocated-but-unused KV slots (the defrag metric: pages are fixed
        size, so the only fragmentation a paged cache suffers is the unused
        tail of each request's last page)."""
        return len(self.pages) * self.alloc.page_size - seq_len
