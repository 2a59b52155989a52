"""Token-level radix tree over page-aligned cached KV prefixes — plus the
FAL first-attention signal as a cached prefix artifact.

The PyTorch port's copy of ``repro/serve/prefix_cache.py``: host-side
Python over the port's ``PageAllocator``, the same tree, LRU, pinning and
page budget.  A stored signal is whatever the engine captured (the port
keeps a cloned tensor of the slot's ``a1_sig`` row); the tree only files it
by position.

At scale most traffic shares system prompts and few-shot preambles; without
sharing, every admission re-prefills the shared prefix from token 0 AND
re-pays block 0's assemble to rebuild ``cache["a1_sig"]``.  This module
keeps finished requests' page-aligned prefixes in a radix tree so a new
request's admission can:

* **match** the longest cached prefix of its prompt (page granularity —
  a page is reusable only if all ``page_size`` tokens agree),
* map the matched PHYSICAL pages straight into its block table (the
  allocator refcounts them; no KV bytes move), and
* **seed** ``cache["a1_sig"]`` from the entry's stored signal, because the
  FAL signal at position p is a pure function of tokens [0, p] — so a
  full-prompt hit enters decode on its first tick with no block-0 assemble
  at admission.  This is the FAL-specific win: the paper's redirected
  first-attention output is a per-request scalar artifact of the prefix,
  so it caches exactly like a KV page does.

Tree shape: children are keyed by their edge's FIRST PAGE of tokens
(``page_size`` tokens, byte-packed), every node's edge holds a whole
number of pages, and edges split only at page boundaries — two prompts
diverging mid-page simply become sibling nodes sharing no page, which is
the page-granularity sharing contract.  Each node carries its edge tokens,
the physical pages of that span (one tree-owned refcount each, taken via
``allocator.share`` at insert), an LRU stamp, and the a1_sig entries whose
positions fall inside its span.

Eviction is LRU over refcount-FREE leaves only: a leaf all of whose pages
have refcount 1 (the tree's own reference) can be dropped; a node still
shared with any live block table is never touched.  Eviction cascades —
dropping a leaf may expose its parent as the next candidate — and runs
both under allocator pressure (the engine calls ``evict`` before
preempting anyone) and against the ``max_pages`` budget
(``EngineConfig.max_cached_prefix_pages``).  ``pinned`` nodes (explicit
pinning via ``ServeRequest.pin_prefix``) are exempt.

Metrics (``prefix_*``, site serve/prefix_cache.py): ``prefix_hits_total``
/ ``prefix_misses_total`` / ``prefix_inserted_pages_total`` /
``prefix_evicted_pages_total`` counters, a ``prefix_hit_tokens``
histogram, and a ``prefix_cached_pages`` gauge; the allocator's
``pages_shared`` gauge counts pages with >1 owner.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.paged_cache import PageAllocator


class _Node:
    """One radix edge: ``tokens`` (a whole number of pages) labels the path
    from ``parent``; ``pages`` are the physical pages of that span (one
    tree refcount each); ``a1`` maps ABSOLUTE prefix positions inside this
    span to stored first-attention signals."""

    __slots__ = ("tokens", "pages", "children", "parent", "last_used",
                 "a1", "pinned")

    def __init__(self, tokens: np.ndarray, pages: List[int],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.pages = pages
        self.children: Dict[bytes, "_Node"] = {}
        self.parent = parent
        self.last_used = 0
        self.a1: Dict[int, Any] = {}
        self.pinned = False


class PrefixCache:
    """Radix tree of page-aligned cached prefixes over a ``PageAllocator``.

    The tree holds one refcount per cached page; requests that hit gain
    their own refcount via ``allocator.share`` (done by the engine before
    adopting, so a concurrent eviction can never free a just-matched
    page).  ``max_pages`` = 0 means no budget beyond the pool itself."""

    def __init__(self, allocator: PageAllocator, max_pages: int = 0,
                 metrics=None, tracer=None):
        self.alloc = allocator
        self.page = allocator.page_size
        self.max_pages = max_pages
        self.root = _Node(np.zeros((0,), np.int64), [], None)
        self.n_pages = 0
        self._clock = 0
        self.metrics = metrics
        self.tracer = tracer
        if metrics is not None:
            site = "serve/prefix_cache.py"
            self._c_hit = metrics.counter("prefix_hits_total",
                                          unit="admissions", site=site)
            self._c_miss = metrics.counter("prefix_misses_total",
                                           unit="admissions", site=site)
            self._c_ins = metrics.counter("prefix_inserted_pages_total",
                                          unit="pages", site=site)
            self._c_evict = metrics.counter("prefix_evicted_pages_total",
                                            unit="pages", site=site)
            self._h_hit_tokens = metrics.histogram("prefix_hit_tokens",
                                                   unit="tokens", site=site)
            self._g_pages = metrics.gauge("prefix_cached_pages",
                                          unit="pages", site=site)

    # -- helpers ----------------------------------------------------------

    def _key(self, tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens[:self.page]).tobytes()

    @staticmethod
    def _canon(tokens) -> np.ndarray:
        return np.asarray(tokens, dtype=np.int64).reshape(-1)

    def _match_pages(self, edge: np.ndarray, query: np.ndarray) -> int:
        """Number of leading whole pages on which ``edge`` and ``query``
        agree."""
        ps = self.page
        lim = min(len(edge), len(query)) // ps
        m = 0
        while m < lim and np.array_equal(edge[m * ps:(m + 1) * ps],
                                         query[m * ps:(m + 1) * ps]):
            m += 1
        return m

    def _observe(self):
        if self.metrics is not None:
            self._g_pages.set(self.n_pages)

    # -- queries ----------------------------------------------------------

    def match(self, tokens) -> Tuple[int, List[int], Dict[int, Any]]:
        """Longest page-aligned cached prefix of ``tokens``.

        Returns ``(n_hit, pages, a1)``: ``n_hit`` matched tokens (a
        multiple of page_size), the physical pages covering them in order,
        and the stored a1_sig entries at absolute positions < n_hit.  The
        caller must ``allocator.share(pages)`` before anything that could
        evict (the match itself holds no reference).  Touches LRU stamps on
        the walked path."""
        tokens = self._canon(tokens)
        self._clock += 1
        node, n = self.root, 0
        pages: List[int] = []
        a1: Dict[int, Any] = {}
        node.last_used = self._clock
        while len(tokens) - n >= self.page:
            child = node.children.get(self._key(tokens[n:]))
            if child is None:
                break
            m = self._match_pages(child.tokens, tokens[n:])
            if m == 0:        # hash collision across dtypes can't happen;
                break         # defensive: first page must match by key
            child.last_used = self._clock
            pages.extend(child.pages[:m])
            end = n + m * self.page
            for q, sig in child.a1.items():
                if q < end:
                    a1[q] = sig
            n = end
            if m < len(child.pages):
                break
            node = child
        return n, pages, a1

    def note_admission(self, hit_tokens: int) -> None:
        """Engine callback on a SUCCESSFUL admission: records hit/miss
        counters and the hit-length histogram (kept out of ``match`` so
        FCFS retries of a blocked head-of-queue don't inflate the rate)."""
        if self.metrics is None:
            return
        if hit_tokens > 0:
            self._c_hit.inc()
            self._h_hit_tokens.record(hit_tokens)
        else:
            self._c_miss.inc()

    # -- mutation ---------------------------------------------------------

    def _split(self, node: "_Node", parent: "_Node", keep_pages: int,
               abs_start: int) -> "_Node":
        """Split ``node``'s edge after ``keep_pages`` pages; returns the new
        upper node.  Pages keep their single tree refcount (they just move
        between nodes); a1 entries are distributed by absolute position."""
        ps = self.page
        cut = keep_pages * ps
        upper = _Node(node.tokens[:cut], node.pages[:keep_pages], parent)
        upper.last_used = node.last_used
        upper.pinned = node.pinned
        parent.children[self._key(upper.tokens)] = upper
        node.tokens = node.tokens[cut:]
        node.pages = node.pages[keep_pages:]
        node.parent = upper
        upper.children[self._key(node.tokens)] = node
        split_abs = abs_start + cut
        for q in [q for q in node.a1 if q < split_abs]:
            upper.a1[q] = node.a1.pop(q)
        return upper

    def insert(self, tokens, pages: List[int],
               a1: Optional[Dict[int, Any]] = None,
               pinned: bool = False) -> int:
        """Cache the page-aligned prefix ``tokens`` whose KV lives in
        ``pages`` (still owned by the inserting request's block table — the
        tree takes its OWN refcount on every newly-cached page via
        ``allocator.share``).  ``a1`` maps absolute positions to
        first-attention signals valid for this prefix.  Returns the number
        of pages newly adopted; enforces ``max_pages`` afterwards by LRU
        eviction (never evicting pinned nodes)."""
        tokens = self._canon(tokens)
        ps = self.page
        assert len(tokens) % ps == 0 and len(pages) == len(tokens) // ps
        a1 = dict(a1 or {})
        self._clock += 1
        node, n, adopted = self.root, 0, 0
        path: List[Tuple[int, "_Node"]] = []      # (abs_start, node)
        node.last_used = self._clock
        while n < len(tokens):
            child = node.children.get(self._key(tokens[n:]))
            if child is None:
                fresh = tokens[n:]
                fresh_pages = list(pages[n // ps:])
                self.alloc.share(fresh_pages)
                new = _Node(fresh, fresh_pages, node)
                new.last_used = self._clock
                node.children[self._key(fresh)] = new
                path.append((n, new))
                adopted += len(fresh_pages)
                self.n_pages += len(fresh_pages)
                n = len(tokens)
                break
            m = self._match_pages(child.tokens, tokens[n:])
            if m == 0:
                # same first-page key but different tokens is impossible
                # (the key IS the first page); defensive stop.
                break
            if m < len(child.pages):
                child = self._split(child, node, m, abs_start=n)
            child.last_used = self._clock
            path.append((n, child))
            n += len(child.tokens)
            node = child
        # pin + a1 attach along the covered path
        for abs_start, nd in path:
            span = len(nd.tokens)
            if pinned:
                nd.pinned = True
            for q in [q for q in a1 if abs_start <= q < abs_start + span]:
                nd.a1[q] = a1.pop(q)
        if self.metrics is not None and adopted:
            self._c_ins.inc(adopted)
        self._observe()
        if self.max_pages and self.n_pages > self.max_pages:
            self.evict(self.n_pages - self.max_pages)
        return adopted

    def _evictable_leaves(self) -> List["_Node"]:
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if (nd is not self.root and not nd.children and not nd.pinned
                    and all(self.alloc.refcount(pg) == 1
                            for pg in nd.pages)):
                out.append(nd)
        return out

    def evict(self, n_pages: int) -> int:
        """Free at least ``n_pages`` cached pages by dropping LRU leaves
        whose pages carry no reference beyond the tree's own (a node shared
        with any live block table is never evicted).  Cascades: removing a
        leaf may expose its parent.  Returns pages actually freed (may be
        less if everything left is referenced or pinned)."""
        freed = 0
        while freed < n_pages:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            self.alloc.free(victim.pages)
            freed += len(victim.pages)
            self.n_pages -= len(victim.pages)
            victim.parent.children.pop(self._key(victim.tokens))
            if self.tracer is not None:
                self.tracer.instant("PREFIX_EVICT", cat="lifecycle",
                                    pages=len(victim.pages),
                                    tokens=len(victim.tokens))
        if self.metrics is not None and freed:
            self._c_evict.inc(freed)
        self._observe()
        return freed

    def clear(self) -> int:
        """Drop every tree reference (shared pages survive in their other
        owners' hands).  Returns the number of page references released."""
        released = 0
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self.alloc.free(nd.pages)
            released += len(nd.pages)
        self.root = _Node(np.zeros((0,), np.int64), [], None)
        self.n_pages = 0
        self._observe()
        return released

    # -- reporting --------------------------------------------------------

    def stats(self) -> dict:
        n_nodes, n_a1 = 0, 0
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            n_nodes += 1
            n_a1 += len(nd.a1)
        out = {"cached_pages": self.n_pages, "nodes": n_nodes,
               "a1_entries": n_a1, "max_pages": self.max_pages}
        if self.metrics is not None:
            h, m = self._c_hit.value, self._c_miss.value
            out.update({
                "hits": h, "misses": m,
                "hit_rate": h / max(h + m, 1),
                "inserted_pages": self._c_ins.value,
                "evicted_pages": self._c_evict.value,
                "hit_tokens": {
                    "p50": self._h_hit_tokens.percentile(50),
                    "p99": self._h_hit_tokens.percentile(99),
                    "mean": self._h_hit_tokens.mean,
                    "count": self._h_hit_tokens.count,
                },
            })
        return out
