"""Page-pool allocator for paged-KV continuous batching (the port's own
copy of ``polyaxon_tpu/serving/paged.py``, semantics unchanged).

Host-side bookkeeping for the device-side paged cache
(``models/llama.py`` paged surface): a fixed pool of KV pages shared by
all slots, per-slot block tables mapping position//page_size → page id.
Memory then scales with tokens actually held instead of slots × max_len
reservations, so the pool can be oversubscribed (admission waits for
pages; a live row that cannot extend fails loudly rather than
corrupting a neighbour).

Cross-request KV reuse is a **radix tree over token prefixes**
(``RadixPrefixIndex``): tree nodes own runs of full pages keyed by the
token chain they hold, admission longest-prefix-matches the prompt
against the tree and adopts the matched pages by refcount, a
divergence *inside* a page forks copy-on-write (the partially-shared
page is duplicated once on device, at fork time, and the new branch
writes only its divergent tokens), and unreferenced tree pages stay
resident until allocation pressure LRU-evicts them from the tails of
the coldest branches. The engine skips prefill compute for every
matched token.

Page 0 is scratch — never allocated; idle rows and masked holes write
there (see ``paged_coords``). The allocator is plain numpy/ints on the
host: allocation happens between decode steps, never inside a kernel.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np


def _common(key: tuple, tokens, start: int, limit: int) -> int:
    """Length of the common prefix of ``key`` and ``tokens[start:]``,
    capped at ``limit - start`` total tokens."""
    n = min(len(key), max(limit - start, 0))
    j = 0
    while j < n and key[j] == tokens[start + j]:
        j += 1
    return j


class _RadixNode:
    """One edge of the prefix tree: a run of FULL pages and the token
    chain they hold (``len(key) == len(pages) * page_size`` always).
    Children are a list, not a first-token dict: a copy-on-write fork
    splits *inside* a page, so siblings may share up to page_size-1
    leading tokens — match picks the child with the longest agreement
    (a fully-matched first page always beats any partial sibling)."""

    __slots__ = ("key", "pages", "children", "parent", "last_used")

    def __init__(self, key: tuple, pages: list, parent: "_RadixNode"):
        self.key = key
        self.pages = pages
        self.children: list[_RadixNode] = []
        self.parent = parent
        self.last_used = 0


@dataclass
class AdmitResult:
    """What an admission reused. Truthy (admit() returns None on
    failure), so ``if pool.admit(...)`` keeps working for callers that
    only care about success."""

    matched_tokens: int = 0   # prefill positions already resident
    matched_pages: int = 0    # full pages adopted from the tree
    live_hits: int = 0        # ...of which were live in another slot
    cow: Optional[tuple] = None  # (src_page, dst_page) device copy, or None


class RadixPrefixIndex:
    """Token-prefix radix tree whose nodes own page runs. Pure host
    bookkeeping — refcounts live in the PagePool; the tree only says
    which pages hold which token chains and how recently each branch
    mattered (the LRU clock is a monotonic touch counter)."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _RadixNode((), [], None)
        self._page_owner: dict[int, _RadixNode] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._page_owner)

    def owns(self, page: int) -> bool:
        return page in self._page_owner

    def _touch(self) -> int:
        self._clock += 1
        return self._clock

    def _nodes(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children)

    def n_nodes(self) -> int:
        return sum(1 for n in self._nodes() if n is not self.root)

    def match(self, tokens, limit: int, touch: bool = True):
        """Longest-prefix match of ``tokens[:limit]`` against the tree:
        (full_pages, cow) where ``full_pages`` are entirely-matched tree
        pages in chain order and ``cow`` is ``(src_page, m)`` when the
        divergence lands ``m`` tokens INTO the next page (fork point for
        copy-on-write) — None when it falls on a page boundary."""
        ps = self.page_size
        node = self.root
        i = 0
        pages: list[int] = []
        cow = None
        while True:
            best, bj = None, 0
            for child in node.children:
                j = _common(child.key, tokens, i, limit)
                if j > bj:
                    best, bj = child, j
            if best is None or bj == 0:
                break
            full = bj // ps
            pages.extend(best.pages[:full])
            if touch:
                best.last_used = self._touch()
            rem = bj - full * ps
            if rem == 0 and bj == len(best.key) and i + bj < limit:
                node = best
                i += bj
                continue
            if rem > 0:
                cow = (best.pages[full], rem)
            break
        return pages, cow

    def insert(self, tokens, pages: list) -> Optional[_RadixNode]:
        """Register a completed chain (``len(tokens) == len(pages) *
        page_size``). Existing nodes win on overlap (first-wins — the
        caller adopted matched pages at admission, so the overlap IS
        those pages); a mid-node join splits the node at the page
        boundary. Returns the ONE new leaf holding the chain's novel
        pages (None when the chain is already fully present) — the
        caller keeps it as the slot's fresh-leaf marker so a failed
        prefill can detach exactly the pages it never wrote."""
        ps = self.page_size
        node = self.root
        i, ti = 0, 0
        limit = len(tokens)
        while i < limit:
            best, bj = None, 0
            for child in node.children:
                j = _common(child.key, tokens, i, limit)
                if j > bj:
                    best, bj = child, j
            if best is None or bj == 0:
                break
            full = bj // ps
            if bj == len(best.key) and bj % ps == 0:
                node = best
                i += bj
                ti += len(best.pages)
                continue
            if full == 0:
                break  # diverges inside the child's first page: sibling
            node = self._split(best, full)
            i += full * ps
            ti += full
            break
        if ti >= len(pages):
            return None
        leaf = _RadixNode(tuple(tokens[i:]), list(pages[ti:]), node)
        leaf.last_used = self._touch()
        node.children.append(leaf)
        for page in leaf.pages:
            self._page_owner[page] = leaf
        return leaf

    def _split(self, node: _RadixNode, at_pages: int) -> _RadixNode:
        """Split ``node`` after its first ``at_pages`` pages; returns
        the (upper) prefix node. Page-aligned by construction."""
        ps = self.page_size
        suffix = _RadixNode(node.key[at_pages * ps:],
                            node.pages[at_pages:], node)
        suffix.children = node.children
        for child in suffix.children:
            child.parent = suffix
        suffix.last_used = node.last_used
        for page in suffix.pages:
            self._page_owner[page] = suffix
        node.key = node.key[:at_pages * ps]
        node.pages = node.pages[:at_pages]
        node.children = [suffix]
        return node

    def detach(self, leaf: _RadixNode) -> list[int]:
        """Unregister a fresh leaf (failed admission: its pages were
        never written by a completed prefill). Returns the pages the
        tree no longer owns."""
        if leaf.parent is not None and leaf in leaf.parent.children:
            leaf.parent.children.remove(leaf)
        for page in leaf.pages:
            self._page_owner.pop(page, None)
        pages, leaf.pages, leaf.key = leaf.pages, [], ()
        return pages

    def evict_one(self, ref: np.ndarray) -> Optional[int]:
        """Pop ONE unreferenced page from the tail of the
        least-recently-used evictable leaf (evicting a middle page
        would break the chain; a page a live slot still references is
        never a candidate). None = nothing evictable right now."""
        best = None
        for node in self._nodes():
            if node is self.root or node.children or not node.pages:
                continue
            if ref[node.pages[-1]] != 0:
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        if best is None:
            return None
        page = best.pages.pop()
        best.key = best.key[:len(best.pages) * self.page_size]
        del self._page_owner[page]
        if not best.pages and best.parent is not None:
            best.parent.children.remove(best)
        return page

    def reclaimable(self, ref: np.ndarray) -> int:
        """How many tree pages repeated ``evict_one`` calls could free
        right now: pages in maximal all-unreferenced suffixes of the
        tree (a ref==0 page buried under a live descendant is resident
        but NOT reclaimable — admission planning must not count it)."""

        def visit(node: _RadixNode):
            count, kids_clean = 0, True
            for child in node.children:
                sub, clean = visit(child)
                count += sub
                kids_clean = kids_clean and clean
            if not kids_clean:
                return count, False
            i = len(node.pages)
            while i > 0 and ref[node.pages[i - 1]] == 0:
                i -= 1
                count += 1
            return count, i == 0

        return visit(self.root)[0]


class PagePool:
    def __init__(self, slots: int, max_len: int, page_size: int,
                 n_pages: int, prefix_cache: bool = True):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.max_pages_per_row = -(-max_len // page_size)
        # Page 0 is scratch: usable pages are 1..n_pages-1.
        if n_pages < 2:
            raise ValueError(f"kv pool needs >= 2 pages, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))
        self.tables = np.full((slots, self.max_pages_per_row), -1, np.int32)
        self.prefix_cache = prefix_cache
        self._ref = np.zeros(n_pages, np.int32)
        self._index = RadixPrefixIndex(page_size) if prefix_cache else None
        # The ONE leaf each slot's admission added to the tree — the
        # only pages a failed prefill must forget (matched pages hold
        # content from COMPLETED prefills and stay shareable).
        self._fresh_leaf: dict[int, _RadixNode] = {}
        # Guards every structure above: the engine loop allocates
        # between decode steps while HTTP threads read stats/invariants.
        self._lock = threading.Lock()
        self._reclaim_cache: Optional[int] = None
        self.prefix_hits = 0        # full pages adopted from the tree
        self.prefix_misses = 0      # shareable pages with no chain match
        self.prefix_hits_live = 0   # adopted pages live in another slot
        self.cow_forks = 0          # mid-page divergences forked
        self.cached_tokens_total = 0  # prefill tokens served from cache
        self.prefix_evictions = 0   # resident pages reclaimed under pressure

    @classmethod
    def dense_equivalent(cls, slots: int, max_len: int, page_size: int,
                         prefix_cache: bool = True) -> "PagePool":
        """Pool sized to the dense engine's reservation (+ scratch)."""
        maxp = -(-max_len // page_size)
        return cls(slots, max_len, page_size, slots * maxp + 1,
                   prefix_cache=prefix_cache)

    # ------------------------------------------------------------ sizing
    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free + tree pages reclaimable by
        LRU eviction right now (resident pages pinned under a live
        branch do NOT count — admission must not plan against them)."""
        with self._lock:
            return len(self._free) + self._reclaimable_locked()

    def _reclaimable_locked(self) -> int:
        if self._index is None:
            return 0
        if self._reclaim_cache is None:
            self._reclaim_cache = self._index.reclaimable(self._ref)
        return self._reclaim_cache

    def pages_for(self, length: int) -> int:
        return -(-max(length, 1) // self.page_size)

    def utilization(self) -> dict:
        """Pool occupancy in the user's units (usable pages — the
        scratch page is internal): the engine-tick gauges and /v1/stats
        both read this one snapshot. `free` counts allocatable pages,
        so reclaimable resident prefix pages land there."""
        total = self.n_pages - 1
        free = self.free_pages
        used = max(total - free, 0)
        return {"total": total, "used": used, "free": free,
                "fraction": round(used / total, 4) if total else 0.0}

    def radix_stats(self) -> dict:
        """Tree shape for the serving gauges: node count plus pages by
        state (referenced = a live slot holds them too, resident =
        retired-but-shareable)."""
        with self._lock:
            if self._index is None:
                return {"nodes": 0, "pages": 0, "referenced": 0,
                        "resident": 0}
            pages = list(self._index._page_owner)
            referenced = sum(1 for p in pages if self._ref[p] > 0)
            return {"nodes": self._index.n_nodes(), "pages": len(pages),
                    "referenced": referenced,
                    "resident": len(pages) - referenced}

    # ---------------------------------------------------------- planning
    def _match_locked(self, length: int, tokens, touch: bool):
        """(full_pages, cow) the tree offers for this prompt. Only the
        PREFILL positions 0..length-2 are matchable: the decode write
        at length-1 needs a private page regardless."""
        if self._index is None or tokens is None:
            return [], None
        return self._index.match(tokens, length - 1, touch=touch)

    def _plan_locked(self, length: int, tokens) -> int:
        """Allocatable units this admission consumes: adopted pages
        LIVE in another slot cost nothing; adopted resident pages cost
        at most their own reclaim slot (charged 1 — conservative) and
        every miss/CoW/private page costs one fresh allocation."""
        matched, _ = self._match_locked(length, tokens, touch=False)
        live = sum(1 for p in matched if self._ref[p] > 0)
        return self.pages_for(length) - live

    def can_admit(self, length: int, tokens=None) -> bool:
        with self._lock:
            return (self._plan_locked(length, tokens)
                    <= len(self._free) + self._reclaimable_locked())

    def peek_matched_tokens(self, length: int, tokens=None) -> int:
        """How many prefill tokens the radix tree would serve for this
        prompt — the cache-aware admission score. Read-only: no LRU
        touch, no allocation."""
        with self._lock:
            matched, cow = self._match_locked(length, tokens, touch=False)
            return len(matched) * self.page_size + (cow[1] if cow else 0)

    def slot_pages(self, slot: int) -> int:
        """Pages mapped into this slot's row, its live KV footprint (the
        preemption policy evicts the slot holding the most)."""
        with self._lock:
            return int(np.count_nonzero(self.tables[slot] >= 0))

    # -------------------------------------------------------- allocation
    def _alloc_one_locked(self):
        """One page: free list first, then evict the LRU reclaimable
        prefix page. None = pool genuinely dry."""
        if self._free:
            return self._free.pop()
        if self._index is not None:
            page = self._index.evict_one(self._ref)
            if page is not None:
                self.prefix_evictions += 1
                self._reclaim_cache = None
                return page
        return None

    def admit(self, slot: int, length: int,
              tokens: Optional[list] = None) -> Optional[AdmitResult]:
        """Allocate pages covering positions 0..length-1 for ``slot``.
        With ``tokens`` (the full prompt) and the prefix cache on, the
        prompt longest-prefix-matches the radix tree: fully-matched
        pages are adopted by refcount (their KV is already written — the
        engine skips their prefill compute), a mid-page divergence
        reports a copy-on-write pair for the engine to duplicate on
        device, and the remaining novel full-page chain is registered
        as ONE fresh tree leaf (invalidated if the prefill never runs).
        None = nothing allocated (the request should wait).

        Page i is shareable iff fully inside the prefill range: the
        decode write at length-1 (and everything after) must land on
        private pages."""
        with self._lock:
            need = self.pages_for(length)
            row = self.tables[slot]
            assert (row < 0).all(), \
                f"slot {slot} admitted while still holding pages"
            matched, cow_src = self._match_locked(length, tokens, touch=True)
            live = sum(1 for p in matched if self._ref[p] > 0)
            if need - live > len(self._free) + self._reclaimable_locked():
                return None
            self._reclaim_cache = None
            for i, page in enumerate(matched):
                row[i] = page
                self._ref[page] += 1
            fresh_start = len(matched)
            for i in range(fresh_start, need):
                page = self._alloc_one_locked()
                if page is None:
                    # _plan said this fits, so this branch is belt-and-
                    # braces against accounting drift: roll back cleanly
                    # rather than corrupt the row.
                    self._release_locked(slot, invalidate_prefix=True)
                    return None
                row[i] = page
                self._ref[page] += 1
            result = AdmitResult(matched_pages=len(matched), live_hits=live)
            m_extra = 0
            if cow_src is not None:
                # Fork point inside page `fresh_start`: the engine
                # copies src → dst once, then the suffix prefill writes
                # only the divergent tokens into the private copy.
                src, m_extra = cow_src
                result.cow = (src, int(row[fresh_start]))
                self.cow_forks += 1
            result.matched_tokens = (len(matched) * self.page_size
                                     + m_extra)
            self.prefix_hits += len(matched)
            self.prefix_hits_live += live
            self.cached_tokens_total += result.matched_tokens
            shareable = 0
            if self._index is not None and tokens is not None:
                shareable = min((length - 1) // self.page_size, need)
            self.prefix_misses += max(shareable - len(matched), 0)
            if shareable > len(matched):
                leaf = self._index.insert(
                    tuple(tokens[:shareable * self.page_size]),
                    [int(p) for p in row[:shareable]])
                if leaf is not None:
                    self._fresh_leaf[slot] = leaf
            return result

    def ensure(self, slot: int, pos: int) -> bool:
        """Make position ``pos`` writable for ``slot`` (allocating its
        page if new). False = pool exhausted; the row keeps its pages."""
        with self._lock:
            idx = pos // self.page_size
            if idx >= self.max_pages_per_row:
                return False
            if self.tables[slot, idx] >= 0:
                return True
            page = self._alloc_one_locked()
            if page is None:
                return False
            self.tables[slot, idx] = page
            self._ref[page] += 1
            return True

    # ----------------------------------------------------------- handoff
    def handoff(self, src_slot: int, dst_slot: int) -> int:
        """Transfer ownership of ``src_slot``'s pages to ``dst_slot``
        (prefill lane → decode lane). Pure bookkeeping: the block-table
        row moves, the fresh-leaf marker follows, and refcounts are
        untouched (the pages appear in exactly one row before and after,
        so ``check_invariants`` holds across the boundary). Returns the
        number of pages transferred."""
        with self._lock:
            dst = self.tables[dst_slot]
            assert (dst < 0).all(), \
                f"handoff into slot {dst_slot} which still holds pages"
            src = self.tables[src_slot]
            dst[:] = src
            src[:] = -1
            leaf = self._fresh_leaf.pop(src_slot, None)
            if leaf is not None:
                self._fresh_leaf[dst_slot] = leaf
            return int((dst >= 0).sum())

    # ----------------------------------------------------------- release
    def commit_prefix(self, slot: int) -> None:
        """The slot's prefill completed: its fresh tree leaf now holds
        real KV content and survives the slot (drop the invalidation
        marker)."""
        with self._lock:
            self._fresh_leaf.pop(slot, None)

    def release(self, slot: int, invalidate_prefix: bool = False) -> None:
        """Drop the slot's references. A page at refcount 0 returns to
        the free list — unless the radix tree owns it, in which case it
        stays resident (LRU-evicted only under allocation pressure) so
        the next matching prompt reuses its KV.

        ``invalidate_prefix``: the slot's admission failed before its
        prefill wrote the pages — detach the ONE fresh leaf this slot
        registered (pages it merely adopted carry content from
        completed prefills and stay shareable)."""
        with self._lock:
            self._release_locked(slot, invalidate_prefix)

    def _release_locked(self, slot: int, invalidate_prefix: bool) -> None:
        leaf = self._fresh_leaf.pop(slot, None)
        if invalidate_prefix and leaf is not None and self._index is not None:
            self._index.detach(leaf)
        row = self.tables[slot]
        for idx in np.flatnonzero(row >= 0):
            page = int(row[idx])
            self._ref[page] -= 1
            if self._ref[page] <= 0:
                self._ref[page] = 0
                if self._index is None or not self._index.owns(page):
                    self._free.append(page)
        row[:] = -1
        self._reclaim_cache = None

    def invalidate_prefix_cache(self) -> None:
        """Forget the whole tree (device cache rebuilt → its content is
        gone). Unreferenced resident pages return to the free list;
        pages still referenced by live rows keep their allocation but
        lose their shareability (they free normally at release)."""
        with self._lock:
            if self._index is None:
                return
            for page in list(self._index._page_owner):
                if self._ref[page] == 0:
                    self._free.append(page)
            self._index = RadixPrefixIndex(self.page_size)
            self._fresh_leaf.clear()
            self._reclaim_cache = None

    # -------------------------------------------------------- invariants
    def check_invariants(self) -> list[str]:
        """Refcount/CoW bookkeeping cross-check (chaos tests and the CI
        radix smoke assert this stays empty): every usable page is free
        XOR referenced XOR resident-in-tree, refcounts equal block-table
        occurrences, the tree's shape is consistent, and scratch page 0
        is never allocated anywhere."""
        out = []
        with self._lock:
            counts = np.bincount(
                self.tables[self.tables >= 0].ravel(),
                minlength=self.n_pages)
            if counts[0]:
                out.append("scratch page 0 appears in a block table")
            if 0 in self._free:
                out.append("scratch page 0 on the free list")
            if len(set(self._free)) != len(self._free):
                out.append("duplicate pages on the free list")
            free = set(self._free)
            owned = set(self._index._page_owner) if self._index else set()
            if self._index is not None and 0 in owned:
                out.append("scratch page 0 owned by the radix tree")
            for page in range(1, self.n_pages):
                ref = int(self._ref[page])
                if ref != int(counts[page]):
                    out.append(f"page {page}: ref {ref} != "
                               f"{int(counts[page])} table occurrences")
                in_free = page in free
                if in_free and ref > 0:
                    out.append(f"page {page}: on free list with ref {ref}")
                if in_free and page in owned:
                    out.append(f"page {page}: on free list AND tree-owned")
                if ref == 0 and not in_free and page not in owned:
                    out.append(f"page {page}: leaked (ref 0, not free, "
                               "not tree-resident)")
            if self._index is not None:
                seen: set[int] = set()
                for node in self._index._nodes():
                    if node is self._index.root:
                        continue
                    if len(node.key) != len(node.pages) * self.page_size:
                        out.append("radix node key/page length mismatch")
                    if not node.pages:
                        out.append("empty radix node left attached")
                    for child in node.children:
                        if child.parent is not node:
                            out.append("radix child/parent link broken")
                    for page in node.pages:
                        if page in seen:
                            out.append(f"page {page}: owned by two nodes")
                        seen.add(page)
                        if self._index._page_owner.get(page) is not node:
                            out.append(f"page {page}: owner map disagrees "
                                       "with node membership")
                if seen != owned:
                    out.append("owner map and tree pages diverge")
                for slot, leaf in self._fresh_leaf.items():
                    node = leaf
                    while node.parent is not None:
                        node = node.parent
                    if node is not self._index.root:
                        out.append(f"slot {slot}: fresh leaf detached "
                                   "from the tree")
        return out

    def padded_row(self, slot: int) -> np.ndarray:
        """The slot's block-table row (fixed [max_pages_per_row])."""
        return self.tables[slot]
