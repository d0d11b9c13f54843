"""Paged KV cache bookkeeping: a global page pool and per-slot block
tables (counterpart of ``repro/serving/kvpool.py``).

The dense engine reserves ``max_len`` KV rows per slot up front.  The
paged engine instead keeps, per attention layer, one **pool** of
``num_pages`` pages of ``page_size`` token rows shared by every slot, and a
per-slot **block table**: position ``t`` of slot ``b`` lives at row
``t % page_size`` of page ``block_table[b, t // page_size]``.  A slot holds
pages only for tokens it has produced; completion, EOS, cancellation and
preemption return them at once.

Everything here is host-side Python and numpy: page ids are decided on the
host and handed to the decode step as a ``(B, max_pages)`` int32 table.
Entries past a slot's allocation point at the pool's **null page** (index
``num_pages``; the pool tensors carry one extra sink page), so every entry
is a valid index; per-slot length masking makes the sink unreachable as
attention history.

Pages are **refcounted**, so prefix caching can point several block
tables and the :class:`PrefixCache` radix tree at one physical page:
``alloc`` hands out pages at refcount 1, ``share`` takes one more
reference and ``release`` drops one; a page returns to the free list
(and counts toward ``total_reclaimed``) only when its last reference
goes.  A slot about to write into a shared page copies it first
(:meth:`BlockTables.cow`).  References are **live** (a block table's) or
**cache** (``share(..., cache=True)``, the radix tree's);
``pages_in_use`` and ``high_water`` count pages with a live reference,
``pages_resident`` cache-only (idle, evictable) pages too.

Allocator invariants: the free list and the in-use set partition
``range(num_pages)``; every in-use page has a refcount >= 1; releasing a
page that is not in use raises; the lowest free ids go first, so traces
replay identically.  ``bind_metrics`` mirrors the accounting into an obs
registry.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV rows.

    >>> pages_for(1, 16), pages_for(16, 16), pages_for(17, 16)
    (1, 1, 2)
    >>> pages_for(0, 16)
    0
    """
    return -(-tokens // page_size)


class PagePool:
    """Fixed-capacity page allocator with deterministic id order.

    >>> p = PagePool(num_pages=4, page_size=16)
    >>> p.alloc(2)
    [0, 1]
    >>> (p.free_pages, p.pages_in_use)
    (2, 2)
    >>> p.release([0])               # last ref -> 1 page physically freed
    1
    >>> p.alloc(1)                   # lowest id first, freed ids reused
    [0]
    >>> p.high_water
    2
    >>> p.share([1]); p.refcount(1)  # second reference: still one page
    2
    >>> p.release([1]), p.pages_in_use, p.total_reclaimed
    (0, 2, 1)
    >>> p.release([1]), p.pages_in_use, p.total_reclaimed  # last ref
    (1, 1, 2)
    """

    def __init__(self, num_pages: int, page_size: int,
                 reclaimer: Optional[Callable[[int], int]] = None):
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.null_page = num_pages      # sink index (extra pool row)
        self._free: List[int] = list(range(num_pages))  # kept sorted
        self._used: set = set()
        self._ref: Dict[int, int] = {}        # page id -> all references
        self._cache_ref: Dict[int, int] = {}  # page id -> cache refs only
        self._n_live = 0                # pages with >= 1 non-cache ref
        self.high_water = 0             # max pages_in_use ever seen
        self.total_reclaimed = 0        # physical pages returned, counted
        #                                 once at the *last* release
        self.reclaimer = reclaimer      # optional shortfall hook: called
        #                                 with the deficit before alloc
        #                                 gives up (prefix-cache eviction)
        self._g_in_use = None           # bound obs gauge (bind_metrics)
        self._c_reclaimed = None

    def bind_metrics(self, registry) -> None:
        """Mirror the pool's accounting into an obs registry: the
        ``kvpool.pages_in_use`` gauge (its high-water is the
        ``pages_hwm`` figure) and the ``kvpool.pages_reclaimed``
        counter track every alloc/release from here on."""
        self._g_in_use = registry.gauge(
            "kvpool.pages_in_use", "KV pages currently allocated")
        self._c_reclaimed = registry.counter(
            "kvpool.pages_reclaimed", "KV pages returned to the pool")
        self._g_in_use.set(self._n_live)

    # -- accounting ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        """Pages bound to at least one live (non-cache) reference."""
        return self._n_live

    @property
    def pages_resident(self) -> int:
        """Pages physically allocated, cache-idle ones included."""
        return len(self._used)

    def fits(self, n: int) -> bool:
        return n <= len(self._free)

    def refcount(self, page: int) -> int:
        """All references on ``page`` (0 if free / never allocated)."""
        return self._ref.get(page, 0)

    def _note_live(self) -> None:
        self.high_water = max(self.high_water, self._n_live)
        if self._g_in_use is not None:
            self._g_in_use.set(self._n_live)

    # -- alloc / share / release --------------------------------------------

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take the ``n`` lowest free page ids at refcount 1; None if the
        pool cannot satisfy the request (caller decides: gate admission,
        or preempt).  If a ``reclaimer`` hook is set it is offered the
        shortfall first (prefix-cache eviction runs before the caller
        ever sees failure)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) and self.reclaimer is not None:
            self.reclaimer(n - len(self._free))
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self._used.update(pages)
        for p in pages:
            self._ref[p] = 1
        self._n_live += len(pages)
        self._note_live()
        return pages

    def share(self, pages: Sequence[int], cache: bool = False) -> None:
        """Take one more reference on each page: a live one (block-table
        sharing) or, with ``cache=True``, a cache-residency one (the
        radix tree's — which does not count toward ``pages_in_use``).
        Sharing a free page is the same class of bug as double-free and
        raises."""
        for p in pages:
            if p not in self._used:
                raise ValueError(
                    f"share of page {p} which is not in use")
        for p in pages:
            if cache:
                self._cache_ref[p] = self._cache_ref.get(p, 0) + 1
            elif self._ref[p] == self._cache_ref.get(p, 0):
                self._n_live += 1       # idle page gains a live referent
            self._ref[p] += 1
        self._note_live()

    def release(self, pages: Sequence[int], cache: bool = False) -> int:
        """Drop one reference per page (``cache=True`` drops a cache
        ref); pages whose last reference goes return to the free list.
        Returns the number of pages physically freed —
        ``total_reclaimed`` and the ``pages_reclaimed`` counter advance
        by that (physical pages once, not per-referencing-slot).
        Double-free (or freeing a never-allocated id) raises — that is a
        bookkeeping bug upstream, and silently absorbing it would let
        two slots clobber each other's KV."""
        for p in pages:
            if p not in self._used:
                raise ValueError(
                    f"release of page {p} which is not in use "
                    f"(double free, or never allocated)")
            if cache and self._cache_ref.get(p, 0) < 1:
                raise ValueError(
                    f"cache release of page {p} which holds no cache ref")
        freed = []
        for p in pages:
            self._ref[p] -= 1
            if cache:
                self._cache_ref[p] -= 1
                if self._cache_ref[p] == 0:
                    del self._cache_ref[p]
            elif self._ref[p] == self._cache_ref.get(p, 0):
                self._n_live -= 1       # last live referent gone
            if self._ref[p] == 0:
                del self._ref[p]
                self._used.remove(p)
                freed.append(p)
        self._free = sorted(self._free + freed)
        self.total_reclaimed += len(freed)
        self._note_live()
        if self._c_reclaimed is not None and freed:
            self._c_reclaimed.inc(len(freed))
        return len(freed)

    def check(self) -> None:
        """Assert the partition + refcount invariants (property test)."""
        free, used = set(self._free), self._used
        assert not (free & used), f"page in both sets: {free & used}"
        assert free | used == set(range(self.num_pages)), \
            f"leaked pages: {set(range(self.num_pages)) - free - used}"
        assert len(self._free) == len(free), "duplicate ids on free list"
        assert set(self._ref) == used, \
            f"refcount map out of sync: {set(self._ref) ^ used}"
        assert all(r >= 1 for r in self._ref.values()), \
            "in-use page with refcount < 1"
        assert all(self._cache_ref.get(p, 0) <= r
                   for p, r in self._ref.items()), \
            "cache refs exceed total refs"
        live = sum(1 for p, r in self._ref.items()
                   if r > self._cache_ref.get(p, 0))
        assert live == self._n_live, \
            f"live-page count out of sync: {live} != {self._n_live}"


class BlockTables:
    """Per-slot block tables over one :class:`PagePool`.

    Owns the ``(n_slots, max_pages)`` int32 table handed to the compiled
    decode step and the per-slot page lists behind it.  All layers share
    one table: a page id indexes the same row of every layer's pool
    (the pools are allocated congruently), so the allocator runs once
    per sequence, not once per layer.

    >>> bt = BlockTables(PagePool(num_pages=6, page_size=4), 2, 3)
    >>> bt.assign(0, 5), bt.assign(1, 4)       # 5 rows: 2 pages
    ([0, 1], [2])
    >>> bt.extend_to(1, 5), bt.table[1].tolist()
    (True, [2, 3, 6])
    >>> bt.release(0), bt.table[0].tolist()    # row back to the sink
    (2, [6, 6, 6])
    """

    def __init__(self, pool: PagePool, n_slots: int, max_pages: int):
        self.pool = pool
        self.max_pages = max_pages
        self.table = np.full((n_slots, max_pages), pool.null_page, np.int32)
        self._slot_pages: Dict[int, List[int]] = {}

    def slot_pages(self, slot: int) -> List[int]:
        return self._slot_pages.get(slot, [])

    def assign(self, slot: int, tokens: int,
               shared: Optional[List[int]] = None) -> Optional[List[int]]:
        """Allocate pages covering ``tokens`` rows for a freshly admitted
        slot (any previous assignment must already be released).  None
        if the pool cannot cover it.

        ``shared`` is a prefix-cache hit: page ids the caller *already
        holds a reference to* (pinned via :meth:`PagePool.share`); the
        slot takes ownership of those references and only the unshared
        suffix is freshly allocated.  On failure the shared references
        are left untouched (caller unpins)."""
        assert slot not in self._slot_pages, \
            f"slot {slot} reassigned without release"
        shared = list(shared or [])
        need = pages_for(tokens, self.pool.page_size) - len(shared)
        assert need >= 0, f"shared prefix longer than {tokens} tokens"
        suffix = self.pool.alloc(need)
        if suffix is None:
            return None
        pages = shared + suffix
        self._slot_pages[slot] = pages
        self.table[slot, :] = self.pool.null_page
        self.table[slot, :len(pages)] = pages
        return pages

    def cow(self, slot: int, page_idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: make the slot's ``page_idx``-th page exclusively
        owned before a KV write lands in it.  Returns ``(src, dst)`` —
        equal when the page was already exclusive (no copy needed),
        distinct when a fresh page was allocated (the caller must copy
        the pool rows ``src -> dst`` before writing).  None if the pool
        cannot supply the copy (caller preempts)."""
        pages = self._slot_pages.get(slot)
        assert pages is not None, f"cow of unassigned slot {slot}"
        src = pages[page_idx]
        if self.pool.refcount(src) == 1:
            return src, src
        got = self.pool.alloc(1)
        if got is None:
            return None
        dst = got[0]
        self.pool.release([src])        # drop our ref; sharers keep theirs
        pages[page_idx] = dst
        self.table[slot, page_idx] = dst
        return src, dst

    def extend_to(self, slot: int, tokens: int) -> bool:
        """Grow a slot's table to cover ``tokens`` rows (decode append).
        False if the pool is exhausted — caller preempts and retries."""
        pages = self._slot_pages.get(slot)
        assert pages is not None, f"extend of unassigned slot {slot}"
        need = pages_for(tokens, self.pool.page_size) - len(pages)
        if need <= 0:
            return True
        if len(pages) + need > self.max_pages:
            raise ValueError(
                f"slot {slot} wants {len(pages) + need} pages "
                f"> max_pages={self.max_pages}")
        got = self.pool.alloc(need)
        if got is None:
            return False
        self.table[slot, len(pages):len(pages) + need] = got
        pages.extend(got)
        return True

    def release(self, slot: int) -> int:
        """Drop the slot's reference on every page it holds (completion /
        preemption); its table row reverts to the null sink.  Shared
        pages survive for their other referents (radix tree or sibling
        slots) — preempting one sharer must not free the other's pages.
        Returns the number of pages *physically* freed."""
        pages = self._slot_pages.pop(slot, [])
        freed = self.pool.release(pages) if pages else 0
        self.table[slot, :] = self.pool.null_page
        return freed


class _RadixNode:
    """One page-granular radix-tree node: ``key`` is the tuple of
    ``page_size`` token ids this page holds, ``page`` the physical pool
    page, ``payload`` an opaque caller sidecar (the engine stores the
    full-precision KV rows there), ``stamp`` the LRU clock."""

    __slots__ = ("key", "page", "payload", "children", "parent", "stamp")

    def __init__(self, key, page, payload, parent, stamp):
        self.key = key
        self.page = page
        self.payload = payload
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.parent = parent
        self.stamp = stamp


class PrefixCache:
    """Radix tree over token-id prefixes, page-granular, LRU-evicted.

    Each node maps one *full page* of token ids to a resident pool page;
    the tree holds its own :meth:`PagePool.share` reference per cached
    page, so cached pages survive the owning slot's release and are only
    reclaimed by :meth:`evict` (LRU leaves whose refcount shows no other
    referent).  Eviction is leaf-first, so an interior node never
    outlives a descendant — a cached prefix is always reachable from the
    root by whole pages.

    >>> pool = PagePool(num_pages=4, page_size=2)
    >>> tree = PrefixCache(pool)
    >>> pages = pool.alloc(2)                    # a slot's prompt pages
    >>> tree.insert([1, 2, 3, 4], pages, [None, None])
    2
    >>> tree.lookup([1, 2, 3, 4, 5])[0]          # partial tail ignored
    [0, 1]
    >>> tree.lookup([1, 2, 9, 9])[0]             # diverges after page 0
    [0]
    >>> _ = pool.release(pages)                  # slot done; tree keeps
    >>> (pool.pages_in_use, pool.pages_resident, tree.evictable())
    (0, 2, 2)
    >>> tree.evict(1)                            # LRU leaf goes first
    1
    >>> (tree.lookup([1, 2, 3, 4])[0], pool.pages_resident)
    ([0], 1)
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _RadixNode(None, None, None, None, 0)
        self._clock = 0                 # monotonic LRU stamp (no wall time)
        self.nodes = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens) -> List[tuple]:
        ps = self.page_size
        toks = [int(t) for t in tokens]
        return [tuple(toks[i:i + ps])
                for i in range(0, len(toks) - len(toks) % ps, ps)]

    def lookup(self, tokens, max_pages: Optional[int] = None
               ) -> Tuple[List[int], List[object]]:
        """Longest cached page-aligned prefix of ``tokens``: returns the
        (pages, payloads) of the matched chain, at most ``max_pages``
        deep.  Touches the matched nodes' LRU stamps."""
        pages: List[int] = []
        payloads: List[object] = []
        node, stamp = self.root, self._tick()
        for key in self._keys(tokens):
            if max_pages is not None and len(pages) >= max_pages:
                break
            node = node.children.get(key)
            if node is None:
                break
            node.stamp = stamp
            pages.append(node.page)
            payloads.append(node.payload)
        return pages, payloads

    def insert(self, tokens, pages: Sequence[int],
               payloads: Sequence[object]) -> int:
        """Cache the full-page prefix of ``tokens`` backed by ``pages``
        (the inserting slot's pages, one per full page).  The tree takes
        its own pool reference on each *newly* cached page; pages whose
        prefix is already resident are skipped (the existing node wins,
        so concurrent identical prompts converge).  Returns the number
        of nodes added."""
        keys = self._keys(tokens)
        assert len(pages) >= len(keys) and len(payloads) >= len(keys), \
            f"{len(keys)} full pages need backing pages/payloads"
        node, stamp, added = self.root, self._tick(), 0
        for key, page, payload in zip(keys, pages, payloads):
            child = node.children.get(key)
            if child is None:
                self.pool.share([page], cache=True)
                child = _RadixNode(key, page, payload, node, stamp)
                node.children[key] = child
                self.nodes += 1
                added += 1
            else:
                child.stamp = stamp
            node = child
        return added

    def _leaves(self) -> List[_RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evictable(self) -> int:
        """How many cached pages :meth:`evict` could free right now —
        the full leaf-first cascade of nodes whose page has no referent
        besides the tree (refcount 1)."""

        def count(n: _RadixNode) -> Tuple[int, bool]:
            total, all_gone = 0, True
            for c in n.children.values():
                t, gone = count(c)
                total += t
                all_gone = all_gone and gone
            if n is self.root:
                return total, all_gone
            if all_gone and self.pool.refcount(n.page) == 1:
                return total + 1, True
            return total, False

        return count(self.root)[0]

    def evict(self, n: int) -> int:
        """Free up to ``n`` cached pages, least-recently-touched leaves
        first (evicting a leaf may expose its parent next round).  Nodes
        whose page is still referenced by a slot (refcount > 1) are
        pinned and skipped.  Returns pages actually freed."""
        freed = 0
        while freed < n:
            victims = [lf for lf in self._leaves()
                       if self.pool.refcount(lf.page) == 1]
            if not victims:
                break
            leaf = min(victims, key=lambda lf: lf.stamp)
            del leaf.parent.children[leaf.key]
            self.nodes -= 1
            freed += self.pool.release([leaf.page], cache=True)
        return freed
