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

Allocator invariants: the free list and the in-use set partition
``range(num_pages)``; releasing a page that is not in use raises; the
lowest free ids go first, so traces replay identically.

Refcounted page sharing, the radix-tree ``PrefixCache`` and
``BlockTables.cow`` come with prefix caching (ROADMAP Queue A item 6.5);
the pool's metrics hooks with the observability slice (item 8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
    >>> p.release([0])               # 1 page physically freed
    1
    >>> p.alloc(1)                   # lowest id first, freed ids reused
    [0]
    >>> p.high_water, p.total_reclaimed
    (2, 1)
    >>> p.alloc(3) is None           # only 2 free: the caller decides
    True
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"need at least one page, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.null_page = num_pages      # sink index (extra pool row)
        self._free: List[int] = list(range(num_pages))  # kept sorted
        self._used: set = set()
        self.high_water = 0             # max pages_in_use ever seen
        self.total_reclaimed = 0        # pages returned to the free list

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take the ``n`` lowest free page ids; None if the pool cannot
        satisfy the request (the caller decides: gate admission, or
        preempt)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self._used.update(pages)
        self.high_water = max(self.high_water, len(self._used))
        return pages

    def release(self, pages: Sequence[int]) -> int:
        """Return pages to the free list; returns how many.  Releasing a
        page that is not in use (a double free, or an id never handed
        out) raises: absorbing it would let two slots share KV rows."""
        for p in pages:
            if p not in self._used:
                raise ValueError(
                    f"release of page {p} which is not in use "
                    f"(double free, or never allocated)")
        if len(set(pages)) != len(pages):
            raise ValueError(f"release of duplicate pages {list(pages)}")
        self._used.difference_update(pages)
        self._free = sorted(self._free + list(pages))
        self.total_reclaimed += len(pages)
        return len(pages)

    def check(self) -> None:
        """Assert the partition invariant."""
        free, used = set(self._free), self._used
        assert not (free & used), f"page in both sets: {free & used}"
        assert free | used == set(range(self.num_pages)), \
            f"leaked pages: {set(range(self.num_pages)) - free - used}"
        assert len(self._free) == len(free), "duplicate ids on free list"


class BlockTables:
    """Per-slot block tables over one :class:`PagePool`.

    Owns the ``(n_slots, max_pages)`` int32 table handed to the decode step
    and the per-slot page lists behind it.  All layers share one table: a
    page id indexes the same row of every layer's pool.

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

    def assign(self, slot: int, tokens: int) -> Optional[List[int]]:
        """Allocate pages covering ``tokens`` rows for a freshly admitted
        slot (any previous assignment must already be released).  None if
        the pool cannot cover it."""
        assert slot not in self._slot_pages, \
            f"slot {slot} reassigned without release"
        pages = self.pool.alloc(pages_for(tokens, self.pool.page_size))
        if pages is None:
            return None
        self._slot_pages[slot] = pages
        self.table[slot, :] = self.pool.null_page
        self.table[slot, :len(pages)] = pages
        return pages

    def extend_to(self, slot: int, tokens: int) -> bool:
        """Grow a slot's table to cover ``tokens`` rows (decode append).
        False if the pool is exhausted: the caller preempts and retries."""
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
        """Return every page the slot holds (completion, cancellation or
        preemption); its table row reverts to the null sink.  Returns the
        number of pages freed."""
        pages = self._slot_pages.pop(slot, [])
        freed = self.pool.release(pages) if pages else 0
        self.table[slot, :] = self.pool.null_page
        return freed
