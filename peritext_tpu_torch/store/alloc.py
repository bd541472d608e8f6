"""Deterministic page allocator for the global element-page pool.

Two replicas that admit the same docs in the same order must build
IDENTICAL page tables, so allocation is a pure function of the request
sequence: lowest free page id first (a heap), no wall clock, no RNG, no
dependence on dict or set iteration order.

Page 0 is permanently reserved as the NULL page: page-table padding
entries point at it, gathers read zeros from it, and the paged apply
re-zeroes it after every scatter (ops/kernel.apply_batch_paged), so a
shared padding target can never carry state between docs.
"""

from __future__ import annotations

import heapq
from typing import Dict, List


class PoolExhausted(RuntimeError):
    """The allocator cannot satisfy a request and the pool may not grow
    further.  Carries the sizing facts a caller needs to decide between
    shedding and resizing."""

    def __init__(self, requested: int, free: int, total: int) -> None:
        self.requested = int(requested)
        self.free = int(free)
        self.total = int(total)
        super().__init__(
            f"page pool exhausted: requested {requested} page(s), "
            f"{free} free of {total} total"
        )


class PageAllocator:
    """Free-list allocator over ``total_pages`` fixed-size pages.

    ``pages_of(doc)`` returns the doc's pages in TABLE ORDER (page k of a
    doc backs slots ``[k*P, (k+1)*P)``), which is allocation order: the
    order is part of the deterministic contract.
    """

    def __init__(self, total_pages: int, reserved: int = 1) -> None:
        if total_pages <= reserved:
            raise ValueError(
                f"pool needs more than {reserved} page(s), got {total_pages}"
            )
        self.total_pages = int(total_pages)
        self.reserved = int(reserved)
        # heap of free page ids: pop order == sorted order (deterministic)
        self._free: List[int] = list(range(reserved, total_pages))
        heapq.heapify(self._free)
        self._pages: Dict[int, List[int]] = {}  # doc row -> page ids

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.total_pages - self.reserved - len(self._free)

    def pages_of(self, doc: int) -> List[int]:
        return list(self._pages.get(doc, ()))

    def num_pages(self, doc: int) -> int:
        return len(self._pages.get(doc, ()))

    def ensure(self, doc: int, num_pages: int) -> List[int]:
        """Grow ``doc``'s page table to ``num_pages`` entries (no-op when it
        already holds at least that many).  Returns the newly assigned page
        ids in allocation order.  Raises :class:`PoolExhausted` when the
        free list cannot cover the delta, atomically: a failed ensure
        assigns nothing."""
        held = self._pages.setdefault(doc, [])
        delta = int(num_pages) - len(held)
        if delta <= 0:
            return []
        if delta > len(self._free):
            raise PoolExhausted(delta, len(self._free), self.total_pages)
        fresh = [heapq.heappop(self._free) for _ in range(delta)]
        held.extend(fresh)
        return fresh

    def grow(self, new_total: int) -> int:
        """Extend the pool to ``new_total`` pages (the new ids join the free
        list); returns the number of pages added.  The device tensors grow
        in :class:`~.paged.PagedDocStore`; this is the bookkeeping half."""
        added = int(new_total) - self.total_pages
        if added <= 0:
            return 0
        for page in range(self.total_pages, int(new_total)):
            heapq.heappush(self._free, page)
        self.total_pages = int(new_total)
        return added
