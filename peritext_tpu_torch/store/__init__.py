"""Paged document storage: the element planes in a pool of fixed-size pages.

The padded ``(D docs x S slots)`` layout pays the widest doc's width for
every doc.  This package keeps the element planes in a device pool of
fixed-size pages plus a per-doc page table instead, so memory and device
work scale with each doc's own size.

* :mod:`.alloc`: :class:`PageAllocator`, deterministic (lowest free page
  id first), and the typed :class:`PoolExhausted` error.
* :mod:`.paged`: :class:`PagedDocStore`, the pool on the device, the page
  tables, the dense per-doc aux rows, and the gather/apply/scatter
  plumbing over ``ops.kernel.apply_batch_paged``.
* :mod:`.ragged`: :func:`ragged_plan`, the flat pool view that
  ``ops.ragged.apply_batch_ragged`` walks in place, and its cache.
* :mod:`.sharded`: :class:`ShardedPagedDocStore`, the pool split into
  one pool per mesh shard, each on its shard's device.
* :mod:`.session`: :class:`PagedStreamingMerge` and
  :class:`RaggedStreamingMerge`, the streaming session over the pool
  (``StreamingMerge(layout="paged" | "ragged")``).
"""

from .alloc import PageAllocator, PoolExhausted
from .paged import DEFAULT_PAGE_SIZE, PagedDocStore, plan_page_groups
from .ragged import PlanCache, RaggedPlan, ragged_plan
from .session import PagedStreamingMerge, RaggedStreamingMerge

__all__ = [
    "DEFAULT_PAGE_SIZE",
    "PageAllocator",
    "PagedDocStore",
    "PagedStreamingMerge",
    "PlanCache",
    "PoolExhausted",
    "RaggedPlan",
    "RaggedStreamingMerge",
    "plan_page_groups",
    "ragged_plan",
]
