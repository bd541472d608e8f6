"""Ragged plan: the flat doc-index and page-table view of the page pool.

The ragged apply (ops/ragged.py) walks the pool in place, so it needs no
buckets: per-doc true op and page counts reach the device as data.  This
module builds that plan on the host: three ``(N_pages,)`` planes over the
pool,

* ``owner``: the batch-local row each pool page belongs to (``num_rows`` =
  unowned: the null page, free pages, and pages of docs outside the
  batch, the apply's inert segment),
* ``pos_base``: the page's first slot position within its doc
  (``page_index_within_doc * page_size``),
* ``prev_page``: the preceding page of the same doc (first pages point at
  the null page 0, whose lanes are always zero),

plus the per-row ``page_count`` (true allocation, no rounding), the
``(B, max_doc_pages)`` ``page_table`` the CUDA kernel reads, and the flat
``row_idx``.  Everything is a pure function of the allocator state,
snapshotted when the plan is built: a later pool growth makes a new plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class RaggedPlan:
    """One ragged dispatch's host-side plan (module doc)."""

    #: batch rows (B,); the ``owner`` sentinel is ``num_rows``
    row_idx: np.ndarray
    #: (N_pages,) batch-local owner per pool page (num_rows = unowned)
    owner: np.ndarray
    #: (N_pages,) first slot position of the page within its doc
    pos_base: np.ndarray
    #: (N_pages,) previous page of the same doc (0 = null page)
    prev_page: np.ndarray
    #: (B,) true allocated page count per row, no power-of-two rounding
    page_count: np.ndarray
    #: (B, max_doc_pages) pool page per (row, doc-page); 0 (the null page)
    #: pads beyond each row's true count
    page_table: np.ndarray
    #: pool size the plan was built against
    pool_pages: int
    docs_walked: int
    pages_walked: int

    @property
    def num_rows(self) -> int:
        return int(self.row_idx.shape[0])


def ragged_plan(store, rows: Optional[Sequence[int]] = None) -> RaggedPlan:
    """Build the ragged pool view for ``rows`` (default: every doc row of
    ``store``).  Rows must already hold their allocation (``ensure_rows``);
    a row with no pages owns no pool segment, and any live op for it
    overflows exactly as the padded oracle's zero-width doc would."""
    if rows is None:
        rows = np.arange(store.num_docs, dtype=np.int64)
    row_idx = np.asarray(rows, np.int64)
    b = int(row_idx.shape[0])
    n = int(store.pool_elem.shape[0])
    p = int(store.page_size)
    owner = np.full(n, b, np.int32)
    pos_base = np.zeros(n, np.int32)
    prev_page = np.zeros(n, np.int32)
    page_count = np.zeros(b, np.int32)
    page_table = np.zeros((b, store.max_doc_pages), np.int32)
    pages_walked = 0
    for i, row in enumerate(row_idx):
        pages = store.alloc.pages_of(int(row))
        page_count[i] = len(pages)
        pages_walked += len(pages)
        for k, pg in enumerate(pages):
            owner[pg] = i
            pos_base[pg] = k * p
            prev_page[pg] = pages[k - 1] if k else 0
            page_table[i, k] = pg
    return RaggedPlan(
        row_idx=row_idx,
        owner=owner,
        pos_base=pos_base,
        prev_page=prev_page,
        page_count=page_count,
        page_table=page_table,
        pool_pages=n,
        docs_walked=b,
        pages_walked=pages_walked,
    )
