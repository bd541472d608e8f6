"""PagedDocStore: the device page pool, per-doc page tables, dense aux rows.

The ELEMENT planes (``elem_id`` / ``char``), which carry nearly all of the
padded layout's waste, live as fixed-size pages in a global
``(N_pages, P)`` pool, addressed per doc through a page table (page ``k``
of a doc backs slots ``[k*P, (k+1)*P)``).  The small per-doc aux tables
(tombstones, mark rows, map registers, scalars) stay dense ``(D, ...)``
rows: paging them would buy nothing and cost a second indirection.

Invariants the layouts lean on:

* **Page 0 is the null page and every free page is all-zero.**  Gathers
  through padding page-table entries read zeros; a page handed out by the
  allocator reads as empty slots (elem_id 0), exactly like a fresh padded
  row.  The paged apply re-zeroes page 0 after its scatter.
* **Allocation is deterministic** (:class:`~.alloc.PageAllocator`).
* **Group widths are power-of-two page counts** capped at the doc slot
  capacity (:func:`plan_page_groups`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.kernel import PAGED_AUX_FIELDS, apply_batch_paged, paged_state_of
from ..ops.packed import PackedDocs, empty_docs
from ..utils.device import resolve_device, upload_int32
from ..utils.shapes import next_pow2
from .alloc import PageAllocator, PoolExhausted

#: Default page width in slots: 64 int32 lanes, 256 B a row.  Internal
#: fragmentation (the unused tail of a doc's last page, at most P - 1
#: slots) grows linearly with the page width; page tables shrink with it.
DEFAULT_PAGE_SIZE = 64


def plan_page_groups(
    rows: Sequence[int], pages_of_row, max_doc_pages: int
) -> List[Tuple[int, np.ndarray]]:
    """Bucket ``rows`` by power-of-two page count (capped at
    ``max_doc_pages``): returns ``[(bucket_pages, rows_array), ...]`` in
    ascending bucket order, rows sorted within each bucket."""
    buckets: Dict[int, List[int]] = {}
    for row in rows:
        g = min(next_pow2(max(1, int(pages_of_row(row)))), max_doc_pages)
        buckets.setdefault(g, []).append(int(row))
    return [(g, np.asarray(sorted(buckets[g]), np.int64)) for g in sorted(buckets)]


def group_stream_named(enc, rows, b: int) -> Dict[str, np.ndarray]:
    """One group's stream arrays by name (host, int32): ``rows`` of an
    EncodedBatch-shaped object (every row when ``rows`` is None),
    zero-padded to ``b`` rows.  Padding rows are all-zero streams, which
    are no-ops; :func:`group_stream_args` reads them back."""
    def take(a):
        a = np.asarray(a)
        src = a if rows is None else a[rows]
        out = np.zeros((b,) + a.shape[1:], np.int32)
        out[: src.shape[0]] = src
        return out

    arrays = {"ins_ref": take(enc.ins_ref), "ins_op": take(enc.ins_op),
              "ins_char": take(enc.ins_char), "del_target": take(enc.del_target),
              "mark_count": take(enc.mark_count), "map_count": take(enc.map_count)}
    arrays.update({f"mark.{c}": take(enc.marks[c]) for c in sorted(enc.marks)})
    arrays.update({f"map.{c}": take(enc.map_ops[c]) for c in sorted(enc.map_ops)})
    return arrays


def group_stream_args(t: Dict[str, torch.Tensor], prefix: str = ""):
    """The ``apply_batch`` 8-tuple from a group's tensors by name (names
    as :func:`group_stream_named` gives them, under ``prefix``)."""
    col = lambda kind: sorted(n[len(prefix) + len(kind):] for n in t  # noqa: E731
                              if n.startswith(prefix + kind))
    return (
        t[prefix + "ins_ref"], t[prefix + "ins_op"], t[prefix + "ins_char"],
        t[prefix + "del_target"], {c: t[f"{prefix}mark.{c}"] for c in col("mark.")},
        t[prefix + "mark_count"], {c: t[f"{prefix}map.{c}"] for c in col("map.")},
        t[prefix + "map_count"],
    )


def group_stream_arrays(enc, rows, b: int, device: Union[str, torch.device]):
    """One group's stream tensors on ``device`` (the ``apply_batch``
    8-tuple, :func:`group_stream_named`), through one upload."""
    return group_stream_args(upload_int32(group_stream_named(enc, rows, b), torch.device(device)))


class PagedDocStore:
    """Page pool + page tables + dense aux rows for ``num_docs`` doc rows,
    on ``device``."""

    def __init__(
        self,
        num_docs: int,
        slot_capacity: int,
        mark_capacity: int,
        tomb_capacity: Optional[int] = None,
        map_capacity: int = 32,
        page_size: int = DEFAULT_PAGE_SIZE,
        initial_pages: Optional[int] = None,
        max_pool_pages: Optional[int] = None,
        *,
        device: Union[str, torch.device],
    ) -> None:
        if slot_capacity % page_size:
            raise ValueError(
                f"slot_capacity {slot_capacity} must be a multiple of the "
                f"page size {page_size}"
            )
        self.device = resolve_device(device)
        self.num_docs = int(num_docs)
        self.page_size = int(page_size)
        self.slot_capacity = int(slot_capacity)
        self.max_doc_pages = slot_capacity // page_size
        # every doc fully grown, plus the null page (or the caller's cap):
        # beyond it ensure_rows raises PoolExhausted instead of growing
        self.max_pool_pages = int(
            max_pool_pages if max_pool_pages is not None
            else 1 + self.num_docs * self.max_doc_pages
        )
        start = initial_pages or min(
            self.max_pool_pages, next_pow2(1 + max(self.num_docs, 8))
        )
        start = max(2, min(int(start), self.max_pool_pages))
        self.alloc = PageAllocator(start)
        self.pool_elem = torch.zeros((start, page_size), dtype=torch.int32, device=self.device)
        self.pool_char = torch.zeros((start, page_size), dtype=torch.int32, device=self.device)
        # aux rows from empty_docs at element width 1.  An omitted tomb
        # capacity defaults to the SLOT capacity, as on the padded layout
        # (empty_docs would take the width-1 element axis otherwise).
        proto = empty_docs(
            num_docs, 1, mark_capacity,
            tomb_capacity=tomb_capacity if tomb_capacity is not None else slot_capacity,
            map_capacity=map_capacity,
            device=self.device,
        )
        self.aux = tuple(getattr(proto, f) for f in PAGED_AUX_FIELDS)
        self._num_pages = np.zeros(num_docs, np.int32)
        #: host-side upper bound on each row's used slots (its cumulative
        #: admitted inserts): drives allocation and the fragmentation stats
        self._used_hint = np.zeros(num_docs, np.int64)
        #: pool growths so far (each one reallocates the pool tensors)
        self.growths = 0
        #: bumped whenever a page table or the pool size changes: plans
        #: and materialized blocks key on it (with the pool size), so a
        #: stale owner plane or page table never reaches a launch
        self.alloc_epoch = 0

    # -- sizing --------------------------------------------------------------

    @property
    def aux_capacities(self) -> Dict[str, int]:
        aux = dict(zip(PAGED_AUX_FIELDS, self.aux))
        return {
            "tomb_capacity": int(aux["tomb_id"].shape[1]),
            "mark_capacity": int(aux["m_action"].shape[1]),
            "map_capacity": int(aux["r_obj"].shape[1]),
        }

    def num_pages(self, row: int) -> int:
        return int(self._num_pages[row])

    def aux_field(self, name: str) -> torch.Tensor:
        """One dense aux plane by PackedDocs field name (e.g. "num_slots")."""
        return self.aux[PAGED_AUX_FIELDS.index(name)]

    def pages_needed(self, used_slots: int) -> int:
        used = min(int(used_slots), self.slot_capacity)
        return max(1, -(-used // self.page_size))

    def width_for_rows(self, rows: Sequence[int]) -> int:
        """Power-of-two page bucket covering every row's allocation (at
        least 1, capped at the doc slot capacity)."""
        top = int(self._num_pages[np.asarray(rows, np.int64)].max()) if len(rows) else 1
        return min(next_pow2(max(1, top)), self.max_doc_pages)

    # -- allocation ----------------------------------------------------------

    def ensure_rows(self, rows: Sequence[int], used_slots: Sequence[int]) -> None:
        """Grow each row's page table to cover ``used_slots`` (its cumulative
        admitted inserts), growing the pool (doubling, up to
        ``max_pool_pages``) when the free list runs dry.  Deterministic:
        rows walk in sorted order; raises :class:`PoolExhausted` past the
        ceiling."""
        order = np.argsort(np.asarray(rows, np.int64), kind="stable")
        rows_arr = np.asarray(rows, np.int64)[order]
        used_arr = np.asarray(used_slots, np.int64)[order]
        for row, used in zip(rows_arr, used_arr):
            row = int(row)
            need = self.pages_needed(int(used))
            delta = need - self.alloc.num_pages(row)
            if delta > 0 and delta > self.alloc.free_pages:
                self._grow_pool(self.alloc.pages_in_use + self.alloc.reserved + delta)
            self.alloc.ensure(row, need)
            if delta > 0:
                self.alloc_epoch += 1
            self._num_pages[row] = self.alloc.num_pages(row)
            self._used_hint[row] = max(self._used_hint[row], int(used))

    def _grow_pool(self, min_total: int) -> None:
        target = next_pow2(max(min_total, 2 * self.alloc.total_pages))
        target = min(target, self.max_pool_pages)
        if target < min_total:
            raise PoolExhausted(
                min_total - self.alloc.total_pages,
                self.alloc.free_pages, self.alloc.total_pages,
            )
        added = self.alloc.grow(target)
        if added:
            pad = self.pool_elem.new_zeros((added, self.page_size))
            self.pool_elem = torch.cat([self.pool_elem, pad])
            self.pool_char = torch.cat([self.pool_char, pad])
            self.growths += 1
            self.alloc_epoch += 1

    def page_rows(self, rows: Sequence[int], bucket_pages: int,
                  pad_rows_to: Optional[int] = None) -> np.ndarray:
        """(B, bucket_pages) int32 page-table slab for ``rows``; padding
        entries (beyond a doc's allocation, and whole padding rows) point
        at the null page 0."""
        b = pad_rows_to if pad_rows_to is not None else len(rows)
        table = np.zeros((b, bucket_pages), np.int32)
        for i, row in enumerate(rows):
            pages = self.alloc.pages_of(int(row))
            table[i, : len(pages)] = pages
        return table

    def group_plan(self, rows: Sequence[int], bucket_pages: int,
                   pad_rows_to: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One group's host plan: the row indices (padding rows =
        ``num_docs``) and a snapshot of its page-table slab, taken now, so
        a later ``ensure_rows`` cannot reach an already planned group."""
        b = pad_rows_to if pad_rows_to is not None else len(rows)
        row_idx = np.full(b, self.num_docs, np.int64)
        row_idx[: len(rows)] = np.asarray(rows, np.int64)
        return row_idx, self.page_rows(rows, bucket_pages, pad_rows_to=b)

    def _group_index(self, rows, bucket_pages, pad_rows_to):
        """:meth:`group_plan` as tensors on the store's device."""
        row_idx, table = self.group_plan(rows, bucket_pages, pad_rows_to)
        return (torch.from_numpy(row_idx).to(self.device),
                torch.from_numpy(table).to(self.device))

    # -- device plumbing -----------------------------------------------------

    def materialize_rows(
        self, rows: Sequence[int], bucket_pages: Optional[int] = None,
        pad_rows_to: Optional[int] = None,
    ) -> PackedDocs:
        """Dense PackedDocs view of ``rows`` gathered from the pool at
        ``bucket_pages * page_size`` slots (default: the rows' own bucket,
        :meth:`width_for_rows`).  Padding rows (up to ``pad_rows_to``)
        gather null pages and the last doc's aux row; callers mask them."""
        g = bucket_pages or self.width_for_rows(rows)
        row_idx, table = self._group_index(rows, g, pad_rows_to)
        return paged_state_of(self.pool_elem, self.pool_char, self.aux, row_idx, table)

    def apply_rows(
        self, rows: Sequence[int], bucket_pages: int, encoded_arrays,
        pad_rows_to: Optional[int] = None,
    ) -> None:
        """Apply one gather-apply-scatter group (ops/kernel.
        apply_batch_paged) to the pool and aux rows, in place.  The stream
        tensors carry the (possibly padded) group row axis; padding rows
        must be all-zero no-ops."""
        row_idx, table = self._group_index(rows, bucket_pages, pad_rows_to)
        apply_batch_paged(self.pool_elem, self.pool_char, self.aux, row_idx, table,
                          encoded_arrays)

    # -- lifecycle: evacuate / compact / permute -------------------------------

    def evacuate_row(self, row: int) -> int:
        """Release one row's pages back to the (zeroed) free list and clear
        its aux row: the doc's state has moved elsewhere (another host, or
        scalar replay).  Returns the number of pages released."""
        pages = self.alloc.evacuate(int(row))
        if pages:
            idx = torch.as_tensor(pages, dtype=torch.int64, device=self.device)
            self.pool_elem[idx] = 0
            self.pool_char[idx] = 0
            self.alloc_epoch += 1
        r = int(row)
        for a in self.aux:
            a[r] = 0
        self._num_pages[r] = 0
        self._used_hint[r] = 0
        return len(pages)

    def compact(self) -> int:
        """Pack every held page into the lowest pool ids (one gather; the
        free tail reads the null page, so it comes back zeroed).  Returns
        the number of pages that moved.  Page tables stay deterministic:
        the plan walks docs in sorted row order."""
        mapping = self.alloc.compact_plan()
        moved = sum(1 for old, new in mapping.items() if old != new)
        if moved:
            src = np.zeros(self.alloc.total_pages, np.int64)  # default: the null page
            for old, new in mapping.items():
                src[new] = old
            idx = torch.from_numpy(src).to(self.device)
            self.pool_elem = self.pool_elem[idx]
            self.pool_char = self.pool_char[idx]
            self.alloc_epoch += 1
        self.alloc.apply_compact(mapping)
        self._num_pages[:] = 0
        for doc in self.alloc.docs():
            self._num_pages[doc] = self.alloc.num_pages(doc)
        return moved

    def permute_rows(self, src: np.ndarray) -> None:
        """Re-home doc rows: new row ``r`` takes old row ``src[r]`` (a full
        permutation).  Pages do not move; page tables and the dense aux
        rows do (one gather)."""
        src = np.asarray(src, np.int64)
        old_pages = {r: self.alloc.pages_of(r) for r in self.alloc.docs()}
        self.alloc.reseat({
            r: old_pages[int(src[r])] for r in range(len(src)) if int(src[r]) in old_pages
        })
        idx = torch.from_numpy(src).to(self.device)
        self.aux = tuple(a[idx] for a in self.aux)
        self._num_pages = self._num_pages[src]
        self._used_hint = self._used_hint[src]
        self.alloc_epoch += 1

    # -- telemetry -----------------------------------------------------------

    def page_loads(self) -> np.ndarray:
        """(num_docs,) pages held per row: the load a reshard balances."""
        return self._num_pages.copy()

    def pool_stats(self) -> Dict:
        """Pool occupancy and internal fragmentation (allocated but unused
        slots), overall and per doc-size decile: the paged layout's waste
        is the unused tail of each doc's last page."""
        total = self.alloc.total_pages - self.alloc.reserved
        in_use = self.alloc.pages_in_use
        live = np.nonzero(self._num_pages > 0)[0]
        alloc_slots = self._num_pages[live].astype(np.int64) * self.page_size
        used_slots = np.minimum(self._used_hint[live], alloc_slots)
        frag = alloc_slots - used_slots
        # the waste by doc size: rows sorted by allocation, in ten chunks
        deciles = {}
        if len(live):
            for i, chunk in enumerate(np.array_split(np.argsort(alloc_slots, kind="stable"), 10)):
                a = int(alloc_slots[chunk].sum()) if len(chunk) else 0
                deciles[f"d{i}"] = round(int(frag[chunk].sum()) / a, 4) if a else 0.0
        return {
            "page_size": self.page_size,
            "pool_pages": total,
            "pages_in_use": in_use,
            "pages_free": total - in_use,
            "pool_utilization": round(in_use / total, 4) if total else 0.0,
            "growths": self.growths,
            "docs_resident": int(len(live)),
            "allocated_slots": int(alloc_slots.sum()),
            "used_slots": int(used_slots.sum()),
            "internal_frag_slots": int(frag.sum()),
            "internal_frag_ratio": (
                round(int(frag.sum()) / int(alloc_slots.sum()), 4)
                if len(live) and int(alloc_slots.sum()) else 0.0
            ),
            "frag_by_decile": deciles,
        }
