"""ShardedPagedDocStore: the page pool split into per-shard pools.

A mesh session (store/session.py under ``mesh=``) runs ONE logical page
pool, split into ``n`` equal per-shard pools: shard ``s`` holds its own
``(Ps, P)`` pool tensors and the aux rows of doc rows ``[s * R, (s + 1) *
R)`` on its device, and its pages are global ids ``[s * Ps, (s + 1) *
Ps)``.  A doc's pages live on the shard that owns its row
(``shard_of_row = row // rows_per_shard``), so every launch of a shard
reads and writes that shard's tensors only.

Invariants on top of :class:`~.paged.PagedDocStore`'s:

* **Every shard has its own null page** (local page 0), permanently zero:
  a shard's gathers pad with it and its paged apply re-zeroes it after the
  scatter, the base's discipline seen per shard.
* **Placement by row range**: a doc's pages live on its row's shard,
  always.  ``ensure_rows`` allocates from the row's shard; when any shard
  runs dry EVERY shard grows to the same size (the global-id arithmetic
  needs ``n`` equal blocks).
* **reshard() moves pages between shards**: the row permutation first
  allocates destination pages in each receiving shard (lowest free
  first, disjoint from the pages staying and the pages leaving), then
  moves them (parallel/mesh_fused.move_pages), reseats the per-shard
  allocators and re-zeroes the vacated pages.

The facade (:class:`ShardedAllocator`) presents the per-shard allocators
under the base allocator interface with GLOBAL page ids, so the base's
host bookkeeping (``pool_stats``, ``page_loads``, ``width_for_rows``)
works unchanged; every verb that touches the pool tensors is overridden.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..obs import GLOBAL_COUNTERS
from ..ops.kernel import PAGED_AUX_FIELDS, apply_batch_paged, paged_state_of
from ..ops.packed import PackedDocs
from ..parallel.mesh import shard_docs
from ..parallel.mesh_fused import move_pages, permute_shard_rows
from ..utils.shapes import next_pow2
from .alloc import PageAllocator, PoolExhausted
from .paged import DEFAULT_PAGE_SIZE, PagedDocStore
from .ragged import RaggedPlan, ragged_plan


class ShardedAllocator:
    """Per-shard :class:`PageAllocator` bank behind the base allocator
    interface.  Doc rows are GLOBAL; page ids returned by query verbs are
    GLOBAL (``s * pages_per_shard + local``); each shard's allocator holds
    LOCAL ids and is keyed by global doc rows (a row lives on exactly one
    shard).  Mutating verbs route to the owning shard."""

    def __init__(self, n_shards: int, pages_per_shard: int, rows_per_shard: int) -> None:
        self.n_shards = int(n_shards)
        self.pages_per_shard = int(pages_per_shard)
        self.rows_per_shard = int(rows_per_shard)
        self.shards: List[PageAllocator] = [
            PageAllocator(pages_per_shard) for _ in range(n_shards)
        ]

    # -- shard arithmetic ----------------------------------------------------

    def shard_of_row(self, row: int) -> int:
        return int(row) // self.rows_per_shard

    def _to_global(self, shard: int, locals_: Sequence[int]) -> List[int]:
        base = shard * self.pages_per_shard
        return [base + int(p) for p in locals_]

    # -- base allocator interface (global view) ------------------------------

    @property
    def total_pages(self) -> int:
        return self.n_shards * self.pages_per_shard

    @property
    def reserved(self) -> int:
        return sum(a.reserved for a in self.shards)

    @property
    def free_pages(self) -> int:
        return sum(a.free_pages for a in self.shards)

    @property
    def pages_in_use(self) -> int:
        return sum(a.pages_in_use for a in self.shards)

    def pages_of(self, doc: int) -> List[int]:
        s = self.shard_of_row(doc)
        return self._to_global(s, self.shards[s].pages_of(doc))

    def num_pages(self, doc: int) -> int:
        return self.shards[self.shard_of_row(doc)].num_pages(doc)

    def docs(self) -> List[int]:
        out: List[int] = []
        for a in self.shards:
            out.extend(a.docs())
        return sorted(out)

    def ensure(self, doc: int, num_pages: int) -> List[int]:
        s = self.shard_of_row(doc)
        return self._to_global(s, self.shards[s].ensure(doc, num_pages))

    def free_doc(self, doc: int) -> List[int]:
        s = self.shard_of_row(doc)
        return self._to_global(s, self.shards[s].free_doc(doc))

    def evacuate(self, doc: int) -> List[int]:
        return self.free_doc(doc)

    def grow(self, new_total: int) -> int:
        raise NotImplementedError(
            "sharded pools grow per shard (ShardedPagedDocStore._grow_pool)")

    def compact_plan(self) -> Dict[int, int]:
        """Per-shard compaction in global ids: every move stays inside its
        shard."""
        mapping: Dict[int, int] = {}
        for s, a in enumerate(self.shards):
            base = s * self.pages_per_shard
            for old, new in a.compact_plan().items():
                mapping[base + old] = base + new
        return mapping

    def apply_compact(self, mapping: Dict[int, int]) -> None:
        per_shard: List[Dict[int, int]] = [{} for _ in self.shards]
        ps = self.pages_per_shard
        for old, new in mapping.items():
            if old // ps != new // ps:
                raise ValueError("sharded compact must not cross shards")
            per_shard[old // ps][old % ps] = new % ps
        for a, m in zip(self.shards, per_shard):
            a.apply_compact(m)

    def reseat(self, pages_by_doc: Dict[int, List[int]]) -> None:
        ps = self.pages_per_shard
        per_shard: List[Dict[int, List[int]]] = [{} for _ in self.shards]
        for doc, pages in pages_by_doc.items():
            s = self.shard_of_row(doc)
            locals_ = [int(p) - s * ps for p in pages]
            if any(p < 0 or p >= ps for p in locals_):
                raise ValueError(f"doc {doc} reseated with pages outside shard {s}")
            per_shard[s][int(doc)] = locals_
        for a, m in zip(self.shards, per_shard):
            a.reseat(m)


class ShardedPagedDocStore(PagedDocStore):
    """Doc-axis-sharded :class:`PagedDocStore` over ``mesh`` (module doc).

    ``pools_elem[s]`` / ``pools_char[s]`` are shard ``s``'s ``(Ps, P)``
    pool tensors and ``shard_aux[s]`` its ``(R, ...)`` aux rows, all on
    ``mesh.devices[s]``.  Row-taking verbs (``materialize_rows``,
    ``apply_rows``, ``group_plan``) take the rows of ONE shard, in global
    ids, and plan with that shard's local rows and pages."""

    def __init__(
        self,
        num_docs: int,
        mesh,
        slot_capacity: int,
        mark_capacity: int,
        tomb_capacity: Optional[int] = None,
        map_capacity: int = 32,
        page_size: int = DEFAULT_PAGE_SIZE,
        initial_pages: Optional[int] = None,
        max_pool_pages: Optional[int] = None,
    ) -> None:
        n = mesh.size
        if num_docs % n:
            raise ValueError(f"num_docs {num_docs} must be a multiple of the mesh size {n}")
        # the base store at its meshless shape on shard 0's device gives the
        # aux schema, capacities and host planes; its pool is replaced below
        super().__init__(
            num_docs, slot_capacity, mark_capacity, tomb_capacity=tomb_capacity,
            map_capacity=map_capacity, page_size=page_size, initial_pages=2,
            device=mesh.devices[0],
        )
        self.mesh = mesh
        self.n_shards = n
        self.rows_per_shard = num_docs // n
        # per-shard ceiling: every resident doc of the shard fully grown,
        # plus the shard's null page (the base's ceiling seen per shard)
        ceil = 1 + self.rows_per_shard * self.max_doc_pages
        if max_pool_pages is not None:
            ceil = min(ceil, max(2, int(max_pool_pages) // n))
        self.max_shard_pages = ceil
        self.max_pool_pages = n * ceil
        start = initial_pages or min(ceil, next_pow2(1 + max(self.rows_per_shard, 8)))
        start = max(2, min(int(start), ceil))
        self.pages_per_shard = start
        self.alloc = ShardedAllocator(n, start, self.rows_per_shard)
        self.pools_elem = [torch.zeros((start, page_size), dtype=torch.int32, device=d)
                           for d in mesh.devices]
        self.pools_char = [torch.zeros((start, page_size), dtype=torch.int32, device=d)
                           for d in mesh.devices]
        self.shard_aux = shard_docs(self.aux, mesh)
        self.pool_elem = self.pool_char = self.aux = None
        #: pages moved between shards so far (reshard telemetry)
        self.ici_page_moves = 0

    @property
    def aux_capacities(self) -> Dict[str, int]:
        aux = dict(zip(PAGED_AUX_FIELDS, self.shard_aux[0]))
        return {
            "tomb_capacity": int(aux["tomb_id"].shape[1]),
            "mark_capacity": int(aux["m_action"].shape[1]),
            "map_capacity": int(aux["r_obj"].shape[1]),
        }

    def aux_field(self, name: str) -> torch.Tensor:
        """One aux plane of every row, gathered on the CPU."""
        i = PAGED_AUX_FIELDS.index(name)
        return torch.cat([aux[i].cpu() for aux in self.shard_aux])

    def shard_tensors(self, shard: int):
        """``(pool_elem, pool_char, aux)`` of one shard."""
        return self.pools_elem[shard], self.pools_char[shard], self.shard_aux[shard]

    # -- allocation: per-shard free lists, uniform growth --------------------

    def ensure_rows(self, rows: Sequence[int], used_slots: Sequence[int]) -> None:
        """Base contract, but a row draws only from ITS shard's free list:
        the dry-shard check is per row and growth is uniform."""
        order = np.argsort(np.asarray(rows, np.int64), kind="stable")
        rows_arr = np.asarray(rows, np.int64)[order]
        used_arr = np.asarray(used_slots, np.int64)[order]
        for row, used in zip(rows_arr, used_arr):
            row = int(row)
            shard = self.alloc.shards[self.alloc.shard_of_row(row)]
            need = self.pages_needed(int(used))
            delta = need - shard.num_pages(row)
            if delta > 0 and delta > shard.free_pages:
                self._grow_pool(shard.pages_in_use + shard.reserved + delta)
            self.alloc.ensure(row, need)
            if delta > 0:
                self.alloc_epoch += 1
            self._num_pages[row] = self.alloc.num_pages(row)
            self._used_hint[row] = max(self._used_hint[row], int(used))

    def _grow_pool(self, min_shard_pages: int) -> None:
        """Grow EVERY shard to the same new per-shard size (at least the
        base's doubling curve); local page ids survive, the global-id base
        of each shard moves."""
        ps = self.pages_per_shard
        target = min(next_pow2(max(int(min_shard_pages), 2 * ps)), self.max_shard_pages)
        if target < min_shard_pages:
            raise PoolExhausted(min_shard_pages - ps,
                                min(a.free_pages for a in self.alloc.shards),
                                self.alloc.total_pages)
        added = target - ps
        if added <= 0:
            return
        grow = lambda t: torch.cat([t, t.new_zeros((added, self.page_size))])  # noqa: E731
        self.pools_elem = [grow(t) for t in self.pools_elem]
        self.pools_char = [grow(t) for t in self.pools_char]
        for a in self.alloc.shards:
            a.grow(target)
        self.pages_per_shard = target
        self.alloc.pages_per_shard = target
        self.growths += 1
        self.alloc_epoch += 1

    # -- one shard's plans and tensors ---------------------------------------

    def _shard_of_rows(self, rows: Sequence[int]) -> int:
        rows = np.asarray(rows, np.int64)
        if not len(rows):
            raise ValueError("a shard plan needs at least one row")
        shards = np.unique(rows // self.rows_per_shard)
        if len(shards) != 1:
            raise ValueError(f"rows span shards {shards.tolist()}; plan one shard at a time")
        return int(shards[0])

    def page_rows(self, rows: Sequence[int], bucket_pages: int,
                  pad_rows_to: Optional[int] = None) -> np.ndarray:
        """(B, bucket_pages) LOCAL page-table slab of one shard's ``rows``;
        padding entries point at the shard's own null page 0."""
        b = pad_rows_to if pad_rows_to is not None else len(rows)
        table = np.zeros((b, bucket_pages), np.int32)
        if len(rows):
            alloc = self.alloc.shards[self._shard_of_rows(rows)]
            for i, row in enumerate(rows):
                pages = alloc.pages_of(int(row))
                table[i, : len(pages)] = pages
        return table

    def group_plan(self, rows: Sequence[int], bucket_pages: int,
                   pad_rows_to: Optional[int] = None):
        """One shard group's host plan: LOCAL row indices (padding rows =
        ``rows_per_shard``, which the apply drops) and its LOCAL page-table
        slab, taken now."""
        b = pad_rows_to if pad_rows_to is not None else len(rows)
        row_idx = np.full(b, self.rows_per_shard, np.int64)
        if len(rows):
            s = self._shard_of_rows(rows)
            row_idx[: len(rows)] = np.asarray(rows, np.int64) - s * self.rows_per_shard
        return row_idx, self.page_rows(rows, bucket_pages, pad_rows_to=b)

    def materialize_rows(self, rows: Sequence[int], bucket_pages: Optional[int] = None,
                         pad_rows_to: Optional[int] = None) -> PackedDocs:
        """Dense PackedDocs of one shard's ``rows`` on that shard's device
        (the base's contract, per shard)."""
        s = self._shard_of_rows(rows)
        g = bucket_pages or self.width_for_rows(rows)
        row_idx, table = self.group_plan(rows, g, pad_rows_to)
        dev = self.mesh.devices[s]
        return paged_state_of(self.pools_elem[s], self.pools_char[s], self.shard_aux[s],
                              torch.from_numpy(row_idx).to(dev), torch.from_numpy(table).to(dev))

    def apply_rows(self, rows: Sequence[int], bucket_pages: int, encoded_arrays,
                   pad_rows_to: Optional[int] = None) -> None:
        """One gather-apply-scatter group of one shard's ``rows`` (streams
        on that shard's device)."""
        s = self._shard_of_rows(rows)
        row_idx, table = self.group_plan(rows, bucket_pages, pad_rows_to)
        dev = self.mesh.devices[s]
        apply_batch_paged(self.pools_elem[s], self.pools_char[s], self.shard_aux[s],
                          torch.from_numpy(row_idx).to(dev), torch.from_numpy(table).to(dev),
                          encoded_arrays)

    def ragged_shard_plan(self, shard: int) -> RaggedPlan:
        """The ragged plan of every row of one shard over its own pool:
        LOCAL row ids (the ``owner`` sentinel is ``rows_per_shard``) and
        LOCAL pages (``prev_page`` of a first page is the shard's null
        page), built off the shard's allocator."""
        lo = shard * self.rows_per_shard
        view = SimpleNamespace(pool_elem=self.pools_elem[shard], page_size=self.page_size,
                               max_doc_pages=self.max_doc_pages, alloc=self.alloc.shards[shard])
        plan = ragged_plan(view, np.arange(lo, lo + self.rows_per_shard, dtype=np.int64))
        return dataclasses.replace(plan, row_idx=np.arange(self.rows_per_shard, dtype=np.int64))

    # -- lifecycle -----------------------------------------------------------

    def evacuate_row(self, row: int) -> int:
        r = int(row)
        s = self.alloc.shard_of_row(r)
        pages = self.alloc.shards[s].evacuate(r)
        if pages:
            idx = torch.as_tensor(pages, dtype=torch.int64, device=self.mesh.devices[s])
            self.pools_elem[s][idx] = 0
            self.pools_char[s][idx] = 0
            self.alloc_epoch += 1
        local = r - s * self.rows_per_shard
        for a in self.shard_aux[s]:
            a[local] = 0
        self._num_pages[r] = 0
        self._used_hint[r] = 0
        return len(pages)

    def compact(self) -> int:
        """Per-shard compaction: each shard packs its held pages into its
        lowest local ids by one gather whose default is the shard's null
        page, so freed pages come back zeroed."""
        moved = 0
        for s, a in enumerate(self.alloc.shards):
            mapping = a.compact_plan()
            shard_moved = sum(1 for old, new in mapping.items() if old != new)
            if shard_moved:
                src = np.zeros(self.pages_per_shard, np.int64)
                for old, new in mapping.items():
                    src[new] = old
                idx = torch.from_numpy(src).to(self.mesh.devices[s])
                self.pools_elem[s] = self.pools_elem[s][idx]
                self.pools_char[s] = self.pools_char[s][idx]
            a.apply_compact(mapping)
            moved += shard_moved
        if moved:
            self.alloc_epoch += 1
        self._num_pages[:] = 0
        for doc in self.alloc.docs():
            self._num_pages[doc] = self.alloc.num_pages(doc)
        return moved

    def permute_rows(self, src: np.ndarray) -> None:
        """New row ``r`` takes old row ``src[r]``.  Rows that stay on their
        shard move tables only; rows that change shard move their PAGES
        (:func:`~..parallel.mesh_fused.move_pages`), destination pages
        allocated first, disjoint from the pages staying AND leaving, and
        the vacated sources re-zeroed."""
        src = np.asarray(src, np.int64)
        n, ps = self.n_shards, self.pages_per_shard
        alloc = self.alloc
        old_pages = {d: alloc.shards[alloc.shard_of_row(d)].pages_of(d)
                     for a in alloc.shards for d in a.docs()}
        staying: List[set] = [set() for _ in range(n)]
        leaving: List[set] = [set() for _ in range(n)]
        new_maps: List[Dict[int, List[int]]] = [{} for _ in range(n)]
        cross = []  # (src_shard, dst_shard, new_row, src_locals)
        for r in range(len(src)):
            o = int(src[r])
            pages = old_pages.get(o)
            if not pages:
                continue
            so, sn = alloc.shard_of_row(o), alloc.shard_of_row(r)
            if so == sn:
                new_maps[sn][r] = pages
                staying[sn].update(pages)
            else:
                cross.append((so, sn, r, pages))
                leaving[so].update(pages)
        if cross:
            # each receiving shard needs destinations outside (staying +
            # leaving): grow every shard first if any is short
            need_in = [0] * n
            for _, sn, _, pages in cross:
                need_in[sn] += len(pages)
            worst = max(1 + len(staying[s]) + len(leaving[s]) + need_in[s] for s in range(n))
            if worst > ps:
                self._grow_pool(worst)
                ps = self.pages_per_shard
            free = [sorted(set(range(1, ps)) - staying[s] - leaving[s]) for s in range(n)]
            send: Dict[tuple, List[int]] = {}
            recv: Dict[tuple, List[int]] = {}
            moved = 0
            for so, sn, r, pages in sorted(cross, key=lambda c: (c[1], c[2])):
                dst = free[sn][: len(pages)]
                del free[sn][: len(pages)]
                new_maps[sn][r] = dst
                d = (sn - so) % n
                send.setdefault((so, d), []).extend(pages)
                recv.setdefault((sn, d), []).extend(dst)
                moved += len(pages)
            m_pages = max(len(v) for v in send.values())
            m_zero = max(max(len(leaving[s]) for s in range(n)), 1)
            send_idx = np.zeros((n, n - 1, m_pages), np.int32)
            recv_idx = np.full((n, n - 1, m_pages), ps, np.int32)
            zero_idx = np.full((n, m_zero), ps, np.int32)
            for (s, d), v in send.items():
                send_idx[s, d - 1, : len(v)] = v
            for (s, d), v in recv.items():
                recv_idx[s, d - 1, : len(v)] = v
            for s in range(n):
                vac = sorted(leaving[s])
                zero_idx[s, : len(vac)] = vac
            move_pages(self.pools_elem, self.pools_char, send_idx, recv_idx, zero_idx)
            self.ici_page_moves += moved
            GLOBAL_COUNTERS.add("store.ici_page_moves", moved)
        for a, m in zip(alloc.shards, new_maps):
            a.reseat(m)
        self.shard_aux = permute_shard_rows(self.shard_aux, src, self.mesh)
        self._num_pages = self._num_pages[src]
        self._used_hint = self._used_hint[src]
        self.alloc_epoch += 1

    # -- telemetry -----------------------------------------------------------

    def shard_stats(self) -> Dict:
        """Per-shard pool snapshot behind the ``peritext_mesh_*`` gauges."""
        per_use = [a.pages_in_use for a in self.alloc.shards]
        cap = self.pages_per_shard - 1
        mean = sum(per_use) / len(per_use) if per_use else 0.0
        return {
            "shards": self.n_shards,
            "rows_per_shard": self.rows_per_shard,
            "pages_per_shard": self.pages_per_shard,
            "shard_load": per_use,
            "shard_utilization": [round(u / cap, 4) if cap else 0.0 for u in per_use],
            "imbalance_ratio": round(max(per_use) / mean, 4) if mean else 1.0,
            "ici_page_moves": self.ici_page_moves,
        }

