"""PagedStreamingMerge and RaggedStreamingMerge: StreamingMerge over the
page pool.

``StreamingMerge(layout="paged")`` and ``layout="ragged"`` build these.
The host half of every round (causal admission, frame scheduling, the
staging buffers) is the padded session's; what changes is where the
document state lives and what each round launches:

* **Paged commit** — per round, the rows it touched get their pages
  (``ensure_rows``, host), group by power-of-two page count, and each
  group is one gather-apply-scatter (ops/kernel.apply_batch_paged_groups)
  at its own width: one insert launch per (round, group), counted by
  ``streaming.group_applies``.  A round costs its touched docs at their own
  size, not every doc at the widest one's.
* **Ragged commit** — per round, one ops/ragged.apply_batch_ragged over
  all D rows straight against the pool, at the session's fixed round
  widths: one ragged insert launch per non-empty doc class of the round's
  plan, counted by ``streaming.ragged_applies``.  The plan is rebuilt only
  when the allocator state changed (store/ragged.PlanCache).
* **Reads and digests** — blocks materialize from the pool at the block's
  page-bucketed width W.  The padded per-doc text hash includes one pad
  term per non-visible slot of the full width S, so every digest program
  here adds the missing ``(S - W) * avalanche(PAD_SEED)`` per live doc:
  digests are bit-equal to a padded session's, the oracle between the
  layouts.
* **reshard()** — balances pages, the resource the pool spends: page
  tables and aux rows move, pages do not.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..obs import GLOBAL_COUNTERS
from ..ops.insert import SMEM_BUDGET
from ..ops.kernel import apply_batch_paged_groups
from ..ops.packed import PackedDocs
from ..ops.ragged import apply_batch_ragged
from ..ops.ragged_insert import ragged_teams
from ..ops.resolve import resolve
from ..parallel.mesh import M32, _PAD_SEED, _av_host, per_doc_text_digest
from ..parallel.streaming import (
    StreamingMerge,
    _compact_packed,
    _resolve_block_digest,
    _rows_digest,
    _width_bucket,
)
from ..utils.shapes import next_pow2
from .paged import DEFAULT_PAGE_SIZE, PagedDocStore, group_stream_arrays, plan_page_groups
from .ragged import PlanCache

#: one pad slot's term of the per-doc text hash (mesh.per_doc_text_digest
#: adds it per non-visible slot; doc_digest_host multiplies it by the pad
#: count)
_PAD_UNIT = _av_host(_PAD_SEED)


def _pad_corrected(per_doc: torch.Tensor, mask: torch.Tensor, pad_slots: int) -> torch.Tensor:
    """Per-doc hashes at width W plus the ``pad_slots = S - W`` pad terms a
    padded session's width S adds, masked to 0 outside ``mask``.  The term
    stays below 2**45, and the sum is masked before anything adds it."""
    return torch.where(mask, (per_doc + pad_slots * _PAD_UNIT) & M32, 0)


class PagedStreamingMerge(StreamingMerge):
    """StreamingMerge whose element planes live in a page pool (module
    doc).  ``static_rounds`` (the one-shape serving discipline) stays on the
    padded layout; ``mesh=`` is not ported (ROADMAP.md queue 1 item 11)."""

    _layout = "paged"

    def __init__(self, num_docs, actors, *args, layout: str = "paged",
                 page_size: int = DEFAULT_PAGE_SIZE, pool_pages: Optional[int] = None,
                 max_pool_pages: Optional[int] = None, **kwargs) -> None:
        if layout != "paged":
            raise ValueError(f"PagedStreamingMerge is layout='paged', got {layout!r}")
        if kwargs.get("static_rounds"):
            raise ValueError(
                "layout='paged' is incompatible with static_rounds: the serving "
                "shape discipline is the padded one-shape apply; use the padded "
                "layout for static-round serving")
        self.page_size = int(page_size)
        super().__init__(num_docs, actors, *args, layout="paged", **kwargs)
        if self._slot_capacity % self.page_size:
            raise ValueError(
                f"slot_capacity {self._slot_capacity} must be a multiple of "
                f"page_size {self.page_size} under layout={self._layout!r}")
        self._store = PagedDocStore(
            self._padded_docs, slot_capacity=self._slot_capacity,
            mark_capacity=self._mark_capacity, tomb_capacity=self._tomb_capacity,
            map_capacity=self._map_capacity, page_size=self.page_size,
            initial_pages=pool_pages, max_pool_pages=max_pool_pages, device=self.device,
        )
        #: materialized read blocks of one (round, placement, allocation)
        #: state, at most two
        self._mat_cache: tuple = (None, {})
        #: op-stream capacity each committed round paid, by round buffer
        self._commit_caps: Dict[int, int] = {}

    @property
    def store(self) -> PagedDocStore:
        return self._store

    @property
    def config(self) -> Dict[str, int]:
        return dict(super().config, page_size=self.page_size)

    def health(self) -> Dict:
        return dict(super().health(), layout=self._layout, page_pool=self._store.pool_stats())

    # -- the device half of a round ------------------------------------------

    def _commit_rounds(self, batch) -> None:
        """Commit scheduled rounds in causal order: per round, the touched
        rows get their pages (host), group by page bucket, and each group
        applies at its own width, one insert launch each.  Each group's page
        table is taken when it is planned."""
        store = self._store
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            rows = np.nonzero(enc.num_ops)[0]
            cap = 0
            if len(rows):
                store.ensure_rows(rows, self._cum_ins[rows])
                inputs = []
                for g, g_rows in plan_page_groups(rows, store.num_pages, store.max_doc_pages):
                    b = next_pow2(len(g_rows))
                    row_idx, table = store.group_plan(g_rows, g, pad_rows_to=b)
                    inputs.append((torch.from_numpy(row_idx).to(self.device),
                                   torch.from_numpy(table).to(self.device),
                                   group_stream_arrays(enc, g_rows, b, self.device)))
                    cap += b * sum(widths)
                apply_batch_paged_groups(store.pool_elem, store.pool_char, store.aux, inputs)
                GLOBAL_COUNTERS.add("streaming.group_applies", len(inputs))
                self._digest_row_valid[rows] = False
            self._commit_caps[id(enc)] = cap
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")

    def _round_capacity(self, enc, widths) -> int:
        """What the launched groups paid (row bucket x widths, per group),
        recorded at commit."""
        return self._commit_caps.pop(id(enc), 0)

    # -- reads: block materialization ------------------------------------------

    def _state_block(self, block_index: int) -> PackedDocs:
        """One read block gathered from the pool at its page-bucketed width,
        cached per (round, placement, allocation), at most two resident."""
        stamp = (self.rounds, self._placement_epoch, self._store.alloc_epoch)
        key_stamp, cache = self._mat_cache
        if key_stamp != stamp:
            cache = {}
            self._mat_cache = (stamp, cache)
        hit = cache.get(block_index)
        if hit is not None:
            return hit
        lo, hi = self._block_bounds(block_index)
        state = self._store.materialize_rows(np.arange(lo, hi))
        if len(cache) >= 2:
            cache.pop(next(iter(cache)))
        cache[block_index] = state
        return state

    def _pad_slots(self, state: PackedDocs) -> int:
        return self._slot_capacity - int(state.elem_id.shape[1])

    def _block_resolve_digest(self, block_index: int, row_mask: torch.Tensor):
        lo, hi = self._block_bounds(block_index)
        state = self._state_block(block_index)
        resolved, per_doc = _resolve_block_digest(state, self.comment_capacity, row_mask,
                                                  *self._digest_tables(lo, hi))
        return resolved, _pad_corrected(per_doc, row_mask & ~resolved.overflow,
                                        self._pad_slots(state))

    def _block_text_digest(self, block_index: int, row_mask: torch.Tensor):
        state = self._state_block(block_index)
        resolved = resolve(state, self.comment_capacity, with_comments=False)
        per_doc = _pad_corrected(per_doc_text_digest(resolved.char, resolved.visible),
                                 row_mask & ~resolved.overflow, self._pad_slots(state))
        return per_doc.sum() & M32, resolved.overflow

    def _dispatch_compact(self, block_index: int):
        """The visible-prefix gather, its width capped at the block's
        materialized width (the session-wide prior may come from a wider
        block)."""
        entry = self._resolution(block_index)
        width = min(self._compact_width_for(block_index, entry), int(entry.device.char.shape[1]))
        return _compact_packed(entry.device, self._state_block(block_index).elem_id, width), width

    def _schedule_rows_digest(self, rest: np.ndarray):
        k = _width_bucket(len(rest))
        rows_idx = np.zeros(k, np.int64)
        rows_idx[: len(rest)] = rest
        mask = np.zeros(k, bool)
        mask[: len(rest)] = True
        g = self._store.width_for_rows(rest)
        sub = self._store.materialize_rows(rest, g, pad_rows_to=k)
        mask_t = torch.from_numpy(mask).to(self.device)
        per_doc, ov = _rows_digest(sub, self.comment_capacity, mask_t,
                                   *self._digest_tables_rows(rows_idx, len(rest)))
        return _pad_corrected(per_doc, mask_t & ~ov, self._pad_slots(sub)), ov

    # -- placement: pages are the load -----------------------------------------

    def _reshard_sizes(self) -> np.ndarray:
        return self._store.page_loads()[self._row_of[: self.num_docs]]

    def _permute_rows(self, src: np.ndarray) -> None:
        self._store.permute_rows(src)

    def reshard(self, assignment=None) -> dict:
        """:meth:`StreamingMerge.reshard`, balancing pages; the return adds
        ``page_load``, the pages each shard's docs hold."""
        out = super().reshard(assignment)
        n_shards = max(len(out["shard_load"]), 1)
        rows_per_shard = max(self._padded_docs // n_shards, 1)
        page_load = [0] * n_shards
        pages = self._store.page_loads()
        for d in range(self.num_docs):
            row = int(self._row_of[d])
            page_load[min(row // rows_per_shard, n_shards - 1)] += int(pages[row])
        out["page_load"] = page_load
        return out


class RaggedStreamingMerge(PagedStreamingMerge):
    """StreamingMerge over the page pool with the ragged apply: every round
    is one ops/ragged.apply_batch_ragged over all D rows against the pool's
    pages, with no page buckets and no padded rows.  Storage, reads,
    digests and placement are the paged session's."""

    _layout = "ragged"

    def __init__(self, num_docs, actors, *args, layout: str = "ragged", **kwargs) -> None:
        if layout != "ragged":
            raise ValueError(f"RaggedStreamingMerge is layout='ragged', got {layout!r}")
        super().__init__(num_docs, actors, *args, layout="paged", **kwargs)
        self._plan_cache = PlanCache()

    def _round_widths(self, pool, obj_streams, ki, kd, km, kp):
        """Round widths stay at the session caps, as the reference's ragged
        session keeps them, so round buffers and round counts equal it.
        Padded stream slots cost upload bytes, not steps: the kernel's trip
        counts are each doc's own."""
        return ki, kd, km, kp

    def _ragged_planes(self):
        """``(plan, plan planes)`` of every row, rebuilt only when the
        allocator state changed (store/ragged.PlanCache)."""
        return self._plan_cache.get(self._store)

    def _commit_round_ragged(self, enc, widths) -> None:
        """One round: one ragged apply over every row (one insert launch per
        non-empty doc class of the plan)."""
        store = self._store
        rows = np.nonzero(enc.num_ops)[0]
        if len(rows):
            store.ensure_rows(rows, self._cum_ins[rows])
        plan, planes = self._ragged_planes()
        row_idx, owner, pos_base, prev_page, page_count, page_table = planes
        ins_counts = torch.from_numpy(np.ascontiguousarray(enc.ins_count, np.int32)).to(self.device)
        apply_batch_ragged(
            store.pool_elem, store.pool_char, store.aux, row_idx, owner, pos_base, prev_page,
            page_count, page_table, group_stream_arrays(enc, None, self._padded_docs, self.device),
            ins_counts, page_count_host=plan.page_count,
        )
        # the doc classes of the launch plan (their split does not depend
        # on the card's SM count)
        classes = ragged_teams(plan.page_count, store.page_size, plan.page_table.shape[1],
                               SMEM_BUDGET, 1)
        GLOBAL_COUNTERS.add("streaming.ragged_applies", len(classes))
        # no bucket rows, no padded steps: the capacity paid is the real work
        self._commit_caps[id(enc)] = int(enc.num_ops.sum())
        if len(rows):
            self._digest_row_valid[rows] = False
        self.rounds += 1
        GLOBAL_COUNTERS.add("streaming.rounds")

    def _commit_rounds(self, batch) -> None:
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            self._commit_round_ragged(enc, widths)
