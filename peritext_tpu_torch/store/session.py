"""PagedStreamingMerge and RaggedStreamingMerge: StreamingMerge over the
page pool.

``StreamingMerge(layout="paged")`` and ``layout="ragged"`` build these.
The host half of every round (causal admission, frame scheduling, the
staging buffers) is the padded session's; what changes is where the
document state lives and what each round launches:

* **Paged commit** — per round, the rows it touched get their pages
  (``ensure_rows``, host), group by power-of-two page count, and each
  group is one gather-apply-scatter at its own width: one insert launch
  per (round, group), counted by ``streaming.group_applies``.  A round
  costs its touched docs at their own size, not every doc at the widest
  one's.  A one-block session commits a drain batch's every (round,
  group) as ONE ``apply_batch_paged_groups`` site call over the pool, in
  place, from one staged buffer (on the card one CUDA-graph replay once
  the batch's signature repeats; pool growth starts a new graph epoch);
  ``fused_pipeline=False`` or a block-chunked session, one call per
  round.
* **Ragged commit** — one ops/ragged.apply_batch_ragged per round over
  all D rows straight against the pool, at the session's fixed round
  widths: one ragged insert launch per non-empty doc class of the plan,
  counted by ``streaming.ragged_applies``.  The plan, its planes and the
  ragged insert's launch plan (ops/ragged.plan_launch, its card arrays
  uploaded once) are rebuilt only when the allocator state changed
  (store/ragged.PlanCache).  A one-block session commits a drain batch
  as ONE ``apply_batch_ragged`` site call: prep gives every round's rows
  their pages, in round order; one staged buffer holds every round's
  streams and insert counts; the call runs the batch's rounds over the
  plan as it stands after prep (on the card one CUDA-graph replay once
  the batch's depth, K3 team plan and buffer layout repeat; the plan's
  planes and the launch plan's arrays are the graph's inputs, so a new
  allocation keeps the graphs and only pool growth starts a new epoch).
  ``fused_pipeline=False`` or a block-chunked session, one call a round.
* **Reads and digests** — blocks materialize from the pool at the block's
  page-bucketed width W.  The padded per-doc text hash includes one pad
  term per non-visible slot of the full width S, so every digest program
  here adds the missing ``(S - W) * avalanche(PAD_SEED)`` per live doc:
  digests are bit-equal to a padded session's, the oracle between the
  layouts.
* **reshard()** — balances pages, the resource the pool spends: page
  tables and aux rows move, pages do not (under a mesh, the pages of docs
  that change shard move between the shards' pools).
* **Mesh** — under ``mesh=`` the pool is a store/sharded.
  ShardedPagedDocStore: one pool and aux block per shard, on its device.
  A paged round plans its page groups per shard, every shard at the
  group's largest shard row count, and launches the insert kernel once
  per (round, shard, group); a ragged round launches the ragged insert
  kernel once per (round, non-empty doc class) of each shard it runs on,
  over that shard's plan (cached per allocation epoch and shard pool
  size).  A drain batch commits per shard as one site call through the
  shard's graph cache (``apply_batch_paged_groups.mesh`` on every shard
  when the batch has a group; ``apply_batch_ragged.mesh`` on each shard
  that holds an op anywhere in the batch), from one staged buffer per
  shard, counted as one ``streaming.fused_dispatches``.  Read blocks are
  the shards.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF, occupancy_key
from ..obs.devprof import plan_static
from ..ops.insert import SMEM_BUDGET
from ..ops.kernel import (
    _apply_groups,
    _insert_plan,
    apply_batch_paged_groups,
    note_form,
    resolve_state_donation,
)
from ..ops.packed import PackedDocs
from ..ops.ragged import _apply_batch_ragged, apply_batch_ragged, plan_arrays, plan_launch
from ..ops.ragged_insert import ragged_insert_bytes, ragged_teams
from ..ops.resolve import resolve
from ..parallel.mesh import M32, _PAD_SEED, _av_host, per_doc_text_digest
from ..parallel.streaming import (
    StreamingMerge,
    _compact_packed,
    _resolve_block_digest,
    _rows_digest,
    _width_bucket,
)
from ..utils.device import pack_int32, unpack_int32
from ..utils.shapes import next_pow2
from .paged import (
    DEFAULT_PAGE_SIZE,
    PagedDocStore,
    group_stream_args,
    group_stream_arrays,
    group_stream_named,
    plan_page_groups,
)
from .ragged import PlanCache
from .sharded import ShardedPagedDocStore

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
    padded layout; under ``mesh=`` the pool shards (module doc)."""

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
        sizes = dict(slot_capacity=self._slot_capacity, mark_capacity=self._mark_capacity,
                     tomb_capacity=self._tomb_capacity, map_capacity=self._map_capacity,
                     page_size=self.page_size, initial_pages=pool_pages,
                     max_pool_pages=max_pool_pages)
        self._store = (
            ShardedPagedDocStore(self._padded_docs, self.mesh, **sizes) if self.mesh is not None
            else PagedDocStore(self._padded_docs, device=self.device, **sizes))
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

    def _mesh_stats(self) -> Dict:
        """The pool's real per-shard occupancy and the count of pages moved
        between shards."""
        return dict(self._store.shard_stats())

    def _shard_tensors(self, shard: Optional[int]):
        """``(device, (pool_elem, pool_char, aux))`` of one shard's pool
        (``shard`` None: the meshless pool)."""
        store = self._store
        if shard is None:
            return self.device, (store.pool_elem, store.pool_char, store.aux)
        return self.mesh.devices[shard], store.shard_tensors(shard)

    def _page_groups(self, rows: np.ndarray):
        """``[(bucket_pages, rows_bucket, [(shard, rows), ...]), ...]``: a
        round's touched rows by power-of-two page bucket.  Under a mesh
        each bucket is planned per shard, every shard at the bucket's
        largest shard row count (shards short of rows pad with no-op rows,
        as the reference's mesh commit does); meshless, shard is None."""
        store = self._store
        groups = plan_page_groups(rows, store.num_pages, store.max_doc_pages)
        if self.mesh is None:
            return [(g, next_pow2(len(g_rows)), [(None, g_rows)]) for g, g_rows in groups]
        r = store.rows_per_shard
        out = []
        for g, g_rows in groups:
            per_shard = [(k, g_rows[g_rows // r == k]) for k in range(store.n_shards)]
            out.append((g, next_pow2(max(len(v) for _, v in per_shard)), per_shard))
        return out

    # -- the device half of a round ------------------------------------------

    def _commit_rounds_serial(self, batch) -> None:
        """Commit scheduled rounds one at a time (a mesh session, or
        ``fused_pipeline=False``): per round, the touched rows get their
        pages (host), group by page bucket (:meth:`_page_groups`, per shard
        under a mesh), and each group applies at its own width, one insert
        launch each (per shard).  Each group's page table is taken when it
        is planned.  Profiled, each group lands in the occupancy table (the
        reference's label: ``streaming.paged.fused`` with
        ``fused_pipeline``, else ``streaming.paged``) and the batch ends
        with a page-pool snapshot (and a mesh one)."""
        store = self._store
        origin = "streaming.paged.fused" if self.fused_pipeline else "streaming.paged"
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            rows = np.nonzero(enc.num_ops)[0]
            cap = 0
            if len(rows):
                store.ensure_rows(rows, self._cum_ins[rows])
                launches: Dict = {}
                for g, b, per_shard in self._page_groups(rows):
                    for shard, s_rows in per_shard:
                        dev, _ = self._shard_tensors(shard)
                        row_idx, table = store.group_plan(s_rows, g, pad_rows_to=b)
                        launches.setdefault(shard, []).append((
                            torch.from_numpy(row_idx).to(dev), torch.from_numpy(table).to(dev),
                            group_stream_arrays(enc, s_rows, b, dev)))
                    paid = b * len(per_shard) * sum(widths)
                    cap += paid
                    if GLOBAL_DEVPROF.enabled:
                        real = sum(int(enc.num_ops[v].sum()) for _, v in per_shard)
                        GLOBAL_DEVPROF.observe_round(occupancy_key(b * len(per_shard), *widths),
                                                     real, paid, origin=origin)
                for shard, inputs in launches.items():
                    apply_batch_paged_groups(*self._shard_tensors(shard)[1], inputs)
                    GLOBAL_COUNTERS.add("streaming.group_applies", len(inputs))
                self._digest_row_valid[rows] = False
            self._commit_caps[id(enc)] = cap
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")
        if GLOBAL_DEVPROF.enabled:
            GLOBAL_DEVPROF.observe_page_pool(store.pool_stats())
            if self.mesh is not None:
                GLOBAL_DEVPROF.observe_mesh(self._mesh_stats())

    # -- the fused forms: every (round, group) of a batch in one site call -----

    def _prep_fused_batch(self, batch):
        """Advance the cumulative inserts, give each round's touched rows
        their pages and plan that round's page groups, each group's page
        table snapshot taken now: everything that reads or mutates the
        allocator happens here, in round order: the reference's
        ``("paged", plans)``, each group ``(rows, b, row_idx, table)``.
        Under a mesh each group is planned per shard, every shard at the
        group's largest shard row count (:meth:`_page_groups`): the
        reference's ``("mesh_paged", plans)``, each group ``(rows by shard,
        bucket pages, b, row_idx (n, b), table (n, b, bucket pages))`` with
        local row ids and local pages."""
        store = self._store
        plans = []
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            rows = np.nonzero(enc.num_ops)[0]
            plan = []
            if len(rows):
                store.ensure_rows(rows, self._cum_ins[rows])
                for g, b, per_shard in self._page_groups(rows):
                    planned = [(s_rows, *store.group_plan(s_rows, g, pad_rows_to=b))
                               for _, s_rows in per_shard]
                    if self.mesh is None:
                        g_rows, row_idx, table = planned[0]
                        plan.append((g_rows, b, row_idx, table))
                    else:
                        plan.append(([p[0] for p in planned], g, b,
                                     np.stack([p[1] for p in planned]),
                                     np.stack([p[2] for p in planned])))
            plans.append((widths, plan))
        return ("paged" if self.mesh is None else "mesh_paged", tuple(plans))

    def _shard_groups(self, plan, shard: int):
        """``[(rows, b, row_idx, table), ...]``: one shard's part of each
        group of a planned round (meshless: the groups themselves)."""
        if self.mesh is None:
            return list(plan)
        return [(rows[shard], b, row_idx[shard], table[shard])
                for rows, _, b, row_idx, table in plan]

    def _stage_fused_batch(self, batch, statics):
        """Every (round, group)'s row indices, page table and streams in ONE
        int32 buffer, one upload: ``(StagedUpload, layout)``, or under a
        mesh ``[(shard, StagedUpload, layout), ...]``, each shard's own
        slice of every group through its copy lane."""
        shards = range(1 if self.mesh is None else self.mesh.size)
        out = []
        for shard in shards:
            arrays = {}
            for r, ((enc, _), (_, plan)) in enumerate(zip(batch, statics[1])):
                for j, (s_rows, b, row_idx, table) in enumerate(self._shard_groups(plan, shard)):
                    arrays[f"{r}.{j}.row_idx"] = row_idx
                    arrays[f"{r}.{j}.table"] = table
                    arrays.update({f"{r}.{j}.{n}": a
                                   for n, a in group_stream_named(enc, s_rows, b).items()})
            flat, layout = pack_int32(arrays)
            out.append((shard, self._shard_lanes[shard].upload(flat), layout))
        return out[0][1:] if self.mesh is None else out

    def _dispatch_fused_batch(self, batch, statics, inputs, chain_digest: bool = False) -> bool:
        """Every (round, group) gather-apply-scatter of the batch as ONE
        ``apply_batch_paged_groups`` site call (one graph replay on the
        card, updating the pool in place), or on the CPU a lone group as
        the per-group ``apply_batch_paged`` (the reference's undonated
        form); under a mesh one such call per shard over its pool
        (``apply_batch_paged_groups.mesh``, each through the shard's graph
        cache, counted as one fused dispatch when the batch has a group).
        Then the per-round bookkeeping and occupancy rows.  The digest is
        never chained here (the reference's paged forms do not either); the
        drain prefetches it separately."""
        plans = statics[1]
        keys = [f"{r}.{j}." for r, (_, plan) in enumerate(plans) for j in range(len(plan))]
        store = self._store
        n = 1 if self.mesh is None else self.mesh.size
        if self.mesh is None:
            upload, layout = inputs
            buf = upload.consume()
            pool = (store.pool_elem, store.pool_char, store.aux)
            if len(keys) == 1 and not resolve_state_donation(store.pool_elem):
                t = unpack_int32(buf, layout)
                _apply_groups(*pool, [(t[keys[0] + "row_idx"], t[keys[0] + "table"],
                                       group_stream_args(t, keys[0]))])
            elif keys:
                self._run_groups(pool, buf, layout, keys)
        elif keys:
            for shard, upload, layout in inputs:
                with self._on_device(shard):
                    self._run_groups(store.shard_tensors(shard), upload.consume(), layout, keys,
                                     shard=shard)
            GLOBAL_COUNTERS.add("streaming.fused_dispatches")
        if keys:
            GLOBAL_COUNTERS.add("streaming.group_applies", len(keys) * n)
        for (enc, _), (widths, plan) in zip(batch, plans):
            cap = 0
            for group in plan:
                by_shard, b = ([group[0]], group[1]) if self.mesh is None else (group[0], group[2])
                cap += b * n * sum(widths)
                if GLOBAL_DEVPROF.enabled:
                    real = sum(int(enc.num_ops[s_rows].sum()) for s_rows in by_shard)
                    GLOBAL_DEVPROF.observe_round(occupancy_key(b * n, *widths), real,
                                                 b * n * sum(widths),
                                                 origin="streaming.paged.fused")
            self._commit_caps[id(enc)] = cap
            rows = np.nonzero(enc.num_ops)[0]
            if len(rows):
                self._digest_row_valid[rows] = False
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")
        if GLOBAL_DEVPROF.enabled:
            GLOBAL_DEVPROF.observe_page_pool(store.pool_stats())
            if self.mesh is not None:
                GLOBAL_DEVPROF.observe_mesh(self._mesh_stats())
        return False

    def _run_groups(self, pool, buf: torch.Tensor, layout, keys,
                    shard: Optional[int] = None) -> None:
        """The batch's group chain over the resident pool and aux rows (a
        mesh shard's, given ``shard``), in place, run by the session's (the
        shard's) graph cache under the ``apply_batch_paged_groups`` site
        (``.mesh`` for a shard)."""
        pool_elem, pool_char, aux = pool
        graphs = self._graphs if shard is None else self._shard_graphs[shard]
        site = "apply_batch_paged_groups" + ("" if shard is None else ".mesh")

        def plan():
            shapes = dict(layout)
            teams, nbytes = [], 0
            for k in keys:
                b, g = shapes[k + "table"]
                t, n = _insert_plan(b, g * pool_elem.shape[1], shapes[k + "ins_op"][1], None,
                                    pool_elem.device)
                teams.extend(t)
                nbytes += n
            return (("plan", plan_static(teams)),), len(teams), nbytes

        def body(b):
            t = unpack_int32(b, layout)
            _apply_groups(pool_elem, pool_char, aux,
                          [(t[k + "row_idx"], t[k + "table"], group_stream_args(t, k))
                           for k in keys])
        note_form(site, (pool_elem, pool_char, aux, buf),
                  lambda: graphs.run(("paged", layout), site, body, (buf,),
                                     binds=(pool_elem, pool_char) + tuple(aux)),
                  plan, device=pool_elem.device)

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
        tables = self._digest_tables(*self._block_bounds(block_index))
        with self.tracer.span("digest.launch"):
            state = self._state_block(block_index)
            resolved, per_doc = _resolve_block_digest(state, self.comment_capacity, row_mask,
                                                      *tables)
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
        dev = sub.elem_id.device
        tables = self._digest_tables_rows(rows_idx, len(rest), dev)
        with self.tracer.span("digest.launch"):
            mask_t = torch.from_numpy(mask).to(dev)
            per_doc, ov = _rows_digest(sub, self.comment_capacity, mask_t, *tables)
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
        #: the mesh form: ((alloc_epoch, pages per shard), [(plan, planes)
        #: per shard], [launch plan per shard])
        self._mesh_plans: tuple = (None, None, None)

    def _round_widths(self, pool, obj_streams, ki, kd, km, kp):
        """Round widths stay at the session caps, as the reference's ragged
        session keeps them, so round buffers and round counts equal it.
        Padded stream slots cost upload bytes, not steps: the kernel's trip
        counts are each doc's own."""
        return ki, kd, km, kp

    def _ragged_planes(self):
        """``(plan, plan planes)`` of every row, rebuilt only when the
        allocator state changed (store/ragged.PlanCache; its ``launch`` is
        the plan's ragged insert launch plan)."""
        return self._plan_cache.get(self._store)

    def _shard_planes(self):
        """Under a mesh, ``[(plan, plan planes), ...]`` per shard, each
        shard's on its device (ShardedPagedDocStore.ragged_shard_plan),
        rebuilt only when the allocation epoch or the shard pool size
        changed (with each shard's launch plan, :meth:`_shard_launches`)."""
        store = self._store
        key = (store.alloc_epoch, store.pages_per_shard)
        if self._mesh_plans[0] != key:
            plans = [store.ragged_shard_plan(s) for s in range(store.n_shards)]
            self._mesh_plans = (
                key, [(plan, plan_arrays(plan, dev)) for plan, dev in zip(plans, self.mesh.devices)],
                [plan_launch(plan, store.page_size, dev)
                 for plan, dev in zip(plans, self.mesh.devices)])
        return self._mesh_plans[1]

    def _shard_launches(self):
        """Each shard's ragged insert launch plan (None on the CPU), of the
        plans :meth:`_shard_planes` holds."""
        self._shard_planes()
        return self._mesh_plans[2]

    def _launch_plans(self, rows: np.ndarray):
        """``[(device, (pool_elem, pool_char, aux), row slice of the
        launch, (plan, planes), launch plan), ...]``: the whole pool
        meshless, else each shard that holds a row with ops."""
        if self.mesh is None:
            return [(*self._shard_tensors(None), slice(0, self._padded_docs),
                     self._ragged_planes(), self._plan_cache.launch)]
        planes, launches = self._shard_planes(), self._shard_launches()
        r = self._store.rows_per_shard
        return [(*self._shard_tensors(s), slice(s * r, (s + 1) * r), planes[s], launches[s])
                for s in np.unique(rows // r)]

    def _classes(self, plan) -> int:
        """The doc classes of a plan's ragged insert, one launch each (their
        split does not depend on the card's SM count)."""
        return len(ragged_teams(plan.page_count, self._store.page_size, plan.page_table.shape[1],
                                SMEM_BUDGET, 1))

    # -- the per-round discipline ----------------------------------------------

    def _commit_round_ragged(self, enc, widths) -> None:
        """One round: one ragged apply over every row (one insert launch per
        non-empty doc class of the plan); under a mesh one per shard that
        holds a row with ops, over that shard's rows."""
        store = self._store
        rows = np.nonzero(enc.num_ops)[0]
        if len(rows):
            store.ensure_rows(rows, self._cum_ins[rows])
        docs_walked = pages_walked = 0
        for dev, tensors, l_rows, (plan, planes), launch in self._launch_plans(rows):
            ins_host = np.ascontiguousarray(enc.ins_count[l_rows], np.int32)
            apply_batch_ragged(
                *tensors, *planes, group_stream_arrays(enc, l_rows, plan.num_rows, dev),
                torch.from_numpy(ins_host).to(dev), page_count_host=plan.page_count,
                ins_counts_host=ins_host, launch_plan=launch,
            )
            GLOBAL_COUNTERS.add("streaming.ragged_applies", self._classes(plan))
            docs_walked += plan.docs_walked
            pages_walked += plan.pages_walked
        self._ragged_bookkeeping([(enc, widths)], docs_walked, pages_walked)

    def _ragged_bookkeeping(self, batch, docs_walked: int, pages_walked: int) -> None:
        """Committed ragged rounds: the capacity paid (no bucket rows, no
        padded steps: the real work), the occupancy and ragged-walk rows,
        dirty digest rows, the round count."""
        for enc, widths in batch:
            real = int(enc.num_ops.sum())
            self._commit_caps[id(enc)] = real
            if GLOBAL_DEVPROF.enabled:
                GLOBAL_DEVPROF.observe_round(occupancy_key(self._padded_docs, *widths), real,
                                             max(real, 1), origin="streaming.ragged")
                GLOBAL_DEVPROF.observe_ragged(docs_walked=docs_walked,
                                              pages_walked=pages_walked, real_ops=real)
            rows = np.nonzero(enc.num_ops)[0]
            if len(rows):
                self._digest_row_valid[rows] = False
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")

    def _commit_rounds_serial(self, batch) -> None:
        """Commit scheduled rounds one at a time (``fused_pipeline=False``,
        a block-chunked session): :meth:`_commit_round_ragged` each, then
        a page-pool snapshot (and a mesh one) when profiled."""
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            self._commit_round_ragged(enc, widths)
        if GLOBAL_DEVPROF.enabled:
            GLOBAL_DEVPROF.observe_page_pool(self._store.pool_stats())
            if self.mesh is not None:
                GLOBAL_DEVPROF.observe_mesh(self._mesh_stats())

    # -- the fused forms: a batch's rounds in one site call --------------------

    def _prep_fused_batch(self, batch):
        """Advance the cumulative inserts and give every round's touched
        rows their pages, in round order: the batch's rounds then apply
        over the plan as it stands after the whole batch (a round's rows
        hold at least the pages it needs).  The reference's ``("ragged",
        k)``, or ``("mesh_ragged", k)`` under a mesh."""
        store = self._store
        for enc, _ in batch:
            self._cum_ins += enc.ins_count
            rows = np.nonzero(enc.num_ops)[0]
            if len(rows):
                store.ensure_rows(rows, self._cum_ins[rows])
        return ("ragged" if self.mesh is None else "mesh_ragged", len(batch))

    def _stage_fused_batch(self, batch, statics):
        """Every round's streams of all D rows at the session's fixed
        widths, with its insert counts, in ONE int32 buffer, one upload:
        ``(StagedUpload, layout)``; under a mesh ``[(shard, StagedUpload,
        layout), ...]`` for each shard that holds an op anywhere in the
        batch, its rows through its copy lane."""
        if self.mesh is None:
            return self._stage_ragged_rows(batch, slice(0, self._padded_docs), self._copy_lane)
        r = self._store.rows_per_shard
        out = []
        for shard in range(self.mesh.size):
            rows = slice(shard * r, (shard + 1) * r)
            if any(enc.num_ops[rows].any() for enc, _ in batch):
                out.append((shard, *self._stage_ragged_rows(batch, rows,
                                                            self._shard_lanes[shard])))
        return out

    @staticmethod
    def _stage_ragged_rows(batch, rows: slice, lane):
        """``(StagedUpload, layout)``: the batch's streams and insert counts
        of ``rows``, packed and uploaded through ``lane``."""
        arrays = {}
        for r, (enc, _) in enumerate(batch):
            arrays.update({f"{r}.{n}": a for n, a in
                           group_stream_named(enc, rows, rows.stop - rows.start).items()})
            arrays[f"{r}.ins_counts"] = enc.ins_count[rows]
        flat, layout = pack_int32(arrays)
        return lane.upload(flat), layout

    def _dispatch_fused_batch(self, batch, statics, inputs, chain_digest: bool = False) -> bool:
        """The batch's rounds as ONE site call over the plan (meshless:
        ``apply_batch_ragged``; under a mesh ``apply_batch_ragged.mesh``
        per staged shard over its plan, counted as one fused dispatch, as
        the reference's), through the graph cache: eager on a signature's
        first occurrence, then one CUDA-graph replay.  Then the per-round
        bookkeeping, the ragged walk of the plan at the end of the batch.
        The digest is never chained (the reference's ragged forms do not
        either); the drain prefetches it separately."""
        store = self._store
        if self.mesh is None:
            plan, planes = self._ragged_planes()
            upload, layout = inputs
            self._run_ragged((store.pool_elem, store.pool_char, store.aux), plan, planes,
                             self._plan_cache.launch, upload.consume(), layout, batch,
                             slice(0, self._padded_docs))
            walked = [plan]
        else:
            planes, launches = self._shard_planes(), self._shard_launches()
            r = store.rows_per_shard
            for shard, upload, layout in inputs:
                plan, shard_planes = planes[shard]
                with self._on_device(shard):
                    self._run_ragged(store.shard_tensors(shard), plan, shard_planes,
                                     launches[shard], upload.consume(), layout, batch,
                                     slice(shard * r, (shard + 1) * r), shard=shard)
            GLOBAL_COUNTERS.add("streaming.fused_dispatches")
            walked = [plan for plan, _ in planes]
        self._ragged_bookkeeping(batch, sum(p.docs_walked for p in walked),
                                 sum(p.pages_walked for p in walked))
        if GLOBAL_DEVPROF.enabled:
            GLOBAL_DEVPROF.observe_page_pool(store.pool_stats())
            if self.mesh is not None:
                GLOBAL_DEVPROF.observe_mesh(self._mesh_stats())
        return False

    def _run_ragged(self, pool, plan, planes, launch, buf: torch.Tensor, layout, batch,
                    rows: slice, shard: Optional[int] = None) -> None:
        """The batch's per-round ragged applies over one plan (the whole
        pool, or a mesh shard's) in place, run by the session's (the
        shard's) graph cache.  Its key is the depth, the insert's launch
        plan and the buffer layout; the plan planes and the launch plan's
        card tensors are the graph's inputs, so a new allocation epoch
        keeps the graphs and only pool growth (new pool tensors, the
        binds) starts a new epoch.  Each round launches the ragged insert
        once per doc class (``streaming.ragged_applies``)."""
        pool_elem, pool_char, aux = pool
        k = len(batch)
        graphs = self._graphs if shard is None else self._shard_graphs[shard]
        site = "apply_batch_ragged" + ("" if shard is None else ".mesh")
        teams = [] if launch is None else list(launch.launches)
        # the plan lists every launch of the call, round by round, as the
        # padded forms' (ops/kernel.rounds_plan)
        static = (("rounds", k), ("plan", plan_static(teams * k)))
        extra = () if launch is None else launch.tensors()

        def body(b, *plane_inputs):
            t = unpack_int32(b, layout)
            grid = None if launch is None else launch.with_tensors(plane_inputs[6:])
            for r in range(k):
                _apply_batch_ragged(pool_elem, pool_char, aux, *plane_inputs[:6],
                                    group_stream_args(t, f"{r}."), t[f"{r}.ins_counts"],
                                    plan.page_count, grid)

        def profile():
            gmax = plan.page_table.shape[1]
            nbytes = sum(ragged_insert_bytes(plan.page_count,
                                             np.ascontiguousarray(enc.ins_count[rows], np.int32),
                                             self._store.page_size, gmax) for enc, _ in batch)
            return static, len(teams) * k, nbytes

        note_form(site, (pool_elem, pool_char, aux, buf),
                  lambda: graphs.run(("ragged", k, static, layout), site, body,
                                     (buf,) + tuple(planes) + tuple(extra),
                                     binds=(pool_elem, pool_char) + tuple(aux)),
                  profile, device=pool_elem.device)
        GLOBAL_COUNTERS.add("streaming.ragged_applies", self._classes(plan) * k)
