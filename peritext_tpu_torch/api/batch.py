"""DocBatch: the batched merge on the card.

Given change logs for D collaborative documents (each a dict actor ->
[Change], what the replication layer accumulates), converge all of them at
once on the device and return each document's formatted spans.

Pipeline: host causal sort + interning + stream splitting (ops/encode.py) ->
device batched apply -> device span resolution (ops/resolve.py) -> host
decode (ops/decode.py).  Documents the device path cannot express (non-text
objects, too many actors) or that overflow their static capacities fall
back to the scalar oracle (core/doc.py), the reference's own semantics;
``MergeReport.fallback_docs`` says which.

Three storage layouts, with equal results:

* ``"padded"``: every doc in one (D, S) batch at the configured capacities
  (ops/kernel.apply_batch, the insert kernel of ops/insert.py);
* ``"paged"``: the element planes in a page pool (store/paged.py); docs
  group by power-of-two page count and op count, and each group encodes,
  applies (ops/kernel.apply_batch_paged) and resolves at its own widths;
* ``"ragged"``: the same pool, with the whole batch applied at once against
  every doc's true pages and op counts (ops/ragged.apply_batch_ragged, the
  ragged insert kernel of ops/ragged_insert.py).

Semantically equivalent to constructing a fresh ``core.Doc`` per workload
and replaying all changes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core.doc import Doc
from ..core.types import Change, FormatSpan
from ..obs import MergeStats, stage_timer
from ..ops.decode import decode_block_spans, decode_doc_root
from ..ops.encode import EncodedBatch, _DocStreams, encode_doc_streams, encode_workloads, pad_doc_streams
from ..ops.kernel import apply_batch, encoded_arrays_of
from ..ops.packed import PackedDocs, empty_docs
from ..ops.ragged import apply_batch_ragged, plan_arrays, stream_counts
from ..ops.resolve import (
    ResolvedDocs,
    oracle_cursor_positions,
    pack_cursor_rows,
    resolve,
    resolve_cursors,
)
from ..parallel.causal import causal_sort
from ..store.paged import DEFAULT_PAGE_SIZE, PagedDocStore, group_stream_arrays, plan_page_groups
from ..store.ragged import ragged_plan
from ..utils.device import resolve_device
from ..utils.shapes import next_pow2

Workload = Dict[str, List[Change]]


@dataclass
class MergeReport:
    """Outcome of a batched merge."""

    spans: List[List[FormatSpan]]
    #: doc indices resolved by the scalar oracle instead of the device
    fallback_docs: List[int] = field(default_factory=list)
    #: ops applied on device (excludes fallback docs)
    device_ops: int = 0
    #: per-merge observability (stage timings, padding efficiency)
    stats: MergeStats = field(default_factory=MergeStats)
    #: resolved cursor indices (aligned with merge()'s ``cursors`` argument);
    #: -1 = cursor's element does not exist in the converged document
    cursor_positions: Optional[List[List[int]]] = None
    #: per-doc materialized root map (nested maps + text list), equal to the
    #: scalar oracle's ``Doc.root``
    roots: Optional[List[dict]] = None


class _Group(NamedTuple):
    """One resolved block of a merge: row i (< len(docs)) holds doc
    ``docs[i]``; rows past that are padding."""

    docs: np.ndarray
    enc: EncodedBatch
    state: PackedDocs
    resolved_dev: ResolvedDocs
    resolved: ResolvedDocs  # host numpy copy


class DocBatch:
    """Batched document merge engine.

    Capacities are static: ``slot_capacity`` bounds elements-including-
    tombstones per doc, ``mark_capacity`` bounds mark ops per doc,
    ``comment_capacity`` bounds distinct interned attrs per doc,
    ``op_capacity`` bounds the insert and delete streams per merge call
    (None = sized to the batch).  ``layout`` picks the storage layout
    (module doc); ``page_size`` is the page width in slots of the paged and
    ragged layouts (default :data:`~peritext_tpu_torch.store.DEFAULT_PAGE_SIZE`),
    and must divide ``slot_capacity`` there.  ``device`` defaults to
    ``cuda``; with no card present, pass ``device="cpu"`` to run the plain
    torch path.
    """

    def __init__(
        self,
        slot_capacity: int = 256,
        mark_capacity: int = 64,
        comment_capacity: int = 32,
        op_capacity: Optional[int] = None,
        map_capacity: int = 32,
        device: Optional[Union[str, torch.device]] = None,
        mesh=None,
        guard: bool = False,
        layout: str = "padded",
        page_size: Optional[int] = None,
    ) -> None:
        if layout not in ("padded", "paged", "ragged"):
            raise ValueError(f"unknown layout: {layout!r}")
        self.layout = layout
        self.page_size = int(DEFAULT_PAGE_SIZE if page_size is None else page_size)
        if layout != "padded" and slot_capacity % self.page_size:
            raise ValueError(
                f"slot_capacity {slot_capacity} must be a multiple of "
                f"page_size {self.page_size} under layout={layout!r}"
            )
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP.md queue 1: 'Multi-GPU mesh')"
            )
        if guard:
            raise NotImplementedError(
                "guard=True is not ported yet (ROADMAP.md queue 1: 'Durability', "
                "guard and the supervisor)"
            )
        self.device = resolve_device(device)
        self.slot_capacity = slot_capacity
        self.mark_capacity = mark_capacity
        self.comment_capacity = comment_capacity
        self.op_capacity = op_capacity
        self.map_capacity = map_capacity
        #: the page store of the most recent paged or ragged merge
        self.last_store: Optional[PagedDocStore] = None

    # -- padded layout -------------------------------------------------------

    def encode(self, workloads: Sequence[Workload]) -> EncodedBatch:
        return encode_workloads(
            list(workloads),
            insert_capacity=self.op_capacity,
            delete_capacity=self.op_capacity,
            mark_capacity=self.mark_capacity,
        )

    def apply_encoded(self, encoded: EncodedBatch) -> PackedDocs:
        """Run the batched apply on an encoded batch."""
        arrays = encoded_arrays_of(encoded, self.device)
        state = empty_docs(
            encoded.num_docs,
            self.slot_capacity,
            self.mark_capacity,
            tomb_capacity=arrays[3].shape[1],  # delete-stream width
            map_capacity=self.map_capacity,
            device=self.device,
        )
        return apply_batch(state, arrays)

    def _run_padded(self, workloads, stats: MergeStats) -> List[_Group]:
        with stage_timer(stats, "encode_seconds"):
            encoded = self.encode(workloads)
        with stage_timer(stats, "apply_seconds", self.device):
            state = self.apply_encoded(encoded)
        with stage_timer(stats, "resolve_seconds", self.device):
            group = self._resolve_group(np.arange(len(workloads)), encoded, state)
        capacity = encoded.num_docs * sum(_stream_widths(encoded))
        stats.padding_efficiency = (
            float(encoded.num_ops.sum()) / capacity if capacity else 0.0
        )
        return [group]

    # -- pooled layouts (store/) ---------------------------------------------

    def _encode_pooled(self, workloads):
        """Per-doc streams, with the configured capacities applied as per-doc
        fallback thresholds (group streams size to their own maxima, so the
        same docs fall back under every layout); fallback docs carry empty
        streams.  Returns ``(streams, fallback, actor_tables, attr_tables,
        map_tables)``."""
        per_doc, fallback, actor_tables, attr_tables, map_tables = (
            encode_doc_streams(workloads)
        )
        fb = set(fallback)
        for d, s in enumerate(per_doc):
            over = len(s.marks) > self.mark_capacity
            if self.op_capacity is not None:
                over = over or len(s.ins) > self.op_capacity or len(s.dels) > self.op_capacity
            if over:
                fb.add(d)
        streams = [_DocStreams() if d in fb else s for d, s in enumerate(per_doc)]
        return streams, fb, actor_tables, attr_tables, map_tables

    def _encode_paged(self, workloads):
        """``[(bucket_pages, docs, EncodedBatch), ...]``: docs grouped by
        (power-of-two page need, power-of-two op count), each group padded
        to its own widths.  The op-count component keeps sub-page docs from
        padding their streams to the widest short doc's."""
        streams, fb, actor_tables, attr_tables, map_tables = self._encode_pooled(workloads)
        page_groups = plan_page_groups(
            range(len(streams)), lambda d: -(-max(1, len(streams[d].ins)) // self.page_size),
            max(1, self.slot_capacity // self.page_size),
        )
        encs = []
        for g, rows in page_groups:
            by_ops: Dict[int, List[int]] = {}
            for d in rows.tolist():
                s = streams[d]
                ops = len(s.ins) + len(s.dels) + len(s.marks) + len(s.maps)
                by_ops.setdefault(next_pow2(max(8, ops)), []).append(d)
            for sb in sorted(by_ops):
                docs = np.asarray(by_ops[sb], np.int64)
                enc = pad_doc_streams(
                    [streams[d] for d in docs],
                    [i for i, d in enumerate(docs) if d in fb],
                    [actor_tables[d] for d in docs],
                    [attr_tables[d] for d in docs],
                    map_tables=[map_tables[d] for d in docs],
                )
                encs.append((g, docs, enc))
        return encs

    def _run_paged(self, workloads, stats: MergeStats) -> List[_Group]:
        with stage_timer(stats, "encode_seconds"):
            encs = self._encode_paged(workloads)
        with stage_timer(stats, "apply_seconds", self.device):
            store = self.last_store = PagedDocStore(
                len(workloads),
                slot_capacity=self.slot_capacity,
                mark_capacity=self.mark_capacity,
                tomb_capacity=max((enc.del_target.shape[1] for _, _, enc in encs), default=8),
                map_capacity=self.map_capacity,
                page_size=self.page_size,
                device=self.device,
            )
            capacity = real_ops = 0
            for g, docs, enc in encs:
                store.ensure_rows(docs, stream_counts(enc)[0])
                b = next_pow2(len(docs))
                store.apply_rows(docs, g, group_stream_arrays(enc, None, b, self.device),
                                 pad_rows_to=b)
                # what the dispatched group paid: b padded rows
                capacity += b * sum(_stream_widths(enc))
                real_ops += int(enc.num_ops.sum())
        with stage_timer(stats, "resolve_seconds", self.device):
            groups = [
                self._resolve_group(docs, enc,
                                    store.materialize_rows(docs, g, pad_rows_to=next_pow2(len(docs))))
                for g, docs, enc in encs
            ]
        stats.padding_efficiency = real_ops / capacity if capacity else 0.0
        _pool_extras(stats, "layout_paged", store)
        return groups

    def _encode_ragged(self, workloads) -> EncodedBatch:
        """One EncodedBatch for the whole batch, padded to its own maxima."""
        streams, fb, actor_tables, attr_tables, map_tables = self._encode_pooled(workloads)
        return pad_doc_streams(streams, sorted(fb), actor_tables, attr_tables,
                               map_tables=map_tables)

    def _ragged_store(self, enc: EncodedBatch):
        """``(store, plan)``: a page store sized to the batch's true page
        need (page 0 is the null page), every row allocated, and the plan
        snapshotted after the allocation."""
        ins_counts, _ = stream_counts(enc)
        max_pages = max(1, self.slot_capacity // self.page_size)
        page_need = np.minimum(-(-np.maximum(ins_counts, 1) // self.page_size), max_pages)
        store = PagedDocStore(
            enc.num_docs,
            slot_capacity=self.slot_capacity,
            mark_capacity=self.mark_capacity,
            tomb_capacity=enc.del_target.shape[1],
            map_capacity=self.map_capacity,
            page_size=self.page_size,
            initial_pages=1 + int(page_need.sum()),
            device=self.device,
        )
        store.ensure_rows(np.arange(enc.num_docs, dtype=np.int64), ins_counts)
        return store, ragged_plan(store)

    def _run_ragged(self, workloads, stats: MergeStats) -> List[_Group]:
        with stage_timer(stats, "encode_seconds"):
            enc = self._encode_ragged(workloads)
        with stage_timer(stats, "apply_seconds", self.device):
            store, plan = self._ragged_store(enc)
            self.last_store = store
            apply_batch_ragged(
                store.pool_elem, store.pool_char, store.aux, *plan_arrays(plan, self.device),
                group_stream_arrays(enc, None, enc.num_docs, self.device),
                torch.from_numpy(stream_counts(enc)[0]).to(self.device),
                page_count_host=plan.page_count,
            )
        with stage_timer(stats, "resolve_seconds", self.device):
            # one dense block at the batch's true widest page count
            state = store.materialize_rows(plan.row_idx, max(1, int(plan.page_count.max(initial=0))))
            group = self._resolve_group(plan.row_idx, enc, state)
        # no padded rows or steps are dispatched: every slot is a real op
        stats.padding_efficiency = 1.0 if int(enc.num_ops.sum()) else 0.0
        _pool_extras(stats, "layout_ragged", store)
        return [group]

    # -- merge -----------------------------------------------------------------

    def _resolve_group(self, docs, enc: EncodedBatch, state: PackedDocs) -> _Group:
        resolved_dev = resolve(state, self.comment_capacity)
        # one whole-array transfer per field, up front
        resolved = ResolvedDocs(*(x.cpu().numpy() for x in resolved_dev))
        return _Group(np.asarray(docs, np.int64), enc, state, resolved_dev, resolved)

    def merge(
        self,
        workloads: Sequence[Workload],
        cursors: Optional[Sequence[Sequence[dict]]] = None,
    ) -> MergeReport:
        """Converge every workload; returns per-doc formatted spans.

        ``cursors`` optionally gives, per document, stable cursors
        (``{"objectId", "elemId"}``, the reference's ``Cursor`` shape,
        src/micromerge.ts:859-870) to resolve against the converged state;
        resolved visible indices land in ``MergeReport.cursor_positions``
        (-1 when the cursor's element is absent).  Device docs resolve on
        the device (ops/resolve.resolve_cursors); fallback docs via the
        oracle.
        """
        stats = MergeStats(docs=len(workloads))
        run = {"padded": self._run_padded, "paged": self._run_paged,
               "ragged": self._run_ragged}[self.layout]
        groups = run(workloads, stats)

        fallback = set()
        for grp in groups:
            fallback.update(int(grp.docs[i]) for i in grp.enc.fallback_docs)
            # only real rows: a padding row reads the last doc's aux row and
            # may carry its overflow flag
            overflow = grp.resolved.overflow[: len(grp.docs)]
            fallback.update(int(grp.docs[i]) for i in np.nonzero(overflow)[0])

        # Fallback docs may be replayed for both cursors and spans; build each
        # oracle doc at most once per merge.
        oracle_docs: Dict[int, Doc] = {}

        def oracle_doc_for(d: int) -> Doc:
            if d not in oracle_docs:
                oracle_docs[d] = _oracle_doc(workloads[d])
            return oracle_docs[d]

        cursor_positions: Optional[List[List[int]]] = None
        if cursors is not None:
            cursor_positions = self._resolve_cursors(groups, cursors, fallback, oracle_doc_for)

        with stage_timer(stats, "decode_seconds"):
            spans: List[Optional[List[FormatSpan]]] = [None] * len(workloads)
            roots: List[Optional[dict]] = [None] * len(workloads)
            device_ops = 0
            fallback_ops = 0
            for grp in groups:
                enc = grp.enc
                # register table transfer (small: 5 x (B, R) int32)
                regs = SimpleNamespace(
                    **{f: getattr(grp.state, f).cpu().numpy()
                       for f in ("r_obj", "r_key", "r_op", "r_kind", "r_val", "num_regs")}
                )
                mask = np.zeros(grp.resolved.visible.shape[0], bool)
                mask[: len(grp.docs)] = [int(d) not in fallback for d in grp.docs]
                block_spans = decode_block_spans(
                    grp.resolved,
                    lambda i: enc.attr_tables[i],
                    lambda i: enc.attr_tables[i],
                    doc_mask=mask,
                )
                for i, d in enumerate(grp.docs.tolist()):
                    if d in fallback:
                        doc = oracle_doc_for(d)
                        spans[d] = doc.get_text_with_formatting(["text"])
                        roots[d] = doc.root
                        fallback_ops += int(enc.num_ops[i])
                    else:
                        spans[d] = block_spans[i]
                        roots[d] = decode_doc_root(regs, grp.resolved, i, enc.map_tables[i])
                        device_ops += int(enc.num_ops[i])

        stats.device_ops = device_ops
        stats.fallback_ops = fallback_ops
        stats.fallback_docs = len(fallback)
        stats.device_docs = len(workloads) - len(fallback)
        return MergeReport(
            spans=spans,
            fallback_docs=sorted(fallback),
            device_ops=device_ops,
            stats=stats,
            cursor_positions=cursor_positions,
            roots=roots,
        )

    def _resolve_cursors(self, groups, cursors, fallback, oracle_doc_for) -> List[List[int]]:
        """Pack each group's device docs' cursor element ids with their actor
        tables and resolve them on the device, one batched call per group;
        fallback docs replay through the oracle."""
        out: List[List[int]] = [[] for _ in cursors]
        for grp in groups:
            enc = grp.enc
            local = {i: list(cursors[d]) for i, d in enumerate(grp.docs.tolist())
                     if d not in fallback}
            cursor_elem = pack_cursor_rows(local, grp.state.elem_id.shape[0],
                                           lambda i: enc.actor_tables[i])
            positions = resolve_cursors(
                grp.state, grp.resolved_dev.visible, torch.as_tensor(cursor_elem).to(self.device)
            ).cpu().numpy()
            for i, row in local.items():
                out[int(grp.docs[i])] = [int(p) for p in positions[i, : len(row)]]
        for d in sorted(fallback):
            out[d] = oracle_cursor_positions(oracle_doc_for(d), cursors[d])
        return out


def _stream_widths(enc: EncodedBatch):
    return (enc.ins_op.shape[1], enc.del_target.shape[1],
            next(iter(enc.marks.values())).shape[1],
            next(iter(enc.map_ops.values())).shape[1])


def _pool_extras(stats: MergeStats, layout_key: str, store: PagedDocStore) -> None:
    pool = store.pool_stats()
    stats.extras[layout_key] = 1.0
    stats.extras["page_pool_utilization"] = pool["pool_utilization"]
    stats.extras["page_internal_frag_ratio"] = pool["internal_frag_ratio"]


def _oracle_doc(workload: Workload) -> Doc:
    doc = Doc("batch-fallback")
    for change in causal_sort([ch for log in workload.values() for ch in log]):
        doc.apply_change(change)
    return doc


def oracle_merge(workloads: Sequence[Workload]) -> List[List[FormatSpan]]:
    """Scalar reference path for the same inputs (differential-test anchor)."""
    return [_oracle_doc(w).get_text_with_formatting(["text"]) for w in workloads]
