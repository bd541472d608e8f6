"""DocBatch: the batched merge on the card.

Given change logs for D collaborative documents (each a dict actor ->
[Change], what the replication layer accumulates), converge all of them at
once on the device and return each document's formatted spans.

Pipeline: host causal sort + interning + stream splitting (ops/encode.py) ->
device batched apply (ops/kernel.py, with the insert kernel of
ops/insert.py) -> device span resolution (ops/resolve.py) -> host decode
(ops/decode.py).  Documents the device path cannot express (non-text
objects, too many actors) or that overflow their static capacities fall
back to the scalar oracle (core/doc.py), the reference's own semantics;
``MergeReport.fallback_docs`` says which.

Semantically equivalent to constructing a fresh ``core.Doc`` per workload
and replaying all changes.  Only ``layout="padded"`` is ported: every doc
sits in one (D, S) batch at the configured capacities.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Union

import torch

from ..core.doc import Doc
from ..core.types import Change, FormatSpan
from ..obs import MergeStats, stage_timer
from ..ops.decode import decode_block_spans, decode_doc_root
from ..ops.encode import EncodedBatch, encode_workloads
from ..ops.kernel import apply_batch, encoded_arrays_of
from ..ops.packed import PackedDocs, empty_docs
from ..ops.resolve import (
    ResolvedDocs,
    oracle_cursor_positions,
    pack_cursor_rows,
    resolve,
    resolve_cursors,
)
from ..parallel.causal import causal_sort
from ..utils.device import resolve_device

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


class DocBatch:
    """Batched document merge engine.

    Capacities are static: ``slot_capacity`` bounds elements-including-
    tombstones per doc, ``mark_capacity`` bounds mark ops per doc,
    ``comment_capacity`` bounds distinct interned attrs per doc,
    ``op_capacity`` bounds the insert and delete streams per merge call
    (None = sized to the batch).  ``device`` defaults to ``cuda``; with no
    card present, pass ``device="cpu"`` to run the plain torch path.
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
    ) -> None:
        if layout not in ("padded", "paged", "ragged"):
            raise ValueError(f"unknown layout: {layout!r}")
        if layout != "padded":
            raise NotImplementedError(
                f"layout={layout!r} is not ported yet (ROADMAP.md queue 1: "
                f"'{'Paged' if layout == 'paged' else 'Ragged'} layout')"
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

    # -- device pipeline ---------------------------------------------------

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
        with stage_timer(stats, "encode_seconds"):
            encoded = self.encode(workloads)
        with stage_timer(stats, "apply_seconds", self.device):
            state = self.apply_encoded(encoded)
        with stage_timer(stats, "resolve_seconds", self.device):
            resolved_dev = resolve(state, self.comment_capacity)
            # one whole-array transfer per field, up front
            resolved = ResolvedDocs(*(x.cpu().numpy() for x in resolved_dev))

        fallback = set(encoded.fallback_docs) | {
            int(d) for d in resolved.overflow.nonzero()[0] if d < len(workloads)
        }

        # Fallback docs may be replayed for both cursors and spans; build each
        # oracle doc at most once per merge.
        oracle_docs: Dict[int, Doc] = {}

        def oracle_doc_for(d: int) -> Doc:
            if d not in oracle_docs:
                oracle_docs[d] = _oracle_doc(workloads[d])
            return oracle_docs[d]

        cursor_positions: Optional[List[List[int]]] = None
        if cursors is not None:
            cursor_positions = self._resolve_cursor_batch(
                state, resolved_dev.visible, encoded, cursors, fallback, oracle_doc_for
            )

        with stage_timer(stats, "decode_seconds"):
            # register table transfer (small: 5 x (D, R) int32)
            regs = SimpleNamespace(
                **{f: getattr(state, f).cpu().numpy()
                   for f in ("r_obj", "r_key", "r_op", "r_kind", "r_val", "num_regs")}
            )
            device_mask = [d not in fallback for d in range(len(workloads))]
            block_spans = decode_block_spans(
                resolved,
                lambda d: encoded.attr_tables[d],
                lambda d: encoded.attr_tables[d],
                doc_mask=device_mask,
            )
            spans: List[List[FormatSpan]] = []
            roots: List[dict] = []
            device_ops = 0
            fallback_ops = 0
            for d in range(len(workloads)):
                if d in fallback:
                    doc = oracle_doc_for(d)
                    spans.append(doc.get_text_with_formatting(["text"]))
                    roots.append(doc.root)
                    fallback_ops += int(encoded.num_ops[d])
                else:
                    spans.append(block_spans[d])
                    roots.append(
                        decode_doc_root(regs, resolved, d, encoded.map_tables[d])
                    )
                    device_ops += int(encoded.num_ops[d])

        stream_capacity = encoded.num_docs * (
            encoded.ins_op.shape[1]
            + encoded.del_target.shape[1]
            + next(iter(encoded.marks.values())).shape[1]
            + next(iter(encoded.map_ops.values())).shape[1]
        )
        stats.device_ops = device_ops
        stats.fallback_ops = fallback_ops
        stats.fallback_docs = len(fallback)
        stats.device_docs = len(workloads) - len(fallback)
        stats.padding_efficiency = (
            float(encoded.num_ops.sum()) / stream_capacity if stream_capacity else 0.0
        )
        return MergeReport(
            spans=spans,
            fallback_docs=sorted(fallback),
            device_ops=device_ops,
            stats=stats,
            cursor_positions=cursor_positions,
            roots=roots,
        )

    def _resolve_cursor_batch(
        self, state, visible_dev, encoded, cursors, fallback, oracle_doc_for
    ) -> List[List[int]]:
        """Pack per-doc cursor element ids with each doc's actor table and
        resolve them on the device in one batched call; fallback docs replay
        through the oracle."""
        num_docs = state.elem_id.shape[0]
        cursor_map = {
            d: doc_cursors
            for d, doc_cursors in enumerate(cursors)
            if d not in fallback
        }
        cursor_elem = pack_cursor_rows(
            cursor_map, num_docs, lambda d: encoded.actor_tables[d]
        )
        positions = resolve_cursors(
            state, visible_dev, torch.as_tensor(cursor_elem).to(self.device)
        ).cpu().numpy()
        out: List[List[int]] = []
        for d, doc_cursors in enumerate(cursors):
            if d in fallback:
                out.append(oracle_cursor_positions(oracle_doc_for(d), doc_cursors))
            else:
                out.append([int(p) for p in positions[d, : len(doc_cursors)]])
        return out


def _oracle_doc(workload: Workload) -> Doc:
    doc = Doc("batch-fallback")
    for change in causal_sort([ch for log in workload.values() for ch in log]):
        doc.apply_change(change)
    return doc


def oracle_merge(workloads: Sequence[Workload]) -> List[List[FormatSpan]]:
    """Scalar reference path for the same inputs (differential-test anchor)."""
    return [_oracle_doc(w).get_text_with_formatting(["text"]) for w in workloads]
