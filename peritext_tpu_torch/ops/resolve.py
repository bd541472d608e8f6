"""Read-time span resolution: mark table -> per-character mark state.

The convergent semantics (see ops/packed.py): a mark op covers character ``x``
iff, in the final element order, the op's start anchor position is <= the gap
just before ``x`` and its end anchor position is > that gap.  Anchor positions
live on the 2n+2 gap grid: ``before(e) -> 2*idx(e)``, ``after(e) ->
2*idx(e)+1``, ``startOfText -> -1``, ``endOfText -> +inf`` (reference
BoundaryPosition, src/micromerge.ts:266-270).

Winner resolution per character follows core/spans.ops_to_marks: the governing
op per mark type is the max op id among covering ops (LWW for strong/em/link,
per-comment-id for comments).  Because max is associative, the mark table is
consumed in CHUNKS of ``MARK_CHUNK`` rows, each reduced to per-slot maxima and
combined into running maxima.  A character is marked iff its max covering
*add* op beats its max covering *remove* op.

The "val trick": the carried state per key is the single value
``(op_id << 1) | is_add`` whose maximum's low bit is the add/remove verdict.
Op ids are below 2**31, so the value needs 32 unsigned bits; it is kept in
int64.  The per-comment-id reduction is a ``scatter_reduce(..., "amax")``
over the comment-id axis, bit-identical to the dense (J, C, S) masked max.

Visibility is computed here too: a slot is visible iff occupied and its
element id is absent from the tombstone table (a keyed set membership,
:func:`_row_isin`).

Everything is plain torch on whatever device the state lies on; there is no
hand kernel in this phase (nor a TPU kernel in the reference package).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..obs.spans import profiler_range
from ..schema import ALL_MARKS, MARK_INDEX
from ..utils.capture import captured
from .packed import (
    BK_BEFORE,
    BK_END_OF_TEXT,
    BK_START_OF_TEXT,
    MA_ADD,
    MAX_CTR,
    PackedDocs,
    pack_id,
)

NUM_TYPES = len(ALL_MARKS)
COMMENT_TYPE = MARK_INDEX["comment"]
LINK_TYPE = MARK_INDEX["link"]
#: chunk width of the mark-table loop: common tables (<= 128 rows) resolve
#: in a single pass
MARK_CHUNK = 128


class ResolvedDocs(NamedTuple):
    """Per-character resolved formatting for a batch of docs."""

    char: torch.Tensor  # int32 (D, S)
    visible: torch.Tensor  # bool (D, S)
    #: (D, T, S): winning op is an addMark, per LWW mark type T
    lww_active: torch.Tensor
    #: (D, S) int32: interned url of the winning link op (0 = none)
    link_attr: torch.Tensor
    #: (D, W, S) int64 holding unsigned 32-bit words: bit ``c % 32`` of word
    #: ``c // 32`` set iff interned comment id ``c``'s winning op is an
    #: addMark (W = ceil(C/32)); the same bits as the reference's uint32 plane
    comment_bits: torch.Tensor
    overflow: torch.Tensor  # bool (D,)


def _row_isin(values: torch.Tensor, table: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(D, S) bool: ``values[d, s]`` is among row d's ``table`` entries
    where ``live``.  Each value is keyed with its row, so one sorted set
    membership (a sort of the table's keys and a binary search of each
    value's) serves every row, in memory linear in D * (S + T); the
    (D, S, T) compare it equals would take D * S * T bytes (69 GB for 1025
    docs at 8192 slots and 8192 tombstones).  Dead entries key to -1,
    below every value's key, so nothing here sizes a tensor by the data:
    no host sync, which a CUDA graph of the fused commit (utils/graphs.py)
    could not hold (``torch.isin`` and boolean masks size theirs)."""
    if table.numel() == 0 or values.numel() == 0:
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    rows = torch.arange(values.shape[0], dtype=torch.int64, device=values.device)[:, None]
    key = lambda x: (rows << 32) | (x.to(torch.int64) & 0xFFFFFFFF)  # noqa: E731
    table_keys = torch.where(live, key(table), -1).reshape(-1).sort().values
    value_keys = key(values).reshape(-1)
    at = torch.searchsorted(table_keys, value_keys).clamp(max=table_keys.numel() - 1)
    return (table_keys[at] == value_keys).reshape(values.shape)


@captured(static=("comment_capacity", "with_comments"))
def resolve(state: PackedDocs, comment_capacity: int = 32,
            with_comments: bool = True) -> ResolvedDocs:
    """Batched resolution over the doc axis.

    ``with_comments=False`` skips the comment planes (``comment_bits`` has
    zero words); the comment-attr overflow check still runs."""
    elem = state.elem_id
    dev = elem.device
    d, s_cap = elem.shape
    m_cap = state.m_action.shape[1]
    pos = torch.arange(s_cap, dtype=torch.int32, device=dev)[None, :]  # (1, S)
    occupied = pos < state.num_slots[:, None]  # (D, S)
    big = 2 * s_cap + 1
    gap_before = 2 * pos  # the gap governing each slot's character
    c_cap = comment_capacity if with_comments else 0
    c_words = -(-c_cap // 32) if with_comments else 0

    lww_val = torch.zeros((d, NUM_TYPES, s_cap), dtype=torch.int64, device=dev)
    link_attr = torch.zeros((d, s_cap), dtype=torch.int32, device=dev)
    # one spill row past the comment ids takes the out-of-range rows
    c_val = torch.zeros((d, c_cap + 1, s_cap), dtype=torch.int64, device=dev)
    error = torch.zeros((d,), dtype=torch.bool, device=dev)

    def anchor_gap(kind, anchor):
        # (D, J, S) unique-id match; masked max == match position, -1 if none
        idx = torch.where(
            (elem[:, None, :] == anchor[:, :, None]) & occupied[:, None, :],
            pos[:, None, :], -1,
        ).amax(dim=2)
        elem_gap = torch.where(kind == BK_BEFORE, 2 * idx, 2 * idx + 1)
        gap = torch.where(
            kind == BK_START_OF_TEXT, -1,
            torch.where(kind == BK_END_OF_TEXT, big, elem_gap),
        )
        anchored = (kind == BK_START_OF_TEXT) | (kind == BK_END_OF_TEXT) | (idx >= 0)
        return gap, anchored

    chunk = max(1, min(MARK_CHUNK, m_cap))
    for j in range(-(-m_cap // chunk)):
        # the last chunk may overlap the one before (a clamped slice, as in
        # the reference); max and or are idempotent, so that is harmless
        lo = min(j * chunk, m_cap - chunk)
        row = lambda a: a[:, lo:lo + chunk]  # noqa: E731
        action = row(state.m_action)
        mtype = row(state.m_type)
        op = row(state.m_op)
        attr = row(state.m_attr)
        live = action != 0

        # the phase markers (obs/spans.py) are profiler ranges, no-ops
        # unless a profiler records
        with profiler_range("resolve.anchors"):
            s_gap, s_ok = anchor_gap(row(state.m_start_kind), row(state.m_start_elem))
            e_gap, e_ok = anchor_gap(row(state.m_end_kind), row(state.m_end_elem))
            error = error | (live & ~(s_ok & e_ok)).any(dim=1)

        with profiler_range("resolve.cover"):
            cover = (
                live[:, :, None]
                & (s_gap[:, :, None] <= gap_before[:, None, :])
                & (gap_before[:, None, :] < e_gap[:, :, None])
                & occupied[:, None, :]
            )  # (D, J, S)
            val = (op.to(torch.int64) << 1) | (action == MA_ADD).to(torch.int64)
            val_col = val[:, :, None]

            for t in range(NUM_TYPES):
                if t == COMMENT_TYPE:
                    continue
                sel = cover & (mtype == t)[:, :, None]
                chunk_val = torch.where(sel, val_col, 0).amax(dim=1)  # (D, S)
                if t == LINK_TYPE:
                    # attr of the chunk winner (duplicate rows tie with equal
                    # attrs); gated on add at the output
                    chunk_attr = torch.where(
                        sel & (val_col == chunk_val[:, None, :]), attr[:, :, None], 0
                    ).amax(dim=1)
                    link_attr = torch.where(chunk_val > lww_val[:, t], chunk_attr, link_attr)
                lww_val[:, t] = torch.maximum(lww_val[:, t], chunk_val)

        is_comment = mtype == COMMENT_TYPE
        if with_comments:
            with profiler_range("resolve.comments"):
                data = torch.where(cover & is_comment[:, :, None], val_col, 0)  # (D, J, S)
                in_range = (attr >= 0) & (attr < c_cap)
                index = torch.where(in_range, attr, c_cap).to(torch.int64)
                c_val = c_val.scatter_reduce(
                    1, index[:, :, None].expand(-1, -1, s_cap), data, "amax",
                    include_self=True,
                )

        error = error | (live & is_comment & (attr >= comment_capacity)).any(dim=1)

    with profiler_range("resolve.visible"):
        # Visibility: occupied and not tombstoned.
        visible = occupied & ~_row_isin(elem, state.tomb_id, state.tomb_id != 0)

        lww_active = (lww_val & 1) == 1
        if with_comments:
            # pack per-id verdicts into 32-bit words: (C, S) -> (W, S)
            active = c_val[:, :c_cap] & 1
            padded = torch.zeros((d, c_words * 32, s_cap), dtype=torch.int64, device=dev)
            padded[:, :c_cap] = active
            weights = (1 << torch.arange(32, dtype=torch.int64, device=dev))[None, None, :, None]
            comment_bits = (padded.reshape(d, c_words, 32, s_cap) * weights).sum(dim=2)
        else:
            comment_bits = torch.zeros((d, 0, s_cap), dtype=torch.int64, device=dev)
    return ResolvedDocs(
        char=state.char,
        visible=visible,
        lww_active=lww_active,
        link_attr=torch.where(lww_active[:, LINK_TYPE], link_attr, 0),
        comment_bits=comment_bits,
        overflow=state.overflow | error,
    )


def resolve_cursors(state: PackedDocs, visible, cursor_elem):
    """Batched stable-cursor resolution.

    Reference ``resolveCursor`` (src/micromerge.ts:868-870) returns the count
    of visible elements strictly before the cursor's element in metadata
    order, which collapses the cursor leftward when its anchor character has
    been deleted.

    ``cursor_elem`` is (D, C) packed element ids, 0 = padding; ``visible``
    is the (D, S) visibility plane from :func:`resolve`.  Returns (D, C)
    int32 visible indices, -1 for padding or element ids absent from the doc.
    """
    elem = state.elem_id
    s_cap = elem.shape[1]
    pos = torch.arange(s_cap, dtype=torch.int32, device=elem.device)
    occupied = pos[None, :] < state.num_slots[:, None]
    match = (elem[:, None, :] == cursor_elem[:, :, None]) & occupied[:, None, :]  # (D, C, S)
    found = match.any(dim=2)
    p = torch.where(match, pos, s_cap).amin(dim=2)  # argmax: first match
    before = (visible[:, None, :] & (pos[None, None, :] < p[:, :, None])).sum(
        dim=2, dtype=torch.int32
    )
    return torch.where((cursor_elem != 0) & found, before, -1).to(torch.int32)


def cursor_width_bucket(needed: int) -> int:
    """Power-of-two cursor-axis width (floor 4), as the reference pads it."""
    w = 4
    while w < needed:
        w *= 2
    return w


def pack_cursor_rows(cursor_map, num_docs: int, actor_table_for) -> np.ndarray:
    """(D, W) packed cursor-element matrix for a per-doc cursor mapping.

    ``cursor_map``: {doc_index: [Cursor, ...]} with reference-shaped Cursor
    dicts; ``actor_table_for(doc_index)`` returns the doc's actor interner.
    Unknown actors / over-wide counters pack to 0 (= resolves to -1)."""
    width = cursor_width_bucket(max([len(c) for c in cursor_map.values()] + [1]))
    rows = np.zeros((num_docs, width), np.int32)
    for d, cursors in cursor_map.items():
        actors = actor_table_for(d)
        if actors is None:
            continue
        for j, cur in enumerate(cursors):
            ctr, actor = cur["elemId"]
            idx = actors.get(actor)
            if idx is not None and ctr <= MAX_CTR:
                rows[d, j] = pack_id(ctr, idx)
    return rows


def oracle_cursor_positions(doc, cursors) -> List[int]:
    """Scalar-replay cursor resolution with device semantics (-1 for absent
    elements) — the fallback-doc path."""
    from ..core.errors import IndexOutOfBounds, MissingObject

    out = []
    for cur in cursors:
        try:
            out.append(doc.resolve_cursor(cur))
        except (IndexOutOfBounds, MissingObject):
            out.append(-1)
    return out
