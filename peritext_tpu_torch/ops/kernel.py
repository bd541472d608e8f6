"""Batched CRDT op application on the padded ``(D, S)`` layout, and its
paged twin (:func:`apply_batch_paged`) over a page pool.

Phases, each over the whole doc axis at once (the reference package vmaps a
per-doc function; here the doc axis is a batch dimension written out):

1. **Inserts** — the only sequential phase, ops/insert.py: the CUDA kernel
   on the card, its plain torch version on the CPU.  Each step realizes the
   reference's RGA insert-after-reference with its convergence skip
   (src/micromerge.ts:1187-1245).
2. **Deletes** — tombstones are idempotent flag-sets that commute with each
   other and do not affect insert placement (the RGA skip compares only
   element ids), so the whole delete stream applies as ONE vectorized
   any-match over (S x KD) (reference applyListUpdate, :1250-1277).
3. **Marks** — already encoded in mark-table layout host-side; appended with
   one masked scatter (span semantics live in ops/resolve.py).
4. **Map registers** — LWW upsert, a loop over the map stream.

A reference element that cannot be found, or a capacity overflow, sets the
doc's ``overflow`` flag; the API layer falls back to the scalar oracle for
flagged docs.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from .encode import MARK_COLS, EncodedBatch
from .insert import insert_batch
from .packed import MAP_STREAM_COLS, PackedDocs


def _append_rows(tables: Dict[str, torch.Tensor], count, rows: Dict[str, torch.Tensor],
                 rows_count):
    """Append ``rows`` (D, KM) into the append-only ``tables`` (D, cap) at
    [count, count + rows_count) per doc; writes past ``cap`` are dropped,
    never wrapped or clamped into range.  Returns (tables, new_count,
    overflow)."""
    first = next(iter(tables.values()))
    d, cap = first.shape
    km = next(iter(rows.values())).shape[1]
    src = torch.arange(km, dtype=torch.int32, device=first.device)[None, :]
    dst = count[:, None] + src
    keep = (src < rows_count[:, None]) & (dst < cap)
    # dropped rows land in a spill column past the table, cut off below
    index = torch.where(keep, dst, cap).to(torch.int64)
    out = {}
    for col, table in tables.items():
        spill = torch.cat([table, table.new_zeros((d, 1))], dim=1)
        out[col] = spill.scatter(1, index, rows[col])[:, :cap]
    overflow = count + rows_count > cap
    new_count = (count + rows_count).clamp(max=cap)
    return out, new_count, overflow


def _post_insert(state: PackedDocs, del_target, marks, mark_count,
                 exists=None) -> PackedDocs:
    """Phases 2+3 (deletes, marks) for every doc, after the insert phase.

    ``exists`` optionally carries the precomputed (D, KD) target-exists
    mask, for callers whose element planes do not live in ``state`` (the
    ragged pool walk, ops/ragged.py); with it given, ``state.elem_id`` is
    never read."""
    live = del_target != 0  # (D, KD)
    if exists is None:
        exists = (state.elem_id[:, :, None] == del_target[:, None, :]).any(dim=1)
    # Idempotence: skip targets already tombstoned in the carried-over table
    # AND duplicates within this stream (concurrent deletes of one char).
    kd = del_target.shape[1]
    order_idx = torch.arange(kd, device=del_target.device)
    dup_earlier = (
        (del_target[:, None, :] == del_target[:, :, None])
        & (order_idx[:, None] < order_idx[None, :])[None]
    ).any(dim=1)
    already = (
        (state.tomb_id[:, :, None] == del_target[:, None, :]).any(dim=1) | dup_earlier
    ) & live
    del_err = (live & ~exists).any(dim=1)
    keep = live & exists & ~already
    # compact kept targets to a dense prefix so the append is contiguous
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    dense = torch.where(keep.gather(1, order), del_target.gather(1, order), 0)
    tombs, num_tombs, tomb_ov = _append_rows(
        {"tomb_id": state.tomb_id}, state.num_tombs, {"tomb_id": dense},
        keep.sum(dim=1, dtype=torch.int32),
    )
    marks_out, num_marks, mark_ov = _append_rows(
        {col: getattr(state, col) for col in MARK_COLS}, state.num_marks,
        marks, mark_count,
    )
    return state._replace(
        tomb_id=tombs["tomb_id"],
        num_tombs=num_tombs,
        num_marks=num_marks,
        overflow=state.overflow | del_err | tomb_ov | mark_ov,
        **marks_out,
    )


def _apply_maps(state: PackedDocs, maps: Dict[str, torch.Tensor], map_count) -> PackedDocs:
    """Phase 4: LWW upsert of map registers, every doc at once.

    The scalar semantics is core/doc.py ``_apply_op``'s map branch
    (reference src/micromerge.ts:1151-1175): per (object, key), the op with
    the largest id wins; ``del`` wins like any write (kind VK_DELETED).
    Sequential over the map stream because an unseen key must append
    exactly one register row even when written twice in a batch."""
    regs = [state.r_obj.clone(), state.r_key.clone(), state.r_op.clone(),
            state.r_kind.clone(), state.r_val.clone()]
    r_obj, r_key, r_op = regs[0], regs[1], regs[2]
    n, ov = state.num_regs, state.overflow
    d, cap = r_op.shape
    slot = torch.arange(cap, dtype=torch.int32, device=r_op.device)[None, :]
    stream = [maps[col] for col in MAP_STREAM_COLS]
    p_obj, p_key, p_op = stream[0], stream[1], stream[2]
    for i in range(p_op.shape[1]):
        live = (i < map_count) & (p_op[:, i] != 0)
        match = (r_op != 0) & (r_obj == p_obj[:, i:i + 1]) & (r_key == p_key[:, i:i + 1])
        exists = match.any(dim=1)
        first = torch.where(match, slot, cap).amin(dim=1)  # argmax: first match
        pos = torch.where(exists, first, n)
        full = ~exists & (n >= cap)
        pos = pos.clamp(max=cap - 1).to(torch.int64)[:, None]
        win = live & ~full & (p_op[:, i] > r_op.gather(1, pos)[:, 0])
        for plane, col in zip(regs, stream):
            plane.scatter_(1, pos, torch.where(win[:, None], col[:, i:i + 1],
                                               plane.gather(1, pos)))
        n = n + (live & ~exists & ~full).to(torch.int32)
        ov = ov | (live & full)
    return state._replace(
        r_obj=regs[0], r_key=regs[1], r_op=regs[2], r_kind=regs[3], r_val=regs[4],
        num_regs=n, overflow=ov,
    )


def apply_batch(state: PackedDocs, encoded_arrays, *,
                insert_loop_slots: Optional[int] = None) -> PackedDocs:
    """Batched apply of every phase.

    ``encoded_arrays`` is the tuple (ins_ref, ins_op, ins_char, del_target,
    marks_dict, mark_count[, maps_dict, map_count]) with leading doc axes,
    as :func:`encoded_arrays_of` produces it; the 6-tuple form (no map
    stream) is accepted for callers without map ops.  ``insert_loop_slots``
    bounds the slot window of the insert phase (ops/insert.py
    ``effective_loop_slots``; a doc that outgrows it is flagged).

    The insert phase launches the CUDA kernel when the state lies on the
    card and runs its plain torch version when it lies on the CPU."""
    if len(encoded_arrays) == 6:
        ins_ref, ins_op, ins_char, del_target, marks, mark_count = encoded_arrays
        maps, map_count = None, None
    else:
        (ins_ref, ins_op, ins_char, del_target, marks, mark_count,
         maps, map_count) = encoded_arrays
    elem, char, n, ov = insert_batch(
        state.elem_id, state.char, state.num_slots, state.overflow,
        ins_ref, ins_op, ins_char, loop_slots=insert_loop_slots,
    )
    state = state._replace(elem_id=elem, char=char, num_slots=n, overflow=ov)
    state = _post_insert(state, del_target, marks, mark_count)
    if maps is not None:
        state = _apply_maps(state, maps, map_count)
    return state


# -- paged storage (store/): gather-based apply through a page table --------
#
# The paged layout (store/paged.py) keeps the element planes in a global
# (N_pages, P) pool with per-doc page tables.  The apply gathers only the
# dispatched docs' pages into a dense (B, G*P) group, runs apply_batch on it
# (the same math, so the result equals the padded layout's), and scatters
# the pages and aux rows back.  Page 0 is the reserved null page: padding
# entries of a page table gather zeros from it, their scatters all land on
# it, and it is re-zeroed after every scatter.

#: PackedDocs fields that stay dense per-doc rows under the paged layout
PAGED_AUX_FIELDS = tuple(f for f in PackedDocs._fields if f not in ("elem_id", "char"))


def paged_state_of(pool_elem, pool_char, aux, row_idx, page_rows) -> PackedDocs:
    """Dense (B, G*P) PackedDocs view of ``row_idx``'s docs, gathered from
    the page pool through ``page_rows`` (B, G) and the dense aux rows.
    Padding rows (``row_idx`` >= the doc count) read the last doc's aux row,
    as the reference's clamping gather does; their streams must be no-ops
    and their results are never written back."""
    b, g = page_rows.shape
    p = pool_elem.shape[1]
    pages = page_rows.reshape(-1).long()
    rows = row_idx.long().clamp(0, aux[0].shape[0] - 1)
    return PackedDocs(
        elem_id=pool_elem[pages].reshape(b, g * p),
        char=pool_char[pages].reshape(b, g * p),
        **{f: a[rows] for f, a in zip(PAGED_AUX_FIELDS, aux)},
    )


def apply_batch_paged(pool_elem, pool_char, aux, row_idx, page_rows, encoded_arrays) -> None:
    """Gather-through-page-table apply, the paged twin of :func:`apply_batch`.

    ``row_idx`` (B,) names the group's doc rows (padding rows >= the doc
    count), ``page_rows`` (B, G) their pages (padding entries 0, the null
    page), and ``encoded_arrays`` the streams with (B, ...) doc axes.
    Updates the pool tensors and the ``aux`` tensors (PAGED_AUX_FIELDS
    order) in place: the store owns them, and a copy of the whole pool per
    group would cost its size in memory traffic."""
    state = apply_batch(paged_state_of(pool_elem, pool_char, aux, row_idx, page_rows),
                        encoded_arrays)
    b, g = page_rows.shape
    p = pool_elem.shape[1]
    pages = page_rows.reshape(-1).long()
    pool_elem[pages] = state.elem_id.reshape(b * g, p)
    pool_char[pages] = state.char.reshape(b * g, p)
    # padding entries all scattered onto the null page (in no set order,
    # since torch leaves duplicate-index writes unordered); restore it last
    pool_elem[0] = 0
    pool_char[0] = 0
    # padding rows are dropped, not clamped: a clamped write would put a
    # stale copy of the last doc's aux row over its new one
    real = row_idx < aux[0].shape[0]
    rows = row_idx[real].long()
    for f, a in zip(PAGED_AUX_FIELDS, aux):
        a[rows] = getattr(state, f)[real]


def apply_batch_paged_groups(pool_elem, pool_char, aux, group_inputs) -> None:
    """One round's page-bucket groups in causal order: each
    ``(row_idx, page_rows, encoded_arrays)`` of ``group_inputs`` is one
    :func:`apply_batch_paged` (one insert launch), with the group's own
    window, writing the pool and aux tensors in place before the next
    group reads them."""
    for row_idx, page_rows, encoded_arrays in group_inputs:
        apply_batch_paged(pool_elem, pool_char, aux, row_idx, page_rows, encoded_arrays)


# -- incremental rounds (parallel/streaming.py) -------------------------------
#
# A streaming round reaches the card as flat per-doc-concatenated streams
# (proportional to its real ops) plus per-doc counts; the padded (D, K)
# rows the phases consume are rebuilt on the card.  Each round's insert
# phase is bounded by its own slot window (``loop_slots``).


def _pad_from_flat(flat: torch.Tensor, counts: torch.Tensor, width: int) -> torch.Tensor:
    """(N,) flat per-doc-concatenated values + (D,) counts -> (D, width)
    zero-padded int32 rows, rebuilt with one gather.  The gather index is
    clamped into the flat stream (the reference's clamping gather; torch
    would raise), and masked positions read 0 — op id 0, a no-op step.  An
    empty stream gives all-zero rows."""
    d = counts.shape[0]
    if flat.shape[0] == 0:  # a round with zero ops of this kind
        return torch.zeros((d, width), dtype=torch.int32, device=counts.device)
    counts = counts.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    cols = torch.arange(width, dtype=torch.int64, device=counts.device)[None, :]
    safe = (offsets[:, None] + cols).clamp(0, flat.shape[0] - 1)
    return torch.where(cols < counts[:, None], flat[safe], 0).to(torch.int32)


def apply_batch_compact(state: PackedDocs, stream_counts, ins_flat, del_flat, mark_flat,
                        map_flat=None, *, widths,
                        insert_loop_slots: Optional[int] = None) -> PackedDocs:
    """:func:`apply_batch` over compactly-transferred streams.

    ``stream_counts`` is (n_ins, n_del, n_mark[, n_map]), each (D,);
    ``ins_flat`` the (ref, op, char) flat streams, ``del_flat`` one,
    ``mark_flat`` / ``map_flat`` dicts by column; ``widths`` the padded
    widths (ki, kd, km[, kp]).  Flat streams may carry zero padding at the
    END (values past sum(counts) are never gathered into a live slot)."""
    n_ins, n_del, n_mark = stream_counts[0], stream_counts[1], stream_counts[2]
    ki, kd, km = widths[0], widths[1], widths[2]
    arrays = (
        _pad_from_flat(ins_flat[0], n_ins, ki),
        _pad_from_flat(ins_flat[1], n_ins, ki),
        _pad_from_flat(ins_flat[2], n_ins, ki),
        _pad_from_flat(del_flat, n_del, kd),
        {col: _pad_from_flat(mark_flat[col], n_mark, km) for col in mark_flat},
        n_mark.to(torch.int32),
    )
    if map_flat is not None:
        n_map = stream_counts[3]
        arrays = arrays + (
            {col: _pad_from_flat(map_flat[col], n_map, widths[3]) for col in map_flat},
            n_map.to(torch.int32),
        )
    return apply_batch(state, arrays, insert_loop_slots=insert_loop_slots)


def encoded_arrays_of(encoded: EncodedBatch, device: Union[str, torch.device]):
    """The tensor tuple for :func:`apply_batch` from a host EncodedBatch,
    on ``device``: the 8-tuple with the map-register stream."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (
        t(encoded.ins_ref),
        t(encoded.ins_op),
        t(encoded.ins_char),
        t(encoded.del_target),
        {col: t(arr) for col, arr in sorted(encoded.marks.items())},
        t(encoded.mark_count),
        {col: t(arr) for col, arr in sorted(encoded.map_ops.items())},
        t(encoded.map_count),
    )
