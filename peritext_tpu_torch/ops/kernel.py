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

The public entry points (:func:`apply_batch`, :func:`apply_batch_paged`,
:func:`apply_batch_paged_groups`, :func:`apply_batch_compact`, and the
fused round pipeline's multi-round forms :func:`apply_batch_compact_rounds`,
:func:`apply_batch_staged_rounds`, :func:`apply_batch_stacked_rounds`,
:func:`apply_batch_stacked_rounds_multi`) are the device profiler's launch
sites (obs/devprof.py): with ``GLOBAL_DEVPROF.enabled`` each call lands in
a bucket keyed by its tensor shapes, its statics and its insert launch
plan (:func:`_insert_plan`, host arithmetic only).  Disabled, the cost is
one attribute check.  A nested site call runs unprofiled: a form's
per-round applies belong to its call.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs.devprof import GLOBAL_DEVPROF, note_launch, plan_static
from .encode import MARK_COLS, EncodedBatch
from .insert import (
    SMEM_BUDGET,
    effective_loop_slots,
    insert_batch,
    insert_batch_bytes,
    insert_teams,
    num_sms,
)
from .packed import MAP_STREAM_COLS, PackedDocs


def _insert_plan(num_docs: int, s_cap: int, k: int, loop_slots: Optional[int],
                 device: torch.device):
    """``(teams, kernel_bytes)`` of one insert phase on (D, S) state and
    (D, K) streams: the launch plan :func:`~.insert.insert_batch` follows
    on a card (none on the CPU, where the plain version runs) and the bytes
    it must move (:func:`~.insert.insert_batch_bytes`)."""
    teams = (insert_teams(num_docs, effective_loop_slots(s_cap, loop_slots), SMEM_BUDGET,
                          num_sms(device))
             if device.type == "cuda" else [])
    return teams, insert_batch_bytes(num_docs, s_cap, k)


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
    """Batched apply of every phase (the ``apply_batch`` launch site).

    ``encoded_arrays`` is the tuple (ins_ref, ins_op, ins_char, del_target,
    marks_dict, mark_count[, maps_dict, map_count]) with leading doc axes,
    as :func:`encoded_arrays_of` produces it; the 6-tuple form (no map
    stream) is accepted for callers without map ops.  ``insert_loop_slots``
    bounds the slot window of the insert phase (ops/insert.py
    ``effective_loop_slots``; a doc that outgrows it is flagged).

    The insert phase launches the CUDA kernel when the state lies on the
    card and runs its plain torch version when it lies on the CPU."""
    if GLOBAL_DEVPROF.enabled:
        device = state.elem_id.device
        teams, nbytes = _insert_plan(*state.elem_id.shape, encoded_arrays[1].shape[1],
                                     insert_loop_slots, device)
        return note_launch(
            "apply_batch", (state, encoded_arrays),
            (("insert_loop_slots", insert_loop_slots), ("plan", plan_static(teams))),
            lambda: _apply_batch(state, encoded_arrays, insert_loop_slots),
            device=device, kernel_launches=len(teams), kernel_bytes=nbytes,
        )
    return _apply_batch(state, encoded_arrays, insert_loop_slots)


def _apply_batch(state: PackedDocs, encoded_arrays,
                 insert_loop_slots: Optional[int]) -> PackedDocs:
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
    group would cost its size in memory traffic.  The
    ``apply_batch_paged`` launch site."""
    if GLOBAL_DEVPROF.enabled:
        teams, nbytes = _paged_plan(pool_elem, page_rows, encoded_arrays)
        note_launch(
            "apply_batch_paged", (pool_elem, pool_char, aux, row_idx, page_rows, encoded_arrays),
            (("plan", plan_static(teams)),),
            lambda: _apply_batch_paged(pool_elem, pool_char, aux, row_idx, page_rows,
                                       encoded_arrays),
            device=pool_elem.device, kernel_launches=len(teams), kernel_bytes=nbytes,
            written=(pool_elem, pool_char, aux),
        )
        return
    _apply_batch_paged(pool_elem, pool_char, aux, row_idx, page_rows, encoded_arrays)


def _paged_plan(pool_elem, page_rows, encoded_arrays):
    """:func:`_insert_plan` of one page group: (B, G*P) state."""
    b, g = page_rows.shape
    return _insert_plan(b, g * pool_elem.shape[1], encoded_arrays[1].shape[1], None,
                        pool_elem.device)


def _apply_batch_paged(pool_elem, pool_char, aux, row_idx, page_rows, encoded_arrays) -> None:
    state = _apply_batch(paged_state_of(pool_elem, pool_char, aux, row_idx, page_rows),
                         encoded_arrays, None)
    b, g = page_rows.shape
    p = pool_elem.shape[1]
    pages = page_rows.reshape(-1).long()
    pool_elem[pages] = state.elem_id.reshape(b * g, p)
    pool_char[pages] = state.char.reshape(b * g, p)
    # padding entries all scattered onto the null page (in no set order,
    # since torch leaves duplicate-index writes unordered); restore it last
    pool_elem[0] = 0
    pool_char[0] = 0
    # padding rows must not write their own row: a clamped write would put
    # a stale copy of the last doc's aux row over its new one.  Each writes
    # the group's first row with that row's value instead, a duplicate
    # write of one value (a boolean mask would sync the host; a CUDA graph
    # cannot hold that).  Padding follows the real rows, so the first row
    # is real unless the group is all padding, and then every write is the
    # unchanged last row.
    real = row_idx < aux[0].shape[0]
    rows = torch.where(real, row_idx, row_idx[:1]).long().clamp(max=aux[0].shape[0] - 1)
    for f, a in zip(PAGED_AUX_FIELDS, aux):
        new = getattr(state, f)
        keep = real.reshape((-1,) + (1,) * (new.dim() - 1))
        a[rows] = torch.where(keep, new, new[:1])


def apply_batch_paged_groups(pool_elem, pool_char, aux, group_inputs) -> None:
    """One round's page-bucket groups in causal order: each
    ``(row_idx, page_rows, encoded_arrays)`` of ``group_inputs`` is one
    :func:`apply_batch_paged` (one insert launch), with the group's own
    window, writing the pool and aux tensors in place before the next
    group reads them.  The ``apply_batch_paged_groups`` launch site: the
    groups' launches are this call's."""
    group_inputs = tuple(group_inputs)
    if GLOBAL_DEVPROF.enabled:
        plans = [_paged_plan(pool_elem, page_rows, arrays) for _, page_rows, arrays in group_inputs]
        teams = [t for group_teams, _ in plans for t in group_teams]
        note_launch(
            "apply_batch_paged_groups", (pool_elem, pool_char, aux, group_inputs),
            (("plan", plan_static(teams)),),
            lambda: _apply_groups(pool_elem, pool_char, aux, group_inputs),
            device=pool_elem.device, kernel_launches=len(teams),
            kernel_bytes=sum(nbytes for _, nbytes in plans), written=(pool_elem, pool_char, aux),
        )
        return
    _apply_groups(pool_elem, pool_char, aux, group_inputs)


def _apply_groups(pool_elem, pool_char, aux, group_inputs) -> None:
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
    END (values past sum(counts) are never gathered into a live slot).
    The ``apply_batch_compact`` launch site."""
    if GLOBAL_DEVPROF.enabled:
        device = state.elem_id.device
        teams, nbytes = _insert_plan(*state.elem_id.shape, widths[0], insert_loop_slots, device)
        return note_launch(
            "apply_batch_compact",
            (state, stream_counts, ins_flat, del_flat, mark_flat, map_flat),
            (("widths", tuple(widths)), ("insert_loop_slots", insert_loop_slots),
             ("plan", plan_static(teams))),
            lambda: _apply_batch_compact(state, stream_counts, ins_flat, del_flat, mark_flat,
                                         map_flat, widths, insert_loop_slots),
            device=device, kernel_launches=len(teams), kernel_bytes=nbytes,
        )
    return _apply_batch_compact(state, stream_counts, ins_flat, del_flat, mark_flat, map_flat,
                                widths, insert_loop_slots)


def _apply_batch_compact(state, stream_counts, ins_flat, del_flat, mark_flat, map_flat,
                         widths, insert_loop_slots) -> PackedDocs:
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
    return _apply_batch(state, arrays, insert_loop_slots)


# -- the fused round pipeline's commit forms (parallel/streaming.py) ----------
#
# A committed batch of R rounds is ONE site call in the reference's forms:
# the per-round applies chained in causal order.  On the CPU each form is
# that eager chain (the plain version the tests run).  On the card the
# session runs the same chain inside a CUDA graph (utils/graphs.py) that
# ends by copying the result into its resident state: the port's form of
# the reference's donated, in-place program.


def resolve_state_donation(*tensors) -> bool:
    """Whether the fused forms update the resident state in place (through
    a CUDA graph) rather than rebinding it: True for state on the card,
    False on the CPU, where a single-round commit takes the undonated
    ``compact1`` / ``static1`` forms the per-round discipline shares, as
    the reference's CPU does."""
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device.type == "cuda"
    return False


def rounds_plan(state: PackedDocs, ks: Sequence[int], loop_slots_seq: Sequence[Optional[int]],
                extra: Tuple = ()):
    """``(static, kernel_launches, kernel_bytes)`` of a chain of rounds with
    insert widths ``ks`` and slot windows ``loop_slots_seq`` on ``state``:
    the bucket static a form's site call is keyed by (``extra``, the
    windows and the insert launch plan), the insert launches the chain
    makes and the bytes they must move."""
    teams, nbytes = [], 0
    for k, loop_slots in zip(ks, loop_slots_seq):
        t, b = _insert_plan(*state.elem_id.shape, k, loop_slots, state.elem_id.device)
        teams.extend(t)
        nbytes += b
    static = tuple(extra) + (("loop_slots_seq", tuple(loop_slots_seq)),
                             ("plan", plan_static(teams)))
    return static, len(teams), nbytes


def note_form(site: str, tensors, run, plan, *, device: torch.device):
    """One commit form's site call under the device profiler (``run()``
    alone when it is off): the form's reference site name, one call per
    committed batch however it runs (eagerly, captured or replayed).
    ``plan()`` gives the call's ``(static, kernel_launches, kernel_bytes)``
    (:func:`rounds_plan`) and runs only while profiling.  The call's CUDA
    events, when its bucket's first call is timed, are recorded around it
    on the caller's stream, never inside a capture."""
    if not GLOBAL_DEVPROF.enabled:
        return run()
    static, launches, nbytes = plan()
    return note_launch(site, tensors, static, run, device=device, kernel_launches=launches,
                       kernel_bytes=nbytes)


def _compact_rounds_chain(state, rounds, widths_seq, loop_slots_seq) -> PackedDocs:
    for (counts, ins, dels, marks, maps), widths, loop_slots in zip(
            rounds, widths_seq, loop_slots_seq):
        state = _apply_batch_compact(state, counts, ins, dels, marks, maps, widths, loop_slots)
    return state


def apply_batch_compact_rounds(state: PackedDocs, rounds, *, widths_seq,
                               loop_slots_seq) -> PackedDocs:
    """R causally ordered rounds, each ``(stream_counts, ins_flat,
    del_flat, mark_flat, map_flat)`` as :func:`apply_batch_compact` takes
    them, chained in one site call (the engine replay's form).  The
    ``apply_batch_compact_rounds`` launch site."""
    rounds = tuple(rounds)
    if not len(rounds) == len(widths_seq) == len(loop_slots_seq):
        raise ValueError(f"rounds/widths_seq/loop_slots_seq length mismatch: "
                         f"{len(rounds)}/{len(widths_seq)}/{len(loop_slots_seq)}")
    return note_form(
        "apply_batch_compact_rounds", (state, rounds),
        lambda: _compact_rounds_chain(state, rounds, widths_seq, loop_slots_seq),
        lambda: rounds_plan(state, [w[0] for w in widths_seq], loop_slots_seq,
                            (("widths_seq", tuple(map(tuple, widths_seq))),)),
        device=state.elem_id.device)


def _staged_rounds_chain(state, counts_all, ins_all, del_all, mark_all, map_all, widths_seq,
                         loop_slots_seq, ins_lens, del_lens, mark_lens, map_lens) -> PackedDocs:
    io = do = mo = po = 0
    for r, (widths, loop_slots) in enumerate(zip(widths_seq, loop_slots_seq)):
        li, ld, lm, lp = ins_lens[r], del_lens[r], mark_lens[r], map_lens[r]
        state = _apply_batch_compact(
            state, tuple(counts_all[r, j] for j in range(4)),
            tuple(a[io:io + li] for a in ins_all), del_all[do:do + ld],
            {c: a[mo:mo + lm] for c, a in mark_all.items()},
            {c: a[po:po + lp] for c, a in map_all.items()}, widths, loop_slots)
        io, do, mo, po = io + li, do + ld, mo + lm, po + lp
    return state


def apply_batch_staged_rounds(state: PackedDocs, counts_all, ins_all, del_all, mark_all,
                              map_all, *, widths_seq, loop_slots_seq, ins_lens, del_lens,
                              mark_lens, map_lens) -> PackedDocs:
    """R causally ordered rounds from ONE staged tensor set (the fused
    pipeline's flat form): ``counts_all`` (R, 4, D) per-round (ins, del,
    mark, map) counts; ``ins_all`` the three insert streams, ``del_all``
    the delete stream, ``mark_all`` / ``map_all`` dicts by column, each the
    rounds' flat streams concatenated, round r's slice ``*_lens[r]`` long
    (its bucket).  The ``apply_batch_staged_rounds`` launch site."""
    if not (len(widths_seq) == len(loop_slots_seq) == counts_all.shape[0] == len(ins_lens)
            == len(del_lens) == len(mark_lens) == len(map_lens)):
        raise ValueError("staged rounds: per-round static/tensor length mismatch")
    statics = (tuple(map(tuple, widths_seq)), tuple(loop_slots_seq), tuple(ins_lens),
               tuple(del_lens), tuple(mark_lens), tuple(map_lens))
    return note_form(
        "apply_batch_staged_rounds", (state, counts_all, ins_all, del_all, mark_all, map_all),
        lambda: _staged_rounds_chain(state, counts_all, ins_all, del_all, mark_all, map_all,
                                     *statics),
        lambda: rounds_plan(state, [w[0] for w in statics[0]], statics[1], tuple(zip(
            ("widths_seq", "ins_lens", "del_lens", "mark_lens", "map_lens"),
            (statics[0],) + statics[2:]))),
        device=state.elem_id.device)


def _stacked_round(stacked, r: int):
    ins_ref, ins_op, ins_char, del_t, marks, mark_count, maps, map_count = stacked
    return (ins_ref[r], ins_op[r], ins_char[r], del_t[r], {c: a[r] for c, a in marks.items()},
            mark_count[r], {c: a[r] for c, a in maps.items()}, map_count[r])


def _stacked_rounds_chain(state, stacked, loop_slots_seq) -> PackedDocs:
    for r, loop_slots in enumerate(loop_slots_seq):
        state = _apply_batch(state, _stacked_round(stacked, r), loop_slots)
    return state


def apply_batch_stacked_rounds(state: PackedDocs, stacked, *, loop_slots_seq) -> PackedDocs:
    """R rounds of the PADDED (D, K) apply chained in one site call: the
    fused pipeline's static-rounds form.  ``stacked`` is the
    :func:`apply_batch` 8-tuple with a leading round axis.  The
    ``apply_batch_stacked_rounds`` launch site."""
    return note_form(
        "apply_batch_stacked_rounds", (state, stacked),
        lambda: _stacked_rounds_chain(state, stacked, tuple(loop_slots_seq)),
        lambda: rounds_plan(state, [stacked[0].shape[2]] * len(loop_slots_seq), loop_slots_seq),
        device=state.elem_id.device)


def _scatter_tenant_blocks(blocks: torch.Tensor, row_base: torch.Tensor, docs: int) -> torch.Tensor:
    """Per-tenant row blocks -> one (docs, ...) staging plane.

    ``blocks`` is (T, Dt, ...), tenant t's Dt doc rows of one plane, and
    ``row_base`` (T,) int32: tenant t's rows land at ``row_base[t] +
    arange(Dt)``.  An add into zeros (``index_add_``), as the reference's
    scatter-add: all-zero rows are no-op rows to the apply phases, so a
    zero pad block adds nothing wherever its ``row_base`` points.  Tenant
    blocks never alias each other (the fusion plan hands every tenant a
    disjoint row range)."""
    t, dt = blocks.shape[0], blocks.shape[1]
    rows = (row_base.to(torch.int64)[:, None]
            + torch.arange(dt, dtype=torch.int64, device=blocks.device)[None, :]).reshape(-1)
    flat = blocks.reshape((t * dt,) + tuple(blocks.shape[2:]))
    out = torch.zeros((docs,) + tuple(blocks.shape[2:]), dtype=blocks.dtype, device=blocks.device)
    return out.index_add_(0, rows, flat)


def _stacked_multi_chain(state, stacked, row_base, loop_slots_seq) -> PackedDocs:
    docs = state.elem_id.shape[0]
    for r, loop_slots in enumerate(loop_slots_seq):
        ins_ref, ins_op, ins_char, del_t, marks, mark_count, maps, map_count = \
            _stacked_round(stacked, r)
        sc = lambda plane: _scatter_tenant_blocks(plane, row_base, docs)  # noqa: E731
        arrays = (sc(ins_ref), sc(ins_op), sc(ins_char), sc(del_t),
                  {c: sc(a) for c, a in marks.items()}, sc(mark_count),
                  {c: sc(a) for c, a in maps.items()}, sc(map_count))
        state = _apply_batch(state, arrays, loop_slots)
    return state


def apply_batch_stacked_rounds_multi(state: PackedDocs, stacked, row_base, *,
                                     loop_slots_seq) -> PackedDocs:
    """The multi-tenant form of :func:`apply_batch_stacked_rounds`
    (cross-tenant fusion, plan/fusion.py): ``stacked`` holds only the
    active tenants' row blocks, leaves shaped (R, T, Dt, ...), and
    ``row_base`` (T,) their first rows; the full (D, K) planes are rebuilt
    on the device (:func:`_scatter_tenant_blocks`) before each round's
    padded apply.  The ``apply_batch_stacked_rounds_multi`` launch site."""
    return note_form(
        "apply_batch_stacked_rounds_multi", (state, stacked, row_base),
        lambda: _stacked_multi_chain(state, stacked, row_base, tuple(loop_slots_seq)),
        lambda: rounds_plan(state, [stacked[0].shape[3]] * len(loop_slots_seq), loop_slots_seq,
                            (("docs", int(state.elem_id.shape[0])),)),
        device=state.elem_id.device)


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
