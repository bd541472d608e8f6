"""Ragged paged apply: one apply of a round over the whole page pool.

The paged apply (ops/kernel.apply_batch_paged) groups docs by
power-of-two page count and pads each group's rows; this one runs against
the ``(N, P)`` page pool directly, with each doc's true op and page counts
as data (store/ragged.RaggedPlan planes), so a mix of short and long docs
is one insert launch with no padded rows and no padded steps.

Phases:

1. **Inserts**: ops/ragged_insert.py, the CUDA kernel on the card (one
   launch per doc class, sized from the plan's host page counts) and the
   plain pool walk on the CPU (the tensor's device picks).
2. **Delete target-exists scan** against pool pages (:func:`_ragged_exists`):
   a compare of every page with its doc's targets and a segment max over
   ``owner``, for all delete columns at once.
3. **Deletes, marks, map registers**: ops/kernel.py ``_post_insert`` (given
   the exists mask, so it never reads element planes) and ``_apply_maps``
   on the dense aux rows, as the padded path runs them; then the aux rows
   are written back.

The result equals the padded apply's phase by phase: the insert math is
the padded step with positions relabelled through ``pos_base``, and
phases 2-3 are the padded code.

:func:`apply_batch_ragged` is the device profiler's ``apply_batch_ragged``
launch site (obs/devprof.py), keyed by its shapes and the ragged insert's
launch plan, which the plan's host page counts give.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..obs.devprof import GLOBAL_DEVPROF, note_launch, plan_static
from .insert import SMEM_BUDGET, num_sms
from .kernel import PAGED_AUX_FIELDS, _apply_maps, _post_insert
from .packed import PackedDocs
from .ragged_insert import ragged_insert, ragged_insert_bytes, ragged_teams

_NUM_SLOTS = PAGED_AUX_FIELDS.index("num_slots")
_OVERFLOW = PAGED_AUX_FIELDS.index("overflow")


#: compare elements (pool slots x delete columns) the exists scan holds at once
_EXISTS_CHUNK = 1 << 26


def _ragged_exists(pool_elem, owner, del_target) -> torch.Tensor:
    """(B, KD) bool: does each delete target exist among its doc's pool
    pages.  Per page, a compare of its slots with its doc's targets; per
    doc, a segment max over ``owner``; columns in chunks of at most
    ``_EXISTS_CHUNK`` compares.  Dead columns (target 0) may read True;
    the caller's ``live`` mask gates them, as in the padded path."""
    b, kd = del_target.shape
    n, p = pool_elem.shape
    own = owner.long()
    # each page's doc's targets; unowned pages take the inert row b
    targets = torch.cat([del_target, del_target.new_zeros((1, kd))])[own]  # (N, KD)
    exists = torch.zeros((b + 1, kd), dtype=torch.int32, device=del_target.device)
    step = max(1, _EXISTS_CHUNK // max(1, n * p))
    for j in range(0, kd, step):
        cols = targets[:, j:j + step]
        hit = (pool_elem[:, :, None] == cols[:, None, :]).any(dim=1).to(torch.int32)
        exists[:, j:j + step] = exists[:, j:j + step].scatter_reduce(
            0, own[:, None].expand_as(hit), hit, "amax")
    return exists[:b] != 0


def apply_batch_ragged(pool_elem, pool_char, aux, row_idx, owner, pos_base, prev_page,
                       page_count, page_table, encoded_arrays, ins_counts, *,
                       page_count_host: Optional[np.ndarray] = None,
                       ins_counts_host: Optional[np.ndarray] = None) -> None:
    """Apply one round's streams directly against the pool's pages.

    ``aux`` is the tuple of dense (D, ...) tensors in PAGED_AUX_FIELDS
    order; ``row_idx`` (B,) the batch's doc rows (all real, no padding);
    ``owner`` / ``pos_base`` / ``prev_page`` / ``page_count`` /
    ``page_table`` the plan planes (:func:`plan_arrays`);
    ``encoded_arrays`` the ``apply_batch`` stream tuple with (B, ...) doc
    axes; ``ins_counts`` (B,) int32 the true per-doc insert counts;
    ``page_count_host`` the plan's host page counts, which size the insert
    kernel's launches without a read from the card, and ``ins_counts_host``
    the insert counts as host numpy: a profiled call takes its launch plan
    and bytes from them (without them, those are left unknown).
    Updates the pool and aux tensors in place."""
    args = (pool_elem, pool_char, aux, row_idx, owner, pos_base, prev_page, page_count,
            page_table, encoded_arrays, ins_counts)
    if not GLOBAL_DEVPROF.enabled:
        _apply_batch_ragged(*args, page_count_host)
        return
    device = pool_elem.device
    teams = nbytes = None
    if page_count_host is not None:
        teams, nbytes = _ragged_plan(page_count_host, ins_counts_host, pool_elem.shape[1],
                                     page_table.shape[1], device)
    note_launch(
        "apply_batch_ragged", args,
        (("plan", None if teams is None else plan_static(teams)),),
        lambda: _apply_batch_ragged(*args, page_count_host),
        device=device, kernel_launches=None if teams is None else len(teams),
        kernel_bytes=nbytes, written=(pool_elem, pool_char, aux),
    )


def _ragged_plan(page_count_host: np.ndarray, ins_counts_host: Optional[np.ndarray],
                 page_size: int, gmax: int, device: torch.device):
    """``(teams, kernel_bytes)`` of one ragged insert phase: the launch plan
    :func:`~.ragged_insert.ragged_insert` follows on a card (none on the
    CPU) and the bytes it must move (None without the host insert
    counts)."""
    teams = (ragged_teams(page_count_host, page_size, gmax, SMEM_BUDGET, num_sms(device))
             if device.type == "cuda" else [])
    nbytes = (None if ins_counts_host is None
              else ragged_insert_bytes(page_count_host, ins_counts_host, page_size, gmax))
    return teams, nbytes


def _apply_batch_ragged(pool_elem, pool_char, aux, row_idx, owner, pos_base, prev_page,
                        page_count, page_table, encoded_arrays, ins_counts,
                        page_count_host) -> None:
    if len(encoded_arrays) == 6:
        ins_ref, ins_op, ins_char, del_target, marks, mark_count = encoded_arrays
        maps, map_count = None, None
    else:
        (ins_ref, ins_op, ins_char, del_target, marks, mark_count,
         maps, map_count) = encoded_arrays
    rows = row_idx.long()
    n1, ov1 = ragged_insert(
        pool_elem, pool_char, owner, pos_base, prev_page, page_count, page_table,
        aux[_NUM_SLOTS][rows], aux[_OVERFLOW][rows], ins_counts,
        ins_ref, ins_op, ins_char, page_count_host=page_count_host,
    )
    exists = _ragged_exists(pool_elem, owner, del_target)
    dummy = del_target.new_zeros((rows.shape[0], 1))
    state = PackedDocs(
        elem_id=dummy, char=dummy, **{f: a[rows] for f, a in zip(PAGED_AUX_FIELDS, aux)}
    )._replace(num_slots=n1, overflow=ov1)
    state = _post_insert(state, del_target, marks, mark_count, exists=exists)
    if maps is not None:
        state = _apply_maps(state, maps, map_count)
    for f, a in zip(PAGED_AUX_FIELDS, aux):
        a[rows] = getattr(state, f)


def plan_arrays(plan, device: Union[str, torch.device]):
    """The plan planes of a store/ragged.RaggedPlan as tensors on
    ``device``: ``(row_idx, owner, pos_base, prev_page, page_count,
    page_table)``."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(plan.row_idx), t(plan.owner), t(plan.pos_base), t(plan.prev_page),
            t(plan.page_count), t(plan.page_table))


def stream_counts(enc, rows: Optional[Sequence[int]] = None):
    """Host ``(ins_counts, del_counts)`` int32 pair: each doc's true insert
    and delete count (live entries: a nonzero op id, a nonzero target),
    restricted to ``rows`` when given.  The insert counts are the ragged
    insert phase's trip counts."""
    ins = np.count_nonzero(np.asarray(enc.ins_op), axis=1).astype(np.int32)
    dels = np.count_nonzero(np.asarray(enc.del_target), axis=1).astype(np.int32)
    if rows is not None:
        ins, dels = ins[rows], dels[rows]
    return ins, dels
