"""The ragged RGA insert phase over the page pool: a hand-written CUDA
kernel and its plain torch version.

:func:`ragged_insert` replaces the reference package's TPU kernel
``_ragged_insert_kernel`` (ops/ragged_pallas.py).  Per batch doc it applies
the doc's true insert count, with the padded insert phase's step
(ops/insert.py), to the doc's true pages of the ``(N, P)`` pool, in place.
On a CUDA tensor it launches ``csrc/ragged_insert.cu``: one thread block
per doc gathers the doc's pages into a contiguous window (shared memory, or
a device-memory scratch window when the widest doc's window exceeds the
budget), runs the steps, and scatters the pages back.  On a CPU tensor it
runs :func:`ragged_insert_reference`, the reference's lax pool walk
(``ops/ragged._ragged_insert_lax``) in torch: every step works on the whole
pool at once, per-doc reductions become segment minima over the ``owner``
plane, and the splice's shift takes lane 0 of each page from the last lane
of the doc's previous page (``prev_page``).  It never falls back from the
card to the CPU.

Both take the same plan planes (store/ragged.py) and streams, update the
pool tensors in place, and return ``(num_slots, overflow)``.  Each doc's
capacity is its allocation, ``page_count * P``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils.nvcc import load_library
from .insert import SMEM_BUDGET, kernel_threads

#: "no position" for the segment minima: far above any slot position, far
#: below int32 max (as the reference's _INF)
_INF = 2**30


def _check(pool_elem, pool_char, owner, pos_base, prev_page, page_count, page_table,
           num_slots, overflow, ins_counts, ins_ref, ins_op, ins_char) -> None:
    if pool_elem.dim() != 2 or page_table.dim() != 2 or ins_op.dim() != 2:
        raise ValueError("pool_elem, page_table and the streams must be 2-D")
    n, p = pool_elem.shape
    b, gmax = page_table.shape
    k = ins_op.shape[1]
    for name, t, shape, dtype in (
        ("pool_elem", pool_elem, (n, p), torch.int32),
        ("pool_char", pool_char, (n, p), torch.int32),
        ("owner", owner, (n,), torch.int32),
        ("pos_base", pos_base, (n,), torch.int32),
        ("prev_page", prev_page, (n,), torch.int32),
        ("page_count", page_count, (b,), torch.int32),
        ("page_table", page_table, (b, gmax), torch.int32),
        ("num_slots", num_slots, (b,), torch.int32),
        ("overflow", overflow, (b,), torch.bool),
        ("ins_counts", ins_counts, (b,), torch.int32),
        ("ins_ref", ins_ref, (b, k), torch.int32),
        ("ins_op", ins_op, (b, k), torch.int32),
        ("ins_char", ins_char, (b, k), torch.int32),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != pool_elem.device:
            raise ValueError(f"{name} is on {t.device}, pool_elem on {pool_elem.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ragged_insert_reference(pool_elem, pool_char, owner, pos_base, prev_page,
                            page_count, page_table, num_slots, overflow, ins_counts,
                            ins_ref, ins_op, ins_char) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch ragged insert phase: the pool walk, ``max(ins_counts)``
    steps over the whole pool.  Per-doc operands gain one trailing inert
    row (index B, the ``owner`` of every unowned page), whose op is 0, so
    unowned pages never change.  ``page_table`` is not read (the owner
    planes carry the same plan)."""
    p = pool_elem.shape[1]
    k_ins = min(int(ins_counts.max()) if ins_counts.numel() else 0, ins_op.shape[1])

    def pad_row(x):
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])

    own = owner.long()
    prev = prev_page.long()
    n, ov, cap = pad_row(num_slots), pad_row(overflow), pad_row(page_count * p)
    refs, ops, chs = pad_row(ins_ref), pad_row(ins_op), pad_row(ins_char)
    lane = torch.arange(p, dtype=torch.int32, device=pool_elem.device)
    pos = pos_base[:, None] + lane[None, :]  # (N, P) slot position within its doc
    elem, chars = pool_elem.clone(), pool_char.clone()
    for k in range(k_ins):
        ref, op, ch = refs[:, k], ops[:, k], chs[:, k]
        live = op != 0
        is_head = ref == 0
        n_pg = n[own][:, None]
        # ids are unique, so the segment min over matching positions is the
        # padded path's first match
        match = (elem == ref[own][:, None]) & (pos < n_pg)
        page_min = torch.where(match, pos, _INF).amin(dim=1)
        pmin = torch.full_like(n, _INF).scatter_reduce(0, own, page_min, "amin")
        found = is_head | (pmin < _INF)
        pref = torch.where(is_head, -1, pmin)
        ok = live & found & (n < cap)
        candidate = (pos > pref[own][:, None]) & (pos < n_pg) & (elem < op[own][:, None])
        page_q = torch.where(candidate, pos, _INF).amin(dim=1)
        q = torch.minimum(torch.full_like(n, _INF).scatter_reduce(0, own, page_q, "amin"), n)
        q_pg = q[own][:, None]
        # the roll by one in page space: lane 0 takes the last lane of the
        # doc's previous page (a first page reads the null page's zero,
        # which the select never keeps: q >= 0)
        shifted_elem = torch.cat([elem[prev, p - 1][:, None], elem[:, :-1]], dim=1)
        shifted_char = torch.cat([chars[prev, p - 1][:, None], chars[:, :-1]], dim=1)
        new_elem = torch.where(pos < q_pg, elem,
                               torch.where(pos == q_pg, op[own][:, None], shifted_elem))
        new_char = torch.where(pos < q_pg, chars,
                               torch.where(pos == q_pg, ch[own][:, None], shifted_char))
        apply_pg = ok[own][:, None]
        elem = torch.where(apply_pg, new_elem, elem)
        chars = torch.where(apply_pg, new_char, chars)
        ov = ov | (live & ~found) | (live & (n >= cap))
        n = n + ok.to(torch.int32)
    pool_elem.copy_(elem)
    pool_char.copy_(chars)
    return n[:-1], ov[:-1]


def ragged_insert(pool_elem, pool_char, owner, pos_base, prev_page, page_count, page_table,
                  num_slots, overflow, ins_counts, ins_ref, ins_op, ins_char, *,
                  smem_budget: int = SMEM_BUDGET) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply every batch doc's first ``ins_counts`` inserts to its pages of
    the pool, in place; returns the new ``(num_slots, overflow)``.

    Shapes: (N, P) int32 pool planes; (N,) int32 ``owner`` / ``pos_base`` /
    ``prev_page`` and (B,) int32 ``page_count``, (B, Gmax) int32
    ``page_table`` (store/ragged.RaggedPlan); (B,) int32 ``num_slots``,
    (B,) bool ``overflow``, (B,) int32 ``ins_counts``; (B, K) int32 streams
    (op id 0 = padding).  ``smem_budget`` is the shared memory, in bytes,
    the kernel may hold a window of ``Gmax * P`` slots in; a larger window
    runs the global-memory variant of the same body.

    CUDA tensors launch the kernel (or raise); CPU tensors run
    :func:`ragged_insert_reference`.  ``ragged_insert.launches`` counts the
    kernel's launches.
    """
    args = (pool_elem, pool_char, owner, pos_base, prev_page, page_count, page_table,
            num_slots, overflow, ins_counts, ins_ref, ins_op, ins_char)
    _check(*args)
    device = pool_elem.device
    if device.type == "cpu":
        return ragged_insert_reference(*args)
    if device.type != "cuda":
        raise ValueError(f"ragged_insert runs on cuda or cpu tensors, not {device}")
    p = pool_elem.shape[1]
    b, gmax = page_table.shape
    k = ins_op.shape[1]
    n_out = torch.empty_like(num_slots)
    ov_out = torch.empty_like(overflow)
    if b == 0:
        return n_out, ov_out
    use_shared = 2 * gmax * p * 4 <= smem_budget
    if use_shared:
        scratch_elem = scratch_char = offsets = pool_elem.new_empty(0)
    else:
        # one contiguous window per doc; sizing it costs one host sync,
        # on the variant whose windows are hundreds of KB anyway
        slots = page_count.clamp(0, gmax).to(torch.int64) * p
        offsets = torch.cumsum(slots, 0) - slots
        total = int(slots.sum())
        scratch_elem = torch.empty(total, dtype=torch.int32, device=device)
        scratch_char = torch.empty(total, dtype=torch.int32, device=device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.peritext_ragged_insert(
            ptr(pool_elem), ptr(pool_char), ptr(page_table), ptr(page_count),
            ptr(ins_counts), ptr(num_slots), ptr(overflow),
            ptr(ins_ref), ptr(ins_op), ptr(ins_char), ptr(n_out), ptr(ov_out),
            ptr(scratch_elem), ptr(scratch_char), ptr(offsets),
            b, p, gmax, k, int(use_shared), kernel_threads(gmax * p),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"ragged insert kernel launch refused: CUDA error {err} (B={b}, P={p}, "
            f"Gmax={gmax}, K={k}, shared={use_shared})"
        )
    ragged_insert.launches += 1
    return n_out, ov_out


ragged_insert.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("ragged_insert")
    fn = lib.peritext_ragged_insert
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib
