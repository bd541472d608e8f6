"""The ragged RGA insert phase over the page pool: a hand-written CUDA
kernel and its plain torch version.

:func:`ragged_insert` replaces the reference package's TPU kernel
``_ragged_insert_kernel`` (ops/ragged_pallas.py).  Per batch doc it applies
the doc's true insert count, with the padded insert phase's step
(ops/insert.py), to the doc's true pages of the ``(N, P)`` pool, in place.
On a CUDA tensor it launches ``csrc/ragged_insert.cu`` once per doc class
(:func:`ragged_teams`): docs whose window (``page_count * P``) is short run
a warp each, long ones a thread block each, each class sized by its own
widest window.  A doc's team gathers its pages into a contiguous window
(shared memory, or a device-memory scratch window when the class's widest
window exceeds the budget), runs the steps, and scatters the pages back.
On a CPU tensor it runs :func:`ragged_insert_reference`, the reference's
lax pool walk (``ops/ragged._ragged_insert_lax``) in torch: every step
works on the whole pool at once, per-doc reductions become segment minima
over the ``owner`` plane, and the splice's shift takes lane 0 of each page
from the last lane of the doc's previous page (``prev_page``).  It never
falls back from the card to the CPU.

Both take the same plan planes (store/ragged.py) and streams, update the
pool tensors in place, and return ``(num_slots, overflow)``.  Each doc's
capacity is its allocation, ``page_count * P``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.nvcc import count_launch, load_library
from .insert import SMEM_BUDGET, TeamLaunch, num_sms, plan_teams, require_host

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


def ragged_insert_bytes(page_count_host: np.ndarray, ins_counts_host: np.ndarray,
                        page_size: int, gmax: int) -> int:
    """Bytes one :func:`ragged_insert` call must move, from the plan's host
    page counts and the host insert counts: each doc's pages gathered and
    scattered (both planes), its streams read up to its own count, and per
    doc ``num_slots`` and ``overflow`` in and out, its page count, insert
    count and page-table row (``gmax`` entries).  A host function: the
    bound column of the card smoke and the device profiler's
    ``kernel_bytes`` share it."""
    require_host(page_count_host, "page_count_host")
    require_host(ins_counts_host, "ins_counts_host")
    b = len(page_count_host)
    pages = int(page_count_host.sum(dtype=np.int64))
    return (2 * 2 * pages * page_size * 4 + 3 * int(ins_counts_host.sum(dtype=np.int64)) * 4
            + b * (2 * 4 + 2 * 1 + 4 + 4) + b * gmax * 4)


def ragged_windows(page_count_host: np.ndarray, page_size: int, gmax: int) -> np.ndarray:
    """(B,) int64 window of each doc in slots: its true pages, clamped to the
    table width, times the page size."""
    require_host(page_count_host, "page_count_host")
    return np.clip(page_count_host.astype(np.int64), 0, gmax) * page_size


def ragged_teams(page_count_host: np.ndarray, page_size: int, gmax: int, smem_budget: int,
                 sms: int) -> List[TeamLaunch]:
    """The launch plan of :func:`ragged_insert`: one launch per non-empty
    doc class, each sized by its own widest true window, never by the
    table width ``gmax`` (:func:`~.insert.plan_teams`)."""
    return plan_teams(ragged_windows(page_count_host, page_size, gmax), smem_budget, sms)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the card, copied on the current stream from pinned
    memory: the host does not wait for the card."""
    return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(device, non_blocking=True)


def ragged_insert(pool_elem, pool_char, owner, pos_base, prev_page, page_count, page_table,
                  num_slots, overflow, ins_counts, ins_ref, ins_op, ins_char, *,
                  smem_budget: int = SMEM_BUDGET,
                  page_count_host: Optional[np.ndarray] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply every batch doc's first ``ins_counts`` inserts to its pages of
    the pool, in place; returns the new ``(num_slots, overflow)``.

    Shapes: (N, P) int32 pool planes; (N,) int32 ``owner`` / ``pos_base`` /
    ``prev_page`` and (B,) int32 ``page_count``, (B, Gmax) int32
    ``page_table`` (store/ragged.RaggedPlan); (B,) int32 ``num_slots``,
    (B,) bool ``overflow``, (B,) int32 ``ins_counts``; (B, K) int32 streams
    (op id 0 = padding).  ``smem_budget`` is the shared memory, in bytes,
    one doc's window may take; a class whose widest window is larger runs
    the global-memory variant of the same body.  ``page_count_host`` is
    ``page_count`` as host numpy (the plan's ``RaggedPlan.page_count``; it
    must hold the same values), which sizes the launches: given, the call
    reads nothing back from the card; omitted, the wrapper copies
    ``page_count`` to the host first.

    CUDA tensors launch the kernel once per non-empty doc class (or raise);
    CPU tensors run :func:`ragged_insert_reference`.
    ``ragged_insert.launches`` counts the kernel's launches.
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
    if page_count_host is None:
        page_count_host = page_count.cpu().numpy()
    windows = ragged_windows(page_count_host, p, gmax)
    if windows.shape != (b,):
        raise ValueError(f"page_count_host must have shape ({b},), got {windows.shape}")
    launches = plan_teams(windows, smem_budget, num_sms(device))
    # device-memory windows, one per doc of a class that runs that variant,
    # at offsets from a host prefix sum
    slots = np.zeros(b, np.int64)
    for launch in launches:
        if not launch.shared:
            rows = slice(None) if launch.rows is None else launch.rows
            slots[rows] = windows[rows]
    total = int(slots.sum())
    offsets = _upload(np.cumsum(slots) - slots, device) if total else pool_elem.new_empty(0)
    scratch_elem = torch.empty(total, dtype=torch.int32, device=device)
    scratch_char = torch.empty(total, dtype=torch.int32, device=device)
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())  # noqa: E731
    for launch in launches:
        rows = None if launch.rows is None else _upload(launch.rows, device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.peritext_ragged_insert(
                ptr(pool_elem), ptr(pool_char), ptr(page_table), ptr(page_count),
                ptr(ins_counts), ptr(num_slots), ptr(overflow),
                ptr(ins_ref), ptr(ins_op), ptr(ins_char), ptr(n_out), ptr(ov_out),
                ptr(scratch_elem), ptr(scratch_char), ptr(offsets), ptr(rows),
                launch.num_docs, launch.window, p, gmax, k, int(launch.team == "warp"),
                int(launch.shared), launch.threads, ctypes.c_void_p(stream),
            )
        if err != 0:
            raise RuntimeError(
                f"ragged insert kernel launch refused: CUDA error {err} (B={b}, P={p}, "
                f"Gmax={gmax}, K={k}, team={launch.team}, docs={launch.num_docs}, "
                f"window={launch.window}, shared={launch.shared})"
            )
        count_launch(ragged_insert)
    return n_out, ov_out


ragged_insert.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("ragged_insert")
    fn = lib.peritext_ragged_insert
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib
