"""The sequential RGA insert phase: a hand-written CUDA kernel and its plain
torch version, and the team plan both insert kernels launch by.

This is the hot loop of the merge (kernel.py phase 1, reference
``applyListInsert`` src/micromerge.ts:1187-1245).  :func:`insert_batch`
replaces the reference package's TPU kernels ``_insert_kernel`` and
``_insert_kernel_chunked`` (ops/pallas_insert.py): on a CUDA tensor it
launches ``csrc/insert.cu``; on a CPU tensor it runs
:func:`insert_batch_reference`, the same arithmetic as a loop over the K
steps batched over docs.  It never falls back from the card to the CPU.

What bounds the kernel on an H100: each step scans a doc's live slots for
the reference and the skip slot and moves the tail, a chain of dependent
shared-memory loads, far above the bytes the call must move.  The design
(``csrc/insert_kernel.cuh``, ``csrc/insert_steps.cuh``) gives each doc a
*team* sized to its window (:func:`plan_teams`): one warp for windows of up
to :data:`WARP_TEAM_MAX_SLOTS` slots, many docs to a block and to an SM,
with ballot scans that stop at the first hit and no block barrier in the
step loop; a thread block for longer windows.  The op stream comes through
registers 32 ops at a time.  The TPU kernel's stream chunking existed for
its VMEM budget; the register chunks take its place.  When the window
exceeds the shared-memory budget, the same kernel body runs on the output
rows in device memory, so the kernel stays on the path at every size (the
reference package routes such shapes off its kernel).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.capture import captured
from ..utils.nvcc import count_launch, load_library

#: dynamic shared memory one block may take on Hopper: 227 KB per block,
#: less a margin for the kernel's static reduction words
SMEM_BUDGET = 227 * 1024 - 1024

InsertState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def effective_loop_slots(s_cap: int, loop_slots: Optional[int]) -> int:
    """The slot-window height the insert phase uses: ``loop_slots`` rounded
    up to a multiple of 8 (at least 8), never past ``s_cap``."""
    if loop_slots is None:
        return s_cap
    return min(s_cap, max(8, -(-loop_slots // 8) * 8))


#: windows of up to this many slots run the warp team (a warp per doc);
#: longer ones a thread block per doc.  Chosen from the team sweep on the
#: card (scripts/torch_team_sweep.py; PERF.md)
WARP_TEAM_MAX_SLOTS = 1024
#: docs (warps) one warp-team block holds at most
WARP_TEAM_DOCS = 8
#: block-team threads: one per this many window slots, in whole warps, at
#: least one warp and at most BLOCK_TEAM_MAX_THREADS (the team sweep's best
#: at 2048 to 8192 slots)
BLOCK_TEAM_SLOTS_PER_THREAD = 8
BLOCK_TEAM_MAX_THREADS = 512


def block_team_threads(window: int) -> int:
    """Threads of a block-team block for a class whose widest window is
    ``window`` slots."""
    per_thread = -(-window // BLOCK_TEAM_SLOTS_PER_THREAD)
    return min(BLOCK_TEAM_MAX_THREADS, max(32, -(-per_thread // 32) * 32))


@dataclass(frozen=True)
class TeamLaunch:
    """One kernel launch of one doc class (:func:`plan_teams`)."""

    #: "warp" (a warp per doc) or "block" (a thread block per doc)
    team: str
    #: the class's batch rows, ascending; None when the class is every row
    rows: Optional[np.ndarray]
    num_docs: int
    #: the class's widest window in slots: each doc's shared-memory share
    window: int
    #: windows in shared memory (else the device-memory variant)
    shared: bool
    #: threads per block
    threads: int
    docs_per_block: int

    @property
    def threads_per_doc(self) -> int:
        return 32 if self.team == "warp" else self.threads


def require_host(a, name: str) -> None:
    """Raise unless ``a`` is a host numpy array: launch sizing reads nothing
    back from the card."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{name} must be host numpy, not {type(a).__name__}")


def plan_teams(windows: np.ndarray, smem_budget: int, num_sms: int) -> List[TeamLaunch]:
    """Split docs by window (slots) into the warp class (at most
    :data:`WARP_TEAM_MAX_SLOTS`) and the block class, and size one launch
    per non-empty class by that class's own widest window.

    ``windows`` is host numpy, never a device tensor: sizing reads nothing
    back from the card.  A class's windows sit in shared memory when its
    widest takes at most ``smem_budget`` bytes (both planes).  A warp-team
    block holds up to :data:`WARP_TEAM_DOCS` docs, fewer when the class
    has fewer than that many docs per SM (``num_sms``) or when their
    windows would pass the card's shared memory per block."""
    require_host(windows, "windows")
    in_warp = windows <= WARP_TEAM_MAX_SLOTS
    launches = []
    for team, mask in (("warp", in_warp), ("block", ~in_warp)):
        count = int(np.count_nonzero(mask))
        if count == 0:
            continue
        rows = None if count == len(windows) else np.flatnonzero(mask).astype(np.int32)
        window = int(windows[mask].max())
        doc_bytes = 2 * 4 * window
        shared = doc_bytes <= smem_budget
        if team == "warp":
            per_block = min(WARP_TEAM_DOCS, -(-count // num_sms))
            if shared:
                per_block = max(1, min(per_block, SMEM_BUDGET // max(1, doc_bytes)))
            threads = 32 * per_block
        else:
            per_block, threads = 1, block_team_threads(window)
        launches.append(TeamLaunch(team, rows, count, window, shared, threads, per_block))
    return launches


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` lies on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def insert_teams(num_docs: int, s_loop: int, smem_budget: int, sms: int) -> List[TeamLaunch]:
    """The launch plan of :func:`insert_batch`: every doc has the window
    ``s_loop``, so one launch (none for no docs)."""
    return plan_teams(np.full(num_docs, s_loop, np.int64), smem_budget, sms)


def insert_batch_bytes(num_docs: int, s_cap: int, k: int) -> int:
    """Bytes one :func:`insert_batch` call must move on (D, S) state planes
    and (D, K) streams: the two state planes, ``num_slots`` and
    ``overflow`` read once and written once, and the three streams read
    once.  A host function of shapes alone: the bound column of the card
    smoke and the device profiler's ``kernel_bytes`` share it."""
    return 2 * (num_docs * s_cap * 4 * 2 + num_docs * 4 + num_docs) + 3 * num_docs * k * 4


def _check(elem_id, char, num_slots, overflow, ins_ref, ins_op, ins_char) -> None:
    if elem_id.dim() != 2:
        raise ValueError(f"elem_id must be (D, S), got {tuple(elem_id.shape)}")
    d, s = elem_id.shape
    for name, t, shape, dtype in (
        ("elem_id", elem_id, (d, s), torch.int32),
        ("char", char, (d, s), torch.int32),
        ("num_slots", num_slots, (d,), torch.int32),
        ("overflow", overflow, (d,), torch.bool),
        ("ins_ref", ins_ref, (d, ins_op.shape[-1]), torch.int32),
        ("ins_op", ins_op, (d, ins_op.shape[-1]), torch.int32),
        ("ins_char", ins_char, (d, ins_op.shape[-1]), torch.int32),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != elem_id.device:
            raise ValueError(f"{name} is on {t.device}, elem_id on {elem_id.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def insert_batch_reference(elem_id, char, num_slots, overflow, ins_ref, ins_op,
                           ins_char, *, loop_slots: Optional[int] = None) -> InsertState:
    """Plain torch insert phase: what the kernel computes, as a loop over the
    K steps with the doc axis batched.  Inside the window of ``s_loop``
    slots (:func:`effective_loop_slots`), which is also the capacity, each
    step is the reference package's ``kernel._insert_loop`` step; slots past
    the window come back untouched."""
    d, s_cap = elem_id.shape
    s_loop = effective_loop_slots(s_cap, loop_slots)
    elem = elem_id[:, :s_loop].clone()
    chars = char[:, :s_loop].clone()
    n = num_slots.clone()
    ov = overflow.clone()
    pos = torch.arange(s_loop, dtype=torch.int32, device=elem_id.device)[None, :]
    for k in range(ins_op.shape[1]):
        ref, op, ch = ins_ref[:, k:k + 1], ins_op[:, k:k + 1], ins_char[:, k:k + 1]
        nn = n[:, None]
        live = op != 0
        is_head = ref == 0
        match = (elem == ref) & (pos < nn)
        first = torch.where(match, pos, s_loop).amin(dim=1, keepdim=True)  # argmax
        found = is_head | (first < s_loop)
        p = torch.where(is_head, -1, first)
        # convergence skip: first slot right of p whose id is below op
        candidate = (pos > p) & (pos < nn) & (elem < op)
        q = torch.where(candidate, pos, nn).amin(dim=1, keepdim=True)
        ok = live & found & (nn < s_loop)
        rolled_elem = torch.roll(elem, 1, dims=1)
        rolled_char = torch.roll(chars, 1, dims=1)
        new_elem = torch.where(pos < q, elem, torch.where(pos == q, op, rolled_elem))
        new_char = torch.where(pos < q, chars, torch.where(pos == q, ch, rolled_char))
        elem = torch.where(ok, new_elem, elem)
        chars = torch.where(ok, new_char, chars)
        ov = ov | ((live & ~found) | (live & (nn >= s_loop)))[:, 0]
        n = n + ok[:, 0].to(torch.int32)
    if s_loop < s_cap:
        elem = torch.cat([elem, elem_id[:, s_loop:]], dim=1)
        chars = torch.cat([chars, char[:, s_loop:]], dim=1)
    return elem, chars, n, ov


@captured(static=("loop_slots", "smem_budget"))
def insert_batch(elem_id, char, num_slots, overflow, ins_ref, ins_op, ins_char, *,
                 loop_slots: Optional[int] = None,
                 smem_budget: int = SMEM_BUDGET) -> InsertState:
    """Apply every doc's insert stream to its state; returns new
    ``(elem_id, char, num_slots, overflow)``.

    Shapes: (D, S) int32 ``elem_id``/``char``, (D,) int32 ``num_slots``,
    (D,) bool ``overflow``, (D, K) int32 streams (op id 0 = padding, a
    no-op).  ``loop_slots`` bounds the window of slots the phase touches
    and thereby the capacity (a doc that would grow past it is flagged in
    ``overflow``, the caller's oracle-fallback signal).  ``smem_budget``
    is the shared memory, in bytes, the kernel may hold a doc's window in;
    a larger window runs the global-memory variant of the same body.

    CUDA tensors launch the kernel (or raise): one launch, whose team
    follows ``s_loop`` (:func:`insert_teams`); every doc has that window,
    so the launch has no row list and the call copies nothing from the
    host (a CUDA graph may capture it as it is).  CPU tensors run
    :func:`insert_batch_reference`.  ``insert_batch.launches`` counts the
    kernel's launches.
    """
    _check(elem_id, char, num_slots, overflow, ins_ref, ins_op, ins_char)
    device = elem_id.device
    if device.type == "cpu":
        return insert_batch_reference(elem_id, char, num_slots, overflow,
                                      ins_ref, ins_op, ins_char, loop_slots=loop_slots)
    if device.type != "cuda":
        raise ValueError(f"insert_batch runs on cuda or cpu tensors, not {device}")
    d, s_cap = elem_id.shape
    k = ins_op.shape[1]
    s_loop = effective_loop_slots(s_cap, loop_slots)
    elem_out = torch.empty_like(elem_id)
    char_out = torch.empty_like(char)
    n_out = torch.empty_like(num_slots)
    ov_out = torch.empty_like(overflow)
    if d == 0:
        return elem_out, char_out, n_out, ov_out
    lib = _library()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    for launch in insert_teams(d, s_loop, smem_budget, num_sms(device)):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.peritext_insert_batch(
                ptr(elem_id), ptr(char), ptr(num_slots), ptr(overflow),
                ptr(ins_ref), ptr(ins_op), ptr(ins_char),
                ptr(elem_out), ptr(char_out), ptr(n_out), ptr(ov_out),
                d, s_cap, s_loop, k, int(launch.team == "warp"), int(launch.shared),
                launch.threads, ctypes.c_void_p(stream),
            )
        if err != 0:
            raise RuntimeError(
                f"insert kernel launch refused: CUDA error {err} (D={d}, S={s_cap}, "
                f"s_loop={s_loop}, K={k}, team={launch.team}, shared={launch.shared})"
            )
        count_launch(insert_batch)
    return elem_out, char_out, n_out, ov_out


insert_batch.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("insert")
    fn = lib.peritext_insert_batch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib
