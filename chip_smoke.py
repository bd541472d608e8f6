#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card, and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is passed over):

1. card: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the paths, one nvcc each, all at once, and
   the package's native host library (g++), which must load;
3. padded slice: ``DocBatch(device="cuda").merge`` with cursors on 1024
   fuzz docs x 256 ops (BASELINE config 3; slots 512, marks 128, comment
   ids 64), with the launch counts set to 0 just before and read just
   after; no doc may fall back, and spans, roots and cursors must equal
   the scalar oracle on a seeded sample of 64 docs;
4. pooled slice: the same 1024 docs plus a long tail of 8 docs x 1024 ops
   merged through each layout (padded, paged, ragged; slots 1024, marks
   512, comment ids 64, pages of 64 slots), each with the launch counts
   set to 0 just before and read just after: the ragged merge launches the
   ragged insert kernel once per non-empty doc class of its plan (warp
   team, block team) and the padded one never, the paged merge the padded
   one once per page-bucket group; no doc may fall back; paged and
   ragged must equal padded on every doc, and a seeded sample of 64 docs
   the scalar oracle;
5. streaming: ``StreamingMerge(device="cuda")`` (BASELINE config 5, the
   reference's streaming bench row: 2048 fuzz docs x 192 ops, 4 shuffled
   arrival rounds; per round ingest, then ``drain()``; then ``digest()``,
   ``read_all()`` and ``read_patches_all()``).  An untimed warm-up session, then session A in
   three object-ingest arms (default, ``fused_pipeline=False``,
   ``static_rounds=True``) that must agree, and its frame arm (the
   reference bench's default wire path: each round's batch of a doc as one
   v2 wire frame, one ``ingest_frames`` call per round, parsed and
   scheduled by the native library, which must have served it), which
   must equal A on every doc; B, A's workload in read blocks of 512 docs,
   must equal A; C, 10240 docs in two blocks of 8192, in an object and a
   frame arm that must agree.  Each session's insert launches, counted
   from 0 over its run, must equal its applies (one per touched block of
   every committed round); A, C and their frame arms must keep digest() ==
   digest(refresh=True) == the sum of doc_digest(), and a seeded sample of
   64 docs (with every fallback doc) must equal the scalar oracle in
   spans, roots, cursors and the host mirror's digest, and
   digest_async().wait() must equal digest();
5b. streaming layouts: A in the paged and the ragged layout (pages of 64
   slots), by objects and by frames, each equal to A on every doc; B in
   the paged layout with a ``reshard()`` after its second round (4
   blocks), equal to A, its digest unchanged by the reshard; C's frame arm
   in the ragged layout at full width (16384 rows), equal to C_frames;
   and the long-tail session (the reference bench's ``longdoc`` shape:
   1024 docs x 8 ops and one essay of 6144 ops, slots 8192, by frames in
   4 rounds) in all three layouts, paged and ragged equal to padded on
   every doc.  A paged session launches the insert kernel once per (round,
   page group) (``streaming.group_applies``) and never the ragged one; a
   ragged session the ragged insert kernel once per non-empty doc class of
   each round's plan (``streaming.ragged_applies``) and never the padded
   one.  Each session prints its ``health()`` and passes phase 5's checks;
6. kernels: each kernel against its plain torch version on the card, bit
   for bit, at the inputs each merge above gives it (for the insert kernel
   the padded slice's, the pooled padded merge's and each paged group's,
   gathered pages, padding rows and null-page entries included; for the
   ragged one the ragged merge's and one streaming round of ragged
   C_frames; for the insert kernel also one streaming round of A and one
   of A's frame arm, each at its ``loop_slots``, and every page group of
   one streaming round of paged A) and at larger shapes: for the insert
   kernel the ``batch_8k`` bench shape (8192 docs x 384 slots x
   179 inserts, with and without ``loop_slots``), the forced global-memory
   variant and a long-doc shape past the shared-memory budget; for the
   ragged insert kernel ``batch_8k_ragged`` (the same streams over a page
   pool), ``mixed_10k`` (10240 docs of 179, 1024 and 4096 inserts in
   pages of 64, also with the global-memory variant forced) and
   ``long_doc_ragged`` (64 docs x 32768 slots x 4096 inserts, whose window
   takes the global variant unforced); with the kernel's device time
   (CUDA events with the host kept ahead: ``device_time_ms``), its time
   per back-to-back call from an idle card, host work included
   (``call_ms``), the plain version's time per call, the least time the
   card could take (bound), and each call's launches with their teams
   (threads per doc, docs per block).

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet; Hopper white paper for int32): HBM3
#: bandwidth, and int32 ALU issue (132 SMs x 64 int32 lanes x 1.98 GHz boost)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

BATCH_8K = dict(docs=8192, slots=384, inserts=179)
LONG_DOC = dict(docs=64, slots=32768, inserts=4096)
#: BASELINE config 3 at the reference's differential capacities, but with 64
#: comment ids: at 32, one doc of this seed (35 distinct attrs) falls back
SLICE = dict(docs=1024, ops=256, slot_capacity=512, mark_capacity=128,
             comment_capacity=64, sample=64, seed=7)
#: the pooled layouts' merge: config 3 plus a long tail, at capacities the
#: long docs fit (340-370 inserts, 285-320 mark ops, up to 64 attrs each)
POOLED = dict(tail_docs=8, tail_ops=1024, tail_seed=8, slot_capacity=1024,
              mark_capacity=512, comment_capacity=64, page_size=64, sample=64)
#: BASELINE config 4's scale ("10K-doc batch, mixed ops ... 4K ops/doc") as
#: a mixed drain: (docs, inserts per doc, synth seed) per size class
MIXED_10K = dict(slots=4096, groups=((9216, 179, 1), (896, 1024, 2), (128, 4096, 3)))
LONG_DOC_RAGGED = dict(docs=64, slots=32768, inserts=4096, seed=2)
#: the long-tail session: the reference bench's ``longdoc`` row (bench.py
#: --mode longdoc, defaults 1024 x 8 and 8192; docs from seed 1, the essay
#: from seed 90001; slots: the power of two covering the essay; marks:
#: essay / 4) moved to streaming: 4 shuffled arrival rounds by v2 frames;
#: the round widths are session A's, which every change fits (checked).
#: One cut, for the time limit: the essay has 6144 ops, not 8192.  At these
#: capacities it overflows (more mark ops and comment ids than the tables
#: hold), so every session replays it on the host: at 8192 ops that took
#: 118 s a session on the card's host, the worker's essay came 146 s after
#: the phases before it, and the script took 892.5 s in all
LONGTAIL = dict(docs=1024, ops=8, seed=1, essay_ops=6144, essay_seed=90001, rounds=4,
                slot_capacity=8192, mark_capacity=2048, tomb_capacity=8192,
                comment_capacity=64, page_size=64, round_caps=(256, 128, 128, 16), sample=64)
#: the streaming sessions: BASELINE config 5 as the reference's streaming
#: bench row (2048 fuzz docs x 192 ops, seed 0, 4 arrival rounds, shuffle
#: model; slots 384, marks 96, round widths 256/128/128/16), by object
#: ingest and by the bench's default wire path (v2 frames); B the same with
#: read blocks of 512 docs; C 10240 docs at the default block of 8192 (two
#: blocks, 16384 rows)
STREAM = dict(docs=2048, ops=192, seed=0, rounds=4, slot_capacity=384, tomb_capacity=384,
              mark_capacity=96, comment_capacity=32, round_caps=(256, 128, 128, 16),
              sample=64, b_read_chunk=512, c_docs=10240, wire="v2")


def log(*parts) -> None:
    print(*parts, flush=True)


def _generate_chunk(args):
    from peritext_tpu_torch.testing.fuzz import generate_workload

    return generate_workload(*args)


def _essay(seed: int, ops: int):
    """One fuzz doc of ``ops`` ops (seed ``seed``) and its scalar-oracle
    replay: the long-tail session's essay, made in a worker."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.testing.fuzz import generate_workload

    workloads = generate_workload(seed, 1, ops)
    return workloads, _oracle_doc(workloads[0])


def generate(seed: int, docs: int, ops: int):
    """``generate_workload(seed, docs, ops)``, built in worker processes
    (doc d is drawn from seed + d alone, so chunks of docs are independent;
    the result is the same list).  The pool ends with the call."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    workers = max(1, min(8, os.cpu_count() or 1, docs // 64))
    step = -(-docs // (4 * workers))
    chunks = [(seed + lo, min(step, docs - lo), ops) for lo in range(0, docs, step)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        return [w for part in pool.map(_generate_chunk, chunks) for w in part]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn()`` over ``reps`` back-to-back calls from
    an idle card, by CUDA events: device time, or the host's own time per
    call where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, with
    the host kept ahead of the card: a spin kernel holds the stream while
    the host enqueues the calls, so the events bracket the card's work and
    not the wrappers' host time.  The spin must outlast the enqueue, else it
    is retried longer; a call that waits for the card (a device-to-host
    read) can never get ahead, and fails."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 2e6  # cycles
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(int(spin))
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        spin_ms = marks[0].elapsed_time(marks[1])
        if spin_ms > host_ms:
            return marks[1].elapsed_time(marks[2]) / reps
        spin *= 2 * host_ms / max(spin_ms, 1e-3)
    raise AssertionError(f"the host never got ahead of the card ({host_ms:.3f} ms to enqueue)")


def replay_ops(elem, num_slots, ins_ref, ins_op, s_loop) -> int:
    """Operations a sequential algorithm needs for these insert steps on a
    window of ``s_loop`` slots: per live step (p + 1) compares to find the
    reference, (q - p) to find the skip slot, and 2 (n - q + 1) element
    moves to splice; replayed with the plain version's own step
    arithmetic."""
    import torch

    elem = elem[:, :s_loop].clone()
    n = num_slots.clone().to(torch.int64)
    pos = torch.arange(s_loop, device=elem.device)[None, :]
    ops = torch.zeros((), dtype=torch.int64, device=elem.device)
    for k in range(ins_op.shape[1]):
        ref, op = ins_ref[:, k:k + 1], ins_op[:, k:k + 1]
        nn = n[:, None]
        match = (elem == ref) & (pos < nn)
        first = torch.where(match, pos, s_loop).amin(dim=1, keepdim=True)
        found = (ref == 0) | (first < s_loop)
        p = torch.where(ref == 0, -1, first)
        q = torch.where((pos > p) & (pos < nn) & (elem < op), pos, nn).amin(dim=1, keepdim=True)
        ok = (op != 0) & found & (nn < s_loop)
        work = (p + 1) + (q - p) + 2 * (nn - q + 1)
        ops += torch.where(ok, work, 0).sum()
        shifted = torch.roll(elem, 1, dims=1)
        new = torch.where(pos < q, elem, torch.where(pos == q, op, shifted))
        elem = torch.where(ok, new, elem)
        n = n + ok[:, 0]
    return int(ops)


def bound(nbytes: int, nops: int):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the int32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def insert_bound(args, loop_slots):
    """(bound_ms, bound_by, bytes, ops) of one insert call on these inputs.

    Bytes: every input read once and every output written once.
    Operations: :func:`replay_ops`."""
    from peritext_tpu_torch.ops.insert import effective_loop_slots

    elem_id, char, num_slots, overflow, ins_ref, ins_op, ins_char = args
    d, s_cap = elem_id.shape
    nbytes = 2 * (elem_id.numel() * 4 * 2 + d * 4 + d) + 3 * ins_op.numel() * 4
    nops = replay_ops(elem_id, num_slots, ins_ref, ins_op, effective_loop_slots(s_cap, loop_slots))
    return (*bound(nbytes, nops), nbytes, nops)


def ragged_bound(args):
    """(bound_ms, bound_by, bytes, ops) of one ragged insert call on these
    inputs (before it runs).

    Bytes: each doc's pages gathered and scattered (both planes), its
    streams read up to its own count, and per doc n and overflow in and
    out, its page count, insert count and page-table row.  Operations:
    :func:`replay_ops` per group of docs with one page count, each doc on
    its own window (page_count * P slots) for its own steps."""
    import torch

    (pool_elem, _, _, _, _, page_count, page_table, num_slots, _, ins_counts,
     ins_ref, ins_op, _) = args
    p = pool_elem.shape[1]
    b, gmax = page_table.shape
    pages = int(page_count.sum())
    nbytes = (2 * 2 * pages * p * 4 + 3 * int(ins_counts.sum()) * 4
              + b * (2 * 4 + 2 * 1 + 4 + 4) + b * gmax * 4)
    nops = 0
    for g in torch.unique(page_count).tolist():
        if g == 0:  # rows holding no pages (a session's padding rows) take no step
            continue
        rows = (page_count == g).nonzero()[:, 0]
        k = int(ins_counts[rows].max())
        elem = pool_elem[page_table[rows, :g].long()].reshape(len(rows), g * p)
        nops += replay_ops(elem, num_slots[rows], ins_ref[rows, :k], ins_op[rows, :k], g * p)
    return (*bound(nbytes, nops), nbytes, nops)


def team_columns(teams, launched):
    """A kernel row's team columns: per launch of the call, the team's
    threads per doc, docs per block, docs and window (slots); and the
    launches the call made, which must be one per planned class."""
    if launched != len(teams):
        raise AssertionError(f"{launched} launches for a plan of {len(teams)} classes")
    return dict(team=[t.threads_per_doc for t in teams],
                docs_per_block=[t.docs_per_block for t in teams],
                class_docs=[t.num_docs for t in teams],
                class_window=[t.window for t in teams], launches=launched)


def check_insert(name, args, loop_slots=None, smem_budget=None, reps=20, plain_reps=2):
    """Kernel vs plain on the card (exact), then times and bound."""
    import torch

    from peritext_tpu_torch.ops.insert import (
        SMEM_BUDGET,
        effective_loop_slots,
        insert_batch,
        insert_batch_reference,
        insert_teams,
        num_sms,
    )

    budget = SMEM_BUDGET if smem_budget is None else smem_budget
    s_loop = effective_loop_slots(args[0].shape[1], loop_slots)
    before = insert_batch.launches
    got = insert_batch(*args, loop_slots=loop_slots, smem_budget=budget)
    launched = insert_batch.launches - before
    want = insert_batch_reference(*args, loop_slots=loop_slots)
    torch.cuda.synchronize()
    err = 0
    for a, b, field in zip(got, want, ("elem_id", "char", "num_slots", "overflow")):
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
        if diff != 0:
            raise AssertionError(f"insert kernel != plain at {name}: {field} max |diff| {diff}")
        err = max(err, diff)
    call = lambda: insert_batch(*args, loop_slots=loop_slots, smem_budget=budget)  # noqa: E731
    ms = device_time_ms(call, reps)
    call_ms = cuda_time_ms(call, reps)
    plain_ms = cuda_time_ms(lambda: insert_batch_reference(*args, loop_slots=loop_slots),
                            plain_reps, warmup=1)
    bound_ms, bound_by, nbytes, nops = insert_bound(args, loop_slots)
    teams = insert_teams(args[0].shape[0], s_loop, budget, num_sms(args[0].device))
    row = dict(shape=name, docs=args[0].shape[0], slots=args[0].shape[1],
               inserts=args[4].shape[1], loop_slots=loop_slots,
               s_loop=s_loop, shared=2 * s_loop * 4 <= budget, **team_columns(teams, launched),
               max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, int_ops=nops,
               overflow_docs=int(got[3].sum().item()))
    log("insert", json.dumps(row))
    return row


def check_ragged(name, args, budgets=(None,), reps=5):
    """Ragged kernel vs plain on the card (exact, every page of both pool
    planes, n and overflow), once per shared-memory budget (None = the
    default), then times and bound.  The plain version runs once for the
    check, timed; the kernel is timed over ``reps`` launches
    after warm-up (its docs start empty, so every launch does the same
    work: the steps read only slots below n)."""
    import torch

    from peritext_tpu_torch.ops.insert import SMEM_BUDGET, num_sms
    from peritext_tpu_torch.ops.ragged_insert import (
        ragged_insert,
        ragged_insert_reference,
        ragged_teams,
    )

    bound_ms, bound_by, nbytes, nops = ragged_bound(args)
    pages = args[5].cpu().numpy()  # the plan's host page counts, as the merge passes them
    fresh = lambda: [a.clone() if i < 2 else a for i, a in enumerate(args)]  # noqa: E731
    plain = fresh()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = (plain[0], plain[1], *ragged_insert_reference(*plain))
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)  # one run: seconds long at the big shapes
    rows = []
    for budget in budgets:
        budget = SMEM_BUDGET if budget is None else budget
        mine = fresh()
        before = ragged_insert.launches
        got = (mine[0], mine[1], *ragged_insert(*mine, smem_budget=budget, page_count_host=pages))
        launched = ragged_insert.launches - before
        torch.cuda.synchronize()
        for a, b, field in zip(got, want, ("pool_elem", "pool_char", "num_slots", "overflow")):
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
            if diff != 0:
                raise AssertionError(f"ragged kernel != plain at {name}: {field} max |diff| {diff}")
        call = lambda: ragged_insert(*mine, smem_budget=budget, page_count_host=pages)  # noqa: E731
        ms = device_time_ms(call, reps)
        call_ms = cuda_time_ms(call, reps)
        b, gmax = args[6].shape
        p = args[0].shape[1]
        teams = ragged_teams(pages, p, gmax, budget, num_sms(args[0].device))
        row = dict(shape=name if budget == SMEM_BUDGET else f"{name}_global_memory",
                   docs=b, page_size=p, gmax=gmax,
                   pages=int(pages.sum()), pool_pages=args[0].shape[0],
                   inserts=int(args[9].sum()), max_count=int(args[9].max()),
                   shared=[t.shared for t in teams], **team_columns(teams, launched),
                   max_abs_err=0, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, int_ops=nops,
                   overflow_docs=int(got[3].sum().item()))
        log("ragged_insert", json.dumps(row))
        rows.append(row)
    return rows


def synth_args(device, docs, slots, inserts, seed):
    import torch

    from peritext_tpu_torch.ops.packed import empty_docs
    from peritext_tpu_torch.testing.synth import synth_streams

    state = empty_docs(docs, slots, 8, tomb_capacity=8, device=device)
    streams = synth_streams(docs, inserts_per_doc=inserts, seed=seed)[:3]
    return [state.elem_id, state.char, state.num_slots, state.overflow,
            *(torch.as_tensor(a).to(device) for a in streams)]


def ragged_args(device, slots, streams):
    """Ragged insert inputs for empty docs: a page store sized to the docs'
    true page need (as the ragged merge sizes it), every row allocated, the
    plan, and the streams (numpy (B, K) int32, left-packed)."""
    import torch

    from peritext_tpu_torch.ops.ragged import plan_arrays
    from peritext_tpu_torch.store import DEFAULT_PAGE_SIZE, PagedDocStore, ragged_plan

    refs, ops, chars = streams
    counts = np.count_nonzero(ops, axis=1).astype(np.int32)
    b = len(counts)
    need = -(-np.maximum(counts, 1) // DEFAULT_PAGE_SIZE)
    store = PagedDocStore(b, slots, 8, tomb_capacity=8, initial_pages=1 + int(need.sum()),
                          device=device)
    store.ensure_rows(np.arange(b), counts)
    planes = plan_arrays(ragged_plan(store), device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return [store.pool_elem, store.pool_char, *planes[1:],
            torch.zeros(b, dtype=torch.int32, device=device),
            torch.zeros(b, dtype=torch.bool, device=device),
            t(counts), t(refs), t(ops), t(chars)]


def mixed_streams():
    """MIXED_10K's streams: each size class from synth_streams, zero-padded
    to the longest class, rows in a seeded shuffle (a drain mixes sizes)."""
    from peritext_tpu_torch.testing.synth import synth_streams

    width = max(k for _, k, _ in MIXED_10K["groups"])
    planes = [[], [], []]
    for docs, k, seed in MIXED_10K["groups"]:
        for plane, a in zip(planes, synth_streams(docs, inserts_per_doc=k, seed=seed)[:3]):
            plane.append(np.pad(a, ((0, 0), (0, width - k))))
    order = np.random.default_rng(4).permutation(sum(d for d, _, _ in MIXED_10K["groups"]))
    return [np.concatenate(p)[order] for p in planes]


def run_slice(device):
    """The padded path: one padded merge of BASELINE config 3 on the card."""
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.testing.fuzz import sample_cursors

    cfg = SLICE
    t0 = time.perf_counter()
    workloads = generate(cfg["seed"], cfg["docs"], cfg["ops"])
    cursors = sample_cursors(workloads, 4, cfg["seed"])
    log(f"slice: generated {cfg['docs']} docs x {cfg['ops']} ops in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = DocBatch(slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
                     comment_capacity=cfg["comment_capacity"], device=device)
    batch.merge(workloads[:8], cursors[:8])  # warm-up: allocator and library load

    insert_batch.launches = 0
    report = batch.merge(workloads, cursors)
    launches = {"rga_insert": insert_batch.launches}
    log("slice stats", json.dumps(report.stats.to_json()))
    log("slice launches", json.dumps(launches))
    if report.fallback_docs:
        raise AssertionError(f"slice: docs fell back to the oracle: {report.fallback_docs[:20]}")
    if launches["rga_insert"] == 0:
        raise AssertionError("slice: the insert kernel was not launched")

    sample = sorted(random.Random(cfg["seed"]).sample(range(cfg["docs"]), cfg["sample"]))
    check_oracle("slice", workloads, cursors, report, sample)
    return batch, workloads, cursors, launches


def check_oracle(phase, workloads, cursors, report, sample) -> None:
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.ops.resolve import oracle_cursor_positions

    for d in sample:
        doc = _oracle_doc(workloads[d])
        if report.spans[d] != doc.get_text_with_formatting(["text"]):
            raise AssertionError(f"{phase}: doc {d} spans differ from the oracle")
        if report.roots[d] != doc.root:
            raise AssertionError(f"{phase}: doc {d} root differs from the oracle")
        if report.cursor_positions[d] != oracle_cursor_positions(doc, cursors[d]):
            raise AssertionError(f"{phase}: doc {d} cursors differ from the oracle")
    log(f"{phase}: {len(sample)} sampled docs equal the oracle (spans, roots, cursors)")


def run_pooled(device, workloads, cursors):
    """The pooled slice: the same workloads, plus a long tail, through all
    three layouts; returns the ragged DocBatch, the workloads and each
    layout's launch counts."""
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.ops.insert import SMEM_BUDGET, insert_batch, num_sms
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert, ragged_teams
    from peritext_tpu_torch.store import ragged_plan
    from peritext_tpu_torch.testing.fuzz import generate_workload, sample_cursors

    cfg = POOLED
    t0 = time.perf_counter()
    tail = generate_workload(cfg["tail_seed"], cfg["tail_docs"], cfg["tail_ops"])
    workloads = workloads + tail
    cursors = cursors + sample_cursors(tail, 4, cfg["tail_seed"])
    log(f"pooled: generated {cfg['tail_docs']} docs x {cfg['tail_ops']} ops in "
        f"{time.perf_counter() - t0:.1f} s; {len(workloads)} docs in all")
    reports, launches, batches = {}, {}, {}
    for layout in ("padded", "paged", "ragged"):
        batch = batches[layout] = DocBatch(
            slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
            comment_capacity=cfg["comment_capacity"], page_size=cfg["page_size"],
            layout=layout, device=device)
        batch.merge(workloads[:8], cursors[:8])  # warm-up
        insert_batch.launches = 0
        ragged_insert.launches = 0
        report = reports[layout] = batch.merge(workloads, cursors)
        launches[layout] = {"rga_insert": insert_batch.launches,
                            "ragged_insert": ragged_insert.launches}
        log(f"pooled {layout} stats", json.dumps(report.stats.to_json()))
        log(f"pooled {layout} launches", json.dumps(launches[layout]))
        if report.fallback_docs:
            raise AssertionError(f"pooled {layout}: docs fell back: {report.fallback_docs[:20]}")

    groups = len(batches["paged"]._encode_paged(workloads))
    plan = ragged_plan(batches["ragged"].last_store)
    classes = ragged_teams(plan.page_count, cfg["page_size"], plan.page_table.shape[1],
                           SMEM_BUDGET, num_sms(device))
    log("pooled ragged classes", json.dumps(
        [dict(team=t.team, docs=t.num_docs, window=t.window) for t in classes]))
    expected = {"padded": {"rga_insert": 1, "ragged_insert": 0},
                "paged": {"rga_insert": groups, "ragged_insert": 0},
                "ragged": {"rga_insert": 0, "ragged_insert": len(classes)}}
    if launches != expected:
        raise AssertionError(f"pooled: launches {launches}, expected {expected}")
    padded = reports["padded"]
    for layout in ("paged", "ragged"):
        r = reports[layout]
        for field in ("spans", "roots", "cursor_positions", "fallback_docs", "device_ops"):
            if getattr(r, field) != getattr(padded, field):
                raise AssertionError(f"pooled {layout}: {field} differ from the padded layout")
    log(f"pooled: paged ({groups} groups) and ragged equal padded on all {len(workloads)} docs")
    head = len(workloads) - cfg["tail_docs"]
    sample = sorted(random.Random(cfg["tail_seed"]).sample(range(head), cfg["sample"] - cfg["tail_docs"]))
    check_oracle("pooled", workloads, cursors, reports["ragged"], sample + list(range(head, len(workloads))))
    return batches, workloads, launches


def _oracle_digest(doc, slot_capacity, actor_table) -> int:
    """A replayed doc's full-state digest term by the host mirrors."""
    from peritext_tpu_torch.parallel.mesh import doc_digest_host
    from peritext_tpu_torch.parallel.streaming import _doc_char_slots, _doc_full_extras_host

    cps, slots = _doc_char_slots(doc)
    return (doc_digest_host(cps, slots, slot_capacity)
            + _doc_full_extras_host(doc, slots, actor_table)) & 0xFFFFFFFF


class GcClock:
    """Host seconds spent in Python's cyclic garbage collector while it is
    registered (``gc.callbacks``): a collection is a pause of the host,
    charged to whatever stage it falls in."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


#: the session counters each streaming report gives as deltas over its run
SESSION_COUNTERS = ("streaming.schedule_passes", "streaming.docs_scanned",
                    "streaming.docs_skipped")


def _arm_capture(capture, layout):
    """Patch the path's kernel wrapper to record the inputs of one armed
    round (``capture["armed"]``), and return the undo.  Padded: the first
    insert call; paged: every insert call of one round's group chain (one
    per page group); ragged: the first ragged insert call."""
    from peritext_tpu_torch.ops import kernel as kernel_mod
    from peritext_tpu_torch.ops import ragged as ragged_mod
    from peritext_tpu_torch.store import session as session_mod

    clone = lambda args: [a.clone() for a in args]  # noqa: E731
    originals = [(kernel_mod, "insert_batch", kernel_mod.insert_batch),
                 (session_mod, "apply_batch_paged_groups", session_mod.apply_batch_paged_groups),
                 (ragged_mod, "ragged_insert", ragged_mod.ragged_insert)]
    insert, groups, ragged = (o[2] for o in originals)

    def insert_rec(*args, loop_slots=None, **kw):
        if capture.get("armed") and layout == "padded":
            capture.update(armed=False, loop_slots=loop_slots, args=clone(args))
        elif capture.get("recording"):
            capture["groups"].append(clone(args))
        return insert(*args, loop_slots=loop_slots, **kw)

    def groups_rec(*args, **kw):
        if not capture.get("armed"):
            return groups(*args, **kw)
        capture.update(armed=False, recording=True, groups=[])
        try:
            return groups(*args, **kw)
        finally:
            capture["recording"] = False

    def ragged_rec(*args, **kw):
        if capture.get("armed"):
            capture.update(armed=False, args=clone(args))
        return ragged(*args, **kw)

    for (mod, name, _), rec in zip(originals, (insert_rec, groups_rec, ragged_rec)):
        setattr(mod, name, rec)
    return lambda: [setattr(mod, name, fn) for mod, name, fn in originals]


#: the insert-launch counter each layout's commits keep, one per launch
APPLY_COUNTER = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
                 "ragged": "streaming.ragged_applies"}


def run_stream_session(device, cfg, workloads, arrival, name, capture=None, wire_bytes=None,
                       after_round=None, **arm):
    """One streaming session over ``arrival``: per arrival round ingest (one
    ``ingest`` per doc, or, when ``wire_bytes`` is given, the arrival is
    wire frames and one ``ingest_frames`` call takes the round), then
    ``drain()`` (synchronized, so its apply time covers the kernels it
    queued); then ``digest()``, ``read_all()`` and ``read_patches_all()``.
    ``arm`` may name a ``layout`` (padded, paged, ragged) and the
    ``fused_pipeline``/``static_rounds`` switches.  Both kernels' launch
    counts are set to 0 just before and read just after: the layout's
    kernel must have launched exactly as often as its commits counted
    (:data:`APPLY_COUNTER`), the other never.  A frame session must have
    been parsed and scheduled by the native library.  ``capture`` (a dict)
    asks for the kernel inputs of one round of the third drain
    (:func:`_arm_capture`); ``after_round(s, r)`` runs after round r's
    drain.  Returns the session and its report."""
    import torch

    from peritext_tpu_torch import native
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    layout = arm.get("layout", "padded")
    ki, kd, km, kp = cfg["round_caps"]
    pooled = {} if layout == "padded" else dict(page_size=cfg.get("page_size", 64))
    s = StreamingMerge(
        num_docs=len(workloads), actors=("doc1", "doc2", "doc3"),
        slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
        tomb_capacity=cfg["tomb_capacity"], round_insert_capacity=ki,
        round_delete_capacity=kd, round_mark_capacity=km, round_map_capacity=kp,
        comment_capacity=cfg["comment_capacity"], read_chunk=cfg.get("read_chunk", 8192),
        static_rounds=arm.get("static_rounds", False), layout=layout, device=device, **pooled,
    )
    s.fused_pipeline = arm.get("fused_pipeline", True)
    undo = _arm_capture(capture, layout) if capture is not None else None
    stages = dict.fromkeys(("ingest", "schedule", "apply", "digest", "read_all",
                            "read_patches_all"), 0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames = wire_bytes is not None
    counters = {c: GLOBAL_COUNTERS.get(c) for c in SESSION_COUNTERS + tuple(APPLY_COUNTER.values())}
    native_calls = dict(native.calls)
    insert_batch.launches = 0
    ragged_insert.launches = 0
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    extra = {}
    t_all = time.perf_counter()
    try:
        for r in range(max(len(b) for b in arrival)):
            t0 = time.perf_counter()
            if frames:
                s.ingest_frames((d, batches[r]) for d, batches in enumerate(arrival)
                                if r < len(batches))
            else:
                for d, batches in enumerate(arrival):
                    if r < len(batches):
                        s.ingest(d, batches[r])
            t1 = time.perf_counter()
            if capture is not None and r == 2:
                capture["armed"] = True
            s.drain()
            t_sync = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            # apply: the commits' spans and the wait for the card; schedule:
            # the rest of the drain, with its passes that admit nothing
            apply = s.last_drain_marks["apply_seconds"] + (t2 - t_sync)
            stages["ingest"] += t1 - t0
            stages["schedule"] += (t2 - t1) - apply
            stages["apply"] += apply
            if after_round is not None:
                t0 = time.perf_counter()
                extra.update(after_round(s, r) or {})
                stages["after_round"] = stages.get("after_round", 0.0) + time.perf_counter() - t0
        for stage, fn in (("digest", s.digest), ("read_all", s.read_all),
                          ("read_patches_all", s.read_patches_all)):
            t0 = time.perf_counter()
            out = fn()
            stages[stage] = time.perf_counter() - t0
            if stage == "digest":
                digest = out
            elif stage == "read_all":
                spans = out
            else:
                patches = out
    finally:
        if undo is not None:
            undo()
        gc.callbacks.remove(gc_clock)
    wall = time.perf_counter() - t_all
    launches = {"rga_insert": insert_batch.launches, "ragged_insert": ragged_insert.launches}
    counts = {c.split(".")[1]: GLOBAL_COUNTERS.get(c) - n for c, n in counters.items()}
    applies = counts[APPLY_COUNTER[layout].split(".")[1]]
    ops = sum(len(ch.ops) for w in workloads for log in w.values() for ch in log)
    fallback = [d for d, sess in enumerate(s.docs) if sess.fallback]
    passes = max(counts["schedule_passes"], 1)
    native_delta = {k: v - native_calls.get(k, 0) for k, v in native.calls.items()
                    if v != native_calls.get(k, 0)}
    report = dict(session=name, layout=layout, ingest="frames" if frames else "objects",
                  docs=len(workloads), padded_docs=s._padded_docs,
                  blocks=-(-s._padded_docs // s._read_chunk), rounds=s.rounds,
                  round_caps=list(s.round_caps), ops=ops, wall_seconds=wall,
                  ops_per_second=ops / wall,
                  stage_seconds=dict(stages, host_parse=s.host_parse_seconds),
                  gc_seconds=gc_clock.seconds,
                  wire_bytes_per_op=wire_bytes / ops if frames else None,
                  schedule_passes=counts["schedule_passes"],
                  object_docs_scanned_per_pass=counts["docs_scanned"] / passes,
                  object_docs_scanned_per_pass_without_skip=(
                      counts["docs_scanned"] + counts["docs_skipped"]) / passes,
                  native_calls=native_delta,
                  rga_insert_launches=launches["rga_insert"],
                  ragged_insert_launches=launches["ragged_insert"],
                  block_applies=counts["block_applies"], group_applies=counts["group_applies"],
                  ragged_applies=counts["ragged_applies"],
                  fallback_docs=len(fallback), overflow_docs=s.overflow_count(),
                  peak_memory_bytes=torch.cuda.max_memory_allocated(), health=s.health(), **extra)
    log("streaming", json.dumps(report))
    kernel = "ragged_insert" if layout == "ragged" else "rga_insert"
    other = "rga_insert" if layout == "ragged" else "ragged_insert"
    if launches[kernel] == 0 or launches[kernel] != applies or launches[other]:
        raise AssertionError(f"streaming {name}: launches {launches} for {applies} "
                             f"{APPLY_COUNTER[layout]} (one {kernel} launch each)")
    if frames and not (native_delta.get("parse_frames") and native_delta.get("schedule_split_batch")):
        raise AssertionError(f"streaming {name}: the frames were not parsed and scheduled by the "
                             f"native library (native calls {native_delta})")
    if s.pending_count():
        raise AssertionError(f"streaming {name}: {s.pending_count()} changes still pending")
    return s, dict(report, digest=digest, spans=spans, patches=patches, fallback=fallback)


def check_stream_session(name, s, out, workloads, cfg, sample, oracle=None) -> None:
    """A session's digest invariants (``digest()`` == ``digest(refresh=True)``
    == the sum of ``doc_digest`` == ``digest_async().wait()``), and a seeded
    doc sample (with every fallback doc) against the scalar oracle: spans,
    root, cursors and the per-doc digest against the host mirrors of the
    replayed doc.  ``oracle`` (a dict) keeps the replayed docs for the
    next session of the same workloads."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.ops.resolve import oracle_cursor_positions
    from peritext_tpu_torch.testing.fuzz import sample_cursors

    oracle = {} if oracle is None else oracle
    if s.digest() != out["digest"] or s.digest(refresh=True) != out["digest"]:
        raise AssertionError(f"streaming {name}: digest() != digest(refresh=True)")
    total = sum(s.doc_digest(d) for d in range(s.num_docs)) & 0xFFFFFFFF
    if total != out["digest"]:
        raise AssertionError(f"streaming {name}: the doc_digest sum != digest()")
    if s.digest_async().wait() != out["digest"]:
        raise AssertionError(f"streaming {name}: digest_async().wait() != digest()")
    docs = sorted(set(sample) | set(out["fallback"]))
    cursors = sample_cursors([workloads[d] for d in docs], 4, cfg["seed"])
    got_cursors = s.resolve_cursors_batch(dict(zip(docs, cursors)))
    for d, cur in zip(docs, cursors):
        if d not in oracle:
            oracle[d] = _oracle_doc(workloads[d])
        doc = oracle[d]
        if out["spans"][d] != doc.get_text_with_formatting(["text"]) or \
                s.read(d) != out["spans"][d]:
            raise AssertionError(f"streaming {name}: doc {d} spans differ from the oracle")
        if s.read_root(d) != doc.root:
            raise AssertionError(f"streaming {name}: doc {d} root differs from the oracle")
        if got_cursors[d] != oracle_cursor_positions(doc, cur):
            raise AssertionError(f"streaming {name}: doc {d} cursors differ from the oracle")
        if s.doc_digest(d) != _oracle_digest(doc, cfg["slot_capacity"], s._actor_table):
            raise AssertionError(f"streaming {name}: doc {d} digest differs from the host mirror")
    log(f"streaming {name}: digest == refresh == sum of doc digests == async; {len(docs)} docs "
        f"({len(out['fallback'])} fallback) equal the oracle (spans, roots, cursors, digests)")


def compare_arms(name, other, base, base_name) -> None:
    """Two arms of one workload hold the same documents."""
    for key in ("spans", "patches", "digest", "fallback"):
        if other[key] != base[key]:
            raise AssertionError(f"streaming: {name} {key} differ from {base_name}")


def run_streaming(device):
    """The streaming slice: an untimed warm-up session, then sessions A
    (three object arms and a frame arm), B (block-chunked) and C (scale,
    an object and a frame arm), each checked; returns the K1 captures of a
    mid-session round of A's object and frame arms, the per-session
    reports, and what the layouts phase reuses (workloads, arrivals,
    samples, oracle docs, A_default's and C_frames' results)."""
    from peritext_tpu_torch.testing.arrival import build_arrival

    cfg = STREAM
    t0 = time.perf_counter()
    workloads = generate(cfg["seed"], cfg["docs"], cfg["ops"])
    arrival = build_arrival(workloads, cfg["rounds"], cfg["seed"])
    wire, wire_bytes = build_arrival(workloads, cfg["rounds"], cfg["seed"], as_frames=True,
                                     wire=cfg["wire"])
    log(f"streaming: generated {cfg['docs']} docs x {cfg['ops']} ops and their "
        f"{cfg['wire']} frames ({wire_bytes} bytes) in {time.perf_counter() - t0:.1f} s")
    sample = sorted(random.Random(cfg["seed"]).sample(range(cfg["docs"]), cfg["sample"]))
    # the first session on the card pays its cold start (kernel modules,
    # allocator growth); the timed arms run warm
    run_stream_session(device, cfg, workloads, arrival, "warm_up")
    capture = {}
    arms = {}
    for arm, kw in (("A_default", {}), ("A_fused_pipeline_off", dict(fused_pipeline=False)),
                    ("A_static_rounds", dict(static_rounds=True))):
        arms[arm] = run_stream_session(
            device, cfg, workloads, arrival, arm,
            capture=capture if arm == "A_fused_pipeline_off" else None, **kw)
    s_a, a = arms["A_default"]
    for arm in ("A_fused_pipeline_off", "A_static_rounds"):
        compare_arms(arm, arms[arm][1], a, "A_default")
    log("streaming: the three arms of A agree (read_all, read_patches_all, digest, fallback)")
    oracle_a = {}
    check_stream_session("A_default", s_a, a, workloads, cfg, sample, oracle_a)
    capture_frames = {}
    s_f, f = run_stream_session(device, cfg, workloads, wire, "A_frames", capture=capture_frames,
                                wire_bytes=wire_bytes)
    compare_arms("A_frames", f, a, "A_default")
    log(f"streaming: A_frames equals A_default on all {cfg['docs']} docs "
        "(read_all, read_patches_all, digest, fallback)")
    check_stream_session("A_frames", s_f, f, workloads, cfg, sample, oracle_a)
    reports = [out for _, out in arms.values()] + [f]
    del arms, s_f

    s_b, b = run_stream_session(device, dict(cfg, read_chunk=cfg["b_read_chunk"]), workloads,
                                arrival, "B_block_chunked")
    compare_arms("B_block_chunked", b, a, "A_default")
    log(f"streaming: B ({b['blocks']} blocks) equals A on all {cfg['docs']} docs and the digest")
    del s_a, s_b

    t0 = time.perf_counter()
    more = generate(cfg["seed"] + cfg["docs"], cfg["c_docs"] - cfg["docs"], cfg["ops"])
    workloads_c = workloads + more
    arrival_c = build_arrival(workloads_c, cfg["rounds"], cfg["seed"])
    log(f"streaming: generated {len(more)} more docs in {time.perf_counter() - t0:.1f} s")
    s_c, c = run_stream_session(device, cfg, workloads_c, arrival_c, "C_scale")
    sample_c = sorted(random.Random(cfg["seed"] + 1).sample(range(len(workloads_c)), cfg["sample"]))
    oracle_c = {}
    check_stream_session("C_scale", s_c, c, workloads_c, cfg, sample_c, oracle_c)
    del s_c
    wire_c, wire_bytes_c = build_arrival(workloads_c, cfg["rounds"], cfg["seed"], as_frames=True,
                                         wire=cfg["wire"])
    s_cf, cf = run_stream_session(device, cfg, workloads_c, wire_c, "C_frames",
                                  wire_bytes=wire_bytes_c)
    compare_arms("C_frames", cf, c, "C_scale")
    log(f"streaming: C_frames equals C_scale on all {len(workloads_c)} docs")
    check_stream_session("C_frames", s_cf, cf, workloads_c, cfg, sample_c, oracle_c)
    del s_cf
    ctx = dict(workloads=workloads, arrival=arrival, wire=wire, wire_bytes=wire_bytes,
               sample=sample, oracle_a=oracle_a, a=a, workloads_c=workloads_c, wire_c=wire_c,
               wire_bytes_c=wire_bytes_c, sample_c=sample_c, oracle_c=oracle_c, cf=cf)
    return capture, capture_frames, reports + [b, c, cf], ctx


def run_stream_layouts(device, ctx, essay_job):
    """The streaming-layouts phase: session A in the paged and the ragged
    layout, by objects and by frames, each equal to A_default on every doc;
    B in the paged layout with a reshard() after its second round (4 read
    blocks, so 4 shards), equal to A, its digest unchanged by the reshard;
    C_frames in the ragged layout at full width (10240 docs, 16384 rows),
    equal to C_frames; and the long-tail session (:data:`LONGTAIL`) in all
    three layouts, paged and ragged equal to padded on every doc.  Each
    session's checks as :func:`check_stream_session`.  Returns the captured
    paged round (K1 inputs, one per group), the captured ragged round of
    ragged C_frames (K3 inputs) and the reports."""
    cfg = STREAM
    reports, capture_paged, capture_ragged = [], {}, {}
    for layout in ("paged", "ragged"):
        for frames in (False, True):
            name = f"A_{layout}" + ("_frames" if frames else "")
            s, out = run_stream_session(
                device, cfg, ctx["workloads"], ctx["wire"] if frames else ctx["arrival"], name,
                capture=capture_paged if name == "A_paged" else None,
                wire_bytes=ctx["wire_bytes"] if frames else None, layout=layout)
            compare_arms(name, out, ctx["a"], "A_default")
            log(f"streaming: {name} equals A_default on all {cfg['docs']} docs "
                "(read_all, read_patches_all, digest, fallback)")
            check_stream_session(name, s, out, ctx["workloads"], cfg, ctx["sample"], ctx["oracle_a"])
            reports.append(out)
            del s

    def reshard_after_second_round(s, r):
        if r != 1:
            return None
        before = s.digest()
        placed = s.reshard()
        after, refreshed = s.digest(), s.digest(refresh=True)
        log(f"streaming B_paged_reshard: reshard after round 2 moved {placed['moved']} docs; "
            f"page_load {placed['page_load']}; digest {before} before, {after} after")
        if not placed["moved"] or after != before or refreshed != before:
            raise AssertionError(f"streaming B_paged_reshard: reshard {placed}, digest {before} "
                                 f"before, {after} after ({refreshed} refreshed)")
        return dict(reshard=placed)

    s, b = run_stream_session(device, dict(cfg, read_chunk=cfg["b_read_chunk"]), ctx["workloads"],
                              ctx["arrival"], "B_paged_reshard",
                              after_round=reshard_after_second_round, layout="paged")
    compare_arms("B_paged_reshard", b, ctx["a"], "A_default")
    check_stream_session("B_paged_reshard", s, b, ctx["workloads"], cfg, ctx["sample"],
                         ctx["oracle_a"])
    log(f"streaming: B_paged_reshard ({b['blocks']} blocks, resharded) equals A on all "
        f"{cfg['docs']} docs and the digest")
    reports.append(b)
    del s

    s, cr = run_stream_session(device, cfg, ctx["workloads_c"], ctx["wire_c"], "C_frames_ragged",
                               capture=capture_ragged, wire_bytes=ctx["wire_bytes_c"],
                               layout="ragged")
    compare_arms("C_frames_ragged", cr, ctx["cf"], "C_frames")
    check_stream_session("C_frames_ragged", s, cr, ctx["workloads_c"], cfg, ctx["sample_c"],
                         ctx["oracle_c"])
    log(f"streaming: C_frames_ragged equals C_frames on all {len(ctx['workloads_c'])} docs; "
        f"peak memory {cr['peak_memory_bytes']} bytes (padded C_frames "
        f"{ctx['cf']['peak_memory_bytes']})")
    reports.append(cr)
    del s
    reports += run_longtail(device, essay_job)
    return capture_paged, capture_ragged, reports


def round_need(workloads):
    """The largest (inserts, deletes, marks, map ops) of any one change:
    round widths at least this wide never demote a change for width."""
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    need = [0, 0, 0, 0]
    for w in workloads:
        for log_ in w.values():
            for ch in log_:
                need = [max(a, b) for a, b in zip(need, StreamingMerge._op_counts(ch))]
    return need


def run_longtail(device, essay_job):
    """The long-tail session (:data:`LONGTAIL`), the reference bench's
    ``longdoc`` shape moved to streaming, by frames, in the padded, paged
    and ragged layouts: paged and ragged must equal padded on every doc and
    in the digest, and every session passes :func:`check_stream_session`
    with the essay in its oracle sample."""
    from peritext_tpu_torch.testing.arrival import build_arrival

    cfg = LONGTAIL
    t0 = time.perf_counter()
    essay_workloads, essay_doc = essay_job.get(timeout=900)
    workloads = generate(cfg["seed"], cfg["docs"], cfg["ops"]) + essay_workloads
    need = round_need(workloads)
    if any(n > c for n, c in zip(need, cfg["round_caps"])):
        raise AssertionError(f"longtail: a change needs {need}, wider than {cfg['round_caps']}")
    wire, wire_bytes = build_arrival(workloads, cfg["rounds"], cfg["seed"], as_frames=True,
                                     wire="v2")
    log(f"longtail: {cfg['docs']} docs x {cfg['ops']} ops + an essay of {cfg['essay_ops']} ops "
        f"(seed {cfg['essay_seed']}) ready in {time.perf_counter() - t0:.1f} s after the earlier "
        f"phases; widest change {need}; round widths {list(cfg['round_caps'])}")
    essay = len(workloads) - 1
    sample = sorted(random.Random(cfg["seed"]).sample(range(essay), cfg["sample"] - 1))
    oracle, outs = {essay: essay_doc}, {}
    for layout in ("padded", "paged", "ragged"):
        s, outs[layout] = run_stream_session(device, cfg, workloads, wire, f"longtail_{layout}",
                                             wire_bytes=wire_bytes, layout=layout)
        check_stream_session(f"longtail_{layout}", s, outs[layout], workloads, cfg,
                             sample + [essay], oracle)
        del s
    for layout, out in outs.items():
        log(f"longtail {layout}: wall {out['wall_seconds']:.3f} s, {out['ops_per_second']:.1f} "
            f"ops/s, peak memory {out['peak_memory_bytes']} bytes, fallback docs "
            f"{out['fallback']}, overflow docs {out['overflow_docs']}, pool_stats "
            f"{json.dumps(out['health'].get('page_pool'))}")
    for layout in ("paged", "ragged"):
        compare_arms(f"longtail_{layout}", outs[layout], outs["padded"], "longtail_padded")
    log(f"longtail: paged and ragged equal padded on all {len(workloads)} docs (read_all, "
        "read_patches_all, digest, fallback)")
    return list(outs.values())


def main_path_insert_args(batch, workloads):
    """The insert kernel's inputs exactly as the padded slice's merge gives them."""
    from peritext_tpu_torch.ops.kernel import encoded_arrays_of
    from peritext_tpu_torch.ops.packed import empty_docs

    encoded = batch.encode(workloads)
    arrays = encoded_arrays_of(encoded, batch.device)
    state = empty_docs(encoded.num_docs, batch.slot_capacity, batch.mark_capacity,
                       tomb_capacity=arrays[3].shape[1], map_capacity=batch.map_capacity,
                       device=batch.device)
    return [state.elem_id, state.char, state.num_slots, state.overflow, *arrays[:3]]


def main_path_paged_args(batch, workloads):
    """The insert kernel's inputs exactly as the paged merge gives them,
    one list per page-bucket group (api/batch.py ``_run_paged`` ->
    store/paged.apply_rows -> ops/kernel.apply_batch_paged): the group's
    pages and aux rows gathered to (B, G*P), with padding rows and
    null-page table entries, and the group's streams padded to B rows."""
    from peritext_tpu_torch.ops.ragged import stream_counts
    from peritext_tpu_torch.store.paged import PagedDocStore, group_stream_arrays
    from peritext_tpu_torch.utils.shapes import next_pow2

    encs = batch._encode_paged(workloads)
    store = PagedDocStore(
        len(workloads), slot_capacity=batch.slot_capacity, mark_capacity=batch.mark_capacity,
        tomb_capacity=max(enc.del_target.shape[1] for _, _, enc in encs),
        map_capacity=batch.map_capacity, page_size=batch.page_size, device=batch.device)
    groups = []
    for g, docs, enc in encs:
        store.ensure_rows(docs, stream_counts(enc)[0])
        b = next_pow2(len(docs))
        state = store.materialize_rows(docs, g, pad_rows_to=b)  # the gather apply_rows makes
        streams = group_stream_arrays(enc, None, b, batch.device)
        groups.append((f"paged_g{g}_b{b}", [state.elem_id, state.char, state.num_slots,
                                           state.overflow, *streams[:3]]))
        store.apply_rows(docs, g, streams, pad_rows_to=b)  # the next group sees this one's pool
    return groups


def main_path_ragged_args(batch, workloads):
    """The ragged insert kernel's inputs exactly as the ragged merge gives
    them (api/batch.py ``_run_ragged`` -> ops/ragged.apply_batch_ragged)."""
    import torch

    from peritext_tpu_torch.ops.ragged import plan_arrays, stream_counts
    from peritext_tpu_torch.store.paged import group_stream_arrays

    enc = batch._encode_ragged(workloads)
    store, plan = batch._ragged_store(enc)
    row_idx, *planes = plan_arrays(plan, batch.device)
    streams = group_stream_arrays(enc, None, enc.num_docs, batch.device)
    rows = row_idx.long()
    return [store.pool_elem, store.pool_char, *planes,
            store.aux_field("num_slots")[rows], store.aux_field("overflow")[rows],
            torch.from_numpy(stream_counts(enc)[0]).to(batch.device), *streams[:3]]


def main() -> int:
    if not (ROOT / "peritext_tpu_torch" / "csrc" / "insert.cu").is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    # the long-tail essay (one doc of thousands of fuzz ops) and its oracle
    # replay take minutes on one core: they start now, in a worker, which
    # ends with main
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        essay_job = pool.apply_async(_essay, (LONGTAIL["essay_seed"], LONGTAIL["essay_ops"]))
        return run_all(device, essay_job)
    finally:
        pool.terminate()
        pool.join()


def run_all(device, essay_job) -> int:
    """Every phase after the device check (module doc)."""
    import torch

    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from peritext_tpu_torch.utils.nvcc import build_libraries

    from peritext_tpu_torch import native

    t0 = time.perf_counter()
    libs = build_libraries(["insert", "ragged_insert"])
    log(f"build: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("build: the native host library (g++) did not build or load")
    log(f"build: native host library {native.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  ptxas:", line.strip())

    torch.manual_seed(0)
    batch, workloads, cursors, launches = run_slice(device)
    pooled, pooled_workloads, pooled_launches = run_pooled(device, workloads, cursors)
    log(f"merges done at {time.perf_counter() - t_start:.1f} s")
    capture, capture_frames, stream_reports, ctx = run_streaming(device)
    log(f"streaming done at {time.perf_counter() - t_start:.1f} s")
    capture_paged, capture_ragged, layout_reports = run_stream_layouts(device, ctx, essay_job)
    stream_reports += layout_reports
    del ctx
    log(f"streaming layouts done at {time.perf_counter() - t_start:.1f} s")

    rows = [check_insert("main_path", main_path_insert_args(batch, workloads))]
    rows.append(check_insert("pooled_padded", main_path_insert_args(pooled["padded"], pooled_workloads)))
    for name, args in main_path_paged_args(pooled["paged"], pooled_workloads):
        rows.append(check_insert(name, args))
    if "args" not in capture:
        raise AssertionError("streaming: no insert call was captured in the third drain")
    rows.append(check_insert("streaming_round", capture["args"], loop_slots=capture["loop_slots"]))
    if "args" not in capture_frames:
        raise AssertionError("streaming: no insert call was captured in A_frames' third drain")
    rows.append(check_insert("streaming_frame_round", capture_frames["args"],
                             loop_slots=capture_frames["loop_slots"]))
    if not capture_paged.get("groups"):
        raise AssertionError("streaming: no paged group chain was captured in A_paged's third drain")
    for i, args in enumerate(capture_paged["groups"]):
        rows.append(check_insert(f"streaming_paged_round_g{i}", args))
    del capture, capture_frames, capture_paged
    args = synth_args(device, **BATCH_8K, seed=1)
    rows.append(check_insert("batch_8k", args))
    rows.append(check_insert("batch_8k_loop_slots", args, loop_slots=BATCH_8K["inserts"]))
    rows.append(check_insert("batch_8k_global_memory", args, smem_budget=0, reps=5))
    del args
    rows.append(check_insert("long_doc", synth_args(device, **LONG_DOC, seed=2),
                             reps=2, plain_reps=1))
    log(f"insert kernel shapes done at {time.perf_counter() - t_start:.1f} s")

    from peritext_tpu_torch.testing.synth import synth_streams

    ragged_rows = check_ragged("main_path", main_path_ragged_args(pooled["ragged"], pooled_workloads))
    if "args" not in capture_ragged:
        raise AssertionError("streaming: no ragged insert call was captured in C_frames_ragged")
    ragged_rows += check_ragged("streaming_ragged_round", capture_ragged.pop("args"))
    ragged_rows += check_ragged("batch_8k_ragged", ragged_args(
        device, BATCH_8K["slots"],
        synth_streams(BATCH_8K["docs"], inserts_per_doc=BATCH_8K["inserts"], seed=1)[:3]))
    ragged_rows += check_ragged("mixed_10k", ragged_args(device, MIXED_10K["slots"], mixed_streams()),
                                budgets=(None, 0))
    cfg = LONG_DOC_RAGGED
    ragged_rows += check_ragged("long_doc_ragged", ragged_args(
        device, cfg["slots"],
        synth_streams(cfg["docs"], inserts_per_doc=cfg["inserts"], seed=cfg["seed"])[:3]))
    log(f"ragged kernel shapes done at {time.perf_counter() - t_start:.1f} s")

    def record(name, source, replaces, launched, kernel_rows):
        main = kernel_rows[0]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
        }

    # ``launches`` is the count of the path whose inputs give ``ms`` (the
    # first row); ``launches_by_path`` lists every path's own count, each
    # counted from 0 over its own run
    rga_paths = {"slice": launches["rga_insert"],
                 "pooled_padded": pooled_launches["padded"]["rga_insert"],
                 "pooled_paged": pooled_launches["paged"]["rga_insert"]}
    rga_paths.update({f"streaming_{r['session']}": r["rga_insert_launches"] for r in stream_reports
                      if r["layout"] != "ragged"})
    ragged_paths = {"pooled_ragged": pooled_launches["ragged"]["ragged_insert"]}
    ragged_paths.update({f"streaming_{r['session']}": r["ragged_insert_launches"]
                         for r in stream_reports if r["layout"] == "ragged"})
    kernels = [
        dict(record("rga_insert", "peritext_tpu_torch/csrc/insert.cu",
                    "peritext_tpu/ops/pallas_insert.py:94", rga_paths["slice"], rows),
             launches_by_path=rga_paths),
        dict(record("ragged_insert", "peritext_tpu_torch/csrc/ragged_insert.cu",
                    "peritext_tpu/ops/ragged_pallas.py:65",
                    pooled_launches["ragged"]["ragged_insert"], ragged_rows),
             launches_by_path=ragged_paths),
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
