#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card, and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is passed over):

1. card: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the main path, one nvcc each, all at once;
3. kernels: each kernel against its plain torch version on the card, bit for
   bit, at the shapes the main path gives it and at the ``batch_8k`` bench
   shape (8192 docs x 384 slots x 179 inserts, with and without
   ``loop_slots``), the forced global-memory variant, and a long-doc shape
   past the shared-memory budget; with CUDA-event times, the plain
   version's time, and the least time the card could take (bound);
4. slice: ``DocBatch(device="cuda").merge`` with cursors on 1024 fuzz docs
   x 256 ops (BASELINE config 3; slots 512, marks 128, comment ids 64),
   with the launch counts set to 0 just
   before and read just after; no doc may fall back, and spans, roots and
   cursors must equal the scalar oracle on a seeded sample of 64 docs.

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

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


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
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


def insert_bound(args, loop_slots):
    """(bound_ms, bound_by, bytes, ops) of one insert call on these inputs.

    Bytes: every input read once and every output written once.  Operations:
    what this run's data needs from a sequential algorithm, per live step
    (p + 1) compares to find the reference, (q - p) to find the skip slot,
    and 2 (n - q + 1) element moves to splice; replayed with the plain
    version's own step arithmetic."""
    import torch

    from peritext_tpu_torch.ops.insert import effective_loop_slots

    elem_id, char, num_slots, overflow, ins_ref, ins_op, ins_char = args
    d, s_cap = elem_id.shape
    nbytes = 2 * (elem_id.numel() * 4 * 2 + d * 4 + d) + 3 * ins_op.numel() * 4
    s_loop = effective_loop_slots(s_cap, loop_slots)
    elem = elem_id[:, :s_loop].clone()
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
    nops = int(ops)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, nops


def check_insert(name, args, loop_slots=None, smem_budget=None, reps=20, plain_reps=2):
    """Kernel vs plain on the card (exact), then times and bound."""
    import torch

    from peritext_tpu_torch.ops.insert import (
        SMEM_BUDGET,
        effective_loop_slots,
        insert_batch,
        insert_batch_reference,
    )

    budget = SMEM_BUDGET if smem_budget is None else smem_budget
    s_loop = effective_loop_slots(args[0].shape[1], loop_slots)
    got = insert_batch(*args, loop_slots=loop_slots, smem_budget=budget)
    want = insert_batch_reference(*args, loop_slots=loop_slots)
    torch.cuda.synchronize()
    err = 0
    for a, b, field in zip(got, want, ("elem_id", "char", "num_slots", "overflow")):
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
        if diff != 0:
            raise AssertionError(f"insert kernel != plain at {name}: {field} max |diff| {diff}")
        err = max(err, diff)
    ms = cuda_time_ms(lambda: insert_batch(*args, loop_slots=loop_slots, smem_budget=budget), reps)
    plain_ms = cuda_time_ms(lambda: insert_batch_reference(*args, loop_slots=loop_slots),
                            plain_reps, warmup=1)
    bound_ms, bound_by, nbytes, nops = insert_bound(args, loop_slots)
    row = dict(shape=name, docs=args[0].shape[0], slots=args[0].shape[1],
               inserts=args[4].shape[1], loop_slots=loop_slots,
               s_loop=s_loop, shared=2 * s_loop * 4 <= budget,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, int_ops=nops,
               overflow_docs=int(got[3].sum().item()))
    log("insert", json.dumps(row))
    return row


def synth_args(device, docs, slots, inserts, seed):
    import torch

    from peritext_tpu_torch.ops.packed import empty_docs
    from peritext_tpu_torch.testing.synth import synth_streams

    state = empty_docs(docs, slots, 8, tomb_capacity=8, device=device)
    streams = synth_streams(docs, inserts_per_doc=inserts, seed=seed)[:3]
    return [state.elem_id, state.char, state.num_slots, state.overflow,
            *(torch.as_tensor(a).to(device) for a in streams)]


def run_slice(device):
    """The main path: one padded merge of BASELINE config 3 on the card."""
    from peritext_tpu_torch.api.batch import DocBatch, _oracle_doc
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.ops.resolve import oracle_cursor_positions
    from peritext_tpu_torch.testing.fuzz import generate_workload, sample_cursors

    cfg = SLICE
    t0 = time.perf_counter()
    workloads = generate_workload(cfg["seed"], cfg["docs"], cfg["ops"])
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
    for d in sample:
        doc = _oracle_doc(workloads[d])
        if report.spans[d] != doc.get_text_with_formatting(["text"]):
            raise AssertionError(f"slice: doc {d} spans differ from the oracle")
        if report.roots[d] != doc.root:
            raise AssertionError(f"slice: doc {d} root differs from the oracle")
        if report.cursor_positions[d] != oracle_cursor_positions(doc, cursors[d]):
            raise AssertionError(f"slice: doc {d} cursors differ from the oracle")
    log(f"slice: {len(sample)} sampled docs equal the oracle (spans, roots, cursors)")
    return batch, workloads, launches


def main_path_insert_args(batch, workloads):
    """The insert kernel's inputs exactly as the slice's merge gives them."""
    from peritext_tpu_torch.ops.kernel import encoded_arrays_of
    from peritext_tpu_torch.ops.packed import empty_docs

    encoded = batch.encode(workloads)
    arrays = encoded_arrays_of(encoded, batch.device)
    state = empty_docs(encoded.num_docs, batch.slot_capacity, batch.mark_capacity,
                       tomb_capacity=arrays[3].shape[1], map_capacity=batch.map_capacity,
                       device=batch.device)
    return [state.elem_id, state.char, state.num_slots, state.overflow, *arrays[:3]]


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

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from peritext_tpu_torch.utils.nvcc import build_libraries

    t0 = time.perf_counter()
    libs = build_libraries(["insert"])
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  ptxas:", line.strip())

    torch.manual_seed(0)
    batch, workloads, launches = run_slice(device)

    rows = [check_insert("main_path", main_path_insert_args(batch, workloads))]
    args = synth_args(device, **BATCH_8K, seed=1)
    rows.append(check_insert("batch_8k", args))
    rows.append(check_insert("batch_8k_loop_slots", args, loop_slots=BATCH_8K["inserts"]))
    rows.append(check_insert("batch_8k_global_memory", args, smem_budget=0, reps=5))
    del args
    rows.append(check_insert("long_doc", synth_args(device, **LONG_DOC, seed=2),
                             reps=2, plain_reps=1))

    main = rows[0]
    kernels = [{
        "name": "rga_insert",
        "route": "cuda",
        "source": "peritext_tpu_torch/csrc/insert.cu",
        "replaces": "peritext_tpu/ops/pallas_insert.py:94",
        "launches": launches["rga_insert"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
