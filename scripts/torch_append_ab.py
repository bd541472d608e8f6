#!/usr/bin/env python3
"""Same-run A/B: two forms of the mark/tomb append inside the batch apply,
the port's twin of ``scripts/append_ab.py``.

``gather`` is the port's current ``ops/kernel.py`` ``_append_rows`` (a
batch-dim scatter into a spill column past the table, the label kept from
the twin); ``scatter`` is the twin's ``scatter_append`` translated: a
batch-dim scatter whose writes out of range are dropped, by a mask over
the (doc, row) pairs (the mask's count is read back by the host).  Each
arm swaps ``kernel._append_rows`` and times ``apply_batch`` (K1 on the
card) on the twin's ``batch_8k`` shape (8192 docs x 256 ops, 70/15/15%
insert/delete/mark, slots 384), in one process, in the twin's order
(gather, scatter, gather2, scatter2): host ms per apply ending in a
synchronize, then on the card each arm's device busy ms per apply over
:data:`DEVICE_REPS` applies (``testing.devtime.DeviceBusy``).  The arms' outputs must be equal
(``num_slots`` and a digest of every state plane).

    python3 scripts/torch_append_ab.py [--docs 8192] [--ops-per-doc 256] [--reps 6]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero when the arms disagree, and without a card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from peritext_tpu_torch.utils.device import script_device, synchronize  # noqa: E402

#: applies per arm inside the one profiler session (its parse grows with
#: the events: an apply is hundreds of launches)
DEVICE_REPS = 2


def scatter_append(tables, count, rows, rows_count):
    """The twin's ``scatter_append`` over the batch dim: (D, cap) tables,
    (D,) count, (D, K) rows, (D,) rows_count; row j of doc d lands at
    ``count[d] + j`` when ``j < rows_count[d]``, and a write past ``cap``
    is dropped (the twin's ``mode="drop"``).  Returns (tables, new_count,
    overflow)."""
    import torch

    first = next(iter(tables.values()))
    d, cap = first.shape
    km = next(iter(rows.values())).shape[1]
    src = torch.arange(km, dtype=torch.int32, device=first.device)[None, :]
    dst = torch.where(src < rows_count[:, None], count[:, None] + src, cap)
    keep = dst < cap
    doc = torch.arange(d, device=first.device)[:, None].expand(d, km)[keep]
    at = dst[keep].to(torch.int64)
    out = {}
    for col, table in tables.items():
        table = table.clone()
        table[doc, at] = rows[col][keep]
        out[col] = table
    overflow = count + rows_count > cap
    new_count = (count + rows_count).clamp(max=cap)
    return out, new_count, overflow


def state_digest(state) -> int:
    """crc32 over every plane of a ``PackedDocs`` state, in field order."""
    crc = 0
    for x in state:
        crc = zlib.crc32(np.ascontiguousarray(x.cpu().numpy()).tobytes(), crc)
    return crc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--docs", type=int, default=8192)
    parser.add_argument("--ops-per-doc", type=int, default=256)
    parser.add_argument("--reps", type=int, default=6)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_append_ab")
    if device is None:
        return 2

    import torch

    from peritext_tpu_torch.ops import kernel
    from peritext_tpu_torch.ops.packed import empty_docs
    from peritext_tpu_torch.testing.synth import synth_streams, synth_total_ops

    d, k = args.docs, args.ops_per_doc
    ki, kd = int(k * 0.7), int(k * 0.15)
    km = k - ki - kd
    streams = synth_streams(d, inserts_per_doc=ki, deletes_per_doc=kd, marks_per_doc=km, seed=0)
    total = synth_total_ops(streams)
    state0 = empty_docs(d, 384, max(96, km), tomb_capacity=max(kd, 8), device=device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    ops_dev = tuple({c: up(v) for c, v in x.items()} if isinstance(x, dict) else up(x)
                    for x in streams)
    gather_append = kernel._append_rows
    apply = lambda: kernel.apply_batch(state0, ops_dev, insert_loop_slots=ki)  # noqa: E731

    def timed(append_impl, reps):
        kernel._append_rows = append_impl
        out = apply()
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = apply()
        synchronize(device)
        return (time.perf_counter() - t0) / reps, out

    arms = (("gather", gather_append), ("scatter", scatter_append),
            ("gather2", gather_append), ("scatter2", scatter_append))
    outputs = {}
    try:
        for name, impl in arms:
            t, outputs[name] = timed(impl, args.reps)
            print(f"{name:8s}: {t*1e3:7.2f} ms/apply, {total/t/1e6:6.1f} M ops/s")
        if device.type == "cuda":
            from peritext_tpu_torch.testing.devtime import DeviceBusy

            with DeviceBusy() as busy:
                for name, impl in arms:
                    kernel._append_rows = impl
                    busy.measure(name, apply, DEVICE_REPS)
            print("device ms/apply: " + ", ".join(f"{n} {busy.ms[n]:.3f}" for n, _ in arms)
                  + f" ({busy.source})")
    finally:
        kernel._append_rows = gather_append

    slots = {name: int(out.num_slots.sum()) for name, out in outputs.items()}
    digests = {name: state_digest(out) for name, out in outputs.items()}
    if len(set(slots.values())) != 1 or len(set(digests.values())) != 1:
        print(f"append A/B: the arms disagree: num_slots {slots}, digests "
              f"{ {n: f'{v:#010x}' for n, v in digests.items()} }", file=sys.stderr)
        return 1
    print(f"arms equal: num_slots {slots['gather']}, state digest {digests['gather']:#010x}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
