#!/usr/bin/env python3
"""Same-run A/B: batch-dim scatter vs FLATTENED 1-D scatter for the
mark/tomb append phase, the port's twin of ``scripts/append_flat_ab.py``.

``batched`` is the port's ``ops/kernel.py`` ``_append_rows`` ((D, cap)
tables, one scatter over the doc axis into a spill column); ``flat``
scatters into the flattened (D*cap,) table with globally unique indices
(``doc*cap + count + src``), dropped writes sent to one spill element past
it.  On the twin's shape (2048 docs, cap 96, 128 rows, 8 int32 columns)
the outputs must be equal; then each arm's host ms per call, ending in a
synchronize, twice in alternation (the twin's lines), and on the card each
arm's device busy ms per call (``testing.devtime.DeviceBusy``).  Neither
arm launches a kernel of the port's own.

    python3 scripts/torch_append_flat_ab.py [--docs 2048] [--reps 16]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero when the arms disagree, and without a card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from peritext_tpu_torch.utils.device import script_device, synchronize  # noqa: E402

#: the twin's table shape: capacity, rows appended per doc, int32 columns
CAP, ROWS, COLS = 96, 128, 8


def flat_append(tables, count, rows, rows_count):
    """(D, cap) tables, (D,) count, (D, K) rows, (D,) rows_count: one
    flattened 1-D scatter per column; returns (tables, new_count,
    overflow)."""
    import torch

    t0 = next(iter(tables.values()))
    d, cap = t0.shape
    km = next(iter(rows.values())).shape[1]
    src = torch.arange(km, dtype=torch.int32, device=t0.device)[None, :]
    dst_in = count[:, None] + src  # (D, K) in-table position
    valid = (src < rows_count[:, None]) & (dst_in < cap)
    base = (torch.arange(d, dtype=torch.int32, device=t0.device) * cap)[:, None]
    flat_dst = torch.where(valid, base + dst_in, d * cap).reshape(-1).to(torch.int64)
    out = {}
    for col, table in tables.items():
        spill = torch.cat([table.reshape(-1), table.new_zeros(1)])
        out[col] = spill.scatter(0, flat_dst, rows[col].reshape(-1))[: d * cap].reshape(d, cap)
    overflow = count + rows_count > cap
    new_count = (count + rows_count).clamp(max=cap)
    return out, new_count, overflow


def inputs(docs: int, cap: int, km: int, cols: int, seed: int = 0):
    """The twin's seeded inputs as numpy: (tables, count, rows, rows_count)."""
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(cols)]
    table = {c: rng.integers(0, 1000, (docs, cap)).astype(np.int32) for c in names}
    rows = {c: rng.integers(0, 1000, (docs, km)).astype(np.int32) for c in names}
    count = rng.integers(0, 16, docs).astype(np.int32)
    rows_count = rng.integers(0, km // 2, docs).astype(np.int32)
    return table, count, rows, rows_count


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--docs", type=int, default=2048)
    parser.add_argument("--reps", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_append_flat_ab")
    if device is None:
        return 2

    import torch

    from peritext_tpu_torch.ops import kernel

    table_np, count_np, rows_np, rows_count_np = inputs(args.docs, CAP, ROWS, COLS)
    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    table = {c: up(v) for c, v in table_np.items()}
    rows = {c: up(v) for c, v in rows_np.items()}
    count, rows_count = up(count_np), up(rows_count_np)

    batched = kernel._append_rows
    o1 = batched(table, count, rows, rows_count)
    o2 = flat_append(table, count, rows, rows_count)
    for c in table:
        if not torch.equal(o1[0][c], o2[0][c]):
            print(f"append flat A/B: column {c} differs", file=sys.stderr)
            return 1
    if not (torch.equal(o1[1], o2[1]) and torch.equal(o1[2], o2[2])):
        print("append flat A/B: counts or overflow differ", file=sys.stderr)
        return 1
    print("equivalent outputs ok")

    def steady(fn, reps):
        fn(table, count, rows, rows_count)
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(table, count, rows, rows_count)
        synchronize(device)
        return (time.perf_counter() - t0) / reps

    arms = (("batched", batched), ("flat", flat_append))
    for _ in range(2):
        for name, fn in arms:
            print(f"{name}: {steady(fn, args.reps)*1e3:7.2f} ms")
    if device.type == "cuda":
        from peritext_tpu_torch.testing.devtime import DeviceBusy

        with DeviceBusy() as busy:
            for name, fn in arms:
                busy.measure(name, lambda fn=fn: fn(table, count, rows, rows_count), args.reps)
        print("device ms/call: " + ", ".join(f"{n} {busy.ms[n]:.4f}" for n, _ in arms)
              + f" ({busy.source})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
