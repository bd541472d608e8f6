#!/usr/bin/env python3
"""Memory roofline of the apply and the resolve on one card: the port's
twin of ``scripts/roofline.py``.

One process, in turn: (a) a pure state-copy program (every plane + 1) at
three doc counts calibrates the bandwidth this card reaches for the
port's state planes and its per-call floor; (b) ``ops/kernel.py``
``apply_batch`` (inserts on K1, slot window 179) and ``ops/resolve.py``
``resolve`` at the ``batch_8k`` shape (8192 docs, 256 synthetic ops a doc:
179 inserts, 38 deletes, 39 marks; 384 slots, 96 marks, 38 tombstones)
give bytes moved per op and the bandwidth reached against that
calibration.  The byte model is the twin's term for term: a copy reads and
writes the state; the apply's least traffic is the state read and written
plus the streams read once; the resolve's is the state read plus three
(D, S) int32 planes written.

    python3 scripts/torch_roofline.py [--device cuda|cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  The port adds the exact byte counts and, on a card, each
call's device busy ms (the device events ``torch.profiler`` records: the
bandwidth its kernels reach once host enqueue is out of the measure) and
each figure's share of the published 3.35 TB/s of an H100's HBM, by the
host clock and by device busy time.  Calls chain
as the twin's do (each apply on the last one's result), so the apply
chain fills the 384 slots by design; the state it starts from stays
empty.  Exits non-zero without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from peritext_tpu_torch.utils.device import card_line, script_device, synchronize  # noqa: E402

#: an H100's published HBM bandwidth (bytes/s), against which the port
#: states a share
HBM_BYTES_PER_S = 3.35e12
#: the calibration copies' doc counts and the batch_8k shape
COPY_DOCS = (2048, 8192, 32768)
SLOTS, MARKS, COPY_TOMBS = 384, 96, 64


def state_bytes(st) -> int:
    return sum(int(x.numel()) * x.element_size() for x in st)


def stream_bytes(streams) -> int:
    """The twin's count: every leaf of the stream tuple at 4 bytes an element."""
    total = 0
    for x in streams:
        for a in (x.values() if isinstance(x, dict) else (x,)):
            total += int(np.prod(np.shape(a))) * 4
    return total


def batch_shape(k: int):
    """``(ki, kd, km)``: the twin's split of ``k`` ops a doc."""
    ki, kd = int(k * 0.7), int(k * 0.15)
    return ki, kd, k - ki - kd


def steady(fn, arg, device, reps: int = 8, chain: bool = True) -> float:
    fn(arg)
    synchronize(device)
    t0 = time.perf_counter()
    o = arg
    for _ in range(reps):
        o = fn(o) if chain else fn(arg)
    synchronize(device)
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--copy-docs", type=int, nargs="+", default=list(COPY_DOCS))
    parser.add_argument("--docs", type=int, default=8192, help="docs of the batch_8k shape")
    parser.add_argument("--ops-per-doc", type=int, default=256)
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_roofline")
    if device is None:
        return 2

    from peritext_tpu_torch.ops.kernel import apply_batch
    from peritext_tpu_torch.ops.packed import PackedDocs, empty_docs
    from peritext_tpu_torch.ops.resolve import resolve
    from peritext_tpu_torch.testing.synth import synth_streams, synth_total_ops

    # (a) copy calibration: how fast can any program move state bytes here?
    copy = lambda st: PackedDocs(*(x + 1 if x.dtype != torch.bool else x  # noqa: E731
                                   for x in st))
    nbytes, rates, traffic, calls = {}, {}, {}, {}
    for d in args.copy_docs:
        st = empty_docs(d, SLOTS, MARKS, tomb_capacity=COPY_TOMBS, device=device)
        b = state_bytes(st)
        t = steady(copy, st, device)
        nbytes[f"copy_{d}_state"] = b
        rates[f"copy d={d}"] = 2 * b / t
        traffic[f"copy d={d}"], calls[f"copy d={d}"] = 2 * b, (lambda st=st: copy(st))
        print(f"copy d={d:6d}: {b/1e6:7.1f} MB state, {t*1e3:7.2f} ms/call, "
              f"{2*b/t/1e9:6.1f} GB/s (r+w)")

    # (b) batch_8k apply + resolve (the reference bench's --mode batch shapes)
    d = args.docs
    ki, kd, km = batch_shape(args.ops_per_doc)
    streams = synth_streams(d, inserts_per_doc=ki, deletes_per_doc=kd, marks_per_doc=km, seed=0)
    total_ops = synth_total_ops(streams)
    state0 = empty_docs(d, SLOTS, max(MARKS, km), tomb_capacity=max(kd, 8), device=device)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    ops_dev = tuple({c: up(v) for c, v in x.items()} if isinstance(x, dict) else up(x)
                    for x in streams)
    sb = state_bytes(state0)
    stream_b = stream_bytes(streams)

    first = apply_batch(state0, ops_dev, insert_loop_slots=ki)
    if bool(first.overflow.any()):
        raise AssertionError("roofline: one apply from the empty state overflowed")
    t = steady(lambda st: apply_batch(st, ops_dev, insert_loop_slots=ki), state0, device)
    if int(state0.num_slots.sum()):
        raise AssertionError("roofline: the apply changed the state it was given")
    moved = 2 * sb + stream_b  # state r+w, streams r: one pass each
    rates["apply batch_8k"] = moved / t
    traffic["apply batch_8k"] = moved
    calls["apply batch_8k"] = lambda: apply_batch(state0, ops_dev, insert_loop_slots=ki)
    print(f"apply batch_8k: {t*1e3:7.2f} ms, {total_ops/t/1e6:6.1f} M ops/s, "
          f"{moved/1e6:6.1f} MB min-moved, {moved/t/1e9:6.1f} GB/s achieved, "
          f"{moved/total_ops:5.1f} B/op")

    applied = apply_batch(state0, ops_dev, insert_loop_slots=ki)
    synchronize(device)
    tr = steady(lambda st: resolve(st, 32), applied, device, chain=False)
    # resolve reads state, writes (D, S) visible/fmt planes ~ 3 planes
    rb = sb + 3 * d * SLOTS * 4
    rates["resolve"] = rb / tr
    traffic["resolve"], calls["resolve"] = rb, (lambda: resolve(applied, 32))
    print(f"resolve:        {tr*1e3:7.2f} ms, {rb/1e6:6.1f} MB min-moved, "
          f"{rb/tr/1e9:6.1f} GB/s achieved, {rb/total_ops:5.1f} B/op")

    nbytes.update(batch_state=sb, batch_streams=stream_b, apply_min_moved=moved,
                  resolve_min_moved=rb, batch_ops=total_ops)
    print("bytes: " + ", ".join(f"{k} {v}" for k, v in nbytes.items()))
    if device.type != "cuda":
        print(f"device busy and shares of the published {HBM_BYTES_PER_S/1e12:.2f} TB/s: "
              "not measured (cpu)")
        return 0
    from peritext_tpu_torch.testing.devtime import DeviceBusy

    # one call of each on the card alone: the bandwidth its kernels reach
    # once host enqueue is out of the measure
    with DeviceBusy() as busy:
        for name, fn in calls.items():
            busy.measure(name, fn, reps=2)
    device_rates = {k: traffic[k] / (ms / 1e3) for k, ms in busy.ms.items()}
    print(f"device ({busy.source}): " + ", ".join(
        f"{k} {ms:.4f} ms, {device_rates[k]/1e9:.1f} GB/s" for k, ms in busy.ms.items()))
    for clock, r in (("host clock", rates), (busy.source.split(",")[0], device_rates)):
        print(f"share of the published {HBM_BYTES_PER_S/1e12:.2f} TB/s by {clock} "
              f"({card_line(device)}): "
              + ", ".join(f"{k} {v / HBM_BYTES_PER_S:.4f}" for k, v in r.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
