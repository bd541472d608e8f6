#!/usr/bin/env python3
"""Per-call cost of the round apply on one card: the port's twin of
``scripts/dispatch_latency.py``.

Times N back-to-back identical ``ops/kernel.py`` ``apply_batch_compact``
calls (inputs already on the device, one synchronize at the end; each call
launches the insert kernel K1) and a one-op program (``x + 1`` on 8 ints),
separating the fixed cost of a call from its compute.  The port adds the
same apply as one replay of a captured CUDA graph
(``utils/graphs.GraphCache``, the port's counterpart of a jitted program),
the host ms per call of each arm, and on a card each arm's device ms per
call: the busy time ``torch.profiler`` records (an eager apply's few
hundred launches overrun the queue a spin kernel can hold the host ahead
of) and, for the one-launch arms, CUDA events with the host kept ahead.

    python3 scripts/torch_dispatch_latency.py [--device cuda|cpu] [--docs 2048]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero without a card unless ``--device cpu`` is given.
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

from peritext_tpu_torch.utils.device import script_device, synchronize  # noqa: E402

#: chain lengths of the twin's table
CHAINS = (1, 4, 16, 64)
#: the twin's stream widths (inserts, deletes, marks, maps) and inserts a doc
WIDTHS = (64, 32, 32, 8)
INSERTS_PER_DOC = 4


def _chain(fn, x, reps: int, device) -> float:
    """Seconds of ``reps`` chained calls ``x = fn(x)``, ending in a
    synchronize."""
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = fn(x)
    synchronize(device)
    return time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--docs", type=int, default=2048)
    parser.add_argument("--slots", type=int, default=384)
    parser.add_argument("--marks", type=int, default=96)
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_dispatch_latency")
    if device is None:
        return 2

    from peritext_tpu_torch.ops.encode import MARK_COLS
    from peritext_tpu_torch.ops.kernel import apply_batch_compact
    from peritext_tpu_torch.ops.packed import MAP_STREAM_COLS, PackedDocs, empty_docs
    from peritext_tpu_torch.parallel.streaming import _write_resident
    from peritext_tpu_torch.utils.graphs import GraphCache

    docs = args.docs
    state = empty_docs(docs, args.slots, args.marks, tomb_capacity=args.slots, device=device)
    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    n = np.full(docs, INSERTS_PER_DOC, np.int32)
    zeros = np.zeros(docs, np.int32)
    counts = (up(n), up(zeros), up(zeros), up(zeros))
    ins = tuple(up(np.zeros(int(n.sum()), np.int32)) for _ in range(3))
    empty = lambda: up(np.zeros(0, np.int32))  # noqa: E731
    dels = empty()
    mk = {c: empty() for c in MARK_COLS}
    mp = {c: empty() for c in MAP_STREAM_COLS}

    def one(st):
        return apply_batch_compact(st, counts, ins, dels, mk, mp, widths=WIDTHS)

    st = one(state)
    synchronize(device)
    if bool(st.overflow.any()):
        raise AssertionError("dispatch latency: the apply overflowed a doc")
    per_call = {}
    for reps in CHAINS:
        dt = _chain(one, state, reps, device)
        per_call["eager"] = dt / reps
        print(f"chained x{reps}: {dt*1e3:8.1f} ms total, {dt*1e3/reps:7.2f} ms/dispatch")

    tiny = lambda y: y + 1  # noqa: E731
    x = torch.zeros(8, dtype=torch.int32, device=device)
    tiny(x)
    for reps in (1, 64):
        dt = _chain(tiny, x, reps, device)
        per_call["tiny"] = dt / reps
        print(f"tiny    x{reps}: {dt*1e3:8.1f} ms total, {dt*1e3/reps:7.2f} ms/dispatch")

    # the port's arm: the same apply captured once, then each call one replay
    # that writes the result into the resident state (the graph's inputs are
    # the streams above, bound by address before the capture)
    resident = PackedDocs(*(t.clone() for t in state))
    graphs = GraphCache(device)

    def body():
        _write_resident(tuple(resident), one(resident))

    def replay(_=None):
        graphs.run(("dispatch",), "apply_batch_compact", body, (), binds=tuple(resident))

    replay()  # eager
    replay()  # captured on the card
    for reps in CHAINS:
        dt = _chain(replay, None, reps, device)
        per_call["replay"] = dt / reps
        print(f"replay  x{reps}: {dt*1e3:8.1f} ms total, {dt*1e3/reps:7.2f} ms/dispatch")
    print(f"per dispatch (host clock, x64): eager {per_call['eager']*1e3:.4f} ms, graph replay "
          f"{per_call['replay']*1e3:.4f} ms, tiny {per_call['tiny']*1e3:.4f} ms; graphs "
          f"{graphs.stats()}")
    if device.type == "cuda":
        from peritext_tpu_torch.testing.devtime import DeviceBusy, device_time_ms

        with DeviceBusy() as busy:
            busy.measure("eager", lambda: one(state), reps=2)
        eager = busy.ms["eager"]
        held = {name: device_time_ms(fn, reps=64) for name, fn in (
            ("replay", replay), ("tiny", lambda: tiny(x)))}
        print(f"per dispatch ({busy.source}): eager {eager:.4f} ms; (device, "
              f"CUDA events, host kept ahead): graph replay {held['replay']:.4f} ms, tiny "
              f"{held['tiny']:.4f} ms")
    else:
        print("per dispatch (device): not measured (cpu)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
