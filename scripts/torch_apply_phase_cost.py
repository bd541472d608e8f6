#!/usr/bin/env python3
"""Per-phase cost of the round apply on one card: the port's twin of
``scripts/apply_phase_cost.py``.

Times ``ops/kernel.py`` ``apply_batch_compact`` at 2048 docs x 384 slots
with one stream width raised at a time (the others at the floor of 8),
steady state (8 chained calls from the same empty state, one synchronize),
so the expensive phase is measured rather than guessed.  Each call
launches the insert kernel K1.

``--floor`` runs the twin's floor probe instead: what a call that does
nearly nothing costs (one plane, two planes, every plane + 1), and the
floor apply with the insert phase on K1 (``impl=cuda``) against its plain
torch version ``ops/insert.py`` ``insert_batch_reference``
(``impl=plain``), the twin's Pallas/lax pair.  That comparison is this
script's own: no path of the port runs the plain version on a card.

    python3 scripts/torch_apply_phase_cost.py [--floor] [--device cuda|cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  The port adds, on a card, each line's device busy ms per call
(the kernels ``torch.profiler`` records) and, for each configuration, the docs its
8-call chain overflowed (the twin's mark and r3mix chains fill the
96-mark table by design; the first call from the empty state overflows
none, and the empty state stays empty).  Exits non-zero without a card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from peritext_tpu_torch.utils.device import script_device, synchronize  # noqa: E402

#: the twin's seven configurations: (label, widths, slot window, ops a doc
#: per stream); a window of None is the whole capacity
CONFIGS = (
    ("floor (8, 8, 8, 8) win=64:      ", (8, 8, 8, 8), 64, (4, 2, 2, 1)),
    ("ins   (128,8,8,8) win=128: ", (128, 8, 8, 8), 128, (64, 2, 2, 1)),
    ("ins   (128,8,8,8) win=384: ", (128, 8, 8, 8), None, (64, 2, 2, 1)),
    ("del   (8,128,8,8) win=64:  ", (8, 128, 8, 8), 64, (4, 64, 2, 1)),
    ("mark  (8,8,128,8) win=64:  ", (8, 8, 128, 8), 64, (4, 2, 64, 1)),
    ("map   (8,8,8,16)  win=64:  ", (8, 8, 8, 16), 64, (4, 2, 2, 8)),
    ("r3mix (128,128,128,8) win=128: ", (128, 128, 128, 8), 128, (64, 32, 32, 1)),
)
REPS = 8


def _apply(device, docs, widths, loop_slots, per_doc):
    """``fn(state)``: one ``apply_batch_compact`` on zero streams of
    ``per_doc`` ops a doc (op id 0, so no insert lands), as the twin's."""
    from peritext_tpu_torch.ops.encode import MARK_COLS
    from peritext_tpu_torch.ops.kernel import apply_batch_compact
    from peritext_tpu_torch.ops.packed import MAP_STREAM_COLS

    up = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    n = [np.full(docs, c, np.int32) for c in per_doc]
    counts = tuple(up(x) for x in n)
    flat = lambda x: up(np.zeros(max(int(x.sum()), 1), np.int32))  # noqa: E731
    ins = tuple(flat(n[0]) for _ in range(3))
    dels = flat(n[1])
    mk = {c: flat(n[2]) for c in MARK_COLS}
    mp = {c: flat(n[3]) for c in MAP_STREAM_COLS}
    return lambda st: apply_batch_compact(st, counts, ins, dels, mk, mp, widths=widths,
                                          insert_loop_slots=loop_slots)


class Steady:
    """The twin's steady-state timing: one warm call, then :data:`REPS`
    chained calls from the same ``base`` behind one synchronize; each call
    kept, so :meth:`device_line` can give its device busy ms from one call
    on ``base`` (on a card; the profiler runs after every host timing)."""

    def __init__(self, base, device) -> None:
        self.base, self.device = base, device
        self.calls = {}
        #: docs the last chain left overflowed
        self.chain_overflow = 0

    def __call__(self, fn, label: str, ctx=contextlib.nullcontext) -> float:
        base, device = self.base, self.device
        with ctx():
            first = fn(base)
            synchronize(device)
            if hasattr(first, "overflow") and bool(first.overflow.any()):
                raise AssertionError(f"{label.strip()}: one call from the empty state "
                                     "overflowed")
            t0 = time.perf_counter()
            st = base
            for _ in range(REPS):
                st = fn(st)
            synchronize(device)
            seconds = (time.perf_counter() - t0) / REPS
        if int(base.num_slots.sum()) or bool(base.overflow.any()):
            raise AssertionError(f"{label.strip()}: a call changed the empty state it was given")
        self.chain_overflow = int(st.overflow.sum()) if hasattr(st, "overflow") else 0
        self.calls[label.strip()] = (fn, ctx)
        return seconds

    def device_line(self) -> None:
        if self.device.type != "cuda":
            print("device busy ms per call: not measured (cpu)")
            return
        from peritext_tpu_torch.testing.devtime import DeviceBusy

        with DeviceBusy() as busy:
            for name, (fn, ctx) in self.calls.items():
                with ctx():
                    busy.measure(name, lambda: fn(self.base), reps=2)
        print(f"device ms per call ({busy.source}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in busy.ms.items()))


def phase_cost(device, docs, slots, marks) -> None:
    from peritext_tpu_torch.ops.packed import empty_docs

    base = empty_docs(docs, slots, marks, tomb_capacity=slots, device=device)
    steady = Steady(base, device)
    overflowed = {}
    for label, widths, loop_slots, per_doc in CONFIGS:
        seconds = steady(_apply(device, docs, widths, loop_slots, per_doc), label)
        overflowed[label.split()[0]] = steady.chain_overflow
        print(f"{label}{seconds*1e3:7.2f} ms")
    print(f"docs overflowed by each {REPS}-call chain: {overflowed}")
    steady.device_line()


@contextlib.contextmanager
def plain_insert():
    """The insert phase's plain torch version in place of K1, on any
    device, for the floor probe's ``impl=plain`` arm."""
    from peritext_tpu_torch.ops import kernel
    from peritext_tpu_torch.ops.insert import insert_batch_reference

    launched = kernel.insert_batch
    kernel.insert_batch = lambda *a, loop_slots=None, **_: insert_batch_reference(
        *a, loop_slots=loop_slots)
    try:
        yield
    finally:
        kernel.insert_batch = launched


def floor_probe(device, docs, slots, marks) -> None:
    """What is a call's floor made of?"""
    from peritext_tpu_torch.ops.packed import empty_docs

    base = empty_docs(docs, slots, marks, tomb_capacity=slots, device=device)
    steady = Steady(base, device)
    ident = lambda st: st._replace(num_slots=st.num_slots + 1)  # noqa: E731
    print(f"identity(+1 on counts):      {steady(ident, 'identity')*1e3:7.2f} ms")
    touch = lambda st: st._replace(elem_id=st.elem_id + 1, char=st.char + 1,  # noqa: E731
                                   num_slots=st.num_slots + 1)
    print(f"touch elem+char planes:      {steady(touch, 'touch')*1e3:7.2f} ms")
    touch_all = lambda st: type(st)(*(x + 1 if x.dtype != torch.bool else x  # noqa: E731
                                      for x in st))
    print(f"touch ALL planes:            {steady(touch_all, 'touch_all')*1e3:7.2f} ms")
    fn = _apply(device, docs, (8, 8, 8, 8), 64, (4, 2, 2, 1))
    for impl, ctx in (("cuda", contextlib.nullcontext), ("plain", plain_insert)):
        seconds = steady(fn, f"apply_{impl}", ctx)
        print(f"floor apply impl={impl:18s}{seconds*1e3:7.2f} ms")
    steady.device_line()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--floor", action="store_true", help="the floor probe instead")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--docs", type=int, default=2048)
    parser.add_argument("--slots", type=int, default=384)
    parser.add_argument("--marks", type=int, default=96)
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_apply_phase_cost")
    if device is None:
        return 2
    run = floor_probe if args.floor else phase_cost
    run(device, args.docs, args.slots, args.marks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
