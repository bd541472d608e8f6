#!/usr/bin/env python3
"""Same-run A/B of the captured rounds on one card, unfused against fused:
the port's twin of ``scripts/engine_ab.py``.  Load on a shared host swamps
absolutes across runs, so the arms take turns in ONE process and each
reports its min of N.

* unfused: one ``apply_batch_compact`` per captured round (each launching
  K1), then the digest, each call enqueued from the host;
* fused: every round in one ``apply_batch_compact_rounds`` site call and
  the digest, through ``testing/engine.EngineReplay``: on a card its CUDA
  graph form, pass 1 eager, pass 2 captured, later passes one replay, each
  reported on its own line.

Both arms' digests must equal the live session's.  Then a fresh live
session runs on the default (fused, pipelined) drain.

    python3 scripts/torch_engine_ab.py [--device cuda|cpu] [--docs 2048]

The first line names the device (the card's name and power limit, or
``cpu``).  Host times end in a synchronize (the digest's read-back).
Exits non-zero without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402

ACTORS = ("doc1", "doc2", "doc3")
TURNS = 4


def _session(device, docs):
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    return StreamingMerge(
        num_docs=docs, actors=ACTORS, slot_capacity=384, mark_capacity=96, tomb_capacity=384,
        round_insert_capacity=256, round_delete_capacity=128, round_mark_capacity=128,
        device=device)


def _feed(s, arrival, rounds):
    for r in range(rounds):
        s.ingest_frames((doc, b[r]) for doc, b in enumerate(arrival) if r < len(b))
        s.drain()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--docs", type=int, default=2048)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--ops-per-doc", type=int, default=192)
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_engine_ab")
    if device is None:
        return 2

    import torch

    from peritext_tpu_torch.testing.devtime import generate
    from peritext_tpu_torch.ops.kernel import apply_batch_compact
    from peritext_tpu_torch.ops.packed import empty_docs
    from peritext_tpu_torch.parallel.streaming import _resolve_block_digest
    from peritext_tpu_torch.testing.arrival import build_arrival
    from peritext_tpu_torch.testing.engine import EngineReplay, replay_digest

    docs, rounds = args.docs, args.rounds
    workloads = generate(0, docs, args.ops_per_doc)
    arrival, _ = build_arrival(workloads, rounds, 0, as_frames=True)
    captured = []
    s = _session(device, docs)
    s._capture_rounds = captured
    t0 = time.perf_counter()
    _feed(s, arrival, rounds)
    expected = s.digest()
    print(f"live session (capture on): {time.perf_counter()-t0:.2f}s, "
          f"{len(captured)} rounds captured")
    if s.overflow_count():
        raise AssertionError(f"engine A/B: {s.overflow_count()} overflowed docs would skew the "
                             "replay")

    caps = s.config
    state0 = empty_docs(s._padded_docs, 384, 96, tomb_capacity=384,
                        map_capacity=caps["map_capacity"], device=device)
    tables = s._digest_tables(0, s._padded_docs)
    row_mask = torch.ones(s._padded_docs, dtype=torch.bool, device=device)

    def unfused():
        st = state0
        for (c, i, dl, mk, mp), w, ls in captured:
            st = apply_batch_compact(st, c, i, dl, mk, mp, widths=w, insert_loop_slots=ls)
        return replay_digest(_resolve_block_digest(st, s.comment_capacity, row_mask,
                                                   *tables)[1])

    engine = EngineReplay(captured, s._padded_docs, caps, device, tables)

    def fused():
        return replay_digest(engine())

    def timed(fn):
        t0 = time.perf_counter()
        got = fn()
        seconds = time.perf_counter() - t0
        if got != expected:
            raise AssertionError(f"engine A/B: digest {got:#x} != the session's {expected:#x}")
        return seconds

    first = {"unfused": timed(unfused), "fused": timed(fused)}  # fused pass 1: eager
    res = {"unfused": [], "fused": []}
    for _ in range(TURNS):
        for name, fn in (("unfused", unfused), ("fused", fused)):
            res[name].append(timed(fn))
    for name, ts in res.items():
        print(f"{name}: min {min(ts)*1e3:7.1f} ms  all {[round(t*1e3) for t in ts]}")
    print(f"fused pass 1 (eager): {first['fused']*1e3:7.1f} ms")
    print(f"fused pass 2 (capture): {res['fused'][0]*1e3:7.1f} ms")
    print(f"fused replays: min {min(res['fused'][1:])*1e3:7.1f} ms  all "
          f"{[round(t*1e3, 1) for t in res['fused'][1:]]}; graphs {engine.graphs.stats()}")
    print(f"digests: unfused = fused = session {expected:#010x}")

    # a fresh live session on the fused drain, in the same process
    t0 = time.perf_counter()
    s2 = _session(device, docs)
    _feed(s2, arrival, rounds)
    if s2.digest() != expected:
        raise AssertionError("engine A/B: the fused-drain session's digest != the capture's")
    print(f"live session (fused drain, warm compiles): {time.perf_counter()-t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
