#!/usr/bin/env python3
"""Would the native causal scheduler pay on the object path?  Session A of
chip_smoke.py (BASELINE config 5: 2048 fuzz docs x 192 ops, 4 arrival
rounds, object ingest, the default arm) on one NVIDIA card, in interleaved
pairs: ``python`` (the package's ``causal_schedule``, the Python heap)
against ``native`` (sets of ``--threshold`` changes or more turned into
arrays and scheduled by the package's C++ ``pt_causal_schedule``, the
reference's route).  The arms' order alternates from pair to pair.

    python3 scripts/torch_causal_pairs.py [--pairs 10] [--threshold 64] [--docs N] [--reps 5]

Then the crossover: the ``causal_schedule`` inputs of one session, recorded
as the streaming schedule makes them, grouped by set size and timed through
each route (``--reps`` passes, the least kept).  Prints one JSON line per
session, the pair summary, the crossover table and, last, the card's name
and power limit.  Exits non-zero without a card or without the native
library.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: set-size bins of the crossover table, [lo, hi)
BINS = ((1, 16), (16, 32), (32, 48), (48, 64), (64, 96), (96, 128), (128, 1 << 30))
#: inputs timed per bin
PER_BIN = 300


def native_schedule(changes, base_clock):
    """``causal_schedule(changes, base_clock)`` through ``pt_causal_schedule``.
    Actor indices follow sorted actor names, so the C++ heap keeps the Python
    tie-break; a dep on an actor absent from the set and the clock becomes an
    impossible self-dep."""
    from peritext_tpu_torch import native

    actors = sorted({ch.actor for ch in changes} | set(base_clock or {}))
    index = {a: i for i, a in enumerate(actors)}
    n = len(changes)
    dep_off = np.zeros(n + 1, np.int32)
    dep_actor, dep_seq = [], []
    for i, ch in enumerate(changes):
        for a, s in (ch.deps or {}).items():
            if a in index:
                dep_actor.append(index[a])
                dep_seq.append(s)
            elif s > 0:
                dep_actor.append(index[ch.actor])
                dep_seq.append(np.iinfo(np.int32).max)
        dep_off[i + 1] = len(dep_actor)
    clock = np.zeros(len(actors), np.int32)
    for a, s in (base_clock or {}).items():
        clock[index[a]] = s
    order = native.causal_schedule_indices(
        np.fromiter((index[ch.actor] for ch in changes), np.int32, n),
        np.fromiter((ch.seq for ch in changes), np.int32, n),
        dep_off, np.asarray(dep_actor, np.int32), np.asarray(dep_seq, np.int32),
        len(actors), clock)
    ordered = [changes[i] for i in order]
    if len(ordered) == n:
        return ordered, []
    scheduled = set(order.tolist())
    clock0 = dict(base_clock or {})
    pending = {}
    for i, ch in enumerate(changes):
        key = (ch.actor, ch.seq)
        if key not in pending and ch.seq > clock0.get(ch.actor, 0):
            pending[key] = i
    return ordered, [changes[i] for _, i in sorted(pending.items()) if i not in scheduled]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("causal pairs: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import STREAM, run_stream_session
    from peritext_tpu_torch.testing.devtime import generate
    from peritext_tpu_torch import native
    from peritext_tpu_torch.parallel import causal
    from peritext_tpu_torch.parallel import streaming as streaming_mod
    from peritext_tpu_torch.testing.arrival import build_arrival

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--threshold", type=int, default=64)
    parser.add_argument("--docs", type=int, default=STREAM["docs"])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not native.available():
        print("causal pairs: the native library did not load", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    device = torch.device("cuda")
    cfg = STREAM
    workloads = generate(cfg["seed"], args.docs, cfg["ops"])
    arrival = build_arrival(workloads, cfg["rounds"], cfg["seed"])
    inputs = []

    def routed(changes, base_clock=None):
        changes = list(changes)
        if len(changes) >= args.threshold:
            return native_schedule(changes, base_clock)
        return causal.causal_schedule(changes, base_clock)

    def recording(changes, base_clock=None):
        changes = list(changes)
        inputs.append((changes, dict(base_clock or {})))
        return causal.causal_schedule(changes, base_clock)

    arms = {"python": causal.causal_schedule, "native": routed, "record": recording}

    def session(arm, name):
        streaming_mod.causal_schedule = arms[arm]
        gc.collect()
        try:
            _, rep = run_stream_session(device, cfg, workloads, arrival, name)
        finally:
            streaming_mod.causal_schedule = causal.causal_schedule
        calls = rep["native_calls"].get("causal_schedule", 0)
        if (calls > 0) != (arm == "native"):
            raise AssertionError(f"{name}: {calls} native causal_schedule calls in the {arm} arm")
        row = {"session": name, "arm": arm, "schedule_s": rep["stage_seconds"]["schedule"],
               "wall_s": rep["wall_seconds"], "gc_s": rep["gc_seconds"],
               "native_causal_calls": calls}
        print(json.dumps(row), flush=True)
        return row

    # untimed: loads every module and kernel, and records the schedule's inputs
    session("record", "warm-up")
    rows = []
    for p in range(args.pairs):
        for arm in (("native", "python") if p % 2 == 0 else ("python", "native")):
            rows.append(session(arm, f"pair{p}-{arm}"))
    by_arm = {a: [r for r in rows if r["arm"] == a] for a in ("native", "python")}
    wins = {k: sum(n[k] < py[k] for n, py in zip(by_arm["native"], by_arm["python"]))
            for k in ("schedule_s", "wall_s")}
    print(json.dumps({
        "pairs": args.pairs, "native_threshold": args.threshold, "native_wins": wins,
        **{f"{a}_{k}_median": statistics.median(r[k] for r in by_arm[a])
           for a in by_arm for k in ("schedule_s", "wall_s")},
        **{f"{a}_schedule_s": [r["schedule_s"] for r in by_arm[a]] for a in by_arm},
    }), flush=True)

    def keys(result):
        return [[(c.actor, c.seq) for c in part] for part in result]

    table = []
    for lo, hi in BINS:
        group = [x for x in inputs if lo <= len(x[0]) < hi][:PER_BIN]
        if not group:
            continue
        for changes, clock in group:  # the two routes agree on every input
            if keys(native_schedule(changes, clock)) != keys(causal.causal_schedule(changes, clock)):
                raise AssertionError(f"the routes disagree on a set of {len(changes)} changes")
        best = {}
        for rep in range(args.reps):
            for arm in (("native", "python") if rep % 2 == 0 else ("python", "native")):
                fn = native_schedule if arm == "native" else causal.causal_schedule
                t0 = time.perf_counter()
                for changes, clock in group:
                    fn(changes, clock)
                dt = (time.perf_counter() - t0) / len(group) * 1e6
                best[arm] = min(best.get(arm, dt), dt)
        table.append({"sizes": [lo, hi], "largest": max(len(x[0]) for x in group),
                      "calls_in_session": sum(lo <= len(x[0]) < hi for x in inputs),
                      "timed": len(group), "python_us": best["python"],
                      "native_us": best["native"],
                      "native_over_python": best["native"] / best["python"]})
    print(json.dumps({"crossover": table, "session_calls": len(inputs)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
