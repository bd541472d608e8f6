#!/usr/bin/env python3
"""Where the time of a streaming session goes on one NVIDIA card: session A
of chip_smoke.py (BASELINE config 5: 2048 fuzz docs x 192 ops, 4 arrival
rounds, the default arm, by object ingest or, with ``--frames``, by v2
wire frames through ``ingest_frames``) run three times on the port's
``StreamingMerge``.

    python3 scripts/torch_stream_profile.py [--docs N] [--frames]

1. plain: the stage seconds, schedule passes and docs scanned per pass,
   as chip_smoke.py reports them;
2. under ``torch.profiler``: the card's busy time (the sum of the kernels'
   and copies' device time) over the session's wall time, and the ops that
   take the most device time and the most host time;
3. under ``cProfile``: the host functions of the session by their own and
   cumulative time.

Each run makes its session anew from the same workload.  Prints one JSON
line per run and, last, the card's name and power limit.  Exits non-zero
without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: host functions whose cumulative time the cProfile run reports
HOST_FUNCTIONS = (
    "_schedule_round", "causal_schedule", "encode_increment", "_commit_rounds",
    "_ingest_frames_native", "parse_frames_bulk", "_step_frame_docs", "_gather_pool",
    "_flatten_round", "_upload", "apply_batch", "insert_batch", "_post_insert",
    "_apply_maps", "_pad_from_flat", "_resolution", "_refresh_digest_rows",
    "read_all", "read_patches_all", "synchronize",
)


def _top(events, key: str, n: int = 12):
    rows = sorted(events, key=lambda e: getattr(e, key), reverse=True)[:n]
    return [{"op": e.key, "calls": e.count, "ms": getattr(e, key) / 1e3} for e in rows]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import STREAM, run_stream_session
    from peritext_tpu_torch.testing.devtime import generate
    from peritext_tpu_torch.testing.arrival import build_arrival

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs", type=int, default=STREAM["docs"])
    parser.add_argument("--frames", action="store_true",
                        help="ingest v2 wire frames (the reference bench's default path)")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    device = torch.device("cuda")
    cfg = STREAM
    workloads = generate(cfg["seed"], args.docs, cfg["ops"])
    wire_bytes = None
    if args.frames:
        arrival, wire_bytes = build_arrival(workloads, cfg["rounds"], cfg["seed"],
                                            as_frames=True, wire=cfg["wire"])
    else:
        arrival = build_arrival(workloads, cfg["rounds"], cfg["seed"])
    session = lambda name: run_stream_session(  # noqa: E731
        device, cfg, workloads, arrival, name, wire_bytes=wire_bytes)

    # a first session loads every kernel module the path uses
    session("warm-up")
    _, plain = session("plain")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session("torch.profiler")
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(json.dumps({
        "run": "torch.profiler", "wall_s": wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
        "top_device": _top(events, "self_device_time_total"),
        "top_host": _top(events, "self_cpu_time_total"),
    }), flush=True)

    profiler = cProfile.Profile()
    profiler.enable()
    session("cProfile")
    profiler.disable()
    stats = pstats.Stats(profiler, stream=io.StringIO())
    funcs = {}
    for (path, line, name), (_, calls, tottime, cumtime, _) in stats.stats.items():
        if name in HOST_FUNCTIONS and "peritext_tpu_torch" in path or name == "synchronize":
            key = f"{Path(path).name}:{line} {name}"
            funcs[key] = {"calls": calls, "own_s": tottime, "cum_s": cumtime}
    own = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:15]
    print(json.dumps({
        "run": "cProfile", "functions": funcs,
        "top_own": [{"fn": f"{Path(p).name}:{line} {name}", "calls": v[1], "own_s": v[2]}
                    for (p, line, name), v in own],
    }), flush=True)
    print(json.dumps({"run": "plain", "ingest": plain["ingest"], **{
        k: plain[k] for k in ("stage_seconds", "wall_seconds", "ops_per_second",
                              "schedule_passes", "object_docs_scanned_per_pass",
                              "object_docs_scanned_per_pass_without_skip", "native_calls",
                              "wire_bytes_per_op")}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
