#!/usr/bin/env python3
"""obs smoke: a 128-doc streaming session with tracing on, the port's twin
of ``scripts/obs_smoke.py``.

Runs a real streaming merge on ``--device`` (the card by default) with the
tracer enabled, asserts that a NON-EMPTY Perfetto dump parses back as
Chrome trace-event JSON covering every pipeline stage, writes the artifacts
(``trace.json``, ``health.json``) to ``--out``, and prints the per-stage
summary table.

    python3 scripts/torch_obs_smoke.py --out /tmp/pt-obs
    python3 scripts/torch_obs_smoke.py --out /tmp/pt-obs --device cpu

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402

#: stages the dump must cover: the streaming pipeline plus digest
REQUIRED_STAGES = (
    "streaming.ingest", "streaming.schedule", "streaming.apply",
    "streaming.resolve", "streaming.decode", "streaming.patch-scatter",
    "streaming.digest",
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--docs", type=int, default=128)
    parser.add_argument("--ops-per-doc", type=int, default=24)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--out", default="obs-artifacts",
                        help="artifact directory (trace.json, health.json)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_obs_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import Tracer, health_snapshot
    from peritext_tpu_torch.obs.__main__ import load_spans, render_table, summarize
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.testing.fuzz import _campaign_session, generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    tracer = Tracer(host="obs-smoke", enabled=True)
    session = _campaign_session(args.docs, args.ops_per_doc, device=device)
    session.tracer = tracer

    rng = random.Random(args.seed)
    workloads = generate_workload(args.seed, num_docs=args.docs, ops_per_doc=args.ops_per_doc)
    for d, workload in enumerate(workloads):
        changes = [ch for log in workload.values() for ch in log]
        rng.shuffle(changes)
        frames = [encode_frame(changes[i:i + 9]) for i in range(0, len(changes), 9)]
        session.ingest_frames((d, f) for f in frames)
        if d % 16 == 0:
            session.step()
    session.drain()
    session.read_all()
    session.read_patches_all()
    digest = session.digest()

    trace_path = out / "trace.json"
    tracer.write_chrome_trace(trace_path)
    (out / "health.json").write_text(
        json.dumps(health_snapshot(session=session), indent=2, default=str))

    # -- the smoke assertions -------------------------------------------------
    doc = json.loads(trace_path.read_text())  # must parse back
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    if not events:
        print("obs-smoke FAIL: Perfetto dump has no span events", file=sys.stderr)
        return 1
    bad = [e for e in events if not all(k in e for k in ("name", "ts", "dur", "pid", "tid"))]
    if bad:
        print(f"obs-smoke FAIL: malformed events: {bad[:3]}", file=sys.stderr)
        return 1
    names = {e["name"] for e in events}
    missing = [s for s in REQUIRED_STAGES if s not in names]
    if missing:
        print(f"obs-smoke FAIL: stages missing from trace: {missing}", file=sys.stderr)
        return 1

    print(f"obs-smoke OK: {len(events)} spans, digest={digest:#010x}, artifacts in {out}/")
    print(render_table(summarize(load_spans(trace_path))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
