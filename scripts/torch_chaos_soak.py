#!/usr/bin/env python3
"""Chaos soak: N seeded campaigns of the composed fault harness, the port's
twin of ``scripts/chaos_soak.py``.

Each seed runs ``peritext_tpu_torch.testing.chaos.run_chaos``: delivery
faults, payload corruption, peer stalls, injected device-round failures
and a crash-restore, all against the byte-equality convergence oracle,
with its sessions on ``--device`` (the card by default).  Any oracle
violation or unhandled exception fails the soak with the seed in the
error.

    python3 scripts/torch_chaos_soak.py --seeds 20            # the `make chaos` run
    python3 scripts/torch_chaos_soak.py --seeds 200 --docs 8  # a long soak

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on a failed campaign, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Composed-fault chaos soak")
    parser.add_argument("--seeds", type=int, default=20, help="number of seeded campaigns")
    parser.add_argument("--seed0", type=int, default=0,
                        help="first seed (campaigns run seed0..seed0+seeds-1)")
    parser.add_argument("--docs", type=int, default=6)
    parser.add_argument("--ops", type=int, default=40)
    parser.add_argument("--no-transport", action="store_true",
                        help="skip the peer-stall transport episode")
    parser.add_argument("--no-crash", action="store_true",
                        help="skip the crash-restore episode")
    parser.add_argument("--json", action="store_true", help="emit one JSON line per campaign")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_chaos_soak")
    if device is None:
        return 2

    from peritext_tpu_torch.observability import GLOBAL_COUNTERS, health_snapshot
    from peritext_tpu_torch.testing.chaos import run_chaos

    t0 = time.time()
    failures = 0
    for seed in range(args.seed0, args.seed0 + args.seeds):
        try:
            report = run_chaos(
                seed, num_docs=args.docs, ops_per_doc=args.ops,
                transport=not args.no_transport, crash=not args.no_crash, device=device,
            )
        except Exception as exc:  # noqa: BLE001 - the soak reports, then fails
            failures += 1
            print(f"seed {seed:4d}: FAILED — {exc}", file=sys.stderr)
            continue
        if args.json:
            print(json.dumps(report.to_json()))
        else:
            print(
                f"seed {seed:4d}: ok  frames={report.delivered_frames:3d} "
                f"corrupt_q={report.corrupt_frames} "
                f"q_peak={report.quarantined_peak} "
                f"rollbacks={report.rollbacks} "
                f"behind={report.transport_behind} "
                f"crash={report.crash_restores} "
                f"digest={report.final_digest:#010x}"
            )
    wall = time.time() - t0
    counters = health_snapshot(GLOBAL_COUNTERS)["counters"]
    print(f"\n{args.seeds - failures}/{args.seeds} campaigns clean "
          f"in {wall:.1f}s; health counters:")
    for name, value in counters.items():
        print(f"  {name:40s} {value:g}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
