#!/usr/bin/env python3
"""fleet smoke: an in-process multi-host partition/heal episode, the
port's twin of ``scripts/fleet_smoke.py``.

Runs a real N-host ``ReplicaServer`` fleet through the chaos harness's
asymmetric-partition schedule — host0 hears every peer's frontier but
every reply is cut, one link flaps, the heal leaves the largest-lag link
slow — and asserts

* host0's ConvergenceMonitor learned its true per-peer lag,
* ``peritext_convergence_lag_ops`` was live in ``/metrics`` mid-episode,
* the first post-heal gossip round followed behind-ness priority,
* the fleet drained to identical fleet-wide store digests,

then runs the seeded same-frontier/different-digest injection and asserts
it reports as a DIVERGENCE incident (counter + flight-recorder dump),
never plain lag.  The episodes are host work (change stores, gossip over
loopback TCP); no session runs on the device.  Artifacts
(``fleet-report.json``, ``divergence.json``, a convergence snapshot, the
divergence flight dump) are written to ``--out``; the convergence report
renders via ``python -m peritext_tpu_torch.obs fleet``.

    python3 scripts/torch_fleet_smoke.py --out /tmp/pt-fleet [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--hosts", type=int, default=4)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--out", default="fleet-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if script_device(args.device, "torch_fleet_smoke") is None:
        return 2

    from peritext_tpu_torch.obs.__main__ import main as obs_main
    from peritext_tpu_torch.testing.chaos import run_divergence_injection, run_fleet_chaos

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    report = run_fleet_chaos(args.seed, hosts=args.hosts)
    (out / "fleet-report.json").write_text(json.dumps(report.to_json(), indent=1))
    print(f"fleet episode: {args.hosts} hosts, "
          f"lag {sum(report.expected_lag.values())} ops at heal, "
          f"drained {report.ops_drained} ops in "
          f"{report.heal_rounds} round(s) / {report.heal_seconds:.2f}s, "
          f"heal order {report.heal_order}")
    if not (report.converged and report.lag_gauge_seen):
        print("fleet smoke: episode oracles failed", file=sys.stderr)
        return 1

    evidence = run_divergence_injection(args.seed, dump_dir=out / "flight")
    (out / "divergence.json").write_text(json.dumps(evidence, indent=1))
    print(f"divergence injection: incident reported, dump {evidence['dump']}")

    # a convergence snapshot the fleet CLI can render (the healed fleet:
    # the command must exit 0 = converged, and the table must print)
    conv = out / "convergence.json"
    conv.write_text(json.dumps({
        "host": "fleet-smoke",
        "rounds": report.heal_rounds,
        "peers": {
            name: {
                "ops_behind": 0, "ops_ahead": 0,
                "peak_ops_behind": report.expected_lag[name],
                "staleness_rounds": 0, "exchanges": 1, "failures": 0,
                "divergent": False, "last_outcome": "converged",
            } for name in report.heal_order
        },
        "total_lag_ops": 0,
        "divergence_incidents": 0,
        "divergent_peers": [],
    }))
    rc = obs_main(["fleet", str(conv)])
    if rc != 0:
        print(f"fleet smoke: obs fleet view exited {rc}", file=sys.stderr)
        return 1
    print(f"fleet smoke OK — artifacts in {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
