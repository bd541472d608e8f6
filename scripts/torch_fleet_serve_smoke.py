#!/usr/bin/env python3
"""fleet-serve smoke: the live-fleet failover contract, the port's twin of
``scripts/fleet_serve_smoke.py``.

Runs the failover episode end to end with every host's session on
``--device`` (the card by default): a 3-host :class:`FleetFrontend` (real
TCP ship endpoints over loopback) carries round-robin client traffic, one
serving host is KILLED mid-traffic, the round-counted heartbeat lease
detects it, and failover re-homes the dead host's docs from the last
shipped checkpoint + journal redelivery (a ship receive runs on the
receiving session's device and stream).  Asserted promises (inside
``testing/chaos.run_host_kill_failover``):

* **typed verdicts only** — zero silent drops across the kill window; the
  fleet-wide accounting identity holds and every shed reason is typed;
* **acked-op survival** — every admitted frame is reflected in the
  re-homed docs' state before any client retry;
* **post-heal byte equality** — after retries drain, every doc (and the
  fleet-wide digest sum) equals a fault-free reference run bit-for-bit;
* **observable** — the failover timeline lands in flight-recorder dumps,
  and a second, live frontend episode is scraped through ``/fleet.json``
  on a loopback ``MetricsServer`` + the ``peritext_fleet_*`` gauges.

Artifacts (``fleet-serve-report.json``, ``fleet.json`` snapshot, flight
dumps) are written to ``--out``.

    python3 scripts/torch_fleet_serve_smoke.py --out /tmp/pt-fleet-serve [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--out", default="fleet-serve-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_fleet_serve_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import MetricsServer, prometheus_text
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.serve import AdmissionController, FleetFrontend, SessionMux
    from peritext_tpu_torch.testing.chaos import _serve_session, run_host_kill_failover
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dump_dir = out / "flight"
    dump_dir.mkdir(exist_ok=True)

    # -- the acceptance episode (all oracles assert inside) -----------------
    report = run_host_kill_failover(args.seed, hosts=3, num_docs=6, ops_per_doc=24,
                                    transport=True, dump_dir=dump_dir, device=device)
    assert report.acked_survived and report.converged, report.to_json()
    assert report.delayed + report.shed > 0, "the kill produced no typed-verdict evidence"
    print(
        f"host-kill episode: victim={report.victim} "
        f"({report.victim_docs} docs), detection in "
        f"{report.detection_rounds} rounds, {report.failover_docs} docs "
        f"re-homed, {report.offered} offered = {report.admitted} admitted "
        f"+ {report.delayed} delayed + {report.shed} shed"
    )

    # -- exporter surface on a live frontend --------------------------------
    fe = FleetFrontend(lease_rounds=2, checkpoint_every=2)
    for i in range(3):
        fe.add_host(f"host{i}", SessionMux(
            _serve_session(4, 24, device=device),
            admission=AdmissionController(max_depth=64, session_quota=None),
        ))
    try:
        workloads = generate_workload(args.seed + 1, num_docs=3, ops_per_doc=24)
        for d, w in enumerate(workloads):
            changes = [ch for log in sorted(w) for ch in w[log]]
            assert fe.open_doc(f"doc{d}", f"client{d}").admitted
            for i in range(0, len(changes), 6):
                assert fe.submit(f"doc{d}", encode_frame(changes[i:i + 6])).admitted
        fe.round()
        fe.flush()
        fe.hosts["host1"].kill()
        for _ in range(3):
            fe.round()
        assert fe.failovers == 1, "exporter episode failover missing"

        server = MetricsServer(fleet=fe)
        host, port = server.start()
        try:
            body = json.loads(urllib.request.urlopen(
                f"http://{host}:{port}/fleet.json", timeout=5).read())
        finally:
            server.stop()
        assert body["failovers"] == 1
        assert body["leases"]["leases"]["host1"]["verdict"] == "dead"
        (out / "fleet.json").write_text(json.dumps(body, indent=2))

        text = prometheus_text(fleet=fe)
        for needle in ("peritext_fleet_dead_hosts 1", "peritext_fleet_failovers_total 1"):
            assert needle in text, needle
    finally:
        fe.stop()

    dumps = sorted(dump_dir.glob("*.jsonl"))
    assert dumps, "no flight-recorder failover timeline dumped"
    (out / "fleet-serve-report.json").write_text(json.dumps(report.to_json(), indent=2))
    print(f"fleet-serve smoke OK; artifacts in {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
