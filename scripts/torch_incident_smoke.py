#!/usr/bin/env python3
"""incident smoke: the fleet incident plane end to end, the port's twin of
``scripts/incident_smoke.py``.

Runs the host-kill chaos episode with its sessions on ``--device`` (the
card by default) and a private incident monitor riding the fleet
snapshot, and asserts it opens EXACTLY a host-death incident, resolves it
post-heal, and reports time-to-detection in monitor rounds; merges the
episode's flight dumps into the cross-host black-box timeline; exercises
the ``obs incidents`` / ``obs status`` / ``obs flight`` exit contracts (0
clean / 1 open or unhealthy / 2 unreadable); and pins the arming cost:
feeding the plane builds, loads and captures nothing
(``obs.RecompileSentinel``) and stays wall-clock cheap.  Artifacts
(``hostkill.json``, ``incidents.json``, ``incidents.prom``,
``timeline.json``) land in ``--out``.

    python3 scripts/torch_incident_smoke.py --out /tmp/pt-incident [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
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

#: feeding budget: 2k observe+advance rounds of a busy monitor must stay
#: under this wall — the plane is dict folds, not device work
FEED_ROUNDS = 2000
FEED_BUDGET_S = 2.0


def fail(msg: str) -> int:
    print(f"incident-smoke FAIL: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=2)
    parser.add_argument("--out", default="incident-artifacts")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_incident_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import IncidentMonitor, merge_flight_dumps
    from peritext_tpu_torch.obs.__main__ import main as obs_main
    from peritext_tpu_torch.obs.exporters import prometheus_text
    from peritext_tpu_torch.obs.sentinel import RecompileSentinel
    from peritext_tpu_torch.testing.chaos import run_host_kill_failover

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    flight_dir = out / "flight"
    flight_dir.mkdir(exist_ok=True)

    # -- the chaos oracle: host-kill opens EXACTLY host-death ----------------
    t0 = time.perf_counter()
    report = run_host_kill_failover(args.seed, hosts=3, num_docs=4, ops_per_doc=16,
                                    transport=False, dump_dir=flight_dir, device=device)
    episode_s = time.perf_counter() - t0
    (out / "hostkill.json").write_text(json.dumps(report.to_json(), indent=2))
    if report.incident_kinds != ["host-death"]:
        return fail(f"host-kill opened {report.incident_kinds}, expected exactly ['host-death']")
    if not report.incident_resolved:
        return fail("host-death incident never resolved post-heal")
    if report.incident_detection_rounds < 1:
        return fail("time-to-detection missing from the episode report")
    print(f"incident-smoke: host-kill episode OK in {episode_s:.1f}s "
          f"(victim={report.victim}, "
          f"detection={report.incident_detection_rounds} monitor rounds)")

    # -- the merged black-box timeline ---------------------------------------
    merged = merge_flight_dumps(flight_dir.glob("flight-*.jsonl"))
    (out / "timeline.json").write_text(json.dumps(merged, indent=2, default=str))
    if not merged["records"]:
        return fail("the episode's flight dumps merged to an empty timeline")
    if "?" in merged["hosts"]:
        return fail("a flight dump lost its host attribution")
    reasons = {d["reason"] for d in merged["dumps"]}
    if "host-death" not in reasons:
        return fail(f"merged timeline lacks the host-death dump: {reasons}")
    rc = obs_main(["flight", str(flight_dir)])
    if rc != 0:
        return fail(f"obs flight exit {rc} on a dump dir (want 0)")

    # -- the CLI exit contracts ----------------------------------------------
    def synth_monitor(open_incident: bool) -> IncidentMonitor:
        m = IncidentMonitor(host="smoke")
        if open_incident:
            m.raise_signal("shed-storm", host="h0", value=5)
            m.raise_signal("slo-burn", host="h0", value=2)
        m.advance_round()
        return m

    open_m, clean_m = synth_monitor(True), synth_monitor(False)
    snap_dir = out / "status"
    snap_dir.mkdir(exist_ok=True)
    (out / "incidents.json").write_text(json.dumps(open_m.snapshot()))
    (snap_dir / "incidents.json").write_text(json.dumps(clean_m.snapshot()))
    rc = obs_main(["incidents", str(out / "incidents.json")])
    if rc != 1:
        return fail(f"obs incidents exit {rc} with an open incident (want 1)")
    rc = obs_main(["incidents", str(snap_dir / "incidents.json")])
    if rc != 0:
        return fail(f"obs incidents exit {rc} on a clean snapshot (want 0)")
    rc = obs_main(["incidents", str(out / "missing.json")])
    if rc != 2:
        return fail(f"obs incidents exit {rc} on unreadable input (want 2)")
    rc = obs_main(["status", str(snap_dir)])
    if rc != 0:
        return fail(f"obs status exit {rc} on a clean snapshot dir (want 0)")

    # correlated view: the two same-host signals collapsed into ONE
    # incident with the larger delta as root cause
    snap = open_m.snapshot()
    if snap["total"] != 1 or snap["incidents"][0]["kind"] != "shed-storm":
        return fail(f"correlation broke: {snap['incidents']}")

    # -- gauges --------------------------------------------------------------
    text = prometheus_text(incidents=open_m)
    (out / "incidents.prom").write_text(text)
    for needle in ("peritext_incident_open ", "peritext_build_info{",
                   'peritext_incident_open_by_kind{kind="host-death"}'):
        if needle not in text:
            return fail(f"{needle!r} missing from the exposition")

    # -- arming cost: nothing built, loaded or captured; cheap wall ----------
    with RecompileSentinel() as sentinel:
        before = sentinel.total
        m = IncidentMonitor(host="smoke")
        t0 = time.perf_counter()
        for n in range(FEED_ROUNDS):
            if n % 7 == 0:
                m.observe_serve({"host": "h0", "recent_sheds": n % 3, "overloaded": False})
            m.observe_sentinel({"total": 0})
            m.advance_round()
        wall = time.perf_counter() - t0
        if sentinel.total != before:
            return fail("feeding the incident plane built, loaded or captured kernels")
    if wall > FEED_BUDGET_S:
        return fail(f"{FEED_ROUNDS} monitor rounds took {wall:.2f}s (budget {FEED_BUDGET_S}s)")

    print(f"incident-smoke OK: timeline={merged['records']} records across "
          f"{len(merged['hosts'])} host(s), {FEED_ROUNDS} monitor rounds in "
          f"{wall * 1e3:.0f}ms, 0 compiles, artifacts in {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
