"""The port's chaos harness, network episodes, against the reference's.

Every episode binds ``127.0.0.1:0``, keeps the reference's per-socket
timeouts and closes its servers and gates.  Each runs in both packages for
the same seed (sessions on ``device="cpu"`` in the port, JAX's CPU in the
reference) and must report the same deterministic fields: verdict
accounting, digests, lag values, incident kinds and detection rounds.  No
wall time is compared.

* ``run_serve_chaos``: overload behind an asymmetric partition;
* ``run_host_kill_failover``: a serving host killed mid-traffic, with its
  flight dumps;
* ``run_fleet_chaos`` (``metrics=False``, and ``metrics=True`` with its
  ``/metrics`` scrape) and ``run_divergence_injection``;
* ``run_reconnect_storm`` at its smoke size (port only: open-loop traffic
  on the wall clock);
* port and reference ``ReplicaServer(incidents=)`` exchanging frontiers:
  each side's ``peer_views`` holds the other's ``wire_summary()``.
"""

import json
import time

import pytest

from peritext_tpu.obs import IncidentMonitor as RefMonitor
from peritext_tpu.parallel import multihost as ref_mh
from peritext_tpu.parallel.anti_entropy import ChangeStore as RefStore
from peritext_tpu.testing import chaos as ref_chaos
from peritext_tpu_torch.obs import IncidentMonitor
from peritext_tpu_torch.parallel import multihost as mh
from peritext_tpu_torch.parallel.anti_entropy import ChangeStore
from peritext_tpu_torch.testing import chaos

TIMEOUT = 10.0


def _fields(report, names):
    data = report.to_json() if hasattr(report, "to_json") else dict(report)
    return {k: data[k] for k in names}


def _wait_for(predicate, timeout=TIMEOUT):
    end = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > end:
            raise AssertionError("condition never held")
        time.sleep(0.01)


def test_serve_chaos_equals_the_reference():
    port = chaos.run_serve_chaos(0, device="cpu")
    ref = ref_chaos.run_serve_chaos(0)
    names = ("offered", "admitted", "delayed", "shed", "shed_reasons", "queue_peak",
             "queue_max_depth", "partition_lag_ops", "fleet_converged",
             "serve_digest_matches_reference", "repaired_digest_matches_clean", "final_digest",
             "latency_sum_consistent", "incident_kinds", "incident_resolved",
             "incident_detection_rounds", "anomaly_keys", "anomaly_detection_rounds")
    assert _fields(port, names) == _fields(ref, names)
    assert port.shed > 0 and port.incident_kinds == ["shed-storm"]


def test_host_kill_failover_equals_the_reference(tmp_path):
    port = chaos.run_host_kill_failover(0, device="cpu", dump_dir=tmp_path / "port")
    ref = ref_chaos.run_host_kill_failover(0, dump_dir=tmp_path / "ref")
    names = ("victim", "victim_docs", "offered", "admitted", "delayed", "shed", "shed_reasons",
             "detection_rounds", "failovers", "failover_docs", "acked_at_kill",
             "acked_survived", "redelivered", "converged", "final_digest", "flight_dumps",
             "incident_kinds", "incident_resolved",
             "incident_detection_rounds", "anomaly_keys", "anomaly_detection_rounds")
    # applied_frames is left out: a mux applies its buffer when its window
    # expires on the wall clock, so what the killed host had applied varies
    assert _fields(port, names) == _fields(ref, names)
    assert port.incident_kinds == ["host-death"] and port.incident_detection_rounds <= 6
    reasons = []
    for side in ("port", "ref"):
        rows = [json.loads(line) for path in sorted((tmp_path / side).glob("*.jsonl"))
                for line in path.read_text().splitlines() if line]
        reasons.append(sorted(r["reason"] for r in rows if r.get("kind") == "fault"))
    assert reasons[0] == reasons[1]


def test_fleet_chaos_equals_the_reference():
    port = chaos.run_fleet_chaos(0, hosts=4, metrics=False)
    ref = ref_chaos.run_fleet_chaos(0, hosts=4, metrics=False)
    for r in (port, ref):
        assert r.converged and r.divergence_incidents == 0
        # the most-behind peer is healed first
        assert r.heal_order == [n for n, _ in sorted(r.expected_lag.items(),
                                                     key=lambda kv: (-kv[1], kv[0]))]
    assert sorted(port.observed_lag.values()) == sorted(ref.observed_lag.values())
    assert (port.partition_rounds, port.final_digest) == (ref.partition_rounds, ref.final_digest)


def test_fleet_chaos_metrics_scrape_is_not_ported():
    """The ``/metrics`` scrape is ported now (the test keeps its name):
    ``metrics=True`` runs the episode with host0's lag gauges scraped
    during the partition."""
    report = chaos.run_fleet_chaos(0, hosts=3, metrics=True)
    assert report.converged and report.divergence_incidents == 0
    assert max(report.observed_lag.values()) > 0


def test_divergence_injection_equals_the_reference(tmp_path):
    port = chaos.run_divergence_injection(2, dump_dir=tmp_path / "port")
    ref = ref_chaos.run_divergence_injection(2, dump_dir=tmp_path / "ref")
    names = ("seed", "outcome_ok", "local_digest", "peer_digest", "counter_incremented",
             "incident_kinds", "incident_resolved", "incident_detection_rounds")
    assert _fields(port, names) == _fields(ref, names)
    assert port["dump"] and port["incident_kinds"] == ["divergence"]


def test_reconnect_storm_smoke():
    report = chaos.run_reconnect_storm(1, backlog_ops=500, num_docs=4, ops_per_doc=30,
                                       serve_rate_per_s=100.0, storm_duration_s=0.5,
                                       device="cpu")
    assert report.converged and report.backlog_ops == 500
    assert report.offered == report.admitted + report.delayed + report.shed
    assert report.served_rounds > 0
    if report.shed == 0 and report.delayed == 0:
        assert report.serve_digest_ok


def _feed(m, host):
    m.observe_leases({"leases": {host: {"verdict": "dead", "missed": 3}}})
    m.advance_round()


@pytest.mark.parametrize("dialer", ("port", "reference"))
def test_replica_servers_exchange_incident_summaries(dialer):
    """A port and a reference ``ReplicaServer``, each with its own
    monitor: after one exchange, each side has recorded the other's wire
    summary under the other's address, and the two views agree exactly
    when the monitors saw the same signals."""
    port_mon, ref_mon = IncidentMonitor(host="fe"), RefMonitor(host="fe")
    port = mh.ReplicaServer(ChangeStore(), host="127.0.0.1", port=0, timeout=TIMEOUT,
                            incidents=port_mon)
    ref = ref_mh.ReplicaServer(RefStore(), host="127.0.0.1", port=0, timeout=TIMEOUT,
                               incidents=ref_mon)
    try:
        port_addr, ref_addr = port.start(), ref.start()
        port_name, ref_name = (f"{a[0]}:{a[1]}" for a in (port_addr, ref_addr))
        for round_ in range(2):
            if round_ == 0:  # only the port's monitor saw a signal: the views differ
                _feed(port_mon, "h1")
            else:  # now both saw the same signals: the views agree
                _feed(ref_mon, "h1")
            if dialer == "port":
                outcome = port.try_sync_with(*ref_addr, retry=mh.RetryPolicy(
                    attempts=1, timeout=TIMEOUT))
            else:
                outcome = ref.try_sync_with(*port_addr, retry=ref_mh.RetryPolicy(
                    attempts=1, timeout=TIMEOUT))
            assert outcome.ok
            # the serving side records the dialer's summary on its handler
            # thread, after the client's last message
            _wait_for(lambda: port_mon.peer_views.get(ref_name) ==
                      port_mon.parse_wire_summary(ref_mon.wire_summary()) and
                      ref_mon.peer_views.get(port_name) ==
                      ref_mon.parse_wire_summary(port_mon.wire_summary()))
            agree = port_mon.snapshot()["peers"][ref_name]["agree"]
            assert agree == ref_mon.snapshot()["peers"][port_name]["agree"] == (round_ == 1)
    finally:
        port.stop()
        ref.stop()


def test_module_level_sync_carries_the_summary():
    ref_mon, port_mon = RefMonitor(host="a"), IncidentMonitor(host="b")
    _feed(ref_mon, "x")
    ref = ref_mh.ReplicaServer(RefStore(), host="127.0.0.1", port=0, timeout=TIMEOUT,
                               incidents=ref_mon)
    try:
        host, port = ref.start()
        assert mh.sync_with(ChangeStore(), host, port, timeout=TIMEOUT,
                            incidents=port_mon, peer_name="ref") == (0, 0)
    finally:
        ref.stop()
    assert port_mon.peer_views == {"ref": ref_mon.parse_wire_summary(ref_mon.wire_summary())}
