"""The port's exporters (``peritext_tpu_torch/obs/exporters.py``) and the
metrics mounts they unblock, against the reference package's, on the CPU.

* ``prometheus_text``: each package's planes fed the same inputs render
  the same exposition, line for line, except ``peritext_build_info``
  (whose ``jax=`` label is ``torch=`` and ``cuda=`` here, and whose
  ``device=`` label is the port's fingerprint: ROADMAP.md section 3).
* The reference's ``TestSurfaceMountAudit`` and ``TestTypedErrorBodies``
  (tests/test_obs_surface.py) and ``TestSurfaces`` (tests/test_incidents.py)
  held against the port's ``MetricsServer``.
* ``ReplicaServer(metrics_port=0, serve=mux)`` and ``(fleet=fe)``, as the
  reference's tests/test_serve.py and tests/test_fleet.py mount them, and
  ``/devprof.json`` from the mounted process profiler.
* ``run_fleet_chaos(metrics=True)``: the ``/metrics`` lag scrape during
  the partition, on both packages.
"""

import json
import random
import urllib.error
import urllib.request

import pytest

from peritext_tpu.obs import ConvergenceMonitor as JaxConvergence
from peritext_tpu.obs import Counters as JaxCounters
from peritext_tpu.obs import DeviceProfiler as JaxProfiler
from peritext_tpu.obs import HistogramRegistry as JaxRegistry
from peritext_tpu.obs import IncidentMonitor as JaxIncidents
from peritext_tpu.obs import LatencyPlane as JaxLatency
from peritext_tpu.obs import TimeSeriesPlane as JaxHistory
from peritext_tpu.obs import prometheus_text as jax_prometheus_text
from peritext_tpu.obs.__main__ import _STATUS_PLANES
from peritext_tpu.testing import chaos as ref_chaos
from peritext_tpu_torch.obs import (
    TAXONOMY,
    ConvergenceMonitor,
    Counters,
    DeviceProfiler,
    GLOBAL_DEVPROF,
    HistogramRegistry,
    IncidentMonitor,
    LatencyPlane,
    MetricsServer,
    TimeSeriesPlane,
    health_snapshot,
    prometheus_text,
)
from peritext_tpu_torch.obs.exporters import build_info
from peritext_tpu_torch.obs.ledger import device_fingerprint, git_sha
from peritext_tpu_torch.parallel.anti_entropy import ChangeStore
from peritext_tpu_torch.parallel.codec import WIRE_CAPS, encode_frame
from peritext_tpu_torch.parallel.multihost import ReplicaServer
from peritext_tpu_torch.serve import AdmissionController, FleetFrontend, SessionMux
from peritext_tpu_torch.testing import chaos
from peritext_tpu_torch.testing.fuzz import generate_workload

TIMEOUT = 5


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as resp:
        return resp.read()


# ---------------------------------------------------------------------------
# prometheus_text, line for line
# ---------------------------------------------------------------------------


def _counters(cls):
    c = cls()
    rng = random.Random(3)
    for name in ("streaming.rounds", "serve.admitted", "merge.device_ops", "a.b-c"):
        for _ in range(5):
            c.add(name, rng.choice((1, 2.5, 0.125, 1e-7, 3.0)))
    return c


def _histograms(cls):
    reg = cls()
    rng = random.Random(4)
    for _ in range(200):
        reg.observe("streaming.round_seconds", rng.random() * rng.choice((1e-4, 0.1, 30.0)))
        reg.observe("serve.batch", rng.randrange(1, 500), buckets=(1, 8, 64, 512))
    return reg


def _devprof(cls):
    p = cls().enable()
    p.observe_round("D8.ki16.kd8.km8.kp8", real_ops=60, padded_capacity=320)
    p.observe_round("D4.ki8.kd8.km8.kp8", real_ops=17, padded_capacity=96,
                    origin="streaming.paged")
    p.observe_page_pool({"pool_pages": 64, "pages_in_use": 40, "pool_utilization": 0.625,
                         "growths": 1, "docs_resident": 9, "internal_frag_slots": 310,
                         "internal_frag_ratio": 0.1211, "page_size": 64,
                         "frag_by_decile": {"0": 0.5, "9": 0.01}})
    p.observe_ragged(docs_walked=9, pages_walked=40, real_ops=77)
    p.observe_mesh({"shards": 2, "rows_per_shard": 8, "imbalance_ratio": 1.25,
                    "ici_page_moves": 3, "shard_load": [5, 4],
                    "shard_utilization": [0.5, 0.4]})
    p.sample_memory()
    return p


class _Snap:
    """A plane stand-in that answers one fixed snapshot."""

    def __init__(self, body):
        self._body = body

    def snapshot(self):
        return json.loads(json.dumps(self._body))


def _bucket(cost):
    return {"dispatches": 3, "sig": "s", "cost": cost,
            "memory": {"argument_size_in_bytes": 10, "output_size_in_bytes": 6,
                       "peak_bytes": 16}}


def _costed_snapshots():
    """The same launch site as each package describes its cost: the
    port's ``kernel_bytes`` where the reference has ``bytes_accessed``."""
    base = _devprof(DeviceProfiler).snapshot()
    port, ref = json.loads(json.dumps(base)), json.loads(json.dumps(base))
    port["sites"] = {"apply_batch_compact": {"distinct_shapes": 1, "dispatches": 3, "buckets": {
        "k": _bucket({"device_ms": 0.5, "kernel_bytes": 4096, "kernel_launches": 1})}}}
    ref["sites"] = {"apply_batch_compact": {"distinct_shapes": 1, "dispatches": 3, "buckets": {
        "k": _bucket({"flops": 0.0, "bytes_accessed": 4096.0})}}}
    return _Snap(port), _Snap(ref)


def _convergence(cls):
    m = cls(host="h0")
    m.observe_frontier("p1", {"a": 5, "b": 2}, {"a": 9, "b": 2})
    m.observe_frontier('p"2\n', {"a": 5}, {"a": 5}, local_digest=1, peer_digest=2)
    m.observe_failure("p1", "timeout")
    return m


def _latency(cls):
    plane = cls(slo_seconds=0.05).enable()
    t = 100.0
    for i in range(40):
        plane.observe_batch(submit=t, admit=t + 0.001 * (i % 3), close=t + 0.01,
                            staged=t + 0.012, commit=t + 0.02 + 0.001 * i,
                            marks={"schedule_seconds": 0.002, "apply_seconds": 0.003,
                                   "rounds": 1},
                            cause=("window", "flush", "backpressure")[i % 3])
        t += 0.05
    return plane


def _incidents(cls):
    m = cls(host="h")
    m.observe_leases({"leases": {"h1": {"verdict": "dead", "missed": 3}}})
    m.observe_serve({"host": "h0", "recent_sheds": 7, "overloaded": True})
    m.advance_round()
    m.observe_latency({"slo": {"burn_rate": 2.5, "breaches": 4}})
    m.advance_round()
    m.observe_sentinel({"total": 9})
    m.advance_round()
    m.observe_peer_summary("peer-1", m.wire_summary())
    return m


def _history(cls):
    plane = cls(min_frames=4).enable()
    for i in range(12):
        plane.sample(serve={"shed": float(i % 3), "depth": float(i)},
                     latency={"p99": 0.01 * (i % 4)})
    return plane


_SERVE = {
    "host": "audit", "sessions": 1, "docs": 1, "doc_capacity": 4, "degraded_docs": 0,
    "rounds": 3, "applied_frames": 3, "buffered_frames": 0, "overloaded": False,
    "queue": {"depth": 0, "peak": 2, "max_depth": 64, "backpressure": False,
              "verdicts": {"submitted": 3, "admitted": 3, "delayed": 0, "shed": 1,
                           "shed_reasons": {"quota": 1}}},
    "window": {"seconds": 0.01, "p99_round_seconds": 0.001, "floor": 0.005, "ceiling": 0.1},
    "fusion": {"grouped": True, "tenants": 4, "lanes": 2, "windows": 7, "dispatches": 9,
               "docs_per_dispatch": 3.5, "window_occupancy": 0.75},
}
_FLEET = {
    "rounds": 2, "hosts": {"h0": {}, "h1": {}},
    "leases": {"leases": {"h0": {"verdict": "live"}, "h1": {"verdict": "dead"}}},
    "router": {"docs": 2}, "serving": {"d0": "h0"}, "moving": {}, "failed_docs": [],
    "failovers": 1, "failover_docs": 2, "migrations": 3, "migration_rollbacks": 0,
    "checkpoint_ships": 4, "journal_frames": 11, "checkpoint_docs": 2,
    "verdicts": {"submitted": 5, "admitted": 4, "delayed": 0, "shed": 1,
                 "shed_reasons": {"host-dead": 1}},
    "auth": {"keys": 0, "rejected": 0},
}
_PLAN = {"modeled": {"current_score": 10.5, "proposed_score": 8.0, "savings_frac": 0.238,
                     "utilization": 0.6},
         "proposal": {"fused_depth": 4, "slot_capacity": 512, "page_size": 64,
                      "window_seconds": 0.01}}


def _planes(kind):
    """``(port kwargs, reference kwargs)`` of ``prometheus_text`` for one
    plane kind, each built from its own package and fed the same."""
    if kind == "counters_histograms":
        return (dict(counters=_counters(Counters), histograms=_histograms(HistogramRegistry)),
                dict(counters=_counters(JaxCounters), histograms=_histograms(JaxRegistry)))
    empty = (dict(counters=Counters(), histograms=HistogramRegistry()),
             dict(counters=JaxCounters(), histograms=JaxRegistry()))
    port, ref = empty
    if kind == "devprof":
        port["devprof"], ref["devprof"] = _devprof(DeviceProfiler), _devprof(JaxProfiler)
    elif kind == "devprof_costed":
        port["devprof"], ref["devprof"] = _costed_snapshots()
    elif kind == "convergence":
        port["convergence"] = _convergence(ConvergenceMonitor)
        ref["convergence"] = _convergence(JaxConvergence)
    elif kind == "latency":
        port["latency"], ref["latency"] = _latency(LatencyPlane), _latency(JaxLatency)
    elif kind == "incidents":
        port["incidents"], ref["incidents"] = _incidents(IncidentMonitor), _incidents(JaxIncidents)
    elif kind == "history":
        port["history"], ref["history"] = _history(TimeSeriesPlane), _history(JaxHistory)
    elif kind == "serve_fleet_plan":
        for kw in (port, ref):
            kw.update(serve=_Snap(_SERVE), fleet=_Snap(_FLEET), plan=dict(_PLAN))
    elif kind == "sentinel":
        class _Sentinel:
            total = 7
        for kw in (port, ref):
            kw["sentinel"] = _Sentinel()
    return port, ref


PLANE_KINDS = ("counters_histograms", "devprof", "devprof_costed", "convergence", "latency",
               "incidents", "history", "serve_fleet_plan", "sentinel")


@pytest.mark.parametrize("kind", PLANE_KINDS)
def test_prometheus_text_equals_the_reference_but_build_info(kind):
    port_kw, ref_kw = _planes(kind)
    ours = prometheus_text(**port_kw).splitlines()
    ref = jax_prometheus_text(**ref_kw).splitlines()
    assert ours[0] == ref[0] == "# TYPE peritext_build_info gauge"
    assert ours[1].startswith("peritext_build_info{") and ref[1].startswith("peritext_build_info{")
    assert ours[2:] == ref[2:]
    assert len(ours) > 2
    for line in ours:
        assert line.startswith("#") or len(line.split()) == 2


def test_costed_bytes_gauge_reads_kernel_bytes():
    port, _ = _costed_snapshots()
    text = prometheus_text(counters=Counters(), histograms=HistogramRegistry(), devprof=port)
    assert 'peritext_device_bytes_accessed_total{site="apply_batch_compact"} 12288' in text
    assert 'peritext_device_flops_total{site="apply_batch_compact"} 0' in text
    assert 'peritext_device_peak_bytes{site="apply_batch_compact"} 16' in text


def test_build_info_labels_torch_cuda_and_the_fingerprint():
    """The deliberate deviation (ROADMAP.md section 3): the reference's
    ``jax=`` label is ``torch=`` and ``cuda=``; ``device=`` is spelled from
    the ledger's fingerprint."""
    import torch

    info = build_info()
    fp = device_fingerprint()
    assert info == {
        "sha": git_sha() or "unknown",
        "wire_caps": str(WIRE_CAPS),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device": f"{fp['platform']}-{fp['kind']}-{fp['cpus']}",
    }
    line = prometheus_text().splitlines()[1]
    assert line == (f'peritext_build_info{{sha="{info["sha"]}",wire_caps="{WIRE_CAPS}",'
                    f'torch="{info["torch"]}",cuda="{info["cuda"]}",'
                    f'device="{info["device"]}"}} 1')
    assert "jax=" not in line


# ---------------------------------------------------------------------------
# the surfaces (tests/test_obs_surface.py, tests/test_incidents.py)
# ---------------------------------------------------------------------------


def _all_planes_server(**overrides):
    kwargs = dict(tracer=object(), convergence=object(), devprof=object(), serve=object(),
                  fleet=object(), plan={}, latency=object(), incidents=object(),
                  history=object())
    kwargs.update(overrides)
    return MetricsServer(**kwargs)


class TestSurfaceMountAudit:
    def test_every_json_endpoint_has_a_status_row(self):
        """The port mounts exactly the JSON routes the reference's ``obs
        status`` roll-up knows."""
        server = _all_planes_server()
        try:
            routes = server._httpd._routes
            assert "/metrics" in routes
            stems = {path[1:-len(".json")] for path in routes if path.endswith(".json")}
        finally:
            server.stop()
        assert stems == {name for name, _ in _STATUS_PLANES}

    def test_every_json_endpoint_has_a_prometheus_family(self):
        history = TimeSeriesPlane(min_frames=4).enable()
        history.sample(serve={"shed": 1.0})
        text = prometheus_text(
            convergence=ConvergenceMonitor(host="audit"), devprof=DeviceProfiler(),
            serve=_Snap(_SERVE), fleet=_Snap(_FLEET), plan=dict(_PLAN),
            latency=LatencyPlane(), incidents=IncidentMonitor(host="audit"), history=history,
        )
        needles = {"health": "peritext_build_info{", "convergence": "peritext_convergence_",
                   "devprof": "peritext_device_", "serve": "peritext_serve_",
                   "fleet": "peritext_fleet_", "plan": "peritext_plan_",
                   "latency": "peritext_latency_", "incidents": "peritext_incident_",
                   "timeseries": "peritext_history_"}
        assert set(needles) == {name for name, _ in _STATUS_PLANES} - {"trace"}
        for plane, needle in sorted(needles.items()):
            assert needle in text, f"{plane}: no {needle} family emitted"


class _Boom:
    def __init__(self, msg):
        self._msg = msg

    def snapshot(self):
        raise RuntimeError(self._msg)

    def chrome_trace(self):
        raise RuntimeError(self._msg)


class TestTypedErrorBodies:
    def test_raising_planes_answer_typed_500_json(self):
        history = TimeSeriesPlane(min_frames=4).enable()
        history.sample(serve={"ok": 1.0})
        server = MetricsServer(convergence=_Boom("lag ledger corrupt"),
                               incidents=_Boom("monitor detached"),
                               devprof=_Boom("events lost"), tracer=_Boom("ring gone"),
                               history=history)
        host, port = server.start()
        base = f"http://{host}:{port}"
        try:
            for stem, msg in (("convergence", "lag ledger corrupt"),
                              ("incidents", "monitor detached"),
                              ("devprof", "events lost"), ("trace", "ring gone")):
                with pytest.raises(urllib.error.HTTPError) as err:
                    _get(f"{base}/{stem}.json")
                assert err.value.code == 500
                body = json.loads(err.value.read())
                assert body == {"error": msg, "plane": stem}
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(f"{base}/metrics")
            assert json.loads(err.value.read())["plane"] == "metrics"
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(f"{base}/nope.json")
            assert err.value.code == 404
            healthy = json.loads(_get(f"{base}/timeseries.json"))
            assert healthy["rounds"] == history.rounds
        finally:
            server.stop()

    def test_raising_history_plane_names_timeseries(self):
        server = MetricsServer(history=_Boom("ring poisoned"))
        host, port = server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(f"http://{host}:{port}/timeseries.json?key=x")
            assert err.value.code == 500
            assert json.loads(err.value.read()) == {"error": "ring poisoned",
                                                    "plane": "timeseries"}
        finally:
            server.stop()

    def test_timeseries_query_params_match_the_reference(self):
        ours, ref = _history(TimeSeriesPlane), _history(JaxHistory)
        server = MetricsServer(history=ours)
        host, port = server.start()
        try:
            from peritext_tpu.obs.timeseries import query_snapshot as jax_query

            for query, params in (("?key=serve.depth&window=4", {"key": "serve.depth",
                                                                  "window": "4"}),
                                  ("?key=serve.shed&rate=1&key=serve.depth",
                                   {"key": "serve.depth", "rate": "1"}), ("", {})):
                body = json.loads(_get(f"http://{host}:{port}/timeseries.json{query}"))
                assert body == json.loads(json.dumps(jax_query(ref.snapshot(), params),
                                                     default=str))
        finally:
            server.stop()

    def test_unstarted_server_stops_cleanly(self):
        MetricsServer().stop()


class TestSurfaces:
    def test_incidents_json_golden_shape(self):
        m = _incidents(IncidentMonitor)
        snap = m.snapshot()
        for key in ("host", "rounds", "open", "acked", "resolved", "total", "by_kind", "digest",
                    "open_after", "clear_after", "correlation_window", "peers", "incidents"):
            assert key in snap
        assert set(snap["by_kind"]) == set(TAXONOMY)
        json.dumps(snap)

    def test_prometheus_incident_gauges(self):
        text = prometheus_text(incidents=_incidents(IncidentMonitor))
        for gauge in ("open", "resolved", "total", "digest"):
            assert f"peritext_incident_{gauge} " in text
        for kind in TAXONOMY:
            assert f'peritext_incident_open_by_kind{{kind="{kind}"}}' in text

    def test_build_info_gauge_in_every_exposition(self):
        assert "peritext_build_info{" in prometheus_text()
        assert set(build_info()) == {"sha", "wire_caps", "torch", "cuda", "device"}

    def test_health_snapshot_carries_incidents(self):
        m = _incidents(IncidentMonitor)
        assert health_snapshot(incidents=m)["incidents"]["total"] == m.snapshot()["total"]

    def test_metrics_server_incidents_route(self):
        m = _incidents(IncidentMonitor)
        server = MetricsServer(incidents=m)
        host, port = server.start()
        try:
            body = json.loads(_get(f"http://{host}:{port}/incidents.json"))
            assert body["host"] == "h" and body["total"] >= 1
            text = _get(f"http://{host}:{port}/metrics").decode()
            assert "peritext_incident_open " in text and "peritext_build_info{" in text
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# ReplicaServer(metrics_port=, serve=, fleet=)
# ---------------------------------------------------------------------------


def _make_mux(num_docs=2, ops=40, host=None):
    kw = {} if host is None else {"host": host}
    return SessionMux(chaos._serve_session(num_docs, ops, device="cpu"),
                      admission=AdmissionController(max_depth=64, session_quota=None), **kw)


def test_replica_server_mounts_serve():
    mux = _make_mux(host="hX")
    mux.open_session("a")
    server = ReplicaServer(ChangeStore(), metrics_port=0, serve=mux)
    server.start()
    try:
        mh, mp = server.metrics_address
        body = json.loads(_get(f"http://{mh}:{mp}/serve.json"))
        assert body["host"] == "hX" and body == json.loads(json.dumps(mux.snapshot()))
        text = _get(f"http://{mh}:{mp}/metrics").decode()
        assert "peritext_serve_sessions 1" in text
        assert "peritext_convergence_peers 0" in text
    finally:
        server.stop()


def test_replica_server_mounts_fleet():
    fe = FleetFrontend(lease_rounds=2, checkpoint_every=2)
    for i in range(2):
        fe.add_host(f"h{i}", _make_mux(num_docs=8, ops=16), transport=False)
    plans = {}
    for d, w in enumerate(generate_workload(31, num_docs=2, ops_per_doc=16)):
        changes = [ch for log in sorted(w) for ch in w[log]]
        plans[f"doc{d}"] = [encode_frame(changes[i:i + 5]) for i in range(0, len(changes), 5)]
    for k in sorted(plans):
        assert fe.open_doc(k, f"client-{k}").admitted
    for k, frames in sorted(plans.items()):
        for f in frames:
            assert fe.submit(k, f).admitted
    fe.round()
    fe.flush()
    server = ReplicaServer(ChangeStore(), metrics_port=0, fleet=fe)
    server.start()
    try:
        mh, mp = server.metrics_address
        body = json.loads(_get(f"http://{mh}:{mp}/fleet.json"))
        assert body["router"]["docs"] == 2
        assert "peritext_fleet_hosts 2" in _get(f"http://{mh}:{mp}/metrics").decode()
    finally:
        server.stop()
        fe.stop()


def test_replica_server_mounts_the_process_profiler():
    """``/devprof.json`` answers while the profiler is off (``enabled:
    false``), and the port's planes appear the moment it is armed."""
    from peritext_tpu_torch.api.batch import DocBatch

    server = ReplicaServer(ChangeStore(), metrics_port=0)
    server.start()
    mh, mp = server.metrics_address
    try:
        assert json.loads(_get(f"http://{mh}:{mp}/devprof.json"))["enabled"] is False
        GLOBAL_DEVPROF.reset()
        GLOBAL_DEVPROF.enable()
        try:
            DocBatch(device="cpu", layout="ragged").merge(generate_workload(5, 4, 24))
            snap = json.loads(_get(f"http://{mh}:{mp}/devprof.json"))
            text = _get(f"http://{mh}:{mp}/metrics").decode()
            health = json.loads(_get(f"http://{mh}:{mp}/health.json"))
        finally:
            GLOBAL_DEVPROF.disable()
            GLOBAL_DEVPROF.reset()
        assert snap["enabled"] is True and snap["sites"]["apply_batch_ragged"]["dispatches"] == 1
        assert 'peritext_device_dispatches{site="apply_batch_ragged"} 1' in text
        assert "peritext_ragged_dispatches 1" in text
        assert {"counters", "histograms", "devprof", "convergence"} <= set(health)
    finally:
        server.stop()
    assert server.metrics._thread is None


def test_replica_server_metrics_port_in_use_releases_the_replica_socket():
    blocker = MetricsServer()
    host, port = blocker.address
    try:
        with pytest.raises(OSError):
            ReplicaServer(ChangeStore(), metrics_port=port)
    finally:
        blocker.stop()


# ---------------------------------------------------------------------------
# run_fleet_chaos(metrics=True)
# ---------------------------------------------------------------------------


def test_fleet_chaos_scrapes_metrics_like_the_reference():
    port = chaos.run_fleet_chaos(1, hosts=3, metrics=True)
    ref = ref_chaos.run_fleet_chaos(1, hosts=3, metrics=True)
    for r in (port, ref):
        assert r.converged and r.divergence_incidents == 0
    assert sorted(port.observed_lag.values()) == sorted(ref.observed_lag.values())
    assert (port.partition_rounds, port.final_digest) == (ref.partition_rounds, ref.final_digest)
