"""The port's incident plane against the reference's.

The reference's own incident tests (``tests/test_incidents.py``: the
Lifecycle, Correlation, Determinism, Feeds, MergeFlightDumps and
Primitives classes) run here on both packages: every scripted signal
sequence drives a port ``IncidentMonitor`` and a reference one, which must
give the same ``incidents_json()`` bytes, ``digest()``, ``wire_summary()``
and ``json.dumps(snapshot())``, and then pass the reference test's own
assertions.  Flight dumps are merged across packages both ways, the
incident summary crosses the frontier sentinel both ways, and the
counters' JSON (the float repair) is held byte for byte.  The Surfaces and
CLI classes wait for the port's exporters and CLI.
"""

import json

import pytest

from peritext_tpu.obs import Counters as RefCounters
from peritext_tpu.obs import FlightRecorder as RefRecorder
from peritext_tpu.obs import HistogramRegistry as RefRegistry
from peritext_tpu.obs import IncidentMonitor as RefMonitor
from peritext_tpu.obs import health_snapshot as ref_health_snapshot
from peritext_tpu.obs import merge_flight_dumps as ref_merge
from peritext_tpu.obs.incidents import TAXONOMY as REF_TAXONOMY
from peritext_tpu.obs.incidents import Incident as RefIncident
from peritext_tpu.parallel import multihost as ref_multihost
from peritext_tpu_torch.obs import (
    TAXONOMY,
    Counters,
    FlightRecorder,
    HistogramRegistry,
    Incident,
    IncidentMonitor,
    health_snapshot,
    merge_flight_dumps,
)
from peritext_tpu_torch.parallel import multihost

PAIR = (IncidentMonitor, RefMonitor)


def _views(m):
    return (m.incidents_json(), m.digest(), m.wire_summary(),
            json.dumps(m.snapshot(), sort_keys=False))


def both(script, **kw):
    """Run ``script(monitor)`` on a port and a reference monitor built with
    ``kw``; both must give the same views.  Returns the port's monitor and
    ``script``'s result on it."""
    out = []
    for cls in PAIR:
        m = cls(**kw)
        out.append((m, script(m)))
    (port, result), (ref, _) = out
    assert _views(port) == _views(ref)
    return port, result


def _feed(m, quiet: int = 3) -> None:
    m.observe_leases({"leases": {"h1": {"verdict": "dead", "missed": 3}}})
    m.observe_serve({"host": "h0", "recent_sheds": 7, "overloaded": True})
    m.advance_round()
    m.observe_latency({"slo": {"burn_rate": 2.5, "breaches": 4}})
    m.advance_round()
    m.observe_sentinel({"total": 9})
    m.observe_supervisor({"rollbacks": 2, "quarantined": {"3": {}}})
    m.advance_round()
    for _ in range(quiet):
        m.advance_round()


def test_taxonomy_is_the_references():
    assert TAXONOMY == REF_TAXONOMY


class TestLifecycle:
    def test_open_resolve_and_time_to_detection(self):
        def script(m):
            fault_round = m.rounds
            m.raise_signal("shed-storm", host="h0", value=4)
            opened = m.advance_round()
            assert [i.kind for i in opened] == ["shed-storm"]
            assert m.open_incidents()[0].status == "open"
            m.advance_round()
            assert m.open_incidents(), "one quiet round must not resolve yet"
            m.advance_round()
            assert not m.open_incidents()
            return fault_round

        m, fault_round = both(script, host="h", open_after=1, clear_after=2)
        assert m.time_to_detection("shed-storm", fault_round) == 1
        assert m.incident_kinds() == ["shed-storm"]

    def test_open_after_high_watermark(self):
        def streak(m):
            for _ in range(2):
                m.raise_signal("slo-burn", value=2.0)
                assert m.advance_round() == []
            m.raise_signal("slo-burn", value=2.0)
            return [i.kind for i in m.advance_round()]

        assert both(streak, host="h", open_after=3, clear_after=2)[1] == ["slo-burn"]

        def gap(m):
            m.raise_signal("slo-burn", value=2.0)
            m.advance_round()
            m.advance_round()
            m.raise_signal("slo-burn", value=2.0)
            return m.advance_round()

        assert both(gap, host="h", open_after=2, clear_after=1)[1] == []

    def test_flap_suppression_re_arms_open_incident(self):
        def script(m):
            for _ in range(2):
                m.raise_signal("shed-storm", host="h0")
                m.advance_round()
            assert len(m.open_incidents()) == 1
            for _ in range(6):
                m.raise_signal("shed-storm", host="h0")
                m.advance_round()
                m.advance_round()
            assert len(m.incidents()) == 1, "flapping minted a second incident"
            assert len(m.open_incidents()) == 1
            m.advance_round()
            m.advance_round()

        m, _ = both(script, host="h", open_after=2, clear_after=2)
        assert not m.open_incidents(), "true quiet must still resolve"

    def test_ack_is_open_only_and_resolve_is_terminal(self):
        def script(m):
            m.raise_signal("divergence", host="p")
            inc = m.advance_round()[0]
            inc.ack(m.rounds)
            assert inc.status == "ack"
            m.advance_round()
            assert inc.status == "resolved"
            inc.ack(m.rounds)
            return inc

        assert both(script, host="h", clear_after=1)[1].status == "resolved"

    def test_monitor_ack_by_id(self):
        def script(m):
            _feed(m, quiet=0)
            ident = m.open_incidents()[0].id
            return m.ack(ident), m.ack("INC-9999"), m.ack(ident)

        assert both(script, host="h")[1] == (True, False, False)

    @pytest.mark.parametrize("cls", PAIR, ids=("port", "reference"))
    def test_unknown_kind_and_bad_watermarks_rejected(self, cls):
        with pytest.raises(ValueError):
            cls().raise_signal("made-up-kind")
        with pytest.raises(ValueError):
            cls(open_after=0)
        with pytest.raises(ValueError):
            cls(clear_after=0)


class TestCorrelation:
    def test_shared_host_window_collapses_to_one_incident(self):
        def script(m):
            m.raise_signal("shed-storm", host="h0", doc="d1", value=5)
            m.advance_round()
            m.raise_signal("slo-burn", host="h0", value=9)
            m.advance_round()

        m, _ = both(script, host="h", clear_after=8, correlation_window=4)
        assert len(m.incidents()) == 1
        inc = m.incidents()[0]
        assert inc.kind == "slo-burn"
        assert [c.kind for c in inc.candidates()] == ["slo-burn", "shed-storm"]

    def test_tie_breaks_to_earliest_taxonomy_entry(self):
        def script(m):
            m.raise_signal("slo-burn", host="h0", value=5)
            m.raise_signal("shed-storm", host="h0", value=5)
            m.advance_round()

        m, _ = both(script, host="h", clear_after=8)
        assert m.incidents()[0].kind == "shed-storm"

    def test_outside_window_opens_a_fresh_incident(self):
        def script(m):
            m.raise_signal("shed-storm", host="h0")
            m.advance_round()
            for _ in range(4):
                m.advance_round()
            m.raise_signal("slo-burn", host="h0")
            m.advance_round()

        m, _ = both(script, host="h", clear_after=1, correlation_window=2)
        assert len(m.incidents()) == 2

    def test_disjoint_hosts_do_not_correlate(self):
        def script(m):
            m.raise_signal("shed-storm", host="h0")
            m.advance_round()
            m.raise_signal("slo-burn", host="h1")
            m.advance_round()

        m, _ = both(script, host="h", clear_after=8)
        assert len(m.incidents()) == 2

    def test_shared_trace_correlates_across_hosts(self):
        def script(m):
            m.raise_signal("shed-storm", host="h0", trace="t1")
            m.advance_round()
            m.raise_signal("slo-burn", host="h1", trace="t1")
            m.advance_round()

        m, _ = both(script, host="h", clear_after=8)
        assert len(m.incidents()) == 1 and m.incidents()[0].hosts == ["h0", "h1"]

    def test_shared_doc_correlates_and_details_merge(self):
        def script(m):
            m.raise_signal("quarantine-storm", host="h0", doc="d7", value=2, a=1)
            m.raise_signal("quarantine-storm", host="h0", doc="d7", value=1, b=2)
            m.advance_round()
            m.raise_signal("migration-failure", host="h3", doc="d7", value=0.1234567891)
            m.advance_round()

        m, _ = both(script, host="h", clear_after=8)
        assert len(m.incidents()) == 1 and m.incidents()[0].docs == ["d7"]


class TestDeterminism:
    def test_two_monitors_byte_identical(self):
        m, _ = both(_feed, host="h")
        assert len(m.incidents()) >= 2

    def test_seeded_signal_scripts_agree(self):
        import random

        for seed in range(6):
            rng = random.Random(seed)
            steps = []
            for _ in range(40):
                for _ in range(rng.randrange(3)):
                    steps.append((rng.choice(TAXONOMY), f"h{rng.randrange(4)}",
                                  rng.choice((None, "d0", "d1")),
                                  rng.choice((None, 1, 2)), rng.random() * 10))
                steps.append(None)

            def script(m):
                for step in steps:
                    if step is None:
                        m.advance_round()
                    else:
                        kind, host, doc, trace, value = step
                        m.raise_signal(kind, host=host, doc=doc, trace=trace, value=value,
                                       n=round(value))

            both(script, host="h", open_after=1 + seed % 2, clear_after=1 + seed % 3,
                 correlation_window=2 + seed)

    def test_ack_is_local_and_digest_normalizes_it(self):
        a, b = IncidentMonitor(host="h"), RefMonitor(host="h")
        _feed(a, quiet=0)
        _feed(b, quiet=0)
        assert a.open_incidents()
        a.open_incidents()[0].ack(a.rounds)
        assert a.digest() == b.digest(), "an operator ack must not fork views"
        assert a.incidents_json() != b.incidents_json()

    def test_wire_summary_roundtrip_and_peer_agreement(self):
        a, b = IncidentMonitor(host="h"), RefMonitor(host="h")
        _feed(a)
        _feed(b)
        for parse in (a.parse_wire_summary, b.parse_wire_summary):
            parsed = parse(a.wire_summary())
            assert parsed == {"open": len(a.open_incidents()), "digest": a.digest()}
        b.observe_peer_summary("a", a.wire_summary())
        a.observe_peer_summary("b", b.wire_summary())
        assert b.snapshot()["peers"]["a"]["agree"] is True
        assert a.snapshot()["peers"]["b"]["agree"] is True
        a.observe_peer_summary("other", 1 << 32)
        assert a.snapshot()["peers"]["other"] == {"open": 1, "digest": 0, "agree": False}

    def test_summary_rides_the_frontier_nul_sentinel_both_ways(self):
        m = IncidentMonitor(host="h")
        _feed(m)
        for make, parse in ((multihost._frontier_meta, ref_multihost._parse_frontier),
                            (ref_multihost._frontier_meta, multihost._parse_frontier)):
            meta = make(None, None, incidents=m.wire_summary())
            body = json.dumps({"actor": 3, **meta}).encode("utf-8")
            clock, parsed = parse(body)
            assert clock == {"actor": 3}, "sentinels must never pollute the clock"
            assert parsed["incidents"] == m.wire_summary()
        assert multihost._frontier_meta(None, None, digest=5, port=7, incidents=9) == \
            ref_multihost._frontier_meta(None, None, digest=5, port=7, incidents=9)


class TestFeeds:
    def test_fleet_feed_resolves_post_heal_not_post_reset(self):
        dead = {"leases": {"leases": {"h1": {"verdict": "dead", "missed": 2}}},
                "serving": {"d0": "h1"}, "failed_docs": []}
        healed = {"leases": {"leases": {"h1": {"verdict": "dead", "missed": 2}}},
                  "serving": {"d0": "h2"}, "failed_docs": []}

        def script(m):
            m.observe_fleet(dead)
            m.advance_round()
            assert [i.kind for i in m.open_incidents()] == ["host-death"]
            for _ in range(3):
                m.observe_fleet(healed)
                m.advance_round()

        m, _ = both(script, host="h", clear_after=2)
        assert not m.open_incidents()

    def test_fleet_feed_migration_failure(self):
        def script(m):
            m.observe_fleet({"leases": {"leases": {}}, "serving": {}, "failed_docs": ["d2"],
                             "migration_rollbacks": 2})
            m.advance_round()

        m, _ = both(script, host="h", clear_after=1)
        assert m.incident_kinds() == ["migration-failure"]

    def test_fleet_feed_over_the_ports_frontend(self):
        """The port's ``FleetFrontend.snapshot()`` keeps every key
        ``observe_fleet`` reads: a killed host's lease, its stranded docs
        and their failover drive both packages' monitors alike."""
        from peritext_tpu_torch.parallel.streaming import StreamingMerge
        from peritext_tpu_torch.serve import FleetFrontend, SessionMux

        fe = FleetFrontend(lease_rounds=2, checkpoint_every=2)
        for i in range(3):
            fe.add_host(f"host{i}", SessionMux(StreamingMerge(
                num_docs=4, actors=("doc1", "doc2", "doc3"), device="cpu")))
        for d in range(6):
            assert fe.open_doc(f"doc{d}", f"c{d}").admitted
        snaps = []
        try:
            victim = sorted(set(fe._serving.values()))[0]
            fe.round()
            snaps.append(fe.snapshot())
            fe.hosts[victim].kill()
            for _ in range(8):
                fe.round()
                snaps.append(fe.snapshot())
        finally:
            fe.stop()
        assert {"leases", "serving", "failed_docs", "migration_rollbacks"} <= set(snaps[0])
        assert snaps[-1]["leases"]["leases"][victim]["verdict"] == "dead"

        def script(m):
            for snap in snaps:
                m.observe_fleet(json.loads(json.dumps(snap)))
                m.advance_round()
            return m.incident_kinds()

        m, kinds = both(script, host="frontend", clear_after=2)
        assert kinds == ["host-death"] and not m.open_incidents()

    def test_sentinel_feed_needs_a_storm_not_a_build(self):
        class Sentinel:
            total = 0

        sentinel = Sentinel()

        def script(m):
            sentinel.total = 2
            m.observe_sentinel(sentinel)
            assert m.advance_round() == []
            m.observe_sentinel({"total": 7})
            return [i.kind for i in m.advance_round()]

        assert both(script, host="h", compile_storm_threshold=3)[1] == ["recompile-storm"]

    def test_convergence_feed_is_delta_triggered(self):
        snap = {"divergence_incidents": 1, "divergent_peers": ["p1"]}

        def script(m):
            m.observe_convergence(snap)
            m.advance_round()
            assert m.incident_kinds() == ["divergence"]
            for _ in range(2):
                m.observe_convergence(snap)
                m.advance_round()

        m, _ = both(script, host="h", clear_after=1)
        assert not m.open_incidents()

    def test_perf_feed_magnitude_is_worst_regression(self):
        def script(m):
            m.observe_perf({"regressed": True, "rows": [
                {"name": "a", "status": "regressed", "delta_pct": -4.0},
                {"name": "b", "status": "regressed", "delta_pct": 11.5},
                {"name": "c", "status": "ok", "delta_pct": 0.1},
            ]})
            return m.advance_round()[0]

        inc = both(script, host="h")[1]
        assert inc.kind == "perf-regression" and inc.candidates()[0].value == 11.5

    def test_supervisor_serve_latency_and_timeseries_feeds(self):
        class Health:
            def health(self):
                return {"rollbacks": 1, "quarantined": {2: {}, 5: {}}}

        class Snap:
            def snapshot(self):
                return {"host": "h9", "anomaly": {"active": [
                    {"kind": "shed-storm", "key": "serve.depth", "z": 7.5, "round": 4},
                    {"kind": "made-up", "key": "x.y", "z": 0, "round": 0}]}}

        def script(m):
            m.observe_supervisor(Health())
            m.observe_serve({"recent_sheds": 0, "overloaded": True})
            m.observe_latency({"slo": {"burn_rate": 0.5}})
            m.observe_timeseries(Snap())
            m.advance_round()
            with pytest.raises(TypeError):
                m.observe_serve(object())
            with pytest.raises(TypeError):
                m.observe_supervisor(object())

        m, _ = both(script, host="h")
        assert m.incident_kinds()

    def test_arming_builds_and_launches_nothing(self, monkeypatch):
        """Arming and feeding the monitor builds no kernel, loads none and
        launches none, and moves no counter."""
        from peritext_tpu_torch.obs import GLOBAL_COUNTERS
        from peritext_tpu_torch.ops.insert import insert_batch
        from peritext_tpu_torch.ops.ragged_insert import ragged_insert
        from peritext_tpu_torch.utils import nvcc

        def refuse(*args, **kwargs):
            raise AssertionError("the incident plane reached the kernel build path")

        monkeypatch.setattr(nvcc, "build_libraries", refuse)
        monkeypatch.setattr(nvcc, "load_library", refuse)
        before = (insert_batch.launches, ragged_insert.launches, GLOBAL_COUNTERS.snapshot())
        m = IncidentMonitor(host="h")
        _feed(m)
        m.snapshot()
        m.incidents_json()
        assert (insert_batch.launches, ragged_insert.launches,
                GLOBAL_COUNTERS.snapshot()) == before

    def test_opened_counter(self):
        counters, ref_counters = Counters(), RefCounters()
        for m in (IncidentMonitor(host="h", counters=counters),
                  RefMonitor(host="h", counters=ref_counters)):
            _feed(m)
        assert json.dumps(counters.snapshot()) == json.dumps(ref_counters.snapshot())
        assert counters.get("incident.opened") >= 1


class TestCountersJson:
    def test_counters_serialize_as_the_references(self):
        port, ref = Counters(), RefCounters()
        for c in (port, ref):
            c.add("streaming.block_applies")
            c.add("serve.admitted", 3)
            c.add("supervisor.rollbacks", 0.5)
        assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot()) == \
            '{"streaming.block_applies": 1.0, "serve.admitted": 3.0, "supervisor.rollbacks": 0.5}'
        assert port.get("missing") == ref.get("missing") == 0.0

    def test_health_snapshot_bytes_with_incidents(self):
        out = []
        for counters_cls, registry_cls, monitor_cls, snapshot in (
                (Counters, HistogramRegistry, IncidentMonitor, health_snapshot),
                (RefCounters, RefRegistry, RefMonitor, ref_health_snapshot)):
            counters = counters_cls()
            for name, value in (("streaming.rounds", 2), ("incident.opened", 1),
                                ("serve.shed", 4), ("private.x", 9)):
                counters.add(name, value)
            m = monitor_cls(host="h")
            _feed(m)
            out.append(json.dumps(snapshot(counters=counters, histograms=registry_cls(),
                                           incidents=m)))
        assert out[0] == out[1]
        assert json.loads(out[0])["incidents"]["total"] >= 1


class TestMergeFlightDumps:
    @staticmethod
    def _dump(cls, directory, host, records, reason="boom"):
        rec = cls(dump_dir=directory, host=host, min_dump_interval=0.0)
        for kind, fields in records:
            rec.record(kind, **fields)
        return rec.dump(reason=reason)

    @pytest.mark.parametrize("writer", ("port", "reference"))
    def test_cross_package_merge(self, tmp_path, writer):
        cls = FlightRecorder if writer == "port" else RefRecorder
        self._dump(cls, tmp_path, "hostA", [("span", {"name": "commit", "trace_id": "t9"})])
        self._dump(cls, tmp_path, "hostB", [("fault", {"reason": "rollback", "trace_id": "t9"})])
        rec = cls(dump_dir=tmp_path, host="hostC", min_dump_interval=0.0)
        rec.record("span", name="a")
        rec.dump(reason="first")
        rec.record("span", name="b")
        rec.dump(reason="second")
        files = sorted(tmp_path.glob("flight-*.jsonl"))
        merged = merge_flight_dumps(files)
        assert merged == ref_merge(files)
        assert merged["hosts"] == ["hostA", "hostB", "hostC"]
        assert merged["records"] == 4, "ring overlap must dedup, not double"
        assert {r["host"] for r in merged["traces"]["t9"]} == {"hostA", "hostB"}

    def test_legacy_hostless_filenames_still_merge(self, tmp_path):
        path = tmp_path / "flight-123-000001-crash.jsonl"
        path.write_text(json.dumps({"kind": "dump", "reason": "crash", "records": 1}) + "\n"
                        + json.dumps({"seq": 1, "ts": 1.0, "kind": "fault"}) + "\n")
        merged = merge_flight_dumps([path])
        assert merged == ref_merge([path])
        assert merged["hosts"] == ["?"] and merged["records"] == 1

    def test_unreadable_lines_and_files_counted_not_fatal(self, tmp_path):
        path = tmp_path / "flight-hostA-1-000001-x.jsonl"
        path.write_text("not json\n[1]\n" + json.dumps({"seq": 1, "ts": 1.0, "kind": "span"}) + "\n")
        missing = tmp_path / "flight-hostB-1-000001-gone.jsonl"
        merged = merge_flight_dumps([path, missing])
        assert merged == ref_merge([path, missing])
        assert merged["skipped"] == 3 and merged["records"] == 1

    def test_incident_open_triggers_dump(self, tmp_path):
        rec = FlightRecorder(dump_dir=tmp_path, host="h0", min_dump_interval=0.0)
        m = IncidentMonitor(host="h0", recorder=rec)
        m.raise_signal("shed-storm", host="h0", value=2)
        m.advance_round()
        dumps = list(tmp_path.glob("flight-h0-*-incident-shed-storm.jsonl"))
        assert dumps, "an incident open must dump the black box"
        m.raise_signal("shed-storm", host="h0", value=2)
        m.advance_round()
        assert len(list(tmp_path.glob("flight-*.jsonl"))) == len(dumps)
        merged = ref_merge(dumps)
        assert merged["dumps"][0]["reason"] == "incident-shed-storm"
        assert merged == merge_flight_dumps(dumps)

    def test_failed_dump_keeps_the_incident(self):
        class Broken:
            def fault(self, *args, **kwargs):
                raise OSError("disk full")

        m = IncidentMonitor(host="h0", recorder=Broken())
        m.raise_signal("shed-storm", host="h0")
        assert [i.kind for i in m.advance_round()] == ["shed-storm"]


class TestIncidentPrimitives:
    def test_candidate_ordering_rest_sorted_by_magnitude(self):
        kinds = []
        for cls in (Incident, RefIncident):
            inc = cls("INC-0001", 1)
            inc.attach("slo-burn", "h0", None, None, 3.0, {}, 1)
            inc.attach("shed-storm", "h0", None, None, 9.0, {}, 1)
            inc.attach("recompile-storm", "h1", None, None, 5.0, {}, 2)
            kinds.append([c.kind for c in inc.candidates()])
        assert kinds[0] == kinds[1] == ["shed-storm", "recompile-storm", "slo-burn"]

    def test_to_json_is_stable_and_the_references(self):
        rows = []
        for cls in (Incident, RefIncident):
            inc = cls("INC-0001", 1)
            inc.attach("divergence", "p", "d", "t", 2.0000001234, {"x": 1}, 1)
            assert json.loads(json.dumps(inc.to_json())) == inc.to_json()
            rows.append(json.dumps(inc.to_json(), sort_keys=True))
        assert rows[0] == rows[1]
        assert Incident("INC-0002", 3).kind == "unknown"
