"""The port's host telemetry planes (``peritext_tpu_torch/obs/``) against
the reference package's, on the CPU.

Each plane of both packages is fed the same seeded inputs (and, where the
plane reads no clock, the same watermarks), and its readouts must be equal
exactly, keys and values: histogram snapshots and percentiles,
``LatencyPlane`` snapshots and decompositions, ``TimeSeriesPlane``
snapshots, persisted segments and their replay, flight-recorder dumps
(timestamps aside) and the ``health_snapshot`` composition.  Spans carry
random trace and span ids, so the tracer's spans are compared after
numbering them by order; nesting, sinks and ``ambient_parent`` across
threads are checked on that form.
"""

import json
import random
import threading

import pytest

from peritext_tpu.obs import FlightRecorder as JaxRecorder
from peritext_tpu.obs import Histogram as JaxHistogram
from peritext_tpu.obs import HistogramRegistry as JaxRegistry
from peritext_tpu.obs import LatencyPlane as JaxLatency
from peritext_tpu.obs import TimeSeriesPlane as JaxHistory
from peritext_tpu.obs import Tracer as JaxTracer
from peritext_tpu.obs import ambient_parent as jax_ambient_parent
from peritext_tpu.obs import current_span as jax_current_span
from peritext_tpu.obs import health_snapshot as jax_health_snapshot
from peritext_tpu.obs import replay_segments as jax_replay_segments
from peritext_tpu.obs.metrics import Counters as JaxCounters
from peritext_tpu_torch.obs import (
    LATENCY_BUCKETS_S,
    SIZE_BUCKETS,
    STAGES,
    Counters,
    FlightRecorder,
    Histogram,
    HistogramRegistry,
    LatencyPlane,
    TimeSeriesPlane,
    Tracer,
    ambient_parent,
    anomaly_kind,
    check_sum_consistency,
    current_span,
    health_snapshot,
    merge_traces,
    replay_segments,
)
from peritext_tpu_torch.obs import timeseries as ts_mod
from peritext_tpu.obs import timeseries as jax_ts_mod


def _values(seed, n=400):
    rng = random.Random(seed)
    return [rng.choice((1e-5, 1e-3, 0.02, 0.3, 4.0, 200.0)) * rng.random() for _ in range(n)]


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1, 16])
@pytest.mark.parametrize("buckets", ["latency", "size"])
def test_histogram_readouts_equal(window, buckets):
    bounds = LATENCY_BUCKETS_S if buckets == "latency" else SIZE_BUCKETS
    ref, port = JaxHistogram(bounds, window=window), Histogram(bounds, window=window)
    scale = 1.0 if buckets == "latency" else 5000.0
    for i, v in enumerate(_values(7)):
        ref.observe(v * scale)
        port.observe(v * scale)
        if i % 37 == 0:
            assert ref.snapshot() == port.snapshot()
    assert ref.snapshot() == port.snapshot()
    assert ref.bucket_counts() == port.bucket_counts()
    assert ref.overflow == port.overflow
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ref.percentile(q) == port.percentile(q)


def test_histogram_rejects_bad_config():
    with pytest.raises(ValueError):
        Histogram(window=0)
    with pytest.raises(ValueError):
        Histogram(buckets=())
    assert Histogram().percentile(0.99) == 0.0


def test_histogram_registry_snapshot_equal():
    ref, port = JaxRegistry(), HistogramRegistry()
    rng = random.Random(3)
    for v in _values(9, 200):
        name = rng.choice(("streaming.round_seconds", "serve.apply_seconds", "x.size"))
        kw = dict(buckets=SIZE_BUCKETS) if name == "x.size" else {}
        ref.observe(name, v * 100, **kw)
        port.observe(name, v * 100, **kw)
    assert ref.snapshot() == port.snapshot()
    assert [n for n, _ in ref.items()] == [n for n, _ in port.items()]
    with port.timed("t"):
        pass
    assert port.get("t").count == 1
    port.reset()
    assert port.snapshot() == {}


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def _numbered(spans, tracer):
    """Span records with ids numbered by order and the clock fields gone."""
    base = {sp.span_id: i + 1 for i, sp in enumerate(sorted(spans, key=lambda s: s.span_id))}
    out = []
    for sp in spans:
        rec = sp.to_json()
        rec.pop("start_ts")
        rec.pop("duration_s")
        rec["span_id"] = base[sp.span_id]
        rec["parent_id"] = base.get(sp.parent_id, 0 if sp.parent_id == 0 else "remote")
        rec["host"] = rec["host"] == tracer.host
        out.append(rec)
    return out


def _traced(tracer_cls, ambient, current):
    """One scripted pipeline on a tracer with a sink: nested spans, an
    error span, a remote context, and a child opened on another thread
    under ``ambient_parent``."""
    tracer = tracer_cls(host="h1", trace_id=0x1234)
    seen = []
    tracer.add_sink(seen.append)
    tracer.add_sink(seen.append)  # idempotent
    with tracer.span("streaming.round", docs=3) as outer:
        assert current() is outer
        with tracer.span("streaming.schedule"):
            pass
        with tracer.span("streaming.apply", rounds=1) as apply:
            apply.args["note"] = object.__name__
        try:
            with tracer.span("streaming.resolve"):
                raise ValueError("boom")
        except ValueError:
            pass

        def worker():
            with ambient(outer):
                with tracer.span("worker.step", tid="w"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join()
    with tracer.span("ingest", ctx=(0xABC, 77)):
        pass
    assert current() is None
    return tracer, seen


def test_tracer_nesting_sinks_and_threads_equal():
    ref, ref_seen = _traced(JaxTracer, jax_ambient_parent, jax_current_span)
    port, port_seen = _traced(Tracer, ambient_parent, current_span)
    assert _numbered(port_seen, port) == _numbered(ref_seen, ref)
    names = [sp.name for sp in port_seen]
    assert names == ["streaming.schedule", "streaming.apply", "streaming.resolve",
                     "worker.step", "streaming.round", "ingest"]
    by = {sp.name: sp for sp in port_seen}
    assert by["worker.step"].parent_id == by["streaming.round"].span_id
    assert by["worker.step"].tid != by["streaming.round"].tid
    assert by["streaming.resolve"].args["error"] == "ValueError('boom')"
    assert by["ingest"].trace_id == 0xABC and by["ingest"].parent_id == 77
    assert all(sp.duration >= 0 for sp in port_seen)
    assert port.spans() == []  # not enabled: measured and sunk, not retained


def test_tracer_retains_when_enabled_and_exports_chrome_trace():
    port = Tracer(host="h1").enable()
    with port.span("a"):
        with port.span("b"):
            pass
    trace = port.chrome_trace()
    assert [e["ph"] for e in trace["traceEvents"]] == ["M", "X", "X"]
    assert {e["name"] for e in trace["traceEvents"][1:]} == {"a", "b"}
    other = Tracer(host="h2").enable()
    with other.span("c"):
        pass
    merged = merge_traces(trace, other.chrome_trace())
    assert [e["ph"] for e in merged["traceEvents"]][:2] == ["M", "M"]
    assert len(merged["traceEvents"]) == 5
    json.dumps(merged)
    port.remove_sink(print)
    port.clear()
    assert port.spans() == []


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


def _strip(records):
    """Records without their clock fields and random span ids."""
    return [{k: v for k, v in r.items()
             if k not in ("ts", "start_ts", "duration_s", "span_id", "parent_id")}
            for r in records]


def _recorded(recorder_cls, tracer_cls, tmp_path):
    rec = recorder_cls(capacity=8, dump_dir=tmp_path, min_dump_interval=3600.0, host="h/1")
    rec.add_context_provider("tail", lambda f: [{"doc": f.get("doc"), "kind": "verdict"}])
    rec.add_context_provider("broken", lambda f: 1 / 0)
    tracer = tracer_cls(host="h1", trace_id=0x99)
    tracer.add_sink(rec.record_span)
    for i in range(12):
        with tracer.span(f"s{i}", i=i):
            pass
        rec.record("event", n=i)
    first = rec.fault("quarantine", doc=3, quarantine_reason="decode")
    rec.fault("rollback", doc=4)  # throttled: no second dump
    path = rec.dump(tmp_path / "manual.jsonl", reason="manual")
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    auto = sorted(p for p in tmp_path.glob("flight-*.jsonl"))
    auto_lines = [json.loads(x) for x in auto[0].read_text().splitlines()]
    return rec, first, lines, auto, auto_lines


def test_flight_recorder_dumps_equal(tmp_path):
    ref = _recorded(JaxRecorder, JaxTracer, tmp_path / "ref")
    port = _recorded(FlightRecorder, Tracer, tmp_path / "port")
    assert _strip([ref[1]]) == _strip([port[1]])
    assert _strip(ref[2]) == _strip(port[2])
    assert _strip(ref[4]) == _strip(port[4])
    assert len(port[3]) == 1 and port[3][0].name.startswith("flight-h_1-")
    assert port[3][0].name.endswith("-quarantine.jsonl")
    snap_ref, snap_port = ref[0].snapshot(), port[0].snapshot()
    assert {k: v for k, v in snap_ref.items() if k != "last_dump"} == \
        {k: v for k, v in snap_port.items() if k != "last_dump"}
    header, *body = port[4]
    assert header["kind"] == "dump" and header["reason"] == "quarantine"
    assert [r["kind"] for r in body][-1] == "context"
    assert body[-1]["provider"] == "tail" and body[-1]["doc"] == 3
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)
    with pytest.raises(ValueError):
        FlightRecorder().dump()


# ---------------------------------------------------------------------------
# the latency plane
# ---------------------------------------------------------------------------


def _latency_script(plane_cls, seed):
    plane = plane_cls(sample_every=2, slo_seconds=0.05, slo_window=16, pending_cap=6).enable()
    rng = random.Random(seed)
    t = 1000.0
    causes = ("window", "backpressure", "flush")
    for i in range(60):
        submit = t
        admit = submit + rng.random() * 1e-3
        close = admit + rng.random() * 0.02
        staged = close + rng.random() * 5e-3
        commit = staged + rng.random() * 0.08
        marks = {"apply_seconds": rng.random() * 0.1, "rounds": rng.randrange(1, 4)}
        plane.observe_batch(submit=submit, admit=admit, close=close, staged=staged,
                            commit=commit, marks=marks if i % 5 else None,
                            cause=causes[i % 3], batch=rng.randrange(1, 50))
        if i % 16 == 15:
            plane.mark_visible(commit + rng.random() * 0.01)
        t = commit + rng.random() * 0.01
    return plane


def test_latency_plane_equal():
    ref, port = _latency_script(JaxLatency, 11), _latency_script(LatencyPlane, 11)
    assert ref.snapshot() == port.snapshot()
    assert ref.decomposition() == port.decomposition()
    snap = port.snapshot()
    assert snap["never_read"] > 0 and snap["records"] == 30 and snap["windows"] == 60
    assert set(snap["stages"]) == set(STAGES)
    assert port.decomposition()["sum_consistent"]
    port.reset()
    assert port.snapshot()["records"] == 0 and port.last is None


def test_sum_consistency_rule():
    rec = {"stages": {"admit": 0.1, "window": 0.2, "stage": 0.0, "dispatch": 0.1,
                      "commit": 0.1}, "total": 0.5}
    assert check_sum_consistency(rec)
    assert not check_sum_consistency(dict(rec, total=0.6))
    assert not check_sum_consistency({"stages": dict(rec["stages"], commit=-0.1), "total": 0.3})
    assert not check_sum_consistency(rec, client_wall=0.2)
    with pytest.raises(ValueError):
        LatencyPlane(sample_every=0)


# ---------------------------------------------------------------------------
# the history plane
# ---------------------------------------------------------------------------


class _Snap:
    def __init__(self, body):
        self.body = body

    def snapshot(self):
        return self.body


def _history_script(plane_cls, directory):
    plane = plane_cls(sample_every=2, tier_capacity=8, tiers=3, merge_factor=4,
                      anomaly_window=16, min_frames=4, threshold=4.0, segment_frames=10,
                      dir=directory, host="h1")
    plane.advance_round(serve={"x": 1})  # disarmed: counts the round only
    plane.enable()
    rng = random.Random(5)
    for i in range(120):
        depth = 10 + rng.random() + (500 if i in (70, 71) else 0)
        sources = dict(serve=_Snap({"queue": {"depth": depth, "backpressure": i % 9 == 0},
                                    "label": "ignored"}),
                       latency={"slo": {"burn_rate": rng.random()}, "nan": float("nan")})
        if i % 3:
            plane.advance_round(**sources)
        else:
            plane.sample(**sources)
    plane.note_overhead(0.25)
    return plane


def test_history_plane_equal(tmp_path):
    ref = _history_script(JaxHistory, tmp_path / "ref")
    port = _history_script(TimeSeriesPlane, tmp_path / "port")
    for plane in (ref, port):
        for i in range(5):
            plane.record_occupancy(i % 2, 0.125 * i, docs=i)
    assert port.occupancy_rows() == ref.occupancy_rows()
    assert port.occupancy_values() == ref.occupancy_values()
    snap = port.snapshot()
    want = ref.snapshot()
    assert len(want["occupancy_rows"]) == 5
    assert {k: v for k, v in want.items() if k != "dir"} == \
        {k: v for k, v in snap.items() if k != "dir"}
    assert ref.frames_json() == port.frames_json()
    assert snap["anomaly"]["total"] > 0 and snap["tier_frames"][1] > 0
    key = "serve.queue.depth"
    assert port.series(key) == ref.series(key)
    assert port.rate(key, window=5) == ref.rate(key, window=5)
    assert port.summary(key) == ref.summary(key)
    assert port.query({"key": key, "rate": "1", "window": "4"}) == \
        ref.query({"key": key, "rate": "1", "window": "4"})
    assert port.active_anomalies() == ref.active_anomalies()
    assert port.anomaly_first_round(key) == ref.anomaly_first_round(key)
    cfg = dict(sample_every=2, tier_capacity=8, tiers=3, merge_factor=4, anomaly_window=16,
               min_frames=4, threshold=4.0, segment_frames=10)
    assert replay_segments(tmp_path / "port", **cfg).frames_json() == \
        jax_replay_segments(tmp_path / "ref", **cfg).frames_json()
    assert port.segments() == ref.segments()


def test_history_helpers_equal():
    for key in ("serve.queue.depth", "latency.slo", "session.x", "plan.y", "jit.z"):
        assert anomaly_kind(key) == jax_ts_mod.anomaly_kind(key)
    rng = random.Random(2)
    base = [rng.random() for _ in range(20)]
    for x in (0.5, 3.0, -2.0):
        assert ts_mod.mad_z(x, base) == jax_ts_mod.mad_z(x, base)
    assert ts_mod.mad_z(5.0, [1.0] * 8) == jax_ts_mod.mad_z(5.0, [1.0] * 8)
    for values in ([], base, [0.2, 0.9, 0.4, 1.0]):
        assert ts_mod.occupancy_distribution(values) == \
            jax_ts_mod.occupancy_distribution(values)
    with pytest.raises(TypeError):
        ts_mod.flatten_gauges("x", 3)
    with pytest.raises(ValueError):
        TimeSeriesPlane(tier_capacity=2, merge_factor=4)


# ---------------------------------------------------------------------------
# the composed health snapshot
# ---------------------------------------------------------------------------


def test_health_snapshot_equal(tmp_path):
    out = []
    for counters_cls, registry_cls, recorder_cls, latency_cls, history_cls, snapshot in (
            (JaxCounters, JaxRegistry, JaxRecorder, JaxLatency, JaxHistory, jax_health_snapshot),
            (Counters, HistogramRegistry, FlightRecorder, LatencyPlane, TimeSeriesPlane,
             health_snapshot)):
        counters, hists = counters_cls(), registry_cls()
        rng = random.Random(1)
        for _ in range(50):
            name = rng.choice(("streaming.rounds", "supervisor.rollbacks", "serve.shed",
                               "private.x", "merge.guarded_fallbacks"))
            counters.add(name, rng.randrange(1, 4))
            hists.observe(rng.choice(("serve.apply_seconds", "other.h")), rng.random())
        recorder = recorder_cls(capacity=4)
        recorder.record("event", n=1)
        latency = _latency_script(latency_cls, 4)
        history = history_cls().enable()
        history.sample(serve={"depth": 3})
        out.append(snapshot(counters=counters, histograms=hists, recorder=recorder,
                            latency=latency, history=history, serve=_Snap({"sessions": 2}),
                            plan={"proposal": 1}, mesh={"shards": 1}))
    assert out[0] == out[1]
    assert set(out[1]) == {"counters", "histograms", "flight_recorder", "latency", "history",
                           "serve", "plan", "mesh"}
    assert "private.x" not in out[1]["counters"] and "other.h" not in out[1]["histograms"]
    json.dumps(out[1])


def test_counters_keep_integers_and_lock():
    c = Counters()
    threads = [threading.Thread(target=lambda: [c.add("streaming.x") for _ in range(1000)])
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.get("streaming.x") == 4000 and isinstance(c.get("streaming.x"), float)
    with c.timed("t"):
        pass
    assert set(c.snapshot()) == {"streaming.x", "t"}
    c.reset()
    assert c.get("streaming.x") == 0
