"""The port's ``obs`` CLI (``peritext_tpu_torch/obs/__main__.py``) against
the reference package's, on the CPU.

For every subcommand both packages' ``main(argv)`` read the same input
files and must give the same exit code, the same stdout and the same
stderr.  The one difference is pinned: the devprof row of ``status`` /
``top`` says ``ops site(s)`` where the reference says ``jit site(s)``
(the port has no jit; ROADMAP.md section 3).  The inputs follow the
reference's own CLI tests (tests/test_obs.py, test_convergence.py,
test_serve.py, test_devprof.py, test_latency.py, test_incidents.py,
test_timeseries.py, test_plan.py), each plane built in both packages and
each package's snapshot fed to both CLIs.  Also: ``status`` and ``top``
live against a port ``MetricsServer`` and a reference one over twin
planes (every live call bounded by a timeout, every server stopped in a
``finally``); the surface audit (the port's ``_STATUS_PLANES`` stems equal
its ``MetricsServer`` route stems); and one ``python -m
peritext_tpu_torch.obs`` subprocess that imports neither ``jax`` nor
``peritext_tpu``.
"""

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from peritext_tpu import obs as ref_obs
from peritext_tpu.obs import ledger as ref_ledger
from peritext_tpu.obs.__main__ import main as ref_main
from peritext_tpu.parallel.codec import encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.plan import propose as ref_propose
from peritext_tpu.serve import AdmissionController as JaxAdmission
from peritext_tpu.serve import SessionMux as JaxSessionMux
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch import obs as port_obs
from peritext_tpu_torch.obs import ledger as port_ledger
from peritext_tpu_torch.obs.__main__ import _STATUS_PLANES, load_spans, render_table, summarize
from peritext_tpu_torch.obs.__main__ import main as port_main
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.plan import propose as port_propose
from peritext_tpu_torch.serve import AdmissionController, SessionMux

ROOT = Path(__file__).resolve().parents[1]
SNAPSHOT = ROOT / "perf" / "plan_devprof.json"
REFERENCE_LEDGER = ROOT / "perf" / "reference_ledger.jsonl"
ACTORS = ("doc1", "doc2", "doc3")
#: seconds a live CLI call may take (its scrapes time out at 10 s each)
LIVE_TIMEOUT = 60
#: the pinned wording of the devprof status row
REF_DEVPROF_ROW, PORT_DEVPROF_ROW = "jit site(s)", "ops site(s)"
#: both packages' obs modules, for planes built in each
PACKAGES = {"port": port_obs, "ref": ref_obs}


def run_both(capsys, argv):
    """Run the reference's and the port's ``main(argv)`` on the same
    inputs; both must agree (exit code, stdout but the pinned devprof row,
    stderr).  Returns the port's ``(code, out, err)``."""
    code_ref = ref_main(list(argv))
    ref = capsys.readouterr()
    code = port_main(list(argv))
    ours = capsys.readouterr()
    assert code == code_ref, (argv, ref.err, ours.err)
    assert ours.out == ref.out.replace(REF_DEVPROF_ROW, PORT_DEVPROF_ROW), argv
    assert REF_DEVPROF_ROW not in ours.out
    assert ours.err == ref.err, argv
    return code, ours.out, ours.err


def _bounded(fn, *args):
    """``fn(*args)`` on a worker thread, failing after LIVE_TIMEOUT s."""
    pool = ThreadPoolExecutor(1)
    try:
        return pool.submit(fn, *args).result(timeout=LIVE_TIMEOUT)
    finally:
        pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# summary and merge (tests/test_obs.py TestObsCli)
# ---------------------------------------------------------------------------


def _trace_file(pkg, tmp_path, name="trace.json"):
    t = pkg.Tracer(host="cli-host", enabled=True, trace_id=0x5)
    for _ in range(3):
        with t.span("streaming.apply"):
            pass
    path = tmp_path / name
    t.write_chrome_trace(path)
    return path


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_summary_table_and_default_command(capsys, tmp_path, pkg):
    path = _trace_file(PACKAGES[pkg], tmp_path)
    for argv in ([str(path)], ["summary", str(path)], ["summary", str(path), "--json"]):
        code, out, _ = run_both(capsys, argv)
        assert code == 0 and "streaming.apply" in out
    assert {r["stage"] for r in summarize(load_spans(path))} == {"streaming.apply"}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_summary_reads_flight_jsonl(capsys, tmp_path, pkg):
    mod = PACKAGES[pkg]
    r = mod.FlightRecorder(capacity=8)
    t = mod.Tracer(host="fl-host")
    t.add_sink(r.record_span)
    with t.span("supervisor.round"):
        pass
    dump = r.dump(tmp_path / "flight.jsonl")
    code, out, _ = run_both(capsys, ["summary", str(dump), "--json"])
    rows = json.loads(out)
    assert code == 0 and rows[0]["stage"] == "supervisor.round" and rows[0]["host"] == "fl-host"


def test_merge_command(capsys, tmp_path):
    a = _trace_file(port_obs, tmp_path, "a.json")
    b = _trace_file(ref_obs, tmp_path, "b.json")
    out = tmp_path / "merged.json"
    merged = []
    for main in (ref_main, port_main):
        assert main(["merge", "-o", str(out), str(a), str(b)]) == 0
        merged.append((out.read_text(), capsys.readouterr()))
    assert merged[0] == merged[1]
    assert {r["stage"] for r in summarize(load_spans(out))} == {"streaming.apply"}
    assert run_both(capsys, ["merge", "-o", str(out), str(tmp_path / "nope.json")])[0] == 2


def test_unreadable_and_empty_exit_codes(capsys, tmp_path):
    assert run_both(capsys, [str(tmp_path / "missing.json")])[0] == 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert run_both(capsys, [str(empty)])[0] == 1


def test_render_table_equals_the_reference():
    from peritext_tpu.obs.__main__ import render_table as ref_render_table

    rows = [{"a": "x", "b": 1.5, "c": -2}, {"a": "longer", "b": 10, "c": 3}]
    for left in (0, 1, 3):
        assert render_table(rows, ["a", "b", "c"], left) == \
            ref_render_table(rows, ["a", "b", "c"], left)
    assert render_table([], ["a"]) == ref_render_table([], ["a"])


# ---------------------------------------------------------------------------
# fleet (tests/test_convergence.py)
# ---------------------------------------------------------------------------


def _convergence(mod, clean=False):
    if clean:
        m = mod.ConvergenceMonitor(host="clean")
        m.observe_frontier("p", {"a": 1}, {"a": 1})
        return m
    m = mod.ConvergenceMonitor(host="exp-test")
    m.observe_frontier("peer-1", {"a": 1}, {"a": 4})
    m.observe_frontier("peer-2", {"a": 1}, {"a": 1}, local_digest=1, peer_digest=2)
    m.advance_round()
    m.observe_failure("peer-1", "refused")
    return m


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_fleet_renders_and_flags_lag(capsys, tmp_path, pkg):
    m = _convergence(PACKAGES[pkg])
    path = tmp_path / "conv.json"
    path.write_text(json.dumps(m.snapshot()))
    nested = tmp_path / "health.json"
    nested.write_text(json.dumps({"convergence": m.snapshot()}))
    code, out, _ = run_both(capsys, ["fleet", str(path), str(nested)])
    assert code == 1 and "peer-1" in out and "YES" in out
    code, out, _ = run_both(capsys, ["fleet", str(path), "--json"])
    assert code == 1 and json.loads(out)["divergence_incidents"] == 1
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(_convergence(PACKAGES[pkg], clean=True).snapshot()))
    assert run_both(capsys, ["fleet", str(clean)])[0] == 0
    assert run_both(capsys, ["fleet", str(tmp_path / "missing.json")])[0] == 2


# ---------------------------------------------------------------------------
# serve (tests/test_serve.py TestServeCLI)
# ---------------------------------------------------------------------------


def _serve_session(pkg, num_docs):
    kw = dict(num_docs=num_docs, actors=ACTORS, slot_capacity=256, mark_capacity=64,
              tomb_capacity=128, round_insert_capacity=128, round_delete_capacity=64,
              round_mark_capacity=64, static_rounds=True)
    if pkg == "port":
        return StreamingMerge(device="cpu", **kw)
    return JaxStreamingMerge(**kw)


def _frames(seed, num_docs):
    plans = []
    for w in generate_workload(seed, num_docs=num_docs, ops_per_doc=40):
        changes = [ch for log in w.values() for ch in log]
        plans.append([encode_frame(changes[i:i + 6]) for i in range(0, len(changes), 6)])
    return plans


def _muxes(pkg):
    """The reference tests' serving hosts, in one package: healthy,
    shedding, overloaded."""
    mux_cls, adm_cls = (SessionMux, AdmissionController) if pkg == "port" else \
        (JaxSessionMux, JaxAdmission)
    healthy = mux_cls(_serve_session(pkg, 2), host="h0")
    healthy.open_session("a")
    shedding = mux_cls(_serve_session(pkg, 2), host="h1")
    shedding.submit(42, b"x")  # a typed unknown-session shed
    overloaded = mux_cls(_serve_session(pkg, 2), host="h2", admission=adm_cls(
        max_depth=4, high_watermark=0.5, low_watermark=0.25, session_quota=None))
    sid, _ = overloaded.open_session("a")
    for f in _frames(33, 1)[0][:3]:
        overloaded.submit(sid, f)
    assert overloaded.overloaded
    return {"healthy": healthy, "shedding": shedding, "overloaded": overloaded}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_serve_exit_codes(capsys, tmp_path, pkg):
    want = {"healthy": 0, "shedding": 1, "overloaded": 1}
    paths = []
    for name, mux in _muxes(pkg).items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(mux.snapshot()))
        paths.append(str(path))
        code, out, _ = run_both(capsys, ["serve", str(path)])
        assert code == want[name], name
        if name == "shedding":
            assert "unknown-session" in out
        health = tmp_path / f"{name}-health.json"
        health.write_text(json.dumps(PACKAGES[pkg].health_snapshot(serve=mux), default=str))
        assert run_both(capsys, ["serve", str(health)])[0] == want[name]
    code, out, _ = run_both(capsys, ["serve", *paths, "--json"])
    assert code == 1 and json.loads(out)["overloaded_hosts"] == 1
    junk = tmp_path / "junk.json"
    junk.write_text('{"not": "a serve snapshot"}')
    assert run_both(capsys, ["serve", str(junk)])[0] == 2


def test_serve_recovered_host_stops_reporting_unhealthy(capsys, tmp_path):
    """Health reads recency: after a clean committed round the host that
    shed once exits 0, its lifetime shed count kept."""
    plans = _frames(33, 1)
    mux = SessionMux(_serve_session("port", 1), host="h4")
    mux.submit(99, b"x")
    path = tmp_path / "h4.json"
    path.write_text(json.dumps(mux.snapshot()))
    assert run_both(capsys, ["serve", str(path)])[0] == 1
    sid, _ = mux.open_session("a")
    mux.submit(sid, plans[0][0])
    mux.flush()
    snap = mux.snapshot()
    assert snap["queue"]["verdicts"]["shed"] == 1 and snap["recent_sheds"] == 0
    path.write_text(json.dumps(snap))
    assert run_both(capsys, ["serve", str(path)])[0] == 0


# ---------------------------------------------------------------------------
# perf (tests/test_devprof.py TestPerfGate) and why (tests/test_latency.py)
# ---------------------------------------------------------------------------


def _record(value=1000.0, unit="ops/s", row="streaming"):
    return {"schema": 1, "sha": "abc", "config": "test",
            "device": {"platform": "cpu", "kind": "cpu", "cpus": 8},
            "rows": [{"row": row, "metric": "m", "value": value, "unit": unit,
                      "key": "docs=64"}], "devprof": None}


def test_perf_gate_exit_codes(capsys, tmp_path):
    path = tmp_path / "ledger.jsonl"
    for rec in (_record(1000.0), _record(950.0)):
        port_ledger.append_record(path, rec)
    code, out, _ = run_both(capsys, ["perf", str(path), "--gate"])
    assert code == 0 and "streaming" in out and "ok" in out
    ref_ledger.append_record(path, _record(10.0))
    assert run_both(capsys, ["perf", str(path)])[0] == 0  # render-only never gates
    assert run_both(capsys, ["perf", str(path), "--gate"])[0] == 1
    code, out, _ = run_both(capsys, ["perf", str(path), "--gate", "--json"])
    assert code == 1 and json.loads(out)["regressed"] is True
    for flags in (["--tolerance", "99.5"], ["--window", "1"], ["--match", "any"]):
        run_both(capsys, ["perf", str(path), "--gate", *flags])


def test_perf_unreadable_ledger_exits_2(capsys, tmp_path):
    assert run_both(capsys, ["perf", str(tmp_path / "missing.jsonl")])[0] == 2
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json}\n")
    assert run_both(capsys, ["perf", str(bad)])[0] == 2
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert run_both(capsys, ["perf", str(empty)])[0] == 2


def test_perf_committed_reference_gates_clean_and_catches_regression(capsys, tmp_path):
    """The JAX package's committed ledger gives the same verdict through the
    port's CLI: exit 0, then exit 1 once a regressed record lands."""
    assert run_both(capsys, ["perf", str(REFERENCE_LEDGER), "--gate"])[0] == 0
    records = port_ledger.load_ledger(REFERENCE_LEDGER)
    regressed = json.loads(json.dumps(records[-1]))
    for row in regressed["rows"]:
        if isinstance(row.get("value"), (int, float)):
            direction = port_ledger.DIRECTION_BY_UNIT.get(row.get("unit"), +1)
            row["value"] = row["value"] * 0.2 if direction > 0 else row["value"] * 5.0
    work = tmp_path / "gate.jsonl"
    work.write_text(REFERENCE_LEDGER.read_text())
    port_ledger.append_record(work, regressed)
    code, out, _ = run_both(capsys, ["perf", str(work), "--gate"])
    assert code == 1 and "regressed" in out


def test_perf_card_record_compares_only_with_card_records(capsys, tmp_path):
    """A record whose device is a card gates only against card records: a
    CPU reference ledger leaves it vacuous (``new``), a card twin does not."""
    card = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "cpus": 8}
    cpu_ref = dict(_record(1000.0), device={"platform": "cpu", "kind": "cpu", "cpus": 8})
    slow_card = dict(_record(100.0), device=card)
    path = tmp_path / "mixed.jsonl"
    for rec in (cpu_ref, slow_card):
        port_ledger.append_record(path, rec)
    code, out, _ = run_both(capsys, ["perf", str(path), "--gate", "--json"])
    assert code == 0 and [v["status"] for v in json.loads(out)["rows"]] == ["new"]
    port_ledger.append_record(path, dict(_record(1000.0), device=card))
    port_ledger.append_record(path, slow_card)
    assert run_both(capsys, ["perf", str(path), "--gate"])[0] == 1


BASE_STAGES = {"admit": 0.1, "window": 2.0, "stage": 0.2, "dispatch": 0.5, "commit": 1.0,
               "visibility": 0.3}


def _ledger_rec(sha, value, stages_ms):
    lat = {"stages_ms": dict(stages_ms),
           "total_ms": round(sum(v for s, v in stages_ms.items() if s != "visibility"), 4)}
    return {"sha": sha, "config": "c1", "device": {"platform": "cpu", "kind": "cpu0"},
            "rows": [{"row": "serve_sustained", "unit": "docs/s", "value": value,
                      "latency": lat}]}


def _regressed_ledger(moved="window", by=7.0):
    records = [_ledger_rec(f"r{i}", 100.0, BASE_STAGES) for i in range(5)]
    stages = dict(BASE_STAGES)
    stages[moved] += by
    records.append(_ledger_rec("bad", 50.0, stages))
    return records


def _write_ledger(tmp_path, records, name="ledger.jsonl"):
    p = tmp_path / name
    p.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(p)


@pytest.mark.parametrize("moved", ["window", "commit", "visibility"])
def test_why_exit_contract(capsys, tmp_path, moved):
    bad = _write_ledger(tmp_path, _regressed_ledger(moved))
    code, out, err = run_both(capsys, ["why", bad, "--tolerance", "10"])
    assert code == 1 and f"dominant moved stage is '{moved}'" in err
    code, out, _ = run_both(capsys, ["why", bad, "--tolerance", "10", "--json"])
    body = json.loads(out)
    assert code == 1 and body["dominant_stage"] == moved
    assert run_both(capsys, ["why", bad, "--row", "serve_sustained", "--tolerance", "10"])[0] == 1
    assert run_both(capsys, ["why", bad, "--row", "nope"])[0] == 2


def test_why_clean_unreadable_and_undecomposed(capsys, tmp_path):
    clean = [_ledger_rec(f"r{i}", 100.0, BASE_STAGES) for i in range(6)]
    code, out, _ = run_both(capsys, ["why", _write_ledger(tmp_path, clean), "--tolerance", "10"])
    assert code == 0 and "nothing to attribute" in out
    assert run_both(capsys, ["why", str(tmp_path / "missing.jsonl")])[0] == 2
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert run_both(capsys, ["why", str(empty)])[0] == 2
    bare = [_record(1000.0), _record(1000.0), _record(100.0)]
    code, _, err = run_both(capsys, ["why", _write_ledger(tmp_path, bare, "bare.jsonl")])
    assert code == 1 and "no latency decomposition" in err
    flat = _regressed_ledger("window", 0.0)
    code, _, err = run_both(capsys, ["why", _write_ledger(tmp_path, flat, "flat.jsonl"),
                                     "--tolerance", "10"])
    assert code == 1 and "no stage moving up" in err
    assert run_both(capsys, ["why", str(REFERENCE_LEDGER)])[0] == 0


# ---------------------------------------------------------------------------
# plan (tests/test_plan.py, tests/test_timeseries.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--json"], ["--tolerance", "1000000"],
                                   ["--ledger", str(REFERENCE_LEDGER)],
                                   ["--ledger", str(REFERENCE_LEDGER), "--json",
                                    "--tolerance", "0"]],
                         ids=["table", "json", "tolerance", "ledger", "ledger_json"])
def test_plan_on_the_committed_snapshot(capsys, extra):
    code, out, err = run_both(capsys, ["plan", str(SNAPSHOT), *extra])
    proposal = port_propose(SNAPSHOT)
    if "--tolerance" not in extra:
        assert code == (1 if proposal.beats_current() else 0)
    if "--json" in extra:
        body = json.loads(out)
        assert body["proposal"] == port_propose(
            SNAPSHOT, port_ledger.load_ledger(REFERENCE_LEDGER)
            if "--ledger" in extra else None).to_json()["proposal"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_plan_history_weighted_terms(capsys, tmp_path, pkg):
    plane = PACKAGES[pkg].TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    bimodal = [0.05, 0.1, 0.95, 1.0] * 4
    for occ in bimodal:
        plane.record_occupancy(0, occ)
    hist = tmp_path / "history.json"
    hist.write_text(json.dumps(plane.snapshot(), default=str))
    wrapped = tmp_path / "health.json"
    wrapped.write_text(json.dumps({"history": plane.snapshot()}, default=str))
    rows = tmp_path / "rows.json"
    rows.write_text(json.dumps(bimodal))
    for src in (hist, wrapped, rows):
        code, out, _ = run_both(capsys, ["plan", str(SNAPSHOT), "--history", str(src)])
        assert "history-weighted terms: dispatch_cost, utilization" in out
        assert "16 occupancy row(s)" in out


def test_plan_unreadable_inputs_exit_2(capsys, tmp_path):
    bad = tmp_path / "garbage.json"
    bad.write_text("{not json")
    assert run_both(capsys, ["plan", str(bad)])[0] == 2
    assert run_both(capsys, ["plan", str(tmp_path / "missing.json")])[0] == 2
    notsnap = tmp_path / "notsnap.json"
    notsnap.write_text('{"not": "a snapshot"}')
    assert run_both(capsys, ["plan", str(notsnap)])[0] == 2
    assert run_both(capsys, ["plan", str(SNAPSHOT), "--ledger", str(bad)])[0] == 2
    assert run_both(capsys, ["plan", str(SNAPSHOT), "--history", str(bad)])[0] == 2


# ---------------------------------------------------------------------------
# incidents, status over a directory, flight (tests/test_incidents.py)
# ---------------------------------------------------------------------------


def _incident_feed(m, quiet=3):
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


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_incidents_exit_codes(capsys, tmp_path, pkg):
    mod = PACKAGES[pkg]
    m = mod.IncidentMonitor(host="h")
    _incident_feed(m)
    path = tmp_path / "incidents.json"
    path.write_text(json.dumps(m.snapshot()))
    expect = 1 if m.open_incidents() else 0
    code, out, _ = run_both(capsys, ["incidents", str(path)])
    assert code == expect and "monitor(s)" in out
    clean_m = mod.IncidentMonitor(host="h")
    clean_m.advance_round()
    clean = tmp_path / "clean.json"
    clean.write_text(json.dumps(clean_m.snapshot()))
    assert run_both(capsys, ["incidents", str(clean)])[0] == 0
    code, out, _ = run_both(capsys, ["incidents", str(path), str(clean), "--json"])
    assert code == expect and json.loads(out)["monitors"] == 2
    health = tmp_path / "health.json"
    health.write_text(json.dumps(mod.health_snapshot(incidents=m)))
    assert run_both(capsys, ["incidents", str(health)])[0] == expect
    assert run_both(capsys, ["incidents", str(tmp_path / "missing.json")])[0] == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert run_both(capsys, ["incidents", str(bad)])[0] == 2


def _status_dir(tmp_path, pkg):
    """A snapshot directory with every plane's file, each body from
    ``pkg``'s planes."""
    mod = PACKAGES[pkg]
    m = mod.IncidentMonitor(host="h")
    _incident_feed(m)
    prof = mod.DeviceProfiler().enable()
    prof.observe_round("D8.ki16.kd8.km8.kp8", real_ops=60, padded_capacity=320)
    history = mod.TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    for i in range(6):
        history.sample(serve={"admitted": float(i)})
    propose = port_propose if pkg == "port" else ref_propose
    bodies = {
        "health": mod.health_snapshot(counters=mod.Counters()),
        "convergence": _convergence(mod).snapshot(),
        "serve": {"sessions": 1, "overloaded": False, "recent_sheds": 0,
                  "queue": {"depth": 0, "max_depth": 8, "backpressure": False,
                            "verdicts": {"shed": 0}}},
        "fleet": {"hosts": {"h0": {}}, "leases": {"leases": {"h0": {"verdict": "live"}}},
                  "serving": {"d0": "h0"}, "failed_docs": [], "failovers": 0},
        "latency": {"windows": 3, "slo": {"burn_rate": 0.5, "violating_frac": 0.0}},
        "incidents": m.snapshot(),
        "devprof": prof.snapshot(),
        "plan": propose(SNAPSHOT).to_json(),
        "timeseries": history.snapshot(),
        "trace": {"traceEvents": [{"ph": "X", "name": "a"}, {"ph": "M"}]},
    }
    root = tmp_path / pkg
    root.mkdir()
    for stem, body in bodies.items():
        (root / f"{stem}.json").write_text(json.dumps(body, default=str))
    return root, 1 if m.open_incidents() else 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_status_composite_over_snapshot_dir(capsys, tmp_path, pkg):
    root, incident_code = _status_dir(tmp_path, pkg)
    code, out, _ = run_both(capsys, ["status", str(root)])
    assert "0 ops site(s) · dispatches 0" in out
    code, out, _ = run_both(capsys, ["status", str(root), "--json"])
    rows = {r["plane"]: r for r in json.loads(out)["planes"]}
    assert set(rows) == {stem for stem, _ in _STATUS_PLANES}
    assert code == max(r["exit"] for r in rows.values()) >= incident_code
    (root / "serve.json").write_text("{not json")
    code, out, _ = run_both(capsys, ["status", str(root), "--json"])
    assert code == 2 and {r["plane"]: r for r in json.loads(out)["planes"]}["serve"]["exit"] == 2
    assert run_both(capsys, ["status", str(tmp_path / "nothing")])[0] == 2


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_top_over_snapshot_dir(capsys, tmp_path, pkg):
    root, _ = _status_dir(tmp_path, pkg)
    code, out, _ = run_both(capsys, ["top", str(root)])
    assert "mover(s)" in out and PORT_DEVPROF_ROW in out
    code_json, out, _ = run_both(capsys, ["top", str(root), "--json", "--top", "1",
                                          "--window", "3"])
    assert code_json == code and json.loads(out)["movers"][0]["key"] == "serve.admitted"
    (root / "timeseries.json").unlink()
    code, out, _ = run_both(capsys, ["top", str(root)])
    assert "history: plane not mounted" in out
    assert run_both(capsys, ["top", str(tmp_path / "nothing")])[0] == 2


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_flight_merged_timeline(capsys, tmp_path, pkg):
    mod = PACKAGES[pkg]
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    for host, name in (("hostA", "commit"), ("hostB", "apply")):
        rec = mod.FlightRecorder(dump_dir=dumps, host=host, min_dump_interval=0.0)
        rec.record("span", name=name, trace_id="t1")
        rec.dump(reason="probe")
    code, out, _ = run_both(capsys, ["flight", str(dumps)])
    assert code == 0 and "hostA" in out and "hostB" in out and "commit" in out
    assert run_both(capsys, ["flight", str(dumps), "--json", "--tail", "1"])[0] == 0
    assert run_both(capsys, ["flight", str(tmp_path / "nope")])[0] == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert run_both(capsys, ["flight", str(empty)])[0] == 2


# ---------------------------------------------------------------------------
# history (tests/test_timeseries.py TestCli)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_history_exit_codes(capsys, tmp_path, pkg):
    mod = PACKAGES[pkg]
    quiet = mod.TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    for _ in range(quiet.min_frames + 2):
        quiet.sample(serve={"shed": 3.0})
    (tmp_path / "timeseries.json").write_text(json.dumps(quiet.snapshot(), default=str))
    code, out, _ = run_both(capsys, ["history", str(tmp_path)])
    assert code == 0 and "serve.shed" in out
    spiked = mod.TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    for _ in range(spiked.min_frames + 2):
        spiked.sample(serve={"shed": 0.0})
    spiked.sample(serve={"shed": 50.0})
    hot = tmp_path / "hot"
    hot.mkdir()
    (hot / "timeseries.json").write_text(json.dumps(spiked.snapshot(), default=str))
    code, _, err = run_both(capsys, ["history", str(hot)])
    assert code == 1 and "anomaly: serve.shed [shed-storm]" in err
    assert run_both(capsys, ["history", str(hot), "--json"])[0] == 1
    assert run_both(capsys, ["history", str(tmp_path / "missing")])[0] == 2
    assert run_both(capsys, ["history", str(tmp_path), "--key", "no.such"])[0] == 2
    wrapped = tmp_path / "wrapped.json"
    wrapped.write_text(json.dumps({"history": quiet.snapshot()}, default=str))
    assert run_both(capsys, ["history", str(wrapped)])[0] == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_history_key_view_with_rate(capsys, tmp_path, pkg):
    plane = PACKAGES[pkg].TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    for i in range(8):
        plane.sample(serve={"admitted": float(i * 2)})
    (tmp_path / "timeseries.json").write_text(json.dumps(plane.snapshot(), default=str))
    code, out, _ = run_both(capsys, ["history", str(tmp_path), "--key", "serve.admitted",
                                     "--rate", "--json"])
    body = json.loads(out)
    assert code == 0 and len(body["points"]) == 8 and body["rate"][-1][1] == 2.0
    assert body["summary"]["delta"] == 14.0
    for extra in (["--rate"], ["--window", "3"], []):
        assert run_both(capsys, ["history", str(tmp_path), "--key", "serve.admitted",
                                 *extra])[0] == 0


# ---------------------------------------------------------------------------
# status and top against live servers over twin planes
# ---------------------------------------------------------------------------


def _live_server(pkg, snaps):
    """A MetricsServer of ``pkg`` with the reference's roll-up planes
    mounted (tests/test_obs_surface.py TestStatusRollupLive), fed the same
    in both packages; ``snaps`` holds the twin session's devprof snapshot
    and its health."""
    mod = PACKAGES[pkg]
    history = mod.TimeSeriesPlane(min_frames=4).enable()
    for i in range(6):
        history.sample(serve={"admitted": float(i)})
    incidents = mod.IncidentMonitor(host="roll")
    incidents.advance_round()
    propose = port_propose if pkg == "port" else ref_propose

    class _Session:
        def health(self):
            return snaps[pkg]["health"]

    class _Devprof:
        def snapshot(self):
            return snaps[pkg]["devprof"]

    return mod.MetricsServer(
        counters=mod.Counters(), histograms=mod.HistogramRegistry(), session=_Session(),
        convergence=mod.ConvergenceMonitor(host="roll"), devprof=_Devprof(),
        incidents=incidents, latency=mod.LatencyPlane(), plan=propose(SNAPSHOT),
        history=history,
    )


@pytest.fixture(scope="module")
def twin_sessions():
    """A padded session per package fed the same changes with each
    package's profiler armed: its devprof snapshot and ``health()``."""
    from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
    from peritext_tpu_torch.core.types import Change
    from peritext_tpu_torch.obs import GLOBAL_DEVPROF

    ref_w = generate_workload(5, num_docs=4, ops_per_doc=24)
    port_w = [{a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}
              for w in ref_w]
    caps = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=64,
                round_insert_capacity=32, round_delete_capacity=16, round_mark_capacity=16)
    out = {}
    for pkg, prof, workloads, session in (
            ("port", GLOBAL_DEVPROF, port_w,
             lambda: StreamingMerge(num_docs=4, actors=ACTORS, device="cpu", **caps)),
            ("ref", JAX_DEVPROF, ref_w,
             lambda: JaxStreamingMerge(num_docs=4, actors=ACTORS, **caps))):
        prof.reset()
        prof.enable(capture_costs=False)
        try:
            s = session()
            for d, w in enumerate(workloads):
                s.ingest(d, [ch for log in w.values() for ch in log])
            s.drain()
            out[pkg] = {"devprof": prof.snapshot(), "health": s.health(),
                        "spans": s.read_all()}
        finally:
            prof.disable()
            prof.reset()
    assert out["port"]["spans"] == out["ref"]["spans"]
    return out


def _live_rows(capsys, url, command):
    code, out, _ = _bounded(run_both, capsys, [command, url, "--json"])
    body = json.loads(out)
    assert code == body["exit"]
    return code, body


def test_status_and_top_live_on_twin_servers(capsys, twin_sessions):
    rows = {}
    for pkg in PACKAGES:
        server = _live_server(pkg, twin_sessions)
        host, port = server.start()
        try:
            url = f"http://{host}:{port}"
            code, body = _live_rows(capsys, url, "status")
            top_code, top = _live_rows(capsys, url, "top")
            assert top_code == code and top["planes"] == body["planes"]
            assert top["movers"][0]["key"] == "serve.admitted"
            mounted = {path[1:-len(".json")] for path in server._httpd._routes
                       if path.endswith(".json")}
        finally:
            server.stop()
        planes = {r["plane"]: r for r in body["planes"]}
        # one row per mounted JSON route; the worst row is the exit
        assert set(planes) == mounted == {"health", "convergence", "devprof", "incidents",
                                          "latency", "plan", "timeseries"}
        assert code == max(r["exit"] for r in planes.values())
        assert planes["devprof"]["summary"].endswith(
            f"padding_waste {twin_sessions[pkg]['devprof']['occupancy_totals']['padding_waste']}")
        rows[pkg] = planes
    # the twin servers agree on every plane but the profiler's own site table
    for plane in ("health", "convergence", "incidents", "latency", "plan", "timeseries"):
        assert rows["port"][plane] == rows["ref"][plane], plane


def test_status_live_incident_plane(capsys):
    """tests/test_incidents.py: a clean monitor on a live server is exit 0,
    an open incident exit 1."""
    for feed, want in ((False, 0), (True, 1)):
        m = port_obs.IncidentMonitor(host="h")
        if feed:
            _incident_feed(m, quiet=0)
        else:
            m.advance_round()
        server = port_obs.MetricsServer(incidents=m)
        host, port = server.start()
        try:
            code, out, _ = _bounded(run_both, capsys, ["status", f"http://{host}:{port}"])
        finally:
            server.stop()
        assert code == want and "incidents" in out and "health" in out


def test_live_history_route(capsys):
    plane = port_obs.TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    for i in range(6):
        plane.sample(serve={"admitted": float(i * 5)})
    server = port_obs.MetricsServer(history=plane)
    host, port = server.start()
    try:
        url = f"http://{host}:{port}"
        code, out, _ = _bounded(run_both, capsys, ["history", url, "--key", "serve.admitted"])
        assert code == 0 and "delta 25.0" in out
        code, out, _ = _bounded(run_both, capsys, ["top", url, "--json"])
        assert code == 0 and json.loads(out)["movers"][0]["delta"] == 25.0
    finally:
        server.stop()
    bare = port_obs.MetricsServer()
    host, port = bare.start()
    try:
        assert _bounded(run_both, capsys, ["history", f"http://{host}:{port}"])[0] == 2
    finally:
        bare.stop()


# ---------------------------------------------------------------------------
# the surface audit; the entry point imports nothing of JAX
# ---------------------------------------------------------------------------


def test_status_planes_equal_the_route_stems():
    server = port_obs.MetricsServer(
        tracer=object(), convergence=object(), devprof=object(), serve=object(),
        fleet=object(), plan={}, latency=object(), incidents=object(), history=object())
    try:
        routes = server._httpd._routes
        stems = {path[1:-len(".json")] for path in routes if path.endswith(".json")}
    finally:
        server.stop()
    assert "/metrics" in routes
    assert stems == {name for name, _ in _STATUS_PLANES}


def test_cli_never_initialises_cuda(capsys, tmp_path):
    root, _ = _status_dir(tmp_path, "port")
    for argv in (["plan", str(SNAPSHOT)], ["perf", str(REFERENCE_LEDGER)],
                 ["status", str(root)], ["history", str(root)]):
        port_main(argv)
    capsys.readouterr()
    assert not torch.cuda.is_initialized()


def test_module_entry_point_imports_neither_jax_nor_the_reference():
    """``python -m peritext_tpu_torch.obs`` in a fresh interpreter, with
    ``-X importtime`` listing every module it imports."""
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "peritext_tpu_torch.obs", "plan",
         str(SNAPSHOT), "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == (1 if port_propose(SNAPSHOT).beats_current() else 0), proc.stderr
    assert json.loads(proc.stdout)["proposal"] == port_propose(SNAPSHOT).to_json()["proposal"]
    imported = [line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "peritext_tpu_torch.plan.tuner" in imported
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "peritext_tpu")]
    assert bad == []
