"""The port's CI smokes (``scripts/torch_*_smoke.py``, twins of the JAX
side's ``scripts/*_smoke.py``) on the CPU, against the reference package.

Each smoke runs in process through its ``main(argv)`` with ``--device
cpu`` and ``--out`` under a temporary directory, shrunk through its twin's
own flags where it has them (fewer seeds, docs, ops).  It must exit 0,
name the device first and write its twin's artifacts under the twin's
file names, each JSON one with the twin's top-level keys (written down
below from the twins' sources; a snapshot a library call makes carries
that call's keys).  Without ``--device cpu`` each exits non-zero here (no
card, no fallback).  Then every digest a smoke reports equals the
reference package's entry point on the same seeded frames: the session
digests of the obs, paged, ragged, fused, mesh and serve smokes against
``peritext_tpu.parallel.streaming.StreamingMerge`` (every layout's
against the reference's padded session: a page-pool session's digest is
the padded one, pad term corrected, and the smokes hold each layout's
session equal to its padded or meshless twin), the chaos episodes' final
digests against ``peritext_tpu.testing.chaos``'s.  Digests are integers:
equal exactly.
"""

import contextlib
import importlib.util
import io
import json
import random
import re
import socket
import threading
import time
from pathlib import Path

import pytest
import torch

from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.parallel.staging import FrameStager as RefFrameStager
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing import chaos as ref_chaos
from peritext_tpu.testing.chaos import _LinkGate as RefLinkGate
from peritext_tpu.testing.fuzz import _campaign_session as jax_campaign_session
from peritext_tpu.testing.fuzz import generate_workload as jax_generate_workload
from peritext_tpu_torch.parallel.staging import FrameStager
from peritext_tpu_torch.testing.chaos import _LinkGate

ROOT = Path(__file__).resolve().parent.parent
ACTORS = ("doc1", "doc2", "doc3")

#: each smoke: its script and its argv on the CPU (its twin's flags only)
SMOKES = {
    "obs": ("torch_obs_smoke", ["--docs", "16", "--ops-per-doc", "12"]),
    "paged": ("torch_paged_smoke", []),
    "ragged": ("torch_ragged_smoke", []),
    "fused": ("torch_fused_smoke", ["--seeds", "5"]),
    "mesh": ("torch_mesh_smoke", ["--seeds", "3"]),
    "plan": ("torch_plan_smoke", ["--windows", "4", "--ops-per-doc", "12"]),
    "serve": ("torch_serve_smoke", []),
    "latency": ("torch_latency_smoke", ["--docs", "2", "--ops-per-doc", "6", "--repeats", "9"]),
    "incident": ("torch_incident_smoke", []),
    "history": ("torch_history_smoke", []),
    "fleet": ("torch_fleet_smoke", []),
    "fleet_serve": ("torch_fleet_serve_smoke", []),
}
#: the A/Bs (tests/test_torch_generators.py runs them)
AB_SCRIPTS = ("torch_append_ab", "torch_append_flat_ab")

#: the reference's devprof snapshot keys (tests/test_devprof.py)
DEVPROF_KEYS = ["enabled", "capture_costs", "sites", "occupancy", "occupancy_totals", "memory",
                "page_pool", "ragged", "mesh"]
#: the host-kill report's keys (``HostKillReport.to_json``)
HOSTKILL_KEYS = ["seed", "hosts", "num_docs", "victim", "victim_docs", "offered", "admitted",
                 "delayed", "shed", "shed_reasons", "detection_rounds", "failovers",
                 "failover_docs", "acked_at_kill", "acked_survived", "redelivered", "converged",
                 "final_digest", "flight_dumps", "traffic_seconds", "applied_frames",
                 "incident_kinds", "incident_resolved", "incident_detection_rounds",
                 "anomaly_keys", "anomaly_detection_rounds"]
#: per smoke, each artifact its twin writes (paths under --out; a glob for
#: the flight dumps): its top-level JSON keys, or None where it is not one
#: JSON object (traces, expositions, ledgers, dumps)
ARTIFACTS = {
    "obs": {"trace.json": ["traceEvents", "displayTimeUnit"],
            "health.json": ["counters", "histograms", "session"]},
    "paged": {"paged-report.json": ["seed", "batch", "streaming", "telemetry"],
              "devprof-snapshot.json": DEVPROF_KEYS, "metrics.prom": None},
    "ragged": {"ragged-report.json": ["seed", "kernel", "batch", "streaming", "telemetry"],
               "devprof-snapshot.json": DEVPROF_KEYS, "metrics.prom": None},
    "fused": {"fused-report.json": ["seeds", "layouts", "staging_overlap",
                                    "steady_state_compiles", "devprof_sites"],
              "devprof-snapshot.json": DEVPROF_KEYS},
    "mesh": {"mesh-report.json": ["seeds", "shard_counts", "layouts", "steady_state_compiles",
                                  "reshard", "devprof_mesh"],
             "devprof-snapshot.json": DEVPROF_KEYS, "mesh-gauges.prom": None},
    "plan": {"plan-report.json": ["tenants", "windows", "seed", "fused_dispatches",
                                  "per_session_dispatches", "amortization_x", "fusion",
                                  "steady_state_compiles", "devprof_sites", "proposal",
                                  "beats_current", "cli_exit", "replay_byte_equal"],
             "devprof-snapshot.json": sorted(DEVPROF_KEYS),
             "proposal.json": ["proposal", "current", "modeled"], "garbage.json": None},
    "serve": {"serve-report.json": ["seed", "overload", "open_loop", "digest"],
              "serve-overloaded.json": None, "serve-healthy.json": None},
    "latency": {"latency.json": None, "latency.prom": None, "why-ledger-clean.jsonl": None,
                "why-ledger.jsonl": None, "why.json": None},
    "incident": {"hostkill.json": HOSTKILL_KEYS, "timeline.json": ["hosts", "dumps", "records",
                                                                   "skipped", "timeline",
                                                                   "traces"],
                 "incidents.json": None, "status/incidents.json": None, "incidents.prom": None,
                 "flight/flight-*.jsonl": None},
    "history": {"history.json": None, "history.prom": None, "serve_chaos.json": None,
                "plan.json": ["proposal", "current", "modeled"], "occupancy.json": None,
                "clean/timeseries.json": None, "hot/timeseries.json": None,
                "segments/history-*.jsonl": None},
    "fleet": {"fleet-report.json": ["seed", "hosts", "partition_rounds", "observed_lag",
                                    "expected_lag", "heal_order", "lag_gauge_seen",
                                    "heal_rounds", "ops_drained", "heal_seconds", "converged",
                                    "final_digest", "divergence_incidents"],
              "divergence.json": None,
              "convergence.json": ["host", "rounds", "peers", "total_lag_ops",
                                   "divergence_incidents", "divergent_peers"],
              "flight/flight-*.jsonl": None},
    "fleet_serve": {"fleet-serve-report.json": HOSTKILL_KEYS, "fleet.json": None,
                    "flight/flight-*.jsonl": None},
}


@pytest.fixture(scope="module", autouse=True)
def _no_thread_outlives_the_module():
    """Ends the threads this module's sessions and episodes leave running,
    so none is alive when the interpreter exits: each package's idle
    staging workers (their lanes closed), the reference's link-gate
    bridges (their client side shut down; the port's gates shut their
    bridges themselves) and what those bridges hold open (servers'
    handlers), each joined within one bound."""
    before = set(threading.enumerate())
    yield
    started = [t for t in threading.enumerate() if t not in before]
    for t in started:
        owner = getattr(getattr(t, "_target", None), "__self__", None)
        if isinstance(owner, (FrameStager, RefFrameStager)):
            owner.close()
        elif isinstance(owner, (_LinkGate, RefLinkGate)) and t._args:
            with contextlib.suppress(OSError):
                t._args[0].shutdown(socket.SHUT_RDWR)
    deadline = time.monotonic() + 15.0
    for t in started:
        t.join(timeout=max(0.0, deadline - time.monotonic()))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Each smoke's exit code, printed lines and artifact directory, each
    smoke run once per module."""
    cache = {}

    def run(key):
        if key not in cache:
            name, argv = SMOKES[key]
            out = tmp_path_factory.mktemp(key)
            with contextlib.redirect_stdout(io.StringIO()) as printed, \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = _script(name).main([*argv, "--device", "cpu", "--out", str(out)])
            cache[key] = rc, printed.getvalue().splitlines(), out
        return cache[key]

    return run


def _hex_after(lines, word):
    for line in lines:
        m = re.search(word + r"[= ](0x[0-9a-f]+)", line)
        if m:
            return int(m.group(1), 16)
    raise AssertionError(f"no {word} in:\n" + "\n".join(lines))


def _report(out, name):
    return json.loads((out / name).read_text())


def test_obs_digest_equals_the_reference(smoke):
    _, lines, _ = smoke("obs")
    argv = SMOKES["obs"][1]
    docs, opd, seed = int(argv[1]), int(argv[3]), 7
    ref = jax_campaign_session(docs, opd)
    rng = random.Random(seed)
    for d, workload in enumerate(jax_generate_workload(seed, num_docs=docs, ops_per_doc=opd)):
        changes = [ch for log in workload.values() for ch in log]
        rng.shuffle(changes)
        ref.ingest_frames((d, jax_encode_frame(changes[i:i + 9]))
                          for i in range(0, len(changes), 9))
        if d % 16 == 0:
            ref.step()
    ref.drain()
    assert _hex_after(lines, "digest") == ref.digest()


@pytest.fixture(scope="module")
def longtail_reference_digest():
    """The reference's padded session on the paged and ragged smokes'
    shared streaming arrival (seed 8: 12 docs of the long tail, two
    frames each)."""
    seed = 8
    workloads = (jax_generate_workload(seed=seed, num_docs=24, ops_per_doc=8)
                 + jax_generate_workload(seed=seed + 90_001, num_docs=1, ops_per_doc=300))
    rng = random.Random(seed)
    arrival = []
    for w in workloads[:12]:
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        half = max(1, len(chs) // 2)
        arrival.append([jax_encode_frame(sorted(chs[:half], key=lambda c: (c.actor, c.seq))),
                        jax_encode_frame(sorted(chs[half:], key=lambda c: (c.actor, c.seq)))])
    s = JaxStreamingMerge(num_docs=len(arrival), actors=ACTORS, slot_capacity=512,
                          mark_capacity=128, tomb_capacity=128)
    for r in range(2):
        s.ingest_frames((d, b[r]) for d, b in enumerate(arrival))
        s.drain()
    return s.digest()


@pytest.mark.parametrize("key", ["paged", "ragged"])
def test_long_tail_digest_equals_the_reference(smoke, longtail_reference_digest, key):
    _, lines, out = smoke(key)
    report = _report(out, f"{key}-report.json")
    assert report["batch"]["byte_equal"] and report["streaming"]["byte_equal"]
    assert int(report["streaming"]["digest"], 16) == longtail_reference_digest
    assert _hex_after(lines, "digest") == longtail_reference_digest


def test_fused_digests_equal_the_reference(smoke):
    _, _, out = smoke("fused")
    report = _report(out, "fused-report.json")
    for seed in {row["seed"] for rows in report["layouts"].values() for row in rows}:
        s = JaxStreamingMerge(num_docs=8, actors=ACTORS, slot_capacity=256, mark_capacity=96,
                              tomb_capacity=128, round_insert_capacity=24,
                              round_delete_capacity=12, round_mark_capacity=12,
                              round_map_capacity=8)
        rng = random.Random(seed)
        plans = []
        for w in jax_generate_workload(seed=seed, num_docs=8, ops_per_doc=48):
            ch = [c for a in sorted(w) for c in w[a]]
            rng.shuffle(ch)
            size = -(-len(ch) // 3)
            plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
        for r in range(3):
            s.ingest_frames((d, jax_encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
                            for d, p in enumerate(plans) if r < len(p))
            s.drain()
        for layout in ("padded", "paged"):
            rows = [row for row in report["layouts"][layout] if row["seed"] == seed]
            assert [(row["digest"], row["rounds"]) for row in rows] == [(s.digest(), s.rounds)], \
                f"{layout} seed {seed}"


def test_mesh_digests_equal_the_references_meshless_session(smoke):
    _, _, out = smoke("mesh")
    report = _report(out, "mesh-report.json")
    assert report["shard_counts"] == [1, 2, 4, 8]
    assert sorted(report["layouts"]) == ["padded", "paged", "ragged"]
    for seed in {row["seed"] for rows in report["layouts"].values() for row in rows}:
        s = JaxStreamingMerge(num_docs=16, actors=ACTORS, slot_capacity=256, mark_capacity=128,
                              tomb_capacity=128)
        for doc, w in enumerate(jax_generate_workload(seed, num_docs=16, ops_per_doc=40)):
            s.ingest(doc, [ch for log in w.values() for ch in log])
        s.drain()
        for layout, rows in report["layouts"].items():
            rows = [row for row in rows if row["seed"] == seed]
            assert {row["digest"] for row in rows} == {s.digest()}, f"{layout} seed {seed}"
            assert [row["fused_dispatches"] for row in rows] == [1] * 4


def test_serve_digest_equals_the_reference(smoke):
    _, _, out = smoke("serve")
    report = _report(out, "serve-report.json")
    clean = ref_chaos._serve_session(6, 40)
    for doc, w in enumerate(jax_generate_workload(3, num_docs=6, ops_per_doc=40)):
        changes = [ch for log in w.values() for ch in log]
        for i in range(0, len(changes), 5):
            clean.ingest_frame(doc, jax_encode_frame(changes[i:i + 5]))
    clean.drain()
    assert int(report["digest"], 16) == clean.digest()
    overload = report["overload"]
    assert overload["submitted"] == overload["admitted"] + overload["delayed"] + overload["shed"]


def test_host_kill_digests_equal_the_reference(smoke, tmp_path):
    _, _, out = smoke("incident")
    port = _report(out, "hostkill.json")
    ref = ref_chaos.run_host_kill_failover(2, hosts=3, num_docs=4, ops_per_doc=16,
                                           transport=False, dump_dir=tmp_path / "incident")
    assert (port["final_digest"], port["victim"], port["incident_kinds"]) == \
        (ref.final_digest, ref.victim, ref.incident_kinds)
    _, _, out = smoke("fleet_serve")
    port = _report(out, "fleet-serve-report.json")
    ref = ref_chaos.run_host_kill_failover(7, hosts=3, num_docs=6, ops_per_doc=24,
                                           transport=True, dump_dir=tmp_path / "fleet_serve")
    assert (port["final_digest"], port["victim"], port["failover_docs"]) == \
        (ref.final_digest, ref.victim, ref.failover_docs)


def test_serve_chaos_digest_equals_the_reference(smoke):
    _, _, out = smoke("history")
    port = _report(out, "serve_chaos.json")
    ref = ref_chaos.run_serve_chaos(3, hosts=3)
    assert (port["final_digest"], port["anomaly_keys"]) == (ref.final_digest, ref.anomaly_keys)


def test_fleet_digests_equal_the_reference(smoke, tmp_path):
    _, _, out = smoke("fleet")
    port = _report(out, "fleet-report.json")
    ref = ref_chaos.run_fleet_chaos(7, hosts=4)
    assert port["lag_gauge_seen"] and ref.lag_gauge_seen
    assert (port["final_digest"], port["partition_rounds"]) == \
        (ref.final_digest, ref.partition_rounds)
    assert sorted(port["expected_lag"].values()) == sorted(ref.expected_lag.values())
    divergence = _report(out, "divergence.json")
    theirs = ref_chaos.run_divergence_injection(7, dump_dir=tmp_path)
    assert (divergence["local_digest"], divergence["peer_digest"]) == \
        (theirs["local_digest"], theirs["peer_digest"])


@pytest.mark.parametrize("key", sorted(SMOKES))
def test_smoke_exits_zero_with_its_twins_artifacts(smoke, key):
    rc, lines, out = smoke(key)
    assert rc == 0, "\n".join(lines)
    assert lines[0] == "device: cpu"
    for pattern, keys in ARTIFACTS[key].items():
        paths = sorted(out.glob(pattern))
        assert paths, f"{key}: no {pattern} in {sorted(out.rglob('*'))}"
        if keys is not None:
            assert list(json.loads(paths[0].read_text())) == keys, f"{key}: {pattern}"


@pytest.mark.parametrize("script", sorted(name for name, _ in SMOKES.values()) + list(AB_SCRIPTS))
def test_script_without_a_card_exits_nonzero(script, capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    argv = ["--out", str(tmp_path)] if script.endswith("_smoke") else []
    assert _script(script).main(argv) != 0
    out, err = capsys.readouterr()
    assert "no CUDA device" in err and not out
    assert not any(tmp_path.iterdir())
