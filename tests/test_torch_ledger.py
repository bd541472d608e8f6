"""The port's perf ledger (``peritext_tpu_torch/obs/ledger.py``) and its
attribution engine (``obs/latency.attribute``) against the reference
package's, on the CPU.

The same record sets go through both packages' ``evaluate`` and
``attribute`` and the reports must be equal: the reference's perf-gate
record sets (tests/test_devprof.py ``TestPerfGate``), its attribution
sets (tests/test_latency.py ``TestAttribution``), and the committed
``perf/reference_ledger.jsonl``, read as data, as it stands and with its
last record regressed.  Plus the record schema with a port devprof
snapshot, the device fingerprint (``{platform, kind, cpus}``: ``cpu``
here), and append/load.
"""

import copy
import json
import os
from pathlib import Path

import pytest

from peritext_tpu.obs import attribute as jax_attribute
from peritext_tpu.obs import ledger as jax_ledger
from peritext_tpu_torch.obs import DeviceProfiler, attribute
from peritext_tpu_torch.obs import ledger

REFERENCE_LEDGER = Path(__file__).resolve().parents[1] / "perf" / "reference_ledger.jsonl"


def _record(value=1000.0, unit="ops/s", row="streaming", device=None, failed=False,
            extra_rows=(), config="test"):
    rows = [{"row": row, "metric": "m", "value": value, "unit": unit, "key": "docs=64",
             **({"failed": True} if failed else {})}]
    rows.extend(extra_rows)
    return {"schema": 1, "sha": "abc", "config": config,
            "device": device or {"platform": "cpu", "kind": "cpu", "cpus": 8},
            "rows": rows, "devprof": None}


WIRE = {"row": "wire", "metric": "w", "value": 5.0, "unit": "B/op", "key": ""}
TWO_CORES = {"platform": "cpu", "kind": "cpu", "cpus": 2}
TPU = {"platform": "tpu", "kind": "TPU v5", "cpus": 8}


def _other_config_set(candidate_rows):
    ref = _record(5.0, "B/op", row="wire", config="ladder-smoke")
    others = [_record(100.0, config="streaming-smoke") for _ in range(ledger.DEFAULT_WINDOW + 1)]
    return [ref, *others, candidate_rows]


def _ladder_then_single():
    ladder = _record(1000.0, config="ladder-smoke")
    ladder["rows"].append(dict(WIRE))
    return [ladder, _record(100.0, config="streaming-smoke")]


#: (name, records, evaluate kwargs): the reference's TestPerfGate sets
GATE_SETS = [
    ("single", [_record()], {}),
    ("drop", [_record(1000.0), _record(1000.0), _record(400.0)], {}),
    ("within_band", [_record(1000.0), _record(700.0)], {}),
    ("bop_up", [_record(5.0, "B/op"), _record(6.0, "B/op")], {}),
    ("bop_down", [_record(5.0, "B/op"), _record(4.0, "B/op")], {}),
    ("median", [_record(100.0), _record(1000.0), _record(1100.0), _record(1000.0)], {}),
    ("device_mismatch", [_record(1000.0, device=TPU), _record(100.0)], {}),
    ("device_mismatch_any", [_record(1000.0, device=TPU), _record(100.0)], {"match": "any"}),
    ("cores_bop", [_record(5.0, "B/op", device=TWO_CORES), _record(7.0, "B/op")], {}),
    ("cores_wall", [_record(1000.0, device=TWO_CORES), _record(100.0)], {}),
    ("dropped_row", [_record(1000.0, extra_rows=[dict(WIRE)]), _record(1000.0)], {}),
    ("other_configs", _other_config_set(_record(50.0, "B/op", row="wire",
                                                config="ladder-smoke")), {}),
    ("other_configs_missing", _other_config_set(_record(1.0, row="unrelated",
                                                        config="ladder-smoke")), {}),
    ("separate_history", _ladder_then_single(), {}),
    ("failed_row", [_record(1000.0), _record(None, failed=True)], {}),
    ("tolerance", [_record(1000.0), _record(850.0)], {"tolerance": 0.1}),
    ("window", [_record(v) for v in (10.0, 10.0, 1000.0, 1000.0, 1000.0, 1000.0, 400.0)],
     {"window": 3}),
    ("platform", [_record(1000.0, device=TWO_CORES), _record(100.0)], {"match": "platform"}),
]

BASE_STAGES = {"admit": 0.1, "window": 2.0, "stage": 0.2, "dispatch": 0.5, "commit": 1.0,
               "visibility": 0.3}


def _lat_rec(sha, value, stages_ms, row="serve_sustained", unit="docs/s", devprof=None):
    lat = {"stages_ms": dict(stages_ms),
           "total_ms": round(sum(v for s, v in stages_ms.items() if s != "visibility"), 4)}
    rec = {"sha": sha, "config": "c1", "device": {"platform": "cpu", "kind": "cpu0"},
           "rows": [{"row": row, "unit": unit, "value": value, "latency": lat}]}
    if devprof is not None:
        rec["devprof"] = devprof
    return rec


def _moved(moves, value=50.0, devprof=None, base_devprof=None):
    records = [_lat_rec(f"r{i}", 100.0, BASE_STAGES, devprof=base_devprof) for i in range(5)]
    stages = dict(BASE_STAGES)
    for stage, by in moves.items():
        stages[stage] += by
    records.append(_lat_rec("bad", value, stages, devprof=devprof))
    return records


def _dp(shapes, dispatches, waste):
    return {"sites": {"apply": {"distinct_shapes": shapes, "dispatches": dispatches}},
            "occupancy_totals": {"padding_waste": waste}}


def _no_decomposition():
    records = [_lat_rec(f"r{i}", 100.0, BASE_STAGES) for i in range(5)]
    records.append({"sha": "bad", "config": "c1", "device": {"platform": "cpu", "kind": "cpu0"},
                    "rows": [{"row": "serve_sustained", "unit": "docs/s", "value": 50.0}]})
    return records


#: (name, records, attribute kwargs): the reference's TestAttribution sets
ATTRIBUTION_SETS = [
    ("window_moved", _moved({"window": 7.0}), {"tolerance": 0.1}),
    ("tie_break", _moved({"stage": 3.0, "commit": 3.0}), {"tolerance": 0.1}),
    ("clean", [_lat_rec(f"r{i}", 100.0, BASE_STAGES) for i in range(6)], {"tolerance": 0.1}),
    ("no_decomposition", _no_decomposition(), {"tolerance": 0.1}),
    ("unattributed", _moved({}), {"tolerance": 0.1}),
    ("devprof_deltas", _moved({"stage": 4.0}, devprof=_dp(5, 70, 0.4),
                              base_devprof=_dp(3, 40, 0.1)), {"tolerance": 0.1}),
    ("explicit_row", _moved({"window": 7.0}), {"row": "serve_sustained", "tolerance": 0.1}),
    ("default_band", _moved({"commit": 1.0}, value=40.0), {}),
]


@pytest.mark.parametrize("name,records,kw", GATE_SETS, ids=[s[0] for s in GATE_SETS])
def test_evaluate_equals_the_reference(name, records, kw):
    ours = ledger.evaluate(copy.deepcopy(records), **kw)
    assert ours == jax_ledger.evaluate(copy.deepcopy(records), **kw)
    assert attribute(copy.deepcopy(records), **kw) == jax_attribute(copy.deepcopy(records), **kw)


@pytest.mark.parametrize("name,records,kw", ATTRIBUTION_SETS,
                         ids=[s[0] for s in ATTRIBUTION_SETS])
def test_attribute_equals_the_reference(name, records, kw):
    ours = attribute(copy.deepcopy(records), **kw)
    assert ours == jax_attribute(copy.deepcopy(records), **kw)
    assert ledger.evaluate(copy.deepcopy(records)) == jax_ledger.evaluate(copy.deepcopy(records))


def test_attribute_verdicts():
    """The attribution verdicts themselves, on the port alone."""
    verdicts = {name: attribute(copy.deepcopy(recs), **kw)
                for name, recs, kw in ATTRIBUTION_SETS}
    assert verdicts["window_moved"]["dominant_stage"] == "window"
    assert verdicts["tie_break"]["dominant_stage"] == "stage"
    assert verdicts["clean"]["verdict"] == "clean"
    assert verdicts["no_decomposition"]["verdict"] == "no-decomposition"
    assert verdicts["unattributed"]["verdict"] == "regression-unattributed"
    assert verdicts["devprof_deltas"]["devprof"]["delta"]["dispatches"] == 30
    with pytest.raises(ValueError):
        attribute(_moved({"window": 7.0}), row="nonexistent")
    with pytest.raises(ValueError, match="empty ledger"):
        ledger.evaluate([])


def _regressed(records):
    """The committed ledger with its last record regressed in every row's
    own bad direction."""
    bad = copy.deepcopy(records[-1])
    for row in bad["rows"]:
        if isinstance(row.get("value"), (int, float)):
            direction = ledger.DIRECTION_BY_UNIT.get(row.get("unit"), +1)
            row["value"] = row["value"] * 0.2 if direction > 0 else row["value"] * 5.0
    return copy.deepcopy(records) + [bad]


@pytest.mark.parametrize("variant", ["as_committed", "regressed"])
@pytest.mark.parametrize("match", ["device", "platform"])
def test_reference_ledger_reports_equal(variant, match):
    records = ledger.load_ledger(REFERENCE_LEDGER)
    assert records == jax_ledger.load_ledger(REFERENCE_LEDGER)
    if variant == "regressed":
        records = _regressed(records)
    ours = ledger.evaluate(copy.deepcopy(records), match=match)
    assert ours == jax_ledger.evaluate(copy.deepcopy(records), match=match)
    assert ours["regressed"] is (variant == "regressed")
    assert (attribute(copy.deepcopy(records), match=match)
            == jax_attribute(copy.deepcopy(records), match=match))


def test_record_schema_with_a_port_devprof_snapshot():
    p = DeviceProfiler().enable()
    p.observe_round("D8.ki8.kd8.km8.kp8", real_ops=10, padded_capacity=256)
    p.sample_memory()
    rows = [{"row": "streaming", "metric": "m", "value": 1.0, "unit": "ops/s", "docs": 64,
             "ops_per_doc": 96, "latency": {"stages_ms": {"commit": 1.0}}},
            {"row": "x", "metric": "y", "value": None, "unit": "s", "failed": True,
             "skipped": True}]
    kw = dict(config="test", sha="abc", device={"platform": "cpu", "kind": "cpu", "cpus": 8})
    record = ledger.ledger_record(rows, devprof=p.snapshot(), **kw)
    ref = jax_ledger.ledger_record(rows, devprof=p.snapshot(), **kw)
    assert record == ref
    assert set(record) == {"schema", "sha", "device", "config", "rows", "devprof"}
    assert record["schema"] == jax_ledger.SCHEMA_VERSION
    assert set(record["rows"][0]) == {"row", "metric", "value", "unit", "key", "latency"}
    assert record["rows"][0]["key"] == "docs=64,ops_per_doc=96"
    json.dumps(record)


def test_device_fingerprint_describes_the_host():
    fp = ledger.device_fingerprint()
    assert fp == {"platform": "cpu", "kind": "cpu", "cpus": os.cpu_count()}
    assert set(fp) == set(jax_ledger.device_fingerprint())
    record = ledger.ledger_record([], config="c")
    assert record["device"] == fp and record["sha"] == jax_ledger.git_sha()


def test_append_and_load(tmp_path):
    path = tmp_path / "sub" / "ledger.jsonl"
    records = [_record(1000.0), _record(950.0)]
    for rec in records:
        ledger.append_record(path, rec)
    assert ledger.load_ledger(path) == records == jax_ledger.load_ledger(path)
    assert path.read_text() == "".join(json.dumps(r, sort_keys=True) + "\n" for r in records)
    path.write_text(path.read_text() + "\n{not json}\n")
    with pytest.raises(ValueError, match=r"ledger.jsonl:4: corrupt"):
        ledger.load_ledger(path)
