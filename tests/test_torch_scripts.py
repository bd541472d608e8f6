"""The port's measurement scripts (``scripts/torch_*.py``, twins of the JAX
side's ``scripts/``) on the CPU at tiny sizes, against the reference package.

Each script runs in process through its ``main(argv)`` with ``--device
cpu`` and must exit 0 and print its JAX twin's lines, with the twin's
labels, in the twin's order; without ``--device cpu`` each exits non-zero
here (no card, no fallback).  Then, on the same seeded inputs:

* the engine profile's and the engine A/B's replay digests equal the
  reference ``StreamingMerge``'s digest of the same frames;
* the roofline's byte counts equal the twin's byte model on the
  reference's ``ops.packed.empty_docs`` and ``testing.synth`` streams;
* the weak-scaling probe digest is one value at 1, 2 and 4 CPU shards (and
  at 1 and 2 in the ragged layout), and equals the reference's meshless
  session on that probe;
* two chaos seeds give the reference ``run_chaos``'s final digests.

Digests are integers: equal exactly.
"""

import ast
import contextlib
import importlib.util
import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from peritext_tpu.ops.packed import empty_docs as jax_empty_docs
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.chaos import run_chaos as jax_run_chaos
from peritext_tpu.testing.fuzz import generate_workload as jax_generate_workload
from peritext_tpu.testing.synth import synth_streams as jax_synth_streams
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.testing.fuzz import generate_workload

ROOT = Path(__file__).resolve().parent.parent
ACTORS = ("doc1", "doc2", "doc3")

#: the engine scripts' shared workload: (docs, rounds, ops a doc); both
#: sessions at slots 384, marks 96, tombstones 384, round widths 256/128/128
ENGINE = (24, 2, 32)
ENGINE_ARGS = ["--docs", "24", "--rounds", "2", "--ops-per-doc", "32"]
ROOFLINE = dict(copy_docs=(4, 8, 16), docs=8, ops=64)
WEAK = dict(docs_per_device=8, ops=16, seed=11, sizes=(1, 2, 4))
CHAOS = dict(seeds=(0, 1), docs=2, ops=8)

#: each run: (script, argv at a tiny size, the twin's line labels in order)
RUNS = {
    "dispatch_latency": ("torch_dispatch_latency", ["--docs", "4", "--slots", "64"], [
        "chained x1:", "chained x4:", "chained x16:", "chained x64:", "tiny    x1:",
        "tiny    x64:"]),
    "apply_phase_cost": ("torch_apply_phase_cost", ["--docs", "4", "--slots", "128"], [
        "floor (8, 8, 8, 8) win=64:      ", "ins   (128,8,8,8) win=128: ",
        "ins   (128,8,8,8) win=384: ", "del   (8,128,8,8) win=64:  ",
        "mark  (8,8,128,8) win=64:  ", "map   (8,8,8,16)  win=64:  ",
        "r3mix (128,128,128,8) win=128: "]),
    "apply_phase_floor": ("torch_apply_phase_cost", ["--floor", "--docs", "4", "--slots", "128"], [
        "identity(+1 on counts):      ", "touch elem+char planes:      ",
        "touch ALL planes:            ", "floor apply impl=cuda", "floor apply impl=plain"]),
    "roofline": ("torch_roofline", [
        "--copy-docs", *map(str, ROOFLINE["copy_docs"]), "--docs", str(ROOFLINE["docs"]),
        "--ops-per-doc", str(ROOFLINE["ops"])], [
        "device: cpu", "copy d=     4:", "copy d=     8:", "copy d=    16:", "apply batch_8k:",
        "resolve:        "]),
    "engine_profile": ("torch_engine_profile", ENGINE_ARGS, ["{'docs': 24, 'rounds': 2"]),
    "engine_profile_fine": ("torch_engine_profile", ["--fine", *ENGINE_ARGS], [
        "round widths:", "bare fetch of ready tiny array:", "dispatch+fetch tiny:            ",
        "round 0 apply (dispatch+sync):", "round 1 apply (dispatch+sync):",
        "chained 2 applies + sync:   ", "digest (dispatch+sync):         ",
        "fused pipeline: pipelined"]),
    "engine_ab": ("torch_engine_ab", ENGINE_ARGS, [
        "live session (capture on):", "unfused: min", "fused: min",
        "live session (fused drain, warm compiles):"]),
    "ingest_profile": ("torch_ingest_profile", ["16"], [
        "docs=16 build=", "   Ordered by: cumulative time"]),
    "weak_scaling": ("torch_weak_scaling", [
        "--docs-per-device", str(WEAK["docs_per_device"]), "--ops-per-doc", str(WEAK["ops"]),
        "--seed", str(WEAK["seed"]), "--sizes", *map(str, WEAK["sizes"])], [
        '{"mesh_devices": 1,', '{"mesh_devices": 2,', '{"mesh_devices": 4,',
        '{"summary": "weak-scaling"']),
    "weak_scaling_ragged": ("torch_weak_scaling", [
        "--docs-per-device", str(WEAK["docs_per_device"]), "--ops-per-doc", str(WEAK["ops"]),
        "--seed", str(WEAK["seed"]), "--sizes", "1", "2", "--layout", "ragged"], [
        '{"mesh_devices": 1,', '{"mesh_devices": 2,', '{"summary": "weak-scaling"']),
    "chaos_soak": ("torch_chaos_soak", [
        "--seeds", str(len(CHAOS["seeds"])), "--docs", str(CHAOS["docs"]), "--ops",
        str(CHAOS["ops"]), "--no-transport", "--no-crash"], [
        "seed    0: ok", "seed    1: ok", "2/2 campaigns clean in", "  streaming."]),
}
#: the keys of the twins' result rows, in their order
ENGINE_ROW_KEYS = ["docs", "rounds", "staged_rounds", "ops", "apply_s", "apply_per_round_ms",
                   "digest_s", "total_s", "ops_per_sec"]
WEAK_ROW_KEYS = ["mesh_devices", "docs", "total_ops", "batch_seconds", "batch_ops_per_sec_total",
                 "batch_ops_per_sec_per_device", "streaming_seconds",
                 "streaming_ops_per_sec_total", "streaming_ops_per_sec_per_device",
                 "streaming_stage_seconds", "fixed_work_seconds", "fixed_work_ops_per_sec",
                 "touched_round_digest_seconds", "idle_round_digest_seconds",
                 "skewed_arrival_reshard", "probe_digest"]
SCRIPTS = sorted({script for script, _, _ in RUNS.values()})


def _script(name):
    spec = importlib.util.spec_from_file_location(f"scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def outputs():
    """Each run's exit code and printed lines, each run once per module."""
    cache = {}

    def run(key):
        if key not in cache:
            script, argv, _ = RUNS[key]
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = _script(script).main([*argv, "--device", "cpu"])
            cache[key] = rc, out.getvalue().splitlines()
        return cache[key]

    return run


def _line(lines, prefix):
    return next(line for line in lines if line.startswith(prefix))


@pytest.mark.parametrize("key", sorted(RUNS))
def test_script_prints_its_twins_lines_in_order(outputs, key):
    rc, lines = outputs(key)
    assert rc == 0
    assert lines[0] == "device: cpu"
    at = 0
    for label in RUNS[key][2]:
        hits = [i for i, line in enumerate(lines) if i >= at and line.startswith(label)]
        assert hits, f"{key}: no line {label!r} after line {at}:\n" + "\n".join(lines)
        at = hits[0] + 1


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_without_a_card_exits_nonzero(script, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    assert _script(script).main([]) != 0
    out, err = capsys.readouterr()
    assert "no CUDA device" in err and not out


def test_result_rows_keep_the_twins_keys(outputs):
    _, lines = outputs("engine_profile")
    row = ast.literal_eval(_line(lines, "{'docs'"))  # the twin prints the row's repr
    assert list(row) == ENGINE_ROW_KEYS
    _, lines = outputs("weak_scaling")
    rows = [json.loads(line) for line in lines if line.startswith('{"mesh_devices"')]
    assert [r["mesh_devices"] for r in rows] == list(WEAK["sizes"])
    assert all(list(r) == WEAK_ROW_KEYS for r in rows)


@pytest.fixture(scope="module")
def reference_engine_digest():
    """The reference session's digest of the engine scripts' frames."""
    docs, rounds, opd = ENGINE
    frames = build_arrival(generate_workload(0, docs, opd), rounds, 0, as_frames=True)[0]
    s = JaxStreamingMerge(num_docs=docs, actors=ACTORS, slot_capacity=384, mark_capacity=96,
                          tomb_capacity=384, round_insert_capacity=256,
                          round_delete_capacity=128, round_mark_capacity=128)
    for r in range(rounds):
        s.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
        s.drain()
    assert s.overflow_count() == 0
    return s.digest()


def _hex_after(line, word):
    return int(re.search(word + r" (0x[0-9a-f]+)", line).group(1), 16)


def test_engine_profile_replay_digest_equals_the_reference(outputs, reference_engine_digest):
    _, lines = outputs("engine_profile")
    line = _line(lines, "engine replay:")
    assert _hex_after(line, "digest") == _hex_after(line, "session") == reference_engine_digest
    _, lines = outputs("engine_profile_fine")
    assert _hex_after(_line(lines, "fused pipeline digest"), "digest") == reference_engine_digest


def test_engine_ab_digests_equal_the_reference(outputs, reference_engine_digest):
    _, lines = outputs("engine_ab")
    assert _hex_after(_line(lines, "digests:"), "session") == reference_engine_digest


def _state_bytes(st):
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in st)


def test_roofline_bytes_equal_the_twins_model(outputs):
    _, lines = outputs("roofline")
    got = dict(item.rsplit(" ", 1) for item in _line(lines, "bytes: ")[7:].split(", "))
    got = {k: int(v) for k, v in got.items()}
    want = {f"copy_{d}_state": _state_bytes(jax_empty_docs(d, 384, 96, tomb_capacity=64))
            for d in ROOFLINE["copy_docs"]}
    d, k = ROOFLINE["docs"], ROOFLINE["ops"]
    ki, kd = int(k * 0.7), int(k * 0.15)
    km = k - ki - kd
    streams = jax_synth_streams(d, inserts_per_doc=ki, deletes_per_doc=kd, marks_per_doc=km,
                                seed=0)
    sb = _state_bytes(jax_empty_docs(d, 384, max(96, km), tomb_capacity=max(kd, 8)))
    stream_b = sum(int(np.prod(np.shape(x))) * 4 for x in jax.tree.leaves(streams))
    want.update(batch_state=sb, batch_streams=stream_b, apply_min_moved=2 * sb + stream_b,
                resolve_min_moved=sb + 3 * d * 384 * 4,
                batch_ops=int(streams[1].size + streams[3].size + streams[4]["m_action"].size))
    assert got == want


@pytest.fixture(scope="module")
def reference_probe_digest():
    """The reference's meshless session's digest of the weak-scaling probe."""
    probe = jax_generate_workload(WEAK["seed"] ^ 0xD16, num_docs=16, ops_per_doc=48)
    ref = JaxStreamingMerge(num_docs=16, actors=ACTORS, slot_capacity=256, mark_capacity=128,
                            tomb_capacity=128)
    for d, w in enumerate(probe):
        ref.ingest(d, [ch for log in w.values() for ch in log])
    ref.drain()
    return ref.digest()


@pytest.mark.parametrize("key", ["weak_scaling", "weak_scaling_ragged"])
def test_weak_scaling_probe_digest_is_mesh_invariant_and_the_references(
        outputs, reference_probe_digest, key):
    _, lines = outputs(key)
    digests = {r["mesh_devices"]: r["probe_digest"]
               for r in (json.loads(line) for line in lines if line.startswith("{"))
               if "mesh_devices" in r}
    assert list(digests) == ([1, 2, 4] if key == "weak_scaling" else [1, 2])
    assert set(digests.values()) == {reference_probe_digest}
    assert json.loads(lines[-1])["probe_digest"] == reference_probe_digest


def test_chaos_seeds_equal_the_reference(outputs):
    _, lines = outputs("chaos_soak")
    for seed in CHAOS["seeds"]:
        report = jax_run_chaos(seed, num_docs=CHAOS["docs"], ops_per_doc=CHAOS["ops"],
                               transport=False, crash=False)
        line = _line(lines, f"seed {seed:4d}: ok")
        assert int(line.rsplit("digest=", 1)[1], 16) == report.final_digest
