"""``BENCHMARK.json`` against the rules a benchmark definition keeps, the
harness's parts found by name, the imports the harness and the reference
may not make, the frozen copies against the program they were copied
from, and the configurations' capacities on their own templates."""

import json
import random
import re
import subprocess
import sys

import pytest
from conftest import ROOT

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(bench, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = spec.metrics_of(bench, "per_layer", w["name"])
        assert per and all(m["moves"] in e2e for m in per)


def test_parts_found_by_name(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        assert spec.config(bench, c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        assert spec.mode(spec.traffic(w["traffic"])["mode"]).Driver
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


KIND_PARTS = ("set_up", "window", "stand_in", "needs", "from_reference", "check", "tally",
              "end_to_end", "slice_steps")


@pytest.mark.parametrize("traffic", sorted(p.stem for p in (ROOT / "benchmark" / "traffic")
                                           .glob("*.json")))
def test_every_traffic_file_names_a_kind_with_every_part(traffic):
    kind = spec.mode(spec.traffic(traffic)["mode"])
    assert callable(kind.cut_frames)
    assert all(callable(getattr(kind.Driver, part)) for part in KIND_PARTS)


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests')\n"
            "from conftest import tiny_config\n"
            "from benchmark import run\n"
            "from benchmark.harness import spec\n"
            "b = spec.load_benchmark()\n"
            "ticks = dict(name='t', config='cfg4_mixed10k', traffic='hot_ticks', chips=1)\n"
            "for c in (spec.cell(b, 'cfg4_mixed10k.jobs'), ticks):\n"
            "    run.run_cell(b, c, 7, 0.5, True, device='cpu', config=tiny_config(b, c),"
            " workers=1, log=lambda *a, **k: None)\n")
    mods = _modules_after(code)
    assert "peritext_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "peritext_tpu"}


def test_reference_and_generators_load_nothing_of_the_program():
    mods = _modules_after("import benchmark.reference.replay, benchmark.gen.fuzz, "
                          "benchmark.gen.codec, benchmark.gen.arrival, benchmark.harness.workload,"
                          " benchmark.harness.verify")
    assert not mods & {"jax", "jaxlib", "flax", "peritext_tpu", "peritext_tpu_torch", "torch"}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "peritext_tpu_torch_x", sys)
    assert "peritext_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("seed,ops", [(31, 120), (2**33 + 7, 900)])
def test_frozen_generator_and_encoder_match_the_program(seed, ops):
    from benchmark.gen.arrival import fifo_order
    from benchmark.gen.codec import encode_frame
    from benchmark.gen.fuzz import session
    from peritext_tpu_torch.core.types import Change
    from peritext_tpu_torch.parallel.codec import encode_frame as program_encode
    from peritext_tpu_torch.testing.arrival import fifo_order as program_fifo
    from peritext_tpu_torch.testing.fuzz import generate_workload

    ours = session(seed, ops)
    theirs = generate_workload(seed, 1, ops)[0]
    assert {a: [c.to_json() for c in log] for a, log in ours.items()} == \
        {a: [c.to_json() for c in log] for a, log in theirs.items()}
    order = fifo_order(ours, random.Random(5))
    assert [c.to_json() for c in order] == \
        [c.to_json() for c in program_fifo(theirs, random.Random(5))]
    for lo in range(0, len(order), 17):
        batch = order[lo:lo + 17]
        assert encode_frame(batch) == program_encode([Change.from_json(c.to_json())
                                                      for c in batch])


def test_reference_digest_matches_the_program_on_cpu():
    from benchmark.gen.arrival import fifo_order
    from benchmark.gen.codec import encode_frame
    from benchmark.gen.fuzz import session
    from benchmark.reference.digest import M32, actor_index
    from benchmark.reference.replay import replay
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    actors = ("doc1", "doc2", "doc3")
    seqs = []
    for d in range(4):
        order = fifo_order(session(50 + d, 90), random.Random(d))
        seqs.append([order[i:i + 20] for i in range(0, len(order), 20)])
    sess = StreamingMerge(num_docs=4, actors=actors, slot_capacity=256, device="cpu")
    for k in range(1, 4):
        sess.ingest_frames([(d, encode_frame(s[k - 1])) for d, s in enumerate(seqs)])
        sess.drain()
        got = sess.digest_async().wait()
        refs = [replay(s, [k], 256, actor_index(actors), spans_at=[k]) for s in seqs]
        assert got == sum(r["digests"][k] for r in refs) & M32
        assert all(sess.read(d) == refs[d]["spans"][k] for d in range(4))


@pytest.mark.parametrize("config", ["cfg4_mixed10k", "cfg5b_100k"])
def test_capacities_hold_the_templates(bench, config):
    """Each class's templates at their own lengths (two a class, the long
    class's one) fit the session's capacities with no fallback, through a
    small CPU session at those capacities."""
    from benchmark.harness import workload
    from benchmark.harness.drive import make_session

    cfg = spec.config(bench, config)
    cap = cfg["session"]
    traffic = {"mode": "jobs", "rounds": 4}
    cls = [dict(c, docs=2 if c["ops"] < 2048 else 1, templates=2 if c["ops"] < 2048 else 1)
           for c in cfg["classes"]]
    small = dict(cfg, classes=cls, variants=1, docs=sum(c["docs"] for c in cls))
    wl = workload.build(small, traffic, 2**31 + 9, workers=1)
    for t in wl.totals:
        assert t["inserts"] <= cap["slot_capacity"] and t["deletes"] <= cap["tomb_capacity"]
        assert t["marks"] <= cap["mark_capacity"] and t["comments"] <= cap["comment_capacity"]
    small["read_chunk"] = wl.num_docs
    sess = make_session(small, "cpu", wl.num_docs)
    for r in range(4):
        sess.ingest_frames([(d, wl.frames_of(d)[r]) for d in range(wl.num_docs)])
        sess.drain()
    sess.digest_async().wait()
    assert not any(s.fallback for s in sess.docs) and sess.overflow_count() == 0


def test_cuda_cell_runs_on_the_card(bench, cuda_card):
    from conftest import tiny_config

    from benchmark import run

    cell = spec.cell(bench, "cfg4_mixed10k.jobs")
    res = run.run_cell(bench, cell, 2**31 + 3, 2.0, True, device="cuda",
                       config=tiny_config(bench, cell, docs=256, ops=120), workers=2)
    assert res["correct"] is True and res["device"]["busy_s"] > 0
