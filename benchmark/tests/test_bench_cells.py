"""Each cell's traffic driven through the harness at a tiny size on the
CPU, its result line's shape, and the correctness check's failures: the
control and the faults a cell can have must come out as not correct."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT, tiny_config

from benchmark import control as control_mod
from benchmark import run
from benchmark.harness import spec

SEED = 2**31 + 12345


#: a cell of the ``ticks`` traffic kind, which no cell of ``BENCHMARK.json``
#: uses yet: its traffic file and kind stay driven and checked here
TICKS = {"name": "cfg4_mixed10k.hot_ticks", "config": "cfg4_mixed10k",
         "traffic": "hot_ticks", "chips": 1, "why": "the ticks traffic kind"}


def _cells(bench=None):
    return [w["name"] for w in (bench or spec.load_benchmark())["workloads"]] + [TICKS["name"]]


def _cell(bench, name):
    return TICKS if name == TICKS["name"] else spec.cell(bench, name)


def _run(bench, name, trace=False, seconds=1.0):
    cell = _cell(bench, name)
    return run.run_cell(bench, cell, SEED, seconds, trace, device="cpu",
                        config=tiny_config(bench, cell), workers=1,
                        log=lambda *a, **k: None)


@pytest.mark.parametrize("name", _cells())
def test_cell_runs_correct_on_cpu(bench, name):
    res = _run(bench, name)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["limit"] == 0 and c["value"] == 0 for c in res["checks"].values())
    want = {m["name"] for m in spec.metrics_of(bench, "end_to_end", name)}
    assert want - {"peak_mem_gb"} <= set(res["metrics"])  # no card: no allocator peak
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("name", _cells())
def test_cell_traced_reads_span_metrics_on_cpu(bench, name):
    res = _run(bench, name, trace=True)
    assert res["correct"] is True
    if name == TICKS["name"]:
        return  # no per-layer metric of BENCHMARK.json lists it
    names = set(res["metrics"])
    for stem in ("ingest_frac", "schedule_frac", "digest_frac", "fallback_docs"):
        assert any(n.startswith(stem + ".") for n in names), (stem, names)
    # device readings exist only with a card: no share of a roofline on the CPU
    assert not any("roofline" in n or "device_idle" in n for n in names)
    assert res["metrics"][[n for n in names if n.startswith("fallback_docs")][0]]["value"] == 0


def test_same_seed_same_inputs(bench):
    from benchmark.harness import workload

    cell = spec.cell(bench, "cfg4_mixed10k.jobs")
    cfg, traffic = tiny_config(bench, cell), spec.traffic(cell["traffic"])
    a = workload.build(cfg, traffic, SEED, 1)
    b = workload.build(cfg, traffic, SEED, 1)
    c = workload.build(cfg, traffic, SEED + 1, 1)
    assert a.frames == b.frames and (a.seq_of == b.seq_of).all()
    assert a.frames != c.frames


@pytest.mark.parametrize("name", _cells())
def test_control_is_not_correct(bench, name):
    cell = _cell(bench, name)
    checks = control_mod.control(bench, cell, SEED, ticks=30,
                                 config=tiny_config(bench, cell, docs=48, ops=120), workers=1)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _unchanged_drain(self, max_rounds=1_000):
    return 0  # a step that leaves the state as it was


def _half_batch(orig):
    def ingest_frames(self, items, on_corrupt="raise"):
        return orig(self, list(items)[::2], on_corrupt)
    return ingest_frames


def _altered_answer(orig):
    def wait(self):
        return orig(self) ^ 1
    return wait


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
@pytest.mark.parametrize("name", _cells())
def test_fault_is_not_correct(bench, name, fault, monkeypatch):
    from peritext_tpu_torch.parallel import streaming

    if fault == "state_unchanged":
        monkeypatch.setattr(streaming.StreamingMerge, "drain", _unchanged_drain)
    elif fault == "half_batch":
        monkeypatch.setattr(streaming.StreamingMerge, "ingest_frames",
                            _half_batch(streaming.StreamingMerge.ingest_frames))
    else:
        monkeypatch.setattr(streaming._PendingDigest, "wait",
                            _altered_answer(streaming._PendingDigest.wait))
    res = _run(bench, name)
    assert res["correct"] is False, res["checks"]


def test_run_without_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cfg4_mixed10k.jobs",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)})
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_result_line_is_json(bench):
    res = _run(bench, "cfg5b_100k.jobs")
    line = json.dumps(res)
    assert json.loads(line)["device"]["count"] == 1


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, device, start, end, thread=1, link=0, kernels=(), note=False):
        self.name, self.device_type, self.thread = name, device, thread
        self.time_range = _Range(start, end)
        self.linked_correlation_id = link
        self.kernels = [_Kernel(d) for d in kernels]
        self.is_user_annotation = note


class _Kernel:
    def __init__(self, duration):
        self.duration = duration


def test_digest_device_time_is_what_the_digest_launched():
    """The digest's device time counts the device operations launched by
    host operations inside the digest's range, not those that ran during
    it: the drain's kernels that run into the digest stay the drain's, and
    the staging thread's are its own."""
    import torch

    from benchmark.harness.trace import device_ops

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    class Prof:
        def events(self):
            return [
                _Event("bench.anchor", cpu, 0, 1),
                _Event("aten::apply", cpu, 10, 20, kernels=[35e6]),  # the drain's launch
                _Event("bench.digest", cpu, 30, 90, kernels=[1e6]),  # a graph it launched
                _Event("aten::resolve", cpu, 40, 50, kernels=[20e6, 2e6]),
                _Event("cudaLaunchKernel", cpu, 41, 42, link=4, kernels=[20e6]),
                _Event("aten::stage", cpu, 45, 46, thread=2, kernels=[1e6]),
                _Event("apply_kernel", cuda, 25, 60),
                _Event("resolve_kernel", cuda, 60, 80),
                _Event("bench.digest", cuda, 60, 80, note=True),  # the range's device copy
            ]

    ops, digest_s, _ = device_ops(Prof(), 100.0)
    assert [n for n, _, _ in ops] == ["apply_kernel", "resolve_kernel"]
    assert digest_s == 23.0
    assert ops[0][1] == 100.0 + 25e-6
