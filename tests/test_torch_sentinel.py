"""The port's build sentinel (``peritext_tpu_torch/obs/sentinel.py``): it
counts the kernel builders' build and load records per library.

* Unit behaviour: records of ``utils/nvcc.py``'s and ``native/``'s forms
  counted per library and kind, on the sentinel and as ``kernel.*``
  counters; prefixed records counted, foreign ones ignored; ``mark`` /
  ``since_mark`` / ``assert_steady_state``; start/stop restore the
  logger.
* What reads it: ``health_snapshot(sentinel=)``, ``prometheus_text``'s
  ``peritext_recompiles_total``, and the incident monitor's
  recompile-storm, fed as the reference's monitor is fed its sentinel.
* The builders themselves: ``load_library`` logs one load per process and
  library (a build only when the library is missing), and a fresh process
  that loads the native host library twice logs exactly one load.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest

from peritext_tpu.obs import IncidentMonitor as JaxMonitor
from peritext_tpu_torch.obs import (
    Counters,
    IncidentMonitor,
    RecompileSentinel,
    health_snapshot,
    prometheus_text,
)
from peritext_tpu_torch.obs.sentinel import KERNEL_LOGGER
from peritext_tpu_torch.observability import _BUILD_MSG_RE
from peritext_tpu_torch.utils import nvcc

ROOT = Path(__file__).resolve().parents[1]
log = logging.getLogger(KERNEL_LOGGER)


def _build_and_load(lib):
    log.info("Building %s with nvcc into %s-0.so", lib, lib)
    log.info("Loading %s from %s-0.so", lib, lib)


def test_counts_builds_and_loads_per_library():
    counters = Counters()
    with RecompileSentinel(counters=counters) as s:
        _build_and_load("insert")
        log.info("Loading ragged_insert from ragged_insert-0.so")
        log.info("Building native with g++ into libptnative-0.so")
        log.info("Loading native from libptnative-0.so")
    assert s.builds == {"insert": 1, "native": 1}
    assert s.loads == {"insert": 1, "ragged_insert": 1, "native": 1}
    assert s.counts == {"insert": 2, "ragged_insert": 1, "native": 2}
    assert s.total == 5
    assert counters.snapshot() == {"kernel.builds.insert": 1.0, "kernel.loads.insert": 1.0,
                                   "kernel.loads.ragged_insert": 1.0,
                                   "kernel.builds.native": 1.0, "kernel.loads.native": 1.0}


def test_records_after_stop_are_not_counted():
    with RecompileSentinel(counters=Counters()) as s:
        _build_and_load("insert")
    _build_and_load("insert")
    assert s.total == 2 and s not in log.handlers


@pytest.mark.parametrize("message", [
    "2026-01-01 12:00:00 INFO Building insert with nvcc into insert-ab.so",
    "first line\nLoading insert from insert-ab.so",
])
def test_prefixed_and_multiline_records_count(message):
    with RecompileSentinel(counters=Counters()) as s:
        log.info(message)
    assert s.counts == {"insert": 1}


@pytest.mark.parametrize("message", [
    "Rebuilding the index", "no build here", "loading docs", "Building",
])
def test_foreign_records_are_ignored(message):
    with RecompileSentinel(counters=Counters()) as s:
        log.info(message)
    # a malformed record never raises into the workload
    s.emit(logging.LogRecord(KERNEL_LOGGER, logging.INFO, __file__, 1, "Building %s %s",
                             ("insert",), None))
    assert s.counts == {} and s.total == 0


def test_regex_names_the_kind_and_library():
    m = _BUILD_MSG_RE.search("Loading ragged_insert from x.so")
    assert m.groups() == ("Loading", "ragged_insert")


def test_mark_since_mark_and_steady_state():
    with RecompileSentinel(counters=Counters()) as s:
        _build_and_load("insert")
        s.mark()
        assert s.since_mark() == {}
        s.assert_steady_state("warm rounds")
        log.info("Loading native from libptnative-0.so")
        assert s.since_mark() == {"native": 1}
        with pytest.raises(AssertionError, match="built or loaded 1 kernel library"):
            s.assert_steady_state("steady rounds")


def test_start_stop_restore_the_logger_level():
    logger = logging.getLogger(KERNEL_LOGGER)
    before = logger.level
    outer = RecompileSentinel(counters=Counters()).start()
    inner = RecompileSentinel(counters=Counters()).start()
    assert outer.start() is outer  # idempotent
    _build_and_load("insert")
    inner.stop()
    _build_and_load("insert")
    outer.stop()
    outer.stop()
    assert (inner.total, outer.total) == (2, 4)
    assert logger.level == before


def test_health_snapshot_and_prometheus_read_it():
    counters = Counters()
    with RecompileSentinel(counters=counters) as s:
        _build_and_load("ragged_insert")
    snap = health_snapshot(counters=counters, sentinel=s)
    assert snap["recompiles"] == {"sites": {"ragged_insert": 2}, "total": 2}
    assert snap["counters"] == {"kernel.builds.ragged_insert": 1.0,
                                "kernel.loads.ragged_insert": 1.0}
    json.dumps(snap)
    text = prometheus_text(counters=counters, sentinel=s)
    assert "peritext_recompiles_total 2\n" in text
    assert "peritext_kernel_loads_ragged_insert 1\n" in text


def test_incident_monitor_reads_it_as_the_reference_reads_its_sentinel():
    """A burst of builds past the storm threshold opens a recompile-storm;
    the port's monitor fed the port's sentinel and the reference's fed
    the same totals agree."""
    ours, ref = IncidentMonitor(host="h"), JaxMonitor(host="h")
    with RecompileSentinel(counters=Counters()) as s:
        for rnd in range(4):
            if rnd == 1:
                for lib in ("insert", "ragged_insert", "native"):
                    _build_and_load(lib)
            ours.observe_sentinel(s)
            ref.observe_sentinel({"total": s.total})
            ours.advance_round()
            ref.advance_round()
    assert ours.incident_kinds() == ref.incident_kinds()
    assert "recompile-storm" in [i["kind"] for i in ours.snapshot()["incidents"]]
    assert ours.digest() == ref.digest()


def test_load_library_logs_one_load_per_process(monkeypatch, tmp_path):
    """``load_library``: a present library is loaded (one record) and never
    built; a second call loads nothing."""
    loaded = []
    monkeypatch.setattr(nvcc, "_loaded", {})
    monkeypatch.setattr(nvcc, "build_libraries", lambda names: {n: tmp_path / f"{n}.so"
                                                                for n in names})
    monkeypatch.setattr(nvcc.ctypes, "CDLL", lambda path: loaded.append(path) or object())
    with RecompileSentinel(counters=Counters()) as s:
        nvcc.load_library("insert")
        nvcc.load_library("insert")
    assert s.loads == {"insert": 1} and s.builds == {} and len(loaded) == 1


def test_native_library_loads_once_in_a_fresh_process():
    code = (
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from peritext_tpu_torch.obs import Counters, RecompileSentinel\n"
        "from peritext_tpu_torch import native\n"
        "with RecompileSentinel(counters=Counters()) as s:\n"
        "    first = native.load()\n"
        "    assert native.load() is first\n"
        "print(json.dumps([s.loads, s.builds, first is not None]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=180, check=True).stdout
    loads, builds, available = json.loads(out.splitlines()[-1])
    assert available and loads == {"native": 1}, out
    # built only when this checkout had no library yet
    assert builds in ({}, {"native": 1}), out
