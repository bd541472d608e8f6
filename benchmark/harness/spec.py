"""Finding a cell's parts by name: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and metrics; each lives in a file of its own
under this folder, which a later change adds without editing one that is
there.

* a configuration: ``configs/<name>.json`` (the entry's ``file``);
* a traffic mix: ``traffic/<name>.json``, parameters of its ``mode``, the
  traffic kind: ``modes/<mode>.py`` cuts the frames, drives the session,
  names what the reference replays, checks the outputs and gives the
  end-to-end values (``modes/jobs.py`` sets out the interface);
* a per-layer metric: ``metrics/<name>.py``, or, for a name with a suffix
  (``ingest_frac.ops``), ``metrics/<stem>.py`` where the first is absent.
  Its ``read(ctx)`` returns the value, or None where it finds nothing.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout


def load_benchmark(path: Optional[Path] = None) -> Dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def mode(name: str):
    """The module of traffic kind ``name``."""
    if not (HERE / "modes" / f"{name}.py").exists():
        raise SystemExit(f"no traffic kind {name!r} under modes/")
    return importlib.import_module(f"benchmark.modes.{name}")


def metrics_of(bench: Dict, section: str, workload: str) -> List[Dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those without a ``workloads`` list, and those whose
    list names it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` function of a per-layer metric."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise SystemExit(f"no reader for per-layer metric {name!r} under metrics/")
