#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference put in
the program's place with one stated guarantee broken, judged by the same
comparison as a run.  It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--ticks N]

The guarantee broken is the delivery one every configuration states: a
change that arrives before its dependencies waits until they have applied.
The control replica drops such a change instead
(``reference.replay.Replica(buffered=False)``).  It drives the cell's own
traffic at the cell's own size, as its traffic kind's ``stand_in`` delivers
it: a jobs cell one whole job; a ticks cell the set-up and ``--ticks``
ticks (the number a window holds).  Needs no
card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def control(bench, cell, seed: int, ticks: int = 200, config=None, workers: int = 0) -> dict:
    """The checks of the control on ``cell``'s traffic from ``seed``."""
    from benchmark.harness import spec, verify, workload

    config = config or spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    wl = workload.build(config, traffic, seed, workers)
    docs = verify.sample_docs(wl, seed, traffic["sample_per_class"])
    driver = spec.mode(traffic["mode"]).Driver(config, traffic, wl, "cpu", seed)
    out = driver.stand_in(ticks)
    needs = driver.needs(out, docs)
    refs = verify.reference(wl, config, needs, workers=workers)
    ctrl = verify.reference(wl, config, needs, buffered=False, workers=workers)
    return driver.check(driver.from_reference(out, ctrl, docs), refs, docs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--ticks", type=int, default=200)
    args = parser.parse_args(argv)

    from benchmark.harness import spec

    bench = spec.load_benchmark()
    checks = control(bench, spec.cell(bench, args.workload), args.seed, args.ticks)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": correct,
                      "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
