#!/usr/bin/env python3
"""Run one cell of the benchmark of ``peritext_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; the harness makes the cell's inputs from ``--seed``, warms up,
drives ``StreamingMerge`` for ``--seconds`` (``harness/drive.py``), holds
what the window produced against the plain reference (``harness/verify.py``)
and prints one JSON line last: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from the program's spans
and a profiled slice of the window.  The numbers compared, each beside its
limit, are the last lines on standard error and the last key of the line.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
if the process has loaded JAX or the JAX package once the window is over.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: top-level module names the run may not hold: JAX and the JAX package
#: (compared whole: ``peritext_tpu_torch`` is the program under test)
FORBIDDEN = ("jax", "jaxlib", "flax", "peritext_tpu")
#: caches a kernel toolchain would write, kept inside the checkout at fixed
#: paths (the program builds its own libraries into peritext_tpu_torch/_build)
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def forbidden_modules():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = None, config=None, workers: int = 0, log=print) -> dict:
    """One run of ``cell``; returns the result line's object.  ``config``
    replaces the cell's configuration (the tests' small sizes)."""
    import numpy as np
    import torch

    from benchmark.harness import drive, spec, trace as tr, verify, workload
    from peritext_tpu_torch.obs import GLOBAL_TRACER

    t_start = T_START if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    config = config or spec.config(bench, cell["config"])
    traffic = spec.traffic(cell["traffic"])
    mode = spec.mode(traffic["mode"])

    wl = workload.build(config, traffic, seed, workers)
    caps = config["session"]
    most = {k: max(t[k] for t in wl.totals) for k in ("inserts", "deletes", "marks", "comments")}
    log("largest template against capacity: " + ", ".join(
        f"{k} {most[k]}/{caps[c]}" for k, c in (("inserts", "slot_capacity"),
                                                ("deletes", "tomb_capacity"),
                                                ("marks", "mark_capacity"),
                                                ("comments", "comment_capacity"))),
        file=sys.stderr)
    docs = verify.sample_docs(wl, seed, traffic["sample_per_class"])
    gc.freeze()  # the workload's objects stay out of the collector's walks
    spans = drive.Spans()
    driver = mode.Driver(config, traffic, wl, device, seed)
    driver.set_up(spans)
    spans.spans.clear()

    first, count = traffic["trace_steps"]
    hooks = tr.Slice(first, count, cuda) if trace else drive.Step()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    pauses = CollectorPauses()
    w0 = time.time()
    with tr.ProgramSpans(GLOBAL_TRACER) as program_spans, pauses:
        out = driver.window(seconds, spans, hooks, time.perf_counter)
    w1 = time.time()
    if trace:
        hooks.finish()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    log(window_line(out, spans.spans, pauses), file=sys.stderr)
    out["program"] = verify.program_outputs(driver.sess, docs)
    driver.sess = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    refs = verify.reference(wl, config, driver.needs(out, docs), workers=workers)
    checks = driver.check(out, refs, docs)
    attempted, failed = driver.tally(out, checks)
    log(f"reference: {len(refs)} sequences in {time.perf_counter() - t_ref:.3f} s",
        file=sys.stderr)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    result = {"correct": correct, "attempted": int(attempted), "failed": int(failed)}
    metrics = {}
    if not trace:
        values = {"setup_s": setup_s, "peak_mem_gb": peak / 1e9 if peak is not None else None,
                  **driver.end_to_end(out, log)}
        for m in spec.metrics_of(bench, "end_to_end", cell["name"]):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        work = verify.slice_work(wl, refs, driver.slice_steps(out, first, count)) \
            if hooks.kernels is not None or not cuda else None
        ctx = tr.Context((w0, w1), program_spans.spans, spans.spans, hooks, out.get("graphs"),
                         out["program"]["fallback_docs"], work)
        for m in spec.metrics_of(bench, "per_layer", cell["name"]):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        bd = tr.breakdown(ctx)
        if bd is not None:
            result["breakdown"] = bd
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak) if peak is not None else 0,
    }
    if trace and ctx.slice is not None:
        result["device"]["busy_s"] = ctx.device_busy_s()
        result["device"]["window_s"] = hooks.t1 - hooks.t0
        log(f"traced slice: {hooks.t1 - hooks.t0:.3f} s, {len(hooks.kernels)} device "
            f"operations, busy {result['device']['busy_s']:.3f} s; {hooks.note}, "
            f"{hooks.digest_s:.3f} device s", file=sys.stderr)
    result["checks"] = checks
    return result


class CollectorPauses:
    """The cyclic collector's passes while open: their count by generation
    and the seconds they took (``gc.callbacks``)."""

    def __init__(self) -> None:
        self.count = [0, 0, 0]
        self.seconds = 0.0
        self._t = None

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count[info["generation"]] += 1
            self._t = None

    def __enter__(self) -> "CollectorPauses":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def window_line(out: dict, spans, pauses: CollectorPauses) -> str:
    """What the window held, for the reader of a run's log: its steps'
    seconds, the sessions it built and the collector's passes."""
    steps = sorted(b - a for n, a, b in spans if n == "bench.digest")
    ends = [b for n, a, b in spans if n == "bench.digest"]
    starts = [a for n, a, b in spans if n == "bench.ingest"]
    per = [e - s for s, e in zip(starts, ends)]
    sessions = [b - a for n, a, b in spans if n == "bench.session"]
    text = f"window: {out['window_s']:.3f} s, {out['steps']} steps"
    if per:
        text += (f"; step s {' '.join(f'{x:.3f}' for x in per)}"
                 f"; digest s median {steps[len(steps) // 2]:.3f}")
    if sessions:
        text += f"; {len(sessions)} sessions built in {' '.join(f'{x:.3f}' for x in sessions)} s"
    return (text + f"; collector passes by generation {pauses.count} "
            f"in {pauses.seconds:.3f} s")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)

    from benchmark.harness import spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"device: {card_line()}", file=sys.stderr)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
