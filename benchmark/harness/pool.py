"""Jobs in worker processes, over pipes alone.

``run(fn, jobs, workers)`` deals the jobs (given costliest first) round
robin to ``workers`` Python processes, each started as ``python -m
benchmark.harness.pool`` from the checkout, which read one pickled chunk
on stdin and write their pickled results on stdout.  No shared memory and
no named semaphores (a ``multiprocessing`` pool keeps those under
``/dev/shm``); every worker is waited for before the call returns.
"""

from __future__ import annotations

import importlib
import pickle
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Sequence

ROOT = Path(__file__).resolve().parents[2]


def run(fn: Callable, jobs: Sequence, workers: int) -> List:
    """``[fn(job) for job in jobs]``, computed in up to ``workers`` processes."""
    workers = max(1, min(workers, len(jobs)))
    if workers == 1:
        return [fn(job) for job in jobs]
    chunks = [list(range(w, len(jobs), workers)) for w in range(workers)]
    procs = []
    try:
        for chunk in chunks:
            p = subprocess.Popen([sys.executable, "-m", "benchmark.harness.pool"], cwd=ROOT,
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE)
            procs.append(p)
            p.stdin.write(pickle.dumps((fn.__module__, fn.__qualname__,
                                        [jobs[i] for i in chunk])))
            p.stdin.close()
        out: List = [None] * len(jobs)
        for p, chunk in zip(procs, chunks):
            results = pickle.loads(p.stdout.read())
            if p.wait() != 0:
                raise RuntimeError(f"worker exited with code {p.returncode}")
            for i, r in zip(chunk, results):
                out[i] = r
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _serve() -> None:
    module, name, chunk = pickle.loads(sys.stdin.buffer.read())
    fn = getattr(importlib.import_module(module), name)
    sys.stdout.buffer.write(pickle.dumps([fn(job) for job in chunk]))
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    _serve()
