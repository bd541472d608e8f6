"""Process-local counters and the composed health snapshot."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional


class Counters:
    """A registry of named monotone counters and accumulated timings (the
    session's ``streaming.*``, the supervisor's ``supervisor.*``, the serve
    tier's ``serve.*``).  Three of them count the commits' insert launches,
    one each: ``streaming.block_applies`` (padded: one per touched read
    block of a round), ``streaming.group_applies`` (paged: one per page
    group of a round) and ``streaming.ragged_applies`` (ragged: one per
    non-empty doc class of a round's plan).  A lock guards every read and
    update: an editor's change queue flushes on a timer thread, and a
    guarded round runs on the supervisor's watchdog thread.  Every value is
    a float, as in the reference, so a snapshot serializes to the same JSON
    (``1.0``, not ``1``); compare it with ints, and ``int()`` it before a
    ``%d`` or a ``range``."""

    def __init__(self) -> None:
        self._values: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._values[name] += value

    def get(self, name: str) -> float:
        with self._lock:
            return self._values.get(name, 0.0)

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - start)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._values)

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


#: Default process-wide counters.
GLOBAL_COUNTERS = Counters()


#: counter/histogram namespaces that make up the fault-domain health surface
_HEALTH_PREFIXES = ("streaming.", "transport.", "supervisor.", "merge.",
                    "jit.", "convergence.", "serve.", "fleet.", "plan.",
                    "incident.", "kernel.")


def health_snapshot(
    counters: Optional[Counters] = None,
    session=None,
    sentinel=None,
    histograms=None,
    recorder=None,
    convergence=None,
    devprof=None,
    serve=None,
    fleet=None,
    plan=None,
    mesh=None,
    latency=None,
    incidents=None,
    history=None,
) -> Dict[str, Any]:
    """One structured dict for a health endpoint: every fault-domain
    counter (quarantines, corrupt frames, supervisor rollbacks, guarded-merge
    fallbacks, serve verdicts) and the fault-domain histogram percentiles,
    plus, for each plane given, its own view: ``session`` (a streaming
    session or a :class:`~..parallel.supervisor.GuardedSession`: its
    ``health()``), ``recorder`` (a :class:`~.recorder.FlightRecorder`),
    ``serve`` (a :class:`~..serve.SessionMux`), ``latency`` (a
    :class:`~.latency.LatencyPlane`), ``history`` (a
    :class:`~.timeseries.TimeSeriesPlane` or a dict), ``devprof`` (a
    :class:`~.devprof.DeviceProfiler`), ``sentinel`` (a
    :class:`~.sentinel.RecompileSentinel`: its per-library ``counts`` and
    ``total`` under ``recompiles``; its ``kernel.*`` counters land under
    ``counters``).  The other keywords take any object with the same
    ``snapshot()``; ``plan`` takes a :class:`~..plan.tuner.PlanProposal`
    (its ``to_json()``) or a dict, and ``mesh`` a dict (the device mesh is
    still to port).  Everything in the snapshot is JSON-serializable."""
    from .histograms import GLOBAL_HISTOGRAMS

    counters = counters or GLOBAL_COUNTERS
    histograms = histograms if histograms is not None else GLOBAL_HISTOGRAMS
    out: Dict[str, Any] = {
        "counters": {
            k: v
            for k, v in sorted(counters.snapshot().items())
            if k.startswith(_HEALTH_PREFIXES)
        },
        "histograms": {
            name: snap
            for name, snap in sorted(histograms.snapshot().items())
            if name.startswith(_HEALTH_PREFIXES)
        },
    }
    if session is not None:
        out["session"] = session.health()
    if sentinel is not None:
        out["recompiles"] = {
            "sites": dict(sorted(sentinel.counts.items())),
            "total": sentinel.total,
        }
    if recorder is not None:
        out["flight_recorder"] = recorder.snapshot()
    if convergence is not None:
        out["convergence"] = convergence.snapshot()
    if devprof is not None:
        out["devprof"] = devprof.snapshot()
    if serve is not None:
        out["serve"] = serve.snapshot()
    if fleet is not None:
        out["fleet"] = fleet.snapshot()
    if plan is not None:
        out["plan"] = (
            plan.to_json() if hasattr(plan, "to_json") else dict(plan)
        )
    if mesh is not None:
        out["mesh"] = dict(mesh)
    if latency is not None:
        out["latency"] = latency.snapshot()
    if incidents is not None:
        out["incidents"] = incidents.snapshot()
    if history is not None:
        out["history"] = (
            history.snapshot() if hasattr(history, "snapshot")
            else dict(history)
        )
    return out
