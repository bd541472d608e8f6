"""Back-compat shim, as the reference package keeps one: the observability
layer is the :mod:`peritext_tpu_torch.obs` package (spans, histograms,
flight recorder, device profiler, exporters — see its docstring).  Every
name here re-exports from there, unchanged in identity
(``GLOBAL_COUNTERS`` here IS ``peritext_tpu_torch.obs.GLOBAL_COUNTERS``).
New code should import from :mod:`peritext_tpu_torch.obs` directly.
"""

from __future__ import annotations

from .obs import (  # noqa: F401
    ConvergenceMonitor,
    Counters,
    EventLog,
    FlightRecorder,
    GLOBAL_COUNTERS,
    GLOBAL_HISTOGRAMS,
    GLOBAL_TRACER,
    Histogram,
    HistogramRegistry,
    LATENCY_BUCKETS_S,
    MergeStats,
    MetricsServer,
    RecompileSentinel,
    SIZE_BUCKETS,
    Span,
    TraceContext,
    Tracer,
    health_snapshot,
    merge_traces,
    profile_trace,
    prometheus_text,
)
from .obs.metrics import _HEALTH_PREFIXES  # noqa: F401
from .obs.sentinel import _BUILD_MSG_RE  # noqa: F401

__all__ = [
    "ConvergenceMonitor",
    "Counters",
    "EventLog",
    "FlightRecorder",
    "GLOBAL_COUNTERS",
    "GLOBAL_HISTOGRAMS",
    "GLOBAL_TRACER",
    "Histogram",
    "HistogramRegistry",
    "LATENCY_BUCKETS_S",
    "MergeStats",
    "MetricsServer",
    "RecompileSentinel",
    "SIZE_BUCKETS",
    "Span",
    "TraceContext",
    "Tracer",
    "health_snapshot",
    "merge_traces",
    "profile_trace",
    "prometheus_text",
]
