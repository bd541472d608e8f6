"""peritext_tpu_torch.obs — the host telemetry planes.

* :mod:`.stats` — ``MergeStats``, the per-merge / per-round report, and
  the synchronizing ``stage_timer`` that fills it;
* :mod:`.metrics` — named counters (``GLOBAL_COUNTERS``) and the composed
  ``health_snapshot``;
* :mod:`.spans` — nested pipeline spans (:class:`Tracer`) with sinks and
  Chrome trace-event export, correlated across hosts by the wire-carried
  :class:`TraceContext`;
* :mod:`.histograms` — fixed-bucket histograms with percentile readout,
  and the rolling window behind the supervisor's deadline autotuning and
  the serve mux's batching window;
* :mod:`.recorder` — the flight recorder: a ring of recent spans and
  events, dumped as JSONL on quarantine and rollback;
* :mod:`.latency` — the time-to-visibility plane the serve tier feeds;
* :mod:`.timeseries` — the round-counted history plane, with the fused
  serving tier's occupancy channel;
* :mod:`.convergence` — per-peer replication-lag watermarks and
  divergence probes over the multihost frontier exchanges.

Every plane is host-side: none synchronizes the card.  The device planes
(a cost and memory profiler, a build sentinel, the perf ledger) are still
to port.
"""

from .convergence import (
    CONVERGED,
    DIVERGENCE,
    LAG,
    ConvergenceMonitor,
    DivergenceIncident,
    PeerLag,
    clock_delta_ops,
    clocks_equal,
)
from .histograms import (
    GLOBAL_HISTOGRAMS,
    Histogram,
    HistogramRegistry,
    LATENCY_BUCKETS_S,
    SIZE_BUCKETS,
)
from .latency import (
    GLOBAL_LATENCY,
    LatencyPlane,
    STAGES,
    check_sum_consistency,
)
from .metrics import Counters, GLOBAL_COUNTERS, health_snapshot
from .recorder import FlightRecorder
from .spans import (
    GLOBAL_TRACER,
    Span,
    TraceContext,
    Tracer,
    ambient_parent,
    current_span,
    merge_traces,
)
from .stats import MergeStats, stage_timer
from .timeseries import (
    GLOBAL_HISTORY,
    TimeSeriesPlane,
    anomaly_kind,
    occupancy_distribution,
    replay_segments,
)

__all__ = [
    "CONVERGED",
    "ConvergenceMonitor",
    "Counters",
    "DIVERGENCE",
    "DivergenceIncident",
    "FlightRecorder",
    "GLOBAL_COUNTERS",
    "GLOBAL_HISTOGRAMS",
    "GLOBAL_HISTORY",
    "GLOBAL_LATENCY",
    "GLOBAL_TRACER",
    "Histogram",
    "HistogramRegistry",
    "LAG",
    "LATENCY_BUCKETS_S",
    "LatencyPlane",
    "MergeStats",
    "PeerLag",
    "SIZE_BUCKETS",
    "STAGES",
    "Span",
    "TimeSeriesPlane",
    "TraceContext",
    "Tracer",
    "ambient_parent",
    "anomaly_kind",
    "clock_delta_ops",
    "clocks_equal",
    "check_sum_consistency",
    "current_span",
    "health_snapshot",
    "merge_traces",
    "occupancy_distribution",
    "replay_segments",
    "stage_timer",
]
