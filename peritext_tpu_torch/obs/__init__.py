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
  divergence probes over the multihost frontier exchanges;
* :mod:`.incidents` — the incident plane: typed, round-counted incidents
  correlated across the other planes' snapshots, their wire summary, and
  the merge of per-host flight dumps into one timeline;
* :mod:`.events` — the structured event log and ``profile_trace``, a
  ``torch.profiler`` capture of a block.

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
from .events import EventLog, profile_trace
from .histograms import (
    GLOBAL_HISTOGRAMS,
    Histogram,
    HistogramRegistry,
    LATENCY_BUCKETS_S,
    SIZE_BUCKETS,
)
from .incidents import TAXONOMY, Incident, IncidentMonitor, merge_flight_dumps
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
    "EventLog",
    "FlightRecorder",
    "GLOBAL_COUNTERS",
    "GLOBAL_HISTOGRAMS",
    "GLOBAL_HISTORY",
    "GLOBAL_LATENCY",
    "GLOBAL_TRACER",
    "Histogram",
    "HistogramRegistry",
    "Incident",
    "IncidentMonitor",
    "LAG",
    "LATENCY_BUCKETS_S",
    "LatencyPlane",
    "MergeStats",
    "PeerLag",
    "SIZE_BUCKETS",
    "STAGES",
    "TAXONOMY",
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
    "merge_flight_dumps",
    "merge_traces",
    "occupancy_distribution",
    "profile_trace",
    "replay_segments",
    "stage_timer",
]
