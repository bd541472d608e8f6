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
  ``torch.profiler`` capture of a block;
* :mod:`.devprof` — the device planes' profiler (:data:`GLOBAL_DEVPROF`,
  off by default): per launch site (``apply_batch``,
  ``apply_batch_paged``, ``apply_batch_paged_groups``,
  ``apply_batch_compact``, ``apply_batch_ragged``) a table of shape and
  launch-plan buckets with each bucket's first call costed (device ms by
  CUDA events, the bytes its insert launches must move, the launches),
  per padded-shape bucket the occupancy, the page pool and the ragged
  walk, and the CUDA allocator's memory watermarks;
* :mod:`.sentinel` — :class:`RecompileSentinel`, which counts kernel
  library builds and loads per library;
* :mod:`.ledger` — the append-only JSONL perf ledger (rows + devprof
  snapshots keyed by git sha, device fingerprint and config) and its
  rolling-reference gate (:func:`~.ledger.evaluate`), which
  :func:`~.latency.attribute` explains stage by stage;
* :mod:`.exporters` — the Prometheus text exposition
  (:func:`prometheus_text`) and :class:`MetricsServer`, the HTTP endpoint
  ``ReplicaServer(metrics_port=)`` mounts (``/metrics``, ``/health.json``,
  ``/devprof.json``, ``/serve.json``, ``/fleet.json`` and the other
  planes' JSON routes).

The host planes never synchronize the card; the profiler's hooks neither
(its CUDA events are read in ``snapshot()``, the read point).
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
from .devprof import (
    DeviceProfiler,
    GLOBAL_DEVPROF,
    note_launch,
    occupancy_key,
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
    attribute,
    check_sum_consistency,
)
from .metrics import Counters, GLOBAL_COUNTERS, health_snapshot
from .recorder import FlightRecorder
from .sentinel import RecompileSentinel
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
from .exporters import MetricsServer, prometheus_text

__all__ = [
    "CONVERGED",
    "ConvergenceMonitor",
    "Counters",
    "DeviceProfiler",
    "DIVERGENCE",
    "DivergenceIncident",
    "EventLog",
    "FlightRecorder",
    "GLOBAL_DEVPROF",
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
    "MetricsServer",
    "PeerLag",
    "RecompileSentinel",
    "SIZE_BUCKETS",
    "STAGES",
    "TAXONOMY",
    "Span",
    "TimeSeriesPlane",
    "TraceContext",
    "Tracer",
    "ambient_parent",
    "anomaly_kind",
    "attribute",
    "clock_delta_ops",
    "clocks_equal",
    "check_sum_consistency",
    "current_span",
    "health_snapshot",
    "merge_flight_dumps",
    "merge_traces",
    "note_launch",
    "occupancy_key",
    "occupancy_distribution",
    "profile_trace",
    "prometheus_text",
    "replay_segments",
    "stage_timer",
]
