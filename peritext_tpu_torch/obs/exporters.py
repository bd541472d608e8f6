"""Metrics exporters: Prometheus text exposition and HTTP endpoints.

:func:`prometheus_text` renders the process counters + histograms (and
optionally one session's health) in Prometheus text-exposition format
(version 0.0.4).  :class:`MetricsServer` mounts that plus the JSON health
snapshot and the live Perfetto trace on a tiny threaded HTTP server —
``ReplicaServer(metrics_port=...)`` starts one per host, so a fleet scrape
is ``GET /metrics`` against every replica.

Endpoints:

* ``/metrics``      — Prometheus text exposition
* ``/health.json``  — :func:`~.metrics.health_snapshot` as JSON
* ``/trace.json``   — the attached tracer's Chrome trace-event dump
* ``/devprof.json`` — the attached :class:`~.devprof.DeviceProfiler`
  snapshot (shape and launch-plan buckets, occupancy, memory watermarks)
* ``/serve.json``   — the attached :class:`~..serve.SessionMux` snapshot
  (sessions, bounded-queue + typed-verdict state, autotuned round window)
* ``/plan.json``    — a planner verdict given as ``plan`` (anything with
  ``to_json()``, or a dict)
* ``/fleet.json``   — the attached :class:`~..serve.FleetFrontend` snapshot
  (heartbeat-lease table, router placement, per-host serve summaries,
  failover/migration tallies, fleet-wide verdict accounting)
* ``/latency.json`` — the attached :class:`~.latency.LatencyPlane` snapshot
  (per-stage watermark histograms, SLO burn rate, close causes,
  time-to-visibility)
* ``/incidents.json`` — the attached
  :class:`~.incidents.IncidentMonitor` snapshot (typed incident list,
  lifecycle tallies, cross-host agreement view)
* ``/timeseries.json`` — the attached
  :class:`~.timeseries.TimeSeriesPlane` snapshot (retention tiers,
  anomaly findings, occupancy rows); supports windowed query params
  (``?key=...&window=N&rate=1`` — :func:`~.timeseries.query_snapshot`)

A raising plane snapshot answers 500 with a TYPED JSON body
(``{"error": ..., "plane": ...}``) — one sick plane must not turn a
fleet scrape into an HTML traceback page.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs

from .histograms import GLOBAL_HISTOGRAMS, HistogramRegistry
from .metrics import Counters, GLOBAL_COUNTERS, health_snapshot
from .timeseries import query_snapshot

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(name: str) -> str:
    return "peritext_" + _NAME_RE.sub("_", name)


def _fmt(value: float) -> str:
    return repr(round(float(value), 9)) if value % 1 else str(int(value))


def _quote_label(value: str) -> str:
    """Full exposition-format label escaping: backslash, quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


#: computed once per process: the sha shells out to git and the fingerprint
#: asks torch for the card's name — neither belongs on the per-scrape path
_BUILD_INFO: Optional[Dict[str, str]] = None


def build_info() -> Dict[str, str]:
    """One identity record for this process — the SAME spellings the perf
    ledger stamps into its rows (:func:`~.ledger.git_sha` /
    :func:`~.ledger.device_fingerprint`), plus the wire caps and the torch
    and CUDA versions (``cuda`` is ``"none"`` for a CPU-only build of
    torch), so a scraped fleet and a ledger row can be joined on identity
    without translation."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        import torch

        from ..parallel.codec import WIRE_CAPS
        from .ledger import device_fingerprint, git_sha

        fp = device_fingerprint()
        _BUILD_INFO = {
            "sha": git_sha() or "unknown",
            "wire_caps": str(WIRE_CAPS),
            "torch": str(torch.__version__),
            "cuda": str(torch.version.cuda or "none"),
            "device": f"{fp.get('platform')}-{fp.get('kind')}"
                      f"-{fp.get('cpus')}",
        }
    return _BUILD_INFO


def prometheus_text(
    counters: Optional[Counters] = None,
    histograms: Optional[HistogramRegistry] = None,
    session=None,
    sentinel=None,
    convergence=None,
    devprof=None,
    serve=None,
    fleet=None,
    plan=None,
    latency=None,
    incidents=None,
    history=None,
) -> str:
    """Prometheus text exposition of the process telemetry.  Counter names
    sanitize ``.`` → ``_`` under a ``peritext_`` prefix; histograms emit the
    standard ``_bucket{le=...}`` / ``_sum`` / ``_count`` series; a session's
    numeric health fields land as ``peritext_session_*`` gauges; a
    :class:`~.convergence.ConvergenceMonitor` lands as per-peer
    ``peritext_convergence_*`` gauges (lag ops, staleness rounds) plus the
    fleet-level totals; a :class:`~.devprof.DeviceProfiler` lands as
    per-site ``peritext_device_*`` gauges (distinct shape buckets,
    dispatches, the bytes its insert launches must move — captured
    ``kernel_bytes`` times dispatches — under the reference's
    ``bytes_accessed`` name, a ``flops`` total that stays 0 since no
    bucket carries a flop count, and the peak argument + output bytes)
    plus the bucket-occupancy and device-memory-watermark totals, and —
    when a mesh-sharded session reported in — ``peritext_mesh_*`` gauges;
    a
    :class:`~..serve.SessionMux` lands as ``peritext_serve_*`` gauges
    (sessions, bounded-queue depth/peak, backpressure flag, autotuned
    window) plus the typed-verdict counters, with sheds labelled by
    reason; a :class:`~..serve.FleetFrontend` lands as
    ``peritext_fleet_*`` gauges (host/lease counts, failover + migration
    tallies, durable-state bookkeeping) plus the fleet-wide verdict
    counters with sheds labelled by reason.  A serve snapshot's
    ``fusion`` section lands as ``peritext_plan_fusion_*`` gauges (group
    membership, dispatch amortization, window occupancy); a planner
    verdict passed as ``plan`` (a :class:`~..plan.tuner.PlanProposal`, or
    its ``to_json()`` dict) lands as ``peritext_plan_*`` gauges (modeled
    scores, savings fraction, the proposed statics); a
    :class:`~.latency.LatencyPlane` lands as ``peritext_latency_*``
    families — one histogram per stage watermark plus the end-to-end
    total and time-to-visibility, SLO burn-rate gauges, and the
    window-close cause counters; an
    :class:`~.incidents.IncidentMonitor` lands as ``peritext_incident_*``
    gauges — lifecycle tallies, per-kind open counts over the FULL
    taxonomy (absent kinds at 0, so alert rules never reference a series
    that has yet to exist), the incident-view digest, and per-peer
    agreement flags; a :class:`~.timeseries.TimeSeriesPlane` (live or
    snapshot dict) lands as ``peritext_history_*`` gauges — frames
    sampled/retained, per-tier frame counts, persisted segments, active
    + cumulative anomalies (with the by-key breakdown as its own
    labelled family), recorded occupancy rows, and the caller-reported
    sampling overhead.  Every exposition also carries ONE
    ``peritext_build_info`` info-style gauge (value 1, identity as
    labels: git sha, wire caps, torch and CUDA versions, device
    fingerprint) — the same spellings the perf ledger stamps, so fleet
    scrapes and ledger rows join on identity.  ``sentinel`` (a
    :class:`~.sentinel.RecompileSentinel`) lands as
    ``peritext_recompiles_total``: its kernel-library builds and loads."""
    counters = counters or GLOBAL_COUNTERS
    histograms = histograms if histograms is not None else GLOBAL_HISTOGRAMS
    lines = []
    info = build_info()
    m = "peritext_build_info"
    lines.append(f"# TYPE {m} gauge")
    lines.append(
        f'{m}{{sha="{_quote_label(info["sha"])}"'
        f',wire_caps="{_quote_label(info["wire_caps"])}"'
        f',torch="{_quote_label(info["torch"])}"'
        f',cuda="{_quote_label(info["cuda"])}"'
        f',device="{_quote_label(info["device"])}"}} 1'
    )
    for name, value in sorted(counters.snapshot().items()):
        m = _metric_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(value)}")
    for name, hist in histograms.items():
        m = _metric_name(name)
        lines.append(f"# TYPE {m} histogram")
        for bound, cum in hist.bucket_counts():
            lines.append(f'{m}_bucket{{le="{bound:g}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {hist.count}')
        lines.append(f"{m}_sum {_fmt(hist.sum)}")
        lines.append(f"{m}_count {hist.count}")
        lines.append(f"{m}_overflow {hist.overflow}")
    if sentinel is not None:
        m = "peritext_recompiles_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {sentinel.total}")
    if convergence is not None:
        snap = convergence.snapshot()
        per_peer = (
            ("peritext_convergence_lag_ops", "ops_behind"),
            ("peritext_convergence_ahead_ops", "ops_ahead"),
            ("peritext_convergence_staleness_rounds", "staleness_rounds"),
            ("peritext_convergence_peer_failures", "failures"),
        )
        for m, key in per_peer:
            lines.append(f"# TYPE {m} gauge")
            for peer, rec in snap["peers"].items():
                # full exposition-format label escaping: backslash, quote,
                # AND newline — peer names are arbitrary strings (pubsub
                # subscriber keys, logical gossip names), and one raw
                # newline would corrupt the whole scrape page
                quoted = (peer.replace("\\", "\\\\").replace('"', '\\"')
                          .replace("\n", "\\n"))
                lines.append(f'{m}{{peer="{quoted}"}} {_fmt(rec[key])}')
        for m, value in (
            ("peritext_convergence_peers", len(snap["peers"])),
            ("peritext_convergence_total_lag_ops", snap["total_lag_ops"]),
            ("peritext_convergence_rounds", snap["rounds"]),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        m = "peritext_convergence_divergence_incidents_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(snap['divergence_incidents'])}")
    if devprof is not None:
        dp = devprof.snapshot()
        per_site = []
        for site, rec in dp["sites"].items():
            flops = sum(
                b["cost"]["flops"] * b["dispatches"]
                for b in rec["buckets"].values()
                if b.get("cost") and "flops" in b["cost"]
            )
            bytes_acc = sum(
                b["cost"]["kernel_bytes"] * b["dispatches"]
                for b in rec["buckets"].values()
                if b.get("cost") and b["cost"].get("kernel_bytes") is not None
            )
            peak = max(
                (b["memory"]["peak_bytes"] for b in rec["buckets"].values()
                 if b.get("memory")),
                default=0,
            )
            per_site.append((site, rec, flops, bytes_acc, peak))
        site_gauges = (
            ("peritext_device_distinct_shapes", lambda r, f, ba, p: r["distinct_shapes"]),
            ("peritext_device_dispatches", lambda r, f, ba, p: r["dispatches"]),
            ("peritext_device_flops_total", lambda r, f, ba, p: f),
            ("peritext_device_bytes_accessed_total", lambda r, f, ba, p: ba),
            ("peritext_device_peak_bytes", lambda r, f, ba, p: p),
        )
        for m, value_of in site_gauges:
            lines.append(f"# TYPE {m} gauge")
            for site, rec, flops, bytes_acc, peak in per_site:
                quoted = (site.replace("\\", "\\\\").replace('"', '\\"')
                          .replace("\n", "\\n"))
                lines.append(
                    f'{m}{{site="{quoted}"}} '
                    f"{_fmt(value_of(rec, flops, bytes_acc, peak))}"
                )
        tot = dp["occupancy_totals"]
        for m, value in (
            ("peritext_device_rounds_total", tot["rounds"]),
            ("peritext_device_real_ops_total", tot["real_ops"]),
            ("peritext_device_padded_ops_total", tot["padded_capacity"]),
            ("peritext_device_padding_waste_ratio", tot["padding_waste"]),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        pp = dp.get("page_pool")
        if pp:
            # paged-storage gauges (store/paged.PagedDocStore.pool_stats):
            # pool occupancy + internal fragmentation, with the per-decile
            # fragmentation breakdown as a labelled family
            for m, value in (
                ("peritext_page_pool_pages", pp["pool_pages"]),
                ("peritext_page_pages_in_use", pp["pages_in_use"]),
                ("peritext_page_pool_utilization", pp["pool_utilization"]),
                ("peritext_page_pool_peak_utilization",
                 pp.get("peak_utilization", pp["pool_utilization"])),
                ("peritext_page_pool_growths", pp["growths"]),
                ("peritext_page_docs_resident", pp["docs_resident"]),
                ("peritext_page_internal_frag_slots", pp["internal_frag_slots"]),
                ("peritext_page_internal_frag_ratio", pp["internal_frag_ratio"]),
                ("peritext_page_size_slots", pp["page_size"]),
            ):
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(value)}")
            m = "peritext_page_frag_ratio"
            lines.append(f"# TYPE {m} gauge")
            for decile, value in sorted(pp.get("frag_by_decile", {}).items()):
                lines.append(f'{m}{{decile="{decile}"}} {_fmt(value)}')
        rg = dp.get("ragged")
        if rg:
            # ragged-apply gauges (ops/ragged.py dispatches): how much of
            # the pool each one-program round actually walked.  The waste
            # gauge is the layout's headline — identically 0 padded slots
            # dispatched, vs the bucket ladder's pow-2 pad
            for m, value in (
                ("peritext_ragged_dispatches", rg["dispatches"]),
                ("peritext_ragged_docs_walked", rg["docs_walked"]),
                ("peritext_ragged_pages_walked", rg["pages_walked"]),
                ("peritext_ragged_real_ops", rg["real_ops"]),
                ("peritext_ragged_padded_slot_waste", rg["padded_slot_waste"]),
            ):
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(value)}")
        ms = dp.get("mesh")
        if ms:
            # mesh-shard gauges (a sharded session's shard stats, fed to
            # observe_mesh): doc-axis balance across the sharded page pools
            # plus the cumulative inter-device page-move tally from reshards
            for m, value in (
                ("peritext_mesh_shards", ms["shards"]),
                ("peritext_mesh_rows_per_shard", ms["rows_per_shard"]),
                ("peritext_mesh_shard_imbalance_ratio",
                 ms["imbalance_ratio"]),
                ("peritext_mesh_peak_imbalance_ratio",
                 ms.get("peak_imbalance", ms["imbalance_ratio"])),
                ("peritext_mesh_ici_page_moves",
                 ms.get("ici_page_moves", 0)),
            ):
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(value)}")
            m = "peritext_mesh_shard_load"
            lines.append(f"# TYPE {m} gauge")
            for shard, value in enumerate(ms.get("shard_load") or ()):
                lines.append(f'{m}{{shard="{shard}"}} {_fmt(value)}')
            m = "peritext_mesh_shard_pool_utilization"
            lines.append(f"# TYPE {m} gauge")
            for shard, value in enumerate(ms.get("shard_utilization") or ()):
                lines.append(f'{m}{{shard="{shard}"}} {_fmt(value)}')
        mem = dp["memory"]
        if mem["available"]:
            for m, value in (
                ("peritext_device_memory_bytes_in_use", mem["bytes_in_use"]),
                ("peritext_device_memory_peak_bytes", mem["peak_bytes_in_use"]),
            ):
                if value is not None:
                    lines.append(f"# TYPE {m} gauge")
                    lines.append(f"{m} {_fmt(value)}")
    if serve is not None:
        snap = serve.snapshot()
        q = snap["queue"]
        w = snap["window"]
        for m, value in (
            ("peritext_serve_sessions", snap["sessions"]),
            ("peritext_serve_docs", snap["docs"]),
            ("peritext_serve_doc_capacity", snap["doc_capacity"]),
            ("peritext_serve_degraded_docs", snap["degraded_docs"]),
            ("peritext_serve_rounds", snap["rounds"]),
            ("peritext_serve_applied_frames", snap["applied_frames"]),
            ("peritext_serve_buffered_frames", snap["buffered_frames"]),
            ("peritext_serve_overloaded", int(snap["overloaded"])),
            ("peritext_serve_queue_depth", q["depth"]),
            ("peritext_serve_queue_peak", q["peak"]),
            ("peritext_serve_queue_max_depth", q["max_depth"]),
            ("peritext_serve_backpressure", int(q["backpressure"])),
            ("peritext_serve_window_seconds", w["seconds"]),
            ("peritext_serve_window_p99_round_seconds",
             w["p99_round_seconds"]),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        verdicts = q["verdicts"]
        for m, key in (
            ("peritext_serve_submitted_total", "submitted"),
            ("peritext_serve_admitted_total", "admitted"),
            ("peritext_serve_delayed_total", "delayed"),
        ):
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_fmt(verdicts[key])}")
        m = "peritext_serve_shed_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {_fmt(verdicts['shed'])}")
        # the by-reason breakdown is its OWN family: mixing an unlabelled
        # total with labelled samples under one name would make a PromQL
        # sum() double-count every shed
        m = "peritext_serve_shed_reason_total"
        lines.append(f"# TYPE {m} counter")
        for reason, count in verdicts["shed_reasons"].items():
            quoted = (reason.replace("\\", "\\\\").replace('"', '\\"')
                      .replace("\n", "\\n"))
            lines.append(f'{m}{{reason="{quoted}"}} {_fmt(count)}')
        fu = snap.get("fusion")
        if fu:
            # cross-tenant fusion gauges: how many tenants this host's
            # dispatches amortize over (identity report when standalone)
            for m, value in (
                ("peritext_plan_fusion_grouped", int(fu["grouped"])),
                ("peritext_plan_fusion_tenants", fu["tenants"]),
                ("peritext_plan_fusion_lanes", fu["lanes"]),
                ("peritext_plan_fusion_windows", fu["windows"]),
                ("peritext_plan_fusion_dispatches", fu["dispatches"]),
                ("peritext_plan_docs_per_dispatch",
                 fu["docs_per_dispatch"]),
                ("peritext_plan_window_occupancy",
                 fu["window_occupancy"]),
            ):
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(value)}")
    if fleet is not None:
        snap = fleet.snapshot()
        leases = snap["leases"]["leases"]
        live = sum(1 for rec in leases.values() if rec["verdict"] == "live")
        dead = sum(1 for rec in leases.values() if rec["verdict"] == "dead")
        for m, value in (
            ("peritext_fleet_hosts", len(snap["hosts"])),
            ("peritext_fleet_live_hosts", live),
            ("peritext_fleet_dead_hosts", dead),
            ("peritext_fleet_docs", len(snap["serving"])),
            ("peritext_fleet_moving_docs", len(snap["moving"])),
            ("peritext_fleet_failed_docs", len(snap["failed_docs"])),
            ("peritext_fleet_rounds", snap["rounds"]),
            ("peritext_fleet_journal_frames", snap["journal_frames"]),
            ("peritext_fleet_checkpoint_docs", snap["checkpoint_docs"]),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        for m, value in (
            ("peritext_fleet_failovers_total", snap["failovers"]),
            ("peritext_fleet_failover_docs_total", snap["failover_docs"]),
            ("peritext_fleet_migrations_total", snap["migrations"]),
            ("peritext_fleet_migration_rollbacks_total",
             snap["migration_rollbacks"]),
            ("peritext_fleet_checkpoint_ships_total",
             snap["checkpoint_ships"]),
        ):
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_fmt(value)}")
        verdicts = snap["verdicts"]
        for m, key in (
            ("peritext_fleet_submitted_total", "submitted"),
            ("peritext_fleet_admitted_total", "admitted"),
            ("peritext_fleet_delayed_total", "delayed"),
            ("peritext_fleet_shed_total", "shed"),
        ):
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {_fmt(verdicts[key])}")
        # by-reason family, own name (same no-double-count rationale as
        # peritext_serve_shed_reason_total)
        m = "peritext_fleet_shed_reason_total"
        lines.append(f"# TYPE {m} counter")
        for reason, count in verdicts["shed_reasons"].items():
            quoted = (reason.replace("\\", "\\\\").replace('"', '\\"')
                      .replace("\n", "\\n"))
            lines.append(f'{m}{{reason="{quoted}"}} {_fmt(count)}')
    if plan is not None:
        pj = plan.to_json() if hasattr(plan, "to_json") else dict(plan)
        modeled = pj.get("modeled") or {}
        proposal = pj.get("proposal") or {}
        for m, value in (
            ("peritext_plan_current_score", modeled.get("current_score")),
            ("peritext_plan_proposed_score", modeled.get("proposed_score")),
            ("peritext_plan_savings_frac", modeled.get("savings_frac")),
            ("peritext_plan_utilization", modeled.get("utilization")),
            ("peritext_plan_proposed_fused_depth",
             proposal.get("fused_depth")),
            ("peritext_plan_proposed_slot_capacity",
             proposal.get("slot_capacity")),
            ("peritext_plan_proposed_page_size", proposal.get("page_size")),
            ("peritext_plan_proposed_window_seconds",
             proposal.get("window_seconds")),
        ):
            if isinstance(value, (int, float)):
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(value)}")
    if latency is not None:
        # the latency plane owns PRIVATE histograms (arming it for one
        # bench arm must not pollute the process registry), so its
        # families are emitted here from the plane itself
        for name, hist in sorted(latency.hists.items()):
            m = f"peritext_latency_{_NAME_RE.sub('_', name)}_seconds"
            lines.append(f"# TYPE {m} histogram")
            for bound, cum in hist.bucket_counts():
                lines.append(f'{m}_bucket{{le="{bound:g}"}} {cum}')
            lines.append(f'{m}_bucket{{le="+Inf"}} {hist.count}')
            lines.append(f"{m}_sum {_fmt(hist.sum)}")
            lines.append(f"{m}_count {hist.count}")
            lines.append(f"{m}_overflow {hist.overflow}")
        snap = latency.snapshot()
        slo = snap["slo"]
        for m, value in (
            ("peritext_latency_enabled", int(snap["enabled"])),
            ("peritext_latency_sample_every", snap["sample_every"]),
            ("peritext_latency_windows", snap["windows"]),
            ("peritext_latency_records", snap["records"]),
            ("peritext_latency_pending_visibility",
             snap["pending_visibility"]),
            ("peritext_latency_never_read", snap["never_read"]),
            ("peritext_latency_replica_fanout", snap["shards"]),
            ("peritext_latency_slo_seconds", slo["slo_seconds"]),
            ("peritext_latency_slo_target", slo["target"]),
            ("peritext_latency_slo_violating_frac", slo["violating_frac"]),
            ("peritext_latency_slo_burn_rate", slo["burn_rate"]),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        m = "peritext_latency_force_close_total"
        lines.append(f"# TYPE {m} counter")
        for cause, count in sorted(snap["force_close"].items()):
            quoted = (cause.replace("\\", "\\\\").replace('"', '\\"')
                      .replace("\n", "\\n"))
            lines.append(f'{m}{{cause="{quoted}"}} {_fmt(count)}')
    if incidents is not None:
        snap = incidents.snapshot()
        for m, value in (
            ("peritext_incident_rounds", snap["rounds"]),
            ("peritext_incident_open", snap["open"]),
            ("peritext_incident_acked", snap["acked"]),
            ("peritext_incident_resolved", snap["resolved"]),
            ("peritext_incident_total", snap["total"]),
            ("peritext_incident_digest", snap["digest"]),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        # by-kind family, own name (same no-double-count rationale as
        # peritext_serve_shed_reason_total); the FULL taxonomy is emitted
        # so dashboards can alert on kinds that have never fired
        m = "peritext_incident_open_by_kind"
        lines.append(f"# TYPE {m} gauge")
        for kind, count in snap["by_kind"].items():
            lines.append(f'{m}{{kind="{_quote_label(kind)}"}} {_fmt(count)}')
        m = "peritext_incident_peer_agreement"
        lines.append(f"# TYPE {m} gauge")
        for peer, view in snap["peers"].items():
            lines.append(
                f'{m}{{peer="{_quote_label(peer)}"}} {int(view["agree"])}'
            )
    if history is not None:
        snap = (history.snapshot() if hasattr(history, "snapshot")
                else dict(history))
        anomaly = snap.get("anomaly") or {}
        occ = snap.get("occupancy") or {}
        for m, value in (
            ("peritext_history_enabled", int(bool(snap.get("enabled")))),
            ("peritext_history_rounds", snap.get("rounds", 0)),
            ("peritext_history_sample_every", snap.get("sample_every", 1)),
            ("peritext_history_frames_sampled",
             snap.get("frames_sampled", 0)),
            ("peritext_history_frames_retained",
             snap.get("frames_retained", 0)),
            ("peritext_history_segments", snap.get("segments", 0)),
            ("peritext_history_anomalies_active",
             len(anomaly.get("active") or ())),
            ("peritext_history_anomalies_total", anomaly.get("total", 0)),
            ("peritext_history_occupancy_rows", occ.get("rows", 0)),
            ("peritext_history_sample_overhead_seconds",
             snap.get("overhead_seconds", 0.0)),
        ):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {_fmt(value)}")
        m = "peritext_history_tier_frames"
        lines.append(f"# TYPE {m} gauge")
        for tier, count in enumerate(snap.get("tier_frames") or ()):
            lines.append(f'{m}{{tier="{tier}"}} {_fmt(count)}')
        # by-key anomaly family, its OWN name (same no-double-count
        # rationale as peritext_serve_shed_reason_total)
        m = "peritext_history_anomaly_by_key"
        lines.append(f"# TYPE {m} counter")
        counts = anomaly.get("counts") or {}
        for key in sorted(counts):
            lines.append(
                f'{m}{{key="{_quote_label(key)}"}} {_fmt(counts[key])}'
            )
    if session is not None:
        health = session.health()
        for key in sorted(health):
            value = health[key]
            if isinstance(value, bool):
                value = int(value)
            if isinstance(value, (int, float)):
                m = _metric_name(f"session.{key}")
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m} {_fmt(value)}")
        quarantined = health.get("quarantined")
        if isinstance(quarantined, dict):
            m = _metric_name("session.quarantined_docs")
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {len(quarantined)}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "peritext-obs"

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
        routes: Dict[str, Tuple[Callable[[], str], str]] = self.server._routes  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        entry = routes.get(path)
        if entry is None:
            self.send_error(404)
            return
        fn, content_type = entry
        try:
            if getattr(fn, "accepts_query", False):
                # last value wins per key, keys visited sorted — a scrape
                # with duplicate params must parse deterministically
                params = {k: v[-1]
                          for k, v in sorted(parse_qs(query).items())}
                body = fn(params).encode("utf-8")
            else:
                body = fn().encode("utf-8")
        except Exception as exc:  # graftlint: boundary(an exporter endpoint answers 500, never kills the serving thread)
            # typed JSON error body: which plane broke + why — a sick
            # plane must not turn a fleet scrape into a traceback page
            stem = path.rsplit("/", 1)[-1]
            if stem.endswith(".json"):
                stem = stem[:-5]
            err = json.dumps({"error": str(exc), "plane": stem or "metrics"})
            body = err.encode("utf-8")
            self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args) -> None:  # scrapes must not spam stderr
        pass


class MetricsServer:
    """Threaded HTTP exporter for one host's telemetry (see module doc)."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        counters: Optional[Counters] = None,
        histograms: Optional[HistogramRegistry] = None,
        session=None,
        tracer=None,
        recorder=None,
        sentinel=None,
        convergence=None,
        devprof=None,
        serve=None,
        fleet=None,
        plan=None,
        latency=None,
        incidents=None,
        history=None,
    ) -> None:
        def metrics() -> str:
            return prometheus_text(
                counters=counters, histograms=histograms,
                session=session, sentinel=sentinel, convergence=convergence,
                devprof=devprof, serve=serve, fleet=fleet, plan=plan,
                latency=latency, incidents=incidents, history=history,
            )

        def snapshot() -> str:
            return json.dumps(
                health_snapshot(
                    counters=counters, session=session, sentinel=sentinel,
                    histograms=histograms, recorder=recorder,
                    convergence=convergence, devprof=devprof, serve=serve,
                    fleet=fleet, plan=plan, latency=latency,
                    incidents=incidents, history=history,
                ),
                default=str,
            )

        routes: Dict[str, Tuple[Callable[[], str], str]] = {
            "/metrics": (metrics, "text/plain; version=0.0.4; charset=utf-8"),
            "/health.json": (snapshot, "application/json"),
        }
        if tracer is not None:
            routes["/trace.json"] = (
                lambda: json.dumps(tracer.chrome_trace()),
                "application/json",
            )
        if convergence is not None:
            routes["/convergence.json"] = (
                lambda: json.dumps(convergence.snapshot()),
                "application/json",
            )
        if devprof is not None:
            routes["/devprof.json"] = (
                lambda: json.dumps(devprof.snapshot()),
                "application/json",
            )
        if serve is not None:
            routes["/serve.json"] = (
                lambda: json.dumps(serve.snapshot()),
                "application/json",
            )
        if fleet is not None:
            routes["/fleet.json"] = (
                lambda: json.dumps(fleet.snapshot()),
                "application/json",
            )
        if plan is not None:
            routes["/plan.json"] = (
                lambda: json.dumps(
                    plan.to_json() if hasattr(plan, "to_json")
                    else dict(plan)
                ),
                "application/json",
            )
        if latency is not None:
            routes["/latency.json"] = (
                lambda: json.dumps(latency.snapshot()),
                "application/json",
            )
        if incidents is not None:
            routes["/incidents.json"] = (
                lambda: json.dumps(incidents.snapshot()),
                "application/json",
            )
        if history is not None:
            def timeseries(params: Optional[Dict[str, str]] = None) -> str:
                return json.dumps(
                    query_snapshot(history.snapshot(), params or {}),
                    default=str,
                )

            # opt into the handler's query-string dispatch
            timeseries.accepts_query = True  # type: ignore[attr-defined]
            routes["/timeseries.json"] = (timeseries, "application/json")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd._routes = routes  # type: ignore[attr-defined]
        self.address: Tuple[str, int] = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self.address

    def stop(self) -> None:
        if self._thread is None:
            # never started: shutdown() would block forever waiting for a
            # serve_forever() loop that doesn't exist — just release the port
            self._httpd.server_close()
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
        self._thread = None
