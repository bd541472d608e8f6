"""``python -m peritext_tpu_torch.obs`` — render telemetry artifacts.

Reads Perfetto/Chrome trace-event JSON (a ``Tracer.chrome_trace()`` dump,
``/trace.json`` scrape, or obs-smoke artifact) or flight-recorder JSONL and
prints a per-stage / per-host summary table: span count, total wall, mean,
and p50/p95/p99 per (stage, host).  The ``fleet`` command instead reads
``/convergence.json`` scrapes (or ``/health.json`` bodies carrying a
``convergence`` key) from one or more hosts and renders the fleet's
replication-lag picture: per (host, peer) ops-behind/ahead watermarks,
staleness, failures, and any divergence incidents.

The ``serve`` command reads ``/serve.json`` scrapes (or ``/health.json``
bodies carrying a ``serve`` key) from one or more serving hosts and
renders the serving tier's load picture: sessions, bounded-queue depth
vs watermarks, typed verdict tallies (admitted / delayed / shed by
reason), degradations, and the autotuned round-open window — exiting 1
when any host is under sustained overload (backpressure engaged) or has
shed load, so the command doubles as a fleet serving-health check.

The ``plan`` command reads one devprof snapshot (a ``/devprof.json``
scrape, a ``/health.json`` body carrying a ``devprof`` key, or an
obs-smoke artifact) — plus, optionally, the perf ledger for the
admission-window term — and prints the closed-loop planner's
:class:`~peritext_tpu_torch.plan.tuner.PlanProposal`: the proposed statics
(stream widths, slot capacity, page size, fused depth, admission
window) next to the observed configuration, with the modeled
padded-FLOPs / recompile / dispatch terms that justify them.  Exit 1
when the proposal beats the current configuration beyond the tolerance
band ("your statics are stale" — the cue to replay the proposal through
a bench row), 0 inside the band.

The ``perf`` command reads the append-only perf ledger
(:mod:`peritext_tpu_torch.obs.ledger`: bench ladder rows + devprof snapshots,
one JSONL record per run) and renders the LAST record as a diff table
against its rolling same-device reference; ``--gate`` makes a regression
beyond the tolerance bands exit 1 — the CI perf-gate job.

The ``why`` command is the perf gate's attribution engine
(:func:`peritext_tpu_torch.obs.latency.attribute`): it judges the ledger's last
record exactly like ``perf``, then explains WHAT moved — diffing the
failing row's per-stage latency decomposition (admit → window → stage →
dispatch → commit → visibility) against the per-stage median over the
rolling reference, attaching the devprof shape-bucket / occupancy
deltas, and deterministically naming the dominant moved stage (largest
positive delta; ties break to the earliest stage in the taxonomy).
``--row`` targets a specific row instead of the first failing one.

The ``incidents`` command reads ``/incidents.json`` scrapes (or
``/health.json`` bodies carrying an ``incidents`` key) and renders the
correlated incident table: typed kind, lifecycle status, scope
(hosts/docs), open/resolve rounds, and each incident's root-cause
candidate ordering — exiting 1 while any incident is open, so the
command doubles as a fleet incident check.

The ``status`` command is the one-look roll-up: given a live
MetricsServer base URL (``http://host:port``) or a snapshot directory
(``health.json`` / ``convergence.json`` / ``serve.json`` /
``fleet.json`` / ``latency.json`` / ``incidents.json`` /
``devprof.json`` / ``plan.json`` / ``timeseries.json`` /
``trace.json``), it renders one
table over every plane present and exits with the COMPOSITE of the
per-plane CLI contracts (the worst plane wins).  Every JSON endpoint
the MetricsServer can mount has a row here — the surface-mount audit
test pins that equivalence.

The ``history`` command reads the history plane (a ``/timeseries.json``
scrape, a snapshot directory holding ``timeseries.json`` or
``history.json``, a ``health.json`` body carrying a ``history`` key, or
a direct file path) and renders the retained trend: by default a
per-gauge-key table (points, first → last, delta, min/max envelope)
sorted so the biggest movers lead; ``--key`` renders one gauge's
``[round, value]`` points instead (``--rate`` adds the per-round
derivative, ``--window N`` limits to the trailing N frames).  Exit 1
while any anomaly finding is active — the command doubles as a fleet
drift check.

The ``top`` command is the single-refresh fleet dashboard: the
``status`` roll-up table composed with the history plane's biggest
recent movers and its active anomaly findings — one look at what is
unhealthy NOW next to what has been drifting.  Exits like ``status``
(the worst plane wins; an active anomaly surfaces through the
``timeseries`` plane row).

The ``flight`` command reads a directory of flight-recorder dumps
(``flight-<host>-<pid>-<n>-<reason>.jsonl``) and renders the merged
cross-host black-box timeline (:func:`peritext_tpu_torch.obs.incidents.
merge_flight_dumps`): every record host-attributed from its dump's
filename, ordered by timestamp, with the per-trace causal groupings.

Usage::

    python -m peritext_tpu_torch.obs summary trace.json [more.json ...]
    python -m peritext_tpu_torch.obs summary flight-*.jsonl --json
    python -m peritext_tpu_torch.obs merge -o merged.json hostA.json hostB.json
    python -m peritext_tpu_torch.obs fleet hostA-convergence.json hostB.json
    python -m peritext_tpu_torch.obs serve hostA-serve.json hostB-serve.json
    python -m peritext_tpu_torch.obs perf perf/reference_ledger.jsonl --gate
    python -m peritext_tpu_torch.obs plan devprof.json --ledger perf/ledger.jsonl
    python -m peritext_tpu_torch.obs why perf/ledger.jsonl --row serve_sustained
    python -m peritext_tpu_torch.obs incidents hostA-incidents.json hostB.json
    python -m peritext_tpu_torch.obs status http://127.0.0.1:9100
    python -m peritext_tpu_torch.obs status snapshot-dir/
    python -m peritext_tpu_torch.obs history http://127.0.0.1:9100
    python -m peritext_tpu_torch.obs history snapshot-dir/ --key serve.queue.depth
    python -m peritext_tpu_torch.obs top http://127.0.0.1:9100
    python -m peritext_tpu_torch.obs flight dump-dir/

``summary`` is the default command (``python -m peritext_tpu_torch.obs t.json``
works).  Exit codes: 0 ok (fleet: converged; serve: healthy; perf: no
regression; why: clean; plan: statics within tolerance; incidents: none
open; status/top: every plane clean; history: no active anomaly), 1 no
spans
found / fleet has lag or divergence / serve has overload or shedding /
perf ``--gate`` regression / why regression (attributed or not) / plan
proposal beats the current statics beyond tolerance / open incidents /
any plane in the status or top roll-up unhealthy / an active history
anomaly, 2 unreadable input.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def load_spans(path: str | Path) -> List[Dict]:
    """Normalized span rows ``{name, host, duration_s, trace_id}`` from a
    Chrome trace JSON or a flight-recorder JSONL file."""
    text = Path(path).read_text()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if doc is not None:  # chrome trace: object with traceEvents, or a list
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        return [
            {
                "name": e.get("name", "?"),
                "host": e.get("args", {}).get("host", str(e.get("pid", "?"))),
                "duration_s": e.get("dur", 0) / 1e6,
                "trace_id": e.get("args", {}).get("trace_id"),
            }
            for e in events
            if e.get("ph") == "X"
        ]
    # flight-recorder JSONL: one record per line, spans have kind == "span"
    spans = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        if rec.get("kind") == "span":
            spans.append({
                "name": rec.get("name", "?"),
                "host": rec.get("host", "?"),
                "duration_s": rec.get("duration_s", 0.0),
                "trace_id": rec.get("trace_id"),
            })
    return spans


def _pct(durs: List[float], q: float) -> float:
    if not durs:
        return 0.0
    idx = min(len(durs) - 1, max(0, int(q * len(durs)) - (0 if q * len(durs) % 1 else 1)))
    return durs[idx]


def summarize(spans: Sequence[Dict]) -> List[Dict]:
    """Per-(stage, host) rows sorted by total wall descending."""
    groups: Dict[tuple, List[float]] = {}
    for sp in spans:
        groups.setdefault((sp["name"], sp["host"]), []).append(sp["duration_s"])
    rows = []
    for (name, host), durs in sorted(groups.items()):
        durs = sorted(durs)
        total = sum(durs)
        rows.append({
            "stage": name,
            "host": host,
            "count": len(durs),
            "total_ms": round(total * 1e3, 3),
            "mean_ms": round(total / len(durs) * 1e3, 3),
            "p50_ms": round(_pct(durs, 0.50) * 1e3, 3),
            "p95_ms": round(_pct(durs, 0.95) * 1e3, 3),
            "p99_ms": round(_pct(durs, 0.99) * 1e3, 3),
        })
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def render_table(rows: Sequence[Dict], cols: Optional[List[str]] = None,
                 left_cols: int = 2) -> str:
    cols = cols or ["stage", "host", "count", "total_ms", "mean_ms",
                    "p50_ms", "p95_ms", "p99_ms"]
    cells = [[str(r[c]) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells)) if cells else len(c)
              for i, c in enumerate(cols)]
    def fmt(row):
        return "  ".join(
            v.ljust(w) if i < left_cols else v.rjust(w)
            for i, (v, w) in enumerate(zip(row, widths))
        )
    lines = [fmt(cols), fmt(["-" * w for w in widths])]
    lines.extend(fmt(row) for row in cells)
    return "\n".join(lines)


# -- fleet view (convergence.json scrapes) ----------------------------------


def load_convergence(path: str | Path) -> Dict:
    """One host's convergence snapshot from a ``/convergence.json`` scrape
    or a ``/health.json`` body whose ``convergence`` key carries it."""
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, dict) and "convergence" in doc:
        doc = doc["convergence"]
    if not isinstance(doc, dict) or "peers" not in doc:
        raise ValueError(f"{path}: not a convergence snapshot")
    return doc


def fleet_rows(snapshots: Sequence[Dict]) -> List[Dict]:
    """Flatten host snapshots into per-(host, peer) lag rows."""
    rows = []
    for snap in snapshots:
        host = snap.get("host", "?")
        for peer, rec in sorted(snap.get("peers", {}).items()):
            rows.append({
                "host": host,
                "peer": peer,
                "lag_ops": rec.get("ops_behind", 0),
                "ahead_ops": rec.get("ops_ahead", 0),
                "stale_rounds": rec.get("staleness_rounds", 0),
                "failures": rec.get("failures", 0),
                "outcome": rec.get("last_outcome", "?"),
                "divergent": "YES" if rec.get("divergent") else "",
                "last_error": rec.get("last_error"),
            })
    rows.sort(key=lambda r: (-r["lag_ops"], -r["stale_rounds"],
                             r["host"], r["peer"]))
    return rows


# -- serve view (/serve.json scrapes) ----------------------------------------


def load_serve(path: str | Path) -> Dict:
    """One host's serving snapshot from a ``/serve.json`` scrape or a
    ``/health.json`` body whose ``serve`` key carries it."""
    doc = json.loads(Path(path).read_text())
    if isinstance(doc, dict) and "serve" in doc and "queue" not in doc:
        doc = doc["serve"]
    if not isinstance(doc, dict) or "queue" not in doc or "window" not in doc:
        raise ValueError(f"{path}: not a serve snapshot")
    return doc


def serve_rows(snapshots: Sequence[Dict]) -> List[Dict]:
    """Flatten host serve snapshots into per-host load rows."""
    rows = []
    for snap in snapshots:
        q = snap.get("queue", {})
        verdicts = q.get("verdicts", {})
        shed_reasons = verdicts.get("shed_reasons", {})
        # health reads RECENCY: sheds since the tier last kept up (an old
        # scrape without the field falls back to the lifetime counter)
        recent = snap.get("recent_sheds", verdicts.get("shed", 0))
        rows.append({
            "host": snap.get("host", "?"),
            "sessions": snap.get("sessions", 0),
            "docs": snap.get("docs", 0),
            "depth": f"{q.get('depth', 0)}/{q.get('max_depth', 0)}",
            "peak": q.get("peak", 0),
            "admitted": verdicts.get("admitted", 0),
            "delayed": verdicts.get("delayed", 0),
            "shed": verdicts.get("shed", 0),
            "recent_sheds": recent,
            "degraded": snap.get("degraded_docs", 0),
            "window_ms": round(
                snap.get("window", {}).get("seconds", 0.0) * 1e3, 2
            ),
            "overloaded": "YES" if (
                snap.get("overloaded") or q.get("backpressure")
            ) else "",
            "shed_reasons": ",".join(
                f"{k}:{v}" for k, v in sorted(shed_reasons.items())
            ),
        })
    rows.sort(key=lambda r: (r["overloaded"] != "YES", -r["recent_sheds"],
                             r["host"]))
    return rows


# -- incident view (/incidents.json scrapes) ---------------------------------


def load_incidents(path: str | Path) -> Dict:
    """One monitor's incident snapshot from an ``/incidents.json`` scrape
    or a ``/health.json`` body whose ``incidents`` key carries it."""
    doc = json.loads(Path(path).read_text())
    if (isinstance(doc, dict) and isinstance(doc.get("incidents"), dict)):
        doc = doc["incidents"]  # health.json composition
    if (not isinstance(doc, dict) or "by_kind" not in doc
            or not isinstance(doc.get("incidents"), list)):
        raise ValueError(f"{path}: not an incidents snapshot")
    return doc


def incident_rows(snapshots: Sequence[Dict]) -> List[Dict]:
    """Flatten monitor snapshots into per-incident rows, open first."""
    rows = []
    for snap in snapshots:
        monitor = snap.get("host", "?")
        for inc in snap.get("incidents", []):
            cands = inc.get("candidates", [])
            root = cands[0] if cands else {}
            rows.append({
                "monitor": monitor,
                "id": inc.get("id", "?"),
                "kind": inc.get("kind", "?"),
                "status": inc.get("status", "?"),
                "hosts": ",".join(inc.get("hosts", [])),
                "docs": ",".join(inc.get("docs", [])),
                "opened": inc.get("opened_round"),
                "resolved": (inc.get("resolved_round")
                             if inc.get("resolved_round") is not None
                             else "-"),
                "signals": inc.get("signals", 0),
                "root_value": root.get("value", 0),
                "candidates": ",".join(
                    f"{c.get('kind')}@{c.get('host')}" for c in cands
                ),
            })
    rows.sort(key=lambda r: (r["status"] == "resolved", r["monitor"],
                             r["id"]))
    return rows


def _incidents_command(args) -> int:
    """Render the correlated incident table (see module doc)."""
    snapshots = []
    for p in args.paths:
        try:
            snapshots.append(load_incidents(p))
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"unreadable incidents snapshot {p}: {exc}",
                  file=sys.stderr)
            return 2
    rows = incident_rows(snapshots)
    open_count = sum(s.get("open", 0) for s in snapshots)
    resolved = sum(s.get("resolved", 0) for s in snapshots)
    digests = sorted({s.get("digest") for s in snapshots})
    if args.json:
        print(json.dumps({
            "monitors": len(snapshots), "open": open_count,
            "resolved": resolved, "digests": digests, "rows": rows,
        }, indent=2))
    else:
        agree = ("" if len(snapshots) < 2 else
                 " · views AGREE" if len(digests) == 1
                 else " · views DISAGREE")
        print(f"{len(snapshots)} monitor(s) · {open_count} open · "
              f"{resolved} resolved{agree}")
        if rows:
            print(render_table(
                rows,
                cols=["monitor", "id", "kind", "status", "hosts",
                      "opened", "resolved", "signals", "candidates"],
                left_cols=5,
            ))
        else:
            print("no incidents recorded")
    # an open incident is exit 1: the command doubles as a fleet
    # incident check (CI / cron), mirroring serve/fleet
    return 1 if open_count else 0


# -- status roll-up (live MetricsServer or snapshot dir) ---------------------

#: plane -> (route/filename stem, evaluator).  Evaluators return
#: (exit_code, summary_string) from the plane's already-parsed JSON body,
#: with the SAME health predicates the per-plane commands apply.
def _eval_health(doc: Dict) -> tuple:
    counters = doc.get("counters", {})
    rollbacks = int(counters.get("supervisor.rollbacks", 0))
    quarantines = sum(
        v for k, v in counters.items()
        if k.startswith("streaming.quarantines")
    )
    return 0, (f"{len(counters)} counters · rollbacks {rollbacks} · "
               f"quarantines {int(quarantines)}")


def _eval_convergence(doc: Dict) -> tuple:
    lag = int(doc.get("total_lag_ops", 0))
    div = int(doc.get("divergence_incidents", 0))
    code = 1 if (lag or div) else 0
    return code, (f"{len(doc.get('peers', {}))} peer(s) · lag {lag} ops · "
                  f"{div} divergence")


def _eval_serve(doc: Dict) -> tuple:
    q = doc.get("queue", {})
    recent = int(doc.get("recent_sheds",
                         q.get("verdicts", {}).get("shed", 0)))
    overloaded = bool(doc.get("overloaded") or q.get("backpressure"))
    code = 1 if (overloaded or recent) else 0
    return code, (f"{doc.get('sessions', 0)} session(s) · "
                  f"depth {q.get('depth', 0)}/{q.get('max_depth', 0)} · "
                  f"recent sheds {recent}"
                  + (" · OVERLOADED" if overloaded else ""))


def _eval_fleet(doc: Dict) -> tuple:
    leases = doc.get("leases", {}).get("leases", {})
    dead = sum(1 for r in leases.values() if r.get("verdict") == "dead")
    failed = len(doc.get("failed_docs", []))
    code = 1 if (dead or failed) else 0
    return code, (f"{len(doc.get('hosts', {}))} host(s) · {dead} dead · "
                  f"{len(doc.get('serving', {}))} docs · "
                  f"{failed} failed · "
                  f"{doc.get('failovers', 0)} failover(s)")


def _eval_latency(doc: Dict) -> tuple:
    slo = doc.get("slo", {})
    burn = float(slo.get("burn_rate", 0.0) or 0.0)
    code = 1 if burn > 1.0 else 0
    return code, (f"windows {doc.get('windows', 0)} · "
                  f"burn rate {burn} · "
                  f"violating {slo.get('violating_frac', 0)}")


def _eval_incidents(doc: Dict) -> tuple:
    open_count = int(doc.get("open", 0))
    code = 1 if open_count else 0
    kinds = ",".join(
        k for k, v in doc.get("by_kind", {}).items() if v
    )
    return code, (f"{open_count} open · {doc.get('resolved', 0)} resolved"
                  + (f" · {kinds}" if kinds else ""))


def _eval_devprof(doc: Dict) -> tuple:
    sites = doc.get("sites", {}) or {}
    dispatches = sum(int(r.get("dispatches", 0)) for r in sites.values())
    tot = doc.get("occupancy_totals", {}) or {}
    # informational: the profiler reports cost, it has no health verdict.
    # The port's sites are its ops-level launch entry points, not jit
    # executables: "ops" is the one word of ``status`` output that differs
    # from the reference package's CLI (the same width as its "jit", so
    # the table's layout is the same)
    return 0, (f"{len(sites)} ops site(s) · dispatches {dispatches} · "
               f"padding_waste {tot.get('padding_waste', 0)}")


def _eval_plan(doc: Dict) -> tuple:
    modeled = doc.get("modeled", {}) or {}
    cur = modeled.get("current_score") or 0
    new = modeled.get("proposed_score")
    tol = modeled.get("tolerance", 0.1)
    # the `plan` command's own contract: stale statics are exit 1
    stale = bool(cur) and new is not None and (cur - new) / cur > tol
    hist = modeled.get("history") or {}
    return (1 if stale else 0), (
        f"score {cur} -> {new} · "
        f"savings {modeled.get('savings_frac', 0)}"
        + (f" · history rows {hist.get('rows')}" if hist else "")
        + (" · STALE STATICS" if stale else "")
    )


def _eval_timeseries(doc: Dict) -> tuple:
    anomaly = doc.get("anomaly", {}) or {}
    active = anomaly.get("active") or []
    kinds = ",".join(sorted({a.get("kind", "?") for a in active}))
    return (1 if active else 0), (
        f"rounds {doc.get('rounds', 0)} · "
        f"frames {doc.get('frames_retained', 0)} · "
        f"segments {doc.get('segments', 0)} · "
        f"{len(active)} active anomaly(ies)"
        + (f" · {kinds}" if kinds else "")
    )


def _eval_trace(doc) -> tuple:
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else (doc or [])
    spans = sum(1 for e in events
                if isinstance(e, dict) and e.get("ph") == "X")
    # informational: a trace dump is evidence, not a verdict
    return 0, f"{len(events)} event(s) · {spans} span(s)"


#: every JSON endpoint MetricsServer can mount has a row here — the
#: surface-mount audit test (tests/test_torch_obs_cli.py) pins route stems
#: == status plane stems, so adding an endpoint without a status row (or
#: vice versa) fails loudly
_STATUS_PLANES = (
    ("health", _eval_health),
    ("convergence", _eval_convergence),
    ("serve", _eval_serve),
    ("fleet", _eval_fleet),
    ("latency", _eval_latency),
    ("incidents", _eval_incidents),
    ("devprof", _eval_devprof),
    ("plan", _eval_plan),
    ("timeseries", _eval_timeseries),
    ("trace", _eval_trace),
)


def _status_source(src: str, plane: str):
    """One plane's JSON body from a MetricsServer base URL or snapshot
    dir.  Returns the parsed body, None when the plane is absent (no
    route / no file), or raises for a present-but-unreadable source."""
    if src.startswith(("http://", "https://")):
        import urllib.error
        import urllib.request

        url = f"{src.rstrip('/')}/{plane}.json"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None  # plane not mounted on this server
            raise
    path = Path(src) / f"{plane}.json"
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _status_rows(src: str) -> tuple:
    """Evaluate every mounted plane at ``src`` — shared by ``status``
    and ``top``.  Returns ``(rows, codes)``; absent planes are skipped,
    present-but-unreadable ones render as exit-2 rows."""
    rows = []
    codes = []
    for plane, evaluator in _STATUS_PLANES:
        try:
            doc = _status_source(src, plane)
        except Exception as exc:  # noqa: BLE001 - every failure renders as a row
            rows.append({"plane": plane, "status": "UNREADABLE",
                         "exit": 2, "summary": str(exc)})
            codes.append(2)
            continue
        if doc is None:
            continue
        code, summary = evaluator(doc)
        rows.append({
            "plane": plane,
            "status": "ok" if code == 0 else "ATTENTION",
            "exit": code,
            "summary": summary,
        })
        codes.append(code)
    return rows, codes


def _status_command(args) -> int:
    """The one-look fleet roll-up (see module doc)."""
    rows, codes = _status_rows(args.src)
    if not rows:
        print(f"status: no plane snapshots found at {args.src} "
              "(expected <plane>.json files or MetricsServer routes)",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps({"src": args.src, "exit": max(codes),
                          "planes": rows}, indent=2))
    else:
        print(f"{args.src} · {len(rows)} plane(s) · "
              f"{sum(1 for c in codes if c)} need attention")
        print(render_table(rows, cols=["plane", "status", "exit", "summary"],
                           left_cols=2))
    # composite contract: the worst per-plane exit code wins
    return max(codes)


# -- history view (/timeseries.json scrapes) ---------------------------------


def _load_history(src: str) -> Dict:
    """The history plane's snapshot from a MetricsServer base URL, a
    snapshot directory (``timeseries.json`` or ``history.json``), a
    ``health.json`` body carrying a ``history`` key, or a direct file."""
    if src.startswith(("http://", "https://")):
        doc = _status_source(src, "timeseries")
        if doc is None:
            raise ValueError("no /timeseries.json route mounted")
    else:
        p = Path(src)
        if p.is_file():
            doc = json.loads(p.read_text())
        else:
            doc = None
            for stem in ("timeseries", "history", "health"):
                f = p / f"{stem}.json"
                if f.exists():
                    doc = json.loads(f.read_text())
                    break
            if doc is None:
                raise ValueError(
                    f"no timeseries.json/history.json under {src}")
    if (isinstance(doc, dict) and "tiers" not in doc
            and isinstance(doc.get("history"), dict)):
        doc = doc["history"]  # health.json composition
    if not isinstance(doc, dict) or "tiers" not in doc:
        raise ValueError(f"{src}: not a history-plane snapshot")
    return doc


def _history_command(args) -> int:
    """Render the history plane's trend view (see module doc)."""
    from .timeseries import (
        chronological_frames,
        key_summary,
        series_points,
        series_rate,
        snapshot_keys,
    )

    try:
        snap = _load_history(args.src)
    except Exception as exc:  # noqa: BLE001 - every failure is one typed exit
        print(f"unreadable history snapshot {args.src}: {exc}",
              file=sys.stderr)
        return 2
    anomaly = snap.get("anomaly", {}) or {}
    active = anomaly.get("active") or []
    frames = chronological_frames(snap)
    header = (
        f"{snap.get('host', '?')} · rounds {snap.get('rounds', 0)} · "
        f"{snap.get('frames_retained', len(frames))} frame(s) across "
        f"{len(snap.get('tiers') or [])} tier(s) · "
        f"{snap.get('segments', 0)} segment(s) · "
        f"{len(active)} active anomaly(ies)"
    )
    if args.key:
        points = series_points(snap, args.key, window=args.window)
        if not points:
            print(f"history: no points for key '{args.key}' "
                  f"({len(snapshot_keys(snap))} keys retained)",
                  file=sys.stderr)
            return 2
        summary = key_summary(snap, args.key, window=args.window)
        if args.json:
            body = {"key": args.key, "points": points, "summary": summary,
                    "anomalies": active}
            if args.rate:
                body["rate"] = series_rate(points)
            print(json.dumps(body, indent=2))
        else:
            print(header)
            rates = {r: v for r, v in series_rate(points)}
            rows = []
            for r, v in points:
                row = {"round": int(r), "value": v}
                if args.rate:
                    row["rate"] = rates.get(r, "-")
                rows.append(row)
            cols = ["round", "value"] + (["rate"] if args.rate else [])
            print(render_table(rows, cols=cols, left_cols=0))
            print(
                f"{args.key}: min {summary['min']} · max {summary['max']} · "
                f"p50 {summary['p50']} · p95 {summary['p95']} · "
                f"delta {summary['delta']}"
            )
    else:
        summaries = [
            key_summary(snap, key, window=args.window)
            for key in snapshot_keys(snap)
        ]
        summaries = [s for s in summaries if s.get("points")]
        # the moving gauges lead; ties break on the key itself
        summaries.sort(key=lambda s: (-abs(s.get("delta") or 0.0), s["key"]))
        if args.json:
            print(json.dumps({"src": args.src, "summaries": summaries,
                              "anomalies": active}, indent=2))
        else:
            print(header)
            rows = [
                {"key": s["key"], "points": s["points"], "first": s["first"],
                 "last": s["last"], "delta": s["delta"], "min": s["min"],
                 "max": s["max"]}
                for s in summaries
            ]
            if rows:
                print(render_table(
                    rows, cols=["key", "points", "first", "last", "delta",
                                "min", "max"], left_cols=1))
            else:
                print("no gauge frames retained yet")
    if active and not args.json:
        for a in active:
            print(
                f"anomaly: {a.get('key')} [{a.get('kind')}] z={a.get('z')} "
                f"value {a.get('value')} vs median {a.get('median')} "
                f"@ round {a.get('round')}", file=sys.stderr,
            )
    # an active anomaly is exit 1: the command doubles as a fleet drift
    # check (CI / cron), mirroring serve/fleet/incidents
    return 1 if active else 0


def _top_command(args) -> int:
    """The single-refresh fleet dashboard (see module doc)."""
    from .timeseries import key_summary, snapshot_keys

    rows, codes = _status_rows(args.src)
    if not rows:
        print(f"top: no plane snapshots found at {args.src} "
              "(expected <plane>.json files or MetricsServer routes)",
              file=sys.stderr)
        return 2
    try:
        snap = _load_history(args.src)
    except Exception:  # noqa: BLE001 - the dashboard degrades to status-only
        snap = None
    movers: List[Dict] = []
    active: List[Dict] = []
    if snap is not None:
        anomaly = snap.get("anomaly", {}) or {}
        active = anomaly.get("active") or []
        summaries = [key_summary(snap, k, window=args.window)
                     for k in snapshot_keys(snap)]
        movers = [s for s in summaries if s.get("points") and s.get("delta")]
        movers.sort(key=lambda s: (-abs(s.get("delta") or 0.0), s["key"]))
        movers = movers[:args.top]
    if args.json:
        print(json.dumps({
            "src": args.src, "exit": max(codes), "planes": rows,
            "movers": movers, "anomalies": active,
        }, indent=2))
        return max(codes)
    print(f"{args.src} · {len(rows)} plane(s) · "
          f"{sum(1 for c in codes if c)} need attention · "
          f"{len(active)} active anomaly(ies)")
    print(render_table(rows, cols=["plane", "status", "exit", "summary"],
                       left_cols=2))
    if movers:
        window = args.window if args.window else "all"
        print(f"top {len(movers)} mover(s) over the trailing "
              f"{window} frame(s):")
        print(render_table(
            [{"key": s["key"], "first": s["first"], "last": s["last"],
              "delta": s["delta"]} for s in movers],
            cols=["key", "first", "last", "delta"], left_cols=1))
    elif snap is not None:
        print("history: no gauge movement recorded")
    else:
        print("history: plane not mounted (arm GLOBAL_HISTORY to trend)")
    for a in active:
        print(f"anomaly: {a.get('key')} [{a.get('kind')}] z={a.get('z')} "
              f"@ round {a.get('round')}", file=sys.stderr)
    # status semantics: the worst plane wins (an active anomaly already
    # surfaces as the timeseries plane's exit-1 row)
    return max(codes)


def _flight_command(args) -> int:
    """Render the merged cross-host black-box timeline (see module doc)."""
    from .incidents import merge_flight_dumps

    root = Path(args.dir)
    if not root.is_dir():
        print(f"flight: {args.dir} is not a directory", file=sys.stderr)
        return 2
    dumps = sorted(root.glob("flight-*.jsonl"))
    if not dumps:
        print(f"flight: no flight-*.jsonl dumps under {args.dir}",
              file=sys.stderr)
        return 2
    merged = merge_flight_dumps(dumps)
    if args.json:
        print(json.dumps(merged, indent=2, default=str))
        return 0
    base = (float(merged["timeline"][0].get("ts", 0.0) or 0.0)
            if merged["timeline"] else 0.0)
    print(f"{len(merged['dumps'])} dump(s) · "
          f"{len(merged['hosts'])} host(s) · {merged['records']} record(s) · "
          f"{len(merged['traces'])} trace(s)"
          + (f" · {merged['skipped']} skipped" if merged["skipped"] else ""))
    rows = []
    for rec in merged["timeline"][-args.tail:]:
        label = (rec.get("name") or rec.get("reason")
                 or rec.get("provider") or "")
        rows.append({
            "t_ms": round((float(rec.get("ts", 0.0) or 0.0) - base) * 1e3, 3),
            "host": rec.get("host", "?"),
            "kind": rec.get("kind", "?"),
            "what": label,
            "trace": (str(rec.get("trace_id"))[-8:]
                      if rec.get("trace_id") else ""),
        })
    if rows:
        print(render_table(rows, cols=["t_ms", "host", "kind", "what",
                                       "trace"], left_cols=0))
    for trace, recs in sorted(merged["traces"].items()):
        hosts = sorted({r["host"] for r in recs})
        print(f"  trace …{trace[-8:]}: {len(recs)} record(s) across "
              f"{','.join(hosts)}")
    return 0


def _perf_command(args) -> int:
    """Render/gate the perf ledger (see module doc)."""
    from . import ledger as _ledger

    try:
        records = _ledger.load_ledger(args.ledger)
    except (OSError, ValueError) as exc:
        print(f"unreadable perf ledger {args.ledger}: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"empty perf ledger {args.ledger}", file=sys.stderr)
        return 2
    report = _ledger.evaluate(
        records,
        tolerance=(args.tolerance / 100.0 if args.tolerance is not None
                   else None),
        window=args.window if args.window is not None else _ledger.DEFAULT_WINDOW,
        match=args.match,
    )
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        cand = report["candidate"]
        sha = (cand.get("sha") or "?")[:12]
        dev = (cand.get("device") or {})
        print(
            f"{len(records)} record(s) · candidate sha {sha} · "
            f"config {cand.get('config')} · device "
            f"{dev.get('platform')}/{dev.get('kind')} · "
            f"{report['reference_records']} matching reference record(s)"
        )
        rows = [
            {
                "row": v["row"],
                "unit": v["unit"],
                "ref": "-" if v["ref"] is None else v["ref"],
                "value": "-" if v["value"] is None else v["value"],
                "delta_pct": "-" if v["delta_pct"] is None else v["delta_pct"],
                "band_pct": v["band_pct"],
                "status": v["status"],
            }
            for v in report["rows"]
        ]
        if rows:
            print(render_table(
                rows,
                cols=["row", "unit", "ref", "value", "delta_pct",
                      "band_pct", "status"],
            ))
        else:
            print("candidate record carries no rows")
    if args.gate and report["regressed"]:
        print("perf gate: REGRESSION detected", file=sys.stderr)
        return 1
    return 0


def _why_command(args) -> int:
    """Render the latency-plane regression attribution (see module doc)."""
    from . import ledger as _ledger
    from .latency import STAGES, attribute

    try:
        records = _ledger.load_ledger(args.ledger)
    except (OSError, ValueError) as exc:
        print(f"unreadable perf ledger {args.ledger}: {exc}", file=sys.stderr)
        return 2
    if not records:
        print(f"empty perf ledger {args.ledger}", file=sys.stderr)
        return 2
    try:
        report = attribute(
            records,
            row=args.row,
            window=args.window,
            match=args.match,
            tolerance=(args.tolerance / 100.0 if args.tolerance is not None
                       else None),
        )
    except ValueError as exc:
        print(f"why: {exc}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        cand = report["candidate"]
        sha = (cand.get("sha") or "?")[:12]
        print(
            f"{len(records)} record(s) · candidate sha {sha} · "
            f"{report['reference_records']} matching reference record(s)"
        )
        if report["verdict"] == "clean":
            print("why: gate passes — nothing to attribute")
            return 0
        print(
            f"row {report['row']} [{report['status']}]: "
            f"{report['ref']} -> {report['value']} {report['unit']} "
            f"(delta {report['delta']}"
            + (f", {report['delta_pct']}%" if report.get("delta_pct")
               is not None else "")
            + ")"
        )
        cand_stages = report.get("candidate_stages_ms")
        ref_stages = report.get("reference_stages_ms")
        deltas = report.get("stage_deltas_ms")
        if cand_stages and ref_stages and deltas is not None:
            rows = [
                {
                    "stage": s,
                    "ref_ms": ref_stages.get(s, "-"),
                    "value_ms": cand_stages.get(s, "-"),
                    "delta_ms": deltas.get(s, "-"),
                }
                for s in sorted(
                    set(cand_stages) | set(ref_stages),
                    key=lambda n: (STAGES.index(n) if n in STAGES
                                   else len(STAGES), n),
                )
            ]
            print(render_table(
                rows, cols=["stage", "ref_ms", "value_ms", "delta_ms"],
                left_cols=1,
            ))
        dp = report.get("devprof")
        if dp:
            d = dp["delta"]
            print(
                "devprof: distinct_shapes "
                f"{d.get('distinct_shapes')} · dispatches "
                f"{d.get('dispatches')} · padding_waste "
                f"{d.get('padding_waste')}"
            )
        if report["verdict"] == "regression-attributed":
            print(f"why: dominant moved stage is "
                  f"'{report['dominant_stage']}'", file=sys.stderr)
        elif report["verdict"] == "no-decomposition":
            print(
                "why: no latency decomposition on candidate or reference "
                "rows — arm the plane and re-run the bench", file=sys.stderr,
            )
        else:
            print(
                "why: regression with no stage moving up — look outside "
                "the latency plane", file=sys.stderr,
            )
    # a regression — whether or not attribution could name a stage — is
    # exit 1, mirroring `perf --gate`; clean is 0
    return 0 if report["verdict"] == "clean" else 1


def _plan_command(args) -> int:
    """The closed-loop planner's operator surface (see module doc)."""
    from ..plan import PlanProposal, propose  # noqa: F401 - typed surface
    from ..plan.model import load_devprof

    try:
        snapshot = load_devprof(args.snapshot)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"unreadable devprof snapshot {args.snapshot}: {exc}",
              file=sys.stderr)
        return 2
    ledger_records = None
    if args.ledger:
        from . import ledger as _ledger

        try:
            ledger_records = _ledger.load_ledger(args.ledger)
        except (OSError, ValueError) as exc:
            print(f"unreadable perf ledger {args.ledger}: {exc}",
                  file=sys.stderr)
            return 2
    history = None
    if getattr(args, "history", None):
        # a timeseries.json snapshot, a health.json carrying `history`,
        # or a plain JSON list of occupancy rows/floats — anything
        # plan.history_values normalizes
        try:
            history = json.loads(Path(args.history).read_text())
        except (OSError, json.JSONDecodeError) as exc:
            print(f"unreadable occupancy history {args.history}: {exc}",
                  file=sys.stderr)
            return 2
        if (isinstance(history, dict) and "occupancy_rows" not in history
                and isinstance(history.get("history"), dict)):
            history = history["history"]
    tolerance = (args.tolerance / 100.0 if args.tolerance is not None
                 else None)
    kwargs = {} if tolerance is None else {"tolerance": tolerance}
    proposal = propose(snapshot, ledger_records, history=history, **kwargs)
    stale = proposal.beats_current(
        tolerance if tolerance is not None else
        proposal.modeled.get("tolerance", 0.1)
    )
    if args.json:
        print(json.dumps(
            {**proposal.to_json(), "beats_current": stale}, indent=2,
        ))
    else:
        modeled = proposal.modeled
        print(
            f"planner: modeled score {modeled['current_score']} -> "
            f"{modeled['proposed_score']} "
            f"(savings {modeled['savings_frac'] * 100:.1f}%, tolerance "
            f"{modeled['tolerance'] * 100:.0f}%, utilization "
            f"{modeled['utilization'] * 100:.1f}%)"
        )
        body = proposal.to_json()
        rows = [
            {"static": key,
             "current": body["current"].get(key, "-"),
             "proposed": body["proposal"][key]}
            for key in body["proposal"]
        ]
        print(render_table(rows, cols=["static", "current", "proposed"],
                           left_cols=1))
        print(
            f"modeled: padded_flops {modeled['padded_flops_current']} -> "
            f"{modeled['padded_flops_proposed']} · recompiles "
            f"{modeled['recompiles_current']} -> "
            f"{modeled['recompiles_proposed']} · dispatches "
            f"{modeled['dispatches_current']} -> "
            f"{modeled['dispatches_proposed']}"
        )
        hist = modeled.get("history")
        if hist:
            occ = hist.get("occupancy") or {}
            print(
                f"history: {hist['rows']} occupancy row(s) · "
                f"p90 {occ.get('p90')} · sparse_frac "
                f"{occ.get('sparse_frac')} · dispatch weight "
                f"x{hist['dispatch_weight_factor']} · "
                "history-weighted terms: "
                + ", ".join(hist["weighted_terms"])
            )
        if stale:
            print(
                "plan: proposal beats current statics beyond tolerance — "
                "replay it through a bench row before re-pinning",
                file=sys.stderr,
            )
        else:
            print("plan: current statics are within tolerance")
    # "stale statics" is exit 1: the command doubles as a CI/cron check
    # that the pinned configuration still matches the observed workload
    return 1 if stale else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # default command: `python -m peritext_tpu_torch.obs trace.json` == summary
    if argv and argv[0] not in ("summary", "merge", "fleet", "serve", "perf",
                                "plan", "why", "incidents", "status",
                                "history", "top", "flight", "-h", "--help"):
        argv.insert(0, "summary")
    parser = argparse.ArgumentParser(
        prog="python -m peritext_tpu_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd")
    p_sum = sub.add_parser("summary", help="per-stage/per-host summary table")
    p_sum.add_argument("paths", nargs="+")
    p_sum.add_argument("--json", action="store_true",
                       help="machine-readable rows instead of the table")
    p_merge = sub.add_parser("merge", help="merge chrome traces into one")
    p_merge.add_argument("paths", nargs="+")
    p_merge.add_argument("-o", "--out", required=True)
    p_fleet = sub.add_parser(
        "fleet", help="per-peer replication-lag table from convergence.json "
        "scrapes",
    )
    p_fleet.add_argument("paths", nargs="+")
    p_fleet.add_argument("--json", action="store_true",
                         help="machine-readable rows instead of the table")
    p_serve = sub.add_parser(
        "serve", help="per-host serving-tier load table from serve.json "
        "scrapes (exit 1 on overload/shedding)",
    )
    p_serve.add_argument("paths", nargs="+")
    p_serve.add_argument("--json", action="store_true",
                         help="machine-readable rows instead of the table")
    p_perf = sub.add_parser(
        "perf", help="perf-ledger diff table: last record vs its rolling "
        "same-device reference",
    )
    p_perf.add_argument("ledger", help="JSONL perf-ledger path")
    p_perf.add_argument("--gate", action="store_true",
                        help="exit 1 when any row regresses beyond its band")
    p_perf.add_argument("--json", action="store_true",
                        help="machine-readable verdicts instead of the table")
    p_perf.add_argument("--tolerance", type=float, default=None, metavar="PCT",
                        help="override every row's tolerance band (percent)")
    p_perf.add_argument("--window", type=int, default=None, metavar="N",
                        help="rolling-reference window (prior records; "
                        "default 5)")
    p_perf.add_argument("--match", choices=("device", "platform", "any"),
                        default="device",
                        help="how strictly reference records must match the "
                        "candidate's device fingerprint (default: device)")
    p_why = sub.add_parser(
        "why", help="latency-plane regression attribution: name the "
        "dominant moved stage behind a perf-gate failure (exit 1 on "
        "regression)",
    )
    p_why.add_argument("ledger", help="JSONL perf-ledger path")
    p_why.add_argument("--row", default=None, metavar="NAME",
                       help="attribute this row instead of the first "
                       "failing one")
    p_why.add_argument("--json", action="store_true",
                       help="machine-readable attribution instead of the "
                       "table")
    p_why.add_argument("--window", type=int, default=None, metavar="N",
                       help="rolling-reference window (prior records; "
                       "default 5)")
    p_why.add_argument("--match", choices=("device", "platform", "any"),
                       default="device",
                       help="how strictly reference records must match the "
                       "candidate's device fingerprint (default: device)")
    p_why.add_argument("--tolerance", type=float, default=None, metavar="PCT",
                       help="override every row's tolerance band (percent)")
    p_plan = sub.add_parser(
        "plan", help="closed-loop planner proposal from a devprof snapshot "
        "(exit 1 when the proposal beats the current statics)",
    )
    p_plan.add_argument("snapshot", help="devprof.json / health.json path")
    p_plan.add_argument("--ledger", default=None, metavar="PATH",
                        help="perf-ledger JSONL for the admission-window "
                        "term (optional)")
    p_plan.add_argument("--history", default=None, metavar="PATH",
                        help="history-plane snapshot (timeseries.json / "
                        "health.json) or occupancy-row JSON: weight the "
                        "cost model by the observed occupancy distribution")
    p_plan.add_argument("--json", action="store_true",
                        help="machine-readable proposal instead of the table")
    p_plan.add_argument("--tolerance", type=float, default=None, metavar="PCT",
                        help="savings band (percent) below which the current "
                        "statics stand (default 10)")
    p_inc = sub.add_parser(
        "incidents", help="correlated incident table from incidents.json "
        "scrapes (exit 1 on open incidents)",
    )
    p_inc.add_argument("paths", nargs="+")
    p_inc.add_argument("--json", action="store_true",
                       help="machine-readable rows instead of the table")
    p_status = sub.add_parser(
        "status", help="one-look roll-up across every plane from a live "
        "MetricsServer URL or a snapshot directory (exit = worst plane)",
    )
    p_status.add_argument("src", help="http(s)://host:port base URL or a "
                          "directory of <plane>.json snapshots")
    p_status.add_argument("--json", action="store_true",
                          help="machine-readable plane rows instead of the "
                          "table")
    p_hist = sub.add_parser(
        "history", help="history-plane trend table from a timeseries.json "
        "scrape / snapshot dir / URL (exit 1 on active anomaly)",
    )
    p_hist.add_argument("src", help="MetricsServer base URL, snapshot "
                        "directory, or timeseries.json file")
    p_hist.add_argument("--key", default=None, metavar="GAUGE",
                        help="render one gauge's [round, value] points "
                        "instead of the per-key trend table")
    p_hist.add_argument("--window", type=int, default=None, metavar="N",
                        help="trailing frames to summarize (default: all "
                        "retained)")
    p_hist.add_argument("--rate", action="store_true",
                        help="with --key: add the per-round derivative "
                        "column")
    p_hist.add_argument("--json", action="store_true",
                        help="machine-readable body instead of the table")
    p_top = sub.add_parser(
        "top", help="single-refresh fleet dashboard: plane status roll-up "
        "+ the history plane's biggest movers (exit = worst plane)",
    )
    p_top.add_argument("src", help="http(s)://host:port base URL or a "
                       "directory of <plane>.json snapshots")
    p_top.add_argument("--window", type=int, default=16, metavar="N",
                       help="trailing frames for the movers table "
                       "(default 16)")
    p_top.add_argument("--top", type=int, default=10, metavar="N",
                       help="movers to show (default 10)")
    p_top.add_argument("--json", action="store_true",
                       help="machine-readable dashboard instead of tables")
    p_flight = sub.add_parser(
        "flight", help="merged cross-host black-box timeline from a "
        "directory of flight-recorder dumps",
    )
    p_flight.add_argument("dir", help="directory holding flight-*.jsonl "
                          "dumps")
    p_flight.add_argument("--json", action="store_true",
                          help="machine-readable merged timeline instead of "
                          "the table")
    p_flight.add_argument("--tail", type=int, default=40, metavar="N",
                          help="show the last N timeline records "
                          "(default 40)")
    args = parser.parse_args(argv)
    if args.cmd is None:
        parser.print_help()
        return 2

    if args.cmd == "perf":
        return _perf_command(args)

    if args.cmd == "why":
        return _why_command(args)

    if args.cmd == "plan":
        return _plan_command(args)

    if args.cmd == "incidents":
        return _incidents_command(args)

    if args.cmd == "status":
        return _status_command(args)

    if args.cmd == "history":
        return _history_command(args)

    if args.cmd == "top":
        return _top_command(args)

    if args.cmd == "flight":
        return _flight_command(args)

    if args.cmd == "serve":
        snapshots = []
        for p in args.paths:
            try:
                snapshots.append(load_serve(p))
            except (OSError, ValueError, json.JSONDecodeError) as exc:
                print(f"unreadable serve snapshot {p}: {exc}",
                      file=sys.stderr)
                return 2
        rows = serve_rows(snapshots)
        # SUSTAINED overload/shedding only: backpressure currently engaged,
        # or sheds since the tier last kept up — a host that shed during a
        # past blip and recovered must not latch unhealthy forever
        total_shed = sum(r["recent_sheds"] for r in rows)
        overloaded = sum(1 for r in rows if r["overloaded"] == "YES")
        if args.json:
            print(json.dumps({
                "hosts": len(snapshots), "overloaded_hosts": overloaded,
                "total_shed": total_shed, "rows": rows,
            }, indent=2))
        else:
            print(f"{len(snapshots)} host(s) · {overloaded} overloaded · "
                  f"{total_shed} frame(s) recently shed")
            print(render_table(
                rows,
                cols=["host", "sessions", "docs", "depth", "peak",
                      "admitted", "delayed", "shed", "recent_sheds",
                      "degraded", "window_ms", "overloaded"],
                left_cols=1,
            ))
            for r in rows:
                if r["shed_reasons"]:
                    print(f"  {r['host']}: shed {r['shed_reasons']}")
        # a tier under sustained overload or shedding load is exit 1: the
        # command doubles as a CI/cron serving-health check
        return 1 if (overloaded or total_shed) else 0

    if args.cmd == "fleet":
        snapshots = []
        for p in args.paths:
            try:
                snapshots.append(load_convergence(p))
            except (OSError, ValueError, json.JSONDecodeError) as exc:
                print(f"unreadable convergence snapshot {p}: {exc}",
                      file=sys.stderr)
                return 2
        rows = fleet_rows(snapshots)
        incidents = sum(s.get("divergence_incidents", 0) for s in snapshots)
        total_lag = sum(r["lag_ops"] for r in rows)
        if args.json:
            print(json.dumps({
                "hosts": len(snapshots), "total_lag_ops": total_lag,
                "divergence_incidents": incidents, "rows": rows,
            }, indent=2))
        else:
            print(f"{len(snapshots)} host(s) · {len(rows)} peer link(s) · "
                  f"lag {total_lag} ops · {incidents} divergence incident(s)")
            print(render_table(
                rows,
                cols=["host", "peer", "lag_ops", "ahead_ops", "stale_rounds",
                      "failures", "outcome", "divergent"],
            ))
        # a fleet with outstanding lag or any divergence is exit 1: the
        # command doubles as a CI/cron convergence check
        return 1 if (total_lag or incidents) else 0

    if args.cmd == "merge":
        from .spans import merge_traces

        traces = []
        for p in args.paths:
            try:
                traces.append(json.loads(Path(p).read_text()))
            except (OSError, json.JSONDecodeError) as exc:
                print(f"unreadable trace {p}: {exc}", file=sys.stderr)
                return 2
        Path(args.out).write_text(json.dumps(merge_traces(*traces)))
        print(f"merged {len(traces)} trace(s) -> {args.out}")
        return 0

    spans: List[Dict] = []
    for p in args.paths:
        try:
            spans.extend(load_spans(p))
        except (OSError, json.JSONDecodeError) as exc:
            print(f"unreadable trace {p}: {exc}", file=sys.stderr)
            return 2
    if not spans:
        print("no spans found", file=sys.stderr)
        return 1
    rows = summarize(spans)
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        hosts = sorted({sp["host"] for sp in spans})
        traces = sorted({sp["trace_id"] for sp in spans if sp["trace_id"]})
        print(f"{len(spans)} spans · {len(hosts)} host(s) · "
              f"{len(traces)} trace(s)")
        print(render_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
