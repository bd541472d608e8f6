"""History plane: round-counted time-series retention + anomaly scoring.

Every other plane answers "what is happening NOW"; this module retains
those answers over time so drift is visible.  It samples any set of plane
snapshots (health, serve, latency, page-pool: anything that is a dict or
exposes ``snapshot()``) into FRAMES held in a bounded in-memory ring and
optionally persisted as append-only JSONL segments.

**Retention tiers**: tier 0 holds recent frames at full rate; when it
overflows, its oldest ``merge_factor`` frames merge N:1 into one tier-1
frame, and so on down the cascade.  Every frame, raw or merged, keeps
``min``/``max``/``last`` per gauge, so a one-frame spike survives every
downsampling tier (the min/max envelope never forgets it) while storage
stays O(tiers × tier_capacity).  The last tier drops oldest-first.

**Determinism contract**: the plane is ROUND-counted, never wall-clocked.
``advance_round()``/``sample()`` advance a logical round counter; frames
are stamped with rounds; the anomaly scorer is a pure function of the
ring.  The plane reads no clock and no RNG: sampling overhead is measured
by CALLERS and fed in as data via :meth:`TimeSeriesPlane.note_overhead`.
Persisted segments replay byte-identically (:func:`replay_segments`).

**Anomaly scoring**: per gauge key, a rolling-median + MAD z-score over
the tier-0 ring (``z = 0.6745·|x − med| / MAD``).  A zero MAD (flat
baseline) falls back to a relative floor scale so flat-then-spiked
counters still fire while float jitter on drifting gauges stays quiet.
Findings are typed dicts; :func:`anomaly_kind` maps a gauge key's source
prefix onto the incident taxonomy.

The occupancy channel (:meth:`TimeSeriesPlane.record_occupancy`) takes
one row per lane per committed window from the fused serving tier; the
snapshot reports the rows and their distribution (p90 utilization, the
sparse-window fraction), the raw material a planner weights by.

Off by default: arming is ``plane.enable()``, and every feed site checks
``plane.enabled``.
"""

from __future__ import annotations

import json
import math
import threading
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

#: when a gauge's rolling MAD is exactly zero (flat baseline), the z-score
#: falls back to ``|x − med| / max(|med| · FRAC, ABS)`` — large enough to
#: fire on a genuine spike from a flat line, forgiving enough that float
#: jitter on a drifting gauge stays quiet
MAD_FLOOR_FRAC = 0.05
MAD_FLOOR_ABS = 1e-6

#: z-scores are capped so a spike over a zero-MAD baseline stays finite
#: and JSON-safe
Z_CAP = 1e9

#: gauge-key prefix -> incident kind for anomaly findings (first match
#: wins; walked in tuple order, so the order IS the contract).  Keys are
#: prefixed by the ``sample(**sources)`` kwarg that produced them.
ANOMALY_KIND_PREFIXES = (
    ("convergence.", "divergence"),
    ("fleet.", "host-death"),
    ("jit.", "recompile-storm"),
    ("latency.", "slo-burn"),
    ("recompiles.", "recompile-storm"),
    ("serve.", "shed-storm"),
    ("session.", "quarantine-storm"),
)

#: anything unmapped (plan., devprof., probe., ...) is a perf concern
ANOMALY_DEFAULT_KIND = "perf-regression"


def anomaly_kind(key: str) -> str:
    """Map a flattened gauge key onto the existing incident taxonomy."""
    for prefix, kind in ANOMALY_KIND_PREFIXES:
        if key.startswith(prefix):
            return kind
    return ANOMALY_DEFAULT_KIND


# -- pure helpers (shared by the plane, the exporter route, and the CLI) -----


def _snap(obj: Any) -> Dict[str, Any]:
    """Normalize a sample source: a plain dict passes through, a live
    plane contributes its ``snapshot()``."""
    if isinstance(obj, dict):
        return obj
    snap = getattr(obj, "snapshot", None)
    if callable(snap):
        body = snap()
        if isinstance(body, dict):
            return body
    raise TypeError(
        f"history source must be a dict or expose snapshot(): {type(obj)!r}"
    )


def _flatten(prefix: str, value: Any, out: Dict[str, float]) -> None:
    """Collapse a snapshot to dotted-key numeric gauges.  Bools become
    0/1, non-finite floats are dropped (JSON safety), strings/lists are
    skipped — gauges are the retained signal, labels are not."""
    if isinstance(value, bool):
        out[prefix] = 1.0 if value else 0.0
    elif isinstance(value, (int, float)):
        v = float(value)
        if math.isfinite(v):
            out[prefix] = v
    elif isinstance(value, dict):
        for k in sorted(value, key=str):
            _flatten(f"{prefix}.{k}", value[k], out)


def flatten_gauges(name: str, source: Any) -> Dict[str, float]:
    """Public flattening entry: ``{name}.{dotted.path}: float``."""
    out: Dict[str, float] = {}
    _flatten(name, _snap(source), out)
    return out


def _median(values: Sequence[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    mid = n // 2
    if n % 2:
        return float(vs[mid])
    return (float(vs[mid - 1]) + float(vs[mid])) / 2.0


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Ceil-rank percentile over an ascending list (deterministic)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, math.ceil(q * len(sorted_vals)) - 1)
    return float(sorted_vals[min(idx, len(sorted_vals) - 1)])


def mad_z(value: float, baseline: Sequence[float]) -> float:
    """The anomaly score: robust z over a rolling baseline (see module
    doc for the zero-MAD floor rule).  Pure — no clock, no RNG."""
    med = _median(baseline)
    mad = _median([abs(v - med) for v in baseline])
    if mad > 0.0:
        scale = mad
    else:
        scale = max(abs(med) * MAD_FLOOR_FRAC, MAD_FLOOR_ABS)
    return min(0.6745 * abs(value - med) / scale, Z_CAP)


def chronological_frames(snap: Dict[str, Any]) -> List[Dict[str, Any]]:
    """All retained frames oldest -> newest: the deepest (most merged)
    tier holds the oldest history, tier 0 the newest."""
    frames: List[Dict[str, Any]] = []
    for tier in reversed(snap.get("tiers") or []):
        frames.extend(tier)
    return frames


def snapshot_keys(snap: Dict[str, Any]) -> List[str]:
    """Sorted union of gauge keys across every retained frame."""
    keys = set()
    for frame in chronological_frames(snap):
        keys.update(frame.get("gauges") or ())
    return sorted(keys)


def series_points(snap: Dict[str, Any], key: str,
                  window: Optional[int] = None) -> List[List[float]]:
    """``[[round, last], ...]`` for one gauge key, oldest -> newest,
    optionally limited to the trailing ``window`` points."""
    points: List[List[float]] = []
    for frame in chronological_frames(snap):
        g = (frame.get("gauges") or {}).get(key)
        if g is not None:
            points.append([frame.get("round_last", frame.get("round", 0)),
                           g["last"]])
    if window is not None and window > 0:
        points = points[-window:]
    return points


def series_rate(points: Sequence[Sequence[float]]) -> List[List[float]]:
    """Per-round derivative between consecutive points: ``[[round,
    (v - v_prev) / (round - round_prev)], ...]`` (the counter-rate view)."""
    rates: List[List[float]] = []
    for prev, cur in zip(points, points[1:]):
        dr = cur[0] - prev[0]
        if dr > 0:
            rates.append([cur[0], round((cur[1] - prev[1]) / dr, 6)])
    return rates


def key_summary(snap: Dict[str, Any], key: str,
                window: Optional[int] = None) -> Dict[str, Any]:
    """Per-key percentile summary.  ``min``/``max`` come from the frame
    ENVELOPES (so spikes merged into deep tiers still count); percentiles
    are over last-values."""
    lasts: List[float] = []
    lo: Optional[float] = None
    hi: Optional[float] = None
    frames = chronological_frames(snap)
    if window is not None and window > 0:
        frames = frames[-window:]
    for frame in frames:
        g = (frame.get("gauges") or {}).get(key)
        if g is None:
            continue
        lasts.append(g["last"])
        lo = g["min"] if lo is None else min(lo, g["min"])
        hi = g["max"] if hi is None else max(hi, g["max"])
    if not lasts:
        return {"key": key, "points": 0}
    ordered = sorted(lasts)
    return {
        "key": key,
        "points": len(lasts),
        "min": lo,
        "max": hi,
        "mean": round(sum(lasts) / len(lasts), 6),
        "p50": _percentile(ordered, 0.50),
        "p95": _percentile(ordered, 0.95),
        "p99": _percentile(ordered, 0.99),
        "first": lasts[0],
        "last": lasts[-1],
        "delta": round(lasts[-1] - lasts[0], 6),
    }


def query_snapshot(snap: Dict[str, Any],
                   params: Dict[str, str]) -> Dict[str, Any]:
    """The ``/timeseries.json?...`` engine, shared with ``obs history``:
    no params -> the full snapshot; ``key=`` -> that gauge's points +
    summary (``rate=1`` adds the derivative); ``window=N`` without a key
    -> the trailing N frames."""
    key = params.get("key")
    raw_window = params.get("window")
    window = int(raw_window) if raw_window else None
    want_rate = str(params.get("rate", "")).lower() in ("1", "true", "yes")
    if key:
        points = series_points(snap, key, window=window)
        body: Dict[str, Any] = {
            "key": key,
            "points": points,
            "summary": key_summary(snap, key, window=window),
        }
        if want_rate:
            body["rate"] = series_rate(points)
        return body
    if window:
        return {
            "window": window,
            "frames": chronological_frames(snap)[-window:],
            "keys": snapshot_keys(snap),
        }
    return snap


def occupancy_distribution(values: Sequence[float]) -> Dict[str, Any]:
    """The distribution body a planner weights by: count, mean, the
    p10/p50/p90 spread, and the sparse-window fraction (occupancy < 0.5
    — windows that under-amortize the drain)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {"count": 0}
    sparse = sum(1 for v in vals if v < 0.5)
    return {
        "count": len(vals),
        "mean": round(sum(vals) / len(vals), 6),
        "p10": _percentile(vals, 0.10),
        "p50": _percentile(vals, 0.50),
        "p90": _percentile(vals, 0.90),
        "sparse_frac": round(sparse / len(vals), 6),
    }


def _merge_frames(chunk: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge N chronological frames into one downsampled frame: min of
    mins, max of maxes, last by round order, key union."""
    gauges: Dict[str, Dict[str, float]] = {}
    for frame in chunk:
        fg = frame["gauges"]
        for key in sorted(fg):
            g = fg[key]
            cur = gauges.get(key)
            if cur is None:
                gauges[key] = {"min": g["min"], "max": g["max"],
                               "last": g["last"]}
            else:
                cur["min"] = min(cur["min"], g["min"])
                cur["max"] = max(cur["max"], g["max"])
                cur["last"] = g["last"]
    return {
        "round": chunk[0]["round"],
        "round_last": chunk[-1]["round_last"],
        "frames": sum(int(f["frames"]) for f in chunk),
        "gauges": gauges,
    }


# -- the plane ---------------------------------------------------------------


class TimeSeriesPlane:
    """The history plane (see module doc).  Thread-safe; off by default.

    ``sample_every`` decimates :meth:`advance_round` (the periodic feed);
    :meth:`sample` always samples.  ``dir=`` arms JSONL persistence:
    every raw frame appends to ``history-<seg>.jsonl``, rotating after
    ``segment_frames`` frames — replay with :func:`replay_segments`.
    """

    def __init__(
        self,
        sample_every: int = 1,
        tier_capacity: int = 64,
        tiers: int = 3,
        merge_factor: int = 4,
        anomaly_window: int = 32,
        min_frames: int = 8,
        threshold: float = 6.0,
        segment_frames: int = 256,
        dir: Optional[Any] = None,
        host: str = "local",
        occupancy_cap: int = 1024,
    ) -> None:
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        if tiers < 1:
            raise ValueError(f"tiers must be >= 1, got {tiers}")
        if merge_factor < 2:
            raise ValueError(f"merge_factor must be >= 2, got {merge_factor}")
        if tier_capacity < merge_factor:
            raise ValueError(
                f"tier_capacity {tier_capacity} < merge_factor {merge_factor}"
            )
        if min_frames < 2:
            raise ValueError(f"min_frames must be >= 2, got {min_frames}")
        if segment_frames < 1:
            raise ValueError(
                f"segment_frames must be >= 1, got {segment_frames}"
            )
        self.enabled = False
        self.host = host
        self.sample_every = int(sample_every)
        self.tier_capacity = int(tier_capacity)
        self.merge_factor = int(merge_factor)
        self.anomaly_window = int(anomaly_window)
        self.min_frames = int(min_frames)
        self.threshold = float(threshold)
        self.segment_frames = int(segment_frames)
        self._dir = Path(dir) if dir is not None else None
        self._lock = threading.Lock()
        self.rounds = 0
        self.frames_sampled = 0
        self._tiers: List[deque] = [deque() for _ in range(int(tiers))]
        self._segment_index = 0
        self._segment_count = 0
        self._active: Dict[str, Dict[str, Any]] = {}
        self._anomaly_counts: Dict[str, int] = {}
        self._anomaly_first_round: Dict[str, int] = {}
        self.anomalies_total = 0
        self._occ_rows: deque = deque(maxlen=int(occupancy_cap))
        self.occupancy_total = 0
        self.overhead_seconds = 0.0

    # -- arming --------------------------------------------------------------

    def enable(self) -> "TimeSeriesPlane":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def __enter__(self) -> "TimeSeriesPlane":
        return self.enable()

    def __exit__(self, *exc) -> None:
        self.disable()

    # -- the feed ------------------------------------------------------------

    def advance_round(self, **sources: Any) -> Optional[Dict[str, Any]]:
        """The periodic feed: advance the round counter and, when armed
        and on the sampling cadence, sample ``sources`` into one frame.
        Returns the retained frame or None when decimated/disarmed."""
        with self._lock:
            self.rounds += 1
            if not self.enabled:
                return None
            if (self.rounds - 1) % self.sample_every:
                return None
            return self._sample_locked(sources)

    def sample(self, **sources: Any) -> Optional[Dict[str, Any]]:
        """Force one sample (still advances the round counter)."""
        with self._lock:
            self.rounds += 1
            if not self.enabled:
                return None
            return self._sample_locked(sources)

    def _sample_locked(self, sources: Dict[str, Any]) -> Dict[str, Any]:
        gauges: Dict[str, float] = {}
        for name in sorted(sources):
            _flatten(name, _snap(sources[name]), gauges)
        return self._ingest_locked(self.rounds, gauges)

    def ingest_raw(self, raw: Dict[str, Any]) -> Dict[str, Any]:
        """Re-feed one persisted raw frame through retention — the replay
        path.  The frame's own round stamp becomes the plane's clock."""
        with self._lock:
            self.rounds = int(raw["round"])
            gauges = {k: float(raw["gauges"][k]) for k in sorted(raw["gauges"])}
            return self._ingest_locked(self.rounds, gauges)

    def _ingest_locked(self, rnd: int,
                       gauges: Dict[str, float]) -> Dict[str, Any]:
        self.frames_sampled += 1
        self._persist_locked({"round": rnd, "gauges": gauges})
        frame = {
            "round": rnd,
            "round_last": rnd,
            "frames": 1,
            "gauges": {k: {"min": gauges[k], "max": gauges[k],
                           "last": gauges[k]} for k in sorted(gauges)},
        }
        self._retain_locked(frame)
        self._score_locked(frame)
        return frame

    def _persist_locked(self, raw: Dict[str, Any]) -> None:
        if self._dir is None:
            return
        self._dir.mkdir(parents=True, exist_ok=True)
        path = self._dir / f"history-{self._segment_index:05d}.jsonl"
        with path.open("a", encoding="utf-8") as fh:
            fh.write(json.dumps(raw, sort_keys=True) + "\n")
        self._segment_count += 1
        if self._segment_count >= self.segment_frames:
            self._segment_index += 1
            self._segment_count = 0

    def _retain_locked(self, frame: Dict[str, Any]) -> None:
        self._tiers[0].append(frame)
        for t in range(len(self._tiers) - 1):
            tier = self._tiers[t]
            while (len(tier) > self.tier_capacity
                   and len(tier) >= self.merge_factor):
                chunk = [tier.popleft() for _ in range(self.merge_factor)]
                self._tiers[t + 1].append(_merge_frames(chunk))
        last = self._tiers[-1]
        while len(last) > self.tier_capacity:
            last.popleft()

    def _score_locked(self, frame: Dict[str, Any]) -> None:
        prior = list(self._tiers[0])[:-1][-self.anomaly_window:]
        active: Dict[str, Dict[str, Any]] = {}
        fg = frame["gauges"]
        for key in sorted(fg):
            vals = []
            for fr in prior:
                g = fr["gauges"].get(key)
                if g is not None:
                    vals.append(g["last"])
            if len(vals) < self.min_frames:
                continue
            x = fg[key]["last"]
            z = mad_z(x, vals)
            if z > self.threshold:
                active[key] = {
                    "key": key,
                    "kind": anomaly_kind(key),
                    "round": frame["round"],
                    "value": x,
                    "median": _median(vals),
                    "z": round(z, 4),
                }
                self._anomaly_counts[key] = (
                    self._anomaly_counts.get(key, 0) + 1
                )
                self.anomalies_total += 1
                if key not in self._anomaly_first_round:
                    self._anomaly_first_round[key] = frame["round"]
        self._active = active

    # -- overhead is fed IN, never read here (no clock in this plane) --------

    # -- the occupancy channel -----------------------------------------------

    def record_occupancy(self, lane: int, occupancy: float,
                         docs: int = 0) -> None:
        """One per-window occupancy row from the fused serving tier."""
        if not self.enabled:
            return
        with self._lock:
            self.occupancy_total += 1
            self._occ_rows.append({
                "row": self.occupancy_total,
                "lane": int(lane),
                "occupancy": round(float(occupancy), 6),
                "docs": int(docs),
            })

    def occupancy_rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._occ_rows]

    def occupancy_values(self) -> List[float]:
        with self._lock:
            return [float(r["occupancy"]) for r in self._occ_rows]

    def note_overhead(self, seconds: float) -> None:
        """Callers measure their own sampling wall and report it: the
        plane reads no clock (its determinism contract)."""
        with self._lock:
            self.overhead_seconds += max(0.0, float(seconds))

    # -- anomaly readout -----------------------------------------------------

    def active_anomalies(self) -> List[Dict[str, Any]]:
        """Findings active as of the latest frame, sorted by key."""
        with self._lock:
            return [dict(self._active[k]) for k in sorted(self._active)]

    def anomaly_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._active)

    def anomaly_first_round(self, key: str) -> Optional[int]:
        with self._lock:
            return self._anomaly_first_round.get(key)

    # -- query API -----------------------------------------------------------

    def series(self, key: str,
               window: Optional[int] = None) -> List[List[float]]:
        return series_points(self.snapshot(), key, window=window)

    def rate(self, key: str,
             window: Optional[int] = None) -> List[List[float]]:
        return series_rate(self.series(key, window=window))

    def summary(self, key: str,
                window: Optional[int] = None) -> Dict[str, Any]:
        return key_summary(self.snapshot(), key, window=window)

    def query(self, params: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        return query_snapshot(self.snapshot(), params or {})

    # -- snapshot ------------------------------------------------------------

    def segments(self) -> int:
        with self._lock:
            return self._segment_index + (1 if self._segment_count else 0)

    def frames_json(self) -> str:
        """Canonical JSON of the retained ring — the byte-identity oracle
        the replay test pins."""
        with self._lock:
            return json.dumps([list(t) for t in self._tiers], sort_keys=True)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/timeseries.json`` body (and the ``history`` section of
        ``health_snapshot``)."""
        with self._lock:
            tiers = [list(t) for t in self._tiers]
            active = [dict(self._active[k]) for k in sorted(self._active)]
            counts = {k: self._anomaly_counts[k]
                      for k in sorted(self._anomaly_counts)}
            first = {k: self._anomaly_first_round[k]
                     for k in sorted(self._anomaly_first_round)}
            occ_rows = [dict(r) for r in self._occ_rows]
            segs = self._segment_index + (1 if self._segment_count else 0)
        snap: Dict[str, Any] = {
            "host": self.host,
            "enabled": self.enabled,
            "rounds": self.rounds,
            "sample_every": self.sample_every,
            "frames_sampled": self.frames_sampled,
            "frames_retained": sum(len(t) for t in tiers),
            "tier_capacity": self.tier_capacity,
            "merge_factor": self.merge_factor,
            "tier_frames": [len(t) for t in tiers],
            "tiers": tiers,
            "segments": segs,
            "segment_frames": self.segment_frames,
            "dir": str(self._dir) if self._dir is not None else None,
            "anomaly": {
                "window": self.anomaly_window,
                "min_frames": self.min_frames,
                "threshold": self.threshold,
                "total": self.anomalies_total,
                "active": active,
                "counts": counts,
                "first_round": first,
            },
            "occupancy": {
                "rows": len(occ_rows),
                "total": self.occupancy_total,
                "distribution": occupancy_distribution(
                    [r["occupancy"] for r in occ_rows]
                ),
            },
            "occupancy_rows": occ_rows,
            "overhead_seconds": round(self.overhead_seconds, 6),
        }
        snap["keys"] = snapshot_keys(snap)
        return snap


def replay_segments(dir: Any, **config: Any) -> TimeSeriesPlane:
    """Rebuild a plane from its persisted JSONL segments: every raw frame
    re-feeds through retention in file/line order, reconstructing the
    ring byte-identically (``frames_json()`` equality is the pin).  Pass
    the ORIGINAL plane's retention config for an exact rebuild."""
    plane = TimeSeriesPlane(**config).enable()
    for path in sorted(Path(dir).glob("history-*.jsonl")):
        for line in path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if line:
                plane.ingest_raw(json.loads(line))
    return plane


#: default process-wide plane — off until ``GLOBAL_HISTORY.enable()``
#: (the GLOBAL_DEVPROF / GLOBAL_LATENCY pattern)
GLOBAL_HISTORY = TimeSeriesPlane()
