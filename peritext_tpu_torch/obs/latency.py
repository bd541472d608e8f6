"""Time-to-visibility latency plane: stage watermarks per drain batch.

The serving tier gates on p99 *apply* latency, but the SLO a client feels
is **time-to-visibility**: submit → admission verdict → window wait →
stage → device commit → the first read that exposes the patch.  This
module is the low-overhead decomposition of that journey.

**Stage taxonomy** (:data:`STAGES`, telescoping watermark diffs):

* ``admit``      — submit entry → admission verdict + enqueue
  (``serve/admission.py`` verdict time);
* ``window``     — enqueue → round-open window close (the batching dial;
  close cause ∈ {``window``, ``backpressure``, ``flush``});
* ``stage``      — window close → frames bulk-ingested into the session
  (``serve/mux.py`` ``pump``);
* ``dispatch``   — staged → the drain's return, MINUS its measured apply
  spans: the host schedule of ``parallel/streaming.py`` and the staging
  lane's flatten and upload (``parallel/staging.py``; its
  ``staging.stage`` span runs on the lane's worker, overlapped with the
  next batch's schedule, so only the part the commit waits for lands
  here);
* ``commit``     — the apply spans themselves (streaming's
  ``streaming.apply`` spans accumulated into ``last_drain_marks``), one
  per committed batch: one site call of a fused form, on the card one
  CUDA-graph replay once the batch's signature repeats.  On the card a
  commit span ends when the batch's kernels are queued, not when the card
  has run them;
* ``visibility`` — commit → the first ``patches()``/``read()`` that
  exposes the committed round; that read ends in a device-to-host copy,
  so it includes the card's outstanding work.

**Sampling policy**: one compact :class:`dict` record per DRAIN BATCH
(never per op), anchored on the batch's first-enqueued frame — the op
that waited the whole window, i.e. the worst case an SLO cares about.
``sample_every=N`` decimates further.

**Determinism contract**: the plane is fed clock watermarks by the SERVE
tier only; the streaming session and its staging lane contribute span
DURATIONS (``last_drain_marks``, the ``staging.stage`` spans), never
wall-clock reads.

Sum-consistency holds by construction: the five server-side stage
durations are telescoping differences of monotonic watermarks, so they
are each nonnegative and sum exactly to ``commit − submit``
(:func:`check_sum_consistency`).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Sequence

from .histograms import Histogram

#: the stage taxonomy, in pipeline order
STAGES = ("admit", "window", "stage", "dispatch", "commit", "visibility")

#: server-side stages (watermark diffs; sum to ``commit − submit``)
SERVER_STAGES = STAGES[:-1]

#: typed window-close causes — the vocabulary the mux and the plane share
CLOSE_WINDOW = "window"
CLOSE_BACKPRESSURE = "backpressure"
CLOSE_FLUSH = "flush"
CLOSE_CAUSES = (CLOSE_WINDOW, CLOSE_BACKPRESSURE, CLOSE_FLUSH)


def check_sum_consistency(record: Dict[str, Any], *, tol: float = 1e-6,
                          client_wall: Optional[float] = None) -> bool:
    """The plane's core invariant on one sampled record: every stage
    nonnegative, the server-side stages summing to the record's total
    (``commit − submit``) within float tolerance, and — when the client's
    own observed wall is supplied — the server-side sum never exceeding
    what the client saw (plus ``tol`` slack for the clock reads between
    the two measurements)."""
    stages = record.get("stages") or {}
    if any(d < 0 for d in stages.values()):
        return False
    total = record.get("total", 0.0)
    # the server-side stages telescope to commit − submit == total; the
    # visibility stage (present once the record is finalized) sits ON TOP
    # of total (total + visibility == time_to_visibility)
    server_sum = sum(stages.get(s, 0.0) for s in SERVER_STAGES)
    if abs(server_sum - total) > tol:
        return False
    if client_wall is not None:
        # the anchor frame's client-observed latency starts at its
        # enqueue (the admit watermark), so compare against the post-admit
        # portion of the server sum
        if total - stages.get("admit", 0.0) > client_wall + tol:
            return False
    return True


class LatencyPlane:
    """The stage-watermark latency plane (see module doc).

    Off by default — arming is ``plane.enable()``
    (``GLOBAL_LATENCY.enable()`` arms every serve-tier hook at once).  One
    :meth:`observe_batch` per committed drain window feeds the per-stage
    histograms; :meth:`mark_visible` (called by the mux's read surface)
    finalizes pending records with the visibility stage.  Thread-safe.

    ``slo_seconds``/``slo_target`` parameterize the burn-rate gauge: the
    fraction of the rolling window's commit totals violating
    ``slo_seconds``, divided by the error budget ``1 − slo_target`` —
    burn rate 1.0 = exactly spending the budget, >1 = burning it down.
    """

    def __init__(
        self,
        sample_every: int = 1,
        slo_seconds: float = 0.25,
        slo_target: float = 0.99,
        slo_window: int = 256,
        pending_cap: int = 512,
    ) -> None:
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}"
            )
        if not 0.0 < slo_target < 1.0:
            raise ValueError(
                f"slo_target must be in (0, 1), got {slo_target}"
            )
        self.enabled = False
        self.sample_every = int(sample_every)
        self.slo_seconds = float(slo_seconds)
        self.slo_target = float(slo_target)
        self._lock = threading.Lock()
        #: per-stage duration histograms + the end-to-end families; the
        #: plane owns PRIVATE histograms (not GLOBAL_HISTOGRAMS) so
        #: enabling it for one traffic run never pollutes another's registry
        self.hists: Dict[str, Histogram] = {
            **{stage: Histogram() for stage in STAGES},
            "total": Histogram(),
            "time_to_visibility": Histogram(),
        }
        self._windows_seen = 0
        self.records = 0
        #: sampled records awaiting their first exposing read; bounded —
        #: an unread backlog evicts oldest-first into ``never_read``
        self._pending: deque = deque()
        self._pending_cap = int(pending_cap)
        self.never_read = 0
        self.force_close: Dict[str, int] = {c: 0 for c in CLOSE_CAUSES}
        #: rolling commit totals behind the SLO burn-rate gauge
        self._slo_ring: deque = deque(maxlen=int(slo_window))
        self.max_shards = 1
        self.last: Optional[Dict[str, Any]] = None

    # -- arming ------------------------------------------------------------

    def enable(self) -> "LatencyPlane":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def __enter__(self) -> "LatencyPlane":
        return self.enable()

    def __exit__(self, *exc) -> None:
        self.disable()

    def reset(self) -> None:
        with self._lock:
            for h in self.hists:
                self.hists[h] = Histogram()
            self._windows_seen = 0
            self.records = 0
            self._pending.clear()
            self.never_read = 0
            self.force_close = {c: 0 for c in CLOSE_CAUSES}
            self._slo_ring.clear()
            self.max_shards = 1
            self.last = None

    # -- the serve tier's feed ---------------------------------------------

    def observe_batch(
        self,
        *,
        submit: float,
        admit: float,
        close: float,
        staged: float,
        commit: float,
        marks: Optional[Dict[str, float]] = None,
        cause: str = CLOSE_WINDOW,
        batch: int = 1,
        shards: int = 1,
    ) -> Optional[Dict[str, Any]]:
        """Record one committed drain window from its stage watermarks
        (monotonic clock reads, all taken by the serve tier) plus the
        session's span-derived ``last_drain_marks``.  Applies the
        sampling policy; returns the sampled record or None when this
        window was decimated.  The watermarks anchor on the batch's
        FIRST-enqueued frame (worst case — see module doc)."""
        with self._lock:
            self._windows_seen += 1
            self.force_close[cause] = self.force_close.get(cause, 0) + 1
            if (self._windows_seen - 1) % self.sample_every:
                return None
            admit_d = max(0.0, admit - submit)
            window_d = max(0.0, close - admit)
            stage_d = max(0.0, staged - close)
            span = max(0.0, commit - staged)
            apply_s = float((marks or {}).get("apply_seconds", span))
            commit_d = min(max(0.0, apply_s), span)
            dispatch_d = span - commit_d
            stages = {
                "admit": admit_d,
                "window": window_d,
                "stage": stage_d,
                "dispatch": dispatch_d,
                "commit": commit_d,
            }
            total = sum(stages.values())
            self.records += 1
            self.max_shards = max(self.max_shards, int(shards))
            record = {
                "seq": self.records,
                "submit": submit,
                "commit": commit,
                "stages": stages,
                "total": total,
                "cause": cause,
                "batch": int(batch),
                "shards": int(shards),
                "rounds": int((marks or {}).get("rounds", 0)),
                "visible": None,
                "time_to_visibility": None,
            }
            for stage, d in stages.items():
                self.hists[stage].observe(d)
            self.hists["total"].observe(total)
            self._slo_ring.append(total)
            self._pending.append(record)
            while len(self._pending) > self._pending_cap:
                self._pending.popleft()
                self.never_read += 1
            self.last = record
            return record

    def mark_visible(self, now: float) -> int:
        """Finalize every pending record with ``now`` as its visibility
        watermark — called by the mux's read surface (``patches()`` /
        ``read()``) at the FIRST read after a commit, i.e. the moment a
        client could actually observe the committed round.  Returns how
        many records were finalized (0 when none were pending: repeat
        reads between commits are free)."""
        with self._lock:
            n = len(self._pending)
            while self._pending:
                rec = self._pending.popleft()
                vis = max(0.0, now - rec["commit"])
                rec["visible"] = now
                rec["stages"]["visibility"] = vis
                rec["time_to_visibility"] = rec["total"] + vis
                self.hists["visibility"].observe(vis)
                self.hists["time_to_visibility"].observe(
                    rec["time_to_visibility"]
                )
            return n

    # -- readout -----------------------------------------------------------

    def slo(self) -> Dict[str, Any]:
        """The burn-rate gauge body (also a ``peritext_latency_*`` gauge
        family): violations over the rolling window / the error budget."""
        with self._lock:
            ring = list(self._slo_ring)
        violations = sum(1 for t in ring if t > self.slo_seconds)
        frac = violations / len(ring) if ring else 0.0
        budget = 1.0 - self.slo_target
        return {
            "slo_seconds": self.slo_seconds,
            "target": self.slo_target,
            "window": len(ring),
            "violations": violations,
            "violating_frac": round(frac, 6),
            "burn_rate": round(frac / budget, 4) if budget else 0.0,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``/latency.json`` body (golden-shape test pins these keys):
        arming + sampling state, the per-stage histogram snapshots, the
        end-to-end families, the SLO burn gauge, close causes, fan-out."""
        with self._lock:
            pending = len(self._pending)
            last = dict(self.last) if self.last is not None else None
        return {
            "enabled": self.enabled,
            "sample_every": self.sample_every,
            "windows": self._windows_seen,
            "records": self.records,
            "pending_visibility": pending,
            "never_read": self.never_read,
            "shards": self.max_shards,
            "force_close": dict(self.force_close),
            "stages": {s: self.hists[s].snapshot() for s in STAGES},
            "total": self.hists["total"].snapshot(),
            "time_to_visibility": self.hists["time_to_visibility"].snapshot(),
            "slo": self.slo(),
            "last": last,
        }

    def decomposition(self) -> Dict[str, Any]:
        """The per-stage decomposition a traffic rung reports: mean
        milliseconds per stage over the sampled
        records, the end-to-end means, and the consistency evidence."""
        def mean_ms(name: str) -> Optional[float]:
            h = self.hists[name]
            return round(h.sum / h.count * 1e3, 4) if h.count else None

        stages_ms = {
            s: mean_ms(s) for s in STAGES if self.hists[s].count
        }
        with self._lock:
            last = self.last
            consistent = (
                check_sum_consistency(last) if last is not None else True
            )
        return {
            "stages_ms": stages_ms,
            "total_ms": mean_ms("total"),
            "time_to_visibility_ms": mean_ms("time_to_visibility"),
            "records": self.records,
            "never_read": self.never_read,
            "shards": self.max_shards,
            "force_close": dict(self.force_close),
            "slo_burn_rate": self.slo()["burn_rate"],
            "sum_consistent": consistent,
        }


#: default process-wide plane — off until ``GLOBAL_LATENCY.enable()``
#: (every serve-tier hook checks ``enabled``)
GLOBAL_LATENCY = LatencyPlane()


# -- attribution ---------------------------------------------------------------


def _devprof_shape(dp: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Collapse a devprof snapshot to the three deltas attribution cites:
    total distinct shape buckets, total dispatches, padding waste."""
    if not isinstance(dp, dict):
        return None
    sites = dp.get("sites") or {}
    occ = dp.get("occupancy_totals") or {}
    return {
        "distinct_shapes": sum(
            int(r.get("distinct_shapes", 0)) for r in sites.values()
        ),
        "dispatches": sum(
            int(r.get("dispatches", 0)) for r in sites.values()
        ),
        "padding_waste": occ.get("padding_waste"),
    }


def attribute(
    records: Sequence[Dict[str, Any]],
    *,
    row: Optional[str] = None,
    window: Optional[int] = None,
    match: str = "device",
    tolerance: Optional[float] = None,
) -> Dict[str, Any]:
    """The attribution engine: judge the ledger's last record with the
    perf gate (:func:`~.ledger.evaluate`), then explain WHAT moved.

    Picks the failing row (or ``row`` explicitly), diffs its per-stage
    ``latency`` decomposition against the per-stage MEDIAN over the prior
    matching records, attaches the devprof shape/occupancy deltas, and
    names the dominant moved stage: the largest positive per-stage delta,
    ties broken by :data:`STAGES` order (earliest wins) — same inputs,
    same verdict, always.

    Verdicts: ``clean`` (gate passes), ``regression-attributed`` (a stage
    moved up), ``regression-unattributed`` (a regression whose
    decomposition shows no stage moving — look outside the latency
    plane), ``no-decomposition`` (candidate or reference rows carry no
    ``latency``).
    """
    from . import ledger as _ledger

    window = window if window is not None else _ledger.DEFAULT_WINDOW
    report = _ledger.evaluate(
        records, tolerance=tolerance, window=window, match=match,
    )
    verdicts = report["rows"]
    target = None
    if row is not None:
        target = next((v for v in verdicts if v["row"] == row), None)
        if target is None:
            raise ValueError(f"row {row!r} not in the candidate record")
    else:
        bad = [v for v in verdicts
               if v["status"] in ("regressed", "failed", "missing")]
        # prefer a failing row that CAN be decomposed; deterministic:
        # verdict order is the candidate record's row order
        target = next((v for v in bad if v.get("latency")), None) \
            or (bad[0] if bad else None)
    out: Dict[str, Any] = {
        "regressed": bool(report["regressed"]),
        "candidate": report["candidate"],
        "reference_records": report["reference_records"],
        "rows": verdicts,
    }
    if target is None:
        out.update(verdict="clean", row=None)
        return out
    out.update(
        row=target["row"], status=target["status"], unit=target["unit"],
        value=target["value"], ref=target["ref"],
        delta=target.get("delta"), delta_pct=target.get("delta_pct"),
    )

    candidate = records[-1]
    cand_config = candidate.get("config")
    cand_dev = candidate.get("device")
    crow = next(
        (r for r in candidate.get("rows", []) if r.get("row") == target["row"]),
        None,
    )
    cand_lat = (crow or {}).get("latency")
    cand_stages = (
        cand_lat.get("stages_ms") if isinstance(cand_lat, dict) else None
    )
    ident = (
        _ledger._row_identity(cand_config, crow) if crow is not None else None
    )
    level = _ledger._match_level((crow or {}).get("unit") or "", match)
    priors = [r for r in records[:-1]
              if _ledger._device_matches(r.get("device"), cand_dev, level)]
    ref_lats = [
        pr["latency"]
        for rec in priors
        for pr in rec.get("rows", [])
        if _ledger._row_identity(rec.get("config"), pr) == ident
        and isinstance(pr.get("latency"), dict)
        and isinstance(pr["latency"].get("stages_ms"), dict)
    ][-window:]
    ref_stages: Dict[str, float] = {}
    for stage in STAGES:
        vals = [
            float(rl["stages_ms"][stage]) for rl in ref_lats
            if isinstance(rl["stages_ms"].get(stage), (int, float))
        ]
        if vals:
            ref_stages[stage] = round(_ledger._median(vals), 4)
    out["reference_latency_records"] = len(ref_lats)
    out["candidate_stages_ms"] = cand_stages
    out["reference_stages_ms"] = ref_stages or None

    # devprof evidence: candidate snapshot vs the newest prior that has one
    cand_dp = _devprof_shape(candidate.get("devprof"))
    ref_dp = next(
        (_devprof_shape(r.get("devprof")) for r in reversed(priors)
         if _devprof_shape(r.get("devprof")) is not None),
        None,
    )
    if cand_dp is not None and ref_dp is not None:
        delta_dp = {}
        for key in ("distinct_shapes", "dispatches", "padding_waste"):
            a, b = cand_dp.get(key), ref_dp.get(key)
            delta_dp[key] = (
                round(a - b, 6) if isinstance(a, (int, float))
                and isinstance(b, (int, float)) else None
            )
        out["devprof"] = {
            "candidate": cand_dp, "reference": ref_dp, "delta": delta_dp,
        }
    else:
        out["devprof"] = None

    if not cand_stages or not ref_stages:
        out.update(verdict="no-decomposition", dominant_stage=None,
                   stage_deltas_ms=None)
        return out
    deltas = {
        s: round(float(cand_stages[s]) - ref_stages[s], 4)
        for s in STAGES if s in cand_stages and s in ref_stages
    }
    dominant = None
    best = 0.0
    for s in STAGES:  # taxonomy order: strict > keeps the EARLIEST on ties
        d = deltas.get(s)
        if d is not None and d > best:
            best, dominant = d, s
    out["stage_deltas_ms"] = deltas
    out["dominant_stage"] = dominant
    out["verdict"] = (
        "regression-attributed" if dominant is not None
        else "regression-unattributed"
    )
    return out
