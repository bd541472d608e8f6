"""Sustained open-loop traffic: the serving tier's load generator.

**Open loop** is the property that makes the ladder honest: arrival times
are fixed by the offered rate alone (``t_i = i / rate``), never gated on
service completions.  A closed-loop generator (send → wait → send) slows
itself down exactly when the server saturates, so it measures the server's
throughput as "whatever the server did" and can never show an SLO
breaking.  An open-loop generator keeps offering, the bounded ingest queue
fills, backpressure engages, verdicts turn to ``delay``/``shed`` — the
breakdown is *visible*, which is what the ladder sweeps for.

:func:`run_open_loop` drives one :class:`~.mux.SessionMux` through one
offered-rate rung and reports the typed-verdict accounting plus the
apply-latency distribution (measured per admitted frame, enqueue to
committed device round).  :func:`sustained_ladder` sweeps ascending rates
until the p99 apply latency breaks the SLO (or verdicts stop being clean)
and reports the highest sustained rate: docs/s at the SLO, each arrival
being one session's frame.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .admission import ADMIT, DELAY, SHED
from .mux import SessionMux

#: one scheduled arrival: (seconds after start, session id, wire frame)
Arrival = Tuple[float, int, bytes]


def build_arrivals(
    frames_by_session: Dict[int, Sequence[bytes]],
    rate_per_s: float,
    duration_s: float,
) -> List[Arrival]:
    """The open-loop schedule: arrivals at ``i / rate`` round-robined over
    the sessions, each session delivering its own frames in order and
    cycling when exhausted (redelivered frames are duplicate-tolerant —
    the CRDT absorbs them — so a long rung keeps offering real ingest
    work).  Deterministic: no RNG, no clock."""
    if rate_per_s <= 0:
        raise ValueError(f"rate must be positive, got {rate_per_s}")
    sids = sorted(frames_by_session)
    if not sids:
        return []
    n = max(1, int(rate_per_s * duration_s))
    cursor = {sid: 0 for sid in sids}
    out: List[Arrival] = []
    for i in range(n):
        sid = sids[i % len(sids)]
        frames = frames_by_session[sid]
        if not frames:
            continue
        out.append((i / rate_per_s, sid, frames[cursor[sid] % len(frames)]))
        cursor[sid] += 1
    return out


@dataclass
class OpenLoopResult:
    """One rung's evidence: typed-verdict accounting + latency readout."""

    rate_per_s: float
    duration_s: float
    offered: int = 0
    admitted: int = 0
    delayed: int = 0
    shed: int = 0
    applied: int = 0
    shed_reasons: Dict[str, int] = field(default_factory=dict)
    queue_peak: int = 0
    rounds: int = 0
    window_seconds: float = 0.0
    p50_apply_s: float = 0.0
    p95_apply_s: float = 0.0
    p99_apply_s: float = 0.0
    max_apply_s: float = 0.0
    wall_seconds: float = 0.0
    #: the latency plane's per-stage decomposition for this rung (present
    #: when the mux's plane was armed): the server-side stage means that
    #: sit NEXT TO the client-observed percentiles above, so one rung's
    #: JSON carries both sides of the sum-consistency story
    latency: Optional[Dict] = None

    @property
    def clean(self) -> bool:
        """Every offered frame admitted — no backpressure, no shedding."""
        return self.shed == 0 and self.delayed == 0

    def accounted(self) -> bool:
        """The zero-silent-drops identity."""
        return self.offered == self.admitted + self.delayed + self.shed

    def to_json(self) -> Dict:
        return {
            "rate_per_s": round(self.rate_per_s, 2),
            "duration_s": round(self.duration_s, 3),
            "offered": self.offered,
            "admitted": self.admitted,
            "delayed": self.delayed,
            "shed": self.shed,
            "applied": self.applied,
            "shed_reasons": dict(sorted(self.shed_reasons.items())),
            "queue_peak": self.queue_peak,
            "rounds": self.rounds,
            "window_seconds": round(self.window_seconds, 6),
            "p50_apply_ms": round(self.p50_apply_s * 1e3, 3),
            "p95_apply_ms": round(self.p95_apply_s * 1e3, 3),
            "p99_apply_ms": round(self.p99_apply_s * 1e3, 3),
            "max_apply_ms": round(self.max_apply_s * 1e3, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            **({"latency": self.latency} if self.latency is not None else {}),
        }


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


def run_open_loop(
    mux: SessionMux,
    arrivals: Sequence[Arrival],
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    drain: bool = True,
    deadline_s: Optional[float] = None,
    read_every: int = 0,
) -> OpenLoopResult:
    """Offer ``arrivals`` open-loop against ``mux`` (see module doc).

    The loop submits every arrival whose time has come (late or not —
    open loop never withholds offered work), pumps the mux's round window
    in between, offers the wait until the next arrival to the mux's
    session (:meth:`SessionMux.idle`: graph captures that fit in it), and
    sleeps only until the next arrival or window expiry.
    ``drain=True`` flushes the tail after the last arrival so every
    admitted frame's latency is measured.  ``deadline_s`` hard-bounds the
    wall clock (a saturated rung must not run away); past it, remaining
    arrivals still submit back-to-back (their verdicts ARE the evidence)
    but no further sleeping happens.  ``read_every=N`` (0 = never, the
    historical behavior) reads the first session's patch stream after
    every Nth committed pump — the pump→read pattern that marks the
    latency plane's VISIBILITY watermark, so an armed plane's
    time-to-visibility histogram fills during the rung."""
    sched = list(arrivals)
    duration = sched[-1][0] if sched else 0.0
    latencies: List[float] = []
    prev_sink = mux.latency_sink
    mux.latency_sink = latencies
    res = OpenLoopResult(
        rate_per_s=(len(sched) / duration if duration else 0.0),
        duration_s=duration,
    )
    read_sid = sched[0][1] if sched else None
    pumps = 0
    start = clock()
    try:
        i = 0
        while i < len(sched):
            now = clock() - start
            overtime = deadline_s is not None and now > deadline_s
            while i < len(sched) and (sched[i][0] <= now or overtime):
                _, sid, frame = sched[i]
                verdict = mux.submit(sid, frame)
                res.offered += 1
                if verdict.kind == ADMIT:
                    res.admitted += 1
                elif verdict.kind == DELAY:
                    res.delayed += 1
                elif verdict.kind == SHED:
                    res.shed += 1
                    res.shed_reasons[verdict.reason] = (
                        res.shed_reasons.get(verdict.reason, 0) + 1
                    )
                i += 1
            if mux.pump() and read_every > 0 and read_sid is not None:
                pumps += 1
                if pumps % read_every == 0:
                    mux.patches(read_sid)
            if i < len(sched) and not overtime:
                gap = max(0.0, sched[i][0] - (clock() - start))
                # the wait until the next arrival is the session's to
                # capture graphs in (a capture is host time)
                if gap > 0 and mux.idle(gap):
                    gap = max(0.0, sched[i][0] - (clock() - start))
                nap = min(gap, max(0.0005, mux.window_seconds() / 4))
                if nap > 0:
                    sleep(nap)
        if drain:
            mux.flush()
            if read_every > 0 and read_sid is not None:
                # expose the tail flush too: the final commits' visibility
                # must be measured, not left pending
                mux.patches(read_sid)
    finally:
        mux.latency_sink = prev_sink
    res.wall_seconds = clock() - start
    res.applied = len(latencies)
    res.queue_peak = mux.admission.peak_depth
    res.rounds = mux.rounds
    res.window_seconds = mux.window_seconds()
    latencies.sort()
    res.p50_apply_s = _pct(latencies, 0.50)
    res.p95_apply_s = _pct(latencies, 0.95)
    res.p99_apply_s = _pct(latencies, 0.99)
    res.max_apply_s = latencies[-1] if latencies else 0.0
    plane = getattr(mux, "latency_plane", None)
    if plane is not None and plane.enabled and plane.records:
        res.latency = plane.decomposition()
    return res


@dataclass
class LadderRung:
    """One swept rate plus whether it sustained the SLO."""

    rate_per_s: float
    result: OpenLoopResult
    slo_p99_s: float
    sustained: bool

    def to_json(self) -> Dict:
        return {
            "rate_per_s": round(self.rate_per_s, 2),
            "sustained": self.sustained,
            "slo_p99_ms": round(self.slo_p99_s * 1e3, 3),
            **self.result.to_json(),
        }


def sustained_ladder(
    mux_factory: Callable[[], Tuple[SessionMux, Dict[int, Sequence[bytes]]]],
    rates: Sequence[float],
    slo_p99_s: float,
    duration_s: float = 1.0,
    delayed_tolerance: float = 0.01,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    warmup: int = 0,
) -> Tuple[List[LadderRung], Optional[LadderRung]]:
    """Sweep ascending arrival rates until the SLO breaks.

    ``mux_factory`` builds a FRESH mux (and its per-session frame lists)
    per rung, so one saturated rung's backlog cannot poison the next.
    A rung sustains iff it shed nothing, delayed at most
    ``delayed_tolerance`` of offered frames, and held p99 apply latency
    within ``slo_p99_s``.  The sweep stops at the first unsustained rung
    (its evidence is recorded — the ladder row shows WHERE it broke).
    ``warmup=N`` runs each rung N times uncounted on throwaway muxes
    first, so one-time costs (the caching allocator's growth, the first
    use of a round width) land outside the measured percentile.  Returns ``(all rungs, highest sustained rung or
    None)``."""
    rungs: List[LadderRung] = []
    best: Optional[LadderRung] = None
    for rate in rates:
        deadline = max(duration_s * 4, duration_s + 2.0)
        for _ in range(max(0, warmup)):
            wmux, wframes = mux_factory()
            run_open_loop(
                wmux, build_arrivals(wframes, rate, duration_s),
                clock=clock, sleep=sleep, deadline_s=deadline,
            )
        mux, frames_by_session = mux_factory()
        arrivals = build_arrivals(frames_by_session, rate, duration_s)
        res = run_open_loop(
            mux, arrivals, clock=clock, sleep=sleep,
            deadline_s=deadline,
        )
        ok = (
            res.accounted()
            and res.shed == 0
            and res.delayed <= delayed_tolerance * max(1, res.offered)
            and res.p99_apply_s <= slo_p99_s
        )
        rung = LadderRung(
            rate_per_s=rate, result=res, slo_p99_s=slo_p99_s, sustained=ok,
        )
        rungs.append(rung)
        if ok:
            best = rung
        else:
            break
    return rungs, best
