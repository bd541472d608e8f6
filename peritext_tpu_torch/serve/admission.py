"""Admission control: typed verdicts over a bounded ingest queue.

When many tenants share one card, the multiplexer must decide
*explicitly* what happens to work it cannot take: an implicit decision is
a silent drop, and a CRDT fleet built on silent drops converges to the
wrong document.  Every submission therefore gets a typed :class:`Verdict`:

* ``admit`` — the op entered the bounded ingest queue and WILL be applied
  in an upcoming device round;
* ``delay(hint)`` — backpressure: the queue is above its high watermark;
  nothing was enqueued, and ``hint_seconds`` tells the client when a retry
  is likely to admit (derived from the queue's observed drain rate);
* ``shed(reason)`` — overload: the queue is full (or the session is over
  its per-session quota); nothing was enqueued, and ``reason`` is a typed
  label from :data:`SHED_REASONS`.

Backpressure is watermark-driven with hysteresis: crossing the HIGH
watermark starts delaying, and delaying stops only once the queue drains
below the LOW watermark — without the gap, a queue hovering at the
threshold would flap between admit and delay every round.

The per-session quota is where overload degradation meets the session's
quarantine/fallback ladder: one hot session may not starve the other
tenants of queue space, so its overflow sheds with ``session-quota``, and
the :class:`~.mux.SessionMux` responds to SUSTAINED quota shedding by
demoting that session's doc to scalar-replay fallback (degraded but
correct, off the device round path) rather than shedding its writes
forever.  That demotion is a load policy, not a device failure.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..obs import Counters, GLOBAL_COUNTERS

#: verdict kinds
ADMIT = "admit"
DELAY = "delay"
SHED = "shed"

#: typed shed reasons — the vocabulary verdicts, stats and snapshots
#: share (a shed with an unknown reason is a bug, not a new category)
SHED_QUEUE_FULL = "queue-full"
#: SUSTAINED overload: backpressure delays kept coming and the queue never
#: drained below the high watermark — ingest truly outruns device rounds,
#: so delays escalate to sheds until the queue drains (see offer())
SHED_OVERLOAD = "overload"
SHED_SESSION_QUOTA = "session-quota"
SHED_UNKNOWN_SESSION = "unknown-session"
SHED_CAPACITY = "capacity"
#: the session's doc has been demoted off the device path AND its scalar
#: backlog is saturated too — the ladder's last rung still answers typed
SHED_DEGRADED = "degraded"
#: the doc's serving host died and failover could not (yet) re-place it —
#: a fleet tier's typed answer while durable state is being re-homed, or
#: terminally when no live host has capacity.  Ops shed here are retryable:
#: nothing about the doc's durable state was lost (checkpoint + journal)
SHED_FAILOVER = "failover"
#: per-session wire auth: the submission carried a missing/bad HMAC session
#: token (serve/auth.SessionKeyring) — rejected AT admission, before any
#: queue space or doc slot is touched
SHED_UNAUTHORIZED = "unauthorized"

SHED_REASONS = (
    SHED_QUEUE_FULL,
    SHED_OVERLOAD,
    SHED_SESSION_QUOTA,
    SHED_UNKNOWN_SESSION,
    SHED_CAPACITY,
    SHED_DEGRADED,
    SHED_FAILOVER,
    SHED_UNAUTHORIZED,
)


@dataclass(frozen=True)
class Verdict:
    """One submission's typed outcome (see module doc)."""

    kind: str
    #: typed shed reason (``kind == "shed"`` only)
    reason: Optional[str] = None
    #: suggested client retry delay (``kind == "delay"`` only)
    hint_seconds: Optional[float] = None
    #: queue depth observed at decision time (telemetry; all kinds)
    queue_depth: int = 0

    @property
    def admitted(self) -> bool:
        return self.kind == ADMIT

    def to_json(self) -> Dict:
        out: Dict = {"kind": self.kind, "queue_depth": self.queue_depth}
        if self.reason is not None:
            out["reason"] = self.reason
        if self.hint_seconds is not None:
            out["hint_seconds"] = round(self.hint_seconds, 4)
        return out


@dataclass
class AdmissionStats:
    """Cumulative verdict accounting.  The zero-silent-drops invariant is
    ``submitted == admitted + delayed + shed`` — checked by the traffic
    generator after every rung."""

    submitted: int = 0
    admitted: int = 0
    delayed: int = 0
    shed: int = 0
    shed_reasons: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "delayed": self.delayed,
            "shed": self.shed,
            "shed_reasons": dict(sorted(self.shed_reasons.items())),
        }


class AdmissionController:
    """Bounded ingest queue with watermark backpressure (see module doc).

    ``max_depth`` bounds the queue in admission units (frames by default;
    pass ``cost`` to weigh heavier submissions).  ``high_watermark`` /
    ``low_watermark`` are fractions of ``max_depth``; ``session_quota`` is
    the per-session share of ``max_depth`` one tenant may hold (None =
    unlimited).  ``shed_after`` is the delay→shed escalation ladder: a
    transient burst gets ``delay`` verdicts, but once ``shed_after``
    consecutive offers have been delayed with the queue still pinned above
    the watermarks, ingest is provably outrunning device rounds and
    verdicts escalate to typed ``shed(overload)`` until the queue drains —
    a client retrying a delay forever must eventually learn the overload
    is sustained.  Thread-safe: submit paths and the round pump may run on
    different threads.
    """

    def __init__(
        self,
        max_depth: int = 1024,
        high_watermark: float = 0.75,
        low_watermark: float = 0.5,
        session_quota: Optional[float] = 0.5,
        shed_after: int = 16,
        counters: Optional[Counters] = None,
    ) -> None:
        if max_depth <= 0:
            raise ValueError(f"max_depth must be positive, got {max_depth}")
        if not 0.0 < low_watermark <= high_watermark <= 1.0:
            raise ValueError(
                "watermarks must satisfy 0 < low <= high <= 1, got "
                f"low={low_watermark} high={high_watermark}"
            )
        self.max_depth = int(max_depth)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.session_quota = (
            None if session_quota is None else float(session_quota)
        )
        self.shed_after = int(shed_after)
        self.counters = counters if counters is not None else GLOBAL_COUNTERS
        self._lock = threading.Lock()
        self._depth = 0
        self._peak_depth = 0
        #: consecutive delay verdicts since the last admit/drain — the
        #: sustained-overload escalation input
        self._delay_streak = 0
        self._per_session: Dict[int, int] = {}
        #: hysteresis latch: True between crossing the high watermark and
        #: draining back below the low one
        self._backpressure = False
        self.stats = AdmissionStats()
        #: rolling drain-rate estimate (units applied per second) behind the
        #: delay hint; fed by :meth:`observe_drain`
        self._drain_rate: float = 0.0
        #: per-session ring of recent verdicts — the incident context a
        #: quarantine/rollback flight dump appends (see verdict_tail());
        #: bounded per session AND in tracked sessions
        self._tails: Dict[int, deque] = {}
        self._tail_len = 32
        self._tail_sessions = 1024

    # -- decision ------------------------------------------------------------

    def offer(self, session_id: int, cost: int = 1,
              degraded: bool = False) -> Verdict:
        """Decide one submission.  ``admit`` reserves ``cost`` units of
        queue space (released by :meth:`mark_applied`); any other verdict
        reserves nothing.  ``degraded`` marks a session already demoted to
        scalar fallback: its work bypasses the device round budget, so it
        admits below the high watermark regardless of its quota — but a
        saturated queue still sheds it with the typed ``degraded`` reason."""
        cost = max(1, int(cost))
        with self._lock:
            self.stats.submitted += 1
            depth = self._depth
            if depth + cost > self.max_depth:
                v = self._shed_locked(
                    SHED_DEGRADED if degraded else SHED_QUEUE_FULL, depth
                )
                self._note_verdict_locked(session_id, v)
                return v
            held = self._per_session.get(session_id, 0)
            if (
                not degraded
                and self.session_quota is not None
                and held + cost > self.session_quota * self.max_depth
            ):
                # one hot tenant may not starve the rest of the queue; the
                # mux converts SUSTAINED quota sheds into a fallback
                # demotion (the degradation ladder), so this reason is a
                # transition state, not a permanent write loss
                v = self._shed_locked(SHED_SESSION_QUOTA, depth)
                self._note_verdict_locked(session_id, v)
                return v
            high = self.high_watermark * self.max_depth
            if depth + cost > high:
                self._backpressure = True
            elif self._backpressure and depth <= self.low_watermark * self.max_depth:
                self._backpressure = False
                self._delay_streak = 0
            if self._backpressure and not degraded:
                self._delay_streak += 1
                if self._delay_streak > self.shed_after:
                    # sustained: the queue has not drained through a whole
                    # ladder of delays — escalate to a typed shed so the
                    # client knows this is overload, not a blip
                    v = self._shed_locked(SHED_OVERLOAD, depth)
                    self._note_verdict_locked(session_id, v)
                    return v
                self.stats.delayed += 1
                self.counters.add("serve.delayed")
                v = Verdict(
                    kind=DELAY,
                    hint_seconds=self._delay_hint_locked(),
                    queue_depth=depth,
                )
                self._note_verdict_locked(session_id, v)
                return v
            if not degraded:
                # degraded-session admits bypass backpressure entirely, so
                # they say nothing about whether delayed clients' work is
                # draining — only a normal admit (or a drain below the low
                # watermark) may reset the delay→shed escalation
                self._delay_streak = 0
            self._depth = depth + cost
            self._peak_depth = max(self._peak_depth, self._depth)
            self._per_session[session_id] = held + cost
            self.stats.admitted += 1
            self.counters.add("serve.admitted")
            v = Verdict(kind=ADMIT, queue_depth=self._depth)
            self._note_verdict_locked(session_id, v)
            return v

    def shed_out_of_band(self, reason: str) -> Verdict:
        """Record a typed shed decided OUTSIDE the queue logic (unknown
        session, doc-slot capacity): it still counts as a submission so
        the zero-silent-drops identity covers every client request, and
        it still lands in the verdict stats the snapshot reports."""
        with self._lock:
            self.stats.submitted += 1
            return self._shed_locked(reason, self._depth)

    def delay_out_of_band(self, hint_seconds: float = 0.05) -> Verdict:
        """Record a typed delay decided OUTSIDE the queue logic — a fleet
        tier's "this doc is mid-failover/mid-cutover, retry shortly"
        verdict.  Counts as a submission so the zero-silent-drops identity
        covers it, exactly like :meth:`shed_out_of_band`."""
        with self._lock:
            self.stats.submitted += 1
            self.stats.delayed += 1
            self.counters.add("serve.delayed")
            return Verdict(
                kind=DELAY, hint_seconds=float(hint_seconds),
                queue_depth=self._depth,
            )

    def _shed_locked(self, reason: str, depth: int) -> Verdict:
        self.stats.shed += 1
        self.stats.shed_reasons[reason] = (
            self.stats.shed_reasons.get(reason, 0) + 1
        )
        self.counters.add("serve.shed")
        self.counters.add(f"serve.shed.{reason}")
        return Verdict(kind=SHED, reason=reason, queue_depth=depth)

    def _note_verdict_locked(self, session_id: int, verdict: Verdict) -> None:
        """Ring one verdict into the session's tail (post-mortem context;
        see :meth:`verdict_tail`).  The submission index doubles as the
        tail entry's sequence number."""
        tail = self._tails.get(session_id)
        if tail is None:
            if len(self._tails) >= self._tail_sessions:
                # evict the oldest-tracked session wholesale: tails exist
                # for post-mortems on ACTIVE docs, not as a history of
                # every session id ever offered
                self._tails.pop(next(iter(self._tails)))
            tail = self._tails[session_id] = deque(maxlen=self._tail_len)
        tail.append({"seq": self.stats.submitted, **verdict.to_json()})

    def verdict_tail(self, session_id: int) -> List[Dict]:
        """The session's recent verdicts, oldest first — what a
        quarantine/rollback flight dump appends as incident context (the
        backpressure picture around the fault)."""
        with self._lock:
            return list(self._tails.get(session_id, ()))

    def _delay_hint_locked(self) -> float:
        """How long until a retry is likely to admit: the units above the
        low watermark divided by the observed drain rate.  With no drain
        observed yet the hint is one nominal round (conservative but
        finite — a client must never be told to wait forever)."""
        excess = self._depth - self.low_watermark * self.max_depth
        if self._drain_rate > 0 and excess > 0:
            return max(0.001, excess / self._drain_rate)
        return 0.05

    # -- the round pump's side ----------------------------------------------

    def mark_applied(self, session_id: int, cost: int = 1) -> None:
        """Release queue space a committed device round drained."""
        cost = max(1, int(cost))
        with self._lock:
            self._depth = max(0, self._depth - cost)
            held = self._per_session.get(session_id, 0) - cost
            if held > 0:
                self._per_session[session_id] = held
            else:
                self._per_session.pop(session_id, None)
            if self._backpressure and (
                self._depth <= self.low_watermark * self.max_depth
            ):
                self._backpressure = False
                self._delay_streak = 0

    def observe_drain(self, units: int, seconds: float) -> None:
        """Teach the delay hint this round's drain rate (EWMA)."""
        if seconds <= 0 or units <= 0:
            return
        rate = units / seconds
        with self._lock:
            self._drain_rate = (
                rate if self._drain_rate == 0
                else 0.7 * self._drain_rate + 0.3 * rate
            )

    # -- readout -------------------------------------------------------------

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def peak_depth(self) -> int:
        with self._lock:
            return self._peak_depth

    @property
    def backpressure(self) -> bool:
        with self._lock:
            return self._backpressure

    def session_depth(self, session_id: int) -> int:
        with self._lock:
            return self._per_session.get(session_id, 0)

    def snapshot(self) -> Dict:
        """JSON-serializable queue + verdict state (the mux snapshot's
        ``queue`` section)."""
        with self._lock:
            return {
                "depth": self._depth,
                "peak": self._peak_depth,
                "max_depth": self.max_depth,
                "high_watermark": self.high_watermark,
                "low_watermark": self.low_watermark,
                "shed_after": self.shed_after,
                "backpressure": self._backpressure,
                "drain_rate_per_s": round(self._drain_rate, 3),
                "verdicts": self.stats.to_json(),
            }
