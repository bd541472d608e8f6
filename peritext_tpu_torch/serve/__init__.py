"""peritext_tpu_torch.serve — the serving tier over the port's sessions.

* :mod:`.admission` — typed admission verdicts (``admit`` / ``delay(hint)``
  / ``shed(reason)``) over a bounded ingest queue with watermark-driven
  backpressure.  A client op is NEVER silently dropped: every submission
  either enters the queue or comes back with a typed verdict, and
  ``submitted == admitted + delayed + shed`` holds.
* :mod:`.auth` — :class:`SessionKeyring`, HMAC session tokens checked at
  admission (the mux's ``auth=``).
* :mod:`.mux` — :class:`SessionMux`: many client sessions multiplexed onto
  one :class:`~..parallel.streaming.StreamingMerge` (padded, paged or
  ragged), with the round-open window autotuned from the rolling round
  latency (:class:`BatchWindowTuner`) and sustained per-session quota
  shedding degraded through the session's fallback ladder.
* :mod:`.traffic` — the open-loop traffic generator: arrival times fixed
  by the offered rate, never by service completions; the ladder sweeps
  the rate until the p99 apply-latency SLO breaks.

Still to port: the fused multi-tenant group (``serve/fused.py``, with the
planner's lane packing) and the fleet frontend (``serve/fleet.py``, with
its transport).
"""

from .admission import (
    ADMIT,
    AdmissionController,
    DELAY,
    SHED,
    SHED_CAPACITY,
    SHED_DEGRADED,
    SHED_FAILOVER,
    SHED_OVERLOAD,
    SHED_QUEUE_FULL,
    SHED_REASONS,
    SHED_SESSION_QUOTA,
    SHED_UNAUTHORIZED,
    SHED_UNKNOWN_SESSION,
    Verdict,
)
from .auth import AuthError, SessionKeyring
from .mux import BatchWindowTuner, ClientSession, SessionMux
from .traffic import (
    LadderRung,
    OpenLoopResult,
    build_arrivals,
    run_open_loop,
    sustained_ladder,
)

__all__ = [
    "ADMIT",
    "AdmissionController",
    "AuthError",
    "BatchWindowTuner",
    "ClientSession",
    "DELAY",
    "LadderRung",
    "OpenLoopResult",
    "SHED",
    "SHED_CAPACITY",
    "SHED_DEGRADED",
    "SHED_FAILOVER",
    "SHED_OVERLOAD",
    "SHED_QUEUE_FULL",
    "SHED_REASONS",
    "SHED_SESSION_QUOTA",
    "SHED_UNAUTHORIZED",
    "SHED_UNKNOWN_SESSION",
    "SessionKeyring",
    "SessionMux",
    "Verdict",
    "build_arrivals",
    "run_open_loop",
    "sustained_ladder",
]
