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
* :mod:`.fused` — :class:`FusedMuxGroup`: many tenants' muxes fused onto
  shared device lanes (the planner's :class:`~..plan.fusion.FusionGroup`
  packing), one drain per touched lane per window; each tenant keeps its
  own admission and patch stream, and byte equality with the unfused path
  holds per tenant.
* :mod:`.fleet` — :class:`FleetFrontend`: docs placed across serving
  hosts by the :class:`~..parallel.router.FleetRouter`, host death
  detected by round-counted leases, failover from checkpoint plus journal,
  and digest-checked migration over the multihost ship leg.
* :mod:`.traffic` — the open-loop traffic generator: arrival times fixed
  by the offered rate, never by service completions; the ladder sweeps
  the rate until the p99 apply-latency SLO breaks.
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
from .fleet import CutoverError, FleetFrontend, FleetHost, FleetStats, HostDown
from .fused import FusedMuxGroup, default_lane_factory
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
    "CutoverError",
    "DELAY",
    "FleetFrontend",
    "FleetHost",
    "FleetStats",
    "FusedMuxGroup",
    "HostDown",
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
    "default_lane_factory",
    "run_open_loop",
    "sustained_ladder",
]
