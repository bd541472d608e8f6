"""Convergence observability: per-peer replication-lag watermarks and
divergence probes.

Peritext's correctness story is *convergence* — replicas that have seen the
same changes read back byte-identical documents — but until this module the
fleet could not SEE convergence: ``try_sync_with`` surfaced a peer as
``behind`` and forgot it, and the only divergence check was the offline
chaos oracle.  A :class:`ConvergenceMonitor` ingests every anti-entropy
frontier exchange (hooked into ``multihost.sync_with`` / ``_serve_one`` and
``anti_entropy.sync``) and maintains, per peer:

* **ops-behind** — the clock-delta sum ``Σ max(0, peer_seq - local_seq)``:
  how many changes the local store still lacks from that peer's frontier;
* **ops-ahead** — the mirror sum: how many changes the peer lacks from us;
* **staleness** — monitor rounds since the last CLEAN exchange with the
  peer (a reachable peer resets it every round; a partitioned peer's
  staleness grows until the partition heals);
* **divergence probes** — when two frontiers MATCH, the stores must hold
  identical change sets, so their commutative store digests
  (:meth:`~..parallel.anti_entropy.ChangeStore.digest`) must match too.
  ``same frontier + different digest`` is TRUE divergence — a corrupt
  merge, not mere lag — and is flagged as a first-class incident: a
  ``convergence.divergence_incidents`` counter tick plus a flight-recorder
  dump, never a plain ``behind``.

The monitor is pure telemetry: it never touches merge state, holds only
plain dicts/ints, and is cheap enough to ingest every exchange.  The
healing control loop that CONSUMES these watermarks is
:class:`~..parallel.gossip.GossipScheduler` (most-behind-first anti-entropy
priority after a partition heals).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from .metrics import Counters, GLOBAL_COUNTERS

#: classification labels returned by :meth:`ConvergenceMonitor.observe_frontier`
CONVERGED = "converged"
LAG = "lag"
DIVERGENCE = "divergence"


def clock_delta_ops(local_clock: Dict[str, int],
                    peer_clock: Dict[str, int]) -> int:
    """Ops the LOCAL store lacks from ``peer_clock``'s frontier:
    ``Σ_actors max(0, peer_seq - local_seq)`` — the ops-behind watermark."""
    return sum(
        max(0, int(seq) - int(local_clock.get(actor, 0)))
        for actor, seq in peer_clock.items()
    )


def clocks_equal(a: Dict[str, int], b: Dict[str, int]) -> bool:
    """Frontier equality modulo zero entries (an actor never heard from is
    the same frontier as that actor at seq 0)."""
    return (
        {k: v for k, v in a.items() if v} == {k: v for k, v in b.items() if v}
    )


@dataclass
class PeerLag:
    """One peer's replication-lag watermarks (all telemetry; see module doc)."""

    peer: str
    #: current ops-behind estimate: the clock-delta sum at the last observed
    #: frontier, zeroed by a clean full exchange (the pull drained it)
    ops_behind: int = 0
    #: the mirror watermark: ops the peer lacked from us at last observation
    ops_ahead: int = 0
    #: high-water mark of ops_behind over the peer's lifetime
    peak_ops_behind: int = 0
    #: monitor round of the last clean (fully merged) exchange; -1 = never
    last_clean_round: int = -1
    #: monitor round of the last frontier observation (clean or not)
    last_seen_round: int = -1
    exchanges: int = 0
    #: consecutive failed exchange attempts (reset by any clean exchange)
    failures: int = 0
    #: the peer has EVER probed divergent (latched: divergence is an
    #: incident to investigate, not a state a later round silently repairs)
    divergent: bool = False
    last_outcome: str = "never"
    #: why the most recent exchange attempt failed (cleared by a clean
    #: exchange) — the fleet view's answer to "stale peer, but WHY"
    last_error: Optional[str] = None

    def staleness(self, rounds: int) -> int:
        """Rounds since the last clean exchange (``rounds`` = monitor now);
        a never-reached peer is stale for the monitor's whole lifetime."""
        if self.last_clean_round < 0:
            return rounds
        return max(0, rounds - self.last_clean_round)

    def to_json(self, rounds: int) -> Dict[str, Any]:
        return {
            "ops_behind": self.ops_behind,
            "ops_ahead": self.ops_ahead,
            "peak_ops_behind": self.peak_ops_behind,
            "staleness_rounds": self.staleness(rounds),
            "exchanges": self.exchanges,
            "failures": self.failures,
            "divergent": self.divergent,
            "last_outcome": self.last_outcome,
            "last_error": self.last_error,
        }


@dataclass
class DivergenceIncident:
    """Evidence of one same-frontier/different-digest probe."""

    peer: str
    round: int
    local_digest: int
    peer_digest: int
    clock_size: int


class ConvergenceMonitor:
    """Per-peer lag watermarks + divergence probes over frontier exchanges.

    Thread-safe: transport handler threads (``_serve_one``), client sync
    threads and the exporter scrape concurrently.  ``recorder`` (a
    :class:`~.recorder.FlightRecorder`) receives a ``fault`` record — and
    therefore an automatic ring dump — on every divergence incident.
    """

    def __init__(self, host: str = "local",
                 recorder=None,
                 counters: Optional[Counters] = None) -> None:
        self.host = host
        self.recorder = recorder
        self.counters = counters if counters is not None else GLOBAL_COUNTERS
        self._lock = threading.Lock()
        self._peers: Dict[str, PeerLag] = {}
        self.rounds = 0
        self.divergence_incidents: List[DivergenceIncident] = []

    # -- ingestion (the transport hooks) ------------------------------------

    def advance_round(self) -> int:
        """Tick the monitor's round clock — the staleness unit.  Called by
        the gossip scheduler once per scheduling round (standalone syncs
        may call it per exchange batch)."""
        with self._lock:
            self.rounds += 1
            return self.rounds

    def peer(self, name: str) -> PeerLag:
        with self._lock:
            return self._peer_locked(name)

    def _peer_locked(self, name: str) -> PeerLag:
        rec = self._peers.get(name)
        if rec is None:
            rec = self._peers[name] = PeerLag(peer=name)
        return rec

    def observe_frontier(
        self,
        peer: str,
        local_clock: Dict[str, int],
        peer_clock: Dict[str, int],
        local_digest: Optional[int] = None,
        peer_digest: Optional[int] = None,
    ) -> str:
        """Ingest one frontier observation (mid-exchange is fine: a slow
        link that dies after the frontier still taught us the peer's
        position).  Returns the classification: ``lag``, ``converged``, or
        ``divergence`` — the last meaning the frontiers MATCH but the
        commutative digests differ, which mere lag can never produce."""
        behind = clock_delta_ops(local_clock, peer_clock)
        ahead = clock_delta_ops(peer_clock, local_clock)
        matched = clocks_equal(local_clock, peer_clock)
        divergent = (
            matched
            and local_digest is not None
            and peer_digest is not None
            and int(local_digest) != int(peer_digest)
        )
        with self._lock:
            rec = self._peer_locked(peer)
            rec.exchanges += 1
            rec.ops_behind = behind
            rec.ops_ahead = ahead
            rec.peak_ops_behind = max(rec.peak_ops_behind, behind)
            rec.last_seen_round = self.rounds
            if divergent:
                rec.divergent = True
                rec.last_outcome = DIVERGENCE
                incident = DivergenceIncident(
                    peer=peer, round=self.rounds,
                    local_digest=int(local_digest),
                    peer_digest=int(peer_digest),
                    clock_size=len(peer_clock),
                )
                self.divergence_incidents.append(incident)
            else:
                rec.last_outcome = CONVERGED if matched else LAG
        self.counters.add("convergence.frontier_exchanges")
        if divergent:
            self.counters.add("convergence.divergence_incidents")
            if self.recorder is not None:
                # first-class incident: the flight recorder turns "digests
                # differ at an equal frontier" into a post-mortem dump
                self.recorder.fault(
                    "divergence", peer=peer, host=self.host,
                    local_digest=int(local_digest),
                    peer_digest=int(peer_digest),
                    round=self.rounds,
                )
            return DIVERGENCE
        return CONVERGED if matched else LAG

    def observe_success(self, peer: str, pulled: int = 0,
                        pushed: int = 0) -> None:
        """One CLEAN bidirectional exchange completed: the pull drained the
        observed lag, so the behind estimate zeroes and staleness resets."""
        with self._lock:
            rec = self._peer_locked(peer)
            rec.ops_behind = 0
            rec.ops_ahead = 0
            rec.failures = 0
            rec.last_error = None
            rec.last_clean_round = self.rounds
            rec.last_seen_round = self.rounds
            if rec.last_outcome != DIVERGENCE:
                rec.last_outcome = CONVERGED
        self.counters.add("convergence.clean_exchanges")
        if pulled:
            self.counters.add("convergence.ops_drained", pulled)
        if pushed:
            self.counters.add("convergence.ops_shipped", pushed)

    def observe_failure(self, peer: str, error: Optional[str] = None) -> None:
        """The exchange attempt failed (behind outcome): the peer keeps its
        last lag estimate, staleness keeps growing, failures count up (the
        gossip scheduler's backoff input)."""
        with self._lock:
            rec = self._peer_locked(peer)
            rec.failures += 1
            rec.last_outcome = "behind"
            rec.last_error = error
        self.counters.add("convergence.failed_exchanges")

    # -- readout (the exporter/scheduler surface) ---------------------------

    def peers(self) -> Dict[str, PeerLag]:
        with self._lock:
            return dict(self._peers)

    def behindness(self, peer: str) -> tuple:
        """The gossip scheduler's priority key for one peer, higher = more
        urgent: (ops_behind estimate, staleness rounds)."""
        with self._lock:
            rec = self._peers.get(peer)
            if rec is None:
                return (0, self.rounds)
            return (rec.ops_behind, rec.staleness(self.rounds))

    def total_lag_ops(self) -> int:
        with self._lock:
            return sum(r.ops_behind for r in self._peers.values())

    def divergent_peers(self) -> List[str]:
        with self._lock:
            return sorted(
                name for name, r in self._peers.items() if r.divergent
            )

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable readout — the ``/convergence.json`` body and
        the ``health_snapshot(convergence=...)`` composition (the exporter
        golden-shape test pins these keys)."""
        with self._lock:
            rounds = self.rounds
            peers = {
                name: rec.to_json(rounds)
                for name, rec in sorted(self._peers.items())
            }
            incidents = len(self.divergence_incidents)
        return {
            "host": self.host,
            "rounds": rounds,
            "peers": peers,
            "total_lag_ops": sum(p["ops_behind"] for p in peers.values()),
            "divergence_incidents": incidents,
            "divergent_peers": sorted(
                name for name, p in peers.items() if p["divergent"]
            ),
        }
