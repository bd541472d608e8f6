"""Lag-driven gossip scheduling: the healing control loop over the
convergence monitor's watermarks.

Before this module, a host repaired partitions by round-robining
``try_sync_with`` over its peer list — every peer cost one round-trip per
round whether it was 10,000 ops behind or fully converged, and an
unreachable peer was re-dialed (and re-timed-out) every single round.  The
:class:`GossipScheduler` owns a :class:`~.multihost.ReplicaServer`'s peer
set and turns the :class:`~..obs.convergence.ConvergenceMonitor`'s
behind-states into a round plan:

* **most-behind-first** — peers sort by ``(ops_behind, staleness)``
  descending, so after a partition heals the backlog drains in lag order
  (the peers holding the most missing work are reached first);
* **per-peer backoff** — a peer that keeps failing is skipped for
  ``2^failures`` rounds (capped), so a dead peer costs one timeout every
  backoff window instead of one per round, while the rest of the fleet
  keeps gossiping at full cadence;
* **divergent peers still sync** — divergence is an incident to surface
  (flight recorder + counter), not a reason to stop exchanging; the sync
  keeps the lag picture current while operators investigate.

Determinism: the scheduler holds no wall clock and no RNG — backoff is counted in ROUNDS, ties break on the peer name — so a
fleet harness replay reproduces the exact round order from the same
observation sequence.  All entropy (retry jitter, socket timing) stays in
the transport layer below.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..obs import GLOBAL_COUNTERS
from .multihost import RetryPolicy, SyncOutcome


@dataclass
class GossipPeer:
    """One peer slot: where to dial it, and its backoff state."""

    name: str
    host: str
    port: int
    #: consecutive failed rounds (mirrors the monitor's failure count but
    #: kept locally so backoff state survives a monitor swap)
    failures: int = 0
    #: scheduler round number before which this peer is skipped
    skip_until: int = 0


class GossipScheduler:
    """Schedules a ReplicaServer's anti-entropy rounds by behind-ness.

    ``peers`` may be seeded at construction or via :meth:`add_peer`; each
    peer has a logical ``name`` (default ``host:port``) — the key the
    monitor tracks it under, which may differ from the dialed address when
    traffic rides a proxy/gateway.  ``backoff_cap`` bounds the skip window
    (rounds); ``retry`` is handed to every ``try_sync_with``.
    """

    def __init__(
        self,
        server,
        peers: Optional[List[Tuple[str, int]]] = None,
        monitor=None,
        retry: Optional[RetryPolicy] = None,
        backoff_cap: int = 8,
    ) -> None:
        self.server = server
        self.monitor = monitor if monitor is not None else server.monitor
        self.retry = retry
        self.backoff_cap = int(backoff_cap)
        self._peers: Dict[str, GossipPeer] = {}
        self.round_no = 0
        #: the peer order of the most recent :meth:`round` (telemetry and
        #: the chaos harness's priority-order oracle)
        self.last_round_order: List[str] = []
        for addr in peers or []:
            self.add_peer(*addr)

    # -- peer-set ownership -------------------------------------------------

    def add_peer(self, host: str, port: int,
                 name: Optional[str] = None) -> str:
        """Register a peer; returns its logical name.  ``name`` defaults to
        ``host:port`` and is how the monitor's watermarks key it — pass the
        peer's canonical identity when dialing through a proxy."""
        name = name or f"{host}:{port}"
        self._peers[name] = GossipPeer(name=name, host=host, port=int(port))
        return name

    def remove_peer(self, name: str) -> bool:
        return self._peers.pop(name, None) is not None

    def peers(self) -> List[str]:
        return sorted(self._peers)

    # -- scheduling ---------------------------------------------------------

    def priority(self, name: str) -> Tuple[int, int]:
        """(ops_behind, staleness) for one peer — higher = more urgent."""
        return self.monitor.behindness(name)

    def plan(self) -> List[str]:
        """This round's peer order: eligible (not backed-off) peers sorted
        most-behind-first — ops_behind desc, then staleness desc, then name
        (the deterministic tiebreak)."""
        eligible = [
            self._peers[n] for n in sorted(self._peers)
            if self._peers[n].skip_until <= self.round_no
        ]
        keyed = [(self.priority(p.name), p.name) for p in eligible]
        keyed.sort(key=lambda kv: (-kv[0][0], -kv[0][1], kv[1]))
        return [name for _, name in keyed]

    def round(self) -> List[Tuple[str, SyncOutcome]]:
        """Run one gossip round: sync eligible peers in behind-ness order,
        applying per-peer exponential backoff to the ones that fail.
        Returns ``[(peer_name, outcome), ...]`` in execution order."""
        self.round_no += 1
        self.monitor.advance_round()
        order = self.plan()
        self.last_round_order = list(order)
        results: List[Tuple[str, SyncOutcome]] = []
        for name in order:
            peer = self._peers[name]
            outcome = self.server.try_sync_with(
                peer.host, peer.port, retry=self.retry, peer_name=name
            )
            if outcome.behind:
                peer.failures += 1
                # exponential skip window, in rounds: 2, 4, ... capped —
                # a dead peer costs one timeout per window, not per round
                window = min(self.backoff_cap, 2 ** peer.failures)
                peer.skip_until = self.round_no + window
                GLOBAL_COUNTERS.add("convergence.gossip_backoffs")
            else:
                peer.failures = 0
                peer.skip_until = 0
            results.append((name, outcome))
        GLOBAL_COUNTERS.add("convergence.gossip_rounds")
        return results

    def wake(self, name: Optional[str] = None) -> None:
        """Clear backoff state — for one peer, or (default) all of them.
        The heal hook: when something above the scheduler learns a
        partition lifted (a failure detector, an operator, the chaos
        harness), waking skips the remaining backoff windows so the next
        round retries immediately, in behind-ness order."""
        peers = (
            [self._peers[name]] if name
            else [self._peers[n] for n in sorted(self._peers)]
        )
        for p in peers:
            p.failures = 0
            p.skip_until = 0

    def drain(self, max_rounds: int = 64) -> int:
        """Gossip until no tracked peer reports lag, staleness stops
        advancing the picture, and a full round completes with every
        eligible exchange clean — or ``max_rounds`` elapse.  Returns the
        number of rounds run.  The post-heal entry point: a caller that
        knows a partition just lifted calls ``drain()`` and gets lag-ordered
        convergence."""
        for i in range(1, max_rounds + 1):
            results = self.round()
            all_clean = all(not out.behind for _, out in results)
            if all_clean and results and self.monitor.total_lag_ops() == 0:
                return i
        return max_rounds

    def snapshot(self) -> Dict:
        """JSON-serializable scheduler state (composes into fleet views)."""
        return {
            "round": self.round_no,
            "peers": {
                name: {
                    "host": p.host,
                    "port": p.port,
                    "failures": p.failures,
                    "backed_off": p.skip_until > self.round_no,
                    "priority": list(self.priority(name)),
                }
                for name, p in sorted(self._peers.items())
            },
            "last_round_order": list(self.last_round_order),
        }
