"""Round-counted heartbeat leases: deterministic host-death detection.

A serving fleet has to decide "that host is dead" without a coordinator,
and the decision feeds :class:`~.router.FleetRouter` placement — so it must
be a DETERMINISTIC function of the observed heartbeat sequence, exactly the
way placement is a deterministic function of the observed load state: two
frontends that saw the same beats must reach the same death verdict on the
same tick, or they re-place the same doc onto different hosts (split-brain
placement, the failure the router's determinism exists to prevent).

Hence no wall clock and no RNG here.  The lease unit is the OBSERVATION
ROUND, not seconds: every frontend bookkeeping round feeds one
beat-or-miss observation per host, and a host whose lease has
``lease_rounds`` consecutive misses is declared dead.  Wall-clock pacing
of the rounds themselves lives with the caller (``serve/``), where it
belongs.

Verdicts are a ladder, not a boolean:

* ``live``    — the latest observation was a beat;
* ``suspect`` — 1..lease_rounds-1 consecutive misses: the lease is
  draining, no action yet (a single dropped poll must not trigger a fleet
  re-placement);
* ``dead``    — ``lease_rounds`` consecutive misses.  LATCHED: later beats
  do not revive the host (its docs have been re-placed; a zombie host
  coming back must re-register through :meth:`reset`, the re-admission
  path, never silently resume serving stale placements).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping

#: verdict vocabulary (the fleet exporters and the chaos oracle share it)
LIVE = "live"
SUSPECT = "suspect"
DEAD = "dead"


@dataclass
class Lease:
    """One host's lease state."""

    host: str
    #: consecutive missed observation rounds
    missed: int = 0
    #: total observation rounds this lease has been fed
    rounds: int = 0
    #: the round index (1-based) at which the dead verdict latched; 0 = alive
    dead_at_round: int = 0

    def verdict(self, lease_rounds: int) -> str:
        if self.dead_at_round:
            return DEAD
        if self.missed == 0:
            return LIVE
        return SUSPECT if self.missed < lease_rounds else DEAD

    def to_json(self) -> Dict:
        return {
            "missed": self.missed,
            "rounds": self.rounds,
            "dead_at_round": self.dead_at_round,
        }


class HeartbeatLedger:
    """Deterministic round-counted lease table (see module doc).

    ``lease_rounds`` is how many CONSECUTIVE missed observations kill a
    lease.  All iteration is sorted by host name; the same observation
    sequence produces the same verdict sequence on every replica that runs
    the ledger — pinned by test with two independently-fed ledgers.
    """

    def __init__(self, lease_rounds: int = 3) -> None:
        if lease_rounds < 1:
            raise ValueError(f"lease_rounds must be >= 1, got {lease_rounds}")
        self.lease_rounds = int(lease_rounds)
        self._leases: Dict[str, Lease] = {}
        self.ticks = 0
        self._newly_dead: List[str] = []

    # -- membership ----------------------------------------------------------

    def track(self, host: str) -> None:
        if host not in self._leases:
            self._leases[host] = Lease(host=host)

    def forget(self, host: str) -> None:
        self._leases.pop(host, None)

    def reset(self, host: str) -> None:
        """Re-admission: a host that was declared dead and has re-registered
        starts a fresh lease (the ONLY way out of the dead latch)."""
        self._leases[host] = Lease(host=host)

    def hosts(self) -> List[str]:
        return sorted(self._leases)

    # -- the observation round -----------------------------------------------

    def tick(self, beats: Mapping[str, bool]) -> Dict[str, str]:
        """Feed one observation round: ``beats[host]`` is True when the
        host answered this round's heartbeat.  A tracked host absent from
        ``beats`` counts as a miss (the poller could not even ask).
        Returns the post-tick verdict per host, and ``newly_dead`` below
        reports leases that latched dead ON this tick — the failover
        trigger must fire exactly once per death."""
        self.ticks += 1
        self._newly_dead = []
        verdicts: Dict[str, str] = {}
        for host in sorted(self._leases):
            lease = self._leases[host]
            lease.rounds += 1
            if lease.dead_at_round:
                verdicts[host] = DEAD
                continue
            if beats.get(host, False):
                lease.missed = 0
            else:
                lease.missed += 1
                if lease.missed >= self.lease_rounds:
                    lease.dead_at_round = lease.rounds
                    self._newly_dead.append(host)
            verdicts[host] = lease.verdict(self.lease_rounds)
        return verdicts

    def newly_dead(self) -> List[str]:
        """Hosts whose lease latched dead on the LAST :meth:`tick` (sorted;
        empty between deaths)."""
        return list(self._newly_dead)

    # -- readout --------------------------------------------------------------

    def verdict(self, host: str) -> str:
        return self._leases[host].verdict(self.lease_rounds)

    def lease(self, host: str) -> Lease:
        return self._leases[host]

    def dead_hosts(self) -> List[str]:
        return [
            h for h in sorted(self._leases)
            if self._leases[h].verdict(self.lease_rounds) == DEAD
        ]

    def snapshot(self) -> Dict:
        """JSON-serializable lease table (``/fleet.json`` section)."""
        return {
            "lease_rounds": self.lease_rounds,
            "ticks": self.ticks,
            "leases": {
                host: {
                    **self._leases[host].to_json(),
                    "verdict": self._leases[host].verdict(self.lease_rounds),
                }
                for host in sorted(self._leases)
            },
        }
