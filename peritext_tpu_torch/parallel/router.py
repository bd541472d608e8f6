"""Sharded doc placement across a serving fleet.

The serving tier's placement question — "which host should carry this new
doc, and which docs should move when a host degrades" — is answered HERE,
as a deterministic function of the observed fleet state: same
observations in, same placement out, on every replica that runs the
router.  That determinism is load-bearing (two frontends placing the same
doc must agree without coordination), so nothing here reads a wall clock
or an RNG.

Load model (the dimensions ``StreamingMerge.reshard()`` established):

* **slot load** — live device slots a host's docs occupy (device cost);
* **host-bound load** — quarantined/fallback docs replaying on the host's
  CPU (the scalar-replay rung of the degradation ladder costs the HOST,
  not the chip), balanced as its own dimension exactly as ``reshard()``
  balances it within one session;
* **lag** — the host's replication lag in ops
  (:class:`~..obs.convergence.ConvergenceMonitor` watermarks, folded in
  via :meth:`FleetRouter.observe`): a behind host charges a placement
  penalty, because a doc placed there serves stale reads until the gossip
  scheduler drains the lag.

Placement is least-loaded-first over the relevant dimension ordering
(host-bound docs weigh host-bound load first; device docs weigh
device+lag load first), name-tiebroken — the same greedy shape as
``reshard()``'s assignment, lifted from rows-within-a-session to
docs-across-a-fleet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class HostSlot:
    """One serving host's tracked placement state."""

    name: str
    #: doc slots this host's mux can still open (capacity bound)
    capacity: int
    docs: int = 0
    slot_load: int = 0
    host_bound_load: int = 0
    #: replication lag (ops behind the observing frontier) — the
    #: ConvergenceMonitor watermark, folded in by :meth:`FleetRouter.observe`
    lag_ops: int = 0
    #: paged-storage load (store/): pages the host's pool holds, from a
    #: paged session's ``reshard()["page_load"]`` / ``health()["page_pool"]``.
    #: Once observed — even at 0, a fresh empty pool — the host is marked
    #: ``paged`` and pages ARE its device dimension: a paged host's scarce
    #: resource is pool pages, and slot-unit estimates would overweight
    #: long docs that actually share pages with nobody.  Unit contract:
    #: placement ``size`` for a paged host is in PAGES, and a MIXED fleet
    #: (paged + padded hosts in one router) must feed page-normalized
    #: sizes/loads on the padded side too — the greedy compares the
    #: dimensions directly and never converts units.
    page_load: int = 0
    #: latched by the first ``observe(page_load=...)`` — see above
    paged: bool = False
    #: a draining host accepts no new docs (operator decommission, or the
    #: serving tier reacting to sustained overload)
    draining: bool = False
    #: per-doc placed sizes (doc_key -> size), the rebalance input
    placed: Dict[str, int] = field(default_factory=dict)
    #: doc_keys whose placed size was counted into ``page_load`` (placed
    #: AFTER the paged latch): _unassign must only subtract from the
    #: dimension the size was added to, or a pre-latch slot-unit doc would
    #: wipe the page estimate on eviction
    page_counted: set = field(default_factory=set)
    #: doc_keys currently host-bound (quarantined/fallback) on this host
    bound_docs: Dict[str, int] = field(default_factory=dict)

    def device_load(self) -> int:
        """The device-dimension load: reported pool pages for paged hosts
        (a fresh empty pool counts as 0, not as "fall back to slots"),
        slot load otherwise (see ``page_load``)."""
        return self.page_load if self.paged else self.slot_load

    def effective_load(self, lag_weight: int) -> int:
        """Device-dimension placement load: device load plus the lag penalty
        (a behind host is 'fuller' — new docs would read stale there)."""
        return self.device_load() + lag_weight * self.lag_ops

    def to_json(self) -> Dict:
        return {
            "capacity": self.capacity,
            "docs": self.docs,
            "slot_load": self.slot_load,
            "page_load": self.page_load,
            "paged": self.paged,
            "host_bound_load": self.host_bound_load,
            "lag_ops": self.lag_ops,
            "draining": self.draining,
        }


class PlacementError(ValueError):
    """No host can accept the doc (every host full or draining)."""


class FleetRouter:
    """Places and re-places docs across N serving hosts (see module doc).

    ``lag_weight`` scales the lag penalty in slot-load units per op behind
    (integer, so placement stays exact-arithmetic deterministic).  All
    iteration orders are sorted; ties break on host name, then doc key.
    """

    def __init__(self, lag_weight: int = 1) -> None:
        self.lag_weight = int(lag_weight)
        self._hosts: Dict[str, HostSlot] = {}
        self._doc_host: Dict[str, str] = {}
        self.placements = 0
        self.moves = 0

    # -- fleet membership -----------------------------------------------------

    def add_host(self, name: str, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError(f"host {name!r} needs positive capacity")
        if name in self._hosts:
            raise ValueError(f"host {name!r} already registered")
        self._hosts[name] = HostSlot(name=name, capacity=int(capacity))

    def remove_host(self, name: str) -> None:
        """Deregister a host (the fleet's dead-host re-admission path).
        Refuses while placements remain — a dead host's are forgotten by
        :meth:`fail_host` first, so a refusal here means the caller is
        removing a host that still serves docs."""
        host = self._hosts[name]
        if host.placed:
            raise PlacementError(
                f"host {name!r} still places {len(host.placed)} doc(s)"
            )
        del self._hosts[name]

    def hosts(self) -> List[str]:
        return sorted(self._hosts)

    def host(self, name: str) -> HostSlot:
        return self._hosts[name]

    def set_draining(self, name: str, draining: bool = True) -> None:
        self._hosts[name].draining = bool(draining)

    # -- observation ingestion (reshard load dims + monitor watermarks) ------

    def observe(
        self,
        name: str,
        slot_load: Optional[int] = None,
        host_bound_load: Optional[int] = None,
        lag_ops: Optional[int] = None,
        page_load: Optional[int] = None,
    ) -> None:
        """Fold one host's measured state in: ``slot_load`` /
        ``host_bound_load`` from its session's ``reshard()`` dimensions or
        health snapshot, ``lag_ops`` from a ConvergenceMonitor watermark
        (``peers()[host].ops_behind`` as observed by the routing frontend),
        ``page_load`` from a paged session's ``reshard()["page_load"]`` sum
        (pages become the device dimension — see ``HostSlot.page_load``).
        Measurements REPLACE the router's accumulated estimates — the
        estimate is only the prior between observations."""
        rec = self._hosts[name]
        if slot_load is not None:
            rec.slot_load = int(slot_load)
        if host_bound_load is not None:
            rec.host_bound_load = int(host_bound_load)
        if lag_ops is not None:
            rec.lag_ops = int(lag_ops)
        if page_load is not None:
            rec.page_load = int(page_load)
            rec.paged = True

    def observe_monitor(self, monitor) -> None:
        """Fold every registered host's lag watermark from one
        :class:`~..obs.convergence.ConvergenceMonitor` (hosts the monitor
        has never exchanged with keep their current estimate)."""
        peers = monitor.peers()
        for name in sorted(self._hosts):
            rec = peers.get(name)
            if rec is not None:
                self._hosts[name].lag_ops = int(rec.ops_behind)

    # -- placement ------------------------------------------------------------

    def _placement_key(self, host: HostSlot, host_bound: bool) -> Tuple:
        if host_bound:
            # scalar-replay docs cost the host CPU: balance that dimension
            # first, device load second (reshard()'s exact ordering)
            return (host.host_bound_load,
                    host.effective_load(self.lag_weight), host.name)
        return (host.effective_load(self.lag_weight),
                host.host_bound_load, host.name)

    def _eligible(self) -> List[HostSlot]:
        return [
            h for h in (self._hosts[n] for n in sorted(self._hosts))
            if not h.draining and h.docs < h.capacity
        ]

    def place(self, doc_key: str, size: int = 1,
              host_bound: bool = False) -> str:
        """Place one doc; returns the chosen host name.  ``size`` is the
        doc's slot-load estimate; ``host_bound`` places a doc already known
        to need scalar replay.  Raises :class:`PlacementError` when every
        host is full or draining (the caller's typed ``capacity`` shed)."""
        if doc_key in self._doc_host:
            return self._doc_host[doc_key]
        hosts = self._eligible()
        if not hosts:
            raise PlacementError(
                f"no serving host can accept doc {doc_key!r}"
            )
        best = min(hosts, key=lambda h: self._placement_key(h, host_bound))
        self._assign(doc_key, best, int(size), host_bound)
        self.placements += 1
        return best.name

    def _assign(self, doc_key: str, host: HostSlot, size: int,
                host_bound: bool) -> None:
        self._doc_host[doc_key] = host.name
        host.docs += 1
        host.slot_load += size
        if host.paged:
            # paged host: size is in PAGES (the caller sizes docs off the
            # paged reshard dimensions); keep the active dimension moving
            # between observations so the greedy stays monotone
            host.page_load += size
            host.page_counted.add(doc_key)
        host.placed[doc_key] = size
        if host_bound:
            host.host_bound_load += size
            host.bound_docs[doc_key] = size

    def _unassign(self, doc_key: str) -> Tuple[HostSlot, int, bool]:
        name = self._doc_host.pop(doc_key)
        host = self._hosts[name]
        size = host.placed.pop(doc_key)
        host.docs -= 1
        host.slot_load -= size
        if doc_key in host.page_counted:
            host.page_counted.discard(doc_key)
            host.page_load = max(0, host.page_load - size)
        bound = doc_key in host.bound_docs
        if bound:
            host.host_bound_load -= host.bound_docs.pop(doc_key)
        return host, size, bound

    def host_of(self, doc_key: str) -> Optional[str]:
        return self._doc_host.get(doc_key)

    def placement(self) -> Dict[str, str]:
        return dict(sorted(self._doc_host.items()))

    # -- re-placement ---------------------------------------------------------

    def mark_host_bound(self, doc_key: str, bound: bool = True) -> None:
        """A placed doc entered (or left) the quarantine/fallback rung:
        shift its size between the device and host-bound load dimensions
        in place (no move — degradation alone never migrates a doc; the
        next :meth:`rebalance` decides whether it should)."""
        name = self._doc_host[doc_key]
        host = self._hosts[name]
        size = host.placed[doc_key]
        if bound and doc_key not in host.bound_docs:
            host.bound_docs[doc_key] = size
            host.host_bound_load += size
        elif not bound and doc_key in host.bound_docs:
            host.host_bound_load -= host.bound_docs.pop(doc_key)

    def evacuate(self, name: str) -> List[Tuple[str, str, str]]:
        """Drain one host: re-place every doc it carries onto the rest of
        the fleet (largest first, host-bound docs first — reshard()'s
        scarcity ordering).  Returns the move plan
        ``[(doc_key, from_host, to_host), ...]`` in plan order; the host
        stays registered and draining.  ATOMIC: if the fleet lacks
        capacity mid-plan, every move already made is rolled back before
        :class:`PlacementError` raises — the caller acts on the whole
        returned plan or none of it, so router state never disagrees with
        where doc state physically lives."""
        host = self._hosts[name]
        host.draining = True
        moves: List[Tuple[str, str, str]] = []
        done: List[Tuple[str, int, bool]] = []  # (doc, size, bound) undo log
        order = sorted(
            host.placed,
            key=lambda dk: (dk not in host.bound_docs,
                            -host.placed[dk], dk),
        )
        for doc_key in order:
            _, size, bound = self._unassign(doc_key)
            hosts = self._eligible()
            if not hosts:
                # nowhere to go: restore this doc AND every earlier move
                self._assign(doc_key, host, size, bound)
                for undo_key, undo_size, undo_bound in reversed(done):
                    self._unassign(undo_key)
                    self._assign(undo_key, host, undo_size, undo_bound)
                self.moves -= len(done)
                raise PlacementError(
                    f"evacuating {name!r}: no capacity for doc {doc_key!r}"
                )
            best = min(hosts, key=lambda h: self._placement_key(h, bound))
            self._assign(doc_key, best, size, bound)
            moves.append((doc_key, name, best.name))
            done.append((doc_key, size, bound))
            self.moves += 1
        return moves

    def release(self, doc_key: str) -> None:
        """Forget one doc's placement — the execution layer failed to
        realize it (target mux out of slots) or the doc was deleted.  A
        no-op for unplaced docs."""
        if doc_key in self._doc_host:
            self._unassign(doc_key)

    def move(self, doc_key: str, to: str) -> None:
        """Directed single-doc move (the execution layer's manual-migration
        bookkeeping): re-assign ``doc_key`` to host ``to`` if it has room.
        Raises :class:`PlacementError` without touching state otherwise."""
        host = self._hosts[to]
        if host.draining or host.docs >= host.capacity:
            raise PlacementError(
                f"host {to!r} cannot accept doc {doc_key!r}"
            )
        _, size, bound = self._unassign(doc_key)
        self._assign(doc_key, host, size, bound)
        self.moves += 1

    def fail_host(self, name: str) -> List[Tuple[str, int, bool]]:
        """A host DIED (heartbeat lease expired): its doc state is gone, so
        — unlike :meth:`evacuate`, which plans moves of live state — its
        placements are simply forgotten and returned for failover
        re-placement from durable state (checkpoint + journal).  The host
        stays registered and draining so a zombie coming back cannot
        receive placements until it re-registers.  Returns
        ``[(doc_key, size, host_bound), ...]`` in the evacuation scarcity
        order (host-bound first, largest first, key tiebreak) — the order
        failover re-placement should run in."""
        host = self._hosts[name]
        host.draining = True
        order = sorted(
            host.placed,
            key=lambda dk: (dk not in host.bound_docs,
                            -host.placed[dk], dk),
        )
        lost: List[Tuple[str, int, bool]] = []
        for doc_key in order:
            _, size, bound = self._unassign(doc_key)
            lost.append((doc_key, size, bound))
        return lost

    def rollback_moves(self, moves: List[Tuple[str, str, str]]) -> None:
        """Reverse an executed move plan (``[(doc_key, from, to), ...]``
        from :meth:`evacuate` / :meth:`rebalance`), newest first — the
        execution layer's atomic-cutover escape hatch: when a move plan's
        PHYSICAL execution fails partway (a cutover digest mismatch), the
        router's bookkeeping must return to the pre-plan placement so it
        never disagrees with where doc state actually serves."""
        for doc_key, from_host, _ in reversed(moves):
            _, size, bound = self._unassign(doc_key)
            self._assign(doc_key, self._hosts[from_host], size, bound)
            self.moves -= 1

    def rebalance(self, max_moves: int = 8) -> List[Tuple[str, str, str]]:
        """Bounded greedy re-placement: while the most- and least-loaded
        hosts (device dimension, lag-penalized) differ by more than the
        moved doc's size, move the largest doc that shrinks the spread.
        Deterministic and monotone: every accepted move strictly reduces
        the max-min spread, so the plan cannot oscillate.  Returns the
        move plan (may be empty)."""
        moves: List[Tuple[str, str, str]] = []
        for _ in range(max_moves):
            hosts = [self._hosts[n] for n in sorted(self._hosts)
                     if not self._hosts[n].draining]
            if len(hosts) < 2:
                break
            hot = max(hosts, key=lambda h: (h.effective_load(self.lag_weight), h.name))
            cold = min(
                (h for h in hosts if h.docs < h.capacity),
                key=lambda h: (h.effective_load(self.lag_weight), h.name),
                default=None,
            )
            if cold is None or hot.name == cold.name:
                break
            spread = (hot.effective_load(self.lag_weight)
                      - cold.effective_load(self.lag_weight))
            candidates = sorted(
                ((size, dk) for dk, size in hot.placed.items()
                 if 0 < size < spread),
                key=lambda sd: (-sd[0], sd[1]),
            )
            if not candidates:
                break
            size, doc_key = candidates[0]
            _, _, bound = self._unassign(doc_key)
            self._assign(doc_key, cold, size, bound)
            moves.append((doc_key, hot.name, cold.name))
            self.moves += 1
        return moves

    def snapshot(self) -> Dict:
        """JSON-serializable fleet placement state (composes into the
        serve exporter surfaces)."""
        return {
            "hosts": {
                name: self._hosts[name].to_json()
                for name in sorted(self._hosts)
            },
            "docs": len(self._doc_host),
            "placements": self.placements,
            "moves": self.moves,
            "lag_weight": self.lag_weight,
        }
