"""Multi-host serving fleet: placement decisions executed as real state.

The deterministic :class:`~..parallel.router.FleetRouter` plans
placements, ``evacuate()`` and ``rebalance()`` as *bookkeeping*.  This
module is the execution layer: a :class:`FleetFrontend` places docs across
live :class:`~.mux.SessionMux` hosts via the router, ingests per-host
load back through the mux's own exporter surface
(``snapshot()["load"]`` — the same body ``/serve.json`` serves), detects
host death with the deterministic round-counted heartbeat leases of
:mod:`~..parallel.lease`, and executes placement changes as REAL doc-state
movement:

* **checkpoint ship** — a doc's durable form is its wire-frame history
  (event sourcing, the checkpoint invariant); migration ships it to
  the target over the retrying multihost transport
  (:func:`~..parallel.multihost.ship_frames`) when the target serves a
  ship endpoint, in-process otherwise;
* **anti-entropy catch-up** — ops that landed on the source mid-move are
  shipped as frame-count-frontier diffs (duplicate-tolerant, the same
  merge semantics the CRDT already guarantees converge);
* **digest-checked cutover** — before the old slot is released, source and
  target must agree on the doc's full-state hash
  (:meth:`~..parallel.streaming.StreamingMerge.doc_digest`) BYTE-FOR-BYTE;
  a mismatch aborts the whole plan and rolls back atomically (router
  bookkeeping via ``rollback_moves``, serving map back to the sources,
  whose sessions were deliberately not released yet) — the router's
  atomic ``evacuate()`` plan semantics at the physical layer.

**Failover** (the lease's ``dead`` verdict): the dead host's docs re-place
from the last shipped checkpoint plus journal redelivery — the frontend
journals every ACKED (admitted) frame between checkpoint ships, so
``checkpoint ∪ journal ⊇ acked ops`` is an invariant and every acked op
survives the host that held it.  While a doc is mid-failover (or
mid-cutover) its submissions get typed ``delay`` verdicts; a doc failover
could not re-place (no fleet capacity) sheds ``failover`` — zero silent
drops extends fleet-wide, and the accounting identity
``submitted == admitted + delayed + shed`` holds over every verdict the
frontend returned.  The flight recorder dumps the failover timeline.

On the card, a ship receive runs on a transport handler thread: it runs
under the host session's device and the stream of the thread that built
the host, and under the host's lock, so a frontend pump and a ship never
interleave on one session.

Wall-clock reads are legal here; everything that must be deterministic —
lease verdicts, placement — lives in ``parallel/`` and reads no clock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..core.errors import PeritextError
from ..obs import GLOBAL_COUNTERS, GLOBAL_TRACER
from ..parallel.lease import DEAD, HeartbeatLedger
from ..parallel.router import FleetRouter, PlacementError
from .auth import AuthError
from .admission import (
    ADMIT,
    AdmissionController,
    DELAY,
    SHED,
    SHED_CAPACITY,
    SHED_FAILOVER,
    SHED_UNAUTHORIZED,
    SHED_UNKNOWN_SESSION,
    Verdict,
)
from .mux import SessionMux


class HostDown(PeritextError):
    """The addressed serving host is dead (raised inside the fleet layer,
    converted to typed verdicts at the frontend edge — a client never sees
    this exception)."""


class CutoverError(PeritextError):
    """Migration cutover digest mismatch: source and target disagree on
    the doc's full-state hash, so the old slot must NOT be released — the
    plan rolls back atomically."""


class FleetHost:
    """One serving host in the fleet: a :class:`SessionMux`, its doc-key →
    session mapping, and (optionally) a real TCP ship endpoint
    (``transport=True`` starts a :class:`~..parallel.multihost.ReplicaServer`
    whose ``on_ship`` lands checkpoint frames in this mux's doc slots).

    Thread-safe around the mux/session: ship receives run on transport
    handler threads while the frontend pumps on its own.  A receive on a
    card session runs on that session's device and on the stream current
    in the thread that built this host, so its rounds queue behind the
    frontend's."""

    def __init__(self, name: str, mux: SessionMux, transport: bool = False,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.name = name
        self.mux = mux
        self.alive = True
        self._lock = threading.RLock()
        self._docs: Dict[str, int] = {}
        device = getattr(mux.session, "device", None)
        self._cuda = (device, torch.cuda.current_stream(device)) \
            if device is not None and device.type == "cuda" else None
        self.server = None
        if transport:
            from ..parallel.anti_entropy import ChangeStore
            from ..parallel.multihost import ReplicaServer

            self.server = ReplicaServer(
                ChangeStore(), host=host, port=port, on_ship=self._on_ship,
            )
            self.server.start()

    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return self.server.address if self.server is not None else None

    # -- liveness -------------------------------------------------------------

    def heartbeat(self) -> bool:
        """The lease ledger's beat input.  In-process liveness here; a
        WAN deployment would probe the wire — the DETERMINISM lives in the
        ledger, the beat source is deliberately pluggable."""
        return self.alive

    def kill(self) -> None:
        """Chaos: the host dies mid-traffic — the mux stops answering, the
        ship endpoint closes, heartbeats stop.  Doc state on this host is
        GONE as far as the fleet is concerned (failover restores from
        checkpoint + journal)."""
        self.alive = False
        if self.server is not None:
            self.server.stop()

    def _require_alive(self) -> None:
        if not self.alive:
            raise HostDown(self.name)

    # -- doc slots ------------------------------------------------------------

    def session_of(self, doc_key: str) -> Optional[int]:
        with self._lock:
            return self._docs.get(doc_key)

    def ensure_doc(self, doc_key: str,
                   client: str = "fleet") -> Tuple[Optional[int], Verdict]:
        """Claim (or find) this host's mux session for ``doc_key``."""
        with self._lock:
            self._require_alive()
            sid = self._docs.get(doc_key)
            if sid is not None:
                return sid, Verdict(kind=ADMIT)
            sid, verdict = self.mux.open_session(client)
            if sid is not None:
                self._docs[doc_key] = sid
            return sid, verdict

    def doc_have(self, doc_key: str) -> int:
        """How many frames this host already holds for ``doc_key`` (0 when
        it has no slot).  The resume input for a retried migration: mux
        slots are append-only, so a failed move KEEPS its doc→slot
        reservation and the next attempt ships into the same slot instead
        of burning a fresh one per retry."""
        with self._lock:
            sid = self._docs.get(doc_key)
            if sid is None or not self.alive:
                return 0
            doc = self.mux.sessions()[sid].doc_index
            return len(self.mux.session.doc_history_frames(doc))

    def doc_append_only(self, doc_key: str) -> bool:
        """Whether the doc's frame history is append-only (frame-mode
        docs): True means a partial ship resumes as a prefix append;
        False (fallback/object docs re-encode the whole log) means a
        resumed ship must re-send in full — the receiver's merge is
        idempotent either way."""
        with self._lock:
            self._require_alive()
            doc = self.mux.sessions()[self._docs[doc_key]].doc_index
            return bool(self.mux.session.docs[doc].frame_mode)

    def release_doc(self, doc_key: str) -> None:
        """Release the doc's serving slot (migration cutover committed, or
        the slot's state is distrusted after a cutover digest mismatch):
        the session closes; its resident device state becomes garbage the
        append-only slot map simply stops reaching (mux slots are
        append-only by design — see SessionMux)."""
        with self._lock:
            sid = self._docs.pop(doc_key, None)
            if sid is not None:
                self.mux.close_session(sid)

    # -- the serving surface --------------------------------------------------

    def submit(self, doc_key: str, frame: bytes) -> Verdict:
        with self._lock:
            self._require_alive()
            return self.mux.submit(self._docs[doc_key], frame)

    def pump(self) -> int:
        with self._lock:
            if not self.alive:
                return 0
            return self.mux.pump()

    def flush(self) -> int:
        with self._lock:
            self._require_alive()
            return self.mux.flush()

    # -- migration state access ----------------------------------------------

    def doc_frames(self, doc_key: str) -> List[bytes]:
        """The doc's ingested frame history (flushing the open round first
        so every ACKED frame is in it) — the checkpoint-ship payload."""
        with self._lock:
            self._require_alive()
            self.mux.flush()
            return self.mux.session.doc_history_frames(self._docs[doc_key])

    def doc_digest(self, doc_key: str) -> int:
        """The doc's full-state hash (flushed first) — the cutover oracle."""
        with self._lock:
            self._require_alive()
            self.mux.flush()
            return self.mux.session.doc_digest(self._docs[doc_key])

    def ingest_doc_frames(self, doc_key: str, frames: List[bytes],
                          base: int = 0) -> int:
        """The ship receiver: land checkpoint/catch-up frames in the doc's
        slot and drain.  ``base`` is the sender's belief of how many frames
        this host already holds; frames this host provably has (history
        longer than ``base``) are skipped so a retried ship stays a prefix
        append.  Returns the post-merge history length (the ack's
        ``have``).  Raises :class:`PlacementError` when the mux is out of
        slots — a ship to a full host must fail loudly, never truncate."""
        with self._lock:
            self._require_alive()
            sid, _ = self.ensure_doc(doc_key, client="migration")
            if sid is None:
                raise PlacementError(
                    f"host {self.name!r}: no slot for shipped doc {doc_key!r}"
                )
            sess = self.mux.session
            doc = self.mux.sessions()[sid].doc_index
            have = len(sess.doc_history_frames(doc))
            skip = max(0, have - int(base))
            for frame in frames[skip:]:
                sess.ingest_frame(doc, frame, on_corrupt="quarantine")
            while sess.drain() > 0:
                pass
            return len(sess.doc_history_frames(doc))

    def _on_ship(self, doc_key: str, frames: List[bytes], base: int) -> int:
        """The ship endpoint's receiver (a transport handler thread)."""
        if self._cuda is None:
            return self.ingest_doc_frames(doc_key, frames, base)
        device, stream = self._cuda
        with torch.cuda.device(device), torch.cuda.stream(stream):
            return self.ingest_doc_frames(doc_key, frames, base)

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "alive": self.alive,
                "docs": sorted(self._docs),
                "address": list(self.address) if self.address else None,
                "serve": self.mux.snapshot() if self.alive else None,
            }


@dataclass
class FleetStats:
    """Fleet-wide verdict accounting over every submission the frontend
    answered (host-mux verdicts routed through plus the frontend's own
    out-of-band failover/auth/capacity verdicts).  The zero-silent-drops
    identity ``submitted == admitted + delayed + shed`` is the chaos
    harness's fleet-wide oracle."""

    submitted: int = 0
    admitted: int = 0
    delayed: int = 0
    shed: int = 0
    shed_reasons: Dict[str, int] = field(default_factory=dict)

    def observe(self, verdict: Verdict) -> Verdict:
        self.submitted += 1
        if verdict.kind == ADMIT:
            self.admitted += 1
        elif verdict.kind == DELAY:
            self.delayed += 1
        elif verdict.kind == SHED:
            self.shed += 1
            self.shed_reasons[verdict.reason] = (
                self.shed_reasons.get(verdict.reason, 0) + 1
            )
        return verdict

    def accounted(self) -> bool:
        return self.submitted == self.admitted + self.delayed + self.shed

    def to_json(self) -> Dict:
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "delayed": self.delayed,
            "shed": self.shed,
            "shed_reasons": dict(sorted(self.shed_reasons.items())),
        }


class FleetFrontend:
    """Places docs across live serving hosts and keeps them alive (see
    module doc).  ``checkpoint_every`` is in frontend bookkeeping ROUNDS
    (the same unit the heartbeat lease counts); ``auth`` is an optional
    :class:`~.auth.SessionKeyring` verified at the fleet edge — on EVERY
    submit, not just at open: unlike a mux session id (a server-assigned
    opaque bearer), the fleet edge routes by ``doc_key``, a public
    client-chosen name, so possession of the name must never stand in for
    the credential.  ``recorder`` an optional
    :class:`~..obs.FlightRecorder` that dumps the failover timeline."""

    def __init__(
        self,
        router: Optional[FleetRouter] = None,
        lease_rounds: int = 3,
        checkpoint_every: int = 4,
        auth=None,
        recorder=None,
        retry=None,
        tracer=None,
    ) -> None:
        from ..parallel.multihost import RetryPolicy

        self.router = router if router is not None else FleetRouter()
        self.ledger = HeartbeatLedger(lease_rounds)
        self.hosts: Dict[str, FleetHost] = {}
        self.auth = auth
        self.recorder = recorder
        self.retry = retry if retry is not None else RetryPolicy(
            attempts=3, base_delay=0.01, max_delay=0.2, timeout=5.0,
        )
        self.tracer = tracer if tracer is not None else GLOBAL_TRACER
        self.checkpoint_every = int(checkpoint_every)
        #: out-of-band typed verdicts (failover delay/shed, auth, capacity):
        #: the queue logic is unused, the verdict accounting + counters are
        #: the point (serve.shed.<reason> telemetry stays one vocabulary)
        self._oob = AdmissionController()
        self.stats = FleetStats()
        #: doc_key -> host currently SERVING it.  The router tracks
        #: PLACEMENT (flips at plan time); this map flips only at cutover —
        #: mid-move ops keep landing on the source, which is what the
        #: catch-up leg ships
        self._serving: Dict[str, str] = {}
        self._clients: Dict[str, str] = {}
        #: per-doc acked-frame journal since the last checkpoint ship
        self._journal: Dict[str, List[bytes]] = {}
        #: per-doc set of every frame ever journaled (shares the journal's
        #: bytes objects): a client retrying its whole plan after a
        #: failover re-admits byte-identical frames, and without dedup
        #: each retry pass would permanently multiply the standby store
        self._acked_frames: Dict[str, set] = {}
        #: per-doc last shipped checkpoint (the frontend is the fleet's
        #: standby store: ``checkpoint ∪ journal ⊇ acked``)
        self._checkpoint: Dict[str, List[bytes]] = {}
        #: docs failover could not re-place (shed(failover) until capacity)
        self._failed_docs: set = set()
        #: docs paused for cutover (typed delay verdicts)
        self._moving: set = set()
        self.rounds = 0
        self.failovers = 0
        self.failover_docs = 0
        self.migrations = 0
        self.migration_rollbacks = 0
        self.checkpoint_ships = 0

    # -- fleet membership -----------------------------------------------------

    def add_host(self, name: str, mux: SessionMux,
                 capacity: Optional[int] = None,
                 transport: bool = False) -> FleetHost:
        """Register a serving host.  Re-registering a name whose lease is
        DEAD is the re-admission path (the only way out of the lease
        latch): the zombie's remnants are torn down and the name starts a
        fresh lease.  A live name re-registering is an operator error and
        raises BEFORE any state mutates — no half-registered fleet."""
        if getattr(mux, "auth", None) is not None:
            # the fleet edge is the tenant auth boundary; host muxes sit
            # behind it and are driven by internal clients (migration
            # ships, failover redelivery) that hold no tokens — a mux-level
            # keyring would make every failover/migration shed unauthorized
            raise AuthError(
                f"host {name!r}: fleet-managed muxes must not enable "
                "mux-level auth; pass the keyring to FleetFrontend(auth=)"
            )
        if name in self.hosts:
            if self.hosts[name].alive and self.ledger.verdict(name) != DEAD:
                raise ValueError(f"host {name!r} already registered")
            # dead-host re-admission: fail_host() already unassigned its
            # placements, so the draining router slot removes cleanly
            self.hosts[name].stop()
            self.router.remove_host(name)
            self.ledger.reset(name)
        self.router.add_host(
            name,
            capacity if capacity is not None else mux.session.num_docs,
        )
        host = FleetHost(name, mux, transport=transport)
        self.hosts[name] = host
        self.ledger.track(name)
        return host

    def stop(self) -> None:
        for host in self.hosts.values():
            host.stop()

    # -- the client surface ---------------------------------------------------

    def open_doc(self, doc_key: str, client: str,
                 token: Optional[str] = None) -> Verdict:
        """Place + open one doc on the fleet.  Typed verdicts only:
        ``unauthorized`` (auth edge, checked first; on an auth-enabled
        fleet re-opening a served doc also requires the REGISTERED owner —
        doc keys are public names, so any-valid-token would hand one
        tenant's doc to another), ``capacity`` (no host can take it), else
        ``admit``."""
        if self.auth is not None and not self.auth.verify(client, token):
            return self.stats.observe(
                self._oob.shed_out_of_band(SHED_UNAUTHORIZED))
        if doc_key in self._serving:
            if self.auth is not None and client != self._clients.get(doc_key):
                return self.stats.observe(
                    self._oob.shed_out_of_band(SHED_UNAUTHORIZED))
            return self.stats.observe(Verdict(kind=ADMIT))
        try:
            placed = self.router.place(doc_key, size=1)
        except PlacementError:
            return self.stats.observe(
                self._oob.shed_out_of_band(SHED_CAPACITY))
        sid, verdict = self.hosts[placed].ensure_doc(doc_key, client)
        if sid is None:
            self.router.release(doc_key)
            return self.stats.observe(verdict)
        self._serving[doc_key] = placed
        self._clients[doc_key] = client
        self._journal.setdefault(doc_key, [])
        GLOBAL_COUNTERS.add("fleet.docs_opened")
        return self.stats.observe(verdict)

    def submit(self, doc_key: str, frame: bytes,
               token: Optional[str] = None) -> Verdict:
        """Route one frame to the doc's serving host.  Every outcome is a
        typed verdict; ``admit`` additionally journals the frame (the
        acked-op survival invariant).  An auth-enabled fleet verifies the
        token on EVERY submit against the doc's registered owner —
        ``doc_key`` is a public name, not a bearer, so the check cannot be
        an opt-in (and an unknown doc sheds ``unauthorized`` before
        ``unknown-session``, leaking no doc existence to probes)."""
        if (self.auth is not None
                and not self.auth.verify(self._clients.get(doc_key, ""),
                                         token)):
            return self.stats.observe(
                self._oob.shed_out_of_band(SHED_UNAUTHORIZED))
        if doc_key in self._failed_docs:
            return self.stats.observe(
                self._oob.shed_out_of_band(SHED_FAILOVER))
        if doc_key in self._moving:
            return self.stats.observe(self._oob.delay_out_of_band(0.01))
        serving = self._serving.get(doc_key)
        if serving is None:
            return self.stats.observe(
                self._oob.shed_out_of_band(SHED_UNKNOWN_SESSION))
        host = self.hosts[serving]
        try:
            verdict = host.submit(doc_key, frame)
        except HostDown:
            # the host died and the lease has not expired yet (or failover
            # is about to run): the client retries — nothing was taken
            return self.stats.observe(self._oob.delay_out_of_band(0.05))
        if verdict.kind == ADMIT:
            # dedup against everything ever journaled: a post-failover
            # client retrying its whole plan re-admits byte-identical
            # frames, and the standby store must not grow per retry pass
            seen = self._acked_frames.setdefault(doc_key, set())
            if frame not in seen:
                seen.add(frame)
                self._journal.setdefault(doc_key, []).append(frame)
        return self.stats.observe(verdict)

    def patches(self, doc_key: str):
        host = self.hosts[self._serving[doc_key]]
        return host.mux.patches(host.session_of(doc_key))

    def doc_digest(self, doc_key: str) -> int:
        return self.hosts[self._serving[doc_key]].doc_digest(doc_key)

    # -- the frontend bookkeeping round ---------------------------------------

    def round(self) -> Dict[str, str]:
        """One observation round: heartbeats → lease ledger (newly-dead
        leases trigger failover), pump every live host's round window,
        re-ingest per-host load through the mux exporter surface, and ship
        checkpoints every ``checkpoint_every`` rounds.  Returns the lease
        verdicts."""
        self.rounds += 1
        beats = {name: host.heartbeat()
                 for name, host in sorted(self.hosts.items())}
        verdicts = self.ledger.tick(beats)
        for name in self.ledger.newly_dead():
            self._failover(name)
        for name in sorted(self.hosts):
            self.hosts[name].pump()
        self.observe_loads()
        if self.checkpoint_every and self.rounds % self.checkpoint_every == 0:
            self.checkpoint_ship()
        return verdicts

    def observe_loads(self) -> None:
        """Fold every live host's measured load (mux ``snapshot()["load"]``
        — the ``/serve.json`` surface) into the router's placement state."""
        for name in sorted(self.hosts):
            host = self.hosts[name]
            if not host.alive:
                continue
            load = host.mux.load_report()
            self.router.observe(
                name,
                slot_load=load["slot_load"],
                host_bound_load=load["host_bound_load"],
                page_load=load.get("page_load"),
            )

    def observe_lag(self, name: str, lag_ops: int) -> None:
        """Fold a host's replication-lag watermark (a ConvergenceMonitor
        ``ops_behind`` reading) into placement."""
        self.router.observe(name, lag_ops=lag_ops)

    def checkpoint_ship(self) -> int:
        """Fold every doc's journal into the frontend's standby checkpoint
        and restart the journal empty: after this, the checkpoint alone
        covers every acked op so far.  The fold is O(journal), never
        O(history) — every acked frame already flowed through
        :meth:`submit`'s journal (the frontend IS the fleet's write path;
        ``open_doc`` creates the doc), so pulling the host's full frame
        history every few rounds would re-copy the same bytes forever for
        nothing.  A dead host cannot stall this: no host is touched.
        Returns how many docs folded journal frames."""
        shipped = 0
        for doc_key in sorted(self._serving):
            journal = self._journal.get(doc_key)
            if not journal:
                continue
            self._checkpoint.setdefault(doc_key, []).extend(journal)
            self._journal[doc_key] = []
            shipped += 1
        self.checkpoint_ships += 1
        GLOBAL_COUNTERS.add("fleet.checkpoint_ships")
        return shipped

    # -- failover --------------------------------------------------------------

    def _failover(self, dead: str) -> None:
        """The lease latched dead: forget the host's placements and re-home
        every doc from durable state — last shipped checkpoint + journal
        redelivery (frames are duplicate-tolerant, so overlap between the
        two is harmless and every ACKED op is in their union)."""
        self.failovers += 1
        GLOBAL_COUNTERS.add("fleet.failovers")
        if self.recorder is not None:
            self.recorder.fault(
                "host-death", host=dead, round=self.rounds,
                docs=len(self.hosts[dead].snapshot()["docs"])
                if dead in self.hosts else 0,
            )
        with self.tracer.span("fleet.failover", host=dead) as sp:
            lost = self.router.fail_host(dead)
            replaced, failed = [], []
            for doc_key, size, bound in lost:
                if self._re_place(doc_key, size, bound):
                    replaced.append(doc_key)
                else:
                    failed.append(doc_key)
            sp.args.update(replaced=len(replaced), failed=len(failed))
        if self.recorder is not None:
            self.recorder.fault(
                "failover-complete", host=dead, round=self.rounds,
                replaced=sorted(replaced), failed=sorted(failed),
            )

    def _re_place(self, doc_key: str, size: int, bound: bool) -> bool:
        try:
            target_name = self.router.place(doc_key, size, bound)
        except PlacementError:
            self._failed_docs.add(doc_key)
            GLOBAL_COUNTERS.add("fleet.failover_unplaced_docs")
            return False
        target = self.hosts[target_name]
        frames = (self._checkpoint.get(doc_key, [])
                  + self._journal.get(doc_key, []))
        try:
            sid, _ = target.ensure_doc(
                doc_key, self._clients.get(doc_key, "fleet"))
            if sid is None:
                raise PlacementError(f"no slot on {target_name!r}")
            # redelivery rides the same ship leg migrations use (TCP when
            # the target serves a ship endpoint)
            self._ship(target, doc_key, frames, base=0)
        except (HostDown, PlacementError, OSError):
            self.router.release(doc_key)
            # the target's doc→slot reservation (if the ship got that far)
            # is deliberately KEPT: retry_failed() re-ships into the same
            # slot — frames are duplicate-tolerant and redelivery always
            # sends checkpoint+journal with base=0, so the receiver's
            # prefix-skip resumes exactly where the dead attempt stopped
            self._failed_docs.add(doc_key)
            GLOBAL_COUNTERS.add("fleet.failover_unplaced_docs")
            return False
        self._serving[doc_key] = target_name
        self._failed_docs.discard(doc_key)
        self.failover_docs += 1
        GLOBAL_COUNTERS.add("fleet.failover_docs")
        return True

    def retry_failed(self) -> int:
        """Re-attempt failover placement for docs that shed ``failover``
        (capacity may have returned: a new host registered, or load
        drained).  Returns how many re-homed."""
        healed = 0
        for doc_key in sorted(self._failed_docs):
            if self._re_place(doc_key, 1, False):
                healed += 1
        return healed

    # -- migration (the evacuate/rebalance executor) ---------------------------

    def _ship(self, target: FleetHost, doc_key: str,
              frames: List[bytes], base: int) -> int:
        """One ship leg: over the retrying multihost transport when the
        target serves a ship endpoint, in-process otherwise (identical
        receiver semantics — ``FleetHost.ingest_doc_frames`` either way)."""
        if target.address is not None:
            from ..parallel.multihost import ship_frames

            return ship_frames(
                *target.address, doc_key, frames, base=base,
                retry=self.retry, tracer=self.tracer,
            )
        return target.ingest_doc_frames(doc_key, frames, base=base)

    def _ship_delta(self, target: FleetHost, doc_key: str,
                    prev: List[bytes], current: List[bytes],
                    have: int) -> Tuple[int, bool]:
        """One catch-up leg: ship whatever ``current`` holds beyond
        ``prev`` (the last-shipped history).  Frame-mode docs are
        append-only, so the tail ships; fallback/object docs RE-ENCODE
        their whole log as one frame whose content changes but whose
        count does not — those re-ship in full with ``base=have`` so the
        receiver's prefix-skip cannot drop the re-encoded payload
        (its merge is idempotent, overlap is harmless).  Returns
        ``(new have, whether anything shipped)``."""
        if current == prev:
            return have, False
        if current[:len(prev)] == prev:
            return (self._ship(target, doc_key, current[len(prev):],
                               base=have), True)
        return self._ship(target, doc_key, current, base=have), True

    def _execute_move(self, doc_key: str, to_name: str,
                      catch_up_rounds: int = 3) -> Tuple[str, int]:
        """Physically move one doc to ``to_name``: checkpoint ship →
        unpaused anti-entropy catch-up (ops landing mid-move keep hitting
        the source and ship as frame-frontier diffs) → cutover pause
        (typed delay verdicts) → final catch-up → byte-equality digest
        check → serving-map flip.  The SOURCE slot is NOT released here —
        the plan executor releases sources only once the whole plan
        committed, so a later cutover failure can still roll everything
        back onto intact source state.  Returns ``(source host name,
        frames shipped)``; raises :class:`CutoverError` on digest
        mismatch (doc unpaused, still serving on the source)."""
        src_name = self._serving[doc_key]
        src, target = self.hosts[src_name], self.hosts[to_name]
        with self.tracer.span("fleet.migrate", doc=doc_key,
                              src=src_name, dst=to_name):
            frames = src.doc_frames(doc_key)
            have0 = target.doc_have(doc_key)
            if have0 == 0:
                have = self._ship(target, doc_key, frames, base=0)
            elif src.doc_append_only(doc_key):
                # resumed slot (a prior attempt failed mid-ship): the
                # target's partial history is a prefix of this same
                # append-only list — ship only the missing tail
                have = (self._ship(target, doc_key, frames[have0:],
                                   base=have0)
                        if len(frames) > have0 else have0)
            else:
                # resumed slot, re-encoded history: the receiver's partial
                # content is unknowable by count, so re-ship in full with
                # base=have0 (no prefix-skip; the merge is idempotent)
                have = self._ship(target, doc_key, frames, base=have0)
            prev, total = frames, len(frames)
            # catch-up: ops that landed while the checkpoint shipped
            for _ in range(max(0, catch_up_rounds)):
                current = src.doc_frames(doc_key)
                have, changed = self._ship_delta(
                    target, doc_key, prev, current, have)
                prev, total = current, len(current)
                if not changed:
                    break
            self._moving.add(doc_key)
            try:
                current = src.doc_frames(doc_key)
                have, _ = self._ship_delta(
                    target, doc_key, prev, current, have)
                total = len(current)
                src_digest = src.doc_digest(doc_key)
                dst_digest = target.doc_digest(doc_key)
                if src_digest != dst_digest:
                    GLOBAL_COUNTERS.add("fleet.cutover_mismatches")
                    # the target slot's state failed byte equality: it is
                    # DISTRUSTED and must never be resumed into — drop the
                    # reservation (the rare case where a slot is burned;
                    # transport failures keep theirs for resume)
                    target.release_doc(doc_key)
                    raise CutoverError(
                        f"doc {doc_key!r} {src_name}->{to_name}: cutover "
                        f"digest {dst_digest:#010x} != source "
                        f"{src_digest:#010x}"
                    )
                # cutover: new ops route to the target from here on
                self._serving[doc_key] = to_name
            finally:
                self._moving.discard(doc_key)
        self.migrations += 1
        GLOBAL_COUNTERS.add("fleet.migrations")
        return src_name, total

    def _execute_plan(self,
                      plan: List[Tuple[str, str, str]]) -> List[Tuple[str, str, str]]:
        """Execute a router move plan atomically: every cutover must pass
        its digest check or NONE of the plan lands — executed cutovers
        revert to their (still intact) sources, target doc→slot
        reservations are kept so a retried plan resumes its ships (a
        digest-mismatched slot alone is distrusted and dropped), and the
        router's bookkeeping rolls back to the pre-plan placement.
        Source slots release only after the whole plan committed."""
        executed: List[Tuple[str, str, str]] = []
        try:
            for doc_key, from_name, to_name in plan:
                self._execute_move(doc_key, to_name)
                executed.append((doc_key, from_name, to_name))
        except (CutoverError, HostDown, PlacementError, PeritextError,
                ValueError, OSError):
            for doc_key, from_name, _ in reversed(executed):
                self._serving[doc_key] = from_name
            # target doc→slot reservations are KEPT on rollback: mux slots
            # are append-only, so releasing could never reclaim capacity —
            # a retried plan resumes each ship into the same slot instead
            # of burning a fresh one per attempt (the shipped state is a
            # valid partial merge; only a cutover digest MISMATCH distrusts
            # a slot, and _execute_move releases that one itself)
            self.router.rollback_moves(plan)
            self.migration_rollbacks += 1
            GLOBAL_COUNTERS.add("fleet.migration_rollbacks")
            raise
        for doc_key, from_name, _ in executed:
            self.hosts[from_name].release_doc(doc_key)
        return executed

    def migrate(self, doc_key: str, to_name: str) -> None:
        """Directed single-doc migration (router bookkeeping + physical
        move, atomic)."""
        from_name = self._serving[doc_key]
        self.router.move(doc_key, to_name)
        self._execute_plan([(doc_key, from_name, to_name)])

    def evacuate(self, name: str) -> List[Tuple[str, str, str]]:
        """Drain one host FOR REAL: the router's atomic plan, executed as
        checkpoint ship + catch-up + digest-checked cutover per doc.  All
        or nothing (see :meth:`_execute_plan`)."""
        plan = self.router.evacuate(name)
        return self._execute_plan(plan)

    def rebalance(self, max_moves: int = 8) -> List[Tuple[str, str, str]]:
        """The router's bounded-greedy rebalance, executed as real state
        movement.  All or nothing."""
        plan = self.router.rebalance(max_moves=max_moves)
        return self._execute_plan(plan)

    # -- readout ---------------------------------------------------------------

    def flush(self) -> None:
        for name in sorted(self.hosts):
            host = self.hosts[name]
            if host.alive:
                host.flush()

    def snapshot(self) -> Dict:
        """The ``/fleet.json`` body (golden-shape pinned): lease table,
        router placement, per-host serve summaries, durable-state
        bookkeeping and the fleet-wide verdict accounting."""
        return {
            "rounds": self.rounds,
            "hosts": {
                name: self.hosts[name].snapshot()
                for name in sorted(self.hosts)
            },
            "leases": self.ledger.snapshot(),
            "router": self.router.snapshot(),
            "serving": dict(sorted(self._serving.items())),
            "moving": sorted(self._moving),
            "failed_docs": sorted(self._failed_docs),
            "failovers": self.failovers,
            "failover_docs": self.failover_docs,
            "migrations": self.migrations,
            "migration_rollbacks": self.migration_rollbacks,
            "checkpoint_ships": self.checkpoint_ships,
            "journal_frames": sum(len(v) for v in self._journal.values()),
            "checkpoint_docs": len(self._checkpoint),
            "verdicts": self.stats.to_json(),
            "auth": (self.auth.snapshot()
                     if self.auth is not None else None),
        }
