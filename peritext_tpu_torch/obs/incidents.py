"""Fleet incident plane: typed, round-counted incidents correlated across
every observability surface.

The planes each answer one narrow question: the heartbeat ledger says which
host is dead, the convergence monitor says which peer diverged, the
admission queue says what it shed, the latency plane says how much SLO
budget burned, a build sentinel says what was built, the supervisor says
what it rolled back, a perf report says what regressed, and the history
plane says which gauge drifted from its own past.  :class:`IncidentMonitor`
gives the *correlated* answer (what broke, where, and what was the first
cause) as a deterministic fold over the planes' own snapshots.

Design rules:

* **Deterministic and round-counted.**  Incident state advances only on
  :meth:`IncidentMonitor.advance_round`; nothing in here reads a wall clock
  or RNG.  Two monitors fed the same observations in the same round order
  hold byte-identical incident sets (``incidents_json``) and equal
  ``digest()`` values, whichever package each monitor comes from: the
  canonical JSON, ``round()`` and ``zlib.crc32`` are the reference's, so a
  port frontend and a reference frontend agree on the incident view.
* **Typed taxonomy.**  Every signal is one of :data:`TAXONOMY`.
* **Two-watermark lifecycle.**  Open → ack → resolve with hysteresis: a
  signal must hold for ``open_after`` consecutive rounds to open an
  incident, and an open incident resolves only after ``clear_after``
  consecutive quiet rounds.  A flapping signal therefore re-arms ONE
  incident instead of minting an open/resolve pair per flap.
* **Causal correlation.**  Signals sharing a host, doc, or trace id within
  ``correlation_window`` rounds collapse into ONE incident; its root-cause
  candidates are ordered largest delta first, ties broken to the earliest
  taxonomy entry.

Cross-host: an incident OPEN fires the attached
:class:`~.recorder.FlightRecorder` (one black-box dump per incident, not
per signal), and :func:`merge_flight_dumps` merges the per-host dump files
(host-attributed by their ``flight-<host>-<pid>-<n>-<reason>.jsonl``
names) into a single fleet timeline keyed by trace id.  A compact incident
summary also rides the replication frontier as the ``"\\x00incidents"``
NUL sentinel (:meth:`IncidentMonitor.wire_summary`): an int, so old peers'
``{actor: seq}`` frontier validation accepts-and-ignores it like every
other sentinel, while new peers record whether their peer's incident view
agrees with their own.

Off by default: nothing arms a monitor implicitly, arming one builds and
launches no kernel (pure-Python bookkeeping), and feeding it costs a few
dict walks per round.  ``observe_sentinel`` takes a
:class:`~.sentinel.RecompileSentinel` (or any object or dict with a
``total``) and ``observe_perf`` a :func:`~.ledger.evaluate` report (or
any mapping of that shape).
"""

from __future__ import annotations

import json
import re
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: The typed incident taxonomy, in FIXED order — the order IS the
#: root-cause tie-break (earlier entries win ties, mirroring the stage
#: order in :data:`~.latency.STAGES`): infrastructure death first, state
#: safety next, control-plane storms, then soft (SLO / perf) degradation.
TAXONOMY = (
    "host-death",
    "divergence",
    "quarantine-storm",
    "shed-storm",
    "slo-burn",
    "recompile-storm",
    "migration-failure",
    "perf-regression",
)

_TAXONOMY_INDEX = {kind: i for i, kind in enumerate(TAXONOMY)}

#: incident lifecycle states (open → ack → resolved; ack is operator-local
#: and excluded from the cross-host digest)
STATUSES = ("open", "ack", "resolved")


def _avalanche(x: int) -> int:
    """The anti-entropy digest's avalanche finisher — reused so incident
    digests and store digests share one mixing idiom."""
    x = (x * 2246822519) & 0xFFFFFFFF
    return x ^ (x >> 15)


def _snap(obj) -> Dict[str, Any]:
    """Feed-normalization: every ``observe_*`` accepts the live plane
    object or its already-scraped ``snapshot()`` dict, so the CLI can feed
    a monitor from files exactly as a process feeds it live objects."""
    if isinstance(obj, dict):
        return obj
    snap = getattr(obj, "snapshot", None)
    if callable(snap):
        return snap()
    raise TypeError(f"expected a dict or an object with snapshot(), got {type(obj).__name__}")


@dataclass
class _Candidate:
    """One signal source attached to an incident: the per-(kind, host, doc)
    accumulation the root-cause ordering ranks."""

    kind: str
    host: str
    doc: Optional[str] = None
    trace: Optional[int] = None
    value: float = 0.0          # max magnitude seen (the ordering delta)
    first_round: int = 0
    last_round: int = 0
    count: int = 0
    detail: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "host": self.host,
            "doc": self.doc,
            "trace": self.trace,
            "value": round(float(self.value), 6),
            "first_round": self.first_round,
            "last_round": self.last_round,
            "count": self.count,
            "detail": dict(sorted(self.detail.items())),
        }


class Incident:
    """One correlated incident: a set of signal sources sharing a
    (host, doc, trace) scope, with a two-watermark lifecycle."""

    def __init__(self, ident: str, opened_round: int) -> None:
        self.id = ident
        self.status = "open"
        self.opened_round = opened_round
        self.acked_round: Optional[int] = None
        self.resolved_round: Optional[int] = None
        self.last_signal_round = opened_round
        self.quiet = 0
        self.signals = 0
        self.dumped = False
        self._candidates: Dict[Tuple[str, str, Optional[str]], _Candidate] = {}

    # -- scope ---------------------------------------------------------------

    @property
    def hosts(self) -> List[str]:
        return sorted({c.host for c in self._candidates.values()})

    @property
    def docs(self) -> List[str]:
        return sorted({c.doc for c in self._candidates.values()
                       if c.doc is not None})

    @property
    def traces(self) -> List[int]:
        return sorted({c.trace for c in self._candidates.values()
                       if c.trace is not None})

    def keys(self) -> Iterable[Tuple[str, str, Optional[str]]]:
        return self._candidates.keys()

    # -- candidates ----------------------------------------------------------

    def attach(self, kind: str, host: str, doc: Optional[str],
               trace: Optional[int], value: float,
               detail: Dict[str, Any], rounds: int) -> None:
        key = (kind, host, doc)
        cand = self._candidates.get(key)
        if cand is None:
            cand = _Candidate(kind=kind, host=host, doc=doc, trace=trace,
                              first_round=rounds)
            self._candidates[key] = cand
        cand.value = max(cand.value, float(value))
        cand.last_round = rounds
        cand.count += 1
        if trace is not None:
            cand.trace = trace
        if detail:
            cand.detail.update(detail)
        self.signals += 1
        self.last_signal_round = rounds

    def candidates(self) -> List[_Candidate]:
        """Root-cause ordering: largest delta wins, ties break to the
        EARLIEST taxonomy entry (strict ``>`` while walking taxonomy order
        keeps the first)."""
        ordered = sorted(
            self._candidates.values(),
            key=lambda c: (_TAXONOMY_INDEX[c.kind], c.host, c.doc or ""),
        )
        best: Optional[_Candidate] = None
        best_val = 0.0
        for cand in ordered:
            if best is None or cand.value > best_val:
                best, best_val = cand, cand.value
        rest = [c for c in ordered if c is not best]
        rest.sort(key=lambda c: (-c.value, _TAXONOMY_INDEX[c.kind],
                                 c.host, c.doc or ""))
        return ([best] if best is not None else []) + rest

    @property
    def kind(self) -> str:
        """The incident's primary classification: its root cause's kind."""
        cands = self.candidates()
        return cands[0].kind if cands else "unknown"

    # -- lifecycle -----------------------------------------------------------

    @property
    def resolved(self) -> bool:
        return self.status == "resolved"

    def ack(self, rounds: int) -> bool:
        if self.status != "open":
            return False
        self.status = "ack"
        self.acked_round = rounds
        return True

    def resolve(self, rounds: int) -> None:
        self.status = "resolved"
        self.resolved_round = rounds

    # -- readout -------------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "kind": self.kind,
            "status": self.status,
            "hosts": self.hosts,
            "docs": self.docs,
            "traces": self.traces,
            "opened_round": self.opened_round,
            "acked_round": self.acked_round,
            "resolved_round": self.resolved_round,
            "last_signal_round": self.last_signal_round,
            "signals": self.signals,
            "candidates": [c.to_json() for c in self.candidates()],
        }


class IncidentMonitor:
    """Deterministic incident fold over the existing planes' snapshots.

    Feed it each monitoring round — any subset of ``observe_*`` calls, then
    ONE :meth:`advance_round` — and read incidents back through
    :meth:`snapshot` (the ``/incidents.json`` body), :meth:`open_incidents`
    or :meth:`incidents_json`.  All thresholds are per-monitor constructor
    state, so two monitors configured alike and fed alike agree exactly.

    ``open_after`` / ``clear_after`` are the two watermarks: consecutive
    active rounds to open, consecutive quiet rounds to resolve.
    ``correlation_window`` bounds how stale an open incident's last signal
    may be while still absorbing a new correlated signal.  ``recorder``
    (optional) gets ONE :meth:`~.recorder.FlightRecorder.fault` per
    incident open — the black-box dump for the post-mortem.
    """

    def __init__(
        self,
        host: str = "local",
        open_after: int = 1,
        clear_after: int = 2,
        correlation_window: int = 4,
        burn_threshold: float = 1.0,
        compile_storm_threshold: int = 3,
        recorder=None,
        counters=None,
    ) -> None:
        if open_after < 1:
            raise ValueError(f"open_after must be >= 1, got {open_after}")
        if clear_after < 1:
            raise ValueError(f"clear_after must be >= 1, got {clear_after}")
        self.host = host
        self.open_after = int(open_after)
        self.clear_after = int(clear_after)
        self.correlation_window = int(correlation_window)
        self.burn_threshold = float(burn_threshold)
        self.compile_storm_threshold = int(compile_storm_threshold)
        self.recorder = recorder
        self.counters = counters
        self.rounds = 0
        self._seq = 0
        self._incidents: List[Incident] = []
        #: (kind, host, doc) -> signals raised THIS round, folded at
        #: advance_round; value/detail keep the largest magnitude seen
        self._raised: Dict[Tuple[str, str, Optional[str]], Dict[str, Any]] = {}
        #: consecutive-active-round streaks per signal key (high watermark)
        self._streaks: Dict[Tuple[str, str, Optional[str]], int] = {}
        #: per-feed cumulative marks for delta detection (rollbacks,
        #: divergence incidents, compiles, migration rollbacks)
        self._marks: Dict[str, int] = {}
        #: hosts whose dead verdict already produced its edge signal — a
        #: latched-dead lease must not re-open a resolved incident forever
        self._dead_seen: set = set()
        #: peer -> parsed wire summary from the frontier sentinel
        self.peer_views: Dict[str, Dict[str, int]] = {}

    # -- raw signal ingestion ------------------------------------------------

    def raise_signal(self, kind: str, host: Optional[str] = None,
                     doc: Optional[str] = None, trace: Optional[int] = None,
                     value: float = 1.0, **detail: Any) -> None:
        """Raise one typed signal for the CURRENT round.  ``value`` is the
        signal's magnitude — the delta the root-cause ordering ranks.
        Re-raising a (kind, host, doc) key within a round keeps the larger
        magnitude; the round's verdicts land at :meth:`advance_round`."""
        if kind not in _TAXONOMY_INDEX:
            raise ValueError(f"unknown incident kind {kind!r}; "
                             f"taxonomy: {', '.join(TAXONOMY)}")
        key = (kind, host or self.host, doc)
        prev = self._raised.get(key)
        if prev is None or float(value) > prev["value"]:
            self._raised[key] = {"value": float(value), "trace": trace,
                                 "detail": dict(detail)}
        elif detail:
            prev["detail"].update(detail)

    # -- typed feeds ---------------------------------------------------------

    def observe_leases(self, ledger) -> None:
        """HeartbeatLedger feed: a ``dead`` verdict is a host-death signal.
        The ledger latches dead, so the signal persists until the host is
        reset (re-admitted) — resolution IS re-admission here."""
        snap = _snap(ledger)
        for name, lease in sorted(snap.get("leases", {}).items()):
            if lease.get("verdict") == "dead":
                self.raise_signal(
                    "host-death", host=name,
                    value=float(lease.get("missed", 1)),
                    dead_at_round=lease.get("dead_at_round"),
                )

    def observe_fleet(self, fleet) -> None:
        """FleetFrontend feed: host-death on the dead-verdict EDGE (and for
        as long as the dead host still owns serving docs or docs sit
        failed), so the incident resolves once failover re-homes everything
        — post-heal, not post-reset; plus migration-failure on
        migration-rollback deltas or failed docs."""
        snap = _snap(fleet)
        leases = snap.get("leases", {}).get("leases", {})
        serving = snap.get("serving", {})
        failed = list(snap.get("failed_docs", ()))
        stranded: Dict[str, int] = {}
        for _doc, owner in serving.items():
            stranded[owner] = stranded.get(owner, 0) + 1
        for name, lease in sorted(leases.items()):
            if lease.get("verdict") != "dead":
                self._dead_seen.discard(name)
                continue
            owned = stranded.get(name, 0)
            if name not in self._dead_seen:
                self._dead_seen.add(name)
            elif owned == 0 and not failed:
                continue  # healed: docs re-homed, nothing failed
            self.raise_signal(
                "host-death", host=name,
                value=float(max(owned, 1)),
                stranded_docs=owned,
                dead_at_round=lease.get("dead_at_round"),
            )
        rollbacks = int(snap.get("migration_rollbacks", 0))
        delta = rollbacks - self._marks.get("migration_rollbacks", 0)
        self._marks["migration_rollbacks"] = rollbacks
        if delta > 0 or failed:
            self.raise_signal(
                "migration-failure", host=self.host,
                value=float(delta + len(failed)),
                rollbacks=delta, failed_docs=failed,
            )

    def observe_convergence(self, monitor) -> None:
        """ConvergenceMonitor feed: NEW divergence incidents (count delta)
        raise a divergence signal per divergent peer.  Delta-triggered, so
        a healed replica that stops probing divergent lets the incident
        resolve even though the convergence monitor's per-peer divergent
        flag stays latched — the latch is its evidence, not ours."""
        snap = _snap(monitor)
        total = int(snap.get("divergence_incidents", 0))
        delta = total - self._marks.get("divergence_incidents", 0)
        self._marks["divergence_incidents"] = total
        if delta <= 0:
            return
        peers = snap.get("divergent_peers") or [self.host]
        for peer in sorted(peers):
            self.raise_signal("divergence", host=peer, value=float(delta),
                              divergence_incidents=total)

    def observe_serve(self, mux) -> None:
        """SessionMux feed: engaged backpressure or sheds since the last
        clean flush raise a shed-storm signal.  ``recent_sheds`` clears on
        the mux's next committed clean round, so redelivery completing IS
        the heal."""
        snap = _snap(mux)
        sheds = int(snap.get("recent_sheds", 0))
        overloaded = bool(snap.get("overloaded", False))
        if sheds > 0 or overloaded:
            self.raise_signal(
                "shed-storm", host=str(snap.get("host", self.host)),
                value=float(max(sheds, 1)),
                recent_sheds=sheds, overloaded=overloaded,
            )

    def observe_latency(self, plane) -> None:
        """LatencyPlane feed: an SLO burn rate above ``burn_threshold``
        (default 1.0 — burning budget faster than it accrues) is an
        slo-burn signal whose magnitude is the burn rate itself."""
        snap = _snap(plane)
        slo = snap.get("slo", {}) or {}
        burn = float(slo.get("burn_rate", 0.0) or 0.0)
        if burn > self.burn_threshold:
            self.raise_signal("slo-burn", host=self.host, value=burn,
                              burn_rate=burn, breaches=slo.get("breaches"))

    def observe_sentinel(self, sentinel) -> None:
        """Build-sentinel feed (any object with a ``total``, or a dict):
        ``compile_storm_threshold`` or more new builds since the previous
        observation is a recompile-storm — a steady-state serving loop
        should build NOTHING per round."""
        if isinstance(sentinel, dict):
            total = int(sentinel.get("total", 0))
        else:
            total = int(getattr(sentinel, "total", 0))
        delta = total - self._marks.get("compiles", 0)
        self._marks["compiles"] = total
        if delta >= self.compile_storm_threshold:
            self.raise_signal("recompile-storm", host=self.host,
                              value=float(delta), new_compiles=delta)

    def observe_supervisor(self, supervisor) -> None:
        """GuardedSession / session ``health()`` feed: NEW rollbacks or
        NEWLY quarantined docs (both count deltas) raise quarantine-storm.
        Delta-triggered on purpose: the quarantine registry latches — a
        recovered session keeps benign demotion records as evidence — so
        absolute presence would hold the incident open forever; the latch
        is the session's evidence, not ours, and quiet rounds after the
        last new rollback/quarantine ARE the heal."""
        if isinstance(supervisor, dict):
            health = supervisor
        else:
            fn = getattr(supervisor, "health", None)
            if not callable(fn):
                raise TypeError("observe_supervisor wants a health() object or dict")
            health = fn()
        rollbacks = int(health.get("rollbacks", 0))
        delta = rollbacks - self._marks.get("rollbacks", 0)
        self._marks["rollbacks"] = rollbacks
        quarantined = health.get("quarantined") or {}
        qdelta = len(quarantined) - self._marks.get("quarantined", 0)
        self._marks["quarantined"] = len(quarantined)
        if delta > 0 or qdelta > 0:
            self.raise_signal(
                "quarantine-storm", host=self.host,
                value=float(max(delta, 0) + max(qdelta, 0)),
                rollbacks=delta,
                quarantined_docs=sorted(str(d) for d in quarantined),
            )

    def observe_perf(self, report) -> None:
        """Perf-report feed (a mapping with ``regressed`` and ``rows`` of
        ``status`` / ``name`` / ``delta_pct``): a regressed gate raises a
        perf-regression signal whose magnitude is the worst regression's
        percentage delta."""
        rep = dict(report)
        if not rep.get("regressed"):
            return
        worst = 0.0
        names: List[str] = []
        for row in rep.get("rows", ()):
            if row.get("status") in ("regressed", "failed", "missing"):
                names.append(str(row.get("name")))
                pct = row.get("delta_pct")
                if pct is not None:
                    worst = max(worst, abs(float(pct)))
        self.raise_signal("perf-regression", host=self.host,
                          value=worst or 1.0, rows=sorted(names))

    def observe_timeseries(self, plane) -> None:
        """TimeSeriesPlane feed (the ninth signal source): every anomaly
        active as of the plane's latest frame raises a signal on the
        EXISTING kind its gauge-key prefix maps to (``anomaly_kind`` —
        ``serve.*`` -> shed-storm, ``fleet.*`` -> host-death, ...), never
        a new latch.  The signal's magnitude is the robust z-score, so a
        correlated incident's root-cause ordering ranks the anomaly
        against the primary plane's own evidence."""
        snap = _snap(plane)
        anomaly = snap.get("anomaly") or {}
        for finding in anomaly.get("active") or ():
            kind = str(finding.get("kind") or "perf-regression")
            if kind not in _TAXONOMY_INDEX:
                kind = "perf-regression"
            self.raise_signal(
                kind, host=str(snap.get("host", self.host)),
                value=float(finding.get("z", 1.0) or 1.0),
                anomaly=True, anomaly_key=str(finding.get("key")),
                anomaly_round=int(finding.get("round", 0) or 0),
            )

    # -- lifecycle fold ------------------------------------------------------

    def advance_round(self) -> List[Incident]:
        """Fold the round's raised signals into incident state: bump
        streaks, open / correlate at the high watermark, resolve at the low
        one.  Returns incidents OPENED this round (the dump trigger)."""
        self.rounds += 1
        raised, self._raised = self._raised, {}
        for key in list(self._streaks):
            if key not in raised:
                del self._streaks[key]
        opened: List[Incident] = []
        for key in sorted(
            raised,
            key=lambda k: (_TAXONOMY_INDEX[k[0]], k[1], k[2] or ""),
        ):
            self._streaks[key] = self._streaks.get(key, 0) + 1
            if self._streaks[key] < self.open_after:
                continue
            kind, host, doc = key
            sig = raised[key]
            inc = self._correlate(host, doc, sig["trace"], key)
            if inc is None:
                self._seq += 1
                inc = Incident(f"INC-{self._seq:04d}", self.rounds)
                self._incidents.append(inc)
                opened.append(inc)
            inc.attach(kind, host, doc, sig["trace"], sig["value"],
                       sig["detail"], self.rounds)
        # the low watermark counts ANY re-fire of an incident's keys as
        # activity — even sub-threshold flaps — so a flapping signal
        # re-arms the open incident instead of letting it resolve and then
        # minting a fresh one (the latch between the two watermarks)
        active_keys = set(raised)
        for inc in self._incidents:
            if inc.resolved:
                continue
            if any(k in active_keys for k in inc.keys()):
                inc.quiet = 0
            else:
                inc.quiet += 1
                if inc.quiet >= self.clear_after:
                    inc.resolve(self.rounds)
        if self.counters is not None:
            for inc in opened:
                self.counters.add("incident.opened")
        for inc in opened:
            self._dump(inc)
        return opened

    def _correlate(self, host: str, doc: Optional[str],
                   trace: Optional[int], key) -> Optional[Incident]:
        """The collapse rule: the EARLIEST-opened unresolved incident whose
        last signal is within the correlation window and which shares the
        signal's host, doc, trace, or exact key."""
        for inc in self._incidents:
            if inc.resolved:
                continue
            if self.rounds - inc.last_signal_round > self.correlation_window:
                continue
            if (key in inc.keys()
                    or host in inc.hosts
                    or (doc is not None and doc in inc.docs)
                    or (trace is not None and trace in inc.traces)):
                return inc
        return None

    def _dump(self, inc: Incident) -> None:
        if self.recorder is None or inc.dumped:
            return
        inc.dumped = True
        try:
            self.recorder.fault(
                f"incident-{inc.kind}", incident=inc.id,
                hosts=",".join(inc.hosts), opened_round=inc.opened_round,
            )
        except Exception:  # graftlint: boundary(a failed dump must not lose the incident that triggered it)
            pass

    def ack(self, ident: str) -> bool:
        """Operator acknowledgement: open → ack.  Local-only state — the
        cross-host digest folds ack back into open so two frontends with
        different operators still agree on the incident view."""
        for inc in self._incidents:
            if inc.id == ident:
                return inc.ack(self.rounds)
        return False

    # -- readout -------------------------------------------------------------

    def incidents(self) -> List[Incident]:
        return list(self._incidents)

    def open_incidents(self) -> List[Incident]:
        return [inc for inc in self._incidents if not inc.resolved]

    def incident_kinds(self) -> List[str]:
        """The DISTINCT primary kinds ever opened — the chaos oracles'
        exact-set assertion surface."""
        return sorted({inc.kind for inc in self._incidents})

    def time_to_detection(self, kind: str,
                          fault_round: int) -> Optional[int]:
        """Monitor rounds from ``fault_round`` to the first open of an
        incident whose primary kind is ``kind`` (None if never opened)."""
        for inc in self._incidents:
            if inc.kind == kind and inc.opened_round >= fault_round:
                return inc.opened_round - fault_round
        return None

    def incidents_json(self) -> str:
        """Canonical JSON of the full incident list — the two-monitor
        determinism contract compares THESE bytes."""
        return json.dumps([inc.to_json() for inc in self._incidents],
                          sort_keys=True, separators=(",", ":"))

    def digest(self) -> int:
        """Order-sensitive 32-bit digest of the observation-derived
        incident view.  Ack state is normalized back to open (operator
        acks are local), so two frontends fed the same observations match
        even when only one operator acked."""
        rows = []
        for inc in self._incidents:
            row = inc.to_json()
            row.pop("acked_round", None)
            if row["status"] == "ack":
                row["status"] = "open"
            rows.append(row)
        blob = json.dumps(rows, sort_keys=True, separators=(",", ":"))
        return _avalanche(zlib.crc32(blob.encode("utf-8")) & 0xFFFFFFFF)

    def wire_summary(self) -> int:
        """The frontier-sentinel payload: ``(open_count << 32) | digest``,
        one int so old peers' ``{actor: seq}`` validation accepts it."""
        return (len(self.open_incidents()) << 32) | self.digest()

    @staticmethod
    def parse_wire_summary(value: int) -> Dict[str, int]:
        return {"open": int(value) >> 32, "digest": int(value) & 0xFFFFFFFF}

    def observe_peer_summary(self, peer: str, value: int) -> None:
        """Record a peer's frontier-carried incident summary; ``snapshot``
        reports per-peer agreement (same digest = same incident view)."""
        self.peer_views[str(peer)] = self.parse_wire_summary(value)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/incidents.json`` body (golden-shape test pins these
        keys): lifecycle tallies, per-kind open counts over the FULL
        taxonomy, the incident list, and the cross-host agreement view."""
        open_incs = self.open_incidents()
        by_kind = {kind: 0 for kind in TAXONOMY}
        for inc in open_incs:
            by_kind[inc.kind] += 1
        digest = self.digest()
        return {
            "host": self.host,
            "rounds": self.rounds,
            "open": len(open_incs),
            "acked": sum(1 for i in open_incs if i.status == "ack"),
            "resolved": sum(1 for i in self._incidents if i.resolved),
            "total": len(self._incidents),
            "by_kind": by_kind,
            "digest": digest,
            "open_after": self.open_after,
            "clear_after": self.clear_after,
            "correlation_window": self.correlation_window,
            "peers": {
                peer: {**view, "agree": view["digest"] == digest}
                for peer, view in sorted(self.peer_views.items())
            },
            "incidents": [inc.to_json() for inc in self._incidents],
        }


# -- merged black-box timeline ------------------------------------------------

#: ``flight-<host>-<pid>-<n>-<reason>.jsonl`` (current) — the pid/counter
#: pair is numeric, which is how the parser tells the host-bearing spelling
#: from the legacy ``flight-<pid>-<n>-<reason>`` one
_DUMP_NAME = re.compile(
    r"^flight-(?:(?P<host>.+?)-)?(?P<pid>\d+)-(?P<n>\d+)-(?P<reason>.+)\.jsonl$"
)


def _dump_host(name: str) -> Optional[str]:
    m = _DUMP_NAME.match(name)
    return m.group("host") if m else None


def merge_flight_dumps(paths: Iterable[str | Path]) -> Dict[str, Any]:
    """Merge per-host flight-recorder dump files into ONE fleet timeline.

    Each record is host-attributed from its dump's filename (the
    ``flight-<host>-...`` spelling; legacy host-less dumps attribute as
    ``"?"``), the merged timeline is ordered by ``(ts, host, seq)``, and
    records carrying a trace id are additionally grouped per trace — the
    cross-host causal chains the wire's trace-context sentinels stitched.
    Successive dumps from one recorder overlap (each carries the whole
    ring), so records are deduplicated by ``(host, pid, seq)`` — the seq
    counter is per-recorder-monotonic, making the triple a stable record
    identity across dumps.  Unreadable files and unparsable lines are
    counted, not fatal: a post-mortem merges what survived the crash.
    """
    timeline: List[Dict[str, Any]] = []
    dumps: List[Dict[str, Any]] = []
    seen: set = set()
    skipped = 0
    for path in sorted(Path(p) for p in paths):
        host = _dump_host(path.name) or "?"
        m = _DUMP_NAME.match(path.name)
        pid = m.group("pid") if m else path.name
        try:
            lines = path.read_text().splitlines()
        except OSError:
            skipped += 1
            continue
        header: Dict[str, Any] = {}
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(rec, dict):
                skipped += 1
                continue
            if rec.get("kind") == "dump" and not header:
                header = rec
                dumps.append({"file": path.name, "host": host,
                              "reason": rec.get("reason"),
                              "records": rec.get("records")})
                continue
            seq = rec.get("seq")
            if seq is not None:
                key = (host, pid, int(seq))
                if key in seen:
                    continue
                seen.add(key)
            timeline.append({"host": host, "file": path.name, **rec})
    timeline.sort(key=lambda r: (float(r.get("ts", 0.0) or 0.0),
                                 r.get("host", ""),
                                 int(r.get("seq", 0) or 0)))
    traces: Dict[str, List[Dict[str, Any]]] = {}
    for rec in timeline:
        trace = rec.get("trace_id")
        if trace is None:
            continue
        traces.setdefault(str(trace), []).append(rec)
    return {
        "hosts": sorted({r["host"] for r in timeline} | {d["host"] for d in dumps}),
        "dumps": dumps,
        "records": len(timeline),
        "skipped": skipped,
        "timeline": timeline,
        "traces": traces,
    }
