"""Cross-tenant fused serving: many muxes, one drain per lane per window.

A host serving N tenants as N standalone :class:`~.mux.SessionMux`
instances pays N drains per batching window — N sets of round launches,
N host round trips.  :class:`FusedMuxGroup` closes that gap: a
:class:`~..plan.fusion.FusionGroup` assigns every tenant a disjoint
doc-row range of a shared device lane (one
:class:`~..parallel.streaming.StreamingMerge` per storage layout —
``static_rounds`` for padded lanes, paged and ragged lanes as they are),
each tenant keeps its OWN :class:`SessionMux` — own
:class:`~.admission.AdmissionController`, own verdict accounting, own
patch stream — and the group recomposes the mux's split round pump
(``_take_batch`` / ``_ingest_batch`` / ``_settle_batch``) around ONE
``drain()`` per touched lane per window.  A padded or paged lane commits
each drain batch as one fused form (on the card one CUDA-graph replay
once its signature repeats), launching the insert kernel once per round
(padded) or per (round, page group) (paged); a ragged lane once per round
and doc class; however many tenants rode it.

Isolation is structural, not filtered: tenants never share doc rows, so
a tenant's patches/digests are computed from rows no other tenant can
write, and admission verdicts come from per-tenant controllers that
never see another tenant's load.  Byte equality with the unfused path
holds per tenant by construction (documents are independent CRDTs).

The WINDOW is owned here: the group's :class:`~.mux.BatchWindowTuner`
times the shared round, any member's backpressure force-closes the
window for everyone (a queue above its high watermark must drain NOW),
and ``FusionGroup.window_rows`` decides whether the drain ships the
multi-tenant offset-plane form (few active tenants: the session's
``fusion_rows`` stage only their blocks, the ``stacked_multi`` form) or
full-lane staging (every tenant active: strictly cheaper).  All
wall-clock reads of the fused tier happen here; :mod:`~..plan.fusion`
stays clock-free.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import Counters, GLOBAL_COUNTERS
from ..obs.latency import CLOSE_BACKPRESSURE, CLOSE_FLUSH, CLOSE_WINDOW
from ..obs.timeseries import GLOBAL_HISTORY
from ..parallel.streaming import StreamingMerge
from ..plan.fusion import FusionGroup, LanePlan, TenantSpec
from .admission import AdmissionController, Verdict
from .mux import BatchWindowTuner, SessionMux


def default_lane_factory(actors: Sequence[str],
                         **session_kw) -> Callable[[LanePlan], StreamingMerge]:
    """A ``session_factory`` for :class:`FusedMuxGroup`: one
    :class:`StreamingMerge` per lane, sized to the lane's doc budget,
    storage layout taken from the lane plan.  Padded lanes are
    ``static_rounds`` sessions (the reference's one-shape serving
    discipline); paged/ragged lanes (whose storage tier forbids
    ``static_rounds``) keep ``fused_pipeline`` on.  ``session_kw`` reaches
    every lane session: ``device=`` among it (default ``cuda``)."""

    def build(plan: LanePlan) -> StreamingMerge:
        sess = StreamingMerge(
            num_docs=plan.docs, actors=actors,
            static_rounds=(plan.layout == "padded"),
            layout=plan.layout, **session_kw,
        )
        sess.fused_pipeline = True
        return sess

    return build


class FusedMuxGroup:
    """N tenants' serving muxes fused onto shared device lanes.

    ``tenants`` are :class:`~..plan.fusion.TenantSpec`s;
    ``session_factory`` builds one backing session per
    :class:`~..plan.fusion.LanePlan` (see :func:`default_lane_factory`).
    Each tenant's mux is reachable via :meth:`mux` and behaves exactly
    like a standalone one for submit/patches/verdicts — only
    :meth:`pump` timing is shared.  When the lane sessions run on a mesh,
    pass ``shard_rows`` (the lane's rows-per-shard) so tenant row ranges
    never straddle a shard mid-boundary.
    """

    def __init__(
        self,
        tenants: Sequence[TenantSpec],
        session_factory: Callable[[LanePlan], StreamingMerge],
        *,
        lane_capacity: int = 4096,
        shard_rows: Optional[int] = None,
        admission_factory: Optional[Callable[[], AdmissionController]] = None,
        tuner: Optional[BatchWindowTuner] = None,
        degrade_after: int = 8,
        clock: Callable[[], float] = time.monotonic,
        counters: Optional[Counters] = None,
        host: str = "local",
    ) -> None:
        self.group = FusionGroup(tenants, lane_capacity=lane_capacity,
                                 shard_rows=shard_rows)
        self.clock = clock
        self.host = host
        self.counters = counters if counters is not None else GLOBAL_COUNTERS
        #: the SHARED round-open window: one tuner over the fused rounds
        #: (a member's private tuner still tracks its own settle walls)
        self.tuner = tuner if tuner is not None else BatchWindowTuner()
        self._lane_sessions: List[StreamingMerge] = []
        for plan in self.group.lanes:
            sess = session_factory(plan)
            if sess.num_docs < plan.docs:
                raise ValueError(
                    f"lane {plan.lane} session has {sess.num_docs} docs, "
                    f"plan needs {plan.docs}"
                )
            static = getattr(sess, "static_rounds", False)
            fused = getattr(sess, "fused_pipeline", False)
            if plan.layout == "padded" and not static:
                raise ValueError(
                    f"lane {plan.lane} session must be static_rounds: the "
                    "multi-tenant staged form is a one-shape discipline"
                )
            if not (static or fused):
                raise ValueError(
                    f"lane {plan.lane} session must run the fused pipeline: "
                    "a per-round-dispatch lane pays back the dispatch floor "
                    "fusion exists to amortize"
                )

            self._lane_sessions.append(sess)
        self.muxes: Dict[str, SessionMux] = {}
        for name in sorted(self.group.slots):
            slot = self.group.slots[name]
            mux = SessionMux(
                self._lane_sessions[slot.lane],
                admission=(admission_factory() if admission_factory
                           else AdmissionController()),
                tuner=BatchWindowTuner(),
                degrade_after=degrade_after,
                clock=clock,
                counters=self.counters,
                host=f"{host}/{name}",
                doc_base=slot.doc_base,
                doc_capacity=slot.docs,
            )
            mux._fusion_stats = self.fusion_snapshot
            self.muxes[name] = mux
        #: deterministic pump order — sorted tenant names, never arrival
        self._order: Tuple[str, ...] = tuple(sorted(self.muxes))
        self.windows = 0
        self.dispatches = 0
        self._docs_dispatched = 0
        self._occ_sum = 0.0
        self._occ_count = 0
        #: the history plane's occupancy channel (swap in a private plane
        #: the way tests swap ``latency_plane``); disarmed it costs one
        #: attribute read per lane per window
        self.history = GLOBAL_HISTORY

    # -- per-tenant delegation --------------------------------------------

    def mux(self, tenant: str) -> SessionMux:
        m = self.muxes.get(tenant)
        if m is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        return m

    def open_session(self, tenant: str, client: str,
                     token: Optional[str] = None):
        return self.mux(tenant).open_session(client, token=token)

    def submit(self, tenant: str, session_id: int, frame: bytes,
               token: Optional[str] = None) -> Verdict:
        return self.mux(tenant).submit(session_id, frame, token=token)

    def submit_changes(self, tenant: str, session_id: int, changes,
                       token: Optional[str] = None) -> Verdict:
        return self.mux(tenant).submit_changes(session_id, changes,
                                               token=token)

    def patches(self, tenant: str, session_id: int):
        return self.mux(tenant).patches(session_id)

    def read(self, tenant: str, session_id: int):
        return self.mux(tenant).read(session_id)

    # -- the fused round pump ---------------------------------------------

    def window_seconds(self) -> float:
        return self.tuner.window_seconds()

    def window_expired(self) -> bool:
        """Whether the SHARED window should close: measured from the
        earliest member's open mark (first arrival anywhere opens the
        group window), force-closed by any member's backpressure."""
        opened = None
        for name in self._order:
            m = self.muxes[name]
            if not m._buffer:
                continue
            if m.admission.backpressure:
                return True
            if m._window_opened is not None and (
                    opened is None or m._window_opened < opened):
                opened = m._window_opened
        if opened is None:
            return False
        return (self.clock() - opened) >= self.tuner.window_seconds()

    def pump(self, force: bool = False) -> int:
        """Close the shared window (if expired or ``force``) and commit
        every member's buffered round through ONE drain per touched
        lane: take all batches first (no member's ingest reopens another
        member's timing), ingest per lane under the lane's
        ``fusion_rows`` extents, drain once, then settle each member
        with the shared wall.  Returns total frames applied.
        ``dispatches`` advances by the lanes' ``streaming.fused_dispatches``
        delta (the reference's meaning: one per scheduled batch of a
        one-block padded lane)."""
        if not any(self.muxes[n]._buffer for n in self._order):
            return 0
        if not (force or self.window_expired()):
            return 0
        # the SHARED close cause (one window, one cause for every rider):
        # a forced flush, else any member's backpressure, else the window
        # elapsing — read before the drains release backpressure.  Only
        # consulted when some member's latency plane is armed.
        armed = any(self.muxes[n].latency_plane.enabled for n in self._order)
        cause = CLOSE_WINDOW
        if armed:
            if force:
                cause = CLOSE_FLUSH
            elif any(m.admission.backpressure
                     for m in self.muxes.values() if m._buffer):
                cause = CLOSE_BACKPRESSURE
        per_lane: Dict[int, List[Tuple[str, list]]] = {}
        for name in self._order:
            m = self.muxes[name]
            if m._buffer:
                lane = self.group.slots[name].lane
                per_lane.setdefault(lane, []).append((name, m._take_batch()))
        applied = 0
        t_open = self.clock()
        d0 = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
        for lane in sorted(per_lane):
            entries = per_lane[lane]
            sess = self._lane_sessions[lane]
            active = [name for name, _ in entries]
            t0 = self.clock()
            sess.fusion_rows = self.group.window_rows(lane, active)
            try:
                for name, batch in entries:
                    self.muxes[name]._ingest_batch(batch)
                t_staged = self.clock() if armed else None
                sess.drain()
            finally:
                sess.fusion_rows = None
            t1 = self.clock()
            wall = max(0.0, t1 - t0)
            for name, batch in entries:
                # each rider's stage watermarks are the LANE's: the close
                # is the lane round's open, staging/commit are shared —
                # a rider pays the fused window it rode, exactly like the
                # settle wall
                self.muxes[name]._settle_batch(
                    batch, wall, t1,
                    close=t0 if armed else None,
                    staged=t_staged, cause=cause,
                )
                applied += len(batch)
            docs = sum(self.group.slots[name].docs for name in active)
            self._docs_dispatched += docs
            occ = self.group.window_occupancy(lane, active)
            self._occ_sum += occ
            self._occ_count += 1
            if self.history.enabled:
                # the closed planner loop's raw material: one occupancy
                # row per lane per committed window
                self.history.record_occupancy(lane, occ, docs=docs)
        self.dispatches += int(
            GLOBAL_COUNTERS.get("streaming.fused_dispatches") - d0
        )
        self.windows += 1
        self.tuner.observe(max(0.0, self.clock() - t_open))
        self.counters.add("serve.fused_windows")
        return applied

    def flush(self) -> int:
        """Force-close the shared window (shutdown, test sync points,
        end-of-rung drains)."""
        return self.pump(force=True)

    # -- health ------------------------------------------------------------

    def fusion_snapshot(self) -> Dict:
        """The shared ``fusion`` section every member's ``/serve.json``
        reports (same key set as the standalone identity report)."""
        return {
            "grouped": True,
            "tenants": len(self.muxes),
            "lanes": len(self.group.lanes),
            "windows": self.windows,
            "dispatches": self.dispatches,
            "docs_per_dispatch": round(
                self._docs_dispatched / self.dispatches, 2
            ) if self.dispatches else 0.0,
            "window_occupancy": round(
                self._occ_sum / self._occ_count, 4
            ) if self._occ_count else 0.0,
        }

    def snapshot(self) -> Dict:
        """The group's own scrape body: the fusion stats, the lane plan,
        the shared window, and every member's full mux snapshot."""
        return {
            "host": self.host,
            "fusion": self.fusion_snapshot(),
            "plan": self.group.to_json(),
            "window": self.tuner.snapshot(),
            "tenants": {
                name: self.muxes[name].snapshot() for name in self._order
            },
        }
