"""Session multiplexing: many client sessions on one device pipeline.

A :class:`SessionMux` is the serving tier's front door for ONE host: it
maps client sessions onto the docs of a
:class:`~..parallel.streaming.StreamingMerge` (padded, paged or ragged),
runs admission control over a bounded ingest queue (:mod:`.admission`),
batches admitted frames into device rounds on an autotuned round-open
window, and hands each session back its incremental ``Patch`` stream —
the same ``Patch`` vocabulary the editor bridge speaks, so an editor
client cannot tell the mux from a direct session.

**The round-open window** is the latency/occupancy dial: the mux collects
arrivals for ``window`` seconds before closing a round, so a longer window
means fuller op streams at the cost of per-op latency.
:class:`BatchWindowTuner` picks it from the rolling round-latency
percentile the way the supervisor picks its watchdog deadline —
``clamp(margin * rolling_p99(round_seconds), floor, ceiling)`` — but
clamps to the FLOOR when empty (lowest latency is the safe direction for a
batching window; the deadline autotuner's empty-clamp is the ceiling, the
safe direction for a watchdog).  Dispatching rounds faster than the card
retires them only queues dispatches, so the window tracks what a round
actually costs: a low-rate tenant mix produces cheap rounds and the window
collapses to the floor (interactive latency), a saturating mix produces
expensive rounds and the window stretches toward the ceiling (batch
occupancy).

**Apply latency** is enqueue to the return of ``session.drain()``.  On
the card that return comes when the round's kernels are queued, not when
the card has run them; the first ``patches()``/``read()`` after it ends in
a copy from the card, which the latency plane's visibility stage prices.

**Degradation** integrates the session's quarantine/fallback ladder: on
a session on the CPU, a client whose quota sheds persist for
``degrade_after`` consecutive submissions is demoted via
``force_fallback`` (scalar replay — degraded but correct, off the device
round budget) and its writes keep flowing; shedding is a pressure
signal, never a silent write loss.  On any other device the sheds stay
backpressure and nothing is demoted: the demotion would move the card's
work to the host for a load reason (the supervisor's last rung follows
the same device rule).  A failing device round is the supervisor's
concern, never the mux's.

Every wall-clock read goes through the injected ``clock`` callable, so
tests drive the window deterministically.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.types import Change, Patch
from ..obs import Counters, GLOBAL_COUNTERS, GLOBAL_HISTOGRAMS, Histogram
from ..obs.latency import (
    CLOSE_BACKPRESSURE,
    CLOSE_FLUSH,
    CLOSE_WINDOW,
    GLOBAL_LATENCY,
)
from ..obs.timeseries import GLOBAL_HISTORY
from ..parallel.codec import encode_frame
from ..parallel.streaming import REASON_CAPACITY, StreamingMerge
from .admission import (
    ADMIT,
    AdmissionController,
    SHED,
    SHED_CAPACITY,
    SHED_SESSION_QUOTA,
    SHED_UNAUTHORIZED,
    SHED_UNKNOWN_SESSION,
    Verdict,
)


class BatchWindowTuner:
    """Round-open window from the rolling round-latency percentile.

    ``window_seconds() == clamp(margin * rolling_p{quantile}(round wall),
    floor, ceiling)``; empty clamps to ``floor`` (see module doc for why
    the empty direction inverts the supervisor's).  Observations come from
    the mux's own committed rounds (measured around ``session.drain()``),
    so the tuner adapts to THIS host's device and workload, not a global
    histogram another session may be feeding.
    """

    def __init__(
        self,
        floor: float = 0.002,
        ceiling: float = 0.25,
        margin: float = 1.0,
        quantile: float = 0.99,
        window: int = 64,
    ) -> None:
        if not 0 < floor <= ceiling:
            raise ValueError(
                f"need 0 < floor <= ceiling, got {floor}/{ceiling}"
            )
        self.floor = float(floor)
        self.ceiling = float(ceiling)
        self.margin = float(margin)
        self.quantile = float(quantile)
        #: rolling window of recent committed-round walls (private
        #: histogram: the tuner must see THIS mux's rounds only)
        self.round_seconds = Histogram(window=window)

    def observe(self, round_wall_seconds: float) -> None:
        self.round_seconds.observe(round_wall_seconds)

    def window_seconds(self) -> float:
        if self.round_seconds.count == 0:
            return self.floor
        tuned = self.margin * self.round_seconds.percentile(self.quantile)
        return float(min(self.ceiling, max(self.floor, tuned)))

    def snapshot(self) -> Dict:
        return {
            "seconds": round(self.window_seconds(), 6),
            "floor": self.floor,
            "ceiling": self.ceiling,
            "margin": self.margin,
            "quantile": self.quantile,
            "p99_round_seconds": round(
                self.round_seconds.percentile(self.quantile), 6
            ),
            "rounds_observed": self.round_seconds.count,
        }


@dataclass
class ClientSession:
    """One multiplexed client session: a stable id, its doc slot, and its
    verdict/degradation bookkeeping."""

    session_id: int
    client: str
    doc_index: int
    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    delayed: int = 0
    #: consecutive quota sheds — ``degrade_after`` of them demotes the doc
    #: of a session on the CPU
    quota_shed_streak: int = 0
    degraded: bool = False
    closed: bool = False
    extras: Dict = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "client": self.client,
            "doc": self.doc_index,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "delayed": self.delayed,
            "shed": self.shed,
            "degraded": self.degraded,
            "closed": self.closed,
        }


class SessionMux:
    """Multiplexes client sessions onto one streaming device pipeline.

    ``session`` is the backing :class:`StreamingMerge` (its ``num_docs`` is
    the slot budget, or ``doc_capacity`` rows from ``doc_base`` on a fused
    group's member); sessions claim doc slots append-only — a closed
    session's doc state stays resident (CRDT state is history, not a
    buffer), so slot reuse is a placement concern for the
    :class:`~..parallel.router.FleetRouter`, not the mux.  ``clock`` is
    monotonic seconds (injected for tests).  All submission paths return a
    typed :class:`~.admission.Verdict`; nothing is ever silently dropped.
    """

    def __init__(
        self,
        session: StreamingMerge,
        admission: Optional[AdmissionController] = None,
        tuner: Optional[BatchWindowTuner] = None,
        degrade_after: int = 8,
        clock: Callable[[], float] = time.monotonic,
        counters: Optional[Counters] = None,
        host: str = "local",
        auth=None,
        auth_per_frame: bool = False,
        doc_base: int = 0,
        doc_capacity: Optional[int] = None,
    ) -> None:
        self.session = session
        #: the doc-row slice of ``session`` this mux owns: a standalone mux
        #: owns the whole doc axis; a FusedMuxGroup member owns the
        #: disjoint ``[doc_base, doc_base + doc_capacity)`` range its
        #: LaneSlot assigned — isolation between fused tenants is this
        #: range discipline, never a runtime filter
        self.doc_base = int(doc_base)
        if not 0 <= self.doc_base <= session.num_docs:
            raise ValueError(
                f"doc_base {doc_base} outside session's {session.num_docs} docs"
            )
        self.doc_capacity = (
            int(doc_capacity) if doc_capacity is not None
            else session.num_docs - self.doc_base
        )
        if self.doc_base + self.doc_capacity > session.num_docs:
            raise ValueError(
                f"doc range [{self.doc_base}, "
                f"{self.doc_base + self.doc_capacity}) exceeds session's "
                f"{session.num_docs} docs"
            )
        self.admission = admission if admission is not None else AdmissionController()
        self.tuner = tuner if tuner is not None else BatchWindowTuner()
        #: per-session wire auth (serve/auth.SessionKeyring): when set,
        #: open_session requires a valid HMAC token for the client name —
        #: bad/missing tokens shed typed ``unauthorized`` BEFORE any slot
        #: or queue space is touched.  ``auth_per_frame`` additionally
        #: re-verifies the token on every submit (bearer-session-id alone
        #: stops being enough).  None (default) = open tier, exactly the
        #: pre-auth behavior.
        self.auth = auth
        self.auth_per_frame = bool(auth_per_frame)
        self.degrade_after = int(degrade_after)
        self.clock = clock
        self.counters = counters if counters is not None else GLOBAL_COUNTERS
        self.host = host
        self._sessions: Dict[int, ClientSession] = {}
        self._next_session = 0
        self._next_doc = 0
        #: the open round's buffered admitted frames:
        #: (session_id, doc, frame_bytes, enqueue_clock, submit_clock) —
        #: submit_clock is read at submit() ENTRY (pre-verdict) so the
        #: latency plane can price the admission stage; with the plane
        #: disarmed it equals enqueue_clock (no extra clock read)
        self._buffer: List[Tuple[int, int, bytes, float, float]] = []
        self._window_opened: Optional[float] = None
        self.rounds = 0
        self.applied = 0
        self.degraded_docs = 0
        #: when a list, per-frame apply latencies (enqueue -> committed
        #: round) are appended here — the traffic generator's per-rung
        #: percentile source (the histograms keep the process-wide view)
        self.latency_sink: Optional[List[float]] = None
        #: the stage-watermark latency plane this mux feeds (default: the
        #: process-wide one, off until ``GLOBAL_LATENCY.enable()``); traffic
        #: runs swap in a private plane so their decompositions don't mix
        self.latency_plane = GLOBAL_LATENCY
        #: the history plane this mux feeds one frame per committed round
        #: (same swap-in-a-private-plane discipline as ``latency_plane``);
        #: disarmed it costs one attribute read per settle
        self.history_plane = GLOBAL_HISTORY
        #: shed count at the last committed round — snapshot()'s
        #: ``recent_sheds`` (sheds since the tier last kept up) derives
        #: from it, so a host that shed once during a blip and then ran
        #: clean rounds stops reporting unhealthy (a health check reads
        #: recency, not the process-lifetime counter)
        self._shed_mark = 0
        #: a fused group member's shared ``fusion`` section (set by
        #: FusedMuxGroup); None on a standalone mux
        self._fusion_stats: Optional[Callable[[], Dict]] = None
        # wire the flight-recorder incident-context hook: a quarantine/
        # rollback fault dump on the backing session appends the affected
        # doc's admission-verdict tail (the backpressure picture around
        # the incident)
        recorder = getattr(session, "recorder", None)
        if recorder is not None and hasattr(recorder, "add_context_provider"):
            recorder.add_context_provider(
                "admission-verdicts", self._fault_context
            )

    # -- session lifecycle ----------------------------------------------------

    def open_session(self, client: str,
                     token: Optional[str] = None) -> Tuple[Optional[int], Verdict]:
        """Claim a doc slot for a new client session.  Returns
        ``(session_id, verdict)`` — ``session_id`` is None when the slot
        budget is exhausted (typed ``capacity`` shed; a fleet router's
        cue to place the doc on another host) or, on an auth-enabled mux,
        when ``token`` fails HMAC verification for ``client`` (typed
        ``unauthorized`` shed — checked FIRST, so an unauthorized probe
        never learns whether capacity exists)."""
        if self.auth is not None and not self.auth.verify(client, token):
            return None, self.admission.shed_out_of_band(SHED_UNAUTHORIZED)
        if self._next_doc >= self.doc_capacity:
            return None, self.admission.shed_out_of_band(SHED_CAPACITY)
        sid = self._next_session
        self._next_session += 1
        doc = self.doc_base + self._next_doc
        self._next_doc += 1
        self._sessions[sid] = ClientSession(
            session_id=sid, client=client, doc_index=doc,
        )
        self.counters.add("serve.sessions_opened")
        return sid, Verdict(kind=ADMIT, queue_depth=self.admission.depth)

    def close_session(self, session_id: int) -> None:
        sess = self._sessions.get(session_id)
        if sess is not None and not sess.closed:
            sess.closed = True
            self.counters.add("serve.sessions_closed")

    def sessions(self) -> Dict[int, ClientSession]:
        return dict(self._sessions)

    # -- the ingest surface ---------------------------------------------------

    def submit(self, session_id: int, frame: bytes,
               token: Optional[str] = None) -> Verdict:
        """Submit one wire frame for a session's doc.  ``admit`` buffers it
        into the open round; ``delay``/``shed`` buffer nothing and the
        client owns the retry.  A degraded session's frames are ingested
        IMMEDIATELY on admit (scalar fallback replays host-side; holding
        them for the device window would only add latency to a path that
        no longer batches).  On an ``auth_per_frame`` mux every submit
        must re-present the session's token (sheds ``unauthorized``
        otherwise)."""
        sess = self._sessions.get(session_id)
        if sess is None or sess.closed:
            return self.admission.shed_out_of_band(SHED_UNKNOWN_SESSION)
        if (self.auth is not None and self.auth_per_frame
                and not self.auth.verify(sess.client, token)):
            sess.submitted += 1
            sess.shed += 1
            return self.admission.shed_out_of_band(SHED_UNAUTHORIZED)
        # pre-verdict watermark for the latency plane's admit stage; the
        # disarmed path reads no extra clock (overhead budget)
        t_sub = self.clock() if self.latency_plane.enabled else None
        sess.submitted += 1
        verdict = self.admission.offer(
            session_id, cost=1, degraded=sess.degraded
        )
        if verdict.kind == ADMIT:
            sess.admitted += 1
            sess.quota_shed_streak = 0
            now = self.clock()
            if sess.degraded:
                self.session.ingest_frame(
                    sess.doc_index, frame, on_corrupt="quarantine"
                )
                self.admission.mark_applied(session_id, 1)
                self.applied += 1
            else:
                if self._window_opened is None:
                    self._window_opened = now
                self._buffer.append((
                    session_id, sess.doc_index, frame, now,
                    t_sub if t_sub is not None else now,
                ))
        elif verdict.kind == SHED:
            sess.shed += 1
            if verdict.reason == SHED_SESSION_QUOTA:
                sess.quota_shed_streak += 1
                if (not sess.degraded
                        and sess.quota_shed_streak >= self.degrade_after):
                    self._degrade(sess)
            else:
                sess.quota_shed_streak = 0
        else:
            sess.delayed += 1
        return verdict

    def submit_changes(self, session_id: int,
                       changes: Sequence[Change],
                       token: Optional[str] = None) -> Verdict:
        """The object-boundary form of :meth:`submit`: a batch of
        ``Change`` objects (what ``bridge.Editor.dispatch_input_ops``
        mints from ``InputOperation`` dicts) submitted as one frame."""
        return self.submit(session_id, encode_frame(list(changes)),
                           token=token)

    def _degrade(self, sess: ClientSession) -> None:
        """The quarantine/fallback rung for a hot session: sustained quota
        shedding means the doc's ingest outruns its fair device-round
        share, so it leaves the device path (scalar replay, correct but
        degraded) and its writes keep flowing — typed quarantine evidence
        included, never a silent drop.  Only on the CPU: on the card the
        doc stays on the device and its sheds stay backpressure; each shed
        past the threshold counts ``serve.degrade_refused_on_device``."""
        if self.session.device.type != "cpu":
            self.counters.add("serve.degrade_refused_on_device")
            return
        sess.degraded = True
        self.degraded_docs += 1
        self.counters.add("serve.degraded_sessions")
        self.session.force_fallback(
            sess.doc_index, REASON_CAPACITY,
            "serve: sustained session-quota shedding "
            f"({sess.quota_shed_streak} consecutive)",
        )

    # -- the round pump -------------------------------------------------------

    def window_seconds(self) -> float:
        return self.tuner.window_seconds()

    def window_expired(self) -> bool:
        """Whether the open round should close: its window elapsed, or
        backpressure engaged (a queue above the high watermark must drain
        NOW, not at the window's leisure)."""
        if not self._buffer:
            return False
        if self.admission.backpressure:
            return True
        assert self._window_opened is not None
        return (self.clock() - self._window_opened) >= self.window_seconds()

    def _take_batch(self) -> List[Tuple[int, int, bytes, float, float]]:
        """Close the open round: detach the buffered frames and reset the
        window.  The round pump's first third, split out so a fused group
        can take EVERY member's batch before any lane drains."""
        batch, self._buffer = self._buffer, []
        self._window_opened = None
        return batch

    def close_cause(self, force: bool) -> str:
        """Why the open round is closing — the typed vocabulary the
        latency plane's force-close counters report.  Read BEFORE the
        drain (the drain itself releases backpressure)."""
        if force:
            return CLOSE_FLUSH
        if self.admission.backpressure:
            return CLOSE_BACKPRESSURE
        return CLOSE_WINDOW

    def _ingest_batch(self, batch: Sequence[Tuple[int, int, bytes, float, float]]) -> None:
        """Bulk-ingest a taken batch into the backing session (corrupt
        frames quarantine their doc — per-doc fault isolation, never an
        exception out of the serving loop).  No drain: the caller owns
        when the device round runs."""
        self.session.ingest_frames(
            [(doc, frame) for _, doc, frame, _, _ in batch],
            on_corrupt="quarantine",
        )

    def _settle_batch(self, batch: Sequence[Tuple[int, int, bytes, float, float]],
                      wall: float, now: float,
                      close: Optional[float] = None,
                      staged: Optional[float] = None,
                      cause: str = CLOSE_WINDOW) -> None:
        """Account a committed batch after its drain: release queue
        space, feed the window tuner + latency histograms, advance the
        round/apply tallies.  ``wall`` is the committed round's wall (on
        a fused group: the SHARED window's wall — every rider pays the
        window it rode); ``now`` is the commit clock.  ``close``/``staged``
        are the latency plane's window-close and staged watermarks (passed
        only while the plane is armed); the batch record anchors on the
        FIRST buffered frame — the op that waited the whole window, the
        worst case an SLO cares about."""
        self.rounds += 1
        self.applied += len(batch)
        self.tuner.observe(wall)
        self.admission.observe_drain(len(batch), wall)
        for sid, _, _, enq, _ in batch:
            self.admission.mark_applied(sid, 1)
            lat = max(0.0, now - enq)
            GLOBAL_HISTOGRAMS.observe("serve.apply_seconds", lat)
            if self.latency_sink is not None:
                self.latency_sink.append(lat)
        GLOBAL_HISTOGRAMS.observe("serve.round_seconds", wall)
        self.counters.add("serve.rounds")
        self.counters.add("serve.applied_frames", len(batch))
        plane = self.latency_plane
        if (plane.enabled and batch
                and close is not None and staged is not None):
            _, _, _, enq0, sub0 = batch[0]
            mesh = getattr(self.session, "mesh", None)
            plane.observe_batch(
                submit=sub0, admit=enq0, close=close, staged=staged,
                commit=now,
                marks=getattr(self.session, "last_drain_marks", None),
                cause=cause, batch=len(batch),
                shards=int(getattr(mesh, "size", 1) or 1),
            )
        if not self.admission.backpressure:
            # the tier is keeping up again: sheds before this round are
            # history, not current health
            self._shed_mark = self.admission.stats.shed
        if self.history_plane.enabled:
            # one history frame per committed round (the plane's own
            # sample_every decimates); measured by the caller's wall via
            # note_overhead, never by the plane itself
            self.history_plane.advance_round(serve=self)

    def pump(self, force: bool = False) -> int:
        """Close the open round if its window expired (or ``force``) and
        drain it through the device: bulk-ingest the buffered frames, run
        device rounds to empty, release queue space, and feed the window
        tuner + latency histograms.  Returns the number of frames applied.
        The drain's return is the commit watermark: on the card the
        round's kernels are queued by then, not yet run.  (The
        take/ingest/settle thirds are split methods so
        :class:`~.fused.FusedMuxGroup` can recompose them around ONE
        shared lane drain.)"""
        if not self._buffer or not (force or self.window_expired()):
            return 0
        armed = self.latency_plane.enabled
        cause = self.close_cause(force) if armed else CLOSE_WINDOW
        batch = self._take_batch()
        t0 = self.clock()
        self._ingest_batch(batch)
        t_staged = self.clock() if armed else None
        self.session.drain()
        t1 = self.clock()
        self._settle_batch(batch, max(0.0, t1 - t0), t1,
                           close=t0 if armed else None,
                           staged=t_staged, cause=cause)
        return len(batch)

    def idle(self, budget_s: float) -> int:
        """The driver submits nothing for ``budget_s`` seconds: offer the
        session that time, cut to what is left of the open window, for its
        graph captures (``utils/graphs.py``), so a capture delays neither a
        submission nor a commit.  Returns the graphs captured."""
        if self._window_opened is not None:
            budget_s = min(budget_s, self.window_seconds() - (self.clock() - self._window_opened))
        return self.session.idle(budget_s) if budget_s > 0 else 0

    def flush(self) -> int:
        """Force-close the open round regardless of its window (shutdown,
        test sync points, the traffic generator's end-of-rung drain)."""
        return self.pump(force=True)

    def queue_depth(self) -> int:
        return self.admission.depth

    # -- the read surface -----------------------------------------------------

    def patches(self, session_id: int) -> List[Patch]:
        """The session's incremental ``Patch`` stream since its previous
        call (first call builds the doc from empty) — the same vocabulary
        the scalar path and the editor bridge emit.

        The first read also arms the session's digest prefetch: this
        client has PROVEN the pump→read pattern, so from the next pump on,
        every drain of a one-block session ends by queueing the block's
        resolve+digest on the card, where the window's host work hides it
        (a mux nobody reads from never pays the per-drain resolve).

        This is also the latency plane's VISIBILITY watermark: the first
        read after a commit is the moment a client could actually observe
        the committed round, so it finalizes every pending stage record."""
        sess = self._require(session_id)
        self.session.prefetch_digest = True
        out = self.session.read_patches(sess.doc_index)
        if self.latency_plane.enabled:
            self.latency_plane.mark_visible(self.clock())
        return out

    def read(self, session_id: int):
        """The session doc's resolved ``FormatSpan`` list.  Arms the
        digest prefetch like :meth:`patches` (the pump→read pattern is
        proven) and marks the latency plane's visibility watermark the
        same way."""
        sess = self._require(session_id)
        self.session.prefetch_digest = True
        out = self.session.read(sess.doc_index)
        if self.latency_plane.enabled:
            self.latency_plane.mark_visible(self.clock())
        return out

    def _require(self, session_id: int) -> ClientSession:
        sess = self._sessions.get(session_id)
        if sess is None:
            raise KeyError(f"unknown serve session {session_id}")
        return sess

    def _fault_context(self, fields: Dict) -> Optional[List[Dict]]:
        """Flight-recorder context provider: a quarantine/rollback fault
        names its ``doc``; answer with the owning session(s)' recent
        admission-verdict tail so the dump shows the backpressure picture
        around the incident."""
        doc = fields.get("doc")
        if doc is None:
            return None
        out: List[Dict] = []
        for sid, sess in self._sessions.items():
            if sess.doc_index != doc:
                continue
            for rec in self.admission.verdict_tail(sid):
                # the verdict's own ``kind`` rides as ``verdict``: the
                # recorder's context envelope owns the ``kind`` key
                body = {k: v for k, v in rec.items() if k != "kind"}
                out.append({"doc": doc, "session": sid,
                            "verdict": rec.get("kind"), **body})
        return out or None

    # -- health ---------------------------------------------------------------

    def load_report(self) -> Dict:
        """This host's load along a fleet router's placement dimensions:
        device slot load of on-device docs, host-bound (scalar-replay) load
        of fallback docs, and — on a paged or ragged session — the pool
        page load.  Rides inside :meth:`snapshot`."""
        sizes = self.session._reshard_sizes()
        slot_load = 0
        host_bound = 0
        for d in range(self.doc_base, self.doc_base + self._next_doc):
            size = int(sizes[d]) if d < len(sizes) else 0
            if self.session.docs[d].fallback:
                host_bound += size
            else:
                slot_load += size
        report = {
            "slot_load": slot_load,
            "host_bound_load": host_bound,
            "docs": self._next_doc,
        }
        pool = getattr(self.session, "store", None)
        if pool is not None:
            report["page_load"] = int(pool.pool_stats()["pages_in_use"])
        return report

    @property
    def overloaded(self) -> bool:
        """Sustained-overload flag: backpressure currently engaged, or the
        open buffer alone can't drain (queue at max)."""
        return self.admission.backpressure

    def fusion_snapshot(self) -> Dict:
        """The snapshot's ``fusion`` section: how many tenants share this
        mux's drains.  Standalone, the identity report — one tenant, one
        lane, one dispatch per committed round.  On a fused group member,
        the group's shared-window stats (injected via ``_fusion_stats``),
        so every tenant's snapshot shows the amortization it got."""
        if self._fusion_stats is not None:
            return self._fusion_stats()
        return {
            "grouped": False,
            "tenants": 1,
            "lanes": 1,
            "windows": self.rounds,
            "dispatches": self.rounds,
            "docs_per_dispatch": float(self._next_doc),
            "window_occupancy": round(
                self._next_doc / self.doc_capacity, 4
            ) if self.doc_capacity else 0.0,
        }

    def snapshot(self) -> Dict:
        """The serve health body (``health_snapshot(serve=mux)``): session
        table, bounded-queue state + typed verdict accounting,
        autotuned window state, and the round/apply tallies."""
        open_sessions = [s for s in self._sessions.values() if not s.closed]
        snap = {
            "host": self.host,
            # the backing session's storage layout: a fleet scrape must be
            # able to tell paged/ragged serving hosts (page-pool gauges
            # live) from padded ones without a second endpoint
            "layout": getattr(self.session, "layout", "padded"),
            # whether drains may end with the digest prefetch — False only
            # on compat sessions
            "fused_pipeline": bool(
                getattr(self.session, "fused_pipeline", False)
            ),
            "sessions": len(open_sessions),
            "sessions_total": len(self._sessions),
            "docs": self._next_doc,
            "doc_capacity": self.doc_capacity,
            "degraded_docs": self.degraded_docs,
            "fusion": self.fusion_snapshot(),
            "rounds": self.rounds,
            "applied_frames": self.applied,
            "buffered_frames": len(self._buffer),
            "overloaded": self.overloaded,
            "recent_sheds": max(
                0, self.admission.stats.shed - self._shed_mark
            ),
            "load": self.load_report(),
            "queue": self.admission.snapshot(),
            "window": self.tuner.snapshot(),
            "session_table": {
                str(sid): s.to_json()
                for sid, s in sorted(self._sessions.items())
            },
        }
        pool = getattr(self.session, "store", None)
        if pool is not None:
            snap["page_pool"] = pool.pool_stats()
        if self.auth is not None:
            snap["auth"] = {
                **self.auth.snapshot(),
                "per_frame": self.auth_per_frame,
            }
        return snap
