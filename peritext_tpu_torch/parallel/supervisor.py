"""Fault-domain supervisor: guarded device rounds over a streaming session.

The streaming session already contains faults to the smallest doc-level
unit (per-doc quarantine, scalar-replay fallback); this module supervises
the one fault domain a doc cannot contain by itself: the DEVICE ROUND.  A
hung dispatch or a device error takes out the whole session's round, so
the supervisor wraps every ``step`` and ``drain`` in a wall-clock watchdog
and, on deadline or error, walks the degradation ladder:

1. **guarded round** — ``step`` runs on a watchdog thread; a round that
   overruns its deadline raises :class:`DeviceRoundError` instead of
   wedging the caller (the stuck round is abandoned with its session
   object: :meth:`GuardedSession.join_abandoned` waits for it);
2. **checkpoint rollback** — the session is rebuilt from the last good
   checkpoint (``checkpoint.CheckpointManager``: atomic staging+rename),
   and every ingest since that checkpoint is replayed from the
   supervisor's journal (frames are duplicate-tolerant, so
   journal/checkpoint overlap is harmless);
3. **guarded re-drain** — the restored session drains on its device under
   the same watchdog; a transient fault fully recovers here;
4. **last rung** — if the device path is still failing, a session on the
   CPU demotes every doc with pending work to scalar replay
   (``StreamingMerge.force_fallback``, reason ``device-round``): degraded
   throughput, byte-identical convergence.  A session on the card does
   not: it is rebuilt once more from durable state and the failure is
   raised as :class:`DeviceRoundError`, since replaying the card's work on
   the host would hide the card's fault.

A kernel that fails to build or load (``utils/nvcc.KernelBuildError``) is
not a round fault: it reaches the caller from any rung, never rolled back.

Limit: a sticky CUDA error (an illegal address, say) poisons the process's
CUDA context.  Every later launch fails, so the rollback's re-drain fails
too, and a session on the card raises at rung 4.  No in-process rollback
recovers from that; the process must be restarted from its checkpoints.
"""

from __future__ import annotations

import threading
import time
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from ..core.errors import DeviceRoundError
from ..obs import (
    FlightRecorder,
    GLOBAL_COUNTERS,
    GLOBAL_DEVPROF,
    GLOBAL_HISTOGRAMS,
    Histogram,
    Tracer,
    ambient_parent,
    current_span,
)
from ..utils.nvcc import KernelBuildError
from .streaming import REASON_DEVICE_ROUND, StreamingMerge


class GuardedSession:
    """A :class:`StreamingMerge` under fault-domain supervision.

    ``factory`` builds a fresh, empty session (used at construction and as
    the last-resort restore when no checkpoint exists yet); checkpoints
    restore onto the factory session's device.  All ingest must flow
    through the supervisor so its journal stays complete; reads (and any
    other public method) pass through to ``self.session``.

    ``deadline`` is the per-round wall-clock watchdog in seconds, AUTOTUNED
    by default: the effective deadline is ``clamp(margin *
    rolling_p{quantile}(round latency), floor, ceiling)`` over the last
    ``deadline_window`` rounds.  ``deadline`` doubles as the ceiling (and,
    /4, the floor) when no explicit bound is given; the first
    ``deadline_warmup`` successful rounds are EXEMPT — they run against the
    ceiling and their latencies never enter the window.  Rollback drains
    always run against the ceiling.  ``autotune=False`` keeps the static
    deadline.

    ``checkpoint_every`` counts successful guarded rounds between automatic
    checkpoints.  ``drain()`` is one atomic guarded unit that checkpoints
    at its end, so its replay window is the drained backlog, and its
    watchdog budget scales with the same backlog (``_drain_deadline``).

    The round body runs on the watchdog thread, on the session's device
    and on the stream that was current on the caller's thread.

    Observability: the supervisor owns a :class:`~..obs.Tracer` (unless
    given one) and a :class:`~..obs.FlightRecorder` ring dumping JSONL
    under ``<checkpoint_root>/flight`` on quarantine and rollback; both are
    attached to the supervised session (and re-attached across restores)
    so round/stage spans land in the ring.  ``mesh=`` is the mesh the
    factory's sessions run on (parallel/mesh.Mesh): a rollback restores
    onto it.
    """

    def __init__(
        self,
        factory: Callable[[], StreamingMerge],
        checkpoint_root: str | Path,
        deadline: float = 30.0,
        checkpoint_every: int = 8,
        keep: int = 3,
        mesh=None,
        tracer=None,
        recorder=None,
        autotune: bool = True,
        deadline_floor: Optional[float] = None,
        deadline_ceiling: Optional[float] = None,
        deadline_quantile: float = 0.99,
        deadline_margin: float = 6.0,
        deadline_window: int = 64,
        deadline_warmup: int = 1,
    ) -> None:
        from ..checkpoint import CheckpointManager

        self._factory = factory
        self.tracer = tracer if tracer is not None else Tracer()
        self.recorder = recorder if recorder is not None else FlightRecorder(
            capacity=1024, dump_dir=Path(checkpoint_root) / "flight"
        )
        self.tracer.add_sink(self.recorder.record_span)
        self.deadline = deadline
        self.autotune = autotune
        self._deadline_floor = deadline_floor
        self._deadline_ceiling = deadline_ceiling
        self.deadline_quantile = deadline_quantile
        self.deadline_margin = deadline_margin
        self.deadline_warmup = deadline_warmup
        #: rolling round-latency window (successful guarded rounds, warmup
        #: exempt) — the percentile source for the effective deadline
        self.round_latency = Histogram(window=deadline_window)
        self._rounds_total = 0
        self.checkpoint_every = checkpoint_every
        self.mesh = mesh
        self.session = factory()
        self.device = self.session.device
        self.manager = CheckpointManager(checkpoint_root, keep=keep, device=self.device)
        self._attach_session(self.session)
        #: everything ingested since the last checkpoint, in order — the
        #: rollback replay source.  Entries are ``(doc, frame_bytes)`` or
        #: ``(doc, [Change, ...])``: the object path journals too, so no
        #: accepted ingest can vanish in a rollback
        self._journal: List[Tuple[int, object]] = []
        self._rounds_since_checkpoint = 0
        # resume numbering above any existing checkpoint: starting at 0 over
        # a pre-crash root would mint already-used low step numbers that
        # retention immediately prunes, leaving latest() stuck on stale state
        self._checkpoint_step = max(self.manager.steps(), default=0)
        self.rollbacks = 0
        self.checkpoints = 0
        #: times the last rung demoted pending docs (only on the CPU)
        self.scalar_degradations = 0
        #: one-shot fault injection queues (chaos harness / tests)
        self._inject_failures: List[Exception] = []
        self._inject_delays: List[float] = []
        #: watchdog threads abandoned past their deadline, still running
        self._abandoned: List[threading.Thread] = []

    # -- deadline autotuning -------------------------------------------------

    @property
    def deadline_floor(self) -> float:
        """Autotune lower clamp (explicit, else ``deadline / 4``)."""
        return (self._deadline_floor if self._deadline_floor is not None
                else self.deadline / 4)

    @property
    def deadline_ceiling(self) -> float:
        """Autotune upper clamp (explicit, else the configured ``deadline``
        — mutating ``self.deadline`` keeps working as the static control)."""
        return (self._deadline_ceiling if self._deadline_ceiling is not None
                else self.deadline)

    def effective_deadline(self) -> float:
        """The watchdog deadline the NEXT guarded round runs against:
        ``clamp(margin * rolling-percentile, floor, ceiling)`` once the
        warmup-exempt window has data, the ceiling before and with
        ``autotune=False``."""
        if not self.autotune or self.round_latency.count == 0:
            return float(self.deadline_ceiling)
        tuned = self.round_latency.percentile(self.deadline_quantile)
        tuned *= self.deadline_margin
        return float(min(self.deadline_ceiling, max(self.deadline_floor, tuned)))

    # -- session attachment --------------------------------------------------

    def _attach_session(self, session) -> None:
        """Point the session's telemetry at the supervisor's tracer and
        flight recorder (round/stage spans land in the dump ring; a
        quarantine inside the session triggers the recorder's auto-dump)."""
        session.tracer = self.tracer
        session.recorder = self.recorder

    def adopt_session(self, session) -> None:
        """Install an externally-restored session (crash-restore path) with
        the telemetry attachment a factory-built session would get."""
        self.session = session
        self._attach_session(session)

    def close(self) -> None:
        """Detach this supervisor's flight-recorder sink from the tracer
        (matters when the tracer is shared and outlives the supervisor).
        Idempotent."""
        self.tracer.remove_sink(self.recorder.record_span)

    def join_abandoned(self, timeout: Optional[float] = None) -> bool:
        """Wait for every round the watchdog abandoned to finish (it runs
        on the abandoned session, and on the card it may still launch
        kernels and move the launch counters).  Returns whether all have
        ended."""
        end = None if timeout is None else time.monotonic() + timeout
        for worker in self._abandoned:
            worker.join(None if end is None else max(0.0, end - time.monotonic()))
        self._abandoned = [w for w in self._abandoned if w.is_alive()]
        return not self._abandoned

    # -- ingest (journalled) ------------------------------------------------

    def ingest_frame(self, doc_index: int, data: bytes) -> None:
        self.ingest_frames([(doc_index, data)])

    def ingest_frames(self, items: Iterable) -> None:
        """Journal + quarantine-mode ingest: corrupt frames are contained to
        their doc (typed ``decode`` quarantine), never raised."""
        items = list(items)
        self._journal.extend(items)
        self.session.ingest_frames(items, on_corrupt="quarantine")

    def ingest(self, doc_index: int, changes: Iterable) -> None:
        """Journalled object-change ingest (the editor/bridge surface) — a
        rollback replays these too, so changes the caller saw accepted can
        never silently vanish."""
        changes = list(changes)
        if not changes:
            return
        self._journal.append((doc_index, changes))
        self.session.ingest(doc_index, changes)

    # -- guarded rounds -----------------------------------------------------

    def inject_failure(self, exc: Exception) -> None:
        """Queue one device-round failure for the next :meth:`step` or
        :meth:`drain` (chaos hook).  ``Exception`` only: the containment
        handler deliberately lets BaseException through."""
        if not isinstance(exc, Exception):
            raise TypeError(f"inject_failure wants an Exception, got {exc!r}")
        self._inject_failures.append(exc)

    def inject_delay(self, seconds: float) -> None:
        """Queue one artificial round delay (deadline-path chaos hook)."""
        self._inject_delays.append(seconds)

    def _round(self) -> int:
        # bind the session NOW: if the watchdog abandons this thread and the
        # supervisor rolls back, a late-waking zombie must keep touching the
        # abandoned session object, never the freshly restored one
        session = self.session
        if self._inject_delays:
            time.sleep(self._inject_delays.pop(0))
        scheduled = session.step()
        # a periodic guarded sync, not per round: an asynchronous device
        # error from round N surfaces inside round N+1's guarded dispatch
        # (or here, before the next checkpoint), and rollback restores the
        # same checkpoint+journal state either way
        if self._rounds_since_checkpoint + 1 >= self.checkpoint_every:
            session.sync_device()
        return scheduled

    def _run_guarded(self, fn: Callable[[], int],
                     deadline: Optional[float] = None) -> int:
        deadline = self.effective_deadline() if deadline is None else deadline
        box: Dict[str, object] = {}
        # the round body runs on the watchdog thread; carry the caller's
        # open span (supervisor.round) across so the session's stage spans
        # nest under it, and pin the session's device and the caller's
        # stream so no work lands on an implicit device or stream
        parent = current_span()
        device = self.session.device
        stream = torch.cuda.current_stream(device) if device.type == "cuda" else None

        def run() -> None:
            try:
                with ambient_parent(parent):
                    if stream is None:
                        box["value"] = fn()
                    else:
                        with torch.cuda.device(device), torch.cuda.stream(stream):
                            box["value"] = fn()
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                box["error"] = exc

        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(deadline)
        if worker.is_alive():
            # the round is wedged; abandon it (state is rebuilt from the
            # checkpoint — the stuck thread can no longer corrupt anything
            # the supervisor will use)
            self._abandoned.append(worker)
            raise DeviceRoundError(
                f"device round exceeded its {deadline:.4g}s deadline"
            )
        if "error" in box:
            exc = box["error"]
            if isinstance(exc, (DeviceRoundError, KernelBuildError)):
                raise exc
            raise DeviceRoundError(f"device round failed: {exc!r}") from exc
        return int(box["value"])  # type: ignore[arg-type]

    def step(self) -> int:
        """One guarded device round.  Returns the changes scheduled, or 0
        when the round was rolled back (the work is not lost: it recovered
        on device during rollback, or, on the CPU, was demoted to scalar
        replay).  Raises when a kernel cannot be built or loaded, and when
        a session on the card still fails after the rollback."""
        sp = None
        try:
            if self._inject_failures:
                raise self._inject_failures.pop(0)
            with self.tracer.span(
                "supervisor.round",
                deadline=round(self.effective_deadline(), 4),
            ) as sp:
                scheduled = self._run_guarded(self._round)
        except Exception as exc:  # graftlint: boundary(the ladder's root: a round failure rolls back)
            if isinstance(exc, KernelBuildError):
                raise
            if sp is not None:
                GLOBAL_HISTOGRAMS.observe("supervisor.round_seconds", sp.duration)
            self._rollback(exc)
            return 0
        self._rounds_total += 1
        GLOBAL_HISTOGRAMS.observe("supervisor.round_seconds", sp.duration)
        if GLOBAL_DEVPROF.enabled:
            # guarded-round boundary: a memory watermark after the round
            GLOBAL_DEVPROF.sample_memory(self.session.device)
        if self._rounds_total > self.deadline_warmup:
            # warmup exemption: the first round(s) must not seed the rolling
            # percentile the deadline derives from
            self.round_latency.observe(sp.duration)
        self._rounds_since_checkpoint += 1
        if self._rounds_since_checkpoint >= self.checkpoint_every:
            self._checkpoint_tolerant()
        return scheduled

    def drain(self, max_rounds: int = 1000) -> int:
        """Guarded drain: the session's whole drain plus the sync that
        surfaces asynchronous device errors runs as ONE atomic guarded unit
        against the deadline ceiling scaled by the backlog.  On deadline or
        any fault, rollback restores the last checkpoint and replays the
        journal, so the recovered session lands on the pre-drain boundary,
        never on a half-applied batch.  Returns the rounds the drain
        committed, 0 when it rolled back; raises as :meth:`step` does."""
        sp = None
        try:
            if self._inject_failures:
                raise self._inject_failures.pop(0)
            deadline = self._drain_deadline(max_rounds)
            with self.tracer.span(
                "supervisor.drain",
                deadline=round(float(deadline), 4),
            ) as sp:
                rounds = self._run_guarded(
                    partial(self._drain_once, max_rounds),
                    deadline=deadline,
                )
        except Exception as exc:  # graftlint: boundary(the drain is one containment unit)
            if isinstance(exc, KernelBuildError):
                raise
            if sp is not None:
                GLOBAL_HISTOGRAMS.observe("supervisor.drain_seconds", sp.duration)
            self._rollback(exc)
            return 0
        GLOBAL_HISTOGRAMS.observe("supervisor.drain_seconds", sp.duration)
        if rounds:
            self._rounds_total += rounds
            self._rounds_since_checkpoint += rounds
            if self._rounds_since_checkpoint >= self.checkpoint_every:
                self._checkpoint_tolerant()
        return rounds

    def _checkpoint_tolerant(self) -> None:
        """A periodic checkpoint whose failure (disk full, permissions) does
        not breach the no-fault contract: the journal is truncated only
        after a successful save, so the next round simply retries."""
        try:
            self.checkpoint()
        except Exception:  # graftlint: boundary(a failed save is retried by the next round)
            GLOBAL_COUNTERS.add("supervisor.checkpoint_failures")

    def _drain_deadline(self, max_rounds: int) -> float:
        """Watchdog budget for one drain: ``deadline_ceiling`` per batch of
        up to ``FUSE_MAX_ROUNDS`` rounds of the session's backlog estimate,
        so a deep but healthy drain is not cut at one round's ceiling."""
        session = self.session
        fuse = int(getattr(session, "FUSE_MAX_ROUNDS", 1) or 1)
        est = getattr(session, "pending_rounds_estimate", None)
        rounds = min(max_rounds, est()) if est is not None else 1
        batches = max(1, -(-rounds // fuse))
        return self.deadline_ceiling * batches

    def _drain_once(self, max_rounds: int) -> int:
        """The guarded drain body (watchdog thread): one session drain plus
        the sync that surfaces device errors INSIDE this guarded unit."""
        session = self.session  # zombie-safety: see _round
        if self._inject_delays:
            time.sleep(self._inject_delays.pop(0))
        rounds = session.drain(max_rounds)
        session.sync_device()
        return rounds

    # -- checkpoint / rollback ---------------------------------------------

    def checkpoint(self) -> Path:
        """Persist the session (its frame histories) and truncate the
        journal — this becomes the rollback target."""
        self._checkpoint_step += 1
        path = self.manager.save(step=self._checkpoint_step, session=self.session)
        self._journal = []
        self._rounds_since_checkpoint = 0
        self.checkpoints += 1
        GLOBAL_COUNTERS.add("supervisor.checkpoints")
        return path

    def _restore_base(self) -> StreamingMerge:
        """Last good checkpoint (not drained: draining happens under the
        watchdog) + journal replay; a fresh session when no checkpoint
        exists yet (the journal then holds the complete history)."""
        latest = self.manager.latest()
        restored: Optional[StreamingMerge] = None
        if latest is not None:
            restored = latest.session(mesh=self.mesh, drain=False)
        if restored is None:
            restored = self._factory()
        # replay in journal order; consecutive frame entries batch through
        # one bulk ingest, object entries replay via ingest so the doc keeps
        # the routing mode the caller established
        run: List[Tuple[int, bytes]] = []
        for d, payload in self._journal:
            if isinstance(payload, (bytes, bytearray)):
                run.append((d, payload))
                continue
            if run:
                restored.ingest_frames(run, on_corrupt="quarantine")
                run = []
            restored.ingest(d, list(payload))
        if run:
            restored.ingest_frames(run, on_corrupt="quarantine")
        self._attach_session(restored)
        return restored

    def _rollback(self, error: BaseException) -> None:
        """Degradation ladder steps 2-4 (see module docstring).  The
        re-drain runs against the deadline ceiling scaled by the restored
        backlog (``_drain_deadline``)."""
        self.rollbacks += 1
        GLOBAL_COUNTERS.add("supervisor.rollbacks")
        self.recorder.fault(
            "rollback", error=repr(error), rollbacks=self.rollbacks,
            journal_frames=len(self._journal),
        )
        self.session = self._restore_base()
        try:
            self._run_guarded(self._drain_device,
                              deadline=self._drain_deadline(1_000))
        except Exception as exc:  # graftlint: boundary(second strike: the device path is still failing)
            if isinstance(exc, KernelBuildError):
                raise
            # rebuild once more from durable state (a deadline here may
            # have left a zombie thread draining the object just restored)
            restored = self._restore_base()
            self.session = restored
            if restored.device.type != "cpu":
                # on the card the last rung raises: demoting the docs would
                # move the card's work to the host and hide its fault
                GLOBAL_COUNTERS.add("supervisor.device_failures")
                raise DeviceRoundError(
                    f"device round failed after rollback: {error!r}; "
                    f"re-drain failed: {exc!r}") from exc
            for d in sorted(restored.pending_docs()):
                restored.force_fallback(
                    d, REASON_DEVICE_ROUND,
                    detail=f"rollback after {error!r}; re-drain failed: {exc!r}",
                )
            self.scalar_degradations += 1
            GLOBAL_COUNTERS.add("supervisor.scalar_degradations")

    def _drain_device(self) -> int:
        session = self.session  # zombie-safety: see _round
        rounds = 0
        while session.drain() > 0:
            rounds += 1
        session.sync_device()
        return rounds

    # -- pass-throughs ------------------------------------------------------

    def read(self, doc_index: int):
        return self.session.read(doc_index)

    def read_all(self):
        return self.session.read_all()

    def digest(self, **kw) -> int:
        return self.session.digest(**kw)

    def quarantined(self):
        return self.session.quarantined()

    def __getattr__(self, name: str):
        # every other PUBLIC session method (read_patches, pending_count,
        # frontier, ...) passes through; private names stay local so a
        # half-constructed supervisor can never recurse here
        session = self.__dict__.get("session")
        if session is not None and not name.startswith("_"):
            return getattr(session, name)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}"
        )

    def health(self) -> Dict:
        """Session health plus the supervisor's own fault evidence (with
        ``scalar_degradations``, which the reference's lacks) and the
        deadline-autotune state."""
        out = self.session.health()
        out.update(
            rollbacks=self.rollbacks,
            checkpoints=self.checkpoints,
            scalar_degradations=self.scalar_degradations,
            journal_frames=len(self._journal),
            deadline_seconds=self.effective_deadline(),
            deadline_static=self.deadline,
            deadline_floor=self.deadline_floor,
            deadline_ceiling=self.deadline_ceiling,
            deadline_autotuned=bool(
                self.autotune and self.round_latency.count > 0
            ),
            round_latency=self.round_latency.snapshot(),
            flight_recorder=self.recorder.snapshot(),
        )
        return out
