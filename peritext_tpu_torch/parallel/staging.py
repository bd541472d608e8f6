"""Double-buffered host->device staging lane (the fused round pipeline's
upload half).

The fused round pipeline (parallel/streaming.py ``drain``) splits a round
batch's host half into SCHEDULE (causal admission into staging buffers;
mutates session clocks, so it stays on the session's thread) and STAGE
(flatten the staged buffers into the batch's one contiguous int32 buffer
and upload it; pure reads of buffers the batch owns).  This module runs
the STAGE half on a worker thread, so batch k's flatten and upload overlap
batch k+1's schedule on the caller's thread and batch k-1's device work.

``depth`` bounds the staged batches in flight (default 2, the double
buffer): ``submit`` blocks while the lane is full, so a deep drain never
piles unbounded staged buffers onto the host or the card.

On the card the worker uploads through a :class:`CopyLane`: each job's
buffer is written into pinned host memory and copied on the lane's own
copy stream of the session's device, with a CUDA event recorded after the
copy.  The committing thread makes its compute stream wait on that event
(:meth:`StagedUpload.consume`) before the batch's replay, and the pinned
buffer is held until the event has completed.

Determinism: staging jobs are pure functions of their already scheduled
batch.  The worker adds no ordering freedom (handles resolve in FIFO
order, commits wait each handle in submission order), reads no clocks and
draws no randomness; timing telemetry is the caller's, through
``span_factory``.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

#: worker idle lifetime: a lane whose owner stopped draining (an abandoned
#: watchdog session, a dropped StreamingMerge) retires its thread instead of
#: leaking one per session; the next submit spawns a new one
IDLE_TIMEOUT_SECONDS = 10.0


class StagedHandle:
    """One staged batch's future: ``wait()`` returns the staging function's
    result or re-raises its failure on the waiting thread, so a staging
    fault surfaces inside the guarded commit that consumes it, never on a
    daemon thread."""

    __slots__ = ("_done", "_value", "_error")

    def __init__(self) -> None:
        self._done = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value) -> None:
        self._value = value
        self._done.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def ready(self) -> bool:
        return self._done.is_set()

    def wait(self):
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._value


class FrameStager:
    """The staging lane: one worker thread consuming a bounded FIFO of
    ``(fn, args)`` jobs, each resolved into a :class:`StagedHandle`.

    One lane per session (built lazily by the fused drain); the worker is a
    daemon with an idle timeout, so an abandoned session costs a bounded
    wait, not a leaked thread.  ``stats()`` exports the job and error
    counts.
    """

    def __init__(self, depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"stager depth must be >= 1, got {depth}")
        self.depth = depth
        self._queue: "queue.Queue[Optional[Tuple]]" = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.staged = 0
        self.errors = 0
        #: optional span hook: a zero-argument callable returning a context
        #: manager (e.g. ``lambda: tracer.span("staging.stage")``); each job
        #: runs inside one.  Spans measure durations; this module reads no
        #: clock itself
        self.span_factory: Optional[Callable] = None

    # -- submission ----------------------------------------------------------

    def submit(self, fn: Callable, *args) -> StagedHandle:
        """Enqueue one staging job; blocks while ``depth`` jobs are already
        in flight (the double-buffer bound).  Returns the job's handle."""
        if self._closed:
            raise RuntimeError("FrameStager is closed")
        handle = StagedHandle()
        # enqueue BEFORE ensuring the worker: the idle-retire path re-checks
        # the queue under the lock, so a job published first either keeps
        # the racing worker alive or is taken by the worker spawned below
        self._queue.put((fn, args, handle))
        self._ensure_worker()
        return handle

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run, name="peritext-stager",
                                                daemon=True)
                self._thread.start()

    # -- the worker ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            try:
                job = self._queue.get(timeout=IDLE_TIMEOUT_SECONDS)
            except queue.Empty:
                with self._lock:
                    # a submit may have raced the timeout: keep serving if
                    # so, else retire this worker
                    if self._queue.empty():
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                continue
            if job is None:  # close() sentinel
                return
            fn, args, handle = job
            try:
                factory = self.span_factory
                if factory is not None:
                    with factory():
                        value = fn(*args)
                else:
                    value = fn(*args)
            except BaseException as exc:  # graftlint: boundary(staging worker forwards every failure to the committing waiter verbatim)
                self.errors += 1
                handle._reject(exc)
            else:
                # count BEFORE resolving: a reader of stats() right after
                # handle.wait() returns never sees an undercount
                self.staged += 1
                handle._resolve(value)
            # the idle wait holds nothing of the job (its function may be a
            # bound method of a session the caller has dropped)
            job = fn = args = handle = value = None

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Stop accepting jobs and let the worker drain then exit.  Handles
        already submitted still resolve; idempotent."""
        if self._closed:
            return
        self._closed = True
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
        if alive:
            self._queue.put(None)

    def stats(self) -> dict:
        return {"staged": self.staged, "errors": self.errors, "depth": self.depth}


# -- the upload itself -------------------------------------------------------


class StagedUpload:
    """One staged batch's int32 buffer on its device.  On the card
    ``event`` is recorded on the copy stream after the host-to-device copy
    (its :class:`CopyLane` holds the pinned source until the event has
    completed); on the CPU it is None and ``tensor`` is the host buffer
    itself."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event=None):
        self.tensor = tensor
        self.event = event

    def consume(self, stream=None) -> torch.Tensor:
        """The buffer, usable on ``stream`` (default: the current stream of
        its device): the stream waits on the copy's event first, and the
        caching allocator learns that the stream uses the buffer (it was
        allocated on the copy stream)."""
        if self.event is not None:
            if stream is None:
                stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.event)
            self.tensor.record_stream(stream)
        return self.tensor


class CopyLane:
    """Pinned, non-blocking uploads to one device on a copy stream of its
    own (the card), or plain host tensors (the CPU).  ``copies`` counts the
    host-to-device copies it made."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.copies = 0
        self._stream = None
        #: (event, pinned buffer) of copies that may still be running: a
        #: pinned buffer is released only after its copy's event completed
        self._held: "collections.deque" = collections.deque()

    def upload(self, flat: np.ndarray) -> StagedUpload:
        """``flat`` (1-D int32) on the lane's device, as one copy."""
        flat = np.ascontiguousarray(flat, np.int32).reshape(-1)
        if self.device.type != "cuda":
            return StagedUpload(torch.from_numpy(flat))
        while self._held and self._held[0][0].query():
            self._held.popleft()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        host = torch.empty(flat.shape, dtype=torch.int32, pin_memory=True)
        host.numpy()[:] = flat
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = torch.empty(flat.shape, dtype=torch.int32, device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._held.append((event, host))
        self.copies += 1
        return StagedUpload(dev, event)
