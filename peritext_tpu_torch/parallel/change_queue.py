"""Outbound change batching (reference ``src/changeQueue.ts``).

Buffers locally-generated changes and flushes them in batches — either
manually (deterministic tests, simulated latency) or on a wall-clock interval
via a background timer thread (interactive demos).  Flush failures requeue the
batch at the front so no change is lost (the reference left this as a TODO,
src/changeQueue.ts:38).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..core.types import Change


class ChangeQueue:
    def __init__(
        self,
        handle_flush: Callable[[List[Change]], None],
        interval: float = 0.01,
        on_error: Optional[Callable[[Exception], None]] = None,
        max_backoff: float = 1.0,
    ) -> None:
        self._changes: List[Change] = []
        self._handle_flush = handle_flush
        self._interval = interval
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()
        self._running = False
        #: called with the exception when a timer-driven flush fails
        self._on_error = on_error
        self._max_backoff = max_backoff
        self._current_interval = interval

    def enqueue(self, *changes: Change) -> None:
        with self._lock:
            self._changes.extend(changes)

    def __len__(self) -> int:
        with self._lock:
            return len(self._changes)

    def flush(self) -> None:
        with self._lock:
            batch, self._changes = self._changes, []
        if not batch:
            return
        try:
            self._handle_flush(batch)
        except Exception:  # graftlint: boundary(requeue-then-reraise: the batch must survive ANY flush failure; the exception propagates unchanged)
            with self._lock:  # requeue at the front; nothing is dropped
                self._changes = batch + self._changes
            raise

    def start(self) -> None:
        """Begin periodic flushing on a daemon timer."""
        with self._lock:
            self._running = True
            self._current_interval = self._interval  # forget stale backoff
        self._schedule()

    def _schedule(self) -> None:
        # Check _running and start the timer under the lock so a concurrent
        # drop() can never observe "stopped" yet leave a fresh timer running.
        with self._lock:
            if not self._running:
                return
            self._timer = threading.Timer(self._current_interval, self._tick)
            self._timer.daemon = True
            self._timer.start()

    def _tick(self) -> None:
        # Timer-driven flushes must not leak exceptions into the timer thread;
        # failures back off exponentially (changes stay queued) and are
        # reported through on_error.
        try:
            self.flush()
            self._current_interval = self._interval
        except Exception as exc:  # noqa: BLE001 - deliberate boundary
            self._current_interval = min(self._current_interval * 2, self._max_backoff)
            if self._on_error is not None:
                self._on_error(exc)
        finally:
            self._schedule()

    def drop(self) -> None:
        """Stop the timer (simulates a network partition; reference
        ``queue.drop()``, src/index.ts:117-119)."""
        with self._lock:
            self._running = False
            timer, self._timer = self._timer, None
        if timer is not None:
            timer.cancel()
