"""Structured event logging and the ``torch.profiler`` trace hook."""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, IO, Iterator, Optional

#: numbers the traces one process writes into one directory
_TRACE_SEQ = itertools.count(1)


class EventLog:
    """Append-only structured event stream.

    Events are plain dicts with a ``kind``; every record gets a monotonic
    sequence number and a wall-clock timestamp.  Optionally tees each record
    to a JSON-lines file (``fsync=True`` additionally fsyncs per record —
    the flight-recorder-grade durability mode).  Usable directly as an
    ``Editor.on_event`` sink, and as a context manager (``with EventLog(p)
    as log: ...`` closes the file on exit).

    Construction is leak-safe: the tee file is opened first, and any
    failure in the remainder of ``__init__`` (e.g. an invalid capacity)
    closes it before re-raising — a half-constructed log never strands an
    open handle.
    """

    def __init__(self, path: Optional[str | Path] = None,
                 capacity: Optional[int] = 10000,
                 fsync: bool = False):
        self._file: Optional[IO[str]] = None
        f: Optional[IO[str]] = open(path, "a") if path is not None else None
        try:
            if capacity is not None and capacity <= 0:
                raise ValueError(
                    f"capacity must be positive or None, got {capacity}"
                )
            self._lock = threading.Lock()
            self._events: list = []
            self._seq = 0
            self.capacity = capacity
            self.fsync = bool(fsync)
            self._file = f
        except BaseException:  # graftlint: boundary(close-on-error: the handle must not leak; always re-raised)
            if f is not None:
                f.close()
            raise

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        record = {"seq": None, "ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self._seq += 1
            record["seq"] = self._seq
            self._events.append(record)
            if self.capacity is not None and len(self._events) > self.capacity:
                self._events = self._events[-self.capacity :]
            if self._file is not None:
                self._file.write(json.dumps(record, default=str) + "\n")
                self._file.flush()
                if self.fsync:
                    os.fsync(self._file.fileno())
        return record

    # Editor.on_event sink (bridge.EditorEvent)
    def __call__(self, editor_event) -> None:
        self.emit(
            f"editor.{editor_event.kind}", actor=editor_event.actor, **editor_event.detail
        )

    def events(self, kind: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if kind is None or e["kind"] == kind] if kind else evs

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed block and write
    it to ``log_dir`` as a Chrome trace (``trace-<pid>-<n>.json``, viewable
    in Perfetto).  The host's activity is always recorded, and the card's
    kernels too when the profiler supports CUDA here.  Degrades to a no-op
    when the profiler cannot start, and a trace that fails to stop or to be
    written is dropped: tracing never fails the traced block."""
    if not enabled:
        yield
        return
    try:
        from torch.profiler import profile, supported_activities

        prof = profile(activities=sorted(supported_activities(), key=str))
        prof.start()
        started = True
    except Exception:  # graftlint: boundary(profiler availability is platform-defined; the workload must run)
        started = False
    try:
        yield
    finally:
        if started:
            try:
                prof.stop()
                out = Path(log_dir)
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(
                    str(out / f"trace-{os.getpid()}-{next(_TRACE_SEQ)}.json"))
            except Exception:  # graftlint: boundary(stop mirrors start: a torn trace is dropped, never raised)
                pass
