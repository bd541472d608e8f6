"""Structured pipeline spans with cross-host trace propagation.

A :class:`Tracer` produces NESTED spans with monotonic ids over the merge
pipeline (``ingest → schedule → apply → resolve → decode →
patch-scatter``, plus guarded supervisor rounds) and serializes them as
Perfetto-compatible Chrome trace-event JSON (``chrome://tracing`` /
https://ui.perfetto.dev load it directly).

Cross-host correlation: a span's :class:`TraceContext` (a compact
``(trace_id, span_id)`` pair) rides the wire codec (frames v5/v6, see
``parallel/codec.py``), and a receiving host opens its handler span with
``ctx=`` so both hosts' spans share ONE trace id in the merged trace
(:func:`merge_traces`).

Instrumentation contract: ``tracer.span(...)`` ALWAYS measures (a pair of
clock reads) so callers can read ``span.duration`` for stats even when
nothing is exporting (a streaming round reports its schedule and apply
seconds from its spans); spans are only RETAINED when the tracer is
enabled (bounded buffer, for the Perfetto dump) or has sinks (e.g. a
:class:`~.recorder.FlightRecorder` ring).  A span measures the host wall
of its region without synchronizing the card: an apply span is the
dispatch, not the device work.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import threading
import time
import zlib
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional


class TraceContext(NamedTuple):
    """The compact wire-carried correlation pair: which trace a remote
    span belongs to, and which span is its parent."""

    trace_id: int
    span_id: int


class Span:
    """One finished (or in-flight) pipeline stage."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "host", "args",
                 "ts", "duration", "tid")

    def __init__(self, name: str, trace_id: int, span_id: int, parent_id: int,
                 host: str, args: Dict, ts: float) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.host = host
        self.args = args
        self.ts = ts  # epoch seconds at span start (cross-host alignable)
        self.duration = 0.0  # wall seconds, set at span exit
        self.tid = threading.get_ident()

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def to_event(self) -> Dict:
        """One Chrome trace-event (complete event, ``ph: "X"``)."""
        return {
            "name": self.name,
            "cat": "peritext",
            "ph": "X",
            "ts": int(self.ts * 1e6),
            "dur": max(1, int(self.duration * 1e6)),
            "pid": _host_pid(self.host),
            "tid": self.tid & 0xFFFFFFFF,
            "args": {
                "trace_id": f"{self.trace_id:016x}",
                "span_id": self.span_id,
                "parent_id": self.parent_id,
                "host": self.host,
                **_jsonable(self.args),
            },
        }

    def to_json(self) -> Dict:
        """Flat record for the flight-recorder JSONL form."""
        return {
            "name": self.name,
            "host": self.host,
            "trace_id": f"{self.trace_id:016x}",
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_ts": self.ts,
            "duration_s": round(self.duration, 6),
            "args": _jsonable(self.args),
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, trace={self.trace_id:#x}, "
                f"id={self.span_id}, dur={self.duration:.6f}s)")


def _jsonable(args: Dict) -> Dict:
    return {k: v if isinstance(v, (str, int, float, bool, type(None))) else str(v)
            for k, v in args.items()}


def _host_pid(host: str) -> int:
    """Stable small int per host label (Chrome's pid field)."""
    return zlib.crc32(host.encode("utf-8")) & 0x7FFFFFFF


def _mint_trace_id() -> int:
    """63-bit trace id.  Entropy is fine here: trace ids are telemetry
    labels, never merge inputs."""
    return (int.from_bytes(os.urandom(8), "big") >> 1) or 1


#: ONE active-span stack per thread, shared across tracer instances, so a
#: span opened by a transport tracer parents the session tracer's ingest
#: spans on the same thread (cross-component linkage)
_ACTIVE = threading.local()


def _stack() -> list:
    stack = getattr(_ACTIVE, "spans", None)
    if stack is None:
        stack = _ACTIVE.spans = []
    return stack


def current_span() -> Optional[Span]:
    """The innermost span open on this thread (any tracer), or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def ambient_parent(span: Optional[Span]) -> Iterator[None]:
    """Propagate ``span`` across a thread boundary: while active, spans
    opened on THIS thread parent under it (the thread-local stack does not
    cross threads by itself).  The supervisor uses this so a guarded
    round's stage spans nest under ``supervisor.round`` even though the
    round body runs on the watchdog worker thread.  ``None`` is a no-op."""
    if span is None:
        yield
        return
    stack = _stack()
    stack.append(span)
    try:
        yield
    finally:
        if stack and stack[-1] is span:
            stack.pop()
        else:  # pragma: no cover - unbalanced exit
            try:
                stack.remove(span)
            except ValueError:
                pass


class Tracer:
    """Produces spans; retains them (bounded) when ``enabled``; pushes each
    finished span to registered sinks either way."""

    def __init__(self, host: Optional[str] = None, enabled: bool = False,
                 trace_id: Optional[int] = None, capacity: int = 65536) -> None:
        self.host = host or f"{socket.gethostname()}/{os.getpid()}"
        self.enabled = enabled
        self.trace_id = int(trace_id) if trace_id is not None else _mint_trace_id()
        self._lock = threading.Lock()
        # span ids are monotonic per tracer ABOVE a random 48-bit-shifted
        # base: two hosts whose spans share one trace id (wire-carried
        # context) must not mint colliding ids, or parent links in a merged
        # trace become ambiguous
        self._id_base = int.from_bytes(os.urandom(6), "big") << 14
        self._next_id = 1
        self._spans: deque = deque(maxlen=capacity)
        self._sinks: List = []

    # -- lifecycle / wiring --------------------------------------------------

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def active(self) -> bool:
        return self.enabled or bool(self._sinks)

    def add_sink(self, sink) -> None:
        """``sink(span)`` is called with every finished span (e.g. a
        FlightRecorder's ``record_span``)."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- span production -----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, ctx: Optional[TraceContext] = None,
             **args) -> Iterator[Span]:
        """Open one nested span.  ``ctx`` adopts a wire-carried remote
        context (the span joins the REMOTE trace as a child of the remote
        span); otherwise the span nests under this thread's innermost open
        span, or roots a new span under the tracer's own trace id."""
        parent = current_span()
        if ctx is not None:
            trace_id, parent_id = int(ctx[0]), int(ctx[1])
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = self.trace_id, 0
        with self._lock:
            span_id = self._id_base + self._next_id
            self._next_id += 1
        sp = Span(name, trace_id, span_id, parent_id, self.host,
                  dict(args), time.time())
        t0 = time.perf_counter()
        stack = _stack()
        stack.append(sp)
        try:
            yield sp
        except BaseException as exc:  # graftlint: boundary(annotate the span for the timeline; always re-raised)
            sp.args.setdefault("error", repr(exc))
            raise
        finally:
            sp.duration = time.perf_counter() - t0
            if stack and stack[-1] is sp:
                stack.pop()
            else:  # pragma: no cover - unbalanced exit (generator misuse)
                try:
                    stack.remove(sp)
                except ValueError:
                    pass
            if self.enabled:
                with self._lock:
                    self._spans.append(sp)
            for sink in list(self._sinks):
                try:
                    sink(sp)
                except Exception:  # graftlint: boundary(a telemetry sink must never fail the traced workload)
                    pass

    def current_context(self) -> Optional[TraceContext]:
        """The context of this thread's innermost open span, for stamping
        onto outbound wire frames."""
        sp = current_span()
        return sp.context if sp is not None else None

    # -- export --------------------------------------------------------------

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def chrome_trace(self) -> Dict:
        """Perfetto/Chrome trace-event JSON for every retained span."""
        spans = self.spans()
        events: List[Dict] = []
        for host in sorted({sp.host for sp in spans}):
            events.append({
                "name": "process_name", "ph": "M", "pid": _host_pid(host),
                "tid": 0, "args": {"name": host},
            })
        events.extend(sp.to_event() for sp in spans)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def merge_traces(*traces: Dict) -> Dict:
    """Merge several ``chrome_trace()`` dicts (or bare event lists) into one
    trace — the per-host dumps of a cross-host exchange view as a single
    timeline because the wire-carried context gave them one trace id."""
    events: List[Dict] = []
    for t in traces:
        events.extend(t.get("traceEvents", []) if isinstance(t, dict) else t)
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: default process-wide tracer: inactive (spans still measure, nothing is
#: retained) until a caller enables it or attaches a sink
GLOBAL_TRACER = Tracer()
