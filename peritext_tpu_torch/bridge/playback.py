"""Trace playback: scripted multi-editor sessions (reference ``src/playback.ts``).

A *trace* is a flat list of events, each either an ``InputOperation`` tagged
with the editor that performs it, a ``{"action": "sync"}`` barrier that
flushes every editor's outbound queue, or a ``{"action": "restart"}`` marker
(a no-op for the interpreter; demo loops use it to delimit iterations).
Events may carry a ``delay`` in milliseconds, honored only when playing in
realtime mode — tests and benchmarks play traces instantly.

``trace_from_spec`` converts a concurrent-edit ``TraceSpec`` (the shape the
ported reference test suite uses) into a trace that types the initial text,
applies each side's ops concurrently, and syncs at the end (reference
``testToTrace``, src/playback.ts:13-36).  ``simulate_typing_for_input_op``
expands a multi-character insert into per-keystroke events
(src/playback.ts:38-51).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional

from ..core.doc import CONTENT_KEY
from ..core.types import InputOperation
from .bridge import Editor

#: A trace event: an InputOperation + {"editorId": ...}, or {"action": "sync"},
#: or {"action": "restart"}; all optionally with {"delay": milliseconds}.
TraceEvent = Dict[str, Any]
Trace = List[TraceEvent]

#: Default inter-keystroke delay for simulated typing, in ms (reference :44).
TYPING_DELAY_MS = 50


def simulate_typing_for_input_op(editor_id: str, op: InputOperation) -> List[TraceEvent]:
    """Expand a multi-char insert into one event per keystroke; everything
    else passes through as a single event."""
    if op["action"] == "insert":
        return [
            {
                **op,
                "editorId": editor_id,
                "path": [CONTENT_KEY],
                "delay": TYPING_DELAY_MS,
                "values": [v],
                "index": op["index"] + i,
            }
            for i, v in enumerate(op["values"])
        ]
    return [{**op, "editorId": editor_id, "path": [CONTENT_KEY]}]


def trace_from_spec(trace_spec: Mapping[str, Any]) -> Trace:
    """Concurrent-edit spec → trace: seed text on alice, sync, both sides
    type their ops concurrently, final sync (reference src/playback.ts:13-36)."""
    initial_text = trace_spec.get("initialText")
    ops1, ops2 = trace_spec.get("inputOps1"), trace_spec.get("inputOps2")
    if not initial_text or ops1 is None or ops2 is None:
        raise ValueError("Expected full trace spec")

    trace: Trace = [
        {"editorId": "alice", "path": [], "action": "makeList", "key": CONTENT_KEY, "delay": 0},
        {"action": "sync", "delay": 0},
        {
            "editorId": "alice",
            "path": [CONTENT_KEY],
            "action": "insert",
            "index": 0,
            "values": list(initial_text),
        },
        {"action": "sync"},
    ]
    for op in ops1:
        trace.extend(simulate_typing_for_input_op("alice", op))
    for op in ops2:
        trace.extend(simulate_typing_for_input_op("bob", op))
    trace.append({"action": "sync"})
    return trace


def execute_trace_event(
    event: TraceEvent,
    editors: Mapping[str, Editor],
    on_sync: Optional[Callable[[], None]] = None,
    realtime: bool = False,
) -> None:
    """Interpret one trace event (reference ``executeTraceEvent``,
    src/playback.ts:82-121)."""
    action = event.get("action")
    if action == "sync":
        if on_sync is not None:
            on_sync()
        for editor in editors.values():
            editor.queue.flush()
    elif action == "restart":
        pass
    else:
        editor = editors.get(event.get("editorId", ""))
        if editor is None:
            raise KeyError("Encountered a trace event for a missing editor")
        op = {k: v for k, v in event.items() if k not in ("editorId", "delay")}
        editor.dispatch_input_ops([op])
    if realtime and event.get("delay"):
        time.sleep(event["delay"] / 1000.0)


def play_trace(
    trace: Iterable[TraceEvent],
    editors: Mapping[str, Editor],
    on_sync: Optional[Callable[[], None]] = None,
    realtime: bool = False,
) -> None:
    for event in trace:
        execute_trace_event(event, editors, on_sync=on_sync, realtime=realtime)


def endless_loop(trace: List[TraceEvent]) -> Iterator[TraceEvent]:
    """Cycle a trace forever (reference ``endlessLoop``, src/essay-demo.ts:92-98)."""
    while True:
        yield from trace
