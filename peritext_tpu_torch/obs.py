"""Observability: the ``MergeStats`` report and the stage timer that fills
it, a counter registry, and measuring spans.

Stage times are host wall-clock seconds.  A stage that ran on the card is
closed with ``torch.cuda.synchronize``, so its time includes the device
work it queued rather than only the enqueue.  Spans (:class:`Tracer`)
measure the host wall of a region without synchronizing: a streaming round
reports its schedule and apply (dispatch) seconds from them.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, NamedTuple, Optional

import torch


class Counters:
    """A registry of named monotone counters (the session's ``streaming.*``
    counts).  Three of them count the commits' insert launches, one each:
    ``streaming.block_applies`` (padded: one per touched read block of a
    round), ``streaming.group_applies`` (paged: one per page group of a
    round) and ``streaming.ragged_applies`` (ragged: one per non-empty doc
    class of a round's plan).  A lock guards every read and update: an
    editor's change queue flushes on a timer thread, and the flush
    publishes and drains sessions there (``parallel/change_queue.py``)."""

    def __init__(self) -> None:
        self._values: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + value

    def get(self, name: str) -> int:
        with self._lock:
            return self._values.get(name, 0)


GLOBAL_COUNTERS = Counters()


class TraceContext(NamedTuple):
    """The correlation pair a traced wire frame carries (codec v5/v6): the
    sender's trace and the span that shipped the frame.  An ingest span
    holds it in its ``args["ctx"]``, linking the receiving host's work to
    the sender's trace."""

    trace_id: int
    span_id: int


class Span:
    """One measured region: ``duration`` (host seconds, set on exit) and
    ``args`` (free-form annotations the region adds while it runs)."""

    __slots__ = ("name", "args", "duration", "_t0")

    def __init__(self, name: str, args: Dict[str, Any]) -> None:
        self.name = name
        self.args = args
        self.duration = 0.0
        self._t0 = 0.0

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.duration = time.perf_counter() - self._t0


class Tracer:
    """Span factory (the session's ``tracer``): every span measures; none
    is retained."""

    def span(self, name: str, **args) -> Span:
        return Span(name, args)


GLOBAL_TRACER = Tracer()


@dataclass
class MergeStats:
    """Per-merge observability (attached to ``api.batch.MergeReport``)."""

    docs: int = 0
    device_docs: int = 0
    fallback_docs: int = 0
    device_ops: int = 0
    fallback_ops: int = 0
    encode_seconds: float = 0.0
    apply_seconds: float = 0.0
    resolve_seconds: float = 0.0
    decode_seconds: float = 0.0
    #: real ops / padded op-stream capacity across the batch (0..1)
    padding_efficiency: float = 0.0
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return (
            self.encode_seconds
            + self.apply_seconds
            + self.resolve_seconds
            + self.decode_seconds
        )

    @property
    def device_ops_per_sec(self) -> float:
        wall = self.apply_seconds
        return self.device_ops / wall if wall > 0 else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "docs": self.docs,
            "device_docs": self.device_docs,
            "fallback_docs": self.fallback_docs,
            "device_ops": self.device_ops,
            "fallback_ops": self.fallback_ops,
            "encode_seconds": round(self.encode_seconds, 6),
            "apply_seconds": round(self.apply_seconds, 6),
            "resolve_seconds": round(self.resolve_seconds, 6),
            "decode_seconds": round(self.decode_seconds, 6),
            "padding_efficiency": round(self.padding_efficiency, 4),
            "device_ops_per_sec": round(self.device_ops_per_sec, 1),
            **self.extras,
        }


@contextmanager
def stage_timer(stats: MergeStats, name: str,
                device: Optional[torch.device] = None) -> Iterator[None]:
    """Time the enclosed stage into ``stats.<name>`` (seconds).  With a CUDA
    ``device``, the stage ends with a synchronize of that device."""
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    setattr(stats, name, time.perf_counter() - t0)
