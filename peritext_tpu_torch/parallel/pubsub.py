"""In-process broadcast fan-out (reference ``src/pubsub.ts``).

The smallest transport in the replication stack: subscribers register a
callback; ``publish`` fans an update out to everyone except the sender.  Used
by the editor bridge and demos; the batched device path uses
:mod:`peritext_tpu_torch.parallel.anti_entropy` instead.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, TypeVar

from ..obs import GLOBAL_COUNTERS, GLOBAL_TRACER

T = TypeVar("T")


class Publisher(Generic[T]):
    """``monitor`` (optional, duck-typed: anything with
    ``observe_success(key, ...)``, and ``observe_failure(key, error=...)``
    for the faulty test double) records every delivery as a clean exchange
    per subscriber, so a fleet view can render editor-bridge subscribers
    next to network peers (the faulty double records drops as
    failures)."""

    def __init__(self, monitor=None) -> None:
        self._subscribers: Dict[str, Callable[[T], None]] = {}
        self.monitor = monitor

    def subscribe(self, key: str, callback: Callable[[T], None]) -> None:
        if key in self._subscribers:
            raise ValueError(f"duplicate subscription key {key!r}")
        self._subscribers[key] = callback

    def unsubscribe(self, key: str) -> None:
        if key not in self._subscribers:
            raise ValueError(f"no subscription under key {key!r}")
        del self._subscribers[key]

    def publish(self, sender: str, update: T) -> None:
        with GLOBAL_TRACER.span("pubsub.publish", sender=sender):
            # deterministic fan-out order: subscription (arrival) order is
            # replica-local history and must not drive delivery (PTL001)
            for key, callback in sorted(self._subscribers.items()):
                if key != sender:
                    callback(update)
                    if self.monitor is not None:
                        self.monitor.observe_success(key)
        GLOBAL_COUNTERS.add("transport.pubsub_published")
