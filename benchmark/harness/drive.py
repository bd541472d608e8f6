"""What every traffic kind shares: a session as the configuration states
it, the harness's own host spans, and one step through ``StreamingMerge``
as a server takes it.

Every step is one ``ingest_frames`` of the step's frames, one ``drain()``
and one ``digest_async()``, whose ``wait()`` returns before the next step's
ingest: the step has converged when the digest that covers it is back.
How steps are made and timed is the traffic kind's (``modes/<kind>.py``).
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional


def make_session(config: Dict, device, num_docs: Optional[int] = None):
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    return StreamingMerge(
        num_docs=num_docs or config["docs"], actors=tuple(config["actors"]),
        layout=config["layout"], read_chunk=config["read_chunk"], device=device,
        **config["session"])


class Spans:
    """The harness's own host spans (name, start, end on ``time.time()``)."""

    def __init__(self) -> None:
        self.spans: List[tuple] = []

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time()))


class Step:
    """Hooks around a step, for the traced run: ``before(i)`` and
    ``after(i)`` with the step's index in the window, and ``digest()``, a
    context around the digest's call and ``wait()``."""

    def before(self, i: int) -> None:
        pass

    def after(self, i: int) -> None:
        pass

    def digest(self):
        return nullcontext()


def run_step(sess, items, spans: Spans, hooks: Step) -> int:
    with spans("bench.ingest"):
        sess.ingest_frames(items)
    with spans("bench.drain"):
        sess.drain()
    with spans("bench.digest"), hooks.digest():
        return sess.digest_async().wait()
