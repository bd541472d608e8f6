"""Arrival schedules for streaming sessions: how a doc's change logs reach a
server over time.

Both split each doc's changes into round batches with ``random.Random``
calls in a fixed sequence, so the same seed gives the same arrival as the
reference package's helpers (``tests/test_streaming.py`` ``interleave_rounds``
and ``bench.build_arrival``, shuffle model), and two sessions fed from one
arrival see identical traffic.  The frame form encodes each round's batch
as one wire frame, as a sending host would.
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence

from ..core.types import Change


def interleave_rounds(workload: Dict[str, List[Change]], rounds: int,
                      rng: random.Random) -> List[List[Change]]:
    """Split one doc's change logs into ``rounds`` arrival batches (shuffled
    within a batch — delivery order must not matter)."""
    changes = [ch for log in workload.values() for ch in log]
    rng.shuffle(changes)
    size = -(-len(changes) // rounds)
    return [changes[i: i + size] for i in range(0, len(changes), size)]


def build_arrival(workloads: Sequence[Dict[str, List[Change]]], rounds: int, seed,
                  as_frames: bool = False, wire: str = "v2"):
    """Per-doc round batches of a session's arrival (the shuffle model: each
    doc's changes in a random order, per-sender reordering included, a
    scheduling stress), split into ``rounds`` batches.  One
    ``random.Random(seed)`` serves every doc, in doc order.

    Object form (default): returns the batches of ``Change`` objects.
    ``as_frames=True``: each batch, sorted by ``(actor, seq)`` (senders flush
    their queues in order), becomes one wire frame — ``wire="v2"``
    self-contained frames, or ``"v4"`` session frames (one compressing
    ``WireSession`` per doc link) — and the result is ``(arrival,
    wire_bytes)``."""
    from ..parallel.codec import WireSession, encode_frame

    if wire not in ("v2", "v4"):
        raise ValueError(f"unknown wire format: {wire!r}")
    rng = random.Random(seed)
    arrival = [interleave_rounds(w, rounds, rng) for w in workloads]
    if not as_frames:
        return arrival
    frames = []
    for batches in arrival:
        enc = WireSession(compress=True).encode_frame if wire == "v4" else encode_frame
        frames.append([enc(sorted(b, key=lambda c: (c.actor, c.seq))) for b in batches])
    return frames, sum(len(f) for doc in frames for f in doc)
