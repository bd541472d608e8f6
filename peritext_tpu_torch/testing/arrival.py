"""Arrival schedules for streaming sessions: how a doc's change logs reach a
server over time.

Both split each doc's changes into round batches with ``random.Random``
calls in a fixed sequence, so the same seed gives the same arrival as the
reference package's helpers (``tests/test_streaming.py`` ``interleave_rounds``
and ``bench.build_arrival``, both arrival models), and two sessions fed from
one arrival see identical traffic.  The frame form encodes each round's batch
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
    return _split_rounds(changes, rounds)


def _split_rounds(changes: List[Change], rounds: int) -> List[List[Change]]:
    size = -(-len(changes) // rounds)
    return [changes[i: i + size] for i in range(0, len(changes), size)]


def fifo_order(workload: Dict[str, List[Change]], rng: random.Random) -> List[Change]:
    """One doc's changes as a transport delivers them: each sender's log in
    its own (FIFO) order, the next change taken from a uniformly random
    sender that still has one."""
    logs = {a: list(log) for a, log in workload.items()}
    actors = sorted(logs)
    changes = []
    while True:
        live = [a for a in actors if logs[a]]
        if not live:
            return changes
        changes.append(logs[rng.choice(live)].pop(0))


def build_arrival(workloads: Sequence[Dict[str, List[Change]]], rounds: int, seed,
                  as_frames: bool = False, wire: str = "v2", arrival_model: str = "shuffle"):
    """Per-doc round batches of a session's arrival, split into ``rounds``
    batches.  One ``random.Random(seed)`` serves every doc, in doc order.

    ``arrival_model``: ``"shuffle"`` (each doc's changes in a random order,
    per-sender reordering included, a scheduling stress) or ``"fifo"``
    (:func:`fifo_order`: per-sender FIFO with a random interleave of
    senders, what a TCP link and a change queue deliver).

    Object form (default): returns the batches of ``Change`` objects.
    ``as_frames=True``: each batch, sorted by ``(actor, seq)`` (senders flush
    their queues in order), becomes one wire frame — ``wire="v2"``
    self-contained frames, or ``"v4"`` session frames (one compressing
    ``WireSession`` per doc link) — and the result is ``(arrival,
    wire_bytes)``."""
    from ..parallel.codec import WireSession, encode_frame

    if wire not in ("v2", "v4"):
        raise ValueError(f"unknown wire format: {wire!r}")
    if arrival_model not in ("shuffle", "fifo"):
        raise ValueError(f"unknown arrival model: {arrival_model!r}")
    rng = random.Random(seed)
    arrival = [interleave_rounds(w, rounds, rng) if arrival_model == "shuffle"
               else _split_rounds(fifo_order(w, rng), rounds) for w in workloads]
    if not as_frames:
        return arrival
    frames = []
    for batches in arrival:
        enc = WireSession(compress=True).encode_frame if wire == "v4" else encode_frame
        frames.append([enc(sorted(b, key=lambda c: (c.actor, c.seq))) for b in batches])
    return frames, sum(len(f) for doc in frames for f in doc)
