"""Arrival schedules for streaming sessions: how a doc's change logs reach a
server over time.

Both split each doc's changes into round batches with ``random.Random``
calls in a fixed sequence, so the same seed gives the same arrival as the
reference package's helpers (``tests/test_streaming.py`` ``interleave_rounds``
and the object branch of ``bench.build_arrival``), and two sessions fed
from one arrival see identical traffic.
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


def build_arrival(workloads: Sequence[Dict[str, List[Change]]], rounds: int,
                  seed) -> List[List[List[Change]]]:
    """Per-doc round batches of a session's object arrival (the shuffle
    model: each doc's changes in a random order, per-sender reordering
    included, a scheduling stress), split into ``rounds`` batches.  One
    ``random.Random(seed)`` serves every doc, in doc order."""
    rng = random.Random(seed)
    return [interleave_rounds(w, rounds, rng) for w in workloads]
