"""Per-sender FIFO arrival: how a transport delivers one doc's changes.

Frozen copy of ``fifo_order`` in ``peritext_tpu_torch/testing/arrival.py``
at commit a8ed934: each sender's log in its own order, the next change
taken from a uniformly random sender that still has one.
"""

from __future__ import annotations

import random
from typing import Dict, List

from ..reference.types import Change


def fifo_order(workload: Dict[str, List[Change]], rng: random.Random) -> List[Change]:
    logs = {a: list(log) for a, log in workload.items()}
    actors = sorted(logs)
    changes = []
    while True:
        live = [a for a in actors if logs[a]]
        if not live:
            return changes
        changes.append(logs[rng.choice(live)].pop(0))
