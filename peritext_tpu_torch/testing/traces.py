"""Replay of recorded traces.

The reference repo ships ``traces/*.json`` — failure records from fuzz runs
(reference test/fuzz.ts:16-20), and :func:`~..checkpoint.save_failed_trace`
writes the same shape.  Each contains per-actor change ``queues``:
replayable ``Change`` lists in the reference's JSON wire format.  The stored
final texts are divergence *evidence*, NOT ground truth (the reference's own
replicas disagreed), so replay asserts convergence across replicas and
delivery orders instead of comparing against stored text.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..core.doc import Doc
from ..core.types import Change
from ..parallel.causal import causal_sort


def load_trace_queues(path: str) -> Dict[str, List[Change]]:
    """Parse a recorded trace's per-actor change queues."""
    with open(path) as f:
        data = json.load(f)
    queues = data["queues"] if "queues" in data else data
    return {
        actor: [Change.from_json(c) for c in changes]
        for actor, changes in queues.items()
    }


def replay_queues(queues: Dict[str, List[Change]], actor_id: str = "replayer") -> Doc:
    """Build a fresh replica by applying every queued change in causal order."""
    all_changes = [ch for log in queues.values() for ch in log]
    doc = Doc(actor_id)
    for ch in causal_sort(all_changes):
        doc.apply_change(ch)
    return doc
