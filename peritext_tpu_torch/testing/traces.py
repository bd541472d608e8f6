"""Replay of recorded traces.

The reference repo ships ``traces/*.json`` — failure records from fuzz runs
(reference test/fuzz.ts:16-20), and :func:`~..checkpoint.save_failed_trace`
writes the same shape.  Each contains per-actor change ``queues``:
replayable ``Change`` lists in the reference's JSON wire format.  The stored
final texts are divergence *evidence*, NOT ground truth (the reference's own
replicas disagreed), so replay asserts convergence across replicas and
delivery orders instead of comparing against stored text.

:func:`available_traces` lists a directory's traces.  Its default is the
checkout's own ``traces/`` directory: code of this repo reads nothing
outside its checkout, so a copy of the TypeScript repo's ``traces/`` goes
there, or its path is passed.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from ..core.doc import Doc
from ..core.types import Change
from ..parallel.causal import causal_sort

#: the checkout's ``traces/`` directory (absent unless a copy is put there)
REFERENCE_TRACES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "traces",
)


def load_trace_queues(path: str) -> Dict[str, List[Change]]:
    """Parse a recorded trace's per-actor change queues."""
    with open(path) as f:
        data = json.load(f)
    queues = data["queues"] if "queues" in data else data
    return {
        actor: [Change.from_json(c) for c in changes]
        for actor, changes in queues.items()
    }


def available_traces(directory: str = REFERENCE_TRACES_DIR) -> List[str]:
    """The ``*.json`` traces in ``directory``, sorted; none when it is
    absent."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        os.path.join(directory, name)
        for name in os.listdir(directory)
        if name.endswith(".json")
    )


def replay_queues(queues: Dict[str, List[Change]], actor_id: str = "replayer") -> Doc:
    """Build a fresh replica by applying every queued change in causal order."""
    all_changes = [ch for log in queues.values() for ch in log]
    doc = Doc(actor_id)
    for ch in causal_sort(all_changes):
        doc.apply_change(ch)
    return doc
