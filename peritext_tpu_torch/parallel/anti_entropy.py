"""Per-actor change logs and causal delivery (reference ``test/merge.ts``).

Each actor keeps an append-only log of its own changes; to sync, a replica
diffs vector clocks to find what the peer is missing and applies those
changes in one causal-sorted pass.  This is the part the workload generator
(testing/fuzz.py) needs.
"""

from __future__ import annotations

from typing import Dict, List

from ..core.doc import Doc
from ..core.errors import PeritextError
from ..core.types import Change, Clock, Patch
from .causal import causal_sort


class ChangeStore:
    """Per-actor append-only change logs (any replica state is
    reconstructible by replay)."""

    def __init__(self) -> None:
        self._logs: Dict[str, List[Change]] = {}

    def append(self, change: Change) -> None:
        log = self._logs.setdefault(change.actor, [])
        if change.seq != len(log) + 1:
            raise PeritextError(
                f"Log gap for {change.actor}: have {len(log)}, appending seq {change.seq}"
            )
        log.append(change)

    def log(self, actor: str) -> List[Change]:
        return self._logs.get(actor, [])

    def actors(self) -> List[str]:
        return list(self._logs.keys())

    def clock(self) -> Clock:
        return {actor: len(log) for actor, log in sorted(self._logs.items())}

    def missing_changes(self, source_clock: Clock, target_clock: Clock) -> List[Change]:
        """Changes known to ``source`` but not ``target`` (reference
        getMissingChanges, test/merge.ts:25-38)."""
        changes: List[Change] = []
        for actor, seq in source_clock.items():
            have = target_clock.get(actor, 0)
            if have < seq:
                changes.extend(self._logs.get(actor, [])[have:seq])
        return changes


def apply_changes(doc: Doc, changes: List[Change]) -> List[Patch]:
    """Apply changes delivered in arbitrary order (duplicates and
    already-applied changes tolerated), in one causal-sorted pass."""
    patches: List[Patch] = []
    for change in causal_sort(changes, doc.clock):
        patches.extend(doc.apply_change(change))
    return patches
