"""Vector-clock anti-entropy and causal delivery (reference ``test/merge.ts``).

Each actor keeps an append-only log of its own changes; to sync, a replica
diffs vector clocks to find what the peer is missing, ships those changes,
and the receiver applies them in one causal-sorted pass that tolerates
arbitrary delivery reordering.  The store's prefix digests make the
store digest at any frontier O(actors), which the multihost frontier
exchange carries as its divergence probe.
"""

from __future__ import annotations

import json
import zlib
from typing import Dict, List, Optional

from ..core.doc import Doc
from ..core.errors import PeritextError
from ..core.types import Change, Clock, Patch
from ..obs import GLOBAL_COUNTERS, GLOBAL_TRACER
from .causal import causal_sort


def change_digest(change: Change) -> int:
    """Stable uint32 content hash of ONE change — identical across hosts
    for identical change content (canonical sorted-key JSON through CRC32,
    avalanched so near-identical changes don't cancel in the sum)."""
    raw = json.dumps(
        change.to_json(), sort_keys=True, separators=(",", ":")
    ).encode("utf-8")
    x = zlib.crc32(raw) & 0xFFFFFFFF
    # the digests' avalanche (mesh._av_host): sums of raw CRCs of
    # related payloads correlate; a multiply + xor-shift decorrelates them
    x = (x * 2246822519) & 0xFFFFFFFF
    return x ^ (x >> 15)


class ChangeStore:
    """Per-actor append-only change logs (the durable source of truth; any
    replica state is reconstructible by replay — event sourcing).

    The store also maintains per-actor PREFIX DIGESTS: ``_digests[actor][i]``
    is the commutative uint32 sum of the first ``i`` changes' content
    hashes, so :meth:`digest` — the store digest at an arbitrary frontier —
    is O(actors), cheap enough to attach to every anti-entropy frontier.
    Two stores with EQUAL frontiers hold the same change set iff their
    digests match (probabilistic, 32 bits), which is what turns "same
    frontier, different digest" into a detectable divergence incident
    (:mod:`~..obs.convergence`) instead of silent split-brain."""

    def __init__(self) -> None:
        self._logs: Dict[str, List[Change]] = {}
        self._digests: Dict[str, List[int]] = {}

    def append(self, change: Change) -> None:
        log = self._logs.setdefault(change.actor, [])
        if change.seq != len(log) + 1:
            raise PeritextError(
                f"Log gap for {change.actor}: have {len(log)}, appending seq {change.seq}"
            )
        log.append(change)
        prefix = self._digests.setdefault(change.actor, [0])
        prefix.append((prefix[-1] + change_digest(change)) & 0xFFFFFFFF)

    def digest(self, clock: Optional[Clock] = None) -> int:
        """Commutative uint32 digest of the change set at ``clock`` (default
        this store's own frontier): the sum over actors of the per-actor
        prefix digest at ``min(clock[actor], len(log))``.  Order-independent
        across actors by construction, so two replicas that merged the same
        changes in any order digest equal."""
        if clock is None:
            clock = self.clock()
        acc = 0
        for actor, seq in clock.items():
            prefix = self._digests.get(actor)
            if prefix is None or seq <= 0:
                continue
            acc = (acc + prefix[min(int(seq), len(prefix) - 1)]) & 0xFFFFFFFF
        return acc

    def log(self, actor: str) -> List[Change]:
        return self._logs.get(actor, [])

    def actors(self) -> List[str]:
        return list(self._logs.keys())

    def clock(self) -> Clock:
        # sorted so the clock's key order (which reaches wire frames) is a
        # function of the actor set, not of arrival order
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


def get_missing_changes(source: Doc, target: Doc, store: ChangeStore) -> List[Change]:
    return store.missing_changes(source.clock, target.clock)


def apply_changes(doc: Doc, changes: List[Change]) -> List[Patch]:
    """Apply changes delivered in arbitrary order (with duplicates and
    already-applied changes tolerated), in one causal-sorted pass.

    Replaces the reference's catch-and-requeue retry loop (test/merge.ts:4-23)
    — O(n log n) instead of retry-until-fixpoint, and a causal gap in the
    input raises immediately with the stuck changes named instead of spinning
    to an iteration cap."""
    patches: List[Patch] = []
    for change in causal_sort(changes, doc.clock):
        patches.extend(doc.apply_change(change))
    return patches


def sync(left: Doc, right: Doc, store: ChangeStore,
         monitor=None) -> Dict[str, List[Patch]]:
    """Bidirectional anti-entropy between two replicas; returns patches each
    side produced.  With a :class:`~..obs.convergence.ConvergenceMonitor`,
    the pre-sync frontiers are ingested as lag watermarks (peer names
    ``left``/``right``) — the in-process analog of the multihost frontier
    hook, so a local two-replica session shows up in the same fleet view."""
    with GLOBAL_TRACER.span("anti-entropy.local-sync"):
        if monitor is not None:
            left_digest = store.digest(left.clock)
            right_digest = store.digest(right.clock)
            monitor.observe_frontier(
                "right", left.clock, right.clock,
                local_digest=left_digest, peer_digest=right_digest,
            )
            monitor.observe_frontier(
                "left", right.clock, left.clock,
                local_digest=right_digest, peer_digest=left_digest,
            )
        to_right = store.missing_changes(left.clock, right.clock)
        to_left = store.missing_changes(right.clock, left.clock)
        out = {
            "right": apply_changes(right, to_right),
            "left": apply_changes(left, to_left),
        }
        if monitor is not None:
            monitor.observe_success("right", pulled=len(to_left),
                                    pushed=len(to_right))
            monitor.observe_success("left", pulled=len(to_right),
                                    pushed=len(to_left))
    GLOBAL_COUNTERS.add("transport.local_syncs")
    GLOBAL_COUNTERS.add("transport.local_sync_changes", len(to_right) + len(to_left))
    return out
