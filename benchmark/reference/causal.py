# Frozen copy of peritext_tpu_torch/parallel/causal.py at commit a8ed934
# (imports made local to this folder): part of the benchmark's plain reference.
"""Host-side causal scheduling.

The device kernel applies a *linear*, padded op stream per document; it must
never see a change whose dependencies haven't been applied.  This module
linearizes an arbitrary set of changes into a deterministic admissible order
(and, for streaming, into causal waves).
Determinism matters only for reproducibility: any admissible order converges,
because op application is commutative across causally-concurrent changes.

The order is the smallest ready ``(actor, seq)`` first, through a heap.  This
pure-Python scheduler is the only one the object path runs: the package's C++
``pt_causal_schedule`` gives the same order, but with its array setup it did
not beat the heap on the streaming session's sets
(``scripts/torch_causal_pairs.py``).
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Optional, Tuple

from .errors import PeritextError
from .types import Change, Clock


def _admissible(change: Change, clock: Clock) -> bool:
    if change.seq != clock.get(change.actor, 0) + 1:
        return False
    return all(clock.get(actor, 0) >= dep for actor, dep in (change.deps or {}).items())


def causal_schedule(
    changes: Iterable[Change], base_clock: Optional[Clock] = None
) -> Tuple[List[Change], List[Change]]:
    """Schedule as many changes as causally possible.

    Returns ``(ordered, stuck)``: ``ordered`` is a deterministic admissible
    order (smallest (actor, seq) among ready first); ``stuck`` are changes
    whose dependencies are absent from the set (e.g. lost in transit).
    """
    clock: Clock = dict(base_clock or {})
    pending: Dict[Tuple[str, int], Change] = {}
    for ch in changes:
        key = (ch.actor, ch.seq)
        if key in pending:
            continue  # duplicate delivery
        if ch.seq <= clock.get(ch.actor, 0):
            continue  # already incorporated
        pending[key] = ch

    # Reverse index: blocker (actor, seq) -> keys waiting on it.  A change
    # waits on its per-actor predecessor and on each unsatisfied dep; since
    # seqs apply in order, clock[a] reaches d exactly when (a, d) is applied.
    waiters: Dict[Tuple[str, int], List[Tuple[str, int]]] = {}
    for key, ch in pending.items():
        if ch.seq > 1 and clock.get(ch.actor, 0) < ch.seq - 1:
            waiters.setdefault((ch.actor, ch.seq - 1), []).append(key)
        for actor, dep in (ch.deps or {}).items():
            if clock.get(actor, 0) < dep and actor != ch.actor:
                waiters.setdefault((actor, dep), []).append(key)

    ready: List[Tuple[str, int]] = [k for k, c in pending.items() if _admissible(c, clock)]
    heapq.heapify(ready)
    out: List[Change] = []

    while ready:
        key = heapq.heappop(ready)
        ch = pending.pop(key, None)
        if ch is None:
            continue  # woken more than once
        out.append(ch)
        clock[ch.actor] = ch.seq
        for waiter in waiters.pop(key, ()):
            cand = pending.get(waiter)
            if cand is not None and _admissible(cand, clock):
                heapq.heappush(ready, waiter)

    stuck = [pending[k] for k in sorted(pending.keys())]
    return out, stuck


def causal_sort(
    changes: Iterable[Change], base_clock: Optional[Clock] = None
) -> List[Change]:
    """Order changes so every change's deps precede it; raises if the set has
    a causal gap relative to ``base_clock`` (strict variant of
    :func:`causal_schedule`)."""
    ordered, stuck = causal_schedule(changes, base_clock)
    if stuck:
        missing = sorted((c.actor, c.seq) for c in stuck)[:5]
        raise PeritextError(f"Causal gap: cannot schedule changes {missing}")
    return ordered


def causal_waves(
    changes: Iterable[Change], base_clock: Optional[Clock] = None
) -> List[List[Change]]:
    """Group changes into waves: wave k contains changes admissible once waves
    < k are applied.  Within a wave all changes are causally concurrent (up to
    per-actor seq chains), which is the unit a streaming pipeline can overlap."""
    clock: Clock = dict(base_clock or {})
    seen: set = set()
    remaining: List[Change] = []
    for ch in changes:
        key = (ch.actor, ch.seq)
        if key in seen or ch.seq <= clock.get(ch.actor, 0):
            continue  # duplicate or already incorporated
        seen.add(key)
        remaining.append(ch)
    waves: List[List[Change]] = []
    while remaining:
        wave = [ch for ch in remaining if _admissible(ch, clock)]
        if not wave:
            raise PeritextError("Causal gap: no admissible changes remain")
        wave.sort(key=lambda c: (c.actor, c.seq))
        for ch in wave:
            clock[ch.actor] = ch.seq
        applied = {(c.actor, c.seq) for c in wave}
        remaining = [c for c in remaining if (c.actor, c.seq) not in applied]
        waves.append(wave)
    return waves
