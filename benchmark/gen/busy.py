"""The card's busy time: the union of its operations' intervals, so that
operations overlapping on two streams count once; and the gaps between.

The arithmetic follows ``peritext_tpu_torch/testing/devtime.py`` at commit
a8ed934 (``device_events``: a profiler's device events less the device-side
copies of user annotations), with the sum there replaced by a union.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of ``[lo, hi]`` between the union's pieces."""
    out, at = [], lo
    for a, b in merge(intervals):
        if b <= lo or a >= hi:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out
