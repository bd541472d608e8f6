"""The one power-of-two width spelling.

The bucketed device paths (the paged layout's page-count groups and row
buckets) round a dynamic count up to a power of two, so groups of similar
size share widths.  The ragged layout (ops/ragged.py, store/ragged.py)
rounds nothing: its per-doc true counts reach the device as data.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    w = 1
    while w < n:
        w *= 2
    return w
