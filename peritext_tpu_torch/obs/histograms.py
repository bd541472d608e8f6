"""Fixed-bucket histograms with percentile readout.

The shape every latency/size metric in the fleet shares: a fixed bucket
table (so merging and exporting never depends on the observation stream),
cumulative or ROLLING-WINDOW counts, and p50/p95/p99 readout computed from
the bucket counts.  Percentiles return the matched bucket's UPPER bound
(the overflow bucket returns the observed max), so a percentile-derived
deadline errs high — the safe direction for a watchdog.

The rolling-window mode is what the supervisor's deadline autotuning rides:
a bounded ring of recent observations whose evictions decrement the bucket
counts, so the percentile always describes the last ``window`` rounds.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

#: latency buckets (seconds): sub-ms dispatches through multi-minute compiles
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
#: size buckets (counts/bytes): frame counts, scheduled changes, op totals
SIZE_BUCKETS = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1_000, 2_500, 5_000,
    10_000, 25_000, 50_000, 100_000, 1_000_000,
)


class Histogram:
    """Thread-safe fixed-bucket histogram.

    ``window=None`` (default) accumulates forever; ``window=N`` keeps the
    counts describing only the most recent N observations (the rolling
    percentile the deadline autotuner needs).
    """

    def __init__(
        self,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
        window: Optional[int] = None,
    ) -> None:
        if window is not None and window <= 0:
            raise ValueError(f"window must be positive or None, got {window}")
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.window = window
        self._lock = threading.Lock()
        # one overflow bucket past the last bound
        self._counts: List[int] = [0] * (len(self.bounds) + 1)
        self._ring: Optional[deque] = deque() if window is not None else None
        self.count = 0
        self.sum = 0.0
        self._max = 0.0

    def _bucket(self, value: float) -> int:
        return bisect_left(self.bounds, value)

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self._bucket(value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.sum += value
            self._max = max(self._max, value)
            if self._ring is not None:
                self._ring.append((idx, value))
                if len(self._ring) > self.window:
                    old_idx, old_value = self._ring.popleft()
                    self._counts[old_idx] -= 1
                    self.count -= 1
                    self.sum -= old_value
                    if old_value >= self._max:
                        self._max = max(
                            (v for _, v in self._ring), default=0.0
                        )

    def percentile(self, q: float) -> float:
        """The q-quantile (0 < q <= 1) as the matched bucket's upper bound;
        the overflow bucket reads as the observed max.  0.0 when empty."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = max(1, math.ceil(q * self.count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= rank:
                    if i < len(self.bounds):
                        return float(self.bounds[i])
                    return float(self._max)
            return float(self._max)

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p95(self) -> float:
        return self.percentile(0.95)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    @property
    def overflow(self) -> int:
        """Observations past the last bound — a saturated top bucket reads
        as "overflowed", never silently as the top bound.  Window-safe: the
        rolling ring decrements this slot on eviction like any other."""
        with self._lock:
            return self._counts[-1]

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """CUMULATIVE counts per upper bound (Prometheus ``le`` semantics);
        the +Inf bucket is ``count``."""
        with self._lock:
            out = []
            cum = 0
            for bound, c in zip(self.bounds, self._counts):
                cum += c
                out.append((bound, cum))
            return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total, mx = self.count, self.sum, self._max
            over = self._counts[-1]
        return {
            "count": count,
            "sum": round(total, 6),
            "max": round(mx, 6),
            "overflow": over,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class HistogramRegistry:
    """Named histograms, created on first observation — the process-wide
    analog of :class:`~.metrics.Counters` for distributions."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hists: Dict[str, Histogram] = {}

    def get(
        self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS_S
    ) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(buckets)
            return h

    def observe(
        self, name: str, value: float,
        buckets: Sequence[float] = LATENCY_BUCKETS_S,
    ) -> None:
        self.get(name, buckets).observe(value)

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        """Observe the enclosed block's wall seconds into ``name``."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - start)

    def items(self) -> List[Tuple[str, Histogram]]:
        with self._lock:
            return sorted(self._hists.items())

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: h.snapshot() for name, h in self.items()}

    def reset(self) -> None:
        with self._lock:
            self._hists.clear()


#: default process-wide histogram registry (exported by health_snapshot
#: and the Prometheus endpoint)
GLOBAL_HISTOGRAMS = HistogramRegistry()
