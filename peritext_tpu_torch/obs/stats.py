"""Per-merge / per-round observability report, and the stage timer that
fills it.

Stage times are host wall-clock seconds.  A stage that ran on the card is
closed with ``torch.cuda.synchronize``, so its time includes the device
work it queued rather than only the enqueue.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch


@dataclass
class MergeStats:
    """Per-merge observability (attached to ``api.batch.MergeReport``, and,
    per streaming commit, to ``StreamingMerge.last_round_stats``)."""

    docs: int = 0
    device_docs: int = 0
    fallback_docs: int = 0
    device_ops: int = 0
    fallback_ops: int = 0
    encode_seconds: float = 0.0
    apply_seconds: float = 0.0
    resolve_seconds: float = 0.0
    decode_seconds: float = 0.0
    #: real ops / padded op-stream capacity across the batch (0..1)
    padding_efficiency: float = 0.0
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def total_seconds(self) -> float:
        return (
            self.encode_seconds
            + self.apply_seconds
            + self.resolve_seconds
            + self.decode_seconds
        )

    @property
    def device_ops_per_sec(self) -> float:
        wall = self.apply_seconds
        return self.device_ops / wall if wall > 0 else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "docs": self.docs,
            "device_docs": self.device_docs,
            "fallback_docs": self.fallback_docs,
            "device_ops": self.device_ops,
            "fallback_ops": self.fallback_ops,
            "encode_seconds": round(self.encode_seconds, 6),
            "apply_seconds": round(self.apply_seconds, 6),
            "resolve_seconds": round(self.resolve_seconds, 6),
            "decode_seconds": round(self.decode_seconds, 6),
            "padding_efficiency": round(self.padding_efficiency, 4),
            "device_ops_per_sec": round(self.device_ops_per_sec, 1),
            **self.extras,
        }


@contextmanager
def stage_timer(stats: MergeStats, name: str,
                device: Optional[torch.device] = None) -> Iterator[None]:
    """Time the enclosed stage into ``stats.<name>`` (seconds).  With a CUDA
    ``device``, the stage ends with a synchronize of that device."""
    t0 = time.perf_counter()
    yield
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    setattr(stats, name, time.perf_counter() - t0)
