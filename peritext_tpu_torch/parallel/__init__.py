"""Host-side replication helpers (causal scheduling, change stores), the
convergence digests and the streaming session."""

from .anti_entropy import ChangeStore, apply_changes
from .causal import causal_schedule, causal_sort
from .streaming import StreamingMerge

__all__ = ["ChangeStore", "StreamingMerge", "apply_changes", "causal_schedule", "causal_sort"]
