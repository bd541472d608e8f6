"""Host-side replication helpers (causal scheduling, change stores), the
convergence digests, the streaming session and its supervisor."""

from .anti_entropy import ChangeStore, apply_changes
from .causal import causal_schedule, causal_sort
from .streaming import StreamingMerge
from .supervisor import GuardedSession

__all__ = ["ChangeStore", "GuardedSession", "StreamingMerge", "apply_changes", "causal_schedule",
           "causal_sort"]
