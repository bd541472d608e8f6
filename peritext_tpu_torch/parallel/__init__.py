"""Host-side replication helpers: causal scheduling and change stores."""

from .anti_entropy import ChangeStore, apply_changes
from .causal import causal_schedule, causal_sort

__all__ = ["ChangeStore", "apply_changes", "causal_schedule", "causal_sort"]
