"""User-facing entry: the batched merge."""

from .batch import DocBatch, MergeReport, Workload, oracle_merge

__all__ = ["DocBatch", "MergeReport", "Workload", "oracle_merge"]
