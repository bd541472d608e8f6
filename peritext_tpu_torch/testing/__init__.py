"""Workload generators: seeded fuzz change logs and synthetic op streams."""

from .fuzz import generate_markheavy_workload, generate_workload, sample_cursors
from .generate import generate_docs
from .synth import synth_streams

__all__ = [
    "generate_docs",
    "generate_markheavy_workload",
    "generate_workload",
    "sample_cursors",
    "synth_streams",
]
