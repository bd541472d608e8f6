"""Workload generators: seeded fuzz change logs, synthetic op streams and
streaming arrival schedules."""

from .arrival import build_arrival, interleave_rounds
from .fuzz import generate_markheavy_workload, generate_workload, sample_cursors
from .generate import generate_docs
from .synth import synth_streams

__all__ = [
    "build_arrival",
    "generate_docs",
    "generate_markheavy_workload",
    "generate_workload",
    "interleave_rounds",
    "sample_cursors",
    "synth_streams",
]
