"""graftlint rule registry — one module per rule, registered by import.

The port carries all seven of the reference's rules.  PTL002-PTL004 lint
its traced programs: the bodies its graph caches run inside a CUDA-graph
capture, the functions marked as capture roots and what they reach
(analysis/astutil.py), as the reference's lint its jit-traced code."""

from __future__ import annotations

from typing import Dict

from ..engine import Rule
from .ptl001_unordered_iteration import UnorderedIterationRule
from .ptl002_tracer_control_flow import TracerControlFlowRule
from .ptl003_host_sync import HostSyncRule
from .ptl004_recompile_hazard import RecompileHazardRule
from .ptl005_broad_except import BroadExceptRule
from .ptl006_nondeterminism import NondeterminismRule
from .ptl007_ragged_bucket_free import RaggedBucketFreeRule

ALL_RULES: Dict[str, Rule] = {
    rule.rule_id: rule
    for rule in (
        UnorderedIterationRule(),
        TracerControlFlowRule(),
        HostSyncRule(),
        RecompileHazardRule(),
        BroadExceptRule(),
        NondeterminismRule(),
        RaggedBucketFreeRule(),
    )
}
