"""graftlint rule registry — one module per rule, registered by import.

The port carries PTL001, PTL005, PTL006 and PTL007.  The reference
package's PTL002-PTL004 (tracer control flow, host syncs and recompile
hazards inside jit-traced code) have nothing to lint here: torch traces and
compiles nothing on this path."""

from __future__ import annotations

from typing import Dict

from ..engine import Rule
from .ptl001_unordered_iteration import UnorderedIterationRule
from .ptl005_broad_except import BroadExceptRule
from .ptl006_nondeterminism import NondeterminismRule
from .ptl007_ragged_bucket_free import RaggedBucketFreeRule

ALL_RULES: Dict[str, Rule] = {
    rule.rule_id: rule
    for rule in (
        UnorderedIterationRule(),
        BroadExceptRule(),
        NondeterminismRule(),
        RaggedBucketFreeRule(),
    )
}
