"""Naive patch-replay oracle.

Accumulates a stream of incremental ``Patch`` dicts into a per-character model
and re-flattens it to format spans — the reference's "dumb model vs. optimized
implementation" differential-testing pattern (reference
``test/accumulatePatches.ts:8-80``).  Used to assert that the incremental
patch path converges to the same document as the batch read path.

Deviation from the reference (a fix, documented): a removeMark patch for a
comment removes only the comment id carried in ``attrs``, rather than wiping
every comment at the position (the reference's accumulator deletes the whole
markType entry because its removeMark patches carry no attrs, making comment
removal unreplayable; reference test/accumulatePatches.ts:54-58).
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..core.spans import add_characters_to_spans, copy_marks as _copy_marks
from ..core.types import FormatSpan, Patch


def accumulate_patches(patches: List[Patch]) -> List[FormatSpan]:
    # Parallel per-character metadata: {"character": str, "marks": {...}}
    metadata: List[Dict[str, Any]] = []

    for patch in patches:
        if list(patch["path"]) != ["text"]:
            raise ValueError("accumulate_patches only supports the 'text' path")
        action = patch["action"]

        if action == "insert":
            for value_index, character in enumerate(patch["values"]):
                metadata.insert(
                    patch["index"] + value_index,
                    {"character": character, "marks": _copy_marks(patch["marks"])},
                )
        elif action == "delete":
            del metadata[patch["index"] : patch["index"] + patch["count"]]
        elif action == "addMark":
            for index in range(patch["startIndex"], patch["endIndex"]):
                marks = metadata[index]["marks"]
                if patch["markType"] == "comment":
                    comments = marks.get("comment", [])
                    cid = patch["attrs"]["id"]
                    if not any(c["id"] == cid for c in comments):
                        marks["comment"] = sorted(
                            comments + [{"id": cid}], key=lambda c: c["id"]
                        )
                else:
                    marks[patch["markType"]] = {
                        "active": True,
                        **{k: v for k, v in patch.get("attrs", {}).items()},
                    }
        elif action == "removeMark":
            for index in range(patch["startIndex"], patch["endIndex"]):
                marks = metadata[index]["marks"]
                if patch["markType"] == "comment" and "attrs" in patch:
                    cid = patch["attrs"]["id"]
                    comments = [c for c in marks.get("comment", []) if c["id"] != cid]
                    if comments:
                        marks["comment"] = comments
                    else:
                        marks.pop("comment", None)
                else:
                    marks.pop(patch["markType"], None)
        elif action == "makeList":
            pass
        else:
            raise ValueError(f"Unknown patch action: {action}")

    spans: List[FormatSpan] = []
    for meta in metadata:
        add_characters_to_spans([meta["character"]], meta["marks"], spans)
    return spans


