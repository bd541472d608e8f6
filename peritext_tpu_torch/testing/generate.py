"""Seed-document generation for tests and workloads
(reference ``test/generateDocs.ts:11-42``)."""

from __future__ import annotations

from typing import List, Tuple

from ..core.doc import Doc
from ..core.types import Change, Patch

DEFAULT_TEXT = "The Peritext editor"


def generate_docs(
    text: str = DEFAULT_TEXT, count: int = 2
) -> Tuple[List[Doc], List[List[Patch]], Change]:
    """Create ``count`` replicas sharing one origin change: doc1 makes the text
    list and inserts ``text``; the rest apply that change."""
    docs = [Doc(f"doc{i + 1}") for i in range(count)]
    patches: List[List[Patch]] = [[] for _ in range(count)]

    initial_change, initial_patches = docs[0].change(
        [
            {"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list(text)},
        ]
    )
    patches[0] = initial_patches
    for i in range(1, count):
        patches[i] = docs[i].apply_change(initial_change)
    return docs, patches, initial_change
