"""The mark schema the reference's CRDT reads: per mark type whether a
span's end grows over text inserted at its right edge, and whether
concurrent marks form a set (comments) or resolve last-writer-wins.

Frozen from ``peritext_tpu_torch/schema.py`` at commit a8ed934 (its
presentation half, which the CRDT never reads, left out).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class MarkSchema:
    """Behavior of one mark type."""

    inclusive: bool
    allow_multiple: bool
    attr_keys: Tuple[str, ...] = field(default=())


MARK_SPEC: Dict[str, MarkSchema] = {
    "strong": MarkSchema(inclusive=True, allow_multiple=False),
    "em": MarkSchema(inclusive=True, allow_multiple=False),
    "comment": MarkSchema(inclusive=False, allow_multiple=True, attr_keys=("id",)),
    "link": MarkSchema(inclusive=False, allow_multiple=False, attr_keys=("url",)),
}

#: stable order of the mark types (the digest's type salts index it)
ALL_MARKS: Tuple[str, ...] = ("strong", "em", "comment", "link")

MARK_INDEX: Dict[str, int] = {name: i for i, name in enumerate(ALL_MARKS)}


def is_mark_type(s: str) -> bool:
    return s in MARK_SPEC
