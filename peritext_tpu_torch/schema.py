"""Declarative mark schema.

Mirrors the semantics the reference derives from its ProseMirror ``markSpec``
(reference ``src/schema.ts:45-96``): per-mark-type behavior flags that the CRDT
core consults.  The CRDT reads only:

* ``inclusive`` — whether the *end* of a span grows to absorb characters
  inserted at its right boundary (``src/micromerge.ts:651``).  Span starts never
  grow (``:650``).
* ``allow_multiple`` — whether concurrent marks of this type form a set
  (comments) or resolve last-writer-wins (strong/em/link)
  (``src/micromerge.ts:403-405``).

For the device path each mark type is interned to a stable small integer
(``MARK_INDEX``).  The presentation half of the reference package's schema
(DOM rendering, exclusion sets) is not part of the merge and is not copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class MarkSchema:
    """Behavior of one mark type."""

    #: Does the span end grow to include text inserted at its right edge?
    inclusive: bool
    #: Multiple concurrent values coexist (set semantics) vs last-writer-wins.
    allow_multiple: bool
    #: Names of data attributes carried by the mark ("url", "id", ...).
    attr_keys: Tuple[str, ...] = field(default=())


#: The default schema, matching the reference's four mark types.
MARK_SPEC: Dict[str, MarkSchema] = {
    "strong": MarkSchema(inclusive=True, allow_multiple=False),
    "em": MarkSchema(inclusive=True, allow_multiple=False),
    "comment": MarkSchema(inclusive=False, allow_multiple=True, attr_keys=("id",)),
    "link": MarkSchema(inclusive=False, allow_multiple=False, attr_keys=("url",)),
}

#: Stable ordering for device-side integer encoding of mark types.
ALL_MARKS: Tuple[str, ...] = ("strong", "em", "comment", "link")

MARK_INDEX: Dict[str, int] = {name: i for i, name in enumerate(ALL_MARKS)}


def is_mark_type(s: str) -> bool:
    return s in MARK_SPEC
