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
(``MARK_INDEX``).  The presentation half (exclusion sets, DOM rendering) is
read by the editor bridge only (``bridge/model.py``, ``bridge/pm.py``).
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
    #: PRESENTATION half of the reference markSpec (src/schema.ts:45-96):
    #: which mark types adding this one replaces in a set.  ``None`` is
    #: ProseMirror's default — a mark excludes its own type (same-type add
    #: replaces); ``()`` is schema.ts's ``excludes: ""`` on comments —
    #: nothing is excluded, so same-type marks coexist (keyed by id).
    excludes: "Tuple[str, ...] | None" = None
    #: DOM rendering tag for :func:`mark_to_dom` (markSpec ``toDOM``).
    dom_tag: str = "span"


#: The default schema, matching the reference's four mark types.
MARK_SPEC: Dict[str, MarkSchema] = {
    "strong": MarkSchema(inclusive=True, allow_multiple=False, dom_tag="strong"),
    "em": MarkSchema(inclusive=True, allow_multiple=False, dom_tag="em"),
    "comment": MarkSchema(inclusive=False, allow_multiple=True,
                          attr_keys=("id",), excludes=(), dom_tag="span"),
    "link": MarkSchema(inclusive=False, allow_multiple=False,
                       attr_keys=("url",), dom_tag="a"),
}

#: Stable ordering for device-side integer encoding of mark types.
ALL_MARKS: Tuple[str, ...] = ("strong", "em", "comment", "link")

MARK_INDEX: Dict[str, int] = {name: i for i, name in enumerate(ALL_MARKS)}


def is_mark_type(s: str) -> bool:
    return s in MARK_SPEC


def excludes_of(mark_type: str) -> Tuple[str, ...]:
    """Resolved exclusion set: ProseMirror's ``Mark.addToSet`` consults the
    schema's ``excludes`` to decide replacement; the default (None) is the
    mark's own type (reference markSpec relies on it for strong/em/link,
    and overrides it to "" for comments, src/schema.ts:77)."""
    spec = MARK_SPEC.get(mark_type)
    if spec is None:
        return (mark_type,)
    return (mark_type,) if spec.excludes is None else spec.excludes


def _link_color(url: str) -> str:
    """Deterministic per-url color (stand-in for the reference demo's
    colorHash, src/schema.ts:86 — any stable mapping works; peers render
    the same url the same color), from the interning content hash."""
    from .utils.interning import content_hash32

    return f"#{(content_hash32(url) >> 8) & 0xFFFFFF:06x}"


def mark_to_dom(mark_type: str, attrs=None):
    """DOMOutputSpec-shaped rendering of one mark (markSpec ``toDOM``,
    reference src/schema.ts:45-96): ``["strong"]``, ``["em"]``,
    ``["a", {href, style}]``, ``["span", {data-mark, data-comment-id}]``.
    Tags come from the spec's ``dom_tag``; the attr shapes mirror the
    reference's per-type toDOM closures."""
    attrs = attrs or {}
    spec = MARK_SPEC.get(mark_type)
    tag = spec.dom_tag if spec else "span"
    if mark_type == "link":
        url = attrs.get("url") or ""
        return [tag, {"href": url, "style": f"color: {_link_color(url)};"}]
    if mark_type == "comment":
        return [tag, {"data-mark": "comment",
                      "data-comment-id": attrs.get("id")}]
    return [tag]
