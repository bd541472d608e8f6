"""Headless rich-text editor document model.

The reference integrates with ProseMirror: its editor document is
``doc(paragraph(text))`` and edits arrive as ProseMirror steps
(``ReplaceStep`` / ``AddMarkStep`` / ``RemoveMarkStep``, reference
``src/bridge.ts:424-528``).  This framework is headless, so this module
supplies the equivalent editor-side document model and step algebra that the
bridge translates to and from CRDT input operations and patches.

Position convention (kept deliberately identical to the reference): editor
positions are **1-based** — position 0 is the paragraph-open token, so editor
position ``p`` addresses the character at CRDT index ``p - 1``
(``contentPosFromProsemirrorPos``, reference ``src/bridge.ts:360-371``).  The
bridge is the only place the ±1 shift happens.

Mark application follows ProseMirror ``Mark.addToSet`` semantics as the
reference relies on them: non-``allow_multiple`` marks replace an existing
mark of the same type; ``allow_multiple`` marks (comments) form a set keyed by
their ``id`` attr.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

from ..core.spans import add_characters_to_spans
from ..core.types import FormatSpan, MarkMap
from ..schema import MARK_SPEC, excludes_of


def _add_mark_to_map(marks: MarkMap, mark_type: str, attrs: Optional[Dict[str, Any]]) -> MarkMap:
    out = dict(marks)
    # PM Mark.addToSet consults the schema's excludes (presentation half of
    # the reference markSpec), in BOTH directions: an existing mark that
    # excludes the new type rejects the add outright, and the new mark
    # evicts the types it excludes.  The default excludes only the mark's
    # own type (same-type replace below); comments exclude nothing.
    for existing in out:
        if existing != mark_type and mark_type in excludes_of(existing):
            return out
    for excluded in excludes_of(mark_type):
        if excluded != mark_type:
            out.pop(excluded, None)
    spec = MARK_SPEC.get(mark_type)
    if spec is not None and spec.allow_multiple:
        entries = [dict(e) for e in out.get(mark_type, [])]
        entry = dict(attrs or {})
        if not any(e.get("id") == entry.get("id") for e in entries):
            entries.append(entry)
        out[mark_type] = sorted(entries, key=lambda e: str(e.get("id")))
    elif mark_type == "link":
        out[mark_type] = {"active": True, "url": (attrs or {}).get("url")}
    else:
        out[mark_type] = {"active": True}
    return out


def _remove_mark_from_map(
    marks: MarkMap, mark_type: str, attrs: Optional[Dict[str, Any]]
) -> MarkMap:
    out = dict(marks)
    spec = MARK_SPEC.get(mark_type)
    if spec is not None and spec.allow_multiple:
        wanted_id = (attrs or {}).get("id")
        entries = [e for e in out.get(mark_type, []) if wanted_id is not None and e.get("id") != wanted_id]
        if entries:
            out[mark_type] = entries
        else:
            out.pop(mark_type, None)
    else:
        out.pop(mark_type, None)
    return out


class EditorDoc:
    """The editor's view of one document: a single paragraph of marked text.

    Stored as parallel per-character arrays (char + mark map), which is the
    natural incremental-patch target; :meth:`spans` flattens to the same
    ``FormatSpan`` shape the CRDT read path produces, so tests can assert the
    incremental view equals the full CRDT render byte for byte.
    """

    def __init__(self, chars: Optional[List[str]] = None, marks: Optional[List[MarkMap]] = None):
        self.chars: List[str] = list(chars or [])
        self.marks: List[MarkMap] = [dict(m) for m in (marks or [])]
        assert len(self.chars) == len(self.marks)

    # -- queries -----------------------------------------------------------

    @property
    def text(self) -> str:
        return "".join(self.chars)

    def __len__(self) -> int:
        return len(self.chars)

    @property
    def size(self) -> int:
        """Editor-coordinate size: content length + the 2 paragraph tokens."""
        return len(self.chars) + 2

    def spans(self) -> List[FormatSpan]:
        out: List[FormatSpan] = []
        for ch, m in zip(self.chars, self.marks):
            add_characters_to_spans([ch], m, out)
        return out

    def copy(self) -> "EditorDoc":
        return EditorDoc(self.chars, self.marks)

    # -- content-index mutations (0-based; the bridge handles the ±1) ------

    def insert_at(self, index: int, text: str, marks: Optional[MarkMap] = None) -> None:
        if not 0 <= index <= len(self.chars):
            raise IndexError(f"insert index {index} out of bounds 0..{len(self.chars)}")
        mm = dict(marks or {})
        self.chars[index:index] = list(text)
        self.marks[index:index] = [dict(mm) for _ in text]

    def delete_at(self, index: int, count: int) -> None:
        if count < 0 or not 0 <= index <= len(self.chars) - count:
            raise IndexError(f"delete [{index}, {index + count}) out of bounds")
        del self.chars[index : index + count]
        del self.marks[index : index + count]

    def add_mark_at(
        self, start: int, end: int, mark_type: str, attrs: Optional[Dict[str, Any]] = None
    ) -> None:
        for i in range(max(start, 0), min(end, len(self.chars))):
            self.marks[i] = _add_mark_to_map(self.marks[i], mark_type, attrs)

    def remove_mark_at(
        self, start: int, end: int, mark_type: str, attrs: Optional[Dict[str, Any]] = None
    ) -> None:
        for i in range(max(start, 0), min(end, len(self.chars))):
            self.marks[i] = _remove_mark_from_map(self.marks[i], mark_type, attrs)

    def reset(self) -> None:
        self.chars, self.marks = [], []

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, EditorDoc)
            and self.chars == other.chars
            and self.marks == other.marks
        )

    def __repr__(self) -> str:
        return f"EditorDoc({self.text!r})"


# ---------------------------------------------------------------------------
# Steps (the editor-side analogs of the three ProseMirror step types the
# reference translates, src/bridge.ts:424-528) and transactions.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ReplaceStep:
    """Replace editor range [from_pos, to_pos) with ``text``.

    Insert = zero-width range; delete = empty text; replace = both (the
    reference translates that as delete-then-insert, src/bridge.ts:428-444).
    """

    from_pos: int
    to_pos: int
    text: str = ""
    marks: Optional[MarkMap] = None

    def apply(self, doc: EditorDoc) -> None:
        index = self.from_pos - 1
        doc.delete_at(index, self.to_pos - self.from_pos)
        if self.text:
            doc.insert_at(index, self.text, self.marks)


@dataclass(frozen=True)
class AddMarkStep:
    from_pos: int
    to_pos: int
    mark_type: str
    attrs: Optional[Dict[str, Any]] = None

    def apply(self, doc: EditorDoc) -> None:
        doc.add_mark_at(self.from_pos - 1, self.to_pos - 1, self.mark_type, self.attrs)


@dataclass(frozen=True)
class RemoveMarkStep:
    from_pos: int
    to_pos: int
    mark_type: str
    attrs: Optional[Dict[str, Any]] = None

    def apply(self, doc: EditorDoc) -> None:
        doc.remove_mark_at(self.from_pos - 1, self.to_pos - 1, self.mark_type, self.attrs)


@dataclass(frozen=True)
class ResetStep:
    """Clear the document (the editor-side effect of a ``makeList`` patch —
    the reference re-renders the whole doc in that case)."""

    def apply(self, doc: EditorDoc) -> None:
        doc.reset()


Step = Union[ReplaceStep, AddMarkStep, RemoveMarkStep, ResetStep]


@dataclass
class Transaction:
    """An ordered batch of steps (the editor-side unit the bridge converts)."""

    steps: List[Step] = field(default_factory=list)

    # chainable helpers (mirroring the PM Transaction API shape)
    def replace(self, from_pos: int, to_pos: int, text: str = "", marks: Optional[MarkMap] = None) -> "Transaction":
        self.steps.append(ReplaceStep(from_pos, to_pos, text, marks))
        return self

    def insert_text(self, pos: int, text: str, marks: Optional[MarkMap] = None) -> "Transaction":
        return self.replace(pos, pos, text, marks)

    def delete(self, from_pos: int, to_pos: int) -> "Transaction":
        return self.replace(from_pos, to_pos, "")

    def add_mark(self, from_pos: int, to_pos: int, mark_type: str, attrs=None) -> "Transaction":
        self.steps.append(AddMarkStep(from_pos, to_pos, mark_type, attrs))
        return self

    def remove_mark(self, from_pos: int, to_pos: int, mark_type: str, attrs=None) -> "Transaction":
        self.steps.append(RemoveMarkStep(from_pos, to_pos, mark_type, attrs))
        return self

    def apply_to(self, doc: EditorDoc) -> EditorDoc:
        for step in self.steps:
            step.apply(doc)
        return doc
