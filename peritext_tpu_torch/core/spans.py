"""Mark-set resolution and span flattening.

``ops_to_marks`` is the heart of convergence: it maps a *set* of mark
operations (in any order) to the resulting mark map, resolving conflicts by
op-ID comparison, so all replicas agree regardless of delivery order
(reference ``opsToMarks``, src/micromerge.ts:417-495).

Semantics, per mark type (driven by :mod:`peritext_tpu_torch.schema`):

* ``strong``/``em`` — last-writer-wins boolean by max op ID; the key appears in
  the output only when the winner is an addMark.
* ``link`` — last-writer-wins whole value by max op ID.
* ``comment`` — per-id resolution: a comment id is present iff the max-op-ID
  operation carrying that id is an addMark.  Output is id-sorted.

Documented deviations from the reference (which this framework *fixes*; the
reference's own ``traces/`` record divergence in exactly these corners):

* Reference ``opsToMarks`` resolves comment add/remove in set-iteration order
  (insertion order, i.e. application order), which is replica-dependent; we use
  per-id LWW, which is order-independent (src/micromerge.ts:435-449).
* A "removed" link yields ``{"active": false}`` in the reference's cleaned
  output (src/micromerge.ts:489) while removed strong/em are omitted; we omit
  removed links too, and omit empty comment lists, so "no mark" has a single
  representation.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from ..schema import MARK_SPEC
from .types import FormatSpan, MarkMap, Operation


def ops_to_marks(ops: Iterable[Operation]) -> MarkMap:
    """Resolve a set of addMark/removeMark ops into a cleaned mark map."""
    # winners for LWW types: mark_type -> op; comments: id -> op
    lww_winner: Dict[str, Operation] = {}
    comment_winner: Dict[str, Operation] = {}

    for op in ops:
        mt = op.mark_type
        if mt is None:
            continue
        if MARK_SPEC[mt].allow_multiple:
            cid = op.attrs["id"]
            prev = comment_winner.get(cid)
            if prev is None or op.opid > prev.opid:
                comment_winner[cid] = op
        else:
            prev = lww_winner.get(mt)
            if prev is None or op.opid > prev.opid:
                lww_winner[mt] = op

    marks: MarkMap = {}
    for mt, op in lww_winner.items():
        if op.action != "addMark":
            continue
        if mt == "link":
            marks["link"] = {"active": True, "url": op.attrs["url"]}
        else:
            marks[mt] = {"active": True}

    active_ids = sorted(cid for cid, op in comment_winner.items() if op.action == "addMark")
    if active_ids:
        marks["comment"] = [{"id": cid} for cid in active_ids]

    return marks


def add_characters_to_spans(
    characters: List[str], marks: MarkMap, spans: List[FormatSpan]
) -> None:
    """Append characters with the given marks, merging into the last span when
    the formatting is identical (reference ``addCharactersToSpans``, :498)."""
    if not characters:
        return
    if spans and spans[-1]["marks"] == marks:
        spans[-1]["text"] += "".join(characters)
    else:
        spans.append({"marks": dict(marks), "text": "".join(characters)})


def spans_text(spans: Iterable[FormatSpan]) -> str:
    """Plain text of a span list."""
    return "".join(s["text"] for s in spans)


def copy_marks(marks: MarkMap) -> MarkMap:
    """One-level-deep copy of a flattened MarkMap (list-valued comment
    entries copied per item; scalar values passed through)."""
    out: MarkMap = {}
    for k, v in marks.items():
        if isinstance(v, list):
            out[k] = [dict(item) for item in v]
        elif isinstance(v, dict):
            out[k] = dict(v)
        else:
            out[k] = v
    return out


def spans_equal(a: List[FormatSpan], b: List[FormatSpan]) -> bool:
    return a == b


def chars_with_marks_to_spans(
    chars: Iterable[str], mark_maps: Iterable[Optional[MarkMap]]
) -> List[FormatSpan]:
    """Flatten parallel (char, marks) streams into merged spans."""
    spans: List[FormatSpan] = []
    for ch, m in zip(chars, mark_maps):
        add_characters_to_spans([ch], m or {}, spans)
    return spans
