"""ProseMirror wire-format interop for the editor bridge.

The reference's L2 is a live ProseMirror plugin (``src/bridge.ts:204-347``)
wired to a real browser view; its edits arrive as ``prosemirror-transform``
steps and its document is ``doc(paragraph(text))`` under the schema in
``src/schema.ts:45-96``.  This image has no node runtime and no network
egress, so a real PM bundle cannot be vendored or executed here — instead
this module speaks PM's exact JSON wire formats, and the conformance suite
(``tests/test_pm_conformance.py``) replays transaction fixtures authored in
the byte-level schema ``Step.toJSON()`` / ``Node.toJSON()`` produce, so a
real ProseMirror can drive the HTTP bridge unchanged the moment one is
available:

* step JSON <-> the bridge's step algebra (``bridge.model``):
  ``{"stepType": "replace", "from": f, "to": t, "slice": {...}}`` /
  ``addMark`` / ``removeMark`` exactly as ``prosemirror-transform`` emits
  them (ReplaceStep.toJSON / AddMarkStep.toJSON);
* document JSON <-> ``EditorDoc``: ``doc(paragraph(text...))`` with mark
  JSON per ``Mark.toJSON()`` ({"type": name} + "attrs" when the type has
  attrs);
* mark-set JSON <-> the bridge ``MarkMap`` (comments are ``allowMultiple``:
  one PM mark per comment id, reference src/schema.ts:79-92).

Positions: PM positions in a single-paragraph doc are exactly the bridge's
1-based convention (position 0 is the paragraph-open token,
``contentPosFromProsemirrorPos`` reference src/bridge.ts:360-371), so no
shifting happens here — the bridge remains the only place the ±1 shift
exists.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..core.types import MarkMap
from ..schema import MARK_SPEC
from .model import (
    AddMarkStep,
    EditorDoc,
    RemoveMarkStep,
    ReplaceStep,
    Step,
    Transaction,
)

#: mark types of the reference schema (src/schema.ts:45-96) and whether
#: their PM serialization carries an attrs object
_PM_MARK_ATTRS = {
    "strong": (),
    "em": (),
    "link": ("url",),
    "comment": ("id",),
}


class PMFormatError(ValueError):
    """Raised when JSON does not match ProseMirror's wire schema."""


# -- marks -------------------------------------------------------------------


def marks_to_pm(marks: Optional[MarkMap]) -> List[Dict[str, Any]]:
    """Bridge MarkMap -> PM mark-set JSON (``Mark.toJSON()`` list, sorted in
    schema rank order like PM's ``Mark.addToSet`` maintains)."""
    out: List[Dict[str, Any]] = []
    for mark_type in _PM_MARK_ATTRS:
        val = (marks or {}).get(mark_type)
        if val is None:
            continue
        spec = MARK_SPEC.get(mark_type)
        if spec is not None and spec.allow_multiple:
            for entry in val:  # one PM mark per comment id
                out.append({"type": mark_type, "attrs": dict(entry)})
        elif mark_type == "link":
            out.append({"type": "link", "attrs": {"url": val.get("url")}})
        else:
            out.append({"type": mark_type})
    return out


def marks_from_pm(pm_marks: Optional[List[Dict[str, Any]]]) -> MarkMap:
    """PM mark-set JSON -> bridge MarkMap."""
    marks: MarkMap = {}
    for m in pm_marks or []:
        if not isinstance(m, dict) or "type" not in m:
            raise PMFormatError(f"bad mark json: {m!r}")
        mark_type = m["type"]
        if mark_type not in _PM_MARK_ATTRS:
            raise PMFormatError(f"unknown mark type: {mark_type!r}")
        attrs = m.get("attrs") or {}
        spec = MARK_SPEC.get(mark_type)
        if spec is not None and spec.allow_multiple:
            entries = list(marks.get(mark_type, []))
            if not any(e.get("id") == attrs.get("id") for e in entries):
                entries.append(dict(attrs))
            marks[mark_type] = sorted(entries, key=lambda e: str(e.get("id")))
        elif mark_type == "link":
            marks["link"] = {"active": True, "url": attrs.get("url")}
        else:
            marks[mark_type] = {"active": True}
    return marks


def _mark_attrs_of(mark_type: str, marks: MarkMap):
    """attrs to put on an Add/RemoveMarkStep for ``mark_type`` in a map."""
    val = marks.get(mark_type)
    if mark_type == "link" and isinstance(val, dict):
        return {"url": val.get("url")}
    return None


# -- steps -------------------------------------------------------------------


def step_from_pm(step_json: Dict[str, Any]) -> Step:
    """``Step.toJSON()`` -> the bridge's step algebra.

    Replace slices are restricted to what the reference's own bridge
    accepts: text content inside one paragraph (src/bridge.ts:424-466 walks
    ``slice.content`` text nodes; block-structure changes are out of the
    flat-text CRDT's model)."""
    if not isinstance(step_json, dict):
        raise PMFormatError(f"step must be an object: {step_json!r}")
    kind = step_json.get("stepType")
    if kind == "replace":
        frm, to = _positions(step_json)
        slice_json = step_json.get("slice")
        text, marks = _slice_text(slice_json)
        return ReplaceStep(frm, to, text, marks)
    if kind in ("addMark", "removeMark"):
        frm, to = _positions(step_json)
        mark = step_json.get("mark")
        if not isinstance(mark, dict) or "type" not in mark:
            raise PMFormatError(f"bad mark in step: {step_json!r}")
        if mark["type"] not in _PM_MARK_ATTRS:
            raise PMFormatError(f"unknown mark type: {mark['type']!r}")
        cls = AddMarkStep if kind == "addMark" else RemoveMarkStep
        return cls(frm, to, mark["type"], mark.get("attrs"))
    raise PMFormatError(f"unsupported stepType: {kind!r}")


def step_to_pm(step: Step) -> Dict[str, Any]:
    """Bridge step -> ``Step.toJSON()`` schema (what a PM client would feed
    ``Step.fromJSON`` to apply remote patches)."""
    if isinstance(step, ReplaceStep):
        out: Dict[str, Any] = {
            "stepType": "replace", "from": step.from_pos, "to": step.to_pos,
        }
        if step.text:
            node: Dict[str, Any] = {"type": "text", "text": step.text}
            pm_marks = marks_to_pm(step.marks)
            if pm_marks:
                node["marks"] = pm_marks
            out["slice"] = {"content": [node]}
        return out
    if isinstance(step, (AddMarkStep, RemoveMarkStep)):
        mark: Dict[str, Any] = {"type": step.mark_type}
        if step.attrs:
            mark["attrs"] = dict(step.attrs)
        return {
            "stepType": "addMark" if isinstance(step, AddMarkStep) else "removeMark",
            "from": step.from_pos,
            "to": step.to_pos,
            "mark": mark,
        }
    raise PMFormatError(f"step {step!r} has no PM serialization")


def transaction_from_pm(steps_json: List[Dict[str, Any]]) -> Transaction:
    """A PM transaction's ``steps`` array -> bridge Transaction."""
    txn = Transaction()
    for s in steps_json:
        txn.steps.append(step_from_pm(s))
    return txn


def _positions(step_json: Dict[str, Any]):
    frm, to = step_json.get("from"), step_json.get("to")
    if not isinstance(frm, int) or not isinstance(to, int) or not 0 < frm <= to:
        raise PMFormatError(f"bad step positions: {step_json!r}")
    return frm, to


def _slice_text(slice_json):
    """Extract (text, marks) from a replace slice; None slice = deletion."""
    if slice_json is None:
        return "", None
    if not isinstance(slice_json, dict):
        raise PMFormatError(f"bad slice: {slice_json!r}")
    if slice_json.get("openStart") or slice_json.get("openEnd"):
        raise PMFormatError("open slices (block joins) are outside the flat-text model")
    text, marks = [], None
    for node in slice_json.get("content", []):
        if not isinstance(node, dict) or node.get("type") != "text":
            raise PMFormatError(f"non-text slice content: {node!r}")
        text.append(node.get("text", ""))
        node_marks = marks_from_pm(node.get("marks"))
        if marks is None:
            marks = node_marks
        elif marks != node_marks:
            # the reference's bridge applies one mark set per replace; PM
            # multi-mark-run slices arrive as separate keystrokes in practice
            raise PMFormatError("replace slice mixes mark sets")
    return "".join(text), marks


# -- documents ---------------------------------------------------------------


def editor_doc_to_pm(doc: EditorDoc) -> Dict[str, Any]:
    """EditorDoc -> ``Node.toJSON()`` of the reference schema:
    doc(paragraph(text runs grouped by identical mark sets))."""
    runs: List[Dict[str, Any]] = []
    for span in doc.spans():
        node: Dict[str, Any] = {"type": "text", "text": span["text"]}
        pm_marks = marks_to_pm(span.get("marks"))
        if pm_marks:
            node["marks"] = pm_marks
        if node["text"]:
            runs.append(node)
    paragraph: Dict[str, Any] = {"type": "paragraph"}
    if runs:
        paragraph["content"] = runs
    return {"type": "doc", "content": [paragraph]}


def editor_doc_from_pm(doc_json: Dict[str, Any]) -> EditorDoc:
    """``Node.toJSON()`` -> EditorDoc (single-paragraph docs, the reference
    schema's shape — src/schema.ts:50-57 content: "paragraph+" with the demo
    and CRDT both flat)."""
    if not isinstance(doc_json, dict) or doc_json.get("type") != "doc":
        raise PMFormatError(f"not a doc node: {doc_json!r}")
    paragraphs = doc_json.get("content", [])
    if len(paragraphs) != 1 or paragraphs[0].get("type") != "paragraph":
        raise PMFormatError("only single-paragraph docs map onto the flat-text CRDT")
    doc = EditorDoc()
    index = 0
    for node in paragraphs[0].get("content", []):
        if node.get("type") != "text":
            raise PMFormatError(f"non-text paragraph content: {node!r}")
        marks = marks_from_pm(node.get("marks"))
        doc.insert_at(index, node.get("text", ""), marks or None)
        index += len(node.get("text", ""))
    return doc
