"""Core CRDT data types: changes, internal operations, boundaries, patches.

The *public* boundary of the framework is identical in shape to the
reference's (``src/micromerge.ts:191-199`` for input operations, ``:14-19`` for
patches): plain JSON-style dicts.  Input operations look like::

    {"action": "insert", "path": ["text"], "index": 3, "values": ["a", "b"]}
    {"action": "delete", "path": ["text"], "index": 3, "count": 2}
    {"action": "addMark", "path": ["text"], "startIndex": 1, "endIndex": 4,
     "markType": "link", "attrs": {"url": "https://..."}}
    {"action": "removeMark", ...}
    {"action": "makeList", "path": [], "key": "text"}
    {"action": "makeMap" | "set" | "del", ...}

and patches are the same index-based shapes flowing outward (insert patches
additionally carry ``marks``).  Internally, operations are anchored to stable
element IDs rather than indices, which is what makes them commutative.

``Change`` is the replication unit (reference ``src/micromerge.ts:67-78``): a
transactional batch of internal ops with vector-clock deps.  ``to_json`` /
``from_json`` speak the reference's exact wire format, so recorded traces
(the reference's ``traces/*.json``) and changes made by the JAX package
replay directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .opids import (
    HEAD,
    ElemRef,
    ObjectId,
    OpId,
    format_elem_ref,
    format_object_id,
    format_opid,
    parse_elem_ref,
    parse_object_id,
    parse_opid,
)

#: Vector clock: actor id -> latest sequence number seen from that actor.
Clock = Dict[str, int]

# Boundary kinds (reference ``BoundaryPosition``, src/micromerge.ts:266-270).
BEFORE = "before"
AFTER = "after"
START_OF_TEXT = "startOfText"
END_OF_TEXT = "endOfText"


@dataclass(frozen=True)
class Boundary:
    """A mark anchor: one of the 2n+2 gaps around the character sequence."""

    kind: str  # BEFORE | AFTER | START_OF_TEXT | END_OF_TEXT
    elem: Optional[OpId] = None  # set iff kind is BEFORE/AFTER

    def to_json(self) -> Dict[str, Any]:
        if self.kind in (BEFORE, AFTER):
            return {"type": self.kind, "elemId": format_opid(self.elem)}
        return {"type": self.kind}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Boundary":
        kind = d["type"]
        if kind in (BEFORE, AFTER):
            return Boundary(kind, parse_opid(d["elemId"]))
        return Boundary(kind)


@dataclass
class Operation:
    """An internal, element-anchored operation (reference ``Operation``,
    src/micromerge.ts:309-317).  One dataclass covers all actions; unused
    fields stay None."""

    action: str  # "set" | "del" | "makeList" | "makeMap" | "addMark" | "removeMark"
    obj: ObjectId
    opid: OpId
    # map ops
    key: Optional[str] = None
    # list ops
    elem_id: Optional[ElemRef] = None
    insert: bool = False
    value: Any = None
    # mark ops
    start: Optional[Boundary] = None
    end: Optional[Boundary] = None
    mark_type: Optional[str] = None
    attrs: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "opId": format_opid(self.opid),
            "action": self.action,
            "obj": format_object_id(self.obj),
        }
        if self.key is not None:
            d["key"] = self.key
        if self.action in ("addMark", "removeMark"):
            d["start"] = self.start.to_json()
            d["end"] = self.end.to_json()
            d["markType"] = self.mark_type
            if self.attrs is not None:
                d["attrs"] = dict(self.attrs)
        elif self.insert:
            d["insert"] = True
            d["value"] = self.value
            # HEAD is omitted on the wire (the reference's HEAD is a JS Symbol
            # which JSON.stringify drops).
            if self.elem_id is not HEAD:
                d["elemId"] = format_elem_ref(self.elem_id)
        else:
            if self.elem_id is not None:
                d["elemId"] = format_elem_ref(self.elem_id)
            if self.action == "set":
                d["value"] = self.value
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Operation":
        action = d["action"]
        obj = parse_object_id(d.get("obj"))
        opid = parse_opid(d["opId"])
        if action in ("addMark", "removeMark"):
            return Operation(
                action=action,
                obj=obj,
                opid=opid,
                start=Boundary.from_json(d["start"]),
                end=Boundary.from_json(d["end"]),
                mark_type=d["markType"],
                attrs=dict(d["attrs"]) if "attrs" in d and d["attrs"] is not None else None,
            )
        if action in ("makeList", "makeMap") or ("key" in d and not d.get("insert")):
            # map-shaped op (set/del on a map also lands here via "key")
            op = Operation(action=action, obj=obj, opid=opid, key=d.get("key"))
            if action == "set":
                op.value = d.get("value")
            return op
        # list-shaped set/del
        if d.get("insert"):
            return Operation(
                action="set",
                obj=obj,
                opid=opid,
                elem_id=parse_elem_ref(d.get("elemId")),
                insert=True,
                value=d.get("value"),
            )
        return Operation(
            action=action,
            obj=obj,
            opid=opid,
            elem_id=parse_elem_ref(d.get("elemId")) if "elemId" in d else None,
            value=d.get("value"),
        )


@dataclass
class Change:
    """A transactional batch of ops from one actor (the replication unit)."""

    actor: str
    seq: int
    deps: Clock
    start_op: int
    ops: List[Operation] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {
            "actor": self.actor,
            "seq": self.seq,
            "deps": dict(self.deps),
            "startOp": self.start_op,
            "ops": [op.to_json() for op in self.ops],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Change":
        return Change(
            actor=d["actor"],
            seq=d["seq"],
            deps=dict(d.get("deps") or {}),
            start_op=d["startOp"],
            ops=[Operation.from_json(op) for op in d["ops"]],
        )


# ---------------------------------------------------------------------------
# Public-boundary shapes (kept as plain dicts; helpers for construction only).
# ---------------------------------------------------------------------------

Path = Tuple[str, ...]
InputOperation = Dict[str, Any]
Patch = Dict[str, Any]
MarkMap = Dict[str, Any]  # cleaned mark map, no op ids
FormatSpan = Dict[str, Any]  # {"text": str, "marks": MarkMap}


def span(text: str, marks: Optional[MarkMap] = None) -> FormatSpan:
    """Convenience constructor for expected-result literals in tests."""
    return {"marks": marks or {}, "text": text}
