"""Scalar document oracle: the full Peritext/Micromerge semantics, in Python.

This is the framework's *specification layer*: a faithful, single-document
implementation of the reference CRDT (reference ``src/micromerge.ts``), used

1. as ground truth for differential testing of the batched device kernels, and
2. as the host-side engine for interactive (single-doc, editor-bridge) use,
   where exact incremental ``Patch`` streams are required.

The bulk path (:mod:`peritext_tpu_torch.ops`) re-derives the same final states from
a packed op-table formulation; this class keeps the reference's incremental
materialized-gap representation because patch emission is defined against it.

Design notes / intentional deviations (see also core/spans.py docstring):

* Op IDs are ``(counter, actor)`` tuples; ordering is native tuple order
  (reference compareOpIds, src/micromerge.ts:1389-1403).
* Gap "sets" of mark ops are insertion-ordered dicts keyed by op ID.  The
  reference uses JS ``Set`` with object identity; op IDs are unique, so keying
  by ID is equivalent (and makes the end-anchor self-exclusion at
  src/micromerge.ts:1087-1093 explicit).
* removeMark patches for comments carry ``attrs: {"id"}`` so that patch
  consumers can remove exactly one comment; the reference omits attrs there
  (src/micromerge.ts:962) which makes comment removal unreplayable from
  patches.
* ``makeMap`` emits no patch, matching the reference's acknowledged gap
  (src/micromerge.ts:1167), and ``makeList`` hardcodes path ["text"] (:1165).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from ..schema import MARK_SPEC, is_mark_type
from .errors import CausalityError, IndexOutOfBounds, MissingObject, PeritextError
from .opids import HEAD, ROOT, ElemRef, ObjectId, OpId
from .spans import add_characters_to_spans, ops_to_marks
from .types import (
    AFTER,
    BEFORE,
    END_OF_TEXT,
    Boundary,
    Change,
    Clock,
    FormatSpan,
    InputOperation,
    MarkMap,
    Operation,
    Patch,
)

CONTENT_KEY = "text"

#: Gap set: insertion-ordered map from op ID to the mark op (add or remove).
MarkOpSet = Dict[OpId, Operation]


@dataclass
class ListItemMeta:
    """CRDT metadata for one list element (reference ListItemMetadata,
    src/micromerge.ts:341-357)."""

    elem_id: OpId
    value_id: OpId
    deleted: bool = False
    #: Mark ops governing the gap before/after this element; None = inherit
    #: from the closest materialized gap to the left.
    mark_ops_before: Optional[MarkOpSet] = None
    mark_ops_after: Optional[MarkOpSet] = None


@dataclass
class MapMeta:
    """CRDT metadata for a map object: LWW op ids per key + child object ids."""

    ops: Dict[str, OpId] = field(default_factory=dict)
    children: Dict[str, ObjectId] = field(default_factory=dict)


Metadata = Union[List[ListItemMeta], MapMeta]

Cursor = Dict[str, Any]  # {"objectId": ObjectId, "elemId": OpId}


class Doc:
    """A single collaborative document replica (reference class Micromerge)."""

    content_key = CONTENT_KEY

    def __init__(self, actor_id: Optional[str] = None) -> None:
        self.actor_id: str = actor_id if actor_id is not None else uuid.uuid4().hex
        self._seq: int = 0
        self._max_op: int = 0
        self.clock: Clock = {}
        self._objects: Dict[Any, Any] = {ROOT: {}}
        self._metadata: Dict[Any, Metadata] = {ROOT: MapMeta()}

    @classmethod
    def resume(cls, actor_id: str, ordered_changes) -> "Doc":
        """Reconstruct a replica AND resume its actor identity.

        ``apply_change`` alone rebuilds state but leaves the local sequence
        counter at zero (the reference behaves the same: ``this.seq`` only
        advances through ``change()``, src/micromerge.ts:566-577), so a
        replica restored by replay would mint colliding ``(actor, seq=1)``
        changes.  This constructor replays ``ordered_changes`` (already in a
        causally-valid order) and then continues the actor's own numbering —
        the event-sourcing restore path (checkpoint.py).
        """
        doc = cls(actor_id)
        for change in ordered_changes:
            doc.apply_change(change)
        doc._seq = doc.clock.get(actor_id, 0)
        return doc

    # ------------------------------------------------------------------
    # Public read API
    # ------------------------------------------------------------------

    @property
    def root(self) -> Dict[str, Any]:
        return self._objects[ROOT]

    def get_root(self) -> Dict[str, Any]:
        return self._objects[ROOT]

    def get_object_id_for_path(self, path) -> ObjectId:
        object_id: ObjectId = ROOT
        for path_elem in path:
            meta = self._metadata.get(object_id)
            if meta is None:
                raise MissingObject(f"No object at path {path!r}")
            if not isinstance(meta, MapMeta):
                raise PeritextError(f"Object {path_elem} in path {path!r} is a list")
            child = meta.children.get(path_elem)
            if child is None:
                raise MissingObject(f"Child not found: {path_elem} in {object_id!r}")
            object_id = child
        return object_id

    def get_text_with_formatting(self, path) -> List[FormatSpan]:
        """Flatten the document into contiguous spans of identically-formatted
        text (the "batch" read path, reference src/micromerge.ts:796-857)."""
        object_id = self.get_object_id_for_path(path)
        text = self._objects.get(object_id)
        metadata = self._metadata.get(object_id)
        if not isinstance(text, list) or not isinstance(metadata, list):
            raise PeritextError(f"Expected a list at object ID {object_id!r}")

        spans: List[FormatSpan] = []
        characters: List[str] = []
        marks: MarkMap = {}
        visible = 0

        for index, el in enumerate(metadata):
            # Formatting changes in the gap before this character come from the
            # "before" set of this element or the "after" set of the previous
            # one; "before" is later in gap order and takes precedence.
            new_marks: Optional[MarkMap] = None
            if el.mark_ops_before is not None:
                new_marks = ops_to_marks(el.mark_ops_before.values())
            elif index > 0 and metadata[index - 1].mark_ops_after is not None:
                new_marks = ops_to_marks(metadata[index - 1].mark_ops_after.values())

            if new_marks is not None:
                add_characters_to_spans(characters, marks, spans)
                characters = []
                marks = new_marks

            if not el.deleted:
                characters.append(text[visible])
                visible += 1

        add_characters_to_spans(characters, marks, spans)
        return spans

    def get_cursor(self, path, index: int) -> Cursor:
        object_id = self.get_object_id_for_path(path)
        return {
            "objectId": object_id,
            "elemId": self._get_list_element_id(object_id, index),
        }

    def resolve_cursor(self, cursor: Cursor) -> int:
        """Current visible index of a stable cursor; collapses left over
        tombstones (reference src/micromerge.ts:868-870)."""
        _, visible = self._find_list_element(cursor["objectId"], cursor["elemId"])
        return visible

    # ------------------------------------------------------------------
    # Local change generation (reference change(), src/micromerge.ts:566)
    # ------------------------------------------------------------------

    def change(self, ops: List[InputOperation]) -> Tuple[Change, List[Patch]]:
        """Convert index-based input operations into a new transactional
        Change, applying it locally; returns (change, patches).

        Input ops are validated *before* any state (seq/clock/doc) mutates, so
        a bad index or missing mark attrs raises cleanly and leaves the
        replica able to keep syncing.  (The reference advances seq first and
        can poison its replication stream on bad input.)"""
        self._validate_input_ops(ops)
        deps = dict(self.clock)
        self._seq += 1
        self.clock[self.actor_id] = self._seq

        change = Change(
            actor=self.actor_id,
            seq=self._seq,
            deps=deps,
            start_op=self._max_op + 1,
            ops=[],
        )
        patches: List[Patch] = []

        for input_op in ops:
            obj_id = self.get_object_id_for_path(input_op["path"])
            obj = self._objects.get(obj_id)
            if obj is None:
                raise MissingObject(f"Object doesn't exist: {obj_id!r}")

            action = input_op["action"]
            if isinstance(obj, list):
                if action == "insert":
                    self._input_insert(change, obj_id, input_op, patches)
                elif action == "delete":
                    self._input_delete(change, obj_id, input_op, patches)
                elif action in ("addMark", "removeMark"):
                    self._input_mark(change, obj_id, obj, input_op, patches)
                else:
                    raise PeritextError(f"Unsupported list op: {action}")
            else:
                if action in ("makeList", "makeMap", "del"):
                    _, ps = self._make_new_op(
                        change,
                        Operation(action=action, obj=obj_id, opid=(0, ""), key=input_op["key"]),
                    )
                    patches.extend(ps)
                elif action == "set":
                    _, ps = self._make_new_op(
                        change,
                        Operation(
                            action="set",
                            obj=obj_id,
                            opid=(0, ""),
                            key=input_op["key"],
                            value=input_op["value"],
                        ),
                    )
                    patches.extend(ps)
                else:
                    raise PeritextError(f"Not a list: {input_op['path']!r}")

        return change, patches

    def _validate_input_ops(self, ops: List[InputOperation]) -> None:
        """Reject malformed input before mutating anything.  Visible lengths
        evolve predictably across the batch (inserts add, deletes remove,
        marks don't change length), so bounds can be checked with a simple
        simulated length per list object."""
        lengths: Dict[Any, int] = {}
        created: Dict[Tuple[str, ...], str] = {}  # batch-local makeList/makeMap

        def resolve(path) -> Tuple[Any, int]:
            """(resolution key, visible length or -1 for maps), accounting for
            objects created earlier in this same batch."""
            pt = tuple(path)
            if pt in created:
                key = ("virtual", pt)
                if key not in lengths:
                    lengths[key] = 0 if created[pt] == "list" else -1
                return key, lengths[key]
            obj_id = self.get_object_id_for_path(path)
            if obj_id not in lengths:
                obj = self._objects.get(obj_id)
                if obj is None:
                    raise MissingObject(f"Object doesn't exist: {obj_id!r}")
                lengths[obj_id] = len(obj) if isinstance(obj, list) else -1
            return obj_id, lengths[obj_id]

        for input_op in ops:
            action = input_op["action"]
            obj_id, n = resolve(input_op["path"])
            is_list = n >= 0
            if action == "insert":
                if not is_list:
                    raise PeritextError(f"Not a list: {input_op['path']!r}")
                if not 0 <= input_op["index"] <= n:
                    raise IndexOutOfBounds(
                        f"Insert index {input_op['index']} out of bounds for length {n}"
                    )
                lengths[obj_id] = n + len(input_op["values"])
            elif action == "delete":
                if not is_list:
                    raise PeritextError(f"Not a list: {input_op['path']!r}")
                index, count = input_op["index"], input_op["count"]
                if index < 0 or count < 0 or index + count > n:
                    raise IndexOutOfBounds(
                        f"Delete [{index}, {index + count}) out of bounds for length {n}"
                    )
                lengths[obj_id] = n - count
            elif action in ("addMark", "removeMark"):
                if not is_list:
                    raise PeritextError(f"Not a list: {input_op['path']!r}")
                mark_type = input_op.get("markType")
                if mark_type is None or not is_mark_type(mark_type):
                    raise PeritextError(f"Unknown mark type: {mark_type}")
                start, end = input_op["startIndex"], input_op["endIndex"]
                if not (0 <= start < end <= n):
                    raise IndexOutOfBounds(
                        f"Mark range [{start}, {end}) invalid for length {n}"
                    )
                attrs = input_op.get("attrs") or {}
                required = MARK_SPEC[mark_type].attr_keys
                needs_attrs = action == "addMark" or mark_type == "comment"
                if needs_attrs:
                    for key in required:
                        if key not in attrs:
                            raise PeritextError(
                                f"{action} {mark_type} requires attr {key!r}"
                            )
            elif action in ("makeList", "makeMap", "set", "del"):
                if is_list:
                    raise PeritextError(f"Map operation on a list: {action}")
                if "key" not in input_op:
                    raise PeritextError(f"{action} requires a key")
                if action in ("makeList", "makeMap"):
                    child_path = tuple(input_op["path"]) + (input_op["key"],)
                    created[child_path] = "list" if action == "makeList" else "map"
            else:
                raise PeritextError(f"Unknown action: {action}")

    def _input_insert(self, change, obj_id, input_op, patches) -> None:
        index = input_op["index"]
        # Insert after the predecessor; peek past trailing tombstones carrying
        # span-end anchors so non-growing marks ending on a tombstone exclude
        # the new characters (reference :1351-1373).
        elem_ref: ElemRef = (
            HEAD
            if index == 0
            else self._get_list_element_id(obj_id, index - 1, look_after_tombstones=True)
        )
        for value in input_op["values"]:
            opid, ps = self._make_new_op(
                change,
                Operation(
                    action="set",
                    obj=obj_id,
                    opid=(0, ""),
                    elem_id=elem_ref,
                    insert=True,
                    value=value,
                ),
            )
            elem_ref = opid  # chain multi-char inserts
            patches.extend(ps)

    def _input_delete(self, change, obj_id, input_op, patches) -> None:
        # The delete index stays fixed: each iteration deletes the character
        # that slid into position `index` (reference :615-645).
        for _ in range(input_op["count"]):
            elem = self._get_list_element_id(obj_id, input_op["index"])
            _, ps = self._make_new_op(
                change, Operation(action="del", obj=obj_id, opid=(0, ""), elem_id=elem)
            )
            patches.extend(ps)

    def _input_mark(self, change, obj_id, obj, input_op, patches) -> None:
        action = input_op["action"]
        mark_type = input_op["markType"]
        if not is_mark_type(mark_type):
            raise PeritextError(f"Unknown mark type: {mark_type}")
        start_index, end_index = input_op["startIndex"], input_op["endIndex"]

        # Span starts never grow; ends grow iff the mark is "inclusive".
        # Growth is encoded purely in anchor choice (reference :650-682).
        start = Boundary(BEFORE, self._get_list_element_id(obj_id, start_index))
        if MARK_SPEC[mark_type].inclusive:
            if end_index < len(obj):
                end = Boundary(BEFORE, self._get_list_element_id(obj_id, end_index))
            else:
                end = Boundary(END_OF_TEXT)
        else:
            end = Boundary(AFTER, self._get_list_element_id(obj_id, end_index - 1))

        attrs = input_op.get("attrs")
        _, ps = self._make_new_op(
            change,
            Operation(
                action=action,
                obj=obj_id,
                opid=(0, ""),
                start=start,
                end=end,
                mark_type=mark_type,
                attrs=dict(attrs) if attrs is not None else None,
            ),
        )
        patches.extend(ps)

    def _make_new_op(self, change: Change, op: Operation) -> Tuple[OpId, List[Patch]]:
        self._max_op += 1
        op.opid = (self._max_op, self.actor_id)
        patches = self._apply_op(op)
        change.ops.append(op)
        return op.opid, patches

    # ------------------------------------------------------------------
    # Remote change application (reference applyChange, src/micromerge.ts:892)
    # ------------------------------------------------------------------

    def apply_change(self, change: Change) -> List[Patch]:
        last_seq = self.clock.get(change.actor, 0)
        if change.seq != last_seq + 1:
            raise CausalityError(
                f"Expected sequence number {last_seq + 1} from {change.actor}, got {change.seq}"
            )
        for actor, dep in (change.deps or {}).items():
            if self.clock.get(actor, 0) < dep:
                raise CausalityError(f"Missing dependency: change {dep} by actor {actor}")

        patches: List[Patch] = []
        for op in change.ops:
            patches.extend(self._apply_op(op))

        # Record the change as applied only after every op succeeded, so a
        # malformed change is never silently marked as delivered.  (Ops of a
        # well-formed change can't fail once the causality checks pass.)
        self.clock[change.actor] = change.seq
        self._max_op = max(self._max_op, change.start_op + len(change.ops) - 1)
        return patches

    # ------------------------------------------------------------------
    # Op application
    # ------------------------------------------------------------------

    def _apply_op(self, op: Operation) -> List[Patch]:
        metadata = self._metadata.get(op.obj)
        obj = self._objects.get(op.obj)
        if metadata is None or obj is None:
            raise MissingObject(f"Object does not exist: {op.obj!r}")

        if op.action == "makeMap":
            self._objects[op.opid] = {}
            self._metadata[op.opid] = MapMeta()
        elif op.action == "makeList":
            self._objects[op.opid] = []
            self._metadata[op.opid] = []

        if isinstance(metadata, list):
            if op.action == "set":
                if op.elem_id is None:
                    raise PeritextError("Must specify elemId when setting in a list")
                return self._apply_list_insert(op)
            if op.action == "del":
                if op.elem_id is None:
                    raise PeritextError("Must specify elemId when deleting in a list")
                return self._apply_list_delete(op)
            if op.action in ("addMark", "removeMark"):
                return self._apply_mark_op(op, metadata, obj)
            raise PeritextError(f"Unsupported op on list: {op.action}")

        # Map object: last-writer-wins per key by op ID (reference :1151-1175).
        key = op.key
        if op.action in ("addMark", "removeMark"):
            raise PeritextError("Can't add or remove marks on a map")
        if key is None:
            raise PeritextError("Must specify key for map operations")
        key_meta = metadata.ops.get(key)
        if key_meta is None or key_meta < op.opid:
            metadata.ops[key] = op.opid
            if op.action == "del":
                obj.pop(key, None)
            elif op.action == "makeList":
                obj[key] = self._objects[op.opid]
                metadata.children[key] = op.opid
                return [{"action": "makeList", "path": [CONTENT_KEY], "key": key}]
            elif op.action == "makeMap":
                # Matches the reference's acknowledged gap: no patch emitted.
                obj[key] = self._objects[op.opid]
                metadata.children[key] = op.opid
            elif op.action == "set":
                obj[key] = op.value
            else:
                raise PeritextError(f"Unsupported op on map: {op.action}")
        return []

    def _apply_list_insert(self, op: Operation) -> List[Patch]:
        """RGA insert-after-reference (reference applyListInsert, :1187-1245)."""
        meta = self._metadata[op.obj]
        obj = self._objects[op.obj]

        if op.elem_id is HEAD:
            index, visible = -1, 0
        else:
            index, visible = self._find_list_element(op.obj, op.elem_id)
        if index >= 0 and not meta[index].deleted:
            visible += 1
        index += 1

        # Convergence rule: skip right past elements whose elemId is greater
        # than the inserting op's ID, so concurrent inserts at one position
        # land in descending op-ID order on every replica (:1201-1208).
        while index < len(meta) and op.opid < meta[index].elem_id:
            if not meta[index].deleted:
                visible += 1
            index += 1

        meta.insert(index, ListItemMeta(elem_id=op.opid, value_id=op.opid))
        if not isinstance(op.value, str):
            raise PeritextError("Expected a string value inserted into text")
        obj.insert(visible, op.value)

        # New characters inherit the formatting active at their position.
        marks = ops_to_marks(self._closest_mark_ops_left(meta, index, BEFORE).values())
        return [
            {
                "path": [CONTENT_KEY],
                "action": "insert",
                "index": visible,
                "values": [op.value],
                "marks": marks,
            }
        ]

    def _apply_list_delete(self, op: Operation) -> List[Patch]:
        """Tombstone a list element (reference applyListUpdate, :1250-1297)."""
        index, visible = self._find_list_element(op.obj, op.elem_id)
        meta = self._metadata[op.obj][index]
        if not meta.deleted:
            meta.deleted = True
            self._objects[op.obj].pop(visible)
            return [
                {
                    "path": [CONTENT_KEY],
                    "action": "delete",
                    "index": visible,
                    "count": 1,
                }
            ]
        return []

    # -- mark op application (the Peritext span walk, reference :1002-1138) --

    def _apply_mark_op(self, op: Operation, metadata: List[ListItemMeta], obj: list) -> List[Patch]:
        patches: List[Patch] = []

        def emit(partial: Patch, end_index: int) -> None:
            # Suppress zero-width / beyond-visible patches; truncate overlong
            # ones (reference emitPatch, :1006-1022).  Flags are computed
            # before truncation, exactly as the reference does.
            patch = dict(partial)
            patch["endIndex"] = end_index
            not_zero_length = patch["endIndex"] > patch["startIndex"]
            affects_visible = patch["startIndex"] < len(obj)
            if patch["endIndex"] > len(obj):
                patch["endIndex"] = len(obj)
            if not_zero_length and affects_visible:
                patches.append(patch)

        op_intersects_item = False
        visible_index = 0
        partial: Optional[Patch] = None

        for index, el in enumerate(metadata):
            for side, prop in ((BEFORE, "mark_ops_before"), (AFTER, "mark_ops_after")):
                # Patch indices address visible characters: the gap after a
                # visible character maps to the next visible index.
                index_for_patch = (
                    visible_index + 1 if (side == AFTER and not el.deleted) else visible_index
                )
                gap: Optional[MarkOpSet] = getattr(el, prop)

                if op.start.kind == side and op.start.elem == el.elem_id:
                    # Start anchor: seed the gap from the closest set to the
                    # left if it isn't materialized, then add this op.
                    existing = (
                        gap
                        if gap is not None
                        else self._closest_mark_ops_left(metadata, index, side)
                    )
                    new_ops = dict(existing)
                    new_ops[op.opid] = op
                    setattr(el, prop, new_ops)
                    if ops_to_marks(existing.values()) != ops_to_marks(new_ops.values()):
                        partial = self._partial_patch(op, index_for_patch)
                    op_intersects_item = True

                elif op.end.kind == side and op.end.elem == el.elem_id:
                    # End anchor: materialize what's active to the right —
                    # everything inherited from the left minus this op.
                    if gap is None:
                        base = self._closest_mark_ops_left(metadata, index, side)
                        base.pop(op.opid, None)
                        setattr(el, prop, base)
                    if partial is not None:
                        emit(partial, index_for_patch)
                        partial = None
                    return patches

                elif op_intersects_item and gap is not None:
                    # Explicit intermediate gap inside the span: close any open
                    # patch segment at this boundary, add the op, and reopen a
                    # segment if visible formatting changed.
                    if partial is not None:
                        emit(partial, index_for_patch)
                        partial = None
                    new_ops = dict(gap)
                    new_ops[op.opid] = op
                    if ops_to_marks(gap.values()) != ops_to_marks(new_ops.values()):
                        partial = self._partial_patch(op, index_for_patch)
                    setattr(el, prop, new_ops)

            if not el.deleted:
                visible_index += 1

        # Span runs to endOfText (or past all materialized gaps): close at the
        # end of the visible sequence.
        if partial is not None:
            emit(partial, len(obj))
        return patches

    def _partial_patch(self, op: Operation, start_index: int) -> Patch:
        partial: Patch = {
            "action": op.action,
            "markType": op.mark_type,
            "path": [CONTENT_KEY],
            "startIndex": start_index,
        }
        if op.action == "addMark" and op.mark_type in ("link", "comment"):
            partial["attrs"] = dict(op.attrs)
        # Deviation from reference: carry the comment id on removeMark patches
        # so consumers can remove exactly that comment (see module docstring).
        if op.action == "removeMark" and op.mark_type == "comment" and op.attrs:
            partial["attrs"] = dict(op.attrs)
        return partial

    def _closest_mark_ops_left(
        self, metadata: List[ListItemMeta], index: int, side: str
    ) -> MarkOpSet:
        """The nearest materialized gap set at or left of (index, side),
        excluding that position itself; {} if none (reference :916-947).
        Always returns a fresh dict safe to mutate."""
        if side == AFTER and metadata[index].mark_ops_before is not None:
            return dict(metadata[index].mark_ops_before)
        for i in range(index - 1, -1, -1):
            if metadata[i].mark_ops_after is not None:
                return dict(metadata[i].mark_ops_after)
            if metadata[i].mark_ops_before is not None:
                return dict(metadata[i].mark_ops_before)
        return {}

    # ------------------------------------------------------------------
    # Element <-> index resolution
    # ------------------------------------------------------------------

    def _find_list_element(self, object_id: ObjectId, elem_id: ElemRef) -> Tuple[int, int]:
        """(metadata index, count of visible elements before it)."""
        meta = self._metadata.get(object_id)
        if not isinstance(meta, list):
            raise MissingObject(f"List object not found: {object_id!r}")
        visible = 0
        for index, el in enumerate(meta):
            if el.elem_id == elem_id:
                return index, visible
            if not el.deleted:
                visible += 1
        raise IndexOutOfBounds(f"List element not found: {elem_id!r}")

    def _get_list_element_id(
        self, object_id: ObjectId, index: int, look_after_tombstones: bool = False
    ) -> OpId:
        """Element ID of the index-th visible element.  With
        ``look_after_tombstones``, return instead the last trailing tombstone
        that carries a span-end ("after") anchor, so inserts land outside
        non-growing spans that end on a tombstone (reference :1334-1381)."""
        meta = self._metadata.get(object_id)
        if not isinstance(meta, list):
            raise MissingObject(f"List object not found: {object_id!r}")
        visible = -1
        for meta_index, el in enumerate(meta):
            if el.deleted:
                continue
            visible += 1
            if visible == index:
                if look_after_tombstones:
                    chosen = meta_index
                    peek = meta_index + 1
                    latest_after_tombstone: Optional[int] = None
                    while peek < len(meta) and meta[peek].deleted:
                        if meta[peek].mark_ops_after is not None:
                            latest_after_tombstone = peek
                        peek += 1
                    if latest_after_tombstone is not None:
                        chosen = latest_after_tombstone
                    return meta[chosen].elem_id
                return el.elem_id
        raise IndexOutOfBounds(f"List index out of bounds: {index}")

    # ------------------------------------------------------------------
    # Introspection for tests / debugging
    # ------------------------------------------------------------------

    def list_metadata(self, path=("text",)) -> List[ListItemMeta]:
        object_id = self.get_object_id_for_path(path)
        meta = self._metadata[object_id]
        assert isinstance(meta, list)
        return meta


#: Alias matching the reference's class name.
Micromerge = Doc
