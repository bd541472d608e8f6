"""Host-side encoding: change logs -> padded split-stream device tensors.

The irregular, string-y work that is wrong for the device happens here: causal
sorting (parallel/causal.py), actor/attr interning (utils/interning.py),
boundary-anchor flattening, and padding/bucketing.

Ops are split into three streams per document, exploiting the commutation
structure of the packed representation (ops/packed.py):

* **inserts** — the only truly sequential stream (each insert's position
  depends on prior inserts); consumed by the insert kernel (ops/insert.py).
* **deletes** — idempotent tombstone sets; they commute with each other and
  with inserts' *placement* (the RGA skip compares only element ids,
  reference src/micromerge.ts:1201-1208), so they apply as one vectorized
  pass after all inserts.
* **marks** — grow-only table rows; they are encoded host-side directly in
  mark-table layout and appended with one vectorized scatter.

All identifiers are packed int32s (packed.pack_id).  Documents whose logs the
device path cannot express (non-text objects, too many actors/ops) are routed
to the scalar-oracle fallback (``EncodedBatch.fallback_docs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.opids import HEAD, ROOT
from ..core.types import AFTER, BEFORE, END_OF_TEXT, START_OF_TEXT, Boundary, Change
from ..parallel.causal import causal_sort
from ..schema import MARK_INDEX
from ..utils.interning import Interner, OrderedActorTable
from .packed import (
    BK_AFTER,
    BK_BEFORE,
    BK_END_OF_TEXT,
    BK_START_OF_TEXT,
    MA_ADD,
    MA_REMOVE,
    MAX_ACTORS,
    MAX_CTR,
    OBJ_ROOT,
    VK_DELETED,
    VK_FALSE,
    VK_INT,
    VK_NULL,
    VK_OBJ,
    VK_STR,
    VK_TEXT,
    VK_TRUE,
    pack_id,
)

_BK = {
    BEFORE: BK_BEFORE,
    AFTER: BK_AFTER,
    START_OF_TEXT: BK_START_OF_TEXT,
    END_OF_TEXT: BK_END_OF_TEXT,
}

#: Columns of a host-side mark row, in PackedDocs mark-table order.
MARK_COLS = (
    "m_action",
    "m_type",
    "m_start_kind",
    "m_start_elem",
    "m_end_kind",
    "m_end_elem",
    "m_op",
    "m_attr",
)

# canonical map-register column order lives in packed.py (device & host
# share one definition); re-exported here for stream-filling callers
from .packed import MAP_STREAM_COLS  # noqa: E402  (grouped with MARK_COLS)


@dataclass
class EncodedBatch:
    """Padded split-stream batch plus intern tables for decoding outputs."""

    # insert stream (D, KI)
    ins_ref: np.ndarray  # packed predecessor elem (0 = HEAD)
    ins_op: np.ndarray  # packed op id (0 = pad)
    ins_char: np.ndarray  # int32 codepoint
    # delete stream (D, KD); packed target elem (0 = pad)
    del_target: np.ndarray
    # mark stream (D, KM) per MARK_COLS
    marks: Dict[str, np.ndarray]
    mark_count: np.ndarray  # int32 (D,)
    # map-register stream (D, KP) per MAP_STREAM_COLS
    map_ops: Dict[str, np.ndarray]
    map_count: np.ndarray  # int32 (D,)
    num_ops: np.ndarray  # int32 (D,) total encoded ops (stats)
    actor_tables: List[OrderedActorTable]
    attr_tables: List[Interner]
    #: per-doc interner for map keys and string values
    map_tables: List[Interner]
    #: doc indices the device path cannot express; resolved by the oracle
    fallback_docs: List[int] = field(default_factory=list)

    @property
    def num_docs(self) -> int:
        return self.ins_op.shape[0]


class _DocStreams:
    def __init__(self) -> None:
        self.ins: List[Tuple[int, int, int]] = []  # (ref, op, char)
        self.dels: List[int] = []
        self.marks: List[Tuple[int, ...]] = []  # MARK_COLS order
        self.maps: List[Tuple[int, int, int, int, int]] = []  # MAP_STREAM_COLS


def _pack_opid(opid, actors: OrderedActorTable) -> int:
    ctr, actor = opid
    if ctr > MAX_CTR:
        raise OverflowError(f"op counter {ctr} exceeds packed capacity")
    return pack_id(ctr, actors.intern(actor))


def _pack_boundary(b: Boundary, actors: OrderedActorTable) -> Tuple[int, int]:
    if b.elem is not None:
        return _BK[b.kind], _pack_opid(b.elem, actors)
    return _BK[b.kind], 0


def _encode_value(value, keys: Interner):
    """Map-set value -> (VK_*, payload), or None when inexpressible on
    device (nested containers, floats, out-of-range ints -> oracle)."""
    if isinstance(value, bool):
        return (VK_TRUE if value else VK_FALSE), 0
    if value is None:
        return VK_NULL, 0
    if isinstance(value, str):
        return VK_STR, keys.intern(value)
    if isinstance(value, int) and -(2**31) <= value < 2**31:
        return VK_INT, value
    return None


def encode_doc(
    changes: Sequence[Change],
    actors: OrderedActorTable,
    attrs: Interner,
    keys: Interner,
    text_obj=None,
    map_objs: Optional[set] = None,
    text_key: Optional[str] = None,
):
    """Split one document's causally-sorted changes into four streams
    (text inserts / deletes / marks, plus map-register writes).
    Returns (_DocStreams, ok, text_obj, text_key); ok=False -> host fallback.
    ``text_obj`` (the op id of the document's text list), ``map_objs`` (the
    packed ids of known map objects, mutated in place) and ``text_key`` carry
    across incremental rounds for streaming sessions."""
    streams = _DocStreams()
    if map_objs is None:
        map_objs = set()

    for change in changes:
        for op in change.ops:
            if text_obj is not None and op.obj == text_obj:
                if op.action == "set" and op.insert:
                    ref = 0 if op.elem_id is HEAD else _pack_opid(op.elem_id, actors)
                    streams.ins.append((ref, _pack_opid(op.opid, actors), ord(op.value)))
                elif op.action == "del":
                    streams.dels.append(_pack_opid(op.elem_id, actors))
                elif op.action in ("addMark", "removeMark"):
                    sk, se = _pack_boundary(op.start, actors)
                    ek, ee = _pack_boundary(op.end, actors)
                    attr = 0
                    if op.attrs:
                        # key-presence, not truthiness: empty url/id is a value
                        if "url" in op.attrs:
                            attr = attrs.intern(op.attrs["url"])
                        elif "id" in op.attrs:
                            attr = attrs.intern(op.attrs["id"])
                    streams.marks.append(
                        (
                            MA_ADD if op.action == "addMark" else MA_REMOVE,
                            MARK_INDEX[op.mark_type],
                            sk,
                            se,
                            ek,
                            ee,
                            _pack_opid(op.opid, actors),
                            attr,
                        )
                    )
                else:
                    return streams, False, text_obj, text_key
                continue

            # Map-object ops (reference src/micromerge.ts:1151-1175): the
            # containing object must be the root or a known child map.
            if op.obj is ROOT:
                pobj = OBJ_ROOT
            else:
                pobj = _pack_opid(op.obj, actors)
                if pobj not in map_objs:
                    return streams, False, text_obj, text_key
            if op.key is None:
                return streams, False, text_obj, text_key
            popid = _pack_opid(op.opid, actors)
            pkey = keys.intern(op.key)
            if op.action == "makeList":
                # exactly one list (the text sequence) is device-expressible
                if text_obj is not None:
                    return streams, False, text_obj, text_key
                text_obj = op.opid
                text_key = op.key
                streams.maps.append((pobj, pkey, popid, VK_TEXT, popid))
            elif op.action == "makeMap":
                map_objs.add(popid)
                streams.maps.append((pobj, pkey, popid, VK_OBJ, popid))
            elif op.action == "set" and not op.insert:
                encoded = _encode_value(op.value, keys)
                if encoded is None:
                    return streams, False, text_obj, text_key
                streams.maps.append((pobj, pkey, popid, *encoded))
            elif op.action == "del":
                streams.maps.append((pobj, pkey, popid, VK_DELETED, 0))
            else:
                return streams, False, text_obj, text_key
    return streams, True, text_obj, text_key


class DocEncoder:
    """Persistent per-document encoder for incremental (streaming) rounds.

    The actor table must be declared up front: packed int32 op-ID comparison
    equals (counter, actor-string) order only when actor indices follow string
    order, and a table that grows mid-session could violate that
    (utils/interning.OrderedActorTable).  A change from an undeclared actor
    marks the encoder failed; the streaming layer then falls back to scalar
    replay for that document.
    """

    def __init__(self, actor_names) -> None:
        self.actors = OrderedActorTable(actor_names)
        self.attrs = Interner()
        self.keys = Interner()
        self.text_obj = None
        self.text_key: Optional[str] = None
        self.map_objs: set = set()
        self.ok = len(self.actors) - 1 <= MAX_ACTORS

    def encode_increment(self, ordered_changes: Sequence[Change]):
        """Encode one round's causally-ordered new changes.  Returns
        (_DocStreams, ok); once not ok, the encoder stays failed."""
        if not self.ok:
            return _DocStreams(), False
        try:
            streams, ok, self.text_obj, self.text_key = encode_doc(
                ordered_changes, self.actors, self.attrs, self.keys,
                self.text_obj, self.map_objs, self.text_key,
            )
        except (OverflowError, KeyError):  # ctr overflow / undeclared actor
            ok = False
            streams = _DocStreams()
        self.ok = ok
        return streams, ok


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)


def encode_doc_streams(
    workloads: Sequence[Dict[str, List[Change]]],
):
    """The per-doc half of :func:`encode_workloads`: causal sort + intern +
    stream split for every doc, WITHOUT padding into a shared (D, K) shape.
    Returns ``(per_doc, fallback, actor_tables, attr_tables, map_tables)``.

    :func:`pad_doc_streams` then pads every doc into one shared shape."""
    per_doc: List[Optional[_DocStreams]] = []
    actor_tables: List[OrderedActorTable] = []
    attr_tables: List[Interner] = []
    map_tables: List[Interner] = []
    fallback: List[int] = []

    for doc_index, queues in enumerate(workloads):
        all_changes = [ch for log in queues.values() for ch in log]
        ordered = causal_sort(all_changes)
        actor_set = {ch.actor for ch in all_changes} | {
            op.opid[1] for ch in all_changes for op in ch.ops
        }
        actors = OrderedActorTable(actor_set)
        attrs = Interner()
        keys = Interner()
        # len(actors) includes the reserved index-0 None slot, so the largest
        # assigned actor index is len(actors) - 1, which must fit ACTOR_BITS.
        ok = len(actors) - 1 <= MAX_ACTORS
        streams = _DocStreams()
        if ok:
            try:
                streams, ok, _, _ = encode_doc(ordered, actors, attrs, keys)
            except OverflowError:
                ok = False
        if not ok:
            fallback.append(doc_index)
            streams = _DocStreams()
        per_doc.append(streams)
        actor_tables.append(actors)
        attr_tables.append(attrs)
        map_tables.append(keys)

    return per_doc, fallback, actor_tables, attr_tables, map_tables


def encode_workloads(
    workloads: Sequence[Dict[str, List[Change]]],
    insert_capacity: Optional[int] = None,
    delete_capacity: Optional[int] = None,
    mark_capacity: Optional[int] = None,
    map_capacity: Optional[int] = None,
) -> EncodedBatch:
    """Encode a batch of per-doc change-log sets (dict actor -> [Change])."""
    per_doc, fallback, actor_tables, attr_tables, map_tables = (
        encode_doc_streams(workloads)
    )
    return pad_doc_streams(
        per_doc,
        fallback,
        actor_tables,
        attr_tables,
        map_tables=map_tables,
        insert_capacity=insert_capacity,
        delete_capacity=delete_capacity,
        mark_capacity=mark_capacity,
        map_capacity=map_capacity,
    )


def pad_doc_streams(
    per_doc: Sequence[_DocStreams],
    fallback: List[int],
    actor_tables: List[OrderedActorTable],
    attr_tables: List[Interner],
    map_tables: Optional[List[Interner]] = None,
    insert_capacity: Optional[int] = None,
    delete_capacity: Optional[int] = None,
    mark_capacity: Optional[int] = None,
    map_capacity: Optional[int] = None,
) -> EncodedBatch:
    """Pad per-doc split streams into dense (D, K) arrays.  Docs exceeding a
    fixed capacity are appended to ``fallback`` and resolved by the scalar
    oracle."""
    d = len(per_doc)
    ki = insert_capacity or _round8(max((len(s.ins) for s in per_doc), default=0))
    kd = delete_capacity or _round8(max((len(s.dels) for s in per_doc), default=0))
    km = mark_capacity or _round8(max((len(s.marks) for s in per_doc), default=0))
    kp = map_capacity or _round8(max((len(s.maps) for s in per_doc), default=0))

    ins_ref = np.zeros((d, ki), np.int32)
    ins_op = np.zeros((d, ki), np.int32)
    ins_char = np.zeros((d, ki), np.int32)
    del_target = np.zeros((d, kd), np.int32)
    marks = {col: np.zeros((d, km), np.int32) for col in MARK_COLS}
    mark_count = np.zeros(d, np.int32)
    map_ops = {col: np.zeros((d, kp), np.int32) for col in MAP_STREAM_COLS}
    map_count = np.zeros(d, np.int32)
    num_ops = np.zeros(d, np.int32)

    for i, streams in enumerate(per_doc):
        if i in fallback:
            continue
        if (
            len(streams.ins) > ki or len(streams.dels) > kd
            or len(streams.marks) > km or len(streams.maps) > kp
        ):
            fallback.append(i)  # over this shape bucket: oracle fallback
            continue
        if streams.ins:
            arr = np.asarray(streams.ins, np.int32)
            ins_ref[i, : len(arr)] = arr[:, 0]
            ins_op[i, : len(arr)] = arr[:, 1]
            ins_char[i, : len(arr)] = arr[:, 2]
        if streams.dels:
            del_target[i, : len(streams.dels)] = streams.dels
        if streams.marks:
            arr = np.asarray(streams.marks, np.int32)
            for c, col in enumerate(MARK_COLS):
                marks[col][i, : len(arr)] = arr[:, c]
            mark_count[i] = len(arr)
        if streams.maps:
            arr = np.asarray(streams.maps, np.int32)
            for c, col in enumerate(MAP_STREAM_COLS):
                map_ops[col][i, : len(arr)] = arr[:, c]
            map_count[i] = len(arr)
        num_ops[i] = (
            len(streams.ins) + len(streams.dels)
            + len(streams.marks) + len(streams.maps)
        )

    return EncodedBatch(
        ins_ref=ins_ref,
        ins_op=ins_op,
        ins_char=ins_char,
        del_target=del_target,
        marks=marks,
        mark_count=mark_count,
        map_ops=map_ops,
        map_count=map_count,
        num_ops=num_ops,
        actor_tables=actor_tables,
        attr_tables=attr_tables,
        map_tables=map_tables if map_tables is not None else [Interner() for _ in range(d)],
        fallback_docs=sorted(fallback),
    )
