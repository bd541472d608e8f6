"""The v2 wire frame encoder: one self-contained binary frame per batch of
changes, as a sending host emits it.

Frozen copy of ``encode_frame`` in ``peritext_tpu_torch/parallel/codec.py``
at commit a8ed934 (its v2 path, with the pure-Python varint; the native
varint gives the same bytes).  The session, traced and checked versions
and every decoder are left out.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

from ..reference.opids import HEAD, ROOT
from ..reference.schema import MARK_INDEX
from ..reference.types import AFTER, BEFORE, END_OF_TEXT, START_OF_TEXT, Change, Operation

_MAGIC = b"PTXF"
_VERSION = 2
_HEADER = struct.Struct("<4sBIIQQ")  # magic, ver, n_changes, n_strings, n_ints, payload_len
_BK_TO_INT = {BEFORE: 0, AFTER: 1, START_OF_TEXT: 2, END_OF_TEXT: 3}

_OP_INSERT, _OP_DEL, _OP_ADDMARK, _OP_REMOVEMARK, _OP_JSON = 0, 1, 2, 3, 4
# map-object ops (device map-register path; reference map LWW
# src/micromerge.ts:1151-1175)
_OP_MAKEMAP, _OP_MAPSET, _OP_MAPDEL = 5, 6, 7

# v2 per-op flag bits, packed above the 3-bit kind in the op's first int.
# Flags refer to the PREVIOUS non-JSON op of the same frame (encoder and
# decoders keep identical frame-scoped context):
#   OPID_SEQ — op id == (change.start_op + op_index, change.actor): the id
#              pair is elided (micromerge assigns change ops sequential
#              counters, reference makeNewOp src/micromerge.ts:876-886, so
#              this holds for essentially every op)
#   OBJ_PREV — same container object as the previous op (text ops all hit
#              the doc's text list): the obj triple is elided
#   REF_PREV — insert only: elem ref == previous op's op id (multi-char
#              inserts chain per-char ops, reference :604-613): ref elided
#   REF_HEAD — insert only: elem ref is HEAD: ref elided.  An insert with
#              neither ref flag carries an explicit (dctr, strid) anchor.
_F_OPID_SEQ, _F_OBJ_PREV, _F_REF_PREV, _F_REF_HEAD = 1, 2, 4, 8
_KIND_BITS = 3
_KIND_MASK = (1 << _KIND_BITS) - 1

# v2 change-header flag bits, packed above the actor strid in the header's
# first int (combo = strid << 4 | flags).  Each elides a field whose value
# the decoder's frame context predicts:
#   DSEQ_ZERO   — seq == last seq of this actor in frame + 1
#   DSTART_ZERO — start_op == this actor's previous change's op-counter end
#   DEPS_SAME   — dep set identical to this actor's previous change's
#                 (own-actor dep advancing to seq-1 as always)
#   NOPS_ONE    — exactly one op
_H_DSEQ_ZERO, _H_DSTART_ZERO, _H_DEPS_SAME, _H_NOPS_ONE = 1, 2, 4, 8
_H_FLAG_BITS = 4

# v2 insert codepoints are stored biased (cp - _CHAR_BIAS): the uniform
# zigzag stream spends 2 bytes on any value > 63, and unbiased ASCII letters
# all land there; centering on lower-case text puts common chars in 1 byte.
_CHAR_BIAS = 110

# value-kind encoding inside _OP_MAPSET (packed.VK_*: 1 str, 2 int, 3 true,
# 4 false, 5 null — VK_STR payload is a string-table index)
_VK_STR, _VK_INT, _VK_TRUE, _VK_FALSE, _VK_NULL = 1, 2, 3, 4, 5


# -- pure-python varint fallback (same bytes as the native core) ------------


def _py_varint_encode(values) -> bytes:
    out = bytearray()
    for v in values:
        z = ((int(v) << 1) ^ (int(v) >> 31)) & 0xFFFFFFFF
        while True:
            byte = z & 0x7F
            z >>= 7
            if z:
                out.append(byte | 0x80)
            else:
                out.append(byte)
                break
    return bytes(out)


class _StringTable:
    def __init__(self) -> None:
        self._index: Dict[str, int] = {}
        self.strings: List[str] = []

    def intern(self, s: str) -> int:
        idx = self._index.get(s)
        if idx is None:
            idx = len(self.strings)
            self._index[s] = idx
            self.strings.append(s)
        return idx


_NO_PREV = object()


class _FrameCtx:
    """Frame-scoped delta context shared by the encoder and every decoder.

    Op level: the previous non-JSON op's container object and op id.
    Change level (header compression): per-actor last seq and op-counter
    end seen in this frame, and per-actor last dep seq referenced — small
    fuzz-shaped changes (1-2 ops) are otherwise dominated by header bytes."""

    __slots__ = ("prev_obj", "prev_opid", "last_seq", "prev_end", "dep_base",
                 "dep_set", "dep_dict")

    def __init__(self) -> None:
        self.prev_obj = _NO_PREV
        self.prev_opid = None
        self.last_seq: Dict[int, int] = {}   # actor strid -> last change seq
        self.prev_end: Dict[int, int] = {}   # actor strid -> start_op + nops
        self.dep_base: Dict[int, int] = {}   # actor strid -> last dep seq
        #: actor strid -> (own_elided, ((dep strid, dep seq), ...)) of the
        #: actor's previous change in frame (DEPS_SAME reference)
        self.dep_set: Dict[int, tuple] = {}
        #: decode side only: actor strid -> the materialized string-keyed
        #: dict for dep_set's explicit part, shared across a DEPS_SAME run
        #: so N same-clock changes cost one dict, not N copies of it
        self.dep_dict: Dict[int, dict] = {}


def _flatten_op(
    op: Operation, table: _StringTable, ints: List[int],
    ctx: _FrameCtx, change: Change, op_index: int,
) -> None:
    def opid_pair(opid) -> Tuple[int, int]:
        return int(opid[0]), table.intern(opid[1])

    def obj_triple(obj):
        if obj is ROOT:
            return (0, 0, 0)
        ctr, actor = opid_pair(obj)
        return (1, ctr, actor)

    def emit(kind: int, body: Tuple[int, ...], ref=None, extra_flags: int = 0) -> None:
        """v2 op emission: flags elide obj/opid/ref when the frame context
        predicts them; `ref` (insert only) is the elem_id or HEAD.  Explicit
        element counters (insert ref, delete target, mark anchors) are
        stored as deltas against the op's own counter — same-doc ids cluster,
        so the zigzag varint usually fits one byte."""
        flags = extra_flags
        if op.opid == (change.start_op + op_index, change.actor):
            flags |= _F_OPID_SEQ
        if ctx.prev_obj is not _NO_PREV and op.obj == ctx.prev_obj:
            flags |= _F_OBJ_PREV
        ref_ints: Tuple[int, ...] = ()
        if kind == _OP_INSERT:
            if ctx.prev_opid is not None and ref == ctx.prev_opid:
                flags |= _F_REF_PREV
            elif ref is HEAD:
                flags |= _F_REF_HEAD
            else:
                ref_ints = (int(ref[0]) - int(op.opid[0]), table.intern(ref[1]))
        ints.append(kind | (flags << _KIND_BITS))
        if not flags & _F_OBJ_PREV:
            ints.extend(obj_triple(op.obj))
        if not flags & _F_OPID_SEQ:
            ints.extend(opid_pair(op.opid))
        ints.extend(ref_ints)
        ints.extend(body)
        ctx.prev_obj = op.obj
        ctx.prev_opid = op.opid

    def spill() -> None:
        # JSON rows carry their ids inside the JSON; they neither read nor
        # advance the delta context (decoders match)
        ints.extend([_OP_JSON, table.intern(json.dumps(op.to_json()))])

    fast_insert = (
        op.action == "set"
        and op.insert
        and isinstance(op.value, str)
        and len(op.value) == 1
        and op.obj is not ROOT
    )
    if fast_insert:
        emit(_OP_INSERT, (ord(op.value) - _CHAR_BIAS,), ref=op.elem_id)
    elif op.action == "del" and op.elem_id is not None and op.obj is not ROOT:
        emit(_OP_DEL, (
            int(op.elem_id[0]) - int(op.opid[0]), table.intern(op.elem_id[1]),
        ))
    elif op.action in ("addMark", "removeMark") and op.mark_type in MARK_INDEX:
        # Fast path only for the exact attr shape the decoder reconstructs
        # ({"url": str} on link, {"id": str} on comment); everything else —
        # extra keys, {}, attrs on other mark types — spills to JSON so the
        # round-trip stays lossless.
        expected_key = {"link": "url", "comment": "id"}.get(op.mark_type)
        attr_idx = 0
        if op.attrs:
            if (
                expected_key is not None
                and set(op.attrs) == {expected_key}
                and isinstance(op.attrs[expected_key], str)
            ):
                attr_idx = table.intern(op.attrs[expected_key]) + 1
            else:  # exotic attrs: JSON spillover
                spill()
                return
        elif op.attrs is not None:  # attrs == {} must round-trip as {}
            spill()
            return

        mtype = MARK_INDEX[op.mark_type]
        if mtype > 3:  # 2-bit packing below; larger schemas spill losslessly
            spill()
            return
        sk = _BK_TO_INT[op.start.kind]
        ek = _BK_TO_INT[op.end.kind]
        if (op.start.elem is None) != (sk >= 2) or (op.end.elem is None) != (ek >= 2):
            spill()  # malformed boundary shape: JSON keeps it lossless
            return
        # one packed kinds int (mtype|sk|ek, 2 bits each, <= 63: one byte)
        # + anchors only where the boundary kind has one; the end counter is
        # delta'd against the start anchor (spans are short) else the op id
        body: List[int] = [mtype | (sk << 2) | (ek << 4)]
        base_ctr = int(op.opid[0])
        if op.start.elem is not None:
            body += [int(op.start.elem[0]) - base_ctr,
                     table.intern(op.start.elem[1])]
            base_ctr = int(op.start.elem[0])
        if op.end.elem is not None:
            body += [int(op.end.elem[0]) - base_ctr,
                     table.intern(op.end.elem[1])]
        body.append(attr_idx)
        kind = _OP_ADDMARK if op.action == "addMark" else _OP_REMOVEMARK
        emit(kind, tuple(body))
    elif op.action == "makeList" and op.key is not None:
        # v2 fast path: makeList rides the makeMap kind with the (otherwise
        # insert-only) _F_REF_HEAD bit — v1 spilled it to a ~70-byte JSON
        # string per frame, the single largest string-table entry
        emit(_OP_MAKEMAP, (table.intern(op.key),), extra_flags=_F_REF_HEAD)
    elif op.action == "makeMap" and op.key is not None:
        emit(_OP_MAKEMAP, (table.intern(op.key),))
    elif (
        op.action == "del" and op.key is not None and op.elem_id is None
    ):
        emit(_OP_MAPDEL, (table.intern(op.key),))
    elif op.action == "set" and not op.insert and op.key is not None:
        v = op.value
        if isinstance(v, bool):
            enc = (_VK_TRUE if v else _VK_FALSE, 0)
        elif v is None:
            enc = (_VK_NULL, 0)
        elif isinstance(v, str):
            enc = (_VK_STR, table.intern(v))
        elif isinstance(v, int) and -(2**31) <= v < 2**31:
            enc = (_VK_INT, v)
        else:  # floats / containers: JSON spillover keeps the codec lossless
            spill()
            return
        emit(_OP_MAPSET, (table.intern(op.key), *enc))
    else:
        spill()


def encode_frame(changes: List[Change]) -> bytes:
    """Pack a batch of changes into one binary frame.

    v2 change headers are delta-encoded against the frame-scoped per-actor
    state (``_FrameCtx``): seq against the actor's last seq in frame + 1,
    start_op against the actor's previous change's op-counter end, dep seqs
    against the per-actor dep chain — and the actor's own ``(actor, seq-1)``
    dep (which ``change()`` always records, reference
    src/micromerge.ts:572-577) is elided behind a flag bit in the dep count.
    Small changes (1-2 ops, the anti-entropy norm) drop from ~11 to ~4
    header bytes."""
    return _encode_frame(changes, _StringTable())


def _encode_frame(changes: List[Change], table: "_StringTable") -> bytes:
    ints: List[int] = []
    ctx = _FrameCtx()
    for change in changes:
        a = table.intern(change.actor)
        dseq = change.seq - ctx.last_seq.get(a, 0) - 1
        dstart = change.start_op - ctx.prev_end.get(a, 0)
        deps = sorted((change.deps or {}).items())
        own_elided = 0
        explicit = []
        for actor, seq in deps:
            if actor == change.actor and seq == change.seq - 1 and not own_elided:
                own_elided = 1
                continue
            explicit.append((table.intern(actor), seq))
        deps_same = ctx.dep_set.get(a) == (own_elided, tuple(explicit))
        hflags = (
            (_H_DSEQ_ZERO if dseq == 0 else 0)
            | (_H_DSTART_ZERO if dstart == 0 else 0)
            | (_H_DEPS_SAME if deps_same else 0)
            | (_H_NOPS_ONE if len(change.ops) == 1 else 0)
        )
        ints.append((a << _H_FLAG_BITS) | hflags)
        if dseq != 0:
            ints.append(dseq)
        if dstart != 0:
            ints.append(dstart)
        if not deps_same:
            # dep-count wire int: (count << 2) | (delta_mode << 1) | own_elided.
            # Delta mode sends only the ENTRIES THAT CHANGED vs this actor's
            # previous dep set (vector clocks advance one entry per received
            # change, so most of the clock repeats change-to-change).
            stored = ctx.dep_set.get(a)
            delta_ok = (
                stored is not None and stored[0] == own_elided
                and [da for da, _ in stored[1]] == [da for da, _ in explicit]
            )
            if delta_ok:
                changed = [
                    (da, ds, old)
                    for (da, ds), (_, old) in zip(explicit, stored[1])
                    if ds != old
                ]
                ints.append((len(changed) << 2) | 2 | own_elided)
                for da, ds, old in changed:
                    ints += [da, ds - old]
                    ctx.dep_base[da] = ds
            else:
                ints.append((len(explicit) << 2) | own_elided)
                for da, ds in explicit:
                    # base: the larger of the dep chain and the actor's last
                    # seq seen in frame — causally-ordered frames make deps
                    # implied (delta 0), per-actor-grouped frames chain well
                    base = max(ctx.dep_base.get(da, 0), ctx.last_seq.get(da, 0))
                    ints += [da, ds - base]
                    ctx.dep_base[da] = ds
            ctx.dep_set[a] = (own_elided, tuple(explicit))
        if len(change.ops) != 1:
            ints.append(len(change.ops))
        ctx.last_seq[a] = change.seq
        ctx.prev_end[a] = change.start_op + len(change.ops)
        for i, op in enumerate(change.ops):
            _flatten_op(op, table, ints, ctx, change, i)

    payload = _py_varint_encode(ints)
    parts = [_HEADER.pack(_MAGIC, _VERSION, len(changes),
                          len(table.strings), len(ints), len(payload))]
    parts += _string_section(table.strings)
    parts.append(payload)
    return b"".join(parts)


def _string_section(strings) -> List[bytes]:
    out = []
    for s in strings:
        raw = s.encode("utf-8")
        out.append(_py_varint_encode([len(raw)]))
        out.append(raw)
    return out

