"""Host-side decoding: resolved device state -> format spans / plain text.

The inverse boundary of ops/encode.py: un-interns attrs, converts codepoints
back to characters, and flattens per-character mark state into the same
merged span lists the scalar oracle's ``get_text_with_formatting`` returns,
so the two paths are directly comparable (byte-equality oracle).

Everything here is numpy: the batch layer moves the resolved planes to the
host once, then decodes; the streaming sweeps decode the visible-prefix
:class:`CompactBlock` the session gathers on the card.  ``comment_bits``
may arrive as any integer dtype holding the unsigned 32-bit words (the
port's resolve returns int64).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.spans import add_characters_to_spans
from ..core.types import FormatSpan
from ..schema import MARK_INDEX
from ..utils.interning import Interner
from .resolve import ResolvedDocs

_STRONG = MARK_INDEX["strong"]
_EM = MARK_INDEX["em"]
_LINK = MARK_INDEX["link"]


class DocMarkDecoder:
    """Per-slot MarkMap extraction for ONE doc of a (numpy-converted)
    ResolvedDocs batch — shared by the span read path and the patch diff
    path (ops/patches.py).  Per-doc rows are sliced once at construction;
    ``marks_at`` is then cheap per visible slot."""

    def __init__(self, resolved: ResolvedDocs, doc_index: int, attr_table: Interner,
                 comment_table: Optional[Interner] = None):
        d = doc_index
        self._attrs = attr_table
        # comment-plane ids may live in a separate (per-doc dense) table:
        # they index capacity-C planes, unlike link attrs which are opaque
        self._comment_ids = comment_table if comment_table is not None else attr_table
        self.visible = np.asarray(resolved.visible[d])
        self.chars = np.asarray(resolved.char[d])
        self._lww = np.asarray(resolved.lww_active[d])
        self._link_attr = np.asarray(resolved.link_attr[d])
        # unpack the (W, S) 32-bit comment words to a (W*32, S) bool plane
        bits = np.asarray(resolved.comment_bits[d]).astype(np.int64)
        shifts = np.arange(32, dtype=np.int64)
        self._comments = (
            (bits[:, None, :] >> shifts[None, :, None]) & 1
        ).astype(bool).reshape(-1, bits.shape[-1])

    def marks_at(self, slot: int) -> dict:
        marks: dict = {}
        if self._lww[_STRONG, slot]:
            marks["strong"] = {"active": True}
        if self._lww[_EM, slot]:
            marks["em"] = {"active": True}
        if self._lww[_LINK, slot]:
            url = self._attrs.lookup(int(self._link_attr[slot]))
            marks["link"] = {"active": True, "url": url}
        active_ids = sorted(
            self._comment_ids.lookup(int(c))
            for c in np.nonzero(self._comments[:, slot])[0]
        )
        if active_ids:
            marks["comment"] = [{"id": cid} for cid in active_ids]
        return marks


def decode_doc_spans(
    resolved: ResolvedDocs, doc_index: int, attr_table: Interner,
    comment_table: Optional[Interner] = None,
) -> List[FormatSpan]:
    """Decode one document of a (numpy-converted) ResolvedDocs batch."""
    dec = DocMarkDecoder(resolved, doc_index, attr_table, comment_table)
    spans: List[FormatSpan] = []
    for slot in np.nonzero(dec.visible)[0]:
        add_characters_to_spans(
            [chr(int(dec.chars[slot]))], dec.marks_at(slot), spans
        )
    return spans


def _comment_ids_from_bits(row_bits, comment_table: Interner):
    """Sorted comment-id strings from one slot's packed uint32 words."""
    ids = []
    for w in range(row_bits.shape[0]):
        v = int(row_bits[w])
        while v:
            b = (v & -v).bit_length() - 1
            ids.append(comment_table.lookup(w * 32 + b))
            v &= v - 1
    return sorted(ids)


def _block_flat(resolved: ResolvedDocs, doc_mask=None):
    """Flatten a (numpy-converted) resolved block to its visible characters
    in doc-major order plus per-char mark features and run boundaries.

    Returns ``(rows, cols, seg_starts, seg_ends, text, lww, link, bits)``
    where a segment is a maximal run of same-doc, identically-marked
    characters — the unit all read paths decode at (marks are built once per
    segment, not per character).  ``doc_mask`` (bool (B,)) excludes docs
    (fallback/overflow rows may hold residue with out-of-table ids)."""
    vis = np.asarray(resolved.visible)
    if doc_mask is not None:
        vis = vis & np.asarray(doc_mask)[:, None]
    rows, cols = np.nonzero(vis)
    if len(rows) == 0:
        return rows, cols, rows, rows, "", None, None, None, None
    chars = np.asarray(resolved.char)[rows, cols]
    lww = np.asarray(resolved.lww_active)[rows, :, cols]  # (N, T)
    link = np.asarray(resolved.link_attr)[rows, cols]
    bits = np.asarray(resolved.comment_bits)[rows, :, cols]  # (N, W) uint32
    feat = np.concatenate(
        [lww.astype(np.int64), link[:, None].astype(np.int64),
         bits.astype(np.int64)],
        axis=1,
    )
    boundary = np.ones(len(rows), bool)
    boundary[1:] = (rows[1:] != rows[:-1]) | np.any(feat[1:] != feat[:-1], axis=1)
    seg_starts = np.nonzero(boundary)[0]
    seg_ends = np.append(seg_starts[1:], len(rows))
    text = "".join(map(chr, chars.tolist()))
    return rows, cols, seg_starts, seg_ends, text, lww, link, bits, feat


def _segment_marks(s: int, lww, link, bits, attrs: Interner,
                   comments: Interner) -> dict:
    marks: dict = {}
    if lww[s, _STRONG]:
        marks["strong"] = {"active": True}
    if lww[s, _EM]:
        marks["em"] = {"active": True}
    if lww[s, _LINK]:
        marks["link"] = {"active": True, "url": attrs.lookup(int(link[s]))}
    if bits[s].any():
        active = _comment_ids_from_bits(bits[s], comments)
        if active:
            marks["comment"] = [{"id": cid} for cid in active]
    return marks


def _copy_marks(marks: dict) -> dict:
    """Copy a memoized marks dict ALL the way down (values are tiny:
    ``{"active": True}``, a link dict, a comment-id list) so a caller
    mutating one span's marks — including nested values — cannot reformat
    unrelated spans sharing the memo entry."""
    return {
        k: [dict(e) for e in v] if isinstance(v, list) else dict(v)
        for k, v in marks.items()
    }


def decode_block_spans(resolved: ResolvedDocs, attr_of, comment_of, doc_mask=None):
    """Vectorized span decode of a WHOLE resolved block in one pass.

    The visible characters of every doc are extracted with numpy, mark-run
    boundaries are computed vectorized, and Python touches only SEGMENTS
    (runs of identically-marked text).

    ``attr_of(d)`` / ``comment_of(d)`` return the attr / comment-id interner
    for block-local doc d; ``doc_mask`` excludes (fallback/overflow) docs.
    Returns a span list per doc (empty for docs with no visible text).

    Marks dicts are MEMOIZED by (interner identities, feature bytes) — a
    100K-doc sweep has millions of segments but only dozens of distinct mark
    combinations, so the per-segment ``_segment_marks`` work collapses to a
    dict hit.  Each span still gets its OWN tiny copy: a caller mutating one
    span's marks must not silently reformat unrelated spans."""
    n_docs = np.asarray(resolved.visible).shape[0]
    return _spans_from_flat(_block_flat(resolved, doc_mask), attr_of,
                            comment_of, n_docs)


def _spans_from_flat(flat, attr_of, comment_of, n_docs: int):
    """Segment loop of the span decoder.  One memoized ``_segment_marks`` per distinct
    (interners, features) key; one defensive copy per span."""
    out = [[] for _ in range(n_docs)]
    rows, _, seg_starts, seg_ends, text, lww, link, bits, feat = flat
    cache: dict = {}
    for s, e in zip(seg_starts.tolist(), seg_ends.tolist()):
        d = int(rows[s])
        attrs, comments = attr_of(d), comment_of(d)
        # the per-doc comment table only shapes marks when the segment has
        # comment bits — keying on its identity otherwise would give every
        # doc its own memo row and defeat the cross-doc dedup entirely
        has_c = bool(bits[s].any())
        key = (id(attrs), id(comments) if has_c else 0, feat[s].tobytes())
        marks = cache.get(key)
        if marks is None:
            marks = cache[key] = _segment_marks(s, lww, link, bits, attrs, comments)
        out[d].append({"marks": _copy_marks(marks), "text": text[s:e]})
    return out


def _char_states_from_flat(flat, packed_elems, actor_table, attr_of,
                           comment_of, n_docs: int):
    """Segment loop of the char-state decoders: per-doc ``(identity, char,
    marks)`` lists.  Characters in a segment share ONE per-segment marks
    copy (diff consumers compare marks by equality); the memoized master
    never escapes.  ``packed_elems`` are the (N,) packed elem ids aligned
    with the flat character order."""
    from .packed import ACTOR_BITS, MAX_ACTORS

    out = [[] for _ in range(n_docs)]
    rows, _, seg_starts, seg_ends, text, lww, link, bits, feat = flat
    if len(rows) == 0:
        return out
    ctrs = (packed_elems >> ACTOR_BITS).tolist()
    actor_idx = (packed_elems & MAX_ACTORS).tolist()
    actor_names = [actor_table.lookup(i) for i in range(len(actor_table))]
    cache: dict = {}
    for s, e in zip(seg_starts.tolist(), seg_ends.tolist()):
        d = int(rows[s])
        attrs, comments = attr_of(d), comment_of(d)
        has_c = bool(bits[s].any())  # see _spans_from_flat on the memo key
        key = (id(attrs), id(comments) if has_c else 0, feat[s].tobytes())
        marks = cache.get(key)
        if marks is None:
            marks = cache[key] = _segment_marks(s, lww, link, bits, attrs, comments)
        seg_marks = _copy_marks(marks)
        bucket = out[d]
        for j in range(s, e):
            bucket.append(((ctrs[j], actor_names[actor_idx[j]]), text[j], seg_marks))
    return out


def block_char_states(resolved: ResolvedDocs, elem_id_block, actor_table,
                      attr_of, comment_of, doc_mask=None):
    """Per-doc ``(identity, char, marks)`` lists for a whole (numpy) block —
    the batched twin of ops/patches.doc_chars_device."""
    vis = np.asarray(resolved.visible)
    flat = _block_flat(resolved, doc_mask)
    rows, cols = flat[0], flat[1]
    if len(rows) == 0:
        return [[] for _ in range(vis.shape[0])]
    packed = np.asarray(elem_id_block)[rows, cols]
    return _char_states_from_flat(flat, packed, actor_table, attr_of,
                                  comment_of, vis.shape[0])


def decode_doc_text(resolved: ResolvedDocs, doc_index: int) -> str:
    visible = np.asarray(resolved.visible[doc_index])
    chars = np.asarray(resolved.char[doc_index])
    return "".join(chr(int(c)) for c in chars[visible])


def decode_doc_root(state, resolved: ResolvedDocs, doc_index: int, keys: Interner):
    """Materialize one doc's root map from its device LWW registers — the
    device twin of the scalar oracle's ``Doc.root`` (object graph walk from
    the reference's nested object store, src/micromerge.ts:520-539).

    ``state`` is a (numpy-converted) PackedDocs; VK_TEXT registers expand to
    the visible character list so ``root == oracle.root`` exactly."""
    from .packed import (
        OBJ_ROOT,
        VK_DELETED,
        VK_FALSE,
        VK_INT,
        VK_NULL,
        VK_OBJ,
        VK_STR,
        VK_TEXT,
        VK_TRUE,
    )

    d = doc_index
    n = int(np.asarray(state.num_regs[d]))
    r_obj = np.asarray(state.r_obj[d])[:n]
    r_key = np.asarray(state.r_key[d])[:n]
    r_op = np.asarray(state.r_op[d])[:n]
    r_kind = np.asarray(state.r_kind[d])[:n]
    r_val = np.asarray(state.r_val[d])[:n]
    visible = np.asarray(resolved.visible[d])
    chars = np.asarray(resolved.char[d])

    by_container: dict = {}
    for i in range(n):
        if r_op[i] == 0:
            continue
        by_container.setdefault(int(r_obj[i]), []).append(i)

    def build(obj_id: int, path: frozenset = frozenset()) -> dict:
        if obj_id in path:  # malformed peer: self/ancestor reference
            return {}
        path = path | {obj_id}
        out: dict = {}
        for i in by_container.get(obj_id, ()):
            kind = int(r_kind[i])
            if kind == VK_DELETED:
                continue
            key = keys.lookup(int(r_key[i]))
            if kind == VK_STR:
                out[key] = keys.lookup(int(r_val[i]))
            elif kind == VK_INT:
                out[key] = int(r_val[i])
            elif kind == VK_TRUE:
                out[key] = True
            elif kind == VK_FALSE:
                out[key] = False
            elif kind == VK_NULL:
                out[key] = None
            elif kind == VK_OBJ:
                out[key] = build(int(r_val[i]), path)
            elif kind == VK_TEXT:
                out[key] = [chr(int(c)) for c in chars[visible]]
        return out

    return build(OBJ_ROOT)


# -- compact (visible-prefix) block decode ----------------------------------
#
# The full resolved planes are (D, S)-shaped over SLOT capacity; a sweep only
# needs the visible characters.  CompactBlock is the same information
# gathered on the card to a visible-prefix layout of bucketed width W << S,
# with the LWW planes bit-packed, and brought to the host in one transfer.


class CompactBlock:
    """Numpy visible-prefix planes of one resolved block.

    ``n_vis[d]`` chars of doc ``d`` live at columns ``0..n_vis[d]`` of:
    ``char``(int32), ``elem``(packed int32 elem ids), ``link``(int32 attr
    ids), ``lww``(uint8 bitmask over LWW mark types), ``comment_bits``
    ((D, Wd, W) uint32).  ``overflow`` is carried for the device/replay
    routing mask."""

    __slots__ = ("n_vis", "char", "elem", "link", "lww", "comment_bits",
                 "overflow")

    def __init__(self, n_vis, char, elem, link, lww, comment_bits, overflow):
        self.n_vis = np.asarray(n_vis)
        self.char = np.asarray(char)
        self.elem = np.asarray(elem)
        self.link = np.asarray(link)
        self.lww = np.asarray(lww)
        self.comment_bits = np.asarray(comment_bits)
        self.overflow = np.asarray(overflow)

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in self.__slots__)


def _block_flat_compact(c: CompactBlock, doc_mask=None):
    """Compact-layout twin of :func:`_block_flat`: flatten to doc-major
    visible characters + per-char features + same-mark run boundaries.
    Columns are CHARACTER indices (the compact layout's native order), and
    the per-type LWW bools are unpacked from the bitmask plane."""
    d, w = c.char.shape
    vis = np.arange(w)[None, :] < c.n_vis[:, None]
    if doc_mask is not None:
        vis &= np.asarray(doc_mask)[:, None]
    rows, cols = np.nonzero(vis)
    if len(rows) == 0:
        return rows, cols, rows, rows, "", None, None, None, None
    chars = c.char[rows, cols]
    lww_bits = c.lww[rows, cols].astype(np.int64)  # (N,) packed
    shifts = np.arange(8, dtype=np.int64)  # uint8 plane: up to 8 LWW types
    lww = ((lww_bits[:, None] >> shifts[None, :]) & 1).astype(bool)  # (N, 8)
    link = c.link[rows, cols]
    bits = (
        c.comment_bits[rows, :, cols]
        if c.comment_bits.shape[1]
        else np.zeros((len(rows), 0), np.uint32)
    )  # (N, Wd) uint32
    feat = np.concatenate(
        [lww_bits[:, None], link[:, None].astype(np.int64), bits.astype(np.int64)],
        axis=1,
    )
    boundary = np.ones(len(rows), bool)
    boundary[1:] = (rows[1:] != rows[:-1]) | np.any(feat[1:] != feat[:-1], axis=1)
    seg_starts = np.nonzero(boundary)[0]
    seg_ends = np.append(seg_starts[1:], len(rows))
    text = "".join(map(chr, chars.tolist()))
    return rows, cols, seg_starts, seg_ends, text, lww, link, bits, feat


def decode_block_spans_compact(c: CompactBlock, attr_of, comment_of,
                               doc_mask=None):
    """:func:`decode_block_spans` over a :class:`CompactBlock` — identical
    output, from one visible-prefix transfer instead of the full planes."""
    return _spans_from_flat(_block_flat_compact(c, doc_mask), attr_of,
                            comment_of, c.char.shape[0])


def block_char_states_compact(c: CompactBlock, actor_table, attr_of,
                              comment_of, doc_mask=None):
    """:func:`block_char_states` over a :class:`CompactBlock`: per-doc
    ``(identity, char, marks)`` lists, identities unpacked from the
    compacted elem-id plane."""
    flat = _block_flat_compact(c, doc_mask)
    rows, cols = flat[0], flat[1]
    if len(rows) == 0:
        return [[] for _ in range(c.char.shape[0])]
    packed = c.elem[rows, cols]
    return _char_states_from_flat(flat, packed, actor_table, attr_of,
                                  comment_of, c.char.shape[0])
