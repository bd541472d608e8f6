"""Host-side decoding: resolved device state -> format spans / plain text.

The inverse boundary of ops/encode.py: un-interns attrs, converts codepoints
back to characters, and flattens per-character mark state into the same
merged span lists the scalar oracle's ``get_text_with_formatting`` returns,
so the two paths are directly comparable (byte-equality oracle).

Everything here is numpy: the batch layer moves the resolved planes to the
host once, then decodes.  ``comment_bits`` may arrive as any integer dtype
holding the unsigned 32-bit words (the port's resolve returns int64).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.spans import add_characters_to_spans
from ..core.types import FormatSpan
from ..schema import MARK_INDEX
from ..utils.interning import Interner
from .resolve import ResolvedDocs

_STRONG = MARK_INDEX["strong"]
_EM = MARK_INDEX["em"]
_LINK = MARK_INDEX["link"]


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
