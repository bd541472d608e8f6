"""Patch emission for the batched path: host diff over resolved states.

The scalar oracle emits reference-shaped incremental patches from inside op
application (core/doc.py, mirroring src/micromerge.ts:1006-1138).  The device
path deliberately does not — per-op effects would serialize the kernel — so
patches are recovered here as a *host diff between two resolved states*.
Plain numpy and ``difflib``; nothing here touches the card.

The diff is exact, not heuristic: characters are keyed by their CRDT element
identity ``(ctr, actor)``, which is stable for a character's whole life, so
insert/delete placement never mis-aligns the way a text-only diff can.  Mark
changes on surviving characters become addMark/removeMark patches over
contiguous runs.  Patch semantics match the reference's (and
``testing/accumulate.py``'s) application model: text patches first, indices
against the evolving document; mark patches afterwards in final coordinates.
"""

from __future__ import annotations

from difflib import SequenceMatcher
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ..core.types import Patch
from ..utils.interning import Interner, OrderedActorTable
from .packed import unpack_id
from .resolve import ResolvedDocs

#: one visible character: (element identity, character, flattened MarkMap)
CharState = Tuple[Any, str, Dict[str, Any]]


def doc_chars_device(
    resolved: ResolvedDocs,
    doc_index: int,
    attr_table: Interner,
    elem_ids: np.ndarray,
    actor_table: OrderedActorTable,
    comment_table: "Interner | None" = None,
) -> List[CharState]:
    """Per-character (identity, char, marks) for one device doc.  Identities
    are unpacked to ``(ctr, actor_string)`` so they are stable across the
    device and scalar paths (a doc that demotes mid-session keeps diffing
    cleanly).  Mark extraction is shared with the span read path
    (decode.DocMarkDecoder) so the two can never diverge."""
    from .decode import DocMarkDecoder

    dec = DocMarkDecoder(resolved, doc_index, attr_table, comment_table)
    out: List[CharState] = []
    for slot in np.nonzero(dec.visible)[0]:
        ctr, actor_idx = unpack_id(int(elem_ids[slot]))
        out.append(
            ((ctr, actor_table.lookup(actor_idx)), chr(int(dec.chars[slot])),
             dec.marks_at(slot))
        )
    return out


def doc_chars_scalar(doc, path=("text",)) -> List[CharState]:
    """Per-character (identity, char, marks) from a scalar oracle Doc."""
    spans = doc.get_text_with_formatting(list(path))
    meta = doc.list_metadata(tuple(path))
    ids = [el.elem_id for el in meta if not el.deleted]
    out: List[CharState] = []
    pos = 0
    for span in spans:
        for ch in span["text"]:
            out.append((ids[pos], ch, _copy_marks(span["marks"])))
            pos += 1
    return out


from ..core.spans import copy_marks as _copy_marks  # shared MarkMap copy


def diff_patches(
    before: Sequence[CharState],
    after: Sequence[CharState],
    path: Sequence[str] = ("text",),
) -> List[Patch]:
    """Reference-shaped patches transforming ``before`` into ``after``.

    Application model (testing/accumulate.py): replay in order; text patches
    use indices valid at their point in the stream, mark patches come last in
    final-document coordinates.  ``accumulate_patches(as_insert_patches(
    before) + diff_patches(before, after))`` equals the span form of
    ``after`` — asserted by the differential tests.
    """
    path = list(path)
    ids_before = [c[0] for c in before]
    ids_after = [c[0] for c in after]
    sm = SequenceMatcher(a=ids_before, b=ids_after, autojunk=False)

    patches: List[Patch] = []
    mark_patches: List[Patch] = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag in ("delete", "replace"):
            patches.append(
                {"action": "delete", "path": path, "index": j1, "count": i2 - i1}
            )
        if tag in ("insert", "replace"):
            # one insert patch per run of identically-marked characters (an
            # insert patch carries a single marks dict for all its values)
            run_start = j1
            while run_start < j2:
                run_end = run_start + 1
                while run_end < j2 and after[run_end][2] == after[run_start][2]:
                    run_end += 1
                patches.append(
                    {
                        "action": "insert",
                        "path": path,
                        "index": run_start,
                        "values": [after[j][1] for j in range(run_start, run_end)],
                        "marks": _copy_marks(after[run_start][2]),
                    }
                )
                run_start = run_end
        if tag == "equal":
            for offset in range(i2 - i1):
                deltas = _mark_deltas(before[i1 + offset][2], after[j1 + offset][2])
                for delta in deltas:
                    _extend_mark_run(mark_patches, delta, j1 + offset, path)

    return patches + mark_patches


def _mark_deltas(before: Dict[str, Any], after: Dict[str, Any]):
    """(action, markType, attrs) changes turning ``before`` marks into
    ``after`` marks for one character."""
    deltas: List[Tuple[str, str, Any]] = []
    types = set(before) | set(after)
    for mark_type in sorted(types):
        b, a = before.get(mark_type), after.get(mark_type)
        if b == a:
            continue
        if mark_type == "comment":
            b_ids = {c["id"] for c in (b or [])}
            a_ids = {c["id"] for c in (a or [])}
            for cid in sorted(a_ids - b_ids):
                deltas.append(("addMark", "comment", {"id": cid}))
            for cid in sorted(b_ids - a_ids):
                deltas.append(("removeMark", "comment", {"id": cid}))
        elif a is None:
            deltas.append(("removeMark", mark_type, None))
        else:
            attrs = {k: v for k, v in a.items() if k != "active"}
            deltas.append(("addMark", mark_type, attrs or None))
    return deltas


def _extend_mark_run(
    mark_patches: List[Patch], delta, position: int, path: List[str]
) -> None:
    """Merge a per-character mark delta into the trailing run patch when it
    is contiguous and identical; otherwise open a new patch."""
    action, mark_type, attrs = delta
    for patch in reversed(mark_patches):
        if (
            patch["action"] == action
            and patch["markType"] == mark_type
            and patch.get("attrs") == attrs
        ):
            if patch["endIndex"] == position:
                patch["endIndex"] = position + 1
                return
            break  # same delta but non-contiguous: new run
    patch: Patch = {
        "action": action,
        "path": path,
        "startIndex": position,
        "endIndex": position + 1,
        "markType": mark_type,
    }
    if attrs is not None:
        patch["attrs"] = attrs
    mark_patches.append(patch)


def as_insert_patches(chars: Sequence[CharState], path=("text",)) -> List[Patch]:
    """A state expressed as the insert-patch stream that builds it from
    empty (the before-stream for differential tests)."""
    return diff_patches([], chars, path)
