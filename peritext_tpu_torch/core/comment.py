"""Comment sidebar model (reference ``src/comment.ts`` + the ``comments`` map
the reference's ``RootDoc`` declares next to ``text``, src/bridge.ts:30-33).

The reference defines the type but no demo writes the map — comment *marks*
are the implemented half.  This framework implements both halves: comment
marks live in the CRDT mark engine (schema ``comment``, allow-multiple set
semantics), and this module stores the comment *bodies* in a nested CRDT map
``comments: {id: {id, actor, content}}`` so they replicate with the document
and resolve concurrent edits per-field by LWW, like any map entry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from .doc import Doc
from .types import Change, Patch

COMMENTS_KEY = "comments"


@dataclass(frozen=True)
class Comment:
    """One comment body (reference ``Comment``, src/comment.ts:5-12)."""

    id: str
    actor: str
    content: str


def put_comment(doc: Doc, comment: Comment) -> Tuple[Change, List[Patch]]:
    """Create or overwrite a comment body in the document's comments map.

    Creates the root ``comments`` map on first use; per-field sets mean
    concurrent edits to one comment converge field-wise by op-ID LWW.
    """
    ops = []
    if COMMENTS_KEY not in doc.root:
        ops.append({"path": [], "action": "makeMap", "key": COMMENTS_KEY})
    ops.append({"path": [COMMENTS_KEY], "action": "makeMap", "key": comment.id})
    path = [COMMENTS_KEY, comment.id]
    ops.extend(
        {"path": path, "action": "set", "key": k, "value": v}
        for k, v in (("id", comment.id), ("actor", comment.actor), ("content", comment.content))
    )
    return doc.change(ops)


def remove_comment(doc: Doc, comment_id: str) -> Tuple[Change, List[Patch]]:
    """Delete a comment body (the mark is removed separately via removeMark)."""
    return doc.change([{"path": [COMMENTS_KEY], "action": "del", "key": comment_id}])


def get_comment(doc: Doc, comment_id: str) -> Optional[Comment]:
    entry = doc.root.get(COMMENTS_KEY, {}).get(comment_id)
    if entry is None:
        return None
    return Comment(id=entry.get("id"), actor=entry.get("actor"), content=entry.get("content"))


def list_comments(doc: Doc) -> List[Comment]:
    """All comment bodies, id-sorted (deterministic across replicas)."""
    table = doc.root.get(COMMENTS_KEY, {})
    return [
        Comment(id=e.get("id"), actor=e.get("actor"), content=e.get("content"))
        for _, e in sorted(table.items())
    ]
