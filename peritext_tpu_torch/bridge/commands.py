"""Editor commands — the headless analog of the reference keymap.

The reference binds Mod-b / Mod-i / Mod-e / Mod-k to mark toggles
(``src/bridge.ts:60-74``): bold and italic toggle, Mod-e adds a comment with a
fresh uuid, Mod-k wraps the selection in a link.  Here those are plain
functions over an :class:`~.bridge.Editor` and a selection given as editor
positions (1-based, like the reference's ProseMirror selections).
"""

from __future__ import annotations

from typing import Optional

from ..core.types import Change
from .bridge import Editor, content_index_from_pos, new_comment_id
from .model import Transaction


def _range_has_mark(editor: Editor, from_pos: int, to_pos: int, mark_type: str) -> bool:
    start, end = content_index_from_pos(from_pos), content_index_from_pos(to_pos)
    chars = editor.view.marks[start:end]
    return bool(chars) and all(mark_type in m for m in chars)


def toggle_mark(editor: Editor, from_pos: int, to_pos: int, mark_type: str) -> Change:
    """ProseMirror-style toggle: remove if the whole range is marked, else add."""
    txn = Transaction()
    if _range_has_mark(editor, from_pos, to_pos, mark_type):
        txn.remove_mark(from_pos, to_pos, mark_type)
    else:
        txn.add_mark(from_pos, to_pos, mark_type)
    return editor.dispatch(txn)


def toggle_bold(editor: Editor, from_pos: int, to_pos: int) -> Change:
    """Mod-b (reference src/bridge.ts:61)."""
    return toggle_mark(editor, from_pos, to_pos, "strong")


def toggle_italic(editor: Editor, from_pos: int, to_pos: int) -> Change:
    """Mod-i (reference src/bridge.ts:62)."""
    return toggle_mark(editor, from_pos, to_pos, "em")


def add_comment(
    editor: Editor, from_pos: int, to_pos: int, comment_id: Optional[str] = None
) -> Change:
    """Mod-e: comment on the selection with a fresh id (src/bridge.ts:63-67)."""
    cid = comment_id if comment_id is not None else new_comment_id()
    return editor.dispatch(
        Transaction().add_mark(from_pos, to_pos, "comment", {"id": cid})
    )


def set_link(editor: Editor, from_pos: int, to_pos: int, url: str) -> Change:
    """Mod-k: link the selection to ``url`` (src/bridge.ts:68-73)."""
    return editor.dispatch(
        Transaction().add_mark(from_pos, to_pos, "link", {"url": url})
    )


def type_text(editor: Editor, pos: int, text: str) -> Change:
    """Insert ``text`` at an editor position (plain keystroke input)."""
    return editor.dispatch(Transaction().insert_text(pos, text))


def delete_range(editor: Editor, from_pos: int, to_pos: int) -> Change:
    return editor.dispatch(Transaction().delete(from_pos, to_pos))
