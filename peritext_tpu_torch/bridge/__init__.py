"""Editor bridge: headless editor model + CRDT transforms (reference
``src/bridge.ts``)."""

from .bridge import (
    DEFAULT_INITIAL_TEXT,
    Editor,
    EditorEvent,
    apply_transaction_to_doc,
    content_index_from_pos,
    create_editor,
    editor_doc_from_crdt,
    initialize_docs,
    new_comment_id,
    patch_to_steps,
    pos_from_content_index,
    transaction_to_input_ops,
)
from .model import (
    AddMarkStep,
    EditorDoc,
    RemoveMarkStep,
    ReplaceStep,
    ResetStep,
    Step,
    Transaction,
)

__all__ = [
    "DEFAULT_INITIAL_TEXT",
    "AddMarkStep",
    "Editor",
    "EditorDoc",
    "EditorEvent",
    "RemoveMarkStep",
    "ReplaceStep",
    "ResetStep",
    "Step",
    "Transaction",
    "apply_transaction_to_doc",
    "content_index_from_pos",
    "create_editor",
    "editor_doc_from_crdt",
    "initialize_docs",
    "new_comment_id",
    "patch_to_steps",
    "pos_from_content_index",
    "transaction_to_input_ops",
]
