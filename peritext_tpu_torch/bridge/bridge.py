"""The editor ↔ CRDT bridge (reference ``src/bridge.ts``).

Bidirectional transform at the framework's stable public boundary:

* **down** (local edit): an editor :class:`~.model.Transaction` becomes
  ``InputOperation`` dicts (``transaction_to_input_ops``, reference
  ``applyProsemirrorTransactionToMicromergeDoc`` ``src/bridge.ts:417-531``),
  is applied via ``Doc.change``, and the resulting patches are re-applied to
  the editor view — the view is *always* driven by patches, never by the
  original transaction, so the incremental path is exercised on every edit.
* **up** (remote change): ``Doc.apply_change`` patches become editor steps
  (``patch_to_steps``, reference
  ``extendProsemirrorTransactionWithMicromergePatch`` ``src/bridge.ts:138-199``).

Editor positions are 1-based (paragraph-open token at 0); all ±1 shifting
happens here and only here (reference ``src/bridge.ts:360-371``).

Two deviations from the JAX package's bridge, both for ``start_queue=True``,
where a peer's timer thread delivers remote changes (``_receive``) while
the caller's thread dispatches local ones:

* each :class:`Editor` holds a lock over its replica, view and session;
  unguarded, the two threads interleave and the view can take one patch
  twice;
* no failure is lost on the timer thread.  A device session that fails
  after its replica took a change leaves the view behind the replica, so
  the editor keeps the error and every later call on it raises; a timer
  flush that fails (a peer's delivery raised) is kept by the flushing
  editor and raised once by its next ``dispatch``, ``sync`` or
  ``rerender``.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..core.doc import CONTENT_KEY, Doc
from ..core.errors import CausalityError
from ..core.types import Change, InputOperation, Patch
from ..parallel.change_queue import ChangeQueue
from ..parallel.pubsub import Publisher
from .model import (
    AddMarkStep,
    EditorDoc,
    RemoveMarkStep,
    ReplaceStep,
    ResetStep,
    Step,
    Transaction,
)

#: Default seed text, as in the reference demo (src/bridge.ts:118).
DEFAULT_INITIAL_TEXT = "Welcome to the Peritext editor!"


def content_index_from_pos(pos: int) -> int:
    """Editor position → CRDT content index (reference src/bridge.ts:360-371)."""
    return pos - 1


def pos_from_content_index(index: int) -> int:
    return index + 1


# ---------------------------------------------------------------------------
# down: editor transaction → input operations
# ---------------------------------------------------------------------------


def transaction_to_input_ops(txn: Transaction) -> List[InputOperation]:
    """Convert editor steps to index-based CRDT input operations.

    ``ReplaceStep`` with content becomes delete-then-insert, exactly as the
    reference translates a content-bearing ``ReplaceStep``
    (src/bridge.ts:428-453).
    """
    ops: List[InputOperation] = []
    for step in txn.steps:
        if isinstance(step, ReplaceStep):
            start = content_index_from_pos(step.from_pos)
            count = step.to_pos - step.from_pos
            if count > 0:
                ops.append(
                    {"path": [CONTENT_KEY], "action": "delete", "index": start, "count": count}
                )
            if step.text:
                ops.append(
                    {
                        "path": [CONTENT_KEY],
                        "action": "insert",
                        "index": start,
                        "values": list(step.text),
                    }
                )
        elif isinstance(step, (AddMarkStep, RemoveMarkStep)):
            action = "addMark" if isinstance(step, AddMarkStep) else "removeMark"
            op: InputOperation = {
                "path": [CONTENT_KEY],
                "action": action,
                "startIndex": content_index_from_pos(step.from_pos),
                "endIndex": content_index_from_pos(step.to_pos),
                "markType": step.mark_type,
            }
            if step.attrs is not None:
                op["attrs"] = dict(step.attrs)
            ops.append(op)
        elif isinstance(step, ResetStep):
            raise ValueError("ResetStep is patch-driven only; editors cannot emit it")
        else:
            raise TypeError(f"Unknown step type: {step!r}")
    return ops


def apply_transaction_to_doc(doc: Doc, txn: Transaction):
    """Editor transaction → (broadcastable Change, local patches)."""
    return doc.change(transaction_to_input_ops(txn))


# ---------------------------------------------------------------------------
# up: CRDT patch → editor steps
# ---------------------------------------------------------------------------


def patch_to_steps(patch: Patch) -> List[Step]:
    """Convert one CRDT patch to editor steps (reference src/bridge.ts:138-199)."""
    action = patch["action"]
    if action == "insert":
        pos = pos_from_content_index(patch["index"])
        return [
            ReplaceStep(pos, pos, "".join(patch["values"]), marks=patch.get("marks") or {})
        ]
    if action == "delete":
        pos = pos_from_content_index(patch["index"])
        return [ReplaceStep(pos, pos + patch["count"], "")]
    if action == "addMark":
        return [
            AddMarkStep(
                pos_from_content_index(patch["startIndex"]),
                pos_from_content_index(patch["endIndex"]),
                patch["markType"],
                patch.get("attrs"),
            )
        ]
    if action == "removeMark":
        return [
            RemoveMarkStep(
                pos_from_content_index(patch["startIndex"]),
                pos_from_content_index(patch["endIndex"]),
                patch["markType"],
                patch.get("attrs"),
            )
        ]
    if action == "makeList":
        return [ResetStep()]
    raise ValueError(f"Unsupported patch for editor: {action}")


def editor_doc_from_crdt(doc: Doc) -> EditorDoc:
    """Full render of the CRDT into an editor doc (reference
    ``prosemirrorDocFromCRDT``, src/bridge.ts:394-414)."""
    view = EditorDoc()
    for span in doc.get_text_with_formatting([CONTENT_KEY]):
        view.insert_at(len(view), span["text"], span["marks"])
    return view


# ---------------------------------------------------------------------------
# Editor: the headless analog of the reference's createEditor wiring
# ---------------------------------------------------------------------------


@dataclass
class EditorEvent:
    """One structured log entry (replaces the reference's DOM debug log,
    ``outputDebugForChange`` src/bridge.ts:235-242)."""

    kind: str  # "local-change" | "remote-change" | "flush"
    actor: str
    detail: Dict[str, Any] = field(default_factory=dict)


class Editor:
    """A headless collaborative editor replica.

    Wires together a CRDT replica, an incremental editor view, an outbound
    :class:`ChangeQueue`, and a :class:`Publisher` subscription — the same
    plumbing ``createEditor`` assembles (reference src/bridge.ts:204-347),
    minus the DOM.  Remote changes tolerate out-of-order delivery with a
    hold-back buffer (the reference gets this from causal queues plus
    ``applyChange``'s dep check).
    """

    def __init__(
        self,
        actor_id: str,
        publisher: Optional[Publisher] = None,
        queue_interval: float = 0.01,
        start_queue: bool = False,
        on_remote_patch: Optional[Callable[["Editor", Patch], None]] = None,
        on_event: Optional[Callable[[EditorEvent], None]] = None,
        backend: str = "scalar",
        actors: Optional[Sequence[str]] = None,
        backend_config: Optional[Dict[str, Any]] = None,
    ) -> None:
        """``backend`` selects who maintains the editor view:

        * ``"scalar"`` (default): the reference architecture — patches from
          the in-process scalar CRDT drive the view.
        * ``"tpu"``: the batched device engine — every change (local and
          remote) is also ingested into a :class:`~..parallel.streaming.
          StreamingMerge` session and the view is driven by its incremental
          ``read_patches`` stream.  Same ``InputOperation`` in, same
          ``Patch`` vocabulary out (the BASELINE boundary contract); the
          scalar ``Doc`` remains the local op *generator* (index→element
          anchoring needs full local state either way).  ``actors`` must
          declare the replica set (packed-id order is fixed up front).
          The name is the boundary's; in this package it selects the CUDA
          session: it runs on ``cuda`` (and raises without a card) unless
          ``backend_config`` names another ``device``, e.g.
          ``{"device": "cpu"}``.  ``backend_config`` goes to the session's
          constructor as given.
        """
        self.actor_id = actor_id
        #: serializes local dispatch, remote delivery and re-render (a
        #: peer's queue timer delivers on its own thread)
        self.lock = threading.RLock()
        self.doc = Doc(actor_id)
        self.view = EditorDoc()
        self.publisher = publisher
        self.on_remote_patch = on_remote_patch
        self.on_event = on_event
        self.backend = backend
        self.session = None
        if backend == "tpu":
            from ..parallel.streaming import StreamingMerge

            config = dict(backend_config or {})
            config.setdefault("slot_capacity", 1024)
            config.setdefault("mark_capacity", 256)
            # generous round widths (cheap at num_docs=1): a single editor
            # transaction — e.g. a large paste — must fit one round, else
            # the session demotes the doc to scalar replay
            config.setdefault("round_insert_capacity", 512)
            config.setdefault("round_delete_capacity", 256)
            config.setdefault("round_mark_capacity", 128)
            self.session = StreamingMerge(
                num_docs=1, actors=list(actors or (actor_id,)), **config
            )
        elif backend != "scalar":
            raise ValueError(f"unknown merge backend: {backend!r}")
        self._holdback: List[Change] = []
        #: the device session's failure: the view is stale, the editor done
        self._failure: Optional[BaseException] = None
        #: a timer flush's failure, raised once by the next call
        self._flush_error: Optional[BaseException] = None
        self.queue = ChangeQueue(self._flush, interval=queue_interval,
                                 on_error=self._keep_flush_error)
        if publisher is not None:
            publisher.subscribe(actor_id, self._receive)
        if start_queue:
            self.queue.start()

    # -- local edits (reference dispatchTransaction, src/bridge.ts:309-347) --

    def dispatch(self, txn: Transaction) -> Change:
        return self.dispatch_input_ops(transaction_to_input_ops(txn))

    def dispatch_input_ops(self, input_ops: List[InputOperation]) -> Change:
        """Apply raw input operations locally (the playback interpreter drives
        editors this way, reference ``executeTraceEvent`` src/playback.ts:102-115)."""
        with self.lock:
            self._raise_kept()
            change, patches = self.doc.change(input_ops)
            if self.session is not None:
                self._backend_ingest(change)
                self._backend_view_sync(remote=False)
            else:
                for patch in patches:
                    for step in patch_to_steps(patch):
                        step.apply(self.view)
            self.queue.enqueue(change)
        self._emit("local-change", ops=len(change.ops), seq=change.seq)
        return change

    # -- tpu backend plumbing ----------------------------------------------

    def _backend_ingest(self, change: Change) -> None:
        try:
            self.session.ingest(0, [change])
        except BaseException as exc:  # graftlint: boundary(a failed session poisons the editor; always re-raised)
            self._failure = exc
            raise

    def _backend_view_sync(self, remote: bool) -> None:
        """Advance the view by the device session's incremental patches."""
        try:
            self.session.drain()
            patches = self.session.read_patches(0)
        except BaseException as exc:  # graftlint: boundary(a failed session poisons the editor; always re-raised)
            self._failure = exc
            raise
        for patch in patches:
            for step in patch_to_steps(patch):
                step.apply(self.view)
            if remote and self.on_remote_patch is not None:
                self.on_remote_patch(self, patch)

    def _raise_kept(self, flush: bool = True) -> None:
        """Raise the device session's kept failure and, with ``flush``, a
        kept timer-flush failure (raised once)."""
        if self._failure is not None:
            raise RuntimeError(
                f"editor {self.actor_id!r}: its device session failed earlier and its "
                f"view is behind its replica ({self._failure!r})"
            ) from self._failure
        if not flush:
            return
        exc, self._flush_error = self._flush_error, None
        if exc is not None:
            raise RuntimeError(f"editor {self.actor_id!r}: a timer flush failed ({exc!r})") from exc

    def _keep_flush_error(self, exc: Exception) -> None:
        self._flush_error = exc

    # -- outbound ----------------------------------------------------------

    def _flush(self, changes: List[Change]) -> None:
        if self.publisher is not None:
            self.publisher.publish(self.actor_id, list(changes))
        self._emit("flush", count=len(changes))

    def sync(self) -> None:
        """Manual flush (the demo Sync button, reference src/index.ts:122-126)."""
        with self.lock:
            self._raise_kept()
        self.queue.flush()

    def disconnect(self) -> None:
        """Stop outbound flushing (simulated partition; reference queue.drop)."""
        self.queue.drop()

    # -- inbound (reference subscribe loop, src/bridge.ts:244-285) ---------

    def _receive(self, changes: List[Change]) -> None:
        with self.lock:
            self._raise_kept(flush=False)  # a peer's delivery gets no flush error of ours
            self._holdback.extend(changes)
            self._drain_holdback()

    def _drain_holdback(self) -> None:
        progressed = True
        applied_remote = False
        while progressed and self._holdback:
            progressed = False
            remaining: List[Change] = []
            for change in self._holdback:
                if change.seq <= self.doc.clock.get(change.actor, 0):
                    progressed = True  # duplicate: drop silently
                    continue
                try:
                    patches = self.doc.apply_change(change)
                except CausalityError:
                    remaining.append(change)
                    continue
                progressed = True
                if self.session is not None:
                    self._backend_ingest(change)
                    applied_remote = True
                else:
                    for patch in patches:
                        for step in patch_to_steps(patch):
                            step.apply(self.view)
                        if self.on_remote_patch is not None:
                            self.on_remote_patch(self, patch)
                self._emit("remote-change", actor=change.actor, seq=change.seq)
            self._holdback = remaining
        if applied_remote:
            self._backend_view_sync(remote=True)

    def apply_remote(self, *changes: Change) -> None:
        """Directly deliver remote changes (tests / transports without pubsub)."""
        self._receive(list(changes))

    # -- misc --------------------------------------------------------------

    def _emit(self, kind: str, **detail) -> None:
        if self.on_event is not None:
            self.on_event(EditorEvent(kind, self.actor_id, detail))

    def rerender(self) -> None:
        """Full re-render of the view (used after init).  Scalar backend:
        from the CRDT; tpu backend: advance by the session's patch stream
        (the view is exclusively patch-driven there)."""
        with self.lock:
            self._raise_kept()
            if self.session is not None:
                self._backend_view_sync(remote=False)
            else:
                self.view = editor_doc_from_crdt(self.doc)

    @property
    def text(self) -> str:
        return self.view.text


def create_editor(
    actor_id: str,
    publisher: Publisher,
    queue_interval: float = 0.01,
    start_queue: bool = False,
    **kwargs,
) -> Editor:
    """Factory mirroring the reference's ``createEditor`` (src/bridge.ts:204)."""
    return Editor(
        actor_id,
        publisher,
        queue_interval=queue_interval,
        start_queue=start_queue,
        **kwargs,
    )


def initialize_docs(editors: Sequence[Editor], initial_text: str = DEFAULT_INITIAL_TEXT) -> Change:
    """Seed every editor with shared history via ONE origin change from the
    first editor (reference ``initializeDocs``, src/bridge.ts:117-126) —
    concurrent edits then share the origin's element ids."""
    first, rest = editors[0], editors[1:]
    with first.lock:
        change, _ = first.doc.change(
            [
                {"path": [], "action": "makeList", "key": CONTENT_KEY},
                {
                    "path": [CONTENT_KEY],
                    "action": "insert",
                    "index": 0,
                    "values": list(initial_text),
                },
            ]
        )
    for editor in rest:
        with editor.lock:
            editor.doc.apply_change(change)
    for editor in editors:
        with editor.lock:
            if editor.session is not None:  # tpu backend: the view is session-fed
                editor._backend_ingest(change)
            editor.rerender()
    return change


def new_comment_id() -> str:
    """Fresh comment id (reference uses uuid, src/bridge.ts:66)."""
    return str(uuid.uuid4())
