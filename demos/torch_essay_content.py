"""The scripted essay session over the PyTorch/CUDA port's bridge
(headless analog of the reference's ``src/essay-demo-content.ts`` — same
SHAPE of content: a full-length two-author writing session with
per-keystroke typing, mid-session corrections, concurrent formatting,
conflicting links, coexisting comments and a restart — with entirely
original text; the same trace as ``demos/essay_content.py``).

The trace is built against a shadow copy of the document so every index is
computed, not hand-counted: between synced sections the shadow equals both
replicas; concurrent sections take their indices from the shadow as it stood
at the last sync, exactly the state both authors see when they type.
"""

from __future__ import annotations

from typing import List

from peritext_tpu_torch.bridge.playback import simulate_typing_for_input_op
from peritext_tpu_torch.core.doc import CONTENT_KEY


class _EssayBuilder:
    def __init__(self) -> None:
        self.trace: List[dict] = [
            {"editorId": "alice", "path": [], "action": "makeList",
             "key": CONTENT_KEY, "delay": 0},
            {"action": "sync", "delay": 0},
        ]
        self.text = ""

    # -- synced, shadow-tracked edits --------------------------------------

    def type(self, editor: str, index: int, s: str, delay: int = 24) -> None:
        events = simulate_typing_for_input_op(
            editor, {"action": "insert", "index": index, "values": list(s)}
        )
        for ev in events:
            ev.setdefault("delay", delay)
        self.trace += events
        self.text = self.text[:index] + s + self.text[index:]

    def append(self, editor: str, s: str) -> None:
        self.type(editor, len(self.text), s)

    def delete(self, editor: str, index: int, count: int) -> None:
        self.trace.append(
            {"editorId": editor, "path": [CONTENT_KEY], "action": "delete",
             "index": index, "count": count, "delay": 120}
        )
        self.text = self.text[:index] + self.text[index + count:]

    def mark(self, editor: str, action: str, start: int, end: int,
             mark_type: str, attrs: dict | None = None) -> None:
        ev = {"editorId": editor, "path": [CONTENT_KEY], "action": action,
              "startIndex": start, "endIndex": end, "markType": mark_type,
              "delay": 200}
        if attrs:
            ev["attrs"] = attrs
        self.trace.append(ev)

    def sync(self) -> None:
        self.trace.append({"action": "sync", "delay": 400})

    def find(self, phrase: str) -> tuple:
        """(start, end) of a phrase in the current shadow text."""
        start = self.text.index(phrase)
        return start, start + len(phrase)


def build_essay_trace() -> List[dict]:
    b = _EssayBuilder()

    # ---- alice drafts the opening; bob reads along ----
    b.append("alice",
             "Rich text is a pact among characters about their shared past. ")
    b.sync()
    b.append("alice",
             "Plain text only has to agree on an order; formatted text must "
             "also agree on where every intention begins and ends. ")
    b.sync()

    # ---- bob continues the argument while alice is away ----
    b.append("bob",
             "When two writers touch the same sentence at the same moment, "
             "the letters have to find a single order, and the bold has to "
             "decide whether it grows around the newcomer or lets it stand "
             "plain. ")
    b.sync()

    # ---- alice revises: deletes a hedge, retypes it sharper ----
    start, end = b.find("a pact among characters")
    b.delete("alice", start, end - start)
    b.type("alice", start, "a merge of independent histories")
    b.sync()

    # ---- a third paragraph, typed concurrently with bob's edits ----
    tail = len(b.text)
    b.append("alice",
             "A mark is a promise pinned between two anchors. Each replica "
             "keeps the promise on its own clock, and the anchors ride the "
             "characters wherever concurrent edits carry them. ")
    # bob, concurrently (indices computed against the synced shadow): bolds
    # the thesis and italicizes an overlapping stretch
    s1, e1 = b.find("a single order")
    b.mark("bob", "addMark", s1, e1, "strong")
    s2, e2 = b.find("order, and the bold")
    b.mark("bob", "addMark", s2, e2, "em")
    b.sync()

    # ---- conflicting links over the same phrase: LWW picks one ----
    s3, e3 = b.find("independent histories")
    b.mark("alice", "addMark", s3, e3, "link",
           {"url": "https://crdt.tech"})
    b.mark("bob", "addMark", s3 + 4, e3, "link",
           {"url": "https://www.inkandswitch.com/peritext/"})
    b.sync()

    # ---- comments coexist where links fight ----
    s4, e4 = b.find("promise pinned between two anchors")
    b.mark("alice", "addMark", s4, e4, "comment", {"id": "essay-alice-1"})
    b.mark("bob", "addMark", s4, s4 + 7, "comment", {"id": "essay-bob-1"})
    b.sync()

    # ---- closing paragraph; bob then withdraws his comment ----
    b.append("bob",
             "Convergence is not agreement about intent. It is the narrower, "
             "sturdier guarantee that after every message arrives, both "
             "writers read the same page. ")
    b.mark("bob", "removeMark", s4, s4 + 7, "comment", {"id": "essay-bob-1"})
    b.sync()

    # ---- a final flourish: emphasis over the close, then loop ----
    s5, e5 = b.find("both writers read the same page")
    b.mark("alice", "addMark", s5, e5, "em")
    b.sync()
    b.trace.append({"action": "restart", "delay": 1500})
    return b.trace


#: sections in sync order, for the demo's narration
ESSAY_SECTIONS = [
    "alice drafts the opening",
    "plain vs formatted text",
    "bob continues the argument",
    "alice revises a phrase",
    "concurrent typing + overlapping bold/italic",
    "conflicting links (LWW)",
    "comments coexist",
    "closing paragraph; a comment withdrawn",
    "final emphasis",
]
