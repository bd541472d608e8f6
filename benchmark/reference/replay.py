"""The plain reference of a streaming session, one document at a time.

A :class:`Replica` receives a document's frames in the order the traffic
delivers them.  Each delivery applies every change whose dependencies are
met (per-sender order and causal deps), and holds the rest until they are:
the delivery guarantee the configurations state.  Its state after any
prefix of deliveries gives the digest term and the formatted spans that
the program's session must hold for that document.

``buffered=False`` is the benchmark's control: it drops a change that
arrives before its dependencies instead of holding it, which breaks the
delivery guarantee and so has to come out as not correct.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .causal import causal_schedule
from .digest import doc_digest
from .doc import Doc
from .types import Change

INSERT_STEP_OPS = 3  # per live insert step beyond the slots it passes


class Replica:
    def __init__(self, slot_capacity: int, actors: Dict[str, int], buffered: bool = True) -> None:
        self.doc = Doc("reference")
        self.slot_capacity = slot_capacity
        self.actors = actors
        self.buffered = buffered
        self._pending: List[Change] = []
        self._mark_ops = 0
        #: per delivery: the K1 operations its applied inserts need, at the
        #: least (every slot already present is passed once, plus a few
        #: operations a step); whether any change applied; and after it,
        #: the elements held (tombstones included) and mark operations
        self.insert_ops: List[int] = []
        self.inserts: List[int] = []
        self.changed: List[bool] = []
        self.slots: List[int] = []
        self.marks: List[int] = []

    def _slots(self) -> int:
        for meta in self.doc._metadata.values():
            if isinstance(meta, list):
                return len(meta)
        return 0

    def deliver(self, changes: Sequence[Change]) -> None:
        if self.buffered:
            ready, self._pending = causal_schedule(list(self._pending) + list(changes),
                                                   self.doc.clock)
        else:
            ready = [ch for ch in changes if causal_schedule([ch], self.doc.clock)[0]]
        ops = inserts = 0
        for ch in ready:
            n = self._slots()
            k = sum(1 for op in ch.ops if op.action == "set" and op.insert)
            ops += k * n + k * (k - 1) // 2 + INSERT_STEP_OPS * k
            inserts += k
            self._mark_ops += sum(1 for op in ch.ops if op.action in ("addMark", "removeMark"))
            self.doc.apply_change(ch)
        self.insert_ops.append(ops)
        self.inserts.append(inserts)
        self.changed.append(bool(ready))
        self.slots.append(self._slots())
        self.marks.append(self._mark_ops)

    def digest(self) -> int:
        return doc_digest(self.doc, self.slot_capacity, self.actors)

    def spans(self):
        return self.doc.get_text_with_formatting(["text"])


def replay(frames: Sequence[Sequence[Change]], stops: Sequence[int], slot_capacity: int,
           actors: Dict[str, int], spans_at: Sequence[int] = (), buffered: bool = True) -> Dict:
    """Deliver ``frames`` in order.  After ``k`` frames, for each ``k`` in
    ``stops``, the digest term; for each in ``spans_at``, the spans too.
    Also, per delivery, the :class:`Replica` records: inserts applied and their K1 operations, whether
    the state changed, elements and mark operations held after it."""
    rep = Replica(slot_capacity, actors, buffered)
    want = set(stops) | set(spans_at)
    digests, spans = {}, {}
    if 0 in want:
        digests[0] = rep.digest()
        if 0 in spans_at:
            spans[0] = rep.spans()
    last = max(want) if want else len(frames)
    for k in range(1, last + 1):
        rep.deliver(frames[k - 1] if k <= len(frames) else [])
        if k in want:
            digests[k] = rep.digest()
            if k in spans_at:
                spans[k] = rep.spans()
    return {"digests": digests, "spans": spans, "insert_ops": rep.insert_ops,
            "inserts": rep.inserts, "changed": rep.changed, "slots": rep.slots, "marks": rep.marks}
