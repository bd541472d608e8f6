"""Seeded fuzz sessions: three replicas make random edits (insert, delete,
addMark, removeMark) and sync pairwise, as the upstream fuzz harness
(raboof/peritext ``test/fuzz.ts``) does; each replica's change log is one
sender's traffic.

Frozen copy of ``peritext_tpu_torch/testing/fuzz.py`` (``make_fuzz_state``,
``random_input_op``, ``fuzz_step`` without its checks and faults,
``generate_workload``), ``testing/generate.py`` and the ``ChangeStore`` of
``parallel/anti_entropy.py`` at commit a8ed934, over the benchmark's own
reference document.  For one seed it draws from ``random.Random`` in the
same order, so the logs equal the program's generator's.
"""

from __future__ import annotations

import random
import string
from typing import Dict, List, Optional

from ..reference.causal import causal_sort
from ..reference.doc import Doc
from ..reference.types import Change

MARK_TYPES = ("strong", "em", "link", "comment")
EXAMPLE_URLS = tuple(f"{c}.com" for c in string.ascii_uppercase)


class ChangeStore:
    """Per-actor append-only change logs."""

    def __init__(self) -> None:
        self._logs: Dict[str, List[Change]] = {}

    def append(self, change: Change) -> None:
        log = self._logs.setdefault(change.actor, [])
        if change.seq != len(log) + 1:
            raise ValueError(f"log gap for {change.actor}: have {len(log)}, got seq {change.seq}")
        log.append(change)

    def log(self, actor: str) -> List[Change]:
        return self._logs.get(actor, [])

    def actors(self) -> List[str]:
        return list(self._logs.keys())

    def missing_changes(self, source_clock, target_clock) -> List[Change]:
        changes: List[Change] = []
        for actor, seq in source_clock.items():
            have = target_clock.get(actor, 0)
            if have < seq:
                changes.extend(self._logs.get(actor, [])[have:seq])
        return changes


class FuzzState:
    def __init__(self, seed: int, num_replicas: int, initial_text: str) -> None:
        self.docs = [Doc(f"doc{i + 1}") for i in range(num_replicas)]
        initial, _ = self.docs[0].change([
            {"path": [], "action": "makeList", "key": "text"},
            {"path": ["text"], "action": "insert", "index": 0, "values": list(initial_text)},
        ])
        for doc in self.docs[1:]:
            doc.apply_change(initial)
        self.store = ChangeStore()
        self.store.append(initial)
        self.rng = random.Random(seed)
        self.comment_history: List[str] = []
        self.ops_generated = 0


def _mark_attrs(state: FuzzState, op: dict, kind: str, mark_type: str) -> bool:
    rng = state.rng
    if mark_type == "link":
        if kind == "addMark":
            op["attrs"] = {"url": rng.choice(EXAMPLE_URLS)}
    elif mark_type == "comment":
        if kind == "addMark":
            cid = f"comment-{rng.randrange(1 << 16):04x}"
            state.comment_history.append(cid)
            op["attrs"] = {"id": cid}
        else:
            if not state.comment_history:
                return False
            op["attrs"] = {"id": rng.choice(state.comment_history)}
    return True


def random_input_op(state: FuzzState, doc: Doc) -> Optional[dict]:
    rng = state.rng
    length = len(doc.root["text"])
    kind = rng.choice(("insert", "remove", "addMark", "removeMark"))

    if kind == "insert" or length == 0:
        index = rng.randint(0, length)
        count = rng.randint(1, 3)
        values = [rng.choice(string.ascii_lowercase + "0123456789") for _ in range(count)]
        return {"path": ["text"], "action": "insert", "index": index, "values": values}

    if kind == "remove":
        index = rng.randrange(length)
        count = rng.randint(1, length - index)
        return {"path": ["text"], "action": "delete", "index": index, "count": count}

    start = rng.randrange(length)
    end = rng.randint(start + 1, length)
    mark_type = rng.choice(MARK_TYPES)
    op = {
        "path": ["text"],
        "action": "addMark" if kind == "addMark" else "removeMark",
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }
    return op if _mark_attrs(state, op, op["action"], mark_type) else None


def fuzz_step(state: FuzzState) -> None:
    """One edit on a random replica, then a random pairwise sync."""
    rng = state.rng
    target = rng.randrange(len(state.docs))
    doc = state.docs[target]
    input_op = random_input_op(state, doc)
    if input_op is not None:
        change, _ = doc.change([input_op])
        state.store.append(change)
        state.ops_generated += len(change.ops)

    left = rng.randrange(len(state.docs))
    right = rng.randrange(len(state.docs))
    if left == right:
        return
    for src, dst in ((left, right), (right, left)):
        missing = state.store.missing_changes(state.docs[src].clock, state.docs[dst].clock)
        rng.shuffle(missing)
        for change in causal_sort(missing, state.docs[dst].clock):
            state.docs[dst].apply_change(change)


def session(seed: int, ops: int, num_replicas: int = 3,
            initial_text: str = "ABCDE") -> Dict[str, List[Change]]:
    """One fuzz session of at least ``ops`` ops: each replica's change log."""
    state = FuzzState(seed, num_replicas, initial_text)
    while state.ops_generated < ops:
        fuzz_step(state)
    return {actor: list(state.store.log(actor)) for actor in state.store.actors()}
