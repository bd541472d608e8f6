"""Seeded generative workloads (reference ``test/fuzz.ts``, fixed).

N replicas make random edits (insert / delete / addMark / removeMark) and
randomly pairwise-sync via vector-clock anti-entropy; the per-actor change
logs they leave are the workload of the batched merge path.  For the same
seed the logs equal those of the reference package's generator: each step
draws from one ``random.Random`` in the same order.

Fixes over the reference fuzzer (documented deviations):

* removeMark actually emits removeMark — the reference's ``removeMarkChange``
  emits addMark by mistake (test/fuzz.ts:80).
* Deterministic seeding (``random.Random(seed)``) for reproducibility.
* delete ranges are generated in-bounds (test/fuzz.ts:127-128).
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..core.doc import Doc
from ..core.types import Change, InputOperation
from ..parallel.anti_entropy import ChangeStore, apply_changes
from .generate import generate_docs

MARK_TYPES = ("strong", "em", "link", "comment")
EXAMPLE_URLS = tuple(f"{c}.com" for c in string.ascii_uppercase)


@dataclass
class FuzzState:
    docs: List[Doc]
    store: ChangeStore
    rng: random.Random
    comment_history: List[str] = field(default_factory=list)
    ops_generated: int = 0


def make_fuzz_state(seed: int, num_replicas: int = 3, initial_text: str = "ABCDE") -> FuzzState:
    docs, _, initial_change = generate_docs(initial_text, num_replicas)
    store = ChangeStore()
    store.append(initial_change)
    return FuzzState(docs=docs, store=store, rng=random.Random(seed))


def _mark_attrs(state: FuzzState, op: InputOperation, kind: str, mark_type: str) -> bool:
    """Fill a mark op's attrs; False when a comment removal has no comment
    to name (the step then makes no edit)."""
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


def random_input_op(state: FuzzState, doc: Doc) -> Optional[InputOperation]:
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
    op: InputOperation = {
        "path": ["text"],
        "action": "addMark" if kind == "addMark" else "removeMark",
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }
    return op if _mark_attrs(state, op, op["action"], mark_type) else None


def markheavy_input_op(state: FuzzState, doc: Doc) -> Optional[InputOperation]:
    """A mark-heavy editorial-pass op: mostly ``addMark``/``removeMark`` over
    LONG spans drawn across the whole doc, so span overlap explodes.  A thin
    stream of inserts keeps the substrate growing."""
    rng = state.rng
    length = len(doc.root["text"])
    if length < 12 or rng.random() > 0.85:
        index = rng.randint(0, length)
        count = rng.randint(2, 6)
        values = [rng.choice(string.ascii_lowercase) for _ in range(count)]
        return {"path": ["text"], "action": "insert", "index": index,
                "values": values}
    start = rng.randrange(length)
    end = rng.randint(start + 1, min(length, start + max(2, length // 2)))
    kind = "addMark" if rng.random() < 0.7 else "removeMark"
    mark_type = rng.choice(MARK_TYPES)
    op: InputOperation = {
        "path": ["text"],
        "action": kind,
        "startIndex": start,
        "endIndex": end,
        "markType": mark_type,
    }
    return op if _mark_attrs(state, op, kind, mark_type) else None


def fuzz_step(state: FuzzState, op_fn=random_input_op) -> None:
    """One iteration: a random edit on a random replica, then a random
    pairwise sync with shuffled (order-independent) delivery."""
    rng = state.rng
    target = rng.randrange(len(state.docs))
    doc = state.docs[target]

    input_op = op_fn(state, doc)
    if input_op is not None:
        change, _ = doc.change([input_op])
        state.store.append(change)
        state.ops_generated += len(change.ops)

    left = rng.randrange(len(state.docs))
    right = rng.randrange(len(state.docs))
    if left == right:
        return
    for src, dst in ((left, right), (right, left)):
        missing = state.store.missing_changes(
            state.docs[src].clock, state.docs[dst].clock
        )
        rng.shuffle(missing)  # delivery order must not matter
        apply_changes(state.docs[dst], missing)


def _workloads(seeds, ops_per_doc, num_replicas, initial_text, op_fn):
    workloads = []
    for seed in seeds:
        state = make_fuzz_state(seed, num_replicas, initial_text=initial_text)
        while state.ops_generated < ops_per_doc:
            fuzz_step(state, op_fn=op_fn)
        workloads.append(
            {actor: list(state.store.log(actor)) for actor in state.store.actors()}
        )
    return workloads


def generate_workload(
    seed: int, num_docs: int, ops_per_doc: int, num_replicas: int = 3
) -> List[Dict[str, List[Change]]]:
    """``num_docs`` independent fuzz change-log sets (doc d from seed + d)."""
    return _workloads(
        [seed + d for d in range(num_docs)], ops_per_doc, num_replicas,
        "ABCDE", random_input_op,
    )


def generate_markheavy_workload(
    seed: int, num_docs: int, ops_per_doc: int, num_replicas: int = 3
) -> List[Dict[str, List[Change]]]:
    """The mark-heavy family (:func:`markheavy_input_op`), same change-log
    shape as :func:`generate_workload`.  Seeds are offset (+1 keeps the
    offset non-degenerate at seed 0) so the two families never correlate."""
    return _workloads(
        [(seed * 7919) + d + 1 for d in range(num_docs)], ops_per_doc,
        num_replicas, "ABCDEFGHIJ", markheavy_input_op,
    )


def sample_cursors(workloads, per_doc: int, seed: int) -> List[List[dict]]:
    """Stable cursors for each workload: ``per_doc`` elements drawn from the
    doc's own text inserts (some later deleted, which exercises the
    leftward collapse), in the reference's ``Cursor`` shape."""
    rng = random.Random(seed)
    out = []
    for w in workloads:
        text_obj, elems = None, []
        for log in w.values():
            for ch in log:
                for op in ch.ops:
                    if op.action == "makeList":
                        text_obj = op.opid
                    elif op.action == "set" and op.insert:
                        elems.append(op.opid)
        elems.sort()
        picks = [rng.choice(elems) for _ in range(per_doc)] if elems else []
        out.append([{"objectId": text_obj, "elemId": e} for e in picks])
    return out
