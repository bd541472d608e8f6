"""Seeded generative workloads (reference ``test/fuzz.ts``, fixed).

N replicas make random edits (insert / delete / addMark / removeMark) and
randomly pairwise-sync via vector-clock anti-entropy; the per-actor change
logs they leave are the workload of the batched merge path.  For the same
seed the logs equal those of the reference package's generator: each step
draws from one ``random.Random`` in the same order.  :func:`run_fuzz` runs
a campaign of such steps (its store is what a failed trace saves), and
:func:`run_crash_restore` kills a streaming session mid-stream and restores
it from a checkpoint.

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
from typing import Dict, List, Optional, Union

import torch

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


def run_fuzz(seed: int, iterations: int, num_replicas: int = 3) -> FuzzState:
    """``iterations`` fuzz steps from a fresh state (the reference's
    ``run_fuzz`` without its per-sync checks, which make no rng call, so
    the store equals the reference's for the same seed)."""
    state = make_fuzz_state(seed, num_replicas)
    for _ in range(iterations):
        fuzz_step(state)
    return state


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


def _campaign_session(num_docs: int, ops_per_doc: int, mesh=None,
                      device: Optional[Union[str, torch.device]] = None):
    """The streaming-session configuration shared by every streaming fuzz
    campaign (capacities scale with the workload's op count)."""
    from ..parallel.streaming import StreamingMerge

    return StreamingMerge(
        num_docs=num_docs,
        actors=("doc1", "doc2", "doc3"),
        slot_capacity=max(256, 4 * ops_per_doc),
        mark_capacity=max(64, ops_per_doc),
        tomb_capacity=max(128, ops_per_doc),
        round_insert_capacity=128,
        round_delete_capacity=64,
        round_mark_capacity=64,
        mesh=mesh,
        device=device,
    )


def run_crash_restore(
    seed: int, num_docs: int = 8, ops_per_doc: int = 80, mesh=None,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """Crash-consistency campaign: kill a streaming session mid-stream and
    restore it from a CheckpointManager checkpoint (event-sourced frame
    histories, checkpoint.py), then repair via one anti-entropy redelivery.

    Per seed: deliver each doc's changes as shuffled chunked frames with
    device rounds interleaved; checkpoint at a random mid-point; "crash"
    (drop the session object); restore from the LATEST checkpoint, meshless;
    then redeliver a random overlapping suffix of every doc's frames
    (duplicate-tolerant anti-entropy).  The restored session must reach the
    clean session's digest, spans and roots, all equal to the oracle.
    Every session runs on ``device`` (default ``cuda``); ``mesh`` is not
    ported and raises.  Returns the number of frames redelivered after
    restore."""
    import tempfile

    from ..api.batch import _oracle_doc
    from ..checkpoint import CheckpointManager
    from ..parallel.codec import encode_frame

    rng = random.Random(seed ^ 0xC4A54)
    workloads = generate_workload(seed, num_docs=num_docs, ops_per_doc=ops_per_doc)

    def mk(use_mesh):
        return _campaign_session(num_docs, ops_per_doc, use_mesh, device=device)

    # per-doc frame schedule
    plans = []
    for w in workloads:
        changes = [ch for log in w.values() for ch in log]
        rng.shuffle(changes)
        chunk = rng.randrange(5, 12)
        plans.append(
            [encode_frame(changes[i : i + chunk]) for i in range(0, len(changes), chunk)]
        )

    # clean reference session (no crash)
    clean = mk(None)
    for d, frames in enumerate(plans):
        for f in frames:
            clean.ingest_frame(d, f)
    clean.drain()
    clean_digest = clean.digest()

    # crashing session: deliver a prefix, checkpoint, deliver a bit more, die
    sess = mk(mesh)
    cut = [rng.randrange(1, len(frames) + 1) for frames in plans]
    for d, frames in enumerate(plans):
        for f in frames[: cut[d]]:
            sess.ingest_frame(d, f)
            if rng.random() < 0.4:
                sess.step()
    sess.drain()
    with tempfile.TemporaryDirectory() as tmp:
        manager = CheckpointManager(tmp, keep=2, device=device)
        manager.save(step=1, session=sess)
        # post-checkpoint deliveries that will be LOST in the crash
        for d, frames in enumerate(plans):
            for f in frames[cut[d] : cut[d] + 1]:
                sess.ingest_frame(d, f)
        sess.step()
        del sess  # crash

        restored = manager.latest().session(mesh=None)  # meshless restore
        assert restored is not None

        # anti-entropy repair: redeliver an overlapping suffix (dup-tolerant)
        redelivered = 0
        for d, frames in enumerate(plans):
            start = max(0, cut[d] - rng.randrange(0, 3))  # overlap into the ckpt
            for f in frames[start:]:
                restored.ingest_frame(d, f)
                redelivered += 1
                if rng.random() < 0.3:
                    restored.step()
        restored.drain()

    assert restored.pending_count() == 0, f"seed={seed}: stuck changes after repair"
    assert restored.digest() == clean_digest, (
        f"seed={seed}: restored digest diverges after crash/repair"
    )
    for d, w in enumerate(workloads):
        oracle = _oracle_doc(w)
        expected = oracle.get_text_with_formatting(["text"])
        got = restored.read(d)
        assert got == expected, (
            f"seed={seed} doc={d}: restored spans diverge from oracle"
        )
        assert restored.read_root(d) == oracle.root, (
            f"seed={seed} doc={d}: restored root diverges from oracle"
        )
    return redelivered
