"""Seeded generative fuzz harness (reference ``test/fuzz.ts``, fixed).

N replicas make random edits (insert / delete / addMark / removeMark) and
randomly pairwise-sync via vector-clock anti-entropy.  Three convergence
oracles after every sync (reference test/fuzz.ts:207-278):

1. patch path == batch path on each replica (accumulate_patches vs
   get_text_with_formatting),
2. synced replicas have identical spans,
3. synced replicas have identical clocks.

The per-actor change logs the replicas leave are the workload of the
batched merge path.  For the same seed the logs equal those of the
reference package's generator: each step draws from one ``random.Random``
in the same order, and the checks draw nothing.  :func:`run_differential`
and :func:`run_differential_frames` hold the card's batched and streaming
paths against the scalar oracle on such workloads; :func:`run_crash_restore`
kills a streaming session mid-stream and restores it from a checkpoint.

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
from ..core.types import Change, InputOperation, Patch
from ..native import available as native_available
from ..parallel.anti_entropy import ChangeStore, apply_changes
from ..parallel.causal import causal_schedule
from ..parallel.faults import FaultSpec, perturb_delivery
from .accumulate import accumulate_patches
from .generate import generate_docs

MARK_TYPES = ("strong", "em", "link", "comment")
EXAMPLE_URLS = tuple(f"{c}.com" for c in string.ascii_uppercase)


@dataclass
class FuzzState:
    docs: List[Doc]
    store: ChangeStore
    patch_lists: List[List[Patch]]
    rng: random.Random
    comment_history: List[str] = field(default_factory=list)
    ops_generated: int = 0
    syncs: int = 0


def make_fuzz_state(seed: int, num_replicas: int = 3, initial_text: str = "ABCDE") -> FuzzState:
    docs, patch_lists, initial_change = generate_docs(initial_text, num_replicas)
    store = ChangeStore()
    store.append(initial_change)
    return FuzzState(
        docs=docs, store=store, patch_lists=patch_lists, rng=random.Random(seed)
    )


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


def fuzz_step(
    state: FuzzState, check: bool = True, faults: Optional[FaultSpec] = None,
    op_fn=random_input_op,
) -> None:
    """One fuzz iteration: a random edit on a random replica, then a random
    pairwise sync with convergence checks.

    With ``faults``, each delivery hop suffers drop/dup/reorder faults:
    changes lost in transit stay in the store and are re-shipped by a later
    round's vector-clock diff, so convergence is delayed, never lost.
    Cross-replica convergence is asserted only for clean (lossless) syncs;
    the per-replica patch/batch oracle must hold regardless.
    """
    rng = state.rng
    target = rng.randrange(len(state.docs))
    doc = state.docs[target]

    input_op = op_fn(state, doc)
    if input_op is not None:
        change, patches = doc.change([input_op])
        state.store.append(change)
        state.patch_lists[target].extend(patches)
        state.ops_generated += len(change.ops)

    left = rng.randrange(len(state.docs))
    right = rng.randrange(len(state.docs))
    if left == right:
        return
    state.syncs += 1

    clean = True
    for src, dst in ((left, right), (right, left)):
        missing = state.store.missing_changes(
            state.docs[src].clock, state.docs[dst].clock
        )
        if faults is not None and faults.any_faults():
            delivered = perturb_delivery(missing, rng, faults)
            ordered, stuck = causal_schedule(delivered, state.docs[dst].clock)
            for ch in ordered:
                state.patch_lists[dst].extend(state.docs[dst].apply_change(ch))
            if len(ordered) < len(missing) or stuck:
                clean = False  # losses repair on a later anti-entropy round
        else:
            rng.shuffle(missing)  # delivery order must not matter
            state.patch_lists[dst].extend(apply_changes(state.docs[dst], missing))

    if check:
        if clean:
            left_spans = state.docs[left].get_text_with_formatting(["text"])
            right_spans = state.docs[right].get_text_with_formatting(["text"])
            assert left_spans == right_spans, (
                f"replica divergence after sync #{state.syncs}:\n{left_spans}\n{right_spans}"
            )
            assert state.docs[left].clock == state.docs[right].clock
        # The incremental-vs-batch oracle holds on every replica even when a
        # faulty sync left the pair divergent.
        for idx in (left, right):
            acc = accumulate_patches(state.patch_lists[idx])
            batch = state.docs[idx].get_text_with_formatting(["text"])
            assert acc == batch, (
                f"patch/batch divergence on replica {idx} after sync #{state.syncs}:"
                f"\npatch: {acc}\nbatch: {batch}"
            )


def full_sync(state: FuzzState) -> None:
    """Bring every replica to the store's global frontier with clean
    (fault-free) delivery — the repair round that ends a faulty session."""
    frontier = state.store.clock()
    for idx, doc in enumerate(state.docs):
        missing = state.store.missing_changes(frontier, doc.clock)
        state.patch_lists[idx].extend(apply_changes(doc, missing))


def run_fuzz(
    seed: int,
    iterations: int,
    num_replicas: int = 3,
    check: bool = True,
    faults: Optional[FaultSpec] = None,
) -> FuzzState:
    """``iterations`` fuzz steps from a fresh state, each checked when
    ``check`` (the checks draw nothing from the rng, so the store equals
    the reference's for the same seed, checked or not)."""
    state = make_fuzz_state(seed, num_replicas)
    for _ in range(iterations):
        fuzz_step(state, check=check, faults=faults)
    return state


def _workloads(seeds, ops_per_doc, num_replicas, initial_text, op_fn):
    workloads = []
    for seed in seeds:
        state = make_fuzz_state(seed, num_replicas, initial_text=initial_text)
        while state.ops_generated < ops_per_doc:
            fuzz_step(state, check=False, op_fn=op_fn)
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


def run_differential(
    seed: int, num_docs: int, ops_per_doc: int, batch=None, cursors_per_doc: int = 4,
    device: Optional[Union[str, torch.device]] = None, mesh=None,
) -> int:
    """Device-vs-oracle differential round: generate ``num_docs`` fuzz
    workloads, converge them through the batched device path AND the scalar
    oracle, and assert identical spans plus identical resolved cursors.
    ``batch`` is a :class:`~..api.batch.DocBatch` of any layout (default: a
    padded one on ``device``, itself defaulting to ``cuda``, over ``mesh``
    when given).  Returns the
    number of device-resolved docs (0 would mean the batch config routed
    everything to fallback — a test-setup bug, so it raises)."""
    from ..api.batch import DocBatch, _oracle_doc
    from ..core.comment import Comment, put_comment

    if batch is None:
        batch = DocBatch(slot_capacity=512, mark_capacity=128, comment_capacity=32,
                         device=device, mesh=mesh)
    workloads = generate_workload(seed, num_docs=num_docs, ops_per_doc=ops_per_doc)

    rng = random.Random(seed ^ 0x5EED)
    # ~1 in 6 docs gets comment-body map ops from a fresh actor
    # (core/comment.py): makeMap/set/del flow through the device map-register
    # path (ops/kernel._apply_map_doc), so these docs must STAY on device and
    # their materialized roots must equal the oracle's
    injected = set()
    for d, w in enumerate(workloads):
        if rng.random() < 1 / 6:
            commenter = Doc("commenter")
            change, _ = put_comment(
                commenter,
                Comment(id=f"cb-{d}", actor="commenter", content="body text"),
            )
            w["commenter"] = [change]
            injected.add(d)
    oracle_docs = [_oracle_doc(w) for w in workloads]
    cursors = []
    for doc in oracle_docs:
        n = sum(len(span["text"]) for span in doc.get_text_with_formatting(["text"]))
        indices = [rng.randrange(n) for _ in range(cursors_per_doc)] if n else []
        cursors.append([doc.get_cursor(["text"], i) for i in indices])

    report = batch.merge(workloads, cursors=cursors)
    for d, doc in enumerate(oracle_docs):
        expected = doc.get_text_with_formatting(["text"])
        assert report.spans[d] == expected, (
            f"seed={seed} doc={d}: device spans diverge from oracle\n"
            f"device: {report.spans[d]}\noracle: {expected}"
        )
        expected_cursors = [doc.resolve_cursor(c) for c in cursors[d]]
        got = report.cursor_positions[d]
        assert got == expected_cursors, (
            f"seed={seed} doc={d}: cursor positions diverge: "
            f"device {got} != oracle {expected_cursors}"
        )
    assert not (injected & set(report.fallback_docs)), (
        f"seed={seed}: comment-body docs {sorted(injected & set(report.fallback_docs))} "
        f"fell back — map ops should apply on device (fallbacks: {report.fallback_docs})"
    )
    for d, doc in enumerate(oracle_docs):
        assert report.roots[d] == doc.root, (
            f"seed={seed} doc={d}: device root map diverges from oracle\n"
            f"device: {report.roots[d]}\noracle: {doc.root}"
        )
    device_docs = num_docs - len(report.fallback_docs)
    uninjected = num_docs - len(injected)
    # every doc (incl. map-op docs) should resolve on device at these
    # capacities; all of them falling back indicates a capacity problem
    if uninjected and device_docs == 0:
        raise RuntimeError(
            f"seed={seed}: every doc fell back to the oracle; raise capacities"
        )
    return device_docs


def _campaign_session(num_docs: int, ops_per_doc: int, mesh=None,
                      device: Optional[Union[str, torch.device]] = None):
    """The streaming-session configuration shared by every streaming fuzz
    campaign (capacities scale with the workload's op count), over ``mesh``
    when given."""
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


def run_differential_frames(
    seed: int, num_docs: int, ops_per_doc: int, chunk: int = 9, mesh=None,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """Streaming frame-ingest differential: deliver each doc's changes as
    shuffled, chunked, partially duplicated wire frames interleaved with
    device rounds; a patch consumer accumulates each doc's incremental
    ``read_patches`` stream every round.  Final spans AND the accumulated
    patch streams must equal the scalar oracle.  The session runs on
    ``device`` (default ``cuda``), over ``mesh`` when given.  Returns the
    number of docs that stayed on the frame fast path."""
    from ..api.batch import _oracle_doc
    from ..core.comment import Comment, put_comment
    from ..parallel.causal import causal_sort
    from ..parallel.codec import encode_frame

    rng = random.Random(seed ^ 0xF7A3E5)
    workloads = generate_workload(seed, num_docs=num_docs, ops_per_doc=ops_per_doc)
    # ~1 in 6 docs gets comment-body map ops (core/comment.py): these must
    # ride the wire fast path into the device map registers, with the
    # materialized root equal to the oracle's.  The comment is authored by a
    # DECLARED replica (doc3) continuing its own history — streaming frames
    # admit only declared actors with causally-valid sequence numbers.
    injected = set()
    for d, w in enumerate(workloads):
        if rng.random() < 1 / 6:
            replica = Doc.resume(
                "doc3", causal_sort([c for log in w.values() for c in log])
            )
            change, _ = put_comment(
                replica, Comment(id=f"cb-{d}", actor="doc3", content="body")
            )
            w.setdefault("doc3", []).append(change)
            injected.add(d)
    sess = _campaign_session(num_docs, ops_per_doc, mesh, device=device)
    patch_streams = {d: [] for d in range(num_docs)}
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        rng.shuffle(changes)
        frames = [
            encode_frame(changes[i : i + chunk]) for i in range(0, len(changes), chunk)
        ]
        if frames and rng.random() < 0.5:
            frames.insert(rng.randrange(len(frames) + 1), rng.choice(frames))
        for f in frames:
            sess.ingest_frame(d, f)
            if rng.random() < 0.5:
                sess.step()
                if rng.random() < 0.3:
                    patch_streams[d].extend(sess.read_patches(d))
    sess.drain()
    out = sess.read_all()
    for d, w in enumerate(workloads):
        expected = _oracle_doc(w).get_text_with_formatting(["text"])
        assert out[d] == expected, (
            f"seed={seed} doc={d}: frame-streamed spans diverge from oracle\n"
            f"device: {out[d]}\noracle: {expected}"
        )
        patch_streams[d].extend(sess.read_patches(d))
        replayed = accumulate_patches(patch_streams[d])
        assert replayed == expected, (
            f"seed={seed} doc={d}: accumulated patch stream diverges\n"
            f"patches: {replayed}\noracle: {expected}"
        )
    assert sess.pending_count() == 0, f"seed={seed}: undelivered changes remain"
    for d, w in enumerate(workloads):
        oracle_root = _oracle_doc(w).root
        got = sess.read_root(d)
        assert got == oracle_root, (
            f"seed={seed} doc={d}: streamed root map diverges from oracle\n"
            f"device: {got}\noracle: {oracle_root}"
        )
    on_fast_path = sum(1 for s in sess.docs if s.frame_mode and not s.fallback)
    # Without the native library every frame legitimately routes to the
    # object path (the native layer is an accelerator, never a requirement);
    # only a genuine all-docs demotion with the library present is a
    # regression.
    if native_available():
        fallen = injected & {
            d for d, s in enumerate(sess.docs) if s.fallback or not s.frame_mode
        }
        assert not fallen, (
            f"seed={seed}: comment-body docs {sorted(fallen)} left the frame "
            "fast path — map ops should ride the device registers"
        )
        if num_docs and on_fast_path == 0:
            raise RuntimeError(f"seed={seed}: every doc left the frame fast path")
    return on_fast_path


def run_crash_restore(
    seed: int, num_docs: int = 8, ops_per_doc: int = 80, mesh=None,
    device: Optional[Union[str, torch.device]] = None,
) -> int:
    """Crash-consistency campaign: kill a streaming session mid-stream and
    restore it from a CheckpointManager checkpoint (event-sourced frame
    histories, checkpoint.py), then repair via one anti-entropy redelivery.

    Per seed: deliver each doc's changes as shuffled chunked frames with
    device rounds interleaved; checkpoint at a random mid-point; "crash"
    (drop the session object); restore from the LATEST checkpoint — a mesh
    session restores MESHLESS, exercising the digest's mesh invariance —
    then redeliver a random overlapping suffix of every doc's frames
    (duplicate-tolerant anti-entropy).  The restored session must reach the
    clean session's digest, spans and roots, all equal to the oracle.
    Every session runs on ``device`` (default ``cuda``), the crashing one
    over ``mesh`` when given.  Returns the number of frames redelivered
    after restore."""
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


def main(argv: Optional[List[str]] = None) -> None:
    """CLI (the reference's ``make fuzz``, bounded by default and with real
    removeMark fuzzing).

    ``--differential`` switches to device-vs-oracle differential fuzzing:
    each round converges a fresh batch of fuzz workloads through the batched
    path on ``--device`` (default ``cuda``) and asserts span + cursor
    equality against the scalar oracle.  ``--differential-frames`` does the
    same through StreamingMerge's frame-native ingest with
    shuffled/duplicated wire-frame delivery.  A failed oracle exits 1, a bad
    flag combination 2."""
    import argparse

    parser = argparse.ArgumentParser(description="Peritext convergence fuzzer")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iterations", type=int, default=2000)
    parser.add_argument("--replicas", type=int, default=3)
    parser.add_argument(
        "--differential", action="store_true",
        help="fuzz the batched device path against the scalar oracle",
    )
    parser.add_argument(
        "--differential-frames", action="store_true",
        help="fuzz the streaming frame-ingest path against the scalar oracle",
    )
    parser.add_argument("--docs", type=int, default=32, help="docs per differential round")
    parser.add_argument(
        "--ops-per-doc", type=int, default=160, help="ops per doc per differential round"
    )
    parser.add_argument(
        "--forever", action="store_true",
        help="loop over fresh seeds until interrupted or a failure is found",
    )
    parser.add_argument(
        "--mesh", type=int, default=0, metavar="N",
        help="shard the doc axis over an N-shard mesh: N cards with --device cuda "
             "(raises when fewer exist), N virtual shards with --device cpu",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the device campaigns (default: cuda)",
    )
    parser.add_argument(
        "--faults", action="store_true",
        help="scalar fuzz: inject delivery faults (drop 10%%, dup 10%%, "
             "reorder) on every sync hop; anti-entropy must still converge",
    )
    parser.add_argument(
        "--crash-restore", action="store_true",
        help="streaming crash-consistency: checkpoint mid-stream, kill the "
             "session, restore from CheckpointManager, redeliver an "
             "overlapping suffix; digest/spans/roots must equal a clean "
             "session and the oracle",
    )
    args = parser.parse_args(argv)
    if args.faults and (args.differential or args.differential_frames
                        or args.crash_restore):
        parser.error("--faults applies to the scalar fuzz only; it would be "
                     "silently ignored with the other campaign flags")
    if args.crash_restore and (args.differential or args.differential_frames):
        parser.error("--crash-restore is its own campaign; combine with "
                     "--mesh/--docs/--ops-per-doc only")
    mesh = None
    if args.mesh:
        from ..parallel.mesh import make_mesh

        try:
            mesh = make_mesh(args.mesh, device=args.device)  # the engines pad the doc axis
        except RuntimeError as exc:
            raise SystemExit(f"--mesh {args.mesh}: {exc}") from exc

    batch = None
    if args.differential:
        from ..api.batch import DocBatch

        batch = DocBatch(
            slot_capacity=512, mark_capacity=128, comment_capacity=32, device=args.device,
            mesh=mesh,
        )

    seed = args.seed
    while True:
        if args.crash_restore:
            redelivered = run_crash_restore(
                seed, num_docs=args.docs, ops_per_doc=args.ops_per_doc, mesh=mesh,
                device=args.device,
            )
            print(
                f"crash-restore seed={seed}: {args.docs} docs x "
                f"{args.ops_per_doc} ops survived kill+restore+repair "
                f"({redelivered} frames redelivered)", flush=True,
            )
        elif args.differential_frames:
            fast = run_differential_frames(
                seed, args.docs, args.ops_per_doc, mesh=mesh, device=args.device
            )
            print(
                f"frames-differential seed={seed}: {args.docs} docs x "
                f"{args.ops_per_doc} ops ({fast} on fast path) match the oracle",
                flush=True,
            )
        elif args.differential:
            device_docs = run_differential(
                seed, args.docs, args.ops_per_doc, batch=batch
            )
            print(
                f"differential seed={seed}: {args.docs} docs x {args.ops_per_doc} ops "
                f"({device_docs} on device) match the oracle", flush=True,
            )
        else:
            faults = FaultSpec(drop_p=0.1, dup_p=0.1, reorder=True) if args.faults else None
            state = run_fuzz(
                seed, args.iterations, num_replicas=args.replicas, faults=faults
            )
            if faults is not None:
                # faulted syncs skip the cross-replica oracle (deliveries are
                # deliberately lossy); the property under test is that one
                # clean anti-entropy round repairs everything
                full_sync(state)
                texts = [d.get_text_with_formatting(["text"]) for d in state.docs]
                assert all(t == texts[0] for t in texts), (
                    f"seed={seed}: replicas diverge after fault repair"
                )
                clocks = [d.clock for d in state.docs]
                assert all(c == clocks[0] for c in clocks), (
                    f"seed={seed}: clocks diverge after fault repair"
                )
            print(
                f"fuzz seed={seed}: {state.ops_generated} ops, "
                f"{state.syncs} syncs"
                f"{' (faulted delivery; repaired + converged)' if faults else ''}, "
                f"all convergence oracles passed", flush=True,
            )
        if not args.forever:
            break
        seed += 1


if __name__ == "__main__":
    main()
