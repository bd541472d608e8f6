"""Frame-native ingest of the port's ``StreamingMerge`` (parallel/streaming.py
over ops/frames.py and the port's native library, on the CPU) against the
reference package's, fed the same wire frames, in the patterns of the
reference's tests/test_frames.py.

Every comparison is exact: parsed arrays and statuses, scheduled round
buffers, and every public read of the sessions — ``read_all``,
``read_patches_all``, ``read``/``read_root`` of every doc, cursors,
``digest(full=True|False)``, ``doc_digest``, ``frontier``,
``pending_count``, ``pending_docs``, ``quarantined()`` and the fallback set.
Sessions that several tests read are built once per module.
"""

import json
import random

import numpy as np
import pytest

from peritext_tpu import native as jax_native
from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.ops import frames as jax_frames
from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.parallel.codec import encode_frame_checked as jax_encode_frame_checked
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_markheavy_workload, generate_workload
from peritext_tpu.testing.generate import generate_docs
from peritext_tpu.utils.interning import Interner as JaxInterner
from peritext_tpu.utils.interning import OrderedActorTable as JaxActorTable
from peritext_tpu_torch import native
from peritext_tpu_torch.core.errors import DecodeError
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.ops import frames
from peritext_tpu_torch.parallel import streaming as streaming_mod
from peritext_tpu_torch.parallel.codec import decode_frame, encode_frame, encode_frame_checked
from peritext_tpu_torch.parallel.codec import encode_frame_traced
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.utils.interning import Interner, OrderedActorTable

ACTORS = ("doc1", "doc2", "doc3")
CAPS = dict(slot_capacity=256, mark_capacity=96, tomb_capacity=128,
            round_insert_capacity=128, round_delete_capacity=64, round_mark_capacity=64)


def _port(changes):
    return [Change.from_json(c.to_json()) for c in changes]


def _port_workload(w):
    return {a: _port(log) for a, log in w.items()}


def _changes_of(workload):
    return [ch for log in workload.values() for ch in log]


def _pair(num_docs, actors=ACTORS, **kw):
    kwargs = dict(num_docs=num_docs, actors=actors, **dict(CAPS, **kw))
    return JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")


def _records(q):
    return {d: (r.reason, r.detail, r.round, r.clean_delivery) for d, r in q.items()}


def _cursor_map(workloads, seed=0):
    rng = random.Random(seed)
    out = {}
    for d, w in enumerate(workloads):
        doc = jax_oracle_doc(w)
        n = sum(len(s["text"]) for s in doc.get_text_with_formatting(["text"]))
        if n:
            out[d] = [doc.get_cursor(["text"], rng.randrange(n)) for _ in range(3)]
    return out


def assert_same(j, t, workloads=None):
    """Every public read of the two sessions is equal."""
    assert t.rounds == j.rounds
    assert t.pending_count() == j.pending_count()
    assert t.pending_docs() == j.pending_docs()
    assert t.pending_rounds_estimate() == j.pending_rounds_estimate()
    assert _records(t.quarantined()) == _records(j.quarantined())
    assert [s.fallback for s in t.docs] == [s.fallback for s in j.docs]
    assert [s.frame_mode for s in t.docs] == [s.frame_mode for s in j.docs]
    assert t.read_all() == j.read_all()
    assert t.read_patches_all() == j.read_patches_all()
    for d in range(t.num_docs):
        assert t.read(d) == j.read(d), d
        assert t.read_root(d) == j.read_root(d), d
        assert t.doc_history_frames(d) == j.doc_history_frames(d), d
    assert t.digest() == j.digest()
    assert t.digest(full=False) == j.digest(full=False)
    assert t.digest(refresh=True) == j.digest()
    assert [t.doc_digest(d) for d in range(t.num_docs)] == \
        [j.doc_digest(d) for d in range(j.num_docs)]
    assert t.frontier() == j.frontier()
    assert t.overflow_count() == j.overflow_count()
    if workloads is not None:
        cursors = _cursor_map(workloads)
        assert t.resolve_cursors_batch(cursors) == j.resolve_cursors_batch(cursors)


def assert_same_docs(a, b):
    """Two port sessions hold the same documents (object vs frame ingest)."""
    assert a.read_all() == b.read_all()
    assert [a.read_root(d) for d in range(a.num_docs)] == \
        [b.read_root(d) for d in range(b.num_docs)]
    assert a.digest() == b.digest() and a.digest(full=False) == b.digest(full=False)
    assert [a.doc_digest(d) for d in range(a.num_docs)] == \
        [b.doc_digest(d) for d in range(b.num_docs)]
    assert [s.fallback for s in a.docs] == [s.fallback for s in b.docs]
    assert a.frontier() == b.frontier()


@pytest.fixture(scope="module")
def workloads():
    return generate_workload(seed=55, num_docs=6, ops_per_doc=80)


@pytest.fixture(scope="module")
def frame_sessions(workloads):
    """The reference and the port, each fed the same shuffled 3-round frame
    arrival (one ``ingest_frames`` per round, as the reference bench
    feeds), with round 0 re-delivered in round 2 (retransmission); plus
    the port's object-ingest twin of the same arrival."""
    arrival, wire_bytes = build_arrival([_port_workload(w) for w in workloads], 3, 9,
                                        as_frames=True)
    objects = build_arrival([_port_workload(w) for w in workloads], 3, 9)
    j, t = _pair(len(workloads))
    o = StreamingMerge(num_docs=len(workloads), actors=ACTORS, **CAPS, device="cpu")
    for r in range(3):
        items = [(d, b[r]) for d, b in enumerate(arrival) if r < len(b)]
        if r == 2:
            items += [(d, b[0]) for d, b in enumerate(arrival)]
        for s in (j, t):
            s.ingest_frames(items)
            s.drain()
        for d, b in enumerate(objects):
            if r < len(b):
                o.ingest(d, b[r])
        o.drain()
    # patches are incremental: the first sweep of each, from empty docs
    patches = {name: s.read_patches_all() for name, s in (("j", j), ("t", t), ("o", o))}
    return arrival, wire_bytes, j, t, o, patches


def test_arrival_frames_equal_reference_bench(workloads):
    import bench

    mine = build_arrival([_port_workload(w) for w in workloads], 3, 9, as_frames=True)
    assert mine == bench.build_arrival(workloads, 3, 9)
    v4 = build_arrival([_port_workload(w) for w in workloads], 3, 9, as_frames=True, wire="v4")
    assert v4 == bench.build_arrival(workloads, 3, 9, wire="v4")
    # object mode keeps its return value: the batches alone, the same rng calls
    objects = build_arrival([_port_workload(w) for w in workloads], 3, 9)
    ref_objects, _ = bench.build_arrival(workloads, 3, 9, as_frames=False)
    assert [[[c.to_json() for c in b] for b in doc] for doc in objects] == \
        [[[c.to_json() for c in b] for b in doc] for doc in ref_objects]


def test_frame_session_equals_reference(workloads, frame_sessions):
    _, wire_bytes, j, t, _, patches = frame_sessions
    assert patches["t"] == patches["j"]
    assert wire_bytes > 0 and t.host_parse_seconds > 0
    assert all(s.frame_mode and not s.fallback for s in t.docs)
    assert_same(j, t, workloads)


def test_frame_session_equals_object_twin(frame_sessions):
    _, _, _, t, o, patches = frame_sessions
    assert not any(s.frame_mode for s in o.docs)
    assert patches["t"] == patches["o"]
    assert_same_docs(t, o)


def test_ingest_span_carries_the_senders_trace_context(workloads):
    from peritext_tpu_torch.obs import Tracer

    tracer = Tracer(trace_id=0x77)
    spans = []
    tracer.add_sink(spans.append)
    t = StreamingMerge(num_docs=2, actors=ACTORS, **CAPS, tracer=tracer, device="cpu")
    changes = _port(_changes_of(workloads[0]))
    t.ingest_frames([(0, encode_frame_traced(changes, 0xABCDEF, 42)),
                     (1, encode_frame_checked(changes, 7, 9))])
    t.ingest_frame(1, encode_frame(changes))
    ingest = [sp for sp in spans if sp.name == "streaming.ingest"]
    # the traced frame's context parents the ingest span in the sender's trace
    assert (ingest[0].trace_id, ingest[0].parent_id) == (0xABCDEF, 42)
    assert ingest[0].args["frames"] == 2
    assert (ingest[1].trace_id, ingest[1].parent_id) == (0x77, 0)
    # the traced forms were stored as their self-contained v2 frames
    assert t.doc_history_frames(0) == t.doc_history_frames(1)[:1] == [encode_frame(changes)]
    t.drain()
    assert t.read(0) == t.read(1)


def test_frame_ingest_used_the_native_library(workloads):
    before = dict(native.calls)
    j, t = _pair(1)
    t.ingest_frames([(0, encode_frame(_port(_changes_of(workloads[0]))))])
    t.drain()
    assert native.calls.get("parse_frames", 0) > before.get("parse_frames", 0)
    assert native.calls.get("schedule_split_batch", 0) > before.get("schedule_split_batch", 0)
    assert t.pending_count() == 0


@pytest.mark.parametrize("order", ["object_then_frame", "frame_then_object"])
def test_mixed_object_and_frame_ingest_equal_reference(workloads, order):
    w0, w1 = workloads[1], workloads[2]
    c0, c1 = _changes_of(w0), _changes_of(w1)
    first, second = ("obj", "frame") if order == "object_then_frame" else ("frame", "obj")
    feed = [(first, 0, c0[: len(c0) // 2]), (first, 1, c1[: len(c1) // 2]),
            (second, 0, c0[len(c0) // 2:]), (second, 1, c1[len(c1) // 2:])]
    j, t = _pair(2)
    for n, (kind, d, changes) in enumerate(feed):
        for s, conv, enc in ((j, list, jax_encode_frame), (t, _port, encode_frame)):
            if kind == "obj":
                s.ingest(d, conv(changes))
            else:
                s.ingest_frame(d, enc(conv(changes)))
        if n % 2:
            j.drain()
            t.drain()
    assert [s.frame_mode for s in t.docs] == [order == "frame_then_object"] * 2
    assert_same(j, t, [w0, w1])


def test_marks_and_comments_through_frames_equal_reference():
    heavy = generate_markheavy_workload(seed=4, num_docs=3, ops_per_doc=70)
    docs, _, initial = generate_docs("hello world", 2)
    d1, d2 = docs
    c1, _ = d1.change([{"path": ["text"], "action": "addMark", "startIndex": 0, "endIndex": 5,
                        "markType": "strong"}])
    c2, _ = d2.change([
        {"path": ["text"], "action": "addMark", "startIndex": 3, "endIndex": 9,
         "markType": "comment", "attrs": {"id": "abc-1"}},
        {"path": ["text"], "action": "addMark", "startIndex": 2, "endIndex": 7,
         "markType": "link", "attrs": {"url": "https://x.test"}}])
    w = heavy + [{"doc1": [initial, c1], "doc2": [c2]}]
    j, t = _pair(len(w))
    for s, conv, enc in ((j, list, jax_encode_frame), (t, _port, encode_frame)):
        for half in (0, 1):
            items = []
            for d, wl in enumerate(w):
                cs = sorted(_changes_of(wl), key=lambda c: (c.actor, c.seq))
                cut = len(cs) // 2
                items.append((d, enc(conv(cs[:cut] if half == 0 else cs[cut:]))))
            s.ingest_frames(items)
            s.drain()
    assert not any(s.fallback for s in t.docs)
    assert any(t._doc_comment_ids.values())
    assert_same(j, t, w)


def _demotion(kind):
    """(actors, workload, ingest kwargs) of one demotion class of
    tests/test_frames.py."""
    if kind == "inexpressible_map_value":
        docs, _, initial = generate_docs("hello", 2)
        c, _ = docs[0].change([{"path": [], "action": "set", "key": "ratio", "value": 0.5}])
        return ACTORS, {"doc1": [initial, c]}, {}
    if kind == "undeclared_actor":
        w = generate_workload(seed=55, num_docs=3, ops_per_doc=80)[2]
        assert "doc3" in w and w["doc3"]
        return ("doc1", "doc2"), w, {}
    assert kind == "oversized_change"
    docs, _, initial = generate_docs("x", 1)
    big, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 1,
                              "values": list("y" * 200)}])
    return ACTORS, {"doc1": [initial, big]}, dict(round_insert_capacity=64)


@pytest.mark.parametrize("kind", ["inexpressible_map_value", "undeclared_actor",
                                  "oversized_change"])
def test_demotions_equal_reference(workloads, kind):
    actors, w, kw = _demotion(kind)
    j, t = _pair(2, actors=actors, **kw)
    good = _changes_of(workloads[0])
    for s, conv, enc in ((j, list, jax_encode_frame), (t, _port, encode_frame)):
        s.ingest_frames([(0, enc(conv(_changes_of(w)))), (1, enc(conv(good)))])
        assert s.drain() < 10  # never wedges
    assert t.docs[0].fallback and t.quarantined()[0].reason in ("schedule", "capacity")
    assert t.docs[1].fallback == (kind == "undeclared_actor")  # doc 1 has doc3 changes too
    assert_same(j, t, [w, workloads[0]])


def _gap_frames(workload):
    """A doc's changes in three frames: the first third, the last third
    (which waits on the middle), and the middle (the gap's repair)."""
    cs = sorted(_changes_of(workload), key=lambda c: (c.actor, c.seq))
    a, b = len(cs) // 3, 2 * len(cs) // 3
    return cs[:a], cs[b:], cs[a:b]


@pytest.mark.parametrize("mode", ["raise", "quarantine"])
def test_corrupt_frame_quarantines_and_lifts_like_reference(workloads, mode):
    head, tail, middle = _gap_frames(workloads[3])
    j, t = _pair(2)
    steps = []
    for s, conv, enc, enc_checked in ((j, list, jax_encode_frame, jax_encode_frame_checked),
                                      (t, _port, encode_frame, encode_frame_checked)):
        corrupt = bytearray(enc_checked(conv(head), 7, 8))
        corrupt[len(corrupt) // 2] ^= 0x5A  # CRC mismatch
        good_other = enc(conv(_changes_of(workloads[4])))
        trace = []
        if mode == "raise":
            with pytest.raises(ValueError) as exc:
                s.ingest_frames([(0, bytes(corrupt)), (1, good_other)])
            trace.append(type(exc.value).__name__)
        else:
            s.ingest_frames([(0, bytes(corrupt)), (1, good_other)], on_corrupt=mode)
        # nothing of the corrupt frame queued; the other doc's frame was
        trace.append((s.pending_count(), sorted(s.pending_docs()), len(s.docs[0].frames)))
        trace.append(_records(s.quarantined()))
        # a clean delivery with a causal gap: still quarantined after drain
        s.ingest_frames([(0, enc(conv(head))), (0, enc(conv(tail)))])
        s.drain()
        trace.append((_records(s.quarantined()), sorted(s.pending_docs())))
        # the gap's repair: the doc drains, and the record lifts
        s.ingest_frame(0, enc(conv(middle)))
        trace.append(_records(s.quarantined()))
        s.drain()
        trace.append(_records(s.quarantined()))
        steps.append(trace)
    jax_trace, port_trace = steps
    if mode == "raise":
        assert port_trace[0] == "DecodeError" and isinstance(DecodeError("x"), ValueError)
        port_trace, jax_trace = port_trace[1:], jax_trace[1:]
    assert port_trace == jax_trace
    assert port_trace[0][2] == 0 and port_trace[0][1] == [1]
    assert port_trace[1][0][0] == "decode"
    assert port_trace[2][0] and 0 in port_trace[2][1]  # stuck: still quarantined
    assert port_trace[-1] == {}  # lifted after the repair drained
    assert_same(j, t, [workloads[3], workloads[4]])


def _bulk_frames(workloads):
    """Frames for the bulk parse: clean fuzz frames (with marks, comments,
    maps), a broadcast duplicate, an undeclared-actor frame (demote), an
    inexpressible-value frame (demote), a truncated and a bad-codepoint
    frame (corrupt)."""
    from wire import craft_frame

    heavy = generate_markheavy_workload(seed=6, num_docs=2, ops_per_doc=50)
    out = []
    for d, w in enumerate(list(workloads[:2]) + heavy):
        cs = sorted(_changes_of(w), key=lambda c: (c.actor, c.seq))
        out.append((d, jax_encode_frame(cs)))
    out.append((1, out[0][1]))  # duplicate bytes, another doc
    actors, w, _ = _demotion("inexpressible_map_value")
    out.append((4, jax_encode_frame(_changes_of(w))))
    out.append((5, craft_frame(["ghost"], [0, 1, 1, 0, 1, 0, 1, 1, 0, 2, 0, 0, 0, 0, 120], 1,
                               version=1)))
    out.append((6, out[2][1][:-2]))
    out.append((7, craft_frame(["doc1"], [0, 1, 1, 0, 1, 0, 1, 1, 0, 2, 0, 0, 0, 0, 0x110000], 1,
                               version=1)))
    return out


@pytest.mark.parametrize("dedup", [False, True])
def test_parse_frames_bulk_equals_reference_and_per_frame(monkeypatch, workloads, dedup):
    items = _bulk_frames(workloads)
    if dedup:  # every frame twice: the broadcast dedup path
        items = items + items
    data = b"".join(f for _, f in items)
    off = np.concatenate([[0], np.cumsum([len(f) for _, f in items])]).astype(np.int64)
    doc_ids = np.asarray([d for d, _ in items], np.int64)
    mine = (OrderedActorTable(ACTORS), Interner(), Interner(), {})
    ref = (JaxActorTable(ACTORS), JaxInterner(), JaxInterner(), {})
    before = native.calls.get("parse_frames", 0)
    parsed, f_ch_off, status = frames.parse_frames_bulk(
        data, off, mine[0], mine[1], doc_ids, mine[3], keys=mine[2])
    assert native.calls.get("parse_frames", 0) == before + 1
    r_parsed, r_f_ch_off, r_status = jax_frames.parse_frames_bulk(
        data, off, ref[0], ref[1], doc_ids, ref[3], keys=ref[2])
    assert np.array_equal(status, r_status) and np.array_equal(f_ch_off, r_f_ch_off)
    assert sorted(set(status.tolist())) == [frames.FRAME_OK, frames.FRAME_CORRUPT,
                                            frames.FRAME_DEMOTE]
    for field in ("ch_actor", "ch_seq", "dep_off", "dep_actor", "dep_seq", "ops_off", "ops",
                  "cnt_ins", "cnt_del", "cnt_mark", "cnt_map"):
        assert np.array_equal(getattr(parsed, field), getattr(r_parsed, field)), field
    assert mine[3] == ref[3]
    assert [mine[1].lookup(i) for i in range(len(mine[1]))] == \
        [ref[1].lookup(i) for i in range(len(ref[1]))]
    # the Python fallback (the codec's object decode) rejects exactly the
    # frames the native parse marks corrupt, and counts the same changes
    for f, (_, frame) in enumerate(items):
        try:
            n = len(decode_frame(frame))
        except DecodeError:
            assert status[f] == frames.FRAME_CORRUPT, f
            continue
        assert status[f] != frames.FRAME_CORRUPT, f
        if status[f] == frames.FRAME_OK:
            assert n == f_ch_off[f + 1] - f_ch_off[f]
    # each clean frame alone, through pt_parse_changes over the codec's
    # Python varint decode, gives the same rows
    monkeypatch.setattr(native, "varint_decode", lambda *a: None)
    attrs, keys = Interner(), Interner()
    text_obj = {}
    for f, (d, frame) in enumerate(items):
        if status[f] != frames.FRAME_OK:
            continue
        one, text_obj[d] = frames.parse_frame(frame, OrderedActorTable(ACTORS), attrs,
                                              text_obj.get(d, 0), keys)
        lo, hi = f_ch_off[f], f_ch_off[f + 1]
        assert np.array_equal(one.ch_seq, parsed.ch_seq[lo:hi])
        assert np.array_equal(one.cnt_ins, parsed.cnt_ins[lo:hi])
        rows = parsed.ops[parsed.ops_off[lo]:parsed.ops_off[hi]]
        assert np.array_equal(one.ops[:, :9], rows[:, :9])


def _pool_and_buffers(workloads, caps):
    """A parsed pool of five docs (one with an oversized change, one with
    a causal gap) and fresh round buffers."""
    docs, _, initial = generate_docs("x", 1)
    big, _ = docs[0].change([{"path": ["text"], "action": "insert", "index": 1,
                              "values": list("y" * 100)}])
    gap = sorted(_changes_of(workloads[5]), key=lambda c: (c.actor, c.seq))
    logs = [_changes_of(workloads[0]), _changes_of(workloads[1]), [initial, big],
            gap[: len(gap) // 3] + gap[2 * len(gap) // 3:], _changes_of(workloads[2])]
    items = [(d, jax_encode_frame(sorted(cs, key=lambda c: (c.actor, c.seq))))
             for d, cs in enumerate(logs)]
    data = b"".join(f for _, f in items)
    off = np.concatenate([[0], np.cumsum([len(f) for _, f in items])]).astype(np.int64)
    doc_ids = np.asarray([d for d, _ in items], np.int64)
    text_obj = {}
    parsed, f_ch_off, status = frames.parse_frames_bulk(
        data, off, OrderedActorTable(ACTORS), Interner(), doc_ids, text_obj, keys=Interner())
    assert (status == frames.FRAME_OK).all()
    doc_of = np.repeat(doc_ids, np.diff(f_ch_off))
    return doc_of, parsed, np.asarray([text_obj[d] for d in range(len(logs))], np.int32)


def _buffers(d, caps):
    return streaming_mod._RoundBuffers(d, *caps)


def _buffer_arrays(enc):
    return [enc.ins_ref, enc.ins_op, enc.ins_char, enc.del_target,
            *[enc.marks[c] for c in sorted(enc.marks)],
            *[enc.map_ops[c] for c in sorted(enc.map_ops)]]


def test_schedule_split_batch_equals_python_and_reference(monkeypatch, workloads):
    """Round after round until the pool drains: the native batched scheduler,
    the reference's, and the per-doc Python scheduler (its causal order by
    the Python twin) fill the same buffers, counts, clocks and statuses."""
    caps = (32, 16, 16, 16)
    doc_of, parsed, text_obj = _pool_and_buffers(workloads, caps)
    n_docs = int(doc_of.max()) + 1
    n_actors = len(ACTORS) + 1
    clocks = {k: np.zeros((n_docs, n_actors), np.int32) for k in ("mine", "ref", "py")}
    pools = {k: (doc_of, parsed) for k in clocks}
    statuses, outs = [], {}
    for _ in range(40):
        if statuses and not outs["mine"][5].any():
            break  # a round that admitted nothing: the rest waits on the gap
        outs = {}
        for k, fn in (("mine", native.schedule_split_batch),
                      ("ref", jax_native.schedule_split_batch)):
            d_of, p = pools[k]
            docs = np.unique(d_of)
            ch_off = np.concatenate([np.searchsorted(d_of, docs), [len(d_of)]]).astype(np.int32)
            clock = np.ascontiguousarray(clocks[k][docs])
            enc = _buffers(n_docs, caps)
            _, ni, nd, nm, np_, nadm, admitted, status = fn(
                n_actors, ch_off, docs.astype(np.int32), text_obj[docs],
                (p.ch_actor, p.ch_seq, p.dep_off, p.dep_actor, p.dep_seq, p.ops_off, p.ops),
                clock, caps, (enc.ins_ref, enc.ins_op, enc.ins_char), enc.del_target,
                enc.marks, enc.map_ops)
            clocks[k][docs] = clock
            keep = (admitted == 0) & ~np.isin(d_of, docs[status != 0])
            pools[k] = (d_of[keep], p.select(np.nonzero(keep)[0]))
            outs[k] = (docs, ni, nd, nm, np_, nadm, status, enc)
        # the per-doc Python form with the Python causal order
        monkeypatch.setattr(native, "causal_schedule_indices", lambda *a, **k: None)
        d_of, p = pools["py"]
        docs = np.unique(d_of)
        enc = _buffers(n_docs, caps)
        bounds = np.concatenate([np.searchsorted(d_of, docs), [len(d_of)]])
        rows, keep_parts, py_status = [], [], []
        for j, d in enumerate(docs):
            sub = p.select(np.arange(bounds[j], bounds[j + 1]))
            try:
                nch, counts, deferred = frames.schedule_split(
                    sub, clocks["py"][d], int(text_obj[d]), caps,
                    (enc.ins_ref[d], enc.ins_op[d], enc.ins_char[d]), enc.del_target[d],
                    {c: enc.marks[c][d] for c in sorted(enc.marks)},
                    {c: enc.map_ops[c][d] for c in sorted(enc.map_ops)}, n_actors)
            except frames.FrameIngestError:
                for plane in _buffer_arrays(enc):
                    plane[d] = 0
                py_status.append(1)
                rows.append((0, 0, 0, 0, 0))
                continue
            py_status.append(0)
            rows.append((*counts, nch))
            keep_parts.append((np.full(deferred.num_changes, d, np.int64), deferred))
        monkeypatch.undo()
        keep_parts = [kp for kp in keep_parts if kp[1].num_changes]
        pools["py"] = ((np.concatenate([kp[0] for kp in keep_parts]),
                        frames.ParsedChanges.concat_many([kp[1] for kp in keep_parts]))
                       if keep_parts else (np.zeros(0, np.int64), frames.ParsedChanges.empty()))
        mine, ref = outs["mine"], outs["ref"]
        for a, b in zip(mine[:7], ref[:7]):
            assert np.array_equal(a, b)
        for a, b, c in zip(_buffer_arrays(mine[7]), _buffer_arrays(ref[7]), _buffer_arrays(enc)):
            assert np.array_equal(a, b) and np.array_equal(a, c)
        assert np.array_equal(mine[0], docs)
        py_rows = np.asarray(rows, np.int32).reshape(-1, 5)
        assert np.array_equal(np.stack(mine[1:6], axis=1), py_rows)
        assert np.array_equal((mine[6] != 0).astype(int), np.asarray(py_status))
        assert np.array_equal(clocks["mine"], clocks["ref"])
        assert np.array_equal(clocks["mine"], clocks["py"])
        statuses.append(mine[6].copy())
    assert any(s.any() for s in statuses)  # the oversized doc was demoted
    # only the gapped doc's waiting changes are left, the same in all three
    assert set(pools["mine"][0].tolist()) == {3}
    for k in ("ref", "py"):
        assert np.array_equal(pools[k][0], pools["mine"][0])
        assert np.array_equal(pools[k][1].ch_seq, pools["mine"][1].ch_seq)
    assert clocks["mine"][3].max() > 0


class _CountingSchedule:
    """``causal_schedule`` of the streaming module, counting calls per doc
    by the identity of the pending list it is handed."""

    def __init__(self, session):
        self.session = session
        self.calls = []
        self._real = streaming_mod.causal_schedule

    def __call__(self, changes, clock=None):
        for d, s in enumerate(self.session.docs):
            if s.pending is changes:
                self.calls.append(d)
        return self._real(changes, clock)


def test_skip_keeps_results_and_rescans_only_after_ingest(monkeypatch, workloads):
    """Object docs whose pending changes all wait on a missing change are
    scanned once, then skipped until an ingest to them; every result, and
    pending_count/pending_docs at each step, equal the reference's."""
    gaps = [_gap_frames(workloads[d]) for d in (3, 4, 5)]
    j, t = _pair(4)
    counter = _CountingSchedule(t)
    monkeypatch.setattr(streaming_mod, "causal_schedule", counter)
    trace = {"j": [], "t": []}
    for key, s, conv in (("j", j, list), ("t", t, _port)):
        for d, (head, tail, _) in enumerate(gaps):
            s.ingest(d, conv(head + tail))
        s.ingest(3, conv(_changes_of(workloads[0])))
        s.drain()
        trace[key].append((s.pending_count(), sorted(s.pending_docs())))
    # each gapped doc was scanned, found waiting, and parked
    assert t._object_waiting == {0, 1, 2} and not t._object_pending
    calls = len(counter.calls)
    t.drain()
    j.drain()
    assert len(counter.calls) == calls  # waiting docs are not re-scanned
    trace["t"].append((t.pending_count(), sorted(t.pending_docs())))
    trace["j"].append((j.pending_count(), sorted(j.pending_docs())))
    for key, s, conv in (("j", j, list), ("t", t, _port)):
        s.ingest(1, conv(gaps[1][2]))  # repair doc 1 only
        s.drain()
        trace[key].append((s.pending_count(), sorted(s.pending_docs())))
    assert counter.calls[calls:].count(1) >= 1 and 0 not in counter.calls[calls:]
    assert t._object_waiting == {0, 2}
    for key, s, conv in (("j", j, list), ("t", t, _port)):
        s.ingest(0, conv(gaps[0][2]))
        s.force_fallback(2)  # a waiting doc leaves through the fallback
        s.drain()
        trace[key].append((s.pending_count(), sorted(s.pending_docs())))
    assert not t._object_waiting and not t._object_pending
    assert trace["t"] == trace["j"]
    assert trace["t"][0][0] > 0
    assert_same(j, t, [workloads[3], workloads[4], workloads[5], workloads[0]])
    assert json.dumps(t.frontier()) == json.dumps(j.frontier())
