"""The port's ``StreamingMerge`` (peritext_tpu_torch/parallel/streaming.py,
padded layout, object ingest, on the CPU) against the reference package's
``StreamingMerge`` on the same arrivals, in the patterns of the reference's
tests/test_streaming.py and tests/test_fused.py.

Every comparison is exact: ``read_all``, ``read_patches_all``, ``read_root``
of every doc, cursors, ``digest(full=True)``, ``digest(full=False)``,
``doc_digest``, ``frontier`` and the set of fallback docs.  Sessions that
several tests read are built once per module.
"""

import random

import numpy as np
import pytest
import torch

from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu.testing.generate import generate_docs
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.arrival import build_arrival, interleave_rounds

ACTORS = ("doc1", "doc2", "doc3")
WIDE = dict(round_insert_capacity=256, round_delete_capacity=128, round_mark_capacity=128)
SMALL = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=64)


def _port(changes):
    return [Change.from_json(c.to_json()) for c in changes]


def _arrival(workloads, rounds, seed):
    """One arrival for both packages: batches of the reference's changes and
    the same batches crossed to the port through the wire format."""
    rng = random.Random(seed)
    ref = [interleave_rounds_ref(w, rounds, rng) for w in workloads]
    return ref, [[_port(b) for b in doc] for doc in ref]


def interleave_rounds_ref(workload, rounds, rng):
    """The reference tests' arrival split, on the reference's changes (the
    port's testing.arrival.interleave_rounds makes the same rng calls)."""
    changes = [ch for log in workload.values() for ch in log]
    rng.shuffle(changes)
    size = -(-len(changes) // rounds)
    return [changes[i: i + size] for i in range(0, len(changes), size)]


def _feed(session, arrival, step=False):
    rounds = max(len(b) for b in arrival)
    for r in range(rounds):
        for d, batches in enumerate(arrival):
            if r < len(batches):
                session.ingest(d, batches[r])
        if step:
            while session.step() > 0:
                pass
        else:
            session.drain()
    return session


def _pair(workloads, rounds=2, seed=0, kwargs=None, jax_kwargs=None, port_setup=None,
          step=False):
    kwargs = dict(num_docs=len(workloads), actors=ACTORS, **(kwargs or {}))
    ref_arrival, port_arrival = _arrival(workloads, rounds, seed)
    j = JaxStreamingMerge(**kwargs, **(jax_kwargs or {}))
    t = StreamingMerge(**kwargs, device="cpu")
    if port_setup:
        port_setup(t)
        port_setup(j)
    _feed(j, ref_arrival, step)
    _feed(t, port_arrival, step)
    return j, t


def _cursor_map(workloads, per_doc=3, seed=0):
    rng = random.Random(seed)
    out = {}
    for d, w in enumerate(workloads):
        doc = jax_oracle_doc(w)
        n = sum(len(s["text"]) for s in doc.get_text_with_formatting(["text"]))
        if n:
            out[d] = [doc.get_cursor(["text"], rng.randrange(n)) for _ in range(per_doc)]
    return out


def assert_same(j, t, workloads=None):
    """Every public read of the two sessions is equal."""
    assert t.rounds == j.rounds
    assert t.read_all() == j.read_all()
    assert t.read_patches_all() == j.read_patches_all()
    for d in range(t.num_docs):
        assert t.read_root(d) == j.read_root(d), d
        assert t.read(d) == j.read(d), d
    assert t.digest() == j.digest()
    assert t.digest(full=False) == j.digest(full=False)
    assert t.digest(refresh=True) == j.digest()
    assert [t.doc_digest(d) for d in range(t.num_docs)] == \
        [j.doc_digest(d) for d in range(j.num_docs)]
    assert t.frontier() == j.frontier()
    assert [s.fallback for s in t.docs] == [s.fallback for s in j.docs]
    assert t.overflow_count() == j.overflow_count()
    assert t.pending_count() == j.pending_count()
    if workloads is not None:
        cursors = _cursor_map(workloads)
        assert t.resolve_cursors_batch(cursors) == j.resolve_cursors_batch(cursors)


@pytest.fixture(scope="module")
def multi_round():
    workloads = generate_workload(seed=31, num_docs=8, ops_per_doc=40)
    return workloads, _pair(workloads, rounds=4, kwargs=dict(WIDE, **SMALL))


def test_multi_round_convergence(multi_round):
    workloads, (j, t) = multi_round
    assert t.rounds >= 4
    assert_same(j, t, workloads)
    assert t.last_round_stats.device_ops > 0


def test_doc_digests_sum_to_digest(multi_round):
    _, (_, t) = multi_round
    assert sum(t.doc_digest(d) for d in range(t.num_docs)) % (1 << 32) == t.digest()


def test_cum_ins_bounds_num_slots(multi_round):
    _, (_, t) = multi_round
    assert (t._cum_ins >= t.state.num_slots.numpy()).all()


def test_decoders_and_host_helpers(multi_round):
    """The full-plane decoders equal the compact sweep's and the reads; the
    insert-patch stream and ``rebalance`` equal the reference's."""
    from peritext_tpu.ops.patches import as_insert_patches as jax_as_insert_patches
    from peritext_tpu.parallel.streaming import rebalance as jax_rebalance
    from peritext_tpu_torch.ops.decode import (
        block_char_states,
        block_char_states_compact,
        decode_doc_text,
    )
    from peritext_tpu_torch.ops.patches import as_insert_patches
    from peritext_tpu_torch.parallel.streaming import rebalance

    _, (j, t) = multi_round
    resolved = t._resolution(0).to_np()
    elem = t.state.elem_id.numpy()
    attr_of, comment_of = t._block_tables(0)
    full = block_char_states(resolved, elem, t._actor_table, attr_of, comment_of)
    compact = t._finish_compact(0, *t._dispatch_compact(0))
    assert full == block_char_states_compact(compact, t._actor_table, attr_of, comment_of)
    for d in range(t.num_docs):
        assert full[d] == t._doc_chars(d), d
        assert decode_doc_text(resolved, d) == "".join(s["text"] for s in t.read(d)), d
        assert as_insert_patches(full[d]) == jax_as_insert_patches(j._doc_chars(d)), d
    sizes = np.random.default_rng(4).integers(1, 500, 37).tolist()
    for shards in (1, 3, 8):
        assert rebalance(sizes, shards) == jax_rebalance(sizes, shards)


def test_one_round_convergence_with_cursors():
    workloads = generate_workload(seed=140, num_docs=3, ops_per_doc=60)
    j, t = _pair(workloads, rounds=1, kwargs=dict(
        slot_capacity=256, mark_capacity=96, round_insert_capacity=128,
        round_delete_capacity=64, round_mark_capacity=64))
    assert_same(j, t, workloads)
    bogus = {"objectId": (1, "doc1"), "elemId": (99999, "nowhere")}
    assert t.resolve_cursors(0, [bogus]) == [-1]


def test_tiny_round_widths_defer_and_converge():
    workloads = generate_workload(seed=7, num_docs=4, ops_per_doc=30)
    j, t = _pair(workloads, rounds=1, kwargs=dict(
        SMALL, round_insert_capacity=8, round_delete_capacity=8, round_mark_capacity=8))
    assert t.rounds > 1
    assert_same(j, t)


def test_duplicate_ingestion_idempotent():
    workloads = generate_workload(seed=3, num_docs=2, ops_per_doc=25)
    kwargs = dict(num_docs=2, actors=ACTORS, **SMALL)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        for _ in range(2):
            j.ingest(d, changes)
            t.ingest(d, _port(changes))
    j.drain()
    t.drain()
    assert_same(j, t)


def test_undeclared_actor_falls_back():
    workloads = generate_workload(seed=5, num_docs=2, ops_per_doc=25)
    kwargs = dict(num_docs=2, actors=("doc1",), **SMALL)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        j.ingest(d, changes)
        t.ingest(d, _port(changes))
    j.drain()
    t.drain()
    assert all(s.fallback for s in t.docs)
    assert {d: r.reason for d, r in t.quarantined().items()} == {0: "encode", 1: "encode"}
    assert_same(j, t, workloads)


def test_device_overflow_falls_back():
    workloads = generate_workload(seed=6, num_docs=2, ops_per_doc=60)
    j, t = _pair(workloads, rounds=1, kwargs=dict(slot_capacity=16, tomb_capacity=8,
                                                  mark_capacity=8))
    assert bool(t.state.overflow.any())
    assert t.overflow_count() > 0
    assert_same(j, t, workloads)


def test_oversized_change_demoted_not_wedged():
    docs, _, initial = generate_docs("x", 1)
    (d1,) = docs
    big, _ = d1.change(
        [{"path": ["text"], "action": "insert", "index": 1, "values": list("y" * 100)}])
    kwargs = dict(num_docs=1, actors=("doc1",), slot_capacity=256, round_insert_capacity=32)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    j.ingest(0, [initial, big])
    t.ingest(0, _port([initial, big]))
    assert t.drain() == j.drain()
    assert t.docs[0].fallback and t.pending_count() == 0
    assert t.quarantined()[0].reason == "capacity"
    assert_same(j, t, [{"doc1": [initial, big]}])


def test_cursors_on_fallback_doc():
    docs, _, initial = generate_docs("fallback text", 1)
    (d1,) = docs
    # a float value is device-inexpressible: forces the fallback path
    fall, _ = d1.change([{"path": [], "action": "set", "key": "ratio", "value": 0.25}])
    kwargs = dict(num_docs=1, actors=("doc1",), slot_capacity=128)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    j.ingest(0, [initial, fall])
    t.ingest(0, _port([initial, fall]))
    j.drain()
    t.drain()
    assert t.docs[0].fallback
    assert_same(j, t, [{"doc1": [initial, fall]}])


def test_read_chunk_smaller_than_docs():
    workloads = generate_workload(seed=150, num_docs=5, ops_per_doc=48)
    kwargs = dict(WIDE, slot_capacity=256, mark_capacity=96, read_chunk=2)
    j, t = _pair(workloads, rounds=2, kwargs=kwargs)
    assert t._padded_docs == 6 and t.state.elem_id.shape[0] == 6
    assert_same(j, t, workloads)
    whole = _pair(workloads, rounds=2, kwargs=dict(kwargs, read_chunk=8192))[1]
    assert whole.read_all() == t.read_all()
    assert whole.digest() == t.digest()


NARROW = dict(SMALL, round_insert_capacity=8, round_delete_capacity=8,
              round_mark_capacity=8, round_map_capacity=8)


@pytest.fixture(scope="module")
def fused_pair():
    workloads = generate_workload(seed=23, num_docs=6, ops_per_doc=40)
    return workloads, _pair(workloads, rounds=3, kwargs=NARROW)


def test_fused_equals_reference(fused_pair):
    _, (j, t) = fused_pair
    assert t.rounds > 3
    assert_same(j, t)


@pytest.mark.parametrize("arm", ["per_round", "static_rounds", "stepwise"])
def test_other_arms_equal_fused(fused_pair, arm):
    workloads, (_, fused) = fused_pair
    if arm == "static_rounds":
        other = _pair(workloads, rounds=3, kwargs=dict(NARROW, static_rounds=True))
    elif arm == "per_round":
        def off(s):
            s.fused_pipeline = False
        other = _pair(workloads, rounds=3, kwargs=NARROW, port_setup=off)
    else:
        other = _pair(workloads, rounds=3, kwargs=NARROW, step=True)
    assert_same(*other)
    assert other[1].digest() == fused.digest()
    assert other[1].read_all() == fused.read_all()


def test_prefetch_digest_chains_and_matches():
    workloads = generate_workload(seed=91, num_docs=6, ops_per_doc=32)
    kwargs = dict(SMALL, round_insert_capacity=8, round_delete_capacity=8,
                  round_mark_capacity=8)

    def arm(s):
        s.prefetch_digest = True
        s.FUSE_MAX_ROUNDS = 2
    before = GLOBAL_COUNTERS.get("streaming.digest_chained")
    j, t = _pair(workloads, rounds=3, kwargs=kwargs, port_setup=arm)
    assert GLOBAL_COUNTERS.get("streaming.digest_chained") > before
    stamp, cache = t._resolved_cache
    assert stamp == t.rounds and 0 in cache
    entry = cache[0]
    digest = t.digest()
    assert t._resolved_cache[1][0] is entry  # the chained resolution served it
    assert digest == j.digest()
    assert_same(j, t)


def test_incremental_digest_across_fallback_and_overflow():
    """The carried per-row plane stays equal to a full refresh (and to the
    reference) across a forced demotion and a doc overflowing mid-session."""
    workloads = generate_workload(seed=13, num_docs=6, ops_per_doc=60)
    kwargs = dict(num_docs=6, actors=ACTORS, slot_capacity=12, tomb_capacity=48,
                  mark_capacity=32, **WIDE)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    ref_arrival, port_arrival = _arrival(workloads, 3, 5)
    overflowed = []
    for r in range(3):
        for d in range(6):
            if r < len(ref_arrival[d]):
                j.ingest(d, ref_arrival[d][r])
                t.ingest(d, port_arrival[d][r])
        j.drain()
        t.drain()
        assert t.digest() == t.digest(refresh=True) == j.digest(), r
        overflowed.append(t.overflow_count())
        if r == 0:
            j.force_fallback(2, detail="test")
            t.force_fallback(2, detail="test")
            assert t.digest() == j.digest() == t.digest(refresh=True)
    # docs outgrew 12 slots on the way, after a round without overflow
    assert overflowed[0] == 0 and overflowed[-1] > 0, overflowed
    assert_same(j, t, workloads)


def test_bench_arrival_matches_reference():
    import bench

    workloads = generate_workload(seed=0, num_docs=4, ops_per_doc=30)
    ref, _ = bench.build_arrival(workloads, 4, 0, as_frames=False)
    port = build_arrival([{a: _port(l) for a, l in w.items()} for w in workloads], 4, 0)
    assert [[[c.to_json() for c in b] for b in doc] for doc in port] == \
        [[[c.to_json() for c in b] for b in doc] for doc in ref]
    rng_a, rng_b = random.Random(9), random.Random(9)
    pw = {a: _port(l) for a, l in workloads[0].items()}
    assert [[c.to_json() for c in b] for b in interleave_rounds(pw, 3, rng_a)] == \
        [[c.to_json() for c in b] for b in interleave_rounds_ref(workloads[0], 3, rng_b)]


def test_session_state_surface():
    t = StreamingMerge(num_docs=3, actors=ACTORS, device="cpu", read_chunk=2)
    j = JaxStreamingMerge(num_docs=3, actors=ACTORS, read_chunk=2)
    assert t.config == j.config
    assert t.layout == "padded"
    assert t.pending_rounds_estimate() == 0
    workloads = generate_workload(seed=2, num_docs=1, ops_per_doc=10)
    t.ingest(1, _port([c for l in workloads[0].values() for c in l]))
    assert t.pending_count() > 0 and t.pending_rounds_estimate() > 0
    t.drain()
    t.sync_device()
    assert t.pending_count() == 0


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMerge(num_docs=1, actors=ACTORS)


@pytest.mark.parametrize("kwargs,item", [
    (dict(mesh=object()), "item 11"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        StreamingMerge(num_docs=1, actors=ACTORS, device="cpu", **kwargs)
    with pytest.raises(ValueError, match="unknown layout"):
        StreamingMerge(num_docs=1, actors=ACTORS, device="cpu", layout="sparse")


@pytest.mark.parametrize("layout,cls", [
    ("paged", "PagedStreamingMerge"),
    ("ragged", "RaggedStreamingMerge"),
])
def test_layout_factory_builds_subclass(layout, cls):
    from peritext_tpu_torch import store

    s = StreamingMerge(num_docs=1, actors=ACTORS, device="cpu", layout=layout)
    assert type(s) is getattr(store, cls) and isinstance(s, StreamingMerge)
    assert s.layout == layout and s.state is None


def _recorded_applies(monkeypatch, workloads, **kwargs):
    """A port session fed 3 arrival rounds, with every apply_batch_compact
    call of its commits recorded as (rows, widths, counts)."""
    from peritext_tpu_torch.ops.kernel import apply_batch_compact as original
    from peritext_tpu_torch.parallel import streaming

    calls = []

    def recording(state, counts, *args, widths, insert_loop_slots=None):
        calls.append((state.elem_id.shape[0], widths, [c.tolist() for c in counts]))
        return original(state, counts, *args, widths=widths, insert_loop_slots=insert_loop_slots)
    monkeypatch.setattr(streaming, "apply_batch_compact", recording)
    t = StreamingMerge(num_docs=len(workloads), actors=ACTORS, device="cpu", **kwargs)
    before = GLOBAL_COUNTERS.get("streaming.block_applies")
    _feed(t, _arrival(workloads, 3, 4)[1])
    assert GLOBAL_COUNTERS.get("streaming.block_applies") - before == len(calls)
    return t, calls


@pytest.mark.parametrize("read_chunk", [8192, 3])
def test_one_apply_per_touched_block_per_round(monkeypatch, read_chunk):
    """Every committed round applies once per block it touches: a one-block
    session once per round, a block-chunked one never on an untouched
    block."""
    workloads = generate_workload(seed=23, num_docs=7, ops_per_doc=30)
    t, calls = _recorded_applies(monkeypatch, workloads, read_chunk=read_chunk, **NARROW)
    blocks = t._padded_docs // t._read_chunk
    assert blocks == (1 if read_chunk > 7 else 3)
    assert all(rows == t._read_chunk for rows, _, _ in calls)
    assert all(any(any(c) for c in counts) for _, _, counts in calls)
    if blocks == 1:
        assert len(calls) == t.rounds
    else:
        assert t.rounds < len(calls) <= t.rounds * blocks


def test_static_rounds_keep_configured_widths(monkeypatch):
    """``static_rounds`` applies every round at the configured widths; the
    default shrinks trickle rounds to their power-of-two buckets."""
    workloads = generate_workload(seed=29, num_docs=5, ops_per_doc=24)
    caps = (WIDE["round_insert_capacity"], WIDE["round_delete_capacity"],
            WIDE["round_mark_capacity"], 16)
    _, static = _recorded_applies(monkeypatch, workloads, static_rounds=True, **SMALL, **WIDE)
    assert static and all(widths == caps for _, widths, _ in static)
    _, adaptive = _recorded_applies(monkeypatch, workloads, **SMALL, **WIDE)
    assert len(adaptive) == len(static)
    assert all(w <= c for _, widths, _ in adaptive for w, c in zip(widths, caps))
    assert any(widths != caps for _, widths, _ in adaptive)


def test_upload_returns_complete_views():
    from peritext_tpu_torch.utils.device import upload_int32

    arrays = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": np.zeros(0, np.int32),
              "c": np.asarray([7], np.int32)}
    out = upload_int32(arrays, torch.device("cpu"))
    assert out["a"].tolist() == [[0, 1, 2], [3, 4, 5]]
    assert out["b"].shape == (0,) and out["c"].tolist() == [7]
