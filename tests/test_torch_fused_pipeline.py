"""The fused round pipeline of the port's sessions (parallel/streaming.py
``drain``, ops/kernel.py's multi-round forms, store/session.py's paged
form) against the reference package's on JAX's CPU, in the pattern of the
reference's tests/test_fused.py.

Every session is fed the same wire frames: each doc's log, shuffled by a
seeded rng, as three frames with a drain after each (the fused sessions
drain pipelined; the oracle sessions, ``fused_pipeline=False``, step one
round at a time).  Low round caps and ``FUSE_MAX_ROUNDS = 2`` force
several multi-round batches per drain.  The reference's sessions are built
once per module and shared.

* fused equals per-round, padded and paged, over seeds: rounds, spans,
  patch streams, digests (full and text), overflow and fallback sets,
  frontier and cursors, and each equals the reference's fused session;
* static rounds (the stacked form) equal their per-round twin and the
  reference;
* the drain-end digest prefetch equals the plain digest; it chains into
  the final staged batch (flat) and into the stacked form, seeding the
  block cache;
* every batch's form and statics equal the reference's, and on the CPU a
  one-round batch takes the undonated ``compact1`` / ``static1`` forms;
* the devprof commit sites (names and dispatch counts) equal the
  reference's;
* ``stacked_multi`` (a fusion window's active tenants only) equals
  whole-lane staging, state plane for plane;
* the forms themselves (``apply_batch_compact_rounds``,
  ``apply_batch_staged_rounds``, ``apply_batch_stacked_rounds``,
  ``apply_batch_stacked_rounds_multi``, ``_scatter_tenant_blocks``) equal
  the reference's functions on the same inputs;
* a repeat workload builds, loads and captures nothing.
"""

import random

import numpy as np
import pytest
import torch

from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
from peritext_tpu.ops import kernel as jax_kernel
from peritext_tpu.ops.packed import empty_docs as jax_empty_docs
from peritext_tpu.parallel.codec import encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF, RecompileSentinel
from peritext_tpu_torch.ops import kernel
from peritext_tpu_torch.ops.encode import MAP_STREAM_COLS, MARK_COLS
from peritext_tpu_torch.ops.packed import empty_docs
from peritext_tpu_torch.parallel.streaming import StreamingMerge

ACTORS = ("doc1", "doc2", "doc3")
STATIC_CAPS = (24, 12, 12, 8)


def _session(cls, layout="padded", static_rounds=False, num_docs=6, fused=True,
             caps=(8, 8, 8, 8)):
    """The reference test module's session (its shapes), of either package."""
    kw = dict(device="cpu") if cls is StreamingMerge else {}
    s = cls(num_docs=num_docs, actors=ACTORS, slot_capacity=64, mark_capacity=48,
            tomb_capacity=48, round_insert_capacity=caps[0], round_delete_capacity=caps[1],
            round_mark_capacity=caps[2], round_map_capacity=caps[3],
            static_rounds=static_rounds, layout=layout, **kw)
    s.fused_pipeline = fused
    s.FUSE_MAX_ROUNDS = 2
    return s


def _frames(workloads, seed, chunks=3):
    """Per round, ``(doc, frame)`` pairs: each doc's log shuffled by the
    seeded rng, cut into ``chunks`` frames (the reference test's feed)."""
    rng = random.Random(seed)
    plans = []
    for w in workloads:
        ch = [c for a in sorted(w) for c in w[a]]
        rng.shuffle(ch)
        size = -(-len(ch) // chunks)
        plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
    return [[(d, encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
             for d, p in enumerate(plans) if r < len(p)] for r in range(chunks)]


def _feed(s, frames, per_round_steps=False, prefetch=False, record=None):
    """Ingest and drain (or step) round by round; ``record`` collects each
    batch's statics as the session's prep returns them."""
    s.prefetch_digest = prefetch
    if record is not None:
        prep = s._prep_fused_batch

        def spied(batch):
            statics = prep(batch)
            record.append(statics)
            return statics
        s._prep_fused_batch = spied
    for items in frames:
        s.ingest_frames(items)
        if per_round_steps:
            while s.step() > 0:
                pass
        else:
            s.drain()
    return s


def _workload(seed, ops=40):
    return generate_workload(seed=seed, num_docs=6, ops_per_doc=ops)


def _cursors(workloads, per_doc=3, seed=0):
    """Cursors into every doc's converged text, from the reference's oracle
    (both packages resolve the same cursor objects)."""
    rng = random.Random(seed)
    out = {}
    for d, w in enumerate(workloads):
        doc = jax_oracle_doc(w)
        n = sum(len(span["text"]) for span in doc.get_text_with_formatting(["text"]))
        if n:
            out[d] = [doc.get_cursor(["text"], rng.randrange(n)) for _ in range(per_doc)]
    return out


def assert_same(a, b):
    """Every read of two sessions (of either package) is equal."""
    assert a.rounds == b.rounds
    assert a.read_all() == b.read_all()
    assert a.digest() == b.digest()
    assert a.digest(full=False) == b.digest(full=False)
    assert [a.doc_digest(d) for d in range(a.num_docs)] == \
        [b.doc_digest(d) for d in range(b.num_docs)]
    assert a.overflow_count() == b.overflow_count()
    assert [s.fallback for s in a.docs] == [s.fallback for s in b.docs]
    assert a.frontier() == b.frontier()
    assert a.pending_count() == b.pending_count()


def _canon(statics):
    """A batch's statics with the paged plans' host arrays as lists."""
    def canon(x):
        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, (tuple, list)):
            return tuple(canon(v) for v in x)
        return x
    return canon(statics)


#: (layout, seed, static, prefetch) -> (reference session, its statics)
_REF = {}


@pytest.fixture(scope="module")
def reference():
    """The reference's fused session of one configuration, built once."""
    def get(layout, seed, static=False, prefetch=True):
        key = (layout, seed, static, prefetch)
        if key not in _REF:
            record = []
            caps = STATIC_CAPS if static else (8, 8, 8, 8)
            s = _feed(_session(JaxStreamingMerge, layout, static, caps=caps),
                      _frames(_workload(seed), seed), prefetch=prefetch, record=record)
            _REF[key] = (s, record)
        return _REF[key]
    yield get
    for s, _ in _REF.values():
        if getattr(s, "_stager", None) is not None:
            s._stager.close()
    _REF.clear()


@pytest.mark.parametrize("layout", ["padded", "paged"])
@pytest.mark.parametrize("seed", [11, 47])
def test_fused_equals_per_round_across_layouts(reference, layout, seed):
    workloads = _workload(seed)
    frames = _frames(workloads, seed)
    record = []
    fused = _feed(_session(StreamingMerge, layout), frames, prefetch=True, record=record)
    oracle = _feed(_session(StreamingMerge, layout, fused=False), frames, per_round_steps=True)
    ref, ref_record = reference(layout, seed)
    assert fused.rounds > 2
    assert any(s[0] in ("flat", "paged") and len(s[1]) == 2 for s in record)
    assert_same(fused, oracle)
    assert_same(fused, ref)
    assert fused.read_patches_all() == oracle.read_patches_all()
    cursors = _cursors(workloads)
    assert cursors and fused.resolve_cursors_batch(cursors) == ref.resolve_cursors_batch(cursors)
    assert [_canon(s) for s in record] == [_canon(s) for s in ref_record]
    fused._ensure_stager().close()


def test_static_rounds_fused_parity(reference):
    frames = _frames(_workload(7), 7)
    record = []
    fused = _feed(_session(StreamingMerge, static_rounds=True, caps=STATIC_CAPS), frames,
                  record=record)
    oracle = _feed(_session(StreamingMerge, static_rounds=True, caps=STATIC_CAPS, fused=False),
                   frames, per_round_steps=True)
    ref, ref_record = reference("padded", 7, static=True, prefetch=False)
    assert {s[0] for s in record} == {"stacked", "static1"}
    assert record == ref_record
    assert_same(fused, oracle)
    assert_same(fused, ref)
    fused._ensure_stager().close()


def test_prefetch_digest_matches_plain_digest(reference):
    frames = _frames(_workload(11), 11)
    a = _feed(_session(StreamingMerge), frames, prefetch=True)
    b = _feed(_session(StreamingMerge), frames, prefetch=False)
    ref, _ = reference("padded", 11)
    assert a.digest() == b.digest() == ref.digest()
    assert a.digest(refresh=True) == b.digest()


def test_drain_end_digest_chains_into_final_staged_batch(reference):
    frames = _frames(_workload(11), 11)
    before = GLOBAL_COUNTERS.get("streaming.digest_chained")
    record = []
    fused = _feed(_session(StreamingMerge), frames, prefetch=True, record=record)
    assert GLOBAL_COUNTERS.get("streaming.digest_chained") > before
    assert record[-1][0] == "flat"
    stamp, cache = fused._resolved_cache
    assert stamp == fused.rounds and 0 in cache
    entry = cache[0]
    digest = fused.digest()
    assert fused._resolved_cache[1][0] is entry
    oracle = _feed(_session(StreamingMerge, fused=False), frames, per_round_steps=True)
    ref, _ = reference("padded", 11)
    assert digest == oracle.digest() == ref.digest()
    assert fused.read_all() == oracle.read_all()


def test_drain_end_digest_chains_on_stacked_serving_form(reference):
    frames = _frames(_workload(23), 23)
    before = GLOBAL_COUNTERS.get("streaming.digest_chained")
    fused = _feed(_session(StreamingMerge, static_rounds=True, caps=STATIC_CAPS), frames,
                  prefetch=True)
    assert GLOBAL_COUNTERS.get("streaming.digest_chained") > before
    oracle = _feed(_session(StreamingMerge, static_rounds=True, caps=STATIC_CAPS, fused=False),
                   frames, per_round_steps=True)
    ref, _ = reference("padded", 23, static=True)
    assert fused.digest() == oracle.digest() == ref.digest()
    assert fused.read_all() == oracle.read_all() == ref.read_all()


def test_cpu_resolves_to_undonated_dispatch(reference):
    """On the CPU nothing donates: a one-round batch takes the per-round
    discipline's own apply (``compact1``), as the reference's CPU does."""
    assert kernel.resolve_state_donation(torch.zeros(1)) is False
    assert kernel.resolve_state_donation(torch.zeros(1, device="meta")) is False
    assert jax_kernel.resolve_state_donation(platform="cpu") is False
    frames = _frames(_workload(11), 11)
    record = []
    s = _feed(_session(StreamingMerge), frames, record=record)
    _, ref_record = reference("padded", 11)
    singles = [st for st in record if st[0] == "compact1"]
    assert singles and all(len(st) == 3 for st in singles)
    assert {st[0] for st in record} == {"compact1", "flat"}
    assert [st for st in record if st[0] == "compact1"] == \
        [st for st in ref_record if st[0] == "compact1"]
    assert s.state.elem_id.device.type == "cpu"


@pytest.mark.parametrize("layout", ["padded", "paged"])
def test_devprof_commit_sites_equal_the_reference(reference, layout):
    """Armed, both packages record the same commit sites, each as many
    times (the port's read paths have no site, the reference's do)."""
    frames = _frames(_workload(47), 47)
    for prof in (GLOBAL_DEVPROF, JAX_DEVPROF):
        prof.reset()
        prof.enable()
    try:
        _feed(_session(StreamingMerge, layout), frames, prefetch=True)
        _feed(_session(JaxStreamingMerge, layout), frames, prefetch=True)
        ours, ref = GLOBAL_DEVPROF.snapshot(), JAX_DEVPROF.snapshot()
    finally:
        for prof in (GLOBAL_DEVPROF, JAX_DEVPROF):
            prof.disable()
            prof.reset()
    calls = {name: site["dispatches"] for name, site in ours["sites"].items()}
    assert calls and calls == {name: site["dispatches"] for name, site in ref["sites"].items()
                               if name in calls}
    want = ({"apply_batch_compact", "apply_batch_staged_rounds", "_fused_rounds_digest"}
            if layout == "padded" else {"apply_batch_paged", "apply_batch_paged_groups"})
    assert set(calls) <= want
    assert ("apply_batch_paged_groups" if layout == "paged" else "_fused_rounds_digest") in calls
    assert ours["occupancy"] == ref["occupancy"]


def test_stacked_multi_equals_whole_lane_staging(reference):
    """A static-round session drained under ``fusion_rows`` (the active
    tenants' row blocks only) ends with the state of its whole-lane twin,
    plane for plane, and of the reference's session under the same rows."""
    frames = _frames(_workload(13, ops=24), 13)
    # two 2-doc tenants of the 6-doc lane carry every op
    frames = [[(d, f) for d, f in items if d in (0, 1, 4, 5)] for items in frames]
    rows = ((0, 4), 2)
    sessions, records = [], []
    for cls, fusion in ((StreamingMerge, rows), (StreamingMerge, None),
                        (JaxStreamingMerge, rows)):
        s = _session(cls, static_rounds=True, caps=STATIC_CAPS)
        s.fusion_rows = fusion
        records.append([])
        sessions.append(_feed(s, frames, record=records[-1]))
    multi, whole, ref = sessions
    assert {st[0] for st in records[0]} == {"stacked_multi"}
    assert records[0] == records[2]
    assert {st[0] for st in records[1]} <= {"stacked", "static1"}
    for field in multi.state._fields:
        a = getattr(multi.state, field).numpy()
        np.testing.assert_array_equal(a, getattr(whole.state, field).numpy(), err_msg=field)
        np.testing.assert_array_equal(a, np.asarray(getattr(ref.state, field)), err_msg=field)
    assert multi.digest() == whole.digest() == ref.digest()
    for s in sessions:
        s._stager.close()


def _random_state(rng, d, s_cap, marks, maps, with_ref=True):
    """A reachable state of both packages: d docs after one round of random
    head-and-chain inserts (so later rounds have references to find)."""
    st = empty_docs(d, s_cap, marks, tomb_capacity=marks, map_capacity=maps, device="cpu")
    k = 6
    ops = (np.arange(d * k, dtype=np.int32).reshape(d, k) + 1) * 4
    ref = np.zeros((d, k), np.int32)
    ref[:, 1:] = ops[:, :-1]
    chars = rng.integers(65, 91, size=(d, k)).astype(np.int32)
    z = np.zeros((d, 1), np.int32)
    arrays = (ref, ops, chars, z, {c: z for c in MARK_COLS}, np.zeros(d, np.int32),
              {c: z for c in MAP_STREAM_COLS}, np.zeros(d, np.int32))
    port = kernel.apply_batch(st, tuple(torch.as_tensor(a) if not isinstance(a, dict) else
                                        {c: torch.as_tensor(v) for c, v in a.items()}
                                        for a in arrays))
    jax_state = jax_kernel.apply_batch(
        jax_empty_docs(d, s_cap, marks, tomb_capacity=marks, map_capacity=maps), arrays,
        insert_impl="lax") if with_ref else None
    return port, jax_state, ops


def _round_arrays(rng, d, ki, kd, live_ops, base):
    """One padded round, dense prefixes per doc: inserts after random live
    elements of the doc (new op ids from ``base``), deletes of random live
    elements.  Returns ``(ins_ref, ins_op, ins_char, del_target, n_ins,
    n_del)``."""
    n_ins = rng.integers(0, ki + 1, size=d)
    n_del = rng.integers(0, kd + 1, size=d)
    pick = lambda k: np.stack([rng.choice(live_ops[i], size=k) for i in range(d)])  # noqa: E731
    live_i = np.arange(ki)[None, :] < n_ins[:, None]
    live_d = np.arange(kd)[None, :] < n_del[:, None]
    ins_op = (np.arange(d * ki).reshape(d, ki) + base) * 4 + 1
    return (np.where(live_i, pick(ki), 0).astype(np.int32),
            np.where(live_i, ins_op, 0).astype(np.int32),
            np.where(live_i, rng.integers(97, 123, size=(d, ki)), 0).astype(np.int32),
            np.where(live_d, pick(kd), 0).astype(np.int32),
            n_ins.astype(np.int32), n_del.astype(np.int32))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.as_tensor(np.asarray(tree))


def _equal_states(port, ref):
    for field, a in zip(port._fields, port):
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(ref, field)), err_msg=field)


def test_forms_equal_the_reference_functions():
    """The stacked, staged and per-round-tuple forms on the same two rounds
    over a reachable state all equal the reference's staged form (its lax
    insert), which its own tests hold equal to its other forms."""
    rng = np.random.default_rng(5)
    d, s_cap, km, kp, ki, kd = 4, 64, 16, 8, 4, 3
    port0, jax0, ops = _random_state(rng, d, s_cap, km, kp)
    rounds = [_round_arrays(rng, d, ki, kd, ops, 1000 * (r + 1)) for r in range(2)]
    loops = (16, None)
    zeros = np.zeros((d, 2), np.int32)
    nil = np.zeros(d, np.int32)
    stacked = tuple(np.stack([r[j] for r in rounds]) for j in range(4)) + (
        {c: np.stack([zeros] * 2) for c in MARK_COLS}, np.stack([nil] * 2),
        {c: np.stack([zeros] * 2) for c in MAP_STREAM_COLS}, np.stack([nil] * 2))
    got_stacked = kernel.apply_batch_stacked_rounds(port0, _to_torch(stacked),
                                                    loop_slots_seq=loops)
    # the same rounds as flat streams: per round its docs' prefixes, padded
    # to a shared bucket of 16, concatenated (the staged form), or one
    # tuple each (the per-round tuple form)
    lens = 16

    def flat(a, n):
        v = np.concatenate([a[i, :n[i]] for i in range(d)])
        return np.pad(v, (0, lens - len(v))).astype(np.int32)

    per_round = []
    for r in rounds:
        counts = (r[4], r[5], nil, nil)
        per_round.append((counts, tuple(flat(r[j], r[4]) for j in range(3)), flat(r[3], r[5]),
                          {c: np.zeros(8, np.int32) for c in MARK_COLS},
                          {c: np.zeros(8, np.int32) for c in MAP_STREAM_COLS}))
    counts_all = np.stack([np.stack(p[0]) for p in per_round]).astype(np.int32)
    ins_all = tuple(np.concatenate([p[1][j] for p in per_round]) for j in range(3))
    del_all = np.concatenate([p[2] for p in per_round])
    mark_all = {c: np.zeros(16, np.int32) for c in MARK_COLS}
    map_all = {c: np.zeros(16, np.int32) for c in MAP_STREAM_COLS}
    statics = dict(widths_seq=((ki, kd, 2, 2),) * 2, loop_slots_seq=loops,
                   ins_lens=(lens,) * 2, del_lens=(lens,) * 2, mark_lens=(8,) * 2,
                   map_lens=(8,) * 2)
    got = kernel.apply_batch_staged_rounds(port0, *_to_torch(
        (counts_all, ins_all, del_all, mark_all, map_all)), **statics)
    want_staged = jax_kernel.apply_batch_staged_rounds(
        jax0, counts_all, ins_all, del_all, mark_all, map_all, insert_impl="lax", **statics)
    _equal_states(got, want_staged)
    got_rounds = kernel.apply_batch_compact_rounds(
        port0, _to_torch(tuple(per_round)), widths_seq=statics["widths_seq"],
        loop_slots_seq=loops)
    # the reference's forms agree with each other (its own tests): one of
    # them stands for all three here
    for form in (got_stacked, got_rounds):
        _equal_states(form, want_staged)
    assert bool(got_rounds.num_slots.sum() > port0.num_slots.sum())


def test_scatter_tenant_blocks_equals_the_reference_and_multi_the_whole_lane():
    rng = np.random.default_rng(9)
    d, s_cap, km, kp, ki, kd = 8, 64, 16, 8, 4, 3
    port0, _, ops = _random_state(rng, d, s_cap, km, kp, with_ref=False)
    blocks = rng.integers(0, 50, size=(4, 2, 3)).astype(np.int32)
    blocks[3] = 0  # a zero pad block
    base = np.asarray([0, 4, 6, 0], np.int32)
    got = kernel._scatter_tenant_blocks(torch.as_tensor(blocks), torch.as_tensor(base), d)
    want = jax_kernel._scatter_tenant_blocks(blocks, base, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # two rounds staged as tenant blocks of 2 rows at rows 2 and 6
    rounds = [_round_arrays(rng, d, ki, kd, ops, 1000 * (r + 1))[:4] for r in range(2)]
    t_rows = [(2, 4), (6, 8)]

    def blk(a):
        out = np.zeros((2, 2) + a.shape[1:], np.int32)
        for t, (lo, hi) in enumerate(t_rows):
            out[t] = a[lo:hi]
        return out

    zeros = np.zeros((d, 2), np.int32)
    per = [(blk(r[0]), blk(r[1]), blk(r[2]), blk(r[3]), {c: blk(zeros) for c in MARK_COLS},
            blk(np.zeros(d, np.int32)), {c: blk(zeros) for c in MAP_STREAM_COLS},
            blk(np.zeros(d, np.int32))) for r in rounds]
    stacked = tuple({c: np.stack([p[j][c] for p in per]) for c in per[0][j]}
                    if isinstance(per[0][j], dict) else np.stack([p[j] for p in per])
                    for j in range(8))
    row_base = np.asarray([2, 6], np.int32)
    got = kernel.apply_batch_stacked_rounds_multi(port0, _to_torch(stacked),
                                                  torch.as_tensor(row_base),
                                                  loop_slots_seq=(None, None))
    # the whole-lane planes the blocks stand for: the tenants' rows, zeros
    # elsewhere, through the stacked form (the reference's stacked_multi
    # is held to the port's at session level,
    # test_stacked_multi_equals_whole_lane_staging)
    def lane(a):
        out = np.zeros_like(a)
        for lo, hi in t_rows:
            out[lo:hi] = a[lo:hi]
        return out

    whole = tuple(np.stack([lane(r[j]) for r in rounds]) for j in range(4)) + (
        {c: np.zeros((2, d, 2), np.int32) for c in MARK_COLS}, np.zeros((2, d), np.int32),
        {c: np.zeros((2, d, 2), np.int32) for c in MAP_STREAM_COLS}, np.zeros((2, d), np.int32))
    whole = _to_torch(whole)
    want = kernel.apply_batch_stacked_rounds(port0, whole, loop_slots_seq=(None, None))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got.num_slots, port0.num_slots)


def test_fused_pipeline_zero_rebuilds_on_repeat_workload():
    """A fresh session serving the same arrival again builds, loads and
    captures nothing (on the CPU nothing is captured at all)."""
    frames = _frames(_workload(31, ops=36), 3)
    cold = _feed(_session(StreamingMerge), frames, prefetch=True)
    with RecompileSentinel() as sentinel:
        sentinel.mark()
        warm = _feed(_session(StreamingMerge), frames, prefetch=True)
        digest = warm.digest()
        sentinel.assert_steady_state("fused pipeline repeat workload")
    assert warm.read_all() == cold.read_all() and digest == cold.digest()
    stats = warm._graphs.stats()
    assert stats and all(row["captures"] == row["replays"] == 0 for row in stats.values())
    for s in (cold, warm):
        s._stager.close()
