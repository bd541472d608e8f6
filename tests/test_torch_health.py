"""The port's fault-domain and placement surfaces of ``StreamingMerge``
against the reference package's, on the CPU: ``health()`` after
``faults.corrupt_detectably`` quarantines and ``force_fallback`` (padded,
paged and ragged), ``reshard()`` (default, explicit, validation, spreading
quarantined docs; in the patterns of the reference's
tests/test_streaming.py ``TestReshard``), ``digest_async()`` with a round
or a reshard before ``wait()``, and the port's copy of
``parallel/faults.py`` (the same rng calls give the same faults).

The reference's ``read_root`` decodes a doc's pre-reshard row after a
reshard, so after one, roots are held against the scalar oracle instead.
"""

import random

import pytest

from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.parallel import faults as jax_faults
from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.parallel import faults
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from test_torch_paged_streaming import ACTORS, _port, assert_same, frame_arrival

WIDE = dict(round_insert_capacity=256, round_delete_capacity=128, round_mark_capacity=128)


def _skewed(seed):
    """8 docs of 30 ops with two of 150: a skew for reshard to balance."""
    workloads = generate_workload(seed=seed, num_docs=8, ops_per_doc=30)
    big = generate_workload(seed=seed + 1, num_docs=2, ops_per_doc=150)
    workloads[0], workloads[1] = big[0], big[1]
    return workloads


def _changes(w):
    return [ch for log in w.values() for ch in log]


def _pair(workloads, ingest="all", **kw):
    """(reference, port) padded sessions fed each doc's changes by objects:
    all of them, or the first half."""
    kwargs = dict(num_docs=len(workloads), actors=ACTORS, **dict(WIDE, **kw))
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    for d, w in enumerate(workloads):
        chs = _changes(w)
        if ingest == "half":
            chs = chs[: len(chs) // 2]
        j.ingest(d, chs)
        t.ingest(d, _port(chs))
    j.drain()
    t.drain()
    return j, t


def _roots_equal_oracle(s, workloads):
    assert [s.read_root(d) for d in range(len(workloads))] == \
        [jax_oracle_doc(w).root for w in workloads]


# -- health ----------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_health_equals_reference_after_quarantine_and_fallback(layout):
    """Detectably corrupted frames quarantine their docs (reason decode),
    a clean redelivery plus a drain lifts them, a forced fallback demotes
    a doc: health() equals the reference's after every step."""
    workloads = generate_workload(seed=29, num_docs=12, ops_per_doc=40)
    frames = frame_arrival(workloads, 3, 7)
    kwargs = dict(num_docs=12, actors=ACTORS, slot_capacity=256, mark_capacity=64,
                  tomb_capacity=64, layout=layout)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    spec = faults.FaultSpec(truncate_p=0.5, bitflip_p=0.5)
    rng, ref_rng = random.Random(3), random.Random(3)
    assert t.health() == j.health()
    corrupted = set()
    for r in range(3):
        items, ref_items = [], []
        for d, batch in enumerate(frames):
            f = batch[r]
            bad = faults.corrupt_detectably(f, rng, spec) if d % 4 == 1 else None
            ref_bad = jax_faults.corrupt_detectably(f, ref_rng, spec) if d % 4 == 1 else None
            assert bad == ref_bad
            if bad is not None:
                corrupted.add(d)
                items.append((d, bad))
                ref_items.append((d, bad))
            items.append((d, f))
            ref_items.append((d, f))
        t.ingest_frames(items, on_corrupt="quarantine")
        j.ingest_frames(ref_items, on_corrupt="quarantine")
        assert t.health() == j.health()
        t.drain()
        j.drain()
        assert t.health() == j.health()
    assert corrupted
    t.force_fallback(5, detail="injected")
    j.force_fallback(5, detail="injected")
    h = t.health()
    assert h == j.health()
    assert h["fallback_docs"] == 1 and h["quarantined"][5]["reason"] == "device-round"
    assert h["frame_docs"] == 11 and h["pending_changes"] == 0
    if layout == "ragged":
        assert h["padding_efficiency_cum"] == 1.0
    assert_same(t, j)


def test_health_of_an_object_session_with_pending_work():
    workloads = generate_workload(seed=30, num_docs=4, ops_per_doc=30)
    j, t = _pair(workloads, ingest="half")
    for s, conv in ((j, lambda c: c), (t, _port)):
        s.ingest(2, conv(_changes(workloads[2])[-3:]))
    assert t.health() == j.health()
    assert t.health()["pending_changes"] > 0
    assert t.health()["round_padding_efficiency"] is not None


# -- reshard ---------------------------------------------------------------------


def test_reshard_preserves_state_and_keeps_ingesting():
    workloads = _skewed(5)
    j, t = _pair(workloads, ingest="half", read_chunk=2)
    before_digest, before_reads = t.digest(), t.read_all()
    out = t.reshard()
    assert out == j.reshard()
    assert out["moved"] > 0
    assert max(out["shard_load"]) < 0.7 * sum(out["shard_load"])
    assert t.digest() == before_digest == t.digest(refresh=True)
    assert t.read_all() == before_reads
    for d, w in enumerate(workloads):
        chs = _changes(w)
        j.ingest(d, chs[len(chs) // 2:])
        t.ingest(d, _port(chs[len(chs) // 2:]))
    j.drain()
    t.drain()
    assert t.read_all() == j.read_all() == [
        jax_oracle_doc(w).get_text_with_formatting(["text"]) for w in workloads]
    assert t.digest() == t.digest(refresh=True) == j.digest()
    _roots_equal_oracle(t, workloads)
    assert_same(t, j, roots=False)


def test_reshard_spreads_quarantined_docs_across_blocks():
    workloads = _skewed(31)
    j, t = _pair(workloads, read_chunk=2)
    for s in (j, t):
        for d in (0, 1, 2, 3):
            s.force_fallback(d, detail="test demotion")
    before_digest, before_reads = t.digest(), t.read_all()
    out = t.reshard()
    assert out == j.reshard()
    assert all(load > 0 for load in out["host_bound_load"]), out
    assert sum(out["host_bound_load"]) <= sum(out["shard_load"])
    assert t.digest() == before_digest == t.digest(refresh=True)
    assert t.read_all() == before_reads
    assert t.health() == j.health()


def test_reshard_explicit_assignment_and_validation():
    workloads = _skewed(21)
    j, t = _pair(workloads, read_chunk=2)
    before = t.digest()
    out = t.reshard([3, 3, 2, 2, 1, 1, 0, 0])
    assert out == j.reshard([3, 3, 2, 2, 1, 1, 0, 0])
    assert t.digest() == before
    assert t.read_all() == [jax_oracle_doc(w).get_text_with_formatting(["text"])
                            for w in workloads]
    _roots_equal_oracle(t, workloads)
    with pytest.raises(ValueError, match="capacity"):
        t.reshard([0] * 8)
    with pytest.raises(ValueError, match="cover"):
        t.reshard([0, 1])
    with pytest.raises(ValueError, match="range"):
        t.reshard([4, 0, 0, 1, 1, 2, 2, 3])
    # one block: nothing to balance
    one = StreamingMerge(num_docs=3, actors=ACTORS, device="cpu")
    assert one.reshard() == JaxStreamingMerge(num_docs=3, actors=ACTORS).reshard()


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_reshard_between_async_digest_and_wait(layout):
    """A reshard between digest_async() and wait() neither changes the
    value (the hashes describe the rows at scheduling time) nor writes the
    pre-reshard hashes into the carried plane."""
    workloads = _skewed(31)
    kwargs = dict(num_docs=8, actors=ACTORS, read_chunk=2, layout=layout, **WIDE)
    j, t = JaxStreamingMerge(**kwargs), StreamingMerge(**kwargs, device="cpu")
    for d, w in enumerate(workloads):
        j.ingest(d, _changes(w))
        t.ingest(d, _port(_changes(w)))
    j.drain()
    t.drain()
    for s in (j, t):
        s.docs[3].fallback = True  # a replay doc exercises the row -> doc map
    expected = t.digest(refresh=True)
    assert expected == j.digest(refresh=True)
    pending, ref_pending = t.digest_async(), j.digest_async()
    out = t.reshard()
    assert out == j.reshard() and out["moved"] > 0
    assert pending.wait() == ref_pending.wait() == expected
    assert t.digest() == t.digest(refresh=True) == expected


def test_digest_async_before_and_after_a_round():
    """The handle's value is the digest at scheduling time; a round before
    wait() keeps its hashes out of the carried plane."""
    workloads = generate_workload(seed=33, num_docs=6, ops_per_doc=40)
    j, t = _pair(workloads, ingest="half")
    want = t.digest()
    assert t.digest_async().wait() == j.digest_async().wait() == want
    pending = t.digest_async()
    for d, w in enumerate(workloads):
        chs = _changes(w)
        t.ingest(d, _port(chs[len(chs) // 2:]))
        j.ingest(d, chs[len(chs) // 2:])
    t.drain()
    j.drain()
    assert pending.wait() == want
    assert t.digest() == t.digest(refresh=True) == j.digest() != want


# -- parallel/faults.py ----------------------------------------------------------


def test_faults_make_the_reference_rng_calls():
    workloads = generate_workload(seed=8, num_docs=1, ops_per_doc=60)
    chs = _changes(workloads[0])
    port = _port(chs)
    spec = faults.FaultSpec(drop_p=0.2, dup_p=0.3, reorder=True)
    ref_spec = jax_faults.FaultSpec(drop_p=0.2, dup_p=0.3, reorder=True)
    assert spec.any_faults() and not spec.any_payload_faults()
    for seed in range(5):
        mine = faults.perturb_delivery(port, random.Random(seed), spec)
        theirs = jax_faults.perturb_delivery(chs, random.Random(seed), ref_spec)
        assert [(c.actor, c.seq) for c in mine] == [(c.actor, c.seq) for c in theirs]
    frame = jax_encode_frame(chs)
    payload = faults.FaultSpec(truncate_p=0.5, bitflip_p=0.7, reorder=False)
    ref_payload = jax_faults.FaultSpec(truncate_p=0.5, bitflip_p=0.7, reorder=False)
    assert faults.perturb_frame(frame, random.Random(0), faults.FaultSpec(reorder=False)) is frame
    detected = 0
    for seed in range(40):
        assert faults.perturb_frame(frame, random.Random(seed), payload) == \
            jax_faults.perturb_frame(frame, random.Random(seed), ref_payload)
        bad = faults.corrupt_detectably(frame, random.Random(seed), payload)
        assert bad == jax_faults.corrupt_detectably(frame, random.Random(seed), ref_payload)
        detected += bad is not None
    assert 0 < detected < 40


def test_fallback_replay_is_kept_until_the_history_grows(monkeypatch):
    """Every read of a fallback doc goes through one scalar replay until the
    doc's history grows; a caller editing a returned root does not reach
    it; reads stay equal to the reference's."""
    from peritext_tpu_torch.parallel import streaming as streaming_mod

    workloads = generate_workload(seed=35, num_docs=4, ops_per_doc=40)
    j, t = _pair(workloads, ingest="half")
    for s in (j, t):
        s.force_fallback(1)
    replays = []
    real = streaming_mod._replay_doc
    monkeypatch.setattr(streaming_mod, "_replay_doc", lambda ch: replays.append(1) or real(ch))
    assert t.read(1) == j.read(1)
    root = t.read_root(1)
    assert root == j.read_root(1)
    root["text"].append("!")
    assert t.read_root(1) == j.read_root(1)
    assert t.read_all() == j.read_all() and t.digest() == j.digest()
    assert t.doc_digest(1) == j.doc_digest(1)
    assert len(replays) == 1
    chs = _changes(workloads[1])
    t.ingest(1, _port(chs[len(chs) // 2:]))
    j.ingest(1, chs[len(chs) // 2:])
    assert t.read(1) == j.read(1) == jax_oracle_doc(workloads[1]).get_text_with_formatting(["text"])
    assert len(replays) == 2
