"""The spans inside the schedule, the ingest and the digest of
``StreamingMerge``, the profiler ranges they open, and the phase markers
inside the digest's device programs (obs/spans.py ``profiler_range``).

Every sub-span appears only where its work ran, as a child of the layer
span it belongs to and inside that span's interval; ``host_parse_seconds``
is the sum of the ``ingest.parse`` spans; under a ``torch.profiler`` the
spans and markers are profiler ranges, and with none recording no range is
entered; a traced session's digests equal an untraced one's."""

import random
from collections import Counter

import pytest
import torch

from peritext_tpu_torch.obs import GLOBAL_TRACER, profiler_range
from peritext_tpu_torch.obs import spans as spans_mod
from peritext_tpu_torch.parallel.codec import decode_frame, encode_frame
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.capture_audit import CaptureAudit
from peritext_tpu_torch.testing.fuzz import generate_workload

ACTORS = ("doc1", "doc2", "doc3")
DOCS = 8
CAPS = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=64)

#: each new span, and the spans it may sit in; the chained digest of a
#: one-block drain builds its masks and tables inside the commit's
#: ``streaming.apply``
PARENTS = {
    "ingest.parse": {"streaming.ingest"},
    "ingest.pool": {"streaming.ingest"},
    "schedule.objects": {"streaming.schedule"},
    "schedule.gather": {"streaming.schedule"},
    "schedule.widths": {"streaming.schedule"},
    "schedule.split": {"streaming.schedule"},
    "schedule.defer": {"streaming.schedule"},
    "digest.masks": {"streaming.digest_async", "streaming.resolve", "streaming.digest",
                     "streaming.apply"},
    "digest.tables": {"streaming.resolve", "streaming.digest_async", "streaming.digest",
                      "streaming.apply"},
    "digest.launch": {"streaming.resolve", "streaming.digest_async", "streaming.digest"},
    "digest.fetch": {"streaming.digest_wait", "streaming.digest"},
    "digest.replay": {"streaming.digest_wait", "streaming.digest"},
    "streaming.digest_async": {None},
    "streaming.digest_wait": {None},
}


def _frames(seed=5, ops=30, chunks=2):
    """Per arrival round, ``(doc, frame)`` pairs: each doc's log shuffled,
    in ``chunks`` frames."""
    rng = random.Random(seed)
    plans = []
    for w in generate_workload(seed, num_docs=DOCS, ops_per_doc=ops):
        ch = [c for a in sorted(w) for c in w[a]]
        rng.shuffle(ch)
        size = -(-len(ch) // chunks)
        plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
    return [[(d, encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
             for d, p in enumerate(plans) if r < len(p)] for r in range(chunks)]


def _run(frames, read_chunk=DOCS, objects=(), fallback=()):
    """A padded session over ``frames`` (``read_chunk`` < DOCS: read
    blocks), with docs ``objects`` fed as change objects, each arrival
    drained; then ``digest_async().wait()`` and ``digest()``.  Returns the
    session, the spans it finished and the two digests."""
    seen = []
    GLOBAL_TRACER.add_sink(seen.append)
    try:
        s = StreamingMerge(num_docs=DOCS, actors=ACTORS, device="cpu", read_chunk=read_chunk,
                           **CAPS)
        for d in fallback:
            s.force_fallback(d)
        for items in frames:
            s.ingest_frames([(d, f) for d, f in items if d not in objects])
            for d, f in items:
                if d in objects:
                    s.ingest(d, decode_frame(f))
            s.drain()
        if s._stager is not None:
            s._stager.close()
        waited = s.digest_async().wait()
        full = s.digest()
    finally:
        GLOBAL_TRACER.remove_sink(seen.append)
    return s, seen, (waited, full)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def sessions(frames):
    """Two read blocks; one block; one block with object docs and a
    fallback doc."""
    return {"blocks": _run(frames, read_chunk=DOCS // 2), "one_block": _run(frames),
            "objects": _run(frames, objects=(1, 2), fallback=(5,))}


@pytest.mark.parametrize("name", ["blocks", "one_block", "objects"])
def test_every_new_span_sits_in_its_layer_span(sessions, name):
    _, seen, _ = sessions[name]
    by_id = {sp.span_id: sp for sp in seen}
    for sp in seen:
        if sp.name not in PARENTS:
            continue
        parent = by_id.get(sp.parent_id)
        assert (parent.name if parent else None) in PARENTS[sp.name], (sp.name, parent)
        if parent is not None:
            assert parent.ts <= sp.ts
            assert sp.ts + sp.duration <= parent.ts + parent.duration + 1e-3


def test_spans_open_only_where_their_work_ran(sessions):
    names = {k: Counter(sp.name for sp in v[1]) for k, v in sessions.items()}
    # one frame parse and one pool append a native ingest
    for n in names.values():
        assert n["ingest.parse"] == n["ingest.pool"] == n["streaming.ingest"] == 2
    # frames only: no object pass; the widths adapt in one-block sessions alone
    assert names["blocks"]["schedule.objects"] == names["one_block"]["schedule.objects"] == 0
    assert names["objects"]["schedule.objects"] > 0
    assert names["blocks"]["schedule.widths"] == 0 and names["one_block"]["schedule.widths"] > 0
    for key in ("blocks", "one_block"):
        s, seen, _ = sessions[key]
        n = names[key]
        assert s.pending_count() == 0
        assert n["schedule.gather"] == n["schedule.split"] >= s.rounds
        assert 0 < n["schedule.defer"] < n["schedule.split"]
        # the drain's last pass finds the pool empty: it opens no sub-span
        last = [sp for sp in seen if sp.name == "streaming.schedule"][-1]
        assert not any(sp.parent_id == last.span_id for sp in seen)
        assert n["streaming.digest_async"] == n["streaming.digest_wait"] == 1
        assert n["digest.replay"] == 0
    # the first digest resolves each block: masks, tables and a launch a block
    blocks = sessions["blocks"][1]
    resolves = [sp for sp in blocks if sp.name == "streaming.resolve"]
    assert len(resolves) == 2
    ids = {sp.span_id for sp in resolves}
    assert sum(sp.name == "digest.tables" and sp.parent_id in ids for sp in blocks) == 2
    assert sum(sp.name == "digest.launch" and sp.parent_id in ids for sp in blocks) == 2
    # the fallback doc's term is replayed in both the wait and the digest
    assert names["objects"]["digest.replay"] == 2


def test_host_parse_seconds_is_the_sum_of_the_parse_spans(sessions):
    for s, seen, _ in sessions.values():
        parse = [sp.duration for sp in seen if sp.name == "ingest.parse"]
        assert parse and s.host_parse_seconds == sum(parse)


def test_spans_and_markers_are_profiler_ranges(frames):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, seen, digests = _run(frames, read_chunk=DOCS // 2)
    names = {e.name for e in prof.events()}
    assert {"schedule.split", "digest.tables", "resolve.cover", "digest.hash",
            "resolve.anchors", "resolve.comments", "resolve.visible",
            "streaming.digest_async"} <= names
    # every span the tracer finished is a range of the profiler
    assert {sp.name for sp in seen} <= names
    assert digests[0] == digests[1]


def test_no_range_is_entered_without_a_profiler(frames, monkeypatch):
    entered = []

    def record_function(name, *a, **k):
        entered.append(name)
        return spans_mod._NO_RANGE

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    _run(frames, read_chunk=DOCS // 2)
    with profiler_range("resolve.cover"):
        pass
    assert entered == []
    assert profiler_range("resolve.cover") is spans_mod._NO_RANGE
    # the patch is live: under a profiler the same calls enter it
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with GLOBAL_TRACER.span("streaming.schedule"):
            with profiler_range("resolve.cover"):
                pass
    assert entered == ["streaming.schedule", "resolve.cover"]


def test_traced_digests_equal_untraced_ones(frames, sessions):
    """The sink and the profiler's ranges leave the digests as they are."""
    s = StreamingMerge(num_docs=DOCS, actors=ACTORS, device="cpu", read_chunk=DOCS // 2,
                       **CAPS)
    for items in frames:
        s.ingest_frames(items)
        s.drain()
    plain = (s.digest_async().wait(), s.digest())
    assert plain == sessions["blocks"][2]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert _run(frames, read_chunk=DOCS // 2)[2] == plain


def test_markers_run_inside_the_captured_chained_digest(frames):
    """The one-block drain's chained digest runs under a graph cache: the
    markers it reaches are in the captured set the rules scan."""
    with CaptureAudit() as audit:
        s = StreamingMerge(num_docs=DOCS, actors=ACTORS, device="cpu", round_insert_capacity=8,
                           round_delete_capacity=8, round_mark_capacity=8,
                           round_map_capacity=8, **CAPS)
        s.prefetch_digest = True
        s.FUSE_MAX_ROUNDS = 2
        for items in frames:
            s.ingest_frames(items)
            s.drain()
        if s._stager is not None:
            s._stager.close()
    seen, outside = audit.reports[("flat", "_fused_rounds_digest")]
    assert ("peritext_tpu_torch.obs.spans", "profiler_range") in seen
    assert outside == []
