"""The fused round pipeline's ragged form (store/session.py
``RaggedStreamingMerge``'s prep, stage and dispatch) against the reference
package's ragged session on JAX's CPU and the port's per-round twin
(``fused_pipeline=False``).

Every session is fed the same wire frames: each doc's log, shuffled by a
seeded rng, cut into frames with a drain after each.  Low round caps and
``FUSE_MAX_ROUNDS = 2`` force several multi-round batches per drain.  The
reference's sessions are built once per module, under its device profiler.

* over two seeds and a mixed case (docs of very different sizes, a pool
  of one page a doc that grows, a doc that overflows its slots): digest,
  spans, patch streams, overflow and fallback sets and rounds equal the
  reference's and the twin's; ``streaming.fused_dispatches`` and
  ``streaming.ragged_applies`` equal the twin's, and the batches' statics
  the reference's;
* the device profiler's occupancy, page-pool and ragged sections equal the
  reference's byte for byte (the ragged walk of each batch's final plan);
* a fused-eligible ragged session drains pipelined, one upload and one
  site call a batch, with the plan's planes as the call's inputs; a
  block-chunked one, an armed engine capture and ``fused_pipeline=False``
  drain round by round.
"""

import json
import random

import pytest

from peritext_tpu.obs import GLOBAL_COUNTERS as JAX_COUNTERS
from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
from peritext_tpu.parallel.codec import encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF
from peritext_tpu_torch.parallel.streaming import StreamingMerge

ACTORS = ("doc1", "doc2", "doc3")
#: the sections a profiled session feeds at each commit
SECTIONS = ("occupancy", "occupancy_totals", "page_pool", "ragged")
COUNTERS = ("streaming.rounds", "streaming.fused_dispatches", "streaming.ragged_applies")
#: (name, seed, workload sizes by doc, session keywords)
CASES = {
    "seed11": (11, (40,) * 6, {}),
    "seed47": (47, (40,) * 6, {}),
    # docs of 8 to 160 ops over 16-slot pages: the pool starts at one page
    # a doc and grows, and the 160-op doc (65 inserts) outgrows its 64 slots
    "mixed": (5, (8, 12, 160, 30, 8, 60, 90, 20),
              dict(page_size=16, pool_pages=9, round_insert_capacity=32,
                   round_delete_capacity=32, round_mark_capacity=32, round_map_capacity=32)),
}


def _session(cls, num_docs, fused=True, **kw):
    kw = dict(dict(slot_capacity=64, page_size=32, mark_capacity=48, tomb_capacity=48,
                   round_insert_capacity=8, round_delete_capacity=8, round_mark_capacity=8,
                   round_map_capacity=8), **kw)
    if cls is StreamingMerge:
        kw["device"] = "cpu"
    s = cls(num_docs=num_docs, actors=ACTORS, layout="ragged", **kw)
    s.fused_pipeline = fused
    s.FUSE_MAX_ROUNDS = 2
    return s


def _workloads(seed, sizes):
    out = []
    for i, n in enumerate(sizes):
        out += generate_workload(seed=seed + 101 * i, num_docs=1, ops_per_doc=n)
    return out


def _frames(workloads, seed, chunks=3):
    """Per round, ``(doc, frame)`` pairs: each doc's log shuffled by the
    seeded rng, cut into ``chunks`` frames."""
    rng = random.Random(seed)
    plans = []
    for w in workloads:
        ch = [c for a in sorted(w) for c in w[a]]
        rng.shuffle(ch)
        size = -(-len(ch) // chunks)
        plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
    return [[(d, encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
             for d, p in enumerate(plans) if r < len(p)] for r in range(chunks)]


def _feed(s, frames, record=None):
    if record is not None:
        prep = s._prep_fused_batch
        s._prep_fused_batch = lambda batch: record.append(prep(batch)) or record[-1]
    for items in frames:
        s.ingest_frames(items)
        s.drain()
    return s


def _profiled(prof, counters, build):
    """Run ``build()`` under a freshly armed profiler: ``(session, its
    sections, counter deltas)``."""
    prof.reset()
    prof.enable()
    before = {c: counters.get(c) for c in COUNTERS}
    try:
        s = build()
        snap = prof.snapshot()
    finally:
        prof.disable()
        prof.reset()
    return s, {k: snap[k] for k in SECTIONS}, {c: counters.get(c) - v for c, v in before.items()}


def _reads(s):
    """Every read two sessions must agree on (the patch read consumes the
    stream: one call per session)."""
    return dict(rounds=s.rounds, digest=s.digest(), text=s.digest(full=False),
                spans=s.read_all(), patches=s.read_patches_all(),
                overflow=s.overflow_count(), fallback=[d.fallback for d in s.docs])


@pytest.fixture(scope="module")
def reference():
    """The reference's ragged session of each case: its reads, statics,
    profiler sections and counter deltas, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            seed, sizes, kw = CASES[name]
            workloads = _workloads(seed, sizes)
            record = []
            s, sections, delta = _profiled(JAX_DEVPROF, JAX_COUNTERS, lambda: _feed(
                _session(JaxStreamingMerge, len(workloads), **kw),
                _frames(workloads, seed), record))
            cache[name] = (_reads(s), record, sections, delta, workloads)
            if getattr(s, "_stager", None) is not None:
                s._stager.close()
        return cache[name]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_ragged_equals_reference_and_per_round_twin(reference, case):
    seed, sizes, kw = CASES[case]
    ref_reads, ref_record, ref_sections, ref_delta, workloads = reference(case)
    frames = _frames(workloads, seed)
    record = []
    fused, sections, delta = _profiled(GLOBAL_DEVPROF, GLOBAL_COUNTERS, lambda: _feed(
        _session(StreamingMerge, len(workloads), **kw), frames, record))
    twin, _, twin_delta = _profiled(GLOBAL_DEVPROF, GLOBAL_COUNTERS, lambda: _feed(
        _session(StreamingMerge, len(workloads), fused=False, **kw), frames))
    assert fused._pipelined() and not twin._pipelined()
    assert any(st[1] == 2 for st in record)  # multi-round batches ran
    reads = _reads(fused)
    assert reads == ref_reads
    assert _reads(twin) == reads
    assert record == ref_record
    assert delta == twin_delta
    assert delta["streaming.rounds"] == ref_delta["streaming.rounds"] == fused.rounds
    assert delta["streaming.fused_dispatches"] == ref_delta["streaming.fused_dispatches"] == 0
    assert delta["streaming.ragged_applies"] >= fused.rounds
    assert json.dumps(sections, sort_keys=True) == json.dumps(ref_sections, sort_keys=True)
    if case == "mixed":
        assert fused.store.growths > 0 and reads["overflow"] > 0
    fused._ensure_stager().close()


def test_fused_ragged_batch_is_one_upload_and_one_site_call():
    """One staged buffer a batch through the copy lane and one graph-cache
    call (on the CPU: eager), whose inputs are the buffer, the plan's six
    planes (no launch plan on the CPU); the rounds' applies all run inside
    it."""
    seed, sizes, kw = CASES["seed11"]
    workloads = _workloads(seed, sizes)
    s = _session(StreamingMerge, len(workloads), **kw)
    calls, run = [], s._graphs.run

    def spy(key, form, body, inputs, binds=()):
        calls.append((key[:2], form, len(inputs), len(binds)))
        return run(key, form, body, inputs, binds)
    s._graphs.run = spy
    record = []
    _feed(s, _frames(workloads, seed), record)
    assert [c[0] for c in calls] == [("ragged", st[1]) for st in record]
    assert {c[1:] for c in calls} == {("apply_batch_ragged", 7, 2 + len(s.store.aux))}
    assert s._copy_lane.copies == 0 and s._graphs.stats()["apply_batch_ragged"]["eager"] == \
        len(record)  # on the CPU the staged buffer is the host array itself


def test_ragged_drains_serially_only_where_the_reference_does():
    seed, sizes, kw = CASES["seed11"]
    workloads = _workloads(seed, sizes)
    frames = _frames(workloads, seed)
    plain = _session(StreamingMerge, len(workloads), **kw)
    chunked = _session(StreamingMerge, len(workloads), read_chunk=4, **kw)
    compat = _session(StreamingMerge, len(workloads), fused=False, **kw)
    capture = _session(StreamingMerge, len(workloads), **kw)
    capture._capture_rounds = []  # the page-pool layouts record nothing
    assert plain._pipelined()
    for s in (chunked, compat, capture):
        assert not s._pipelined()
    preps = {}
    for name, s in (("plain", plain), ("chunked", chunked), ("compat", compat),
                    ("capture", capture)):
        record = []
        _feed(s, frames, record)
        preps[name] = len(record)
    assert preps["plain"] > 0
    assert preps["chunked"] == preps["compat"] == preps["capture"] == 0
    assert capture._capture_rounds == []
    for s in (chunked, compat, capture):
        assert (s.digest(), s.read_all()) == (plain.digest(), plain.read_all())
