"""The fused round pipeline's mesh forms (parallel/streaming.py
``mesh_stacked``, store/session.py ``mesh_paged`` and ``mesh_ragged``),
over virtual CPU shards, against the reference package's mesh sessions on
the virtual CPU devices conftest.py forces and against the port's
meshless twin; and which sessions drain pipelined.

Every session is fed the same wire frames (each doc's log, shuffled by a
seeded rng, in two frames with a drain after each), with
``FUSE_MAX_ROUNDS = 2`` and, in the port's sessions, the digest prefetch
armed (the reference's mesh digest twin does not trace under the
installed JAX: its resolve loop's carry meets shard_map's varying-axis
check, so its sessions prefetch nothing).

* for 1, 2 and 4 shards in every layout: reads, digests, rounds, the
  batches' statics and ``streaming.fused_dispatches`` equal the reference
  mesh session's, the device profiler's mesh, ragged, page-pool and
  occupancy sections too, the padded drains chain their digests,
  the reads equal the meshless twin's, and each layout's launch counter
  equals the insert-kernel calls it counts (on the CPU the plain versions
  run where a card launches the kernels);
* the padded mesh drain chains each shard's resolve and digest into its
  final batch (every shard's block cached at the drain's round), equal to
  a drain that prefetches separately and to the reference;
* each shard has its own copy lane and graph cache, the caches of the
  shards of one device capture into one pool, and one idle offer reaches
  every shard's cache;
* ``_pipelined()`` holds for every one-block session and every mesh
  session, and ``drain()`` takes the per-round ``_drain_serial`` exactly
  for block-chunked sessions, an armed engine capture and
  ``fused_pipeline=False``.
"""

import functools
import json
import random

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from peritext_tpu.obs import GLOBAL_COUNTERS as JAX_COUNTERS
from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
from peritext_tpu.parallel.codec import encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF
from peritext_tpu_torch.ops import kernel as kernel_mod
from peritext_tpu_torch.ops import ragged as ragged_mod
from peritext_tpu_torch.ops.insert import SMEM_BUDGET
from peritext_tpu_torch.ops.ragged_insert import ragged_teams
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge

ACTORS = ("doc1", "doc2", "doc3")
DOCS, OPS, SEED = 10, 36, 29
CAPS = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=64, round_insert_capacity=8,
            round_delete_capacity=8, round_mark_capacity=8, round_map_capacity=8)
LAYOUTS = ("padded", "paged", "ragged")
SHARDS = (1, 2, 4)
SECTIONS = ("mesh", "ragged", "page_pool", "occupancy", "occupancy_totals")
COUNTERS = ("streaming.rounds", "streaming.fused_dispatches", "streaming.digest_chained")
APPLY_COUNTER = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
                 "ragged": "streaming.ragged_applies"}


@functools.lru_cache(maxsize=None)
def frames():
    """Per arrival round, ``(doc, frame)`` pairs of the reference's codec."""
    rng = random.Random(SEED)
    plans = []
    for w in generate_workload(SEED, num_docs=DOCS, ops_per_doc=OPS):
        ch = [c for a in sorted(w) for c in w[a]]
        rng.shuffle(ch)
        size = -(-len(ch) // 2)
        plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
    return [[(d, encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
             for d, p in enumerate(plans) if r < len(p)] for r in range(2)]


def _session(cls, layout, mesh=None, fused=True, prefetch=True, **kw):
    kw = dict(CAPS, **kw)
    if cls is StreamingMerge:
        kw["device"] = "cpu"
    if layout != "padded":
        kw["page_size"] = 32
    s = cls(num_docs=DOCS, actors=ACTORS, layout=layout, mesh=mesh, **kw)
    s.fused_pipeline = fused
    s.prefetch_digest = prefetch
    s.FUSE_MAX_ROUNDS = 2
    return s


def _feed(s, record=None):
    if record is not None:
        prep = s._prep_fused_batch
        s._prep_fused_batch = lambda batch: record.append(prep(batch)) or record[-1]
    for items in frames():
        s.ingest_frames(items)
        s.drain()
    return s


def _profiled(prof, counters, build):
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


def _reads(s, text=True):
    """The reads two sessions must agree on (the reference's text digest
    compiles programs of its own: the port's is held to the twin's, and
    the twin's to the reference's in tests/test_torch_digest.py)."""
    return dict(rounds=s.rounds, digest=s.digest(), text=s.digest(full=False) if text else None,
                spans=s.read_all(), patches=s.read_patches_all(),
                fallback=[d.fallback for d in s.docs])


def _canon(x):
    """Statics as plain lists and ints (host arrays and tuples alike)."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (tuple, list)):
        return [_canon(v) for v in x]
    if isinstance(x, np.integer):
        return int(x)
    return x


@pytest.fixture(scope="module")
def reference():
    """The reference's mesh session of a (layout, shard count): its reads,
    statics, profiler sections and counter deltas, built once."""
    cache = {}

    def get(layout, n):
        if (layout, n) not in cache:
            record = []
            mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("docs",))
            s, sections, delta = _profiled(JAX_DEVPROF, JAX_COUNTERS, lambda: _feed(
                _session(JaxStreamingMerge, layout, mesh, prefetch=False), record))
            cache[(layout, n)] = (_reads(s, text=False), _canon(record), sections, delta)
            if getattr(s, "_stager", None) is not None:
                s._stager.close()
        return cache[(layout, n)]
    return get


@functools.lru_cache(maxsize=None)
def twin(layout):
    return _reads(_feed(_session(StreamingMerge, layout)))


class LaunchCount:
    """Counts, on the CPU, the kernel launches a card would make: one per
    insert_batch call, one per non-empty doc class of each ragged_insert
    call."""

    def __init__(self, monkeypatch):
        self.insert = self.ragged = 0
        insert, ragged = kernel_mod.insert_batch, ragged_mod.ragged_insert

        def insert_rec(*args, **kw):
            self.insert += 1
            return insert(*args, **kw)

        def ragged_rec(pool_elem, *args, page_count_host=None, **kw):
            self.ragged += len(ragged_teams(page_count_host, pool_elem.shape[1],
                                            args[5].shape[1], SMEM_BUDGET, 1))
            return ragged(pool_elem, *args, page_count_host=page_count_host, **kw)

        monkeypatch.setattr(kernel_mod, "insert_batch", insert_rec)
        monkeypatch.setattr(ragged_mod, "ragged_insert", ragged_rec)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_fused_equals_reference_and_twin(reference, monkeypatch, layout, n):
    ref_reads, ref_record, ref_sections, ref_delta = reference(layout, n)
    launches = LaunchCount(monkeypatch)
    applies = GLOBAL_COUNTERS.get(APPLY_COUNTER[layout])
    record = []
    s, sections, delta = _profiled(GLOBAL_DEVPROF, GLOBAL_COUNTERS, lambda: _feed(
        _session(StreamingMerge, layout, make_mesh(n, device="cpu")), record))
    applies = int(GLOBAL_COUNTERS.get(APPLY_COUNTER[layout]) - applies)
    assert getattr(launches, "ragged" if layout == "ragged" else "insert") == applies > 0
    assert s._pipelined()
    assert {st[0] for st in record} == {f"mesh_{'stacked' if layout == 'padded' else layout}"}
    assert any(len(st[1]) == 2 if layout != "ragged" else st[1] == 2 for st in record)
    reads = _reads(s)
    assert reads == twin(layout)
    assert dict(reads, text=None) == ref_reads
    assert _canon(record) == ref_record
    chained = delta.pop("streaming.digest_chained")
    assert chained == (len(frames()) if layout == "padded" else 0)
    assert delta == {c: v for c, v in ref_delta.items() if c != "streaming.digest_chained"}
    assert delta["streaming.fused_dispatches"] == len(record)
    assert json.dumps(sections, sort_keys=True) == json.dumps(ref_sections, sort_keys=True)


def test_padded_mesh_drain_chains_each_shards_digest(reference):
    mesh = make_mesh(4, device="cpu")
    chained = _feed(_session(StreamingMerge, "padded", mesh))
    stamp, cache = chained._resolved_cache
    assert stamp == chained.rounds and sorted(cache) == [0, 1, 2, 3]
    entries = dict(cache)
    digest = chained.digest()
    assert all(chained._resolved_cache[1][k] is e for k, e in entries.items())
    separate = _feed(_session(StreamingMerge, "padded", mesh, prefetch=False))
    separate._prefetch_digest()
    plain = _feed(_session(StreamingMerge, "padded", mesh, prefetch=False))
    assert digest == separate.digest() == plain.digest() == reference("padded", 4)[0]["digest"]
    assert chained.digest(refresh=True) == digest


def test_each_shard_has_its_lane_and_cache_sharing_a_pool_per_device():
    s = _session(StreamingMerge, "ragged", make_mesh(devices=["cpu"] * 3))
    assert len(s._shard_lanes) == len(s._shard_graphs) == 3
    assert len({id(c) for c in s._shard_graphs}) == 3
    assert len({id(c._pool) for c in s._shard_graphs}) == 1
    assert s._graphs is s._shard_graphs[0] and s._copy_lane is s._shard_lanes[0]
    offered = []
    for cache in s._shard_graphs:
        cache.idle = lambda budget, cache=cache: offered.append(cache) or 0
    assert s.idle(0.5) == 0 and offered == s._shard_graphs
    meshless = _session(StreamingMerge, "padded")
    assert meshless._shard_graphs == [meshless._graphs]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_drain_is_serial_only_for_chunked_capture_and_compat(monkeypatch, layout):
    serial = []
    real = StreamingMerge._drain_serial

    def spy(self, max_rounds):
        serial.append(self)
        return real(self, max_rounds)
    monkeypatch.setattr(StreamingMerge, "_drain_serial", spy)
    pipelined = [_session(StreamingMerge, layout)] + [
        _session(StreamingMerge, layout, make_mesh(n, device="cpu")) for n in SHARDS]
    compat = [_session(StreamingMerge, layout, fused=False),
              _session(StreamingMerge, layout, make_mesh(2, device="cpu"), fused=False)]
    chunked = [_session(StreamingMerge, layout, read_chunk=4)]
    capture = _session(StreamingMerge, layout)
    capture._capture_rounds = []
    unpipelined = compat + chunked + [capture]
    for s in pipelined:
        assert s._pipelined(), s.mesh
    for s in unpipelined:
        assert not s._pipelined()
    for s in pipelined + unpipelined:
        _feed(s)
    assert {id(s) for s in serial} == {id(s) for s in unpipelined}
    want = twin(layout)
    for s in pipelined + unpipelined:
        assert _reads(s) == want
