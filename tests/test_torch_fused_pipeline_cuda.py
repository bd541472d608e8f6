"""The fused round pipeline on the card: CUDA-graph replay of the commit
forms (utils/graphs.py), the pinned staging upload (parallel/staging.py),
and the sessions that run them.

* graphed, eager-fused and per-round arms of a padded, a paged and a
  static-round session are byte-equal to each other and to a CPU twin, on
  typing traffic whose batch signatures repeat (captures and hits);
* a signature's first occurrence captures nothing (a session's first drain
  neither); the second captures, later ones replay; once a driver offers
  idle time, a repeated signature waits for a capture that fits in it;
* replays count the insert kernel's launches: launches equal the commit
  counters whatever ran eagerly, was captured or replayed;
* a reshard and a pool growth bump the graph epoch and recapture;
* a capture that meets a host sync raises, and the cache keeps working;
* a pinned upload is one copy on the lane's stream, waited on by events;
* the ragged form and the mesh forms (two virtual shards on the card, in
  every layout): graphed, eager-fused and per-round arms byte-equal to a
  CPU twin, every shard's cache capturing and replaying, the shards'
  caches sharing one pool, launches equal to the counters;
* a ragged session's replays stay equal to its eager twin while the host
  allocates and frees pinned memory between drains (no graph holds a
  host-to-device copy whose pinned source the allocator hands out again);
* a session whose capture fails raises from ``drain()``: nothing retries
  eagerly, no doc leaves the card.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_pipeline_cuda.py -q
"""

import numpy as np
import pytest
import torch

from peritext_tpu_torch.core.doc import Doc
from peritext_tpu_torch.obs import GLOBAL_COUNTERS, RecompileSentinel
from peritext_tpu_torch.ops import ragged as ragged_mod
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.staging import CopyLane
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.utils.graphs import GraphCache

pytestmark = pytest.mark.cuda

DOCS, ROUNDS = 16, 12
COUNTER = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
           "static": "streaming.block_applies", "ragged": "streaming.ragged_applies"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernel has no CPU mode")
    return torch.device("cuda")


def _frames():
    """Typing traffic whose batches repeat their shapes: doc d makes its
    text, then types ``1 + d % 3`` characters at the end each round, one
    frame a round.  Every round has the same per-doc op counts, so the
    fused forms' signatures change only with the slot window (the power-of-
    two bucket of the longest doc) and repeat in between."""
    frames = []
    for d in range(DOCS):
        doc = Doc("doc1")
        ch, _ = doc.change([{"path": [], "action": "makeList", "key": "text"},
                            {"path": ["text"], "action": "insert", "index": 0,
                             "values": list("hello")}])
        out = [encode_frame([ch])]
        n = 5
        for r in range(ROUNDS):
            k = 1 + d % 3
            ch, _ = doc.change([{"path": ["text"], "action": "insert", "index": n,
                                 "values": [chr(97 + (d + r + i) % 26) for i in range(k)]}])
            out.append(encode_frame([ch]))
            n += k
        frames.append(out)
    return frames


def _session(device, layout="padded", fused=True, eager=False, **kw):
    """One-round batches (each drain commits one round)."""
    static = layout == "static"
    pooled = {} if layout in ("padded", "static") else dict(page_size=32)
    s = StreamingMerge(num_docs=DOCS, actors=("doc1", "doc2", "doc3"), slot_capacity=64,
                       mark_capacity=16, tomb_capacity=16, round_insert_capacity=8,
                       round_delete_capacity=8, round_mark_capacity=8, round_map_capacity=8,
                       layout="padded" if static else layout, static_rounds=static,
                       device=device, **pooled, **kw)
    s.fused_pipeline = fused
    s.FUSE_MAX_ROUNDS = 1
    if eager:
        # runs every form's body eagerly, on the card
        s._graphs = GraphCache("cpu")
        s._shard_graphs = [GraphCache("cpu") for _ in s._shard_graphs]
    return s


def _drive(s, frames, rounds=range(ROUNDS + 1)):
    for r in rounds:
        s.ingest_frames((d, b[r]) for d, b in enumerate(frames))
        s.drain()
    return s


def _totals(stats):
    return {k: sum(row[k] for row in stats.values()) for k in ("eager", "captures", "replays",
                                                               "hits")}


@pytest.mark.parametrize("layout", ["padded", "paged", "static"])
def test_graphed_eager_and_per_round_arms_are_byte_equal(cuda, layout):
    frames = _frames()
    arms = {
        "graphed": _session(cuda, layout),
        "eager": _session(cuda, layout, eager=True),
        "per_round": _session(cuda, layout, fused=False),
        "cpu": _session("cpu", layout),
    }
    for s in arms.values():
        _drive(s, frames)
    torch.cuda.synchronize()
    graphed = _totals(arms["graphed"]._graphs.stats())
    assert graphed["captures"] > 0 and graphed["hits"] > 0
    assert _totals(arms["eager"]._graphs.stats())["captures"] == 0
    want = arms["cpu"]
    # a patch stream is what changed since the session's previous read:
    # each arm's first read against the CPU twin's first
    want_patches = want.read_patches_all()
    for name, s in arms.items():
        assert s.rounds == want.rounds, name
        assert s.read_all() == want.read_all(), name
        assert s.digest() == want.digest(), name
        if s is not want:
            assert s.read_patches_all() == want_patches, name
        assert [d.fallback for d in s.docs] == [d.fallback for d in want.docs], name


def test_first_occurrence_captures_nothing(cuda):
    x = torch.zeros(4, dtype=torch.int32, device=cuda)
    cache = GraphCache(cuda)

    def body(step):
        x.add_(step)

    step = torch.ones(4, dtype=torch.int32, device=cuda)
    with RecompileSentinel() as sentinel:
        cache.run(("k",), "f", body, (step,), binds=(x,))
        assert len(cache) == 0 and sentinel.captures == {}
        cache.run(("k",), "f", body, (step,), binds=(x,))
        assert len(cache) == 1 and sentinel.captures == {"graph.f": 1}
        cache.run(("k",), "f", body, (step * 2,), binds=(x,))
    assert cache.stats() == {"f": {"eager": 1, "captures": 1, "replays": 2, "hits": 1}}
    assert x.tolist() == [4] * 4  # eager 1, the capture's replay 1, a replay of 2
    # a session's first drain captures nothing
    s = _drive(_session(cuda), _frames(), range(1))
    assert _totals(s._graphs.stats())["captures"] == 0


def test_idle_captures_stay_off_the_commit(cuda):
    """Once a driver has offered idle time, a repeated signature runs
    eagerly and waits; an idle offer too short for its estimate captures
    nothing, a long one captures it (running nothing), and the next
    occurrence replays."""
    x = torch.zeros(4, dtype=torch.int32, device=cuda)
    cache = GraphCache(cuda)

    def body(step):
        x.add_(step)

    step = torch.ones(4, dtype=torch.int32, device=cuda)
    assert cache.idle(1.0) == 0  # nothing pending yet
    with RecompileSentinel() as sentinel:
        for _ in range(3):
            cache.run(("k",), "f", body, (step,), binds=(x,))
        assert len(cache) == 0 and sentinel.captures == {}
        assert cache.idle(0.0) == 0 and len(cache) == 0
        assert cache.idle(5.0) == 1 and sentinel.captures == {"graph.f": 1}
        cache.run(("k",), "f", body, (step,), binds=(x,))
    torch.cuda.synchronize()
    assert cache.stats() == {"f": {"eager": 3, "captures": 1, "replays": 1, "hits": 1}}
    assert x.tolist() == [4] * 4  # three eager runs and one replay


@pytest.mark.parametrize("layout", ["padded", "paged", "static"])
def test_replays_count_insert_launches(cuda, layout):
    s = _session(cuda, layout)
    before = GLOBAL_COUNTERS.get(COUNTER[layout])
    insert_batch.launches = 0
    _drive(s, _frames())
    torch.cuda.synchronize()
    applies = int(GLOBAL_COUNTERS.get(COUNTER[layout]) - before)
    totals = _totals(s._graphs.stats())
    assert totals["replays"] > 0 and totals["hits"] > 0
    assert insert_batch.launches == applies > 0


def forced_reshard(s):
    """``reshard()`` of a one-block session over two read blocks (over one
    it moves no row), then one block again: the rows move by one
    permutation, so the state is new tensors."""
    chunk = s._read_chunk
    s._read_chunk = s._padded_docs // 2
    try:
        return s.reshard()
    finally:
        s._read_chunk = chunk


def test_reshard_and_pool_growth_recapture(cuda):
    frames = _frames()
    s = _drive(_session(cuda), frames, range(7))
    epoch, captures = s._graphs.epoch, _totals(s._graphs.stats())["captures"]
    assert captures > 0
    assert forced_reshard(s)["moved"] > 0
    _drive(s, frames, range(7, ROUNDS + 1))
    assert s._graphs.epoch == epoch + 1
    assert _totals(s._graphs.stats())["captures"] > captures
    twin = _drive(_session("cpu"), frames)
    assert s.read_all() == twin.read_all() and s.digest() == twin.digest()
    # a pool of 18 pages grows when docs pass one page of 32 slots: a new
    # epoch
    p = _drive(_session(cuda, "paged", pool_pages=18), frames, range(5))
    growths, epoch = p.store.growths, p._graphs.epoch
    captures = []
    for r in range(5, ROUNDS + 1):
        _drive(p, frames, [r])
        captures.append((p.store.growths, _totals(p._graphs.stats())["captures"]))
    assert p.store.growths > growths and p._graphs.epoch > epoch
    # graphs captured after the growth's new epoch
    grown = next(i for i, (g, _) in enumerate(captures) if g > growths)
    assert captures[-1][1] > captures[grown][1]
    assert p.read_all() == twin.read_all() and p.digest() == twin.digest()


def test_capture_meeting_a_host_sync_raises(cuda):
    x = torch.zeros(4, dtype=torch.int32, device=cuda)
    cache = GraphCache(cuda)

    def syncing(step):
        x.add_(step)
        if int(x.sum().item()) < 0:  # a host read: no graph can hold it
            x.zero_()

    step = torch.ones(4, dtype=torch.int32, device=cuda)
    cache.run(("sync",), "f", syncing, (step,), binds=(x,))  # eager: fine
    with pytest.raises(RuntimeError):
        cache.run(("sync",), "f", syncing, (step,), binds=(x,))
    torch.cuda.synchronize()
    assert x.tolist() == [1] * 4  # the failed capture ran nothing

    def clean(step):
        x.add_(step)

    for _ in range(3):
        cache.run(("clean",), "f", clean, (step,), binds=(x,))
    torch.cuda.synchronize()
    assert x.tolist() == [4] * 4 and cache.stats()["f"]["captures"] == 1


def test_pinned_upload_is_one_copy_on_its_stream(cuda):
    lane = CopyLane(cuda)
    flat = np.arange(1 << 16, dtype=np.int32)
    ups = [lane.upload(flat + i) for i in range(3)]
    assert lane.copies == 3
    assert all(host.is_pinned() for _, host in lane._held)
    for i, up in enumerate(ups):
        assert up.event is not None
        got = up.consume()
        assert got.device.type == "cuda" and torch.equal(got.cpu(), torch.from_numpy(flat + i))


def _shard_mesh(cuda, n=2):
    return make_mesh(devices=[torch.device("cuda", cuda.index or 0)] * n)


@pytest.mark.parametrize("layout,shards", [("ragged", None), ("padded", 2), ("paged", 2),
                                           ("ragged", 2)])
def test_ragged_and_mesh_replays_equal_eager_twins(cuda, layout, shards):
    frames = _frames()
    mesh = None if shards is None else _shard_mesh(cuda, shards)
    arms = {
        "graphed": _session(cuda, layout, mesh=mesh),
        "eager": _session(cuda, layout, eager=True, mesh=mesh),
        "per_round": _session(cuda, layout, fused=False, mesh=mesh),
        "cpu": _session("cpu", layout),
    }
    counter = COUNTER[layout]
    launches = {}
    for name, s in arms.items():
        before = GLOBAL_COUNTERS.get(counter)
        insert_batch.launches = ragged_insert.launches = 0
        _drive(s, frames)
        torch.cuda.synchronize()
        kernel = ragged_insert if layout == "ragged" else insert_batch
        launches[name] = (kernel.launches, int(GLOBAL_COUNTERS.get(counter) - before))
    graphed = arms["graphed"]
    caches = graphed._shard_graphs if mesh is not None else [graphed._graphs]
    for cache in caches:
        totals = _totals(cache.stats())
        assert totals["captures"] > 0 and totals["hits"] > 0, cache.stats()
    if mesh is not None:
        assert len({id(c._pool) for c in caches}) == 1 and len(set(map(id, caches))) == shards
    for name in ("graphed", "eager", "per_round"):
        assert launches[name][0] == launches[name][1] > 0, (name, launches)
    want = arms["cpu"]
    want_patches = want.read_patches_all()
    for name, s in arms.items():
        assert s.rounds == want.rounds, name
        assert s.read_all() == want.read_all(), name
        assert s.digest() == want.digest(), name
        if s is not want:
            assert s.read_patches_all() == want_patches, name


def test_ragged_replays_survive_pinned_host_churn(cuda):
    """Between drains the host allocates, fills and frees pinned buffers of
    the sizes a launch plan's uploads have (the caching host allocator
    hands the same blocks out again); the graphed session's replays equal
    the eager twin's state all the same."""
    frames = _frames()
    graphed = _session(cuda, "ragged")
    eager = _session(cuda, "ragged", eager=True)
    rng = np.random.default_rng(0)
    for r in range(ROUNDS + 1):
        for s in (graphed, eager):
            _drive(s, frames, [r])
        for size in (DOCS, DOCS * 2, 64, 256) * 8:
            junk = torch.empty(size, dtype=torch.int64, pin_memory=True)
            junk.copy_(torch.from_numpy(rng.integers(0, 1 << 30, size)))
            junk.to(cuda, non_blocking=True)
            del junk
        torch.cuda.synchronize()
        assert graphed.digest() == eager.digest(), r
    assert _totals(graphed._graphs.stats())["hits"] > 0
    assert graphed.read_all() == eager.read_all()


@pytest.mark.parametrize("layout,shards", [("ragged", None), ("padded", 2)])
def test_failed_session_capture_raises(cuda, monkeypatch, layout, shards):
    """A host read of the delete targets inside the commit form: eagerly it
    passes, and the first capture raises out of drain().  Nothing retries
    eagerly, and no doc leaves the card."""
    from peritext_tpu_torch.ops import kernel as kernel_mod

    s = _session(cuda, layout, mesh=None if shards is None else _shard_mesh(cuda, shards))
    frames = _frames()
    _drive(s, frames, range(1))
    target, name, index = ((ragged_mod, "_ragged_exists", 2) if layout == "ragged"
                           else (kernel_mod, "_post_insert", 1))
    original = getattr(target, name)

    def syncing(*args, **kw):
        if int(args[index].sum().item()) < 0:  # a host read: no graph can hold it
            raise AssertionError("delete targets are never negative")
        return original(*args, **kw)
    monkeypatch.setattr(target, name, syncing)
    with pytest.raises(RuntimeError):
        _drive(s, frames, range(1, ROUNDS + 1))
    torch.cuda.synchronize()
    assert s.device.type == "cuda" and not any(d.fallback for d in s.docs)
    # the failed capture left nothing in capture mode: the card's random
    # generator still draws
    assert torch.randint(0, 10, (4,), device=cuda).shape == (4,)
    caches = s._shard_graphs if shards else [s._graphs]
    assert all(_totals(c.stats())["captures"] == _totals(c.stats())["hits"] == 0
               for c in caches)
