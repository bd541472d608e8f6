"""``StreamingMerge`` on the card against the same session on the CPU: the
streaming slice's arms (default, ``fused_pipeline`` off, static rounds,
block-chunked, digest prefetch) at a small size give equal reads, patches,
roots, cursors and digests, and launch the insert kernel once per touched
block of every committed round; a frame-ingest session on the card equals
its object-ingest twin; the paged and ragged sessions on the card equal
their CPU twins, before and after a reshard, and launch the insert kernel
once per (round, page group) (paged) or the ragged insert kernel once per
doc class of each round (ragged), as their counters say.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_streaming_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.testing.fuzz import generate_workload, sample_cursors

pytestmark = pytest.mark.cuda

ACTORS = ("doc1", "doc2", "doc3")
ARMS = {
    "fused": {},
    "per_round": dict(fused_pipeline=False),
    "static_rounds": dict(static_rounds=True),
    "block_chunked": dict(read_chunk=8),
    "prefetch_digest": dict(prefetch_digest=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernel has no CPU mode")
    return torch.device("cuda")


def _run(device, workloads, arm, frames=False, layout="padded"):
    kw = dict(ARMS[arm], layout=layout)
    fused = kw.pop("fused_pipeline", True)
    prefetch = kw.pop("prefetch_digest", False)
    s = StreamingMerge(num_docs=len(workloads), actors=ACTORS, slot_capacity=192,
                       mark_capacity=64, tomb_capacity=192, round_insert_capacity=32,
                       round_delete_capacity=16, round_mark_capacity=16,
                       round_map_capacity=8, device=device, **kw)
    s.fused_pipeline = fused
    s.prefetch_digest = prefetch
    s.FUSE_MAX_ROUNDS = 3
    arrival = build_arrival(workloads, 4, 0, as_frames=True)[0] if frames else \
        build_arrival(workloads, 4, 0)
    for batch_round in range(4):
        if frames:  # one bulk call per round
            s.ingest_frames((d, batches[batch_round]) for d, batches in enumerate(arrival)
                            if batch_round < len(batches))
        else:
            for d, batches in enumerate(arrival):
                if batch_round < len(batches):
                    s.ingest(d, batches[batch_round])
        s.drain()
    return s


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_card_session_equals_cpu_session(cuda, arm):
    workloads = generate_workload(seed=3, num_docs=20, ops_per_doc=80)
    cpu = _run(torch.device("cpu"), workloads, arm)
    insert_batch.launches = 0
    applies = GLOBAL_COUNTERS.get("streaming.block_applies")
    card = _run(cuda, workloads, arm)
    launched = insert_batch.launches
    assert card.rounds == cpu.rounds > 4
    blocks = -(-card._padded_docs // card._read_chunk)
    assert launched == GLOBAL_COUNTERS.get("streaming.block_applies") - applies
    assert card.rounds <= launched <= card.rounds * blocks
    assert card.read_all() == cpu.read_all()
    assert card.read_patches_all() == cpu.read_patches_all()
    for d in range(len(workloads)):
        assert card.read_root(d) == cpu.read_root(d)
    cursors = dict(enumerate(sample_cursors(workloads, 3, 1)))
    assert card.resolve_cursors_batch(cursors) == cpu.resolve_cursors_batch(cursors)
    assert card.digest() == cpu.digest() == card.digest(refresh=True)
    assert card.digest(full=False) == cpu.digest(full=False)
    assert [card.doc_digest(d) for d in range(20)] == [cpu.doc_digest(d) for d in range(20)]
    assert [s.fallback for s in card.docs] == [s.fallback for s in cpu.docs]
    assert card.overflow_count() == cpu.overflow_count()


@pytest.mark.parametrize("arm", ["fused", "block_chunked"])
def test_card_frame_session_equals_object_twin(cuda, arm):
    from peritext_tpu_torch import native

    workloads = generate_workload(seed=3, num_docs=20, ops_per_doc=80)
    objects = _run(cuda, workloads, arm)
    calls = dict(native.calls)
    insert_batch.launches = 0
    applies = GLOBAL_COUNTERS.get("streaming.block_applies")
    frames = _run(cuda, workloads, arm, frames=True)
    assert insert_batch.launches == GLOBAL_COUNTERS.get("streaming.block_applies") - applies > 0
    assert native.calls["parse_frames"] > calls.get("parse_frames", 0)
    assert all(s.frame_mode for s in frames.docs) and frames.pending_count() == 0
    assert frames.read_all() == objects.read_all()
    assert frames.read_patches_all() == objects.read_patches_all()
    for d in range(len(workloads)):
        assert frames.read_root(d) == objects.read_root(d)
    cursors = dict(enumerate(sample_cursors(workloads, 3, 1)))
    assert frames.resolve_cursors_batch(cursors) == objects.resolve_cursors_batch(cursors)
    assert frames.digest() == objects.digest() == frames.digest(refresh=True)
    assert frames.digest(full=False) == objects.digest(full=False)
    assert [frames.doc_digest(d) for d in range(20)] == [objects.doc_digest(d) for d in range(20)]
    assert [s.fallback for s in frames.docs] == [s.fallback for s in objects.docs]
    assert frames.frontier() == objects.frontier()


@pytest.mark.parametrize("layout", ["paged", "ragged"])
@pytest.mark.parametrize("frames", [False, True], ids=["objects", "frames"])
def test_card_pooled_session_equals_cpu_twin(cuda, layout, frames):
    workloads = generate_workload(seed=3, num_docs=20, ops_per_doc=80)
    cpu = _run(torch.device("cpu"), workloads, "block_chunked", frames, layout)
    insert_batch.launches = 0
    ragged_insert.launches = 0
    counts = {c: GLOBAL_COUNTERS.get(c) for c in ("streaming.group_applies",
                                                  "streaming.ragged_applies")}
    card = _run(cuda, workloads, "block_chunked", frames, layout)
    groups = GLOBAL_COUNTERS.get("streaming.group_applies") - counts["streaming.group_applies"]
    classes = GLOBAL_COUNTERS.get("streaming.ragged_applies") - counts["streaming.ragged_applies"]
    if layout == "paged":
        assert insert_batch.launches == groups >= card.rounds and ragged_insert.launches == 0
    else:
        assert ragged_insert.launches == classes >= card.rounds and insert_batch.launches == 0
    assert card.rounds == cpu.rounds > 4
    assert card.health() == cpu.health()
    for stage in ("before", "after"):
        assert card.read_all() == cpu.read_all(), stage
        assert card.read_patches_all() == cpu.read_patches_all(), stage
        for d in range(len(workloads)):
            assert card.read_root(d) == cpu.read_root(d), (stage, d)
        assert card.digest() == cpu.digest() == card.digest(refresh=True)
        assert card.digest(full=False) == cpu.digest(full=False)
        assert card.digest_async().wait() == cpu.digest()
        assert [s.fallback for s in card.docs] == [s.fallback for s in cpu.docs]
        if stage == "before":
            out = card.reshard()
            assert out == cpu.reshard() and out["moved"] > 0


def test_one_ragged_build_serves_every_doc_mix(cuda, monkeypatch):
    """A ragged session whose rounds mix short docs (warp class) with a
    long one (block class) loads csrc/ragged_insert.cu through one build:
    shapes and classes are launch arguments, never build inputs."""
    from peritext_tpu_torch.core.doc import Doc
    from peritext_tpu_torch.ops.insert import WARP_TEAM_MAX_SLOTS
    from peritext_tpu_torch.utils import nvcc

    builds = []
    real = nvcc.build_libraries
    monkeypatch.setattr(nvcc, "build_libraries", lambda names: builds.append(tuple(names))
                        or real(names))
    monkeypatch.setattr(nvcc, "_loaded", {})
    doc = Doc("doc1")
    long_doc = [doc.change([{"path": [], "action": "makeList", "key": "text"}])[0]]
    for i in range(0, 1200, 100):
        long_doc.append(doc.change([{"path": ["text"], "action": "insert", "index": i,
                                     "values": ["x"] * 100}])[0])
    workloads = generate_workload(seed=6, num_docs=5, ops_per_doc=20) + [{"doc1": long_doc}]
    frames, _ = build_arrival(workloads, 2, 1, as_frames=True)
    kw = dict(num_docs=6, actors=ACTORS, slot_capacity=2048, mark_capacity=512,
              tomb_capacity=512, round_insert_capacity=512, round_delete_capacity=256,
              round_mark_capacity=256)
    ragged_insert.launches = 0
    card = StreamingMerge(**kw, layout="ragged", device=cuda)
    cpu = StreamingMerge(**kw, device="cpu")
    for s in (card, cpu):
        for r in range(2):
            s.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
            s.drain()
    assert card.store.num_pages(card._row_of[5]) * 64 > WARP_TEAM_MAX_SLOTS
    assert ragged_insert.launches > card.rounds  # a round ran both classes
    assert builds == [("ragged_insert",)]
    assert card.read_all() == cpu.read_all() and card.digest() == cpu.digest()
