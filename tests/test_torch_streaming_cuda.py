"""``StreamingMerge`` on the card against the same session on the CPU: the
streaming slice's arms (default, ``fused_pipeline`` off, static rounds,
block-chunked, digest prefetch) at a small size give equal reads, patches,
roots, cursors and digests, and launch the insert kernel once per touched
block of every committed round.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_streaming_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.insert import insert_batch
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


def _run(device, workloads, arm):
    kw = dict(ARMS[arm])
    fused = kw.pop("fused_pipeline", True)
    prefetch = kw.pop("prefetch_digest", False)
    s = StreamingMerge(num_docs=len(workloads), actors=ACTORS, slot_capacity=192,
                       mark_capacity=64, tomb_capacity=192, round_insert_capacity=32,
                       round_delete_capacity=16, round_mark_capacity=16,
                       round_map_capacity=8, device=device, **kw)
    s.fused_pipeline = fused
    s.prefetch_digest = prefetch
    s.FUSE_MAX_ROUNDS = 3
    for batch_round in range(4):
        for d, batches in enumerate(build_arrival(workloads, 4, 0)):
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
