"""The engine capture and its replay on the card: a capture session of 64
fuzz docs on ``cuda`` records its rounds, and their replay
(testing/engine.py) gives the session's digest with one insert-kernel
launch per captured round, counted from 0; the session equals its CPU
twin.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_capture_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.testing.engine import replay_digest, replay_rounds
from peritext_tpu_torch.testing.fuzz import generate_workload

pytestmark = pytest.mark.cuda

DOCS, OPS, ROUNDS = 64, 96, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernel has no CPU mode")
    return torch.device("cuda")


def _session(device, frames, capture):
    s = StreamingMerge(num_docs=DOCS, actors=("doc1", "doc2", "doc3"), slot_capacity=256,
                       mark_capacity=96, tomb_capacity=256, round_insert_capacity=64,
                       round_delete_capacity=32, round_mark_capacity=32, device=device)
    s._capture_rounds = capture
    for r in range(ROUNDS):
        s.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
        s.drain()
    return s


def test_capture_replays_to_session_digest(cuda):
    frames = build_arrival(generate_workload(5, DOCS, OPS), ROUNDS, 5, as_frames=True)[0]
    captured = []
    insert_batch.launches = 0
    s = _session(cuda, frames, captured)
    torch.cuda.synchronize()
    assert insert_batch.launches == len(captured) == s.rounds > 0
    assert not any(d.fallback for d in s.docs) and s.overflow_count() == 0
    assert all(t.device.type == "cuda" for (counts, *_), _, _ in captured for t in counts)
    digest = s.digest()
    assert digest == _session("cpu", frames, None).digest()
    tables = s._digest_tables(0, s._padded_docs)
    for _ in range(2):
        insert_batch.launches = 0
        per_doc = replay_rounds(captured, s._padded_docs, s.config, cuda, tables)
        assert replay_digest(per_doc) == digest
        assert insert_batch.launches == len(captured)
