"""The editor bridge's device backend, checkpoints and the guarded merge on
the card: a ``"tpu"`` editor pair converges on ``cuda`` with one insert
launch per block apply; a checkpoint saved from a session on the card
restores on the CPU and on the card with equal digests and reads, in every
layout; ``DocBatch(guard=True)`` without a fault launches the insert kernel
and equals the unguarded merge, and an injected fault raises on the card,
guarded or not.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bridge_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.api import batch as batch_mod
from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.bridge import create_editor, editor_doc_from_crdt, initialize_docs
from peritext_tpu_torch.bridge.commands import add_comment, set_link, toggle_bold, type_text
from peritext_tpu_torch.checkpoint import restore_session, save_session
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.pubsub import Publisher
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.fuzz import generate_workload, sample_cursors

pytestmark = pytest.mark.cuda

ACTORS = ("alice", "bob")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernel has no CPU mode")
    return torch.device("cuda")


def test_tpu_editor_pair_converges_on_the_card(cuda):
    pub = Publisher()
    alice = create_editor("alice", pub, backend="tpu", actors=ACTORS)
    bob = create_editor("bob", pub, backend="tpu", actors=ACTORS)
    assert alice.session.device.type == "cuda"
    applies = GLOBAL_COUNTERS.get("streaming.block_applies")
    insert_batch.launches = 0
    initialize_docs([alice, bob], "The Peritext editor")
    type_text(alice, 1, "Hey ")
    toggle_bold(bob, 2, 10)
    set_link(bob, 5, 13, "https://x.test")
    add_comment(alice, 3, 8, "c1")
    alice.sync()
    bob.sync()
    launches = insert_batch.launches
    assert launches > 0
    assert launches == GLOBAL_COUNTERS.get("streaming.block_applies") - applies
    assert alice.view == bob.view
    for ed in (alice, bob):
        assert ed.view == editor_doc_from_crdt(ed.doc)
        assert not ed.session.docs[0].fallback


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_card_checkpoint_restores_on_cpu_and_card(cuda, layout, tmp_path):
    workloads = generate_workload(seed=61, num_docs=6, ops_per_doc=60)
    kw = dict(num_docs=len(workloads), actors=("doc1", "doc2", "doc3"), slot_capacity=512,
              mark_capacity=128, round_insert_capacity=128, round_delete_capacity=64,
              round_mark_capacity=64, layout=layout)
    sess = StreamingMerge(device=cuda, **kw)
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        if d % 2:
            sess.ingest(d, changes)
        else:
            sess.ingest_frame(d, encode_frame(changes))
    sess.drain()
    save_session(sess, tmp_path / "ckpt")
    counter = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
               "ragged": "streaming.ragged_applies"}[layout]
    kernel = ragged_insert if layout == "ragged" else insert_batch
    for device in ("cpu", "cuda"):
        before = GLOBAL_COUNTERS.get(counter)
        kernel.launches = 0
        restored = restore_session(tmp_path / "ckpt", device=device)
        assert restored.device.type == device
        if device == "cuda":
            assert kernel.launches == GLOBAL_COUNTERS.get(counter) - before > 0
        assert restored.digest() == sess.digest()
        assert restored.digest(full=False) == sess.digest(full=False)
        assert restored.read_all() == sess.read_all()
        assert restored.frontier() == sess.frontier()
        assert restored.pending_count() == sess.pending_count()


def test_guarded_merge_launches_and_raises_a_card_fault(cuda, monkeypatch):
    workloads = generate_workload(seed=7, num_docs=16, ops_per_doc=64)
    cursors = sample_cursors(workloads, 3, seed=7)
    clean = DocBatch(device=cuda).merge(workloads, cursors)
    insert_batch.launches = 0
    guarded = DocBatch(device=cuda, guard=True).merge(workloads, cursors)
    assert insert_batch.launches == 1
    assert "guarded_fallback" not in guarded.stats.extras
    for field in ("spans", "roots", "cursor_positions", "fallback_docs"):
        assert getattr(guarded, field) == getattr(clean, field)

    def fault(*args, **kwargs):
        raise RuntimeError("injected device-stage failure")

    monkeypatch.setattr(batch_mod, "apply_batch", fault)
    before = GLOBAL_COUNTERS.get("merge.guarded_fallbacks")
    for guard in (True, False):
        with pytest.raises(RuntimeError, match="injected"):
            DocBatch(device=cuda, guard=guard).merge(workloads, cursors)
    assert GLOBAL_COUNTERS.get("merge.guarded_fallbacks") == before
