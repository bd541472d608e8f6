"""The chaos harness on the card.

* ``run_chaos`` (seed 0, its defaults) and the mid-drain kill
  (``run_fused_drain_kill``) with every session on ``cuda`` pass their
  oracles and report exactly what the same episodes report on the CPU,
  where the tier-1 tests hold them to the reference's.  Every insert launch
  of the episodes is one block apply.
* The supervisor's last rung on the card: when the rollback's re-drain
  fails too, a ``GuardedSession`` over a ``cuda`` session raises
  ``DeviceRoundError`` and demotes no doc (a CPU session degrades instead,
  ``tests/test_torch_chaos.py``).

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chaos_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.core.errors import DeviceRoundError
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.parallel.supervisor import GuardedSession
from peritext_tpu_torch.testing.chaos import run_chaos, run_fused_drain_kill
from peritext_tpu_torch.testing.fuzz import generate_workload

pytestmark = pytest.mark.cuda

KW = dict(num_docs=3, actors=("doc1", "doc2", "doc3"), slot_capacity=256, mark_capacity=64,
          tomb_capacity=128, round_insert_capacity=128, round_delete_capacity=64,
          round_mark_capacity=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernels have no CPU mode")
    return torch.device("cuda")


def _launches(fn):
    insert_batch.launches = 0
    applies = GLOBAL_COUNTERS.get("streaming.block_applies")
    out = fn()
    torch.cuda.synchronize()
    return out, insert_batch.launches, GLOBAL_COUNTERS.get("streaming.block_applies") - applies


def test_run_chaos_on_the_card_equals_the_cpu(cuda):
    card, launches, applies = _launches(lambda: run_chaos(0, device=cuda))
    assert launches > 0 and launches == applies
    assert card.to_json() == run_chaos(0, device="cpu").to_json()


def test_mid_drain_kill_on_the_card_equals_the_cpu(cuda):
    card, launches, applies = _launches(lambda: run_fused_drain_kill(0, device=cuda))
    assert launches > 0 and launches == applies
    assert card["rollbacks"] == 1 and card["batches_before_kill"] >= 1
    assert card == run_fused_drain_kill(0, device="cpu")


def test_last_rung_raises_on_the_card(cuda, tmp_path, monkeypatch):
    g = GuardedSession(lambda: StreamingMerge(**KW, device=cuda), tmp_path)
    for d, w in enumerate(generate_workload(5, num_docs=3, ops_per_doc=20)):
        g.ingest_frame(d, encode_frame([ch for log in w.values() for ch in log]))

    def sick(self):
        raise RuntimeError("device still failing")

    monkeypatch.setattr(GuardedSession, "_drain_device", sick)
    g.inject_failure(RuntimeError("chaos: injected device error"))
    with pytest.raises(DeviceRoundError, match="device still failing"):
        g.step()
    assert g.rollbacks == 1 and g.scalar_degradations == 0
    assert g.session.device.type == "cuda"
    assert not any(s.fallback for s in g.session.docs)
