"""The serving tier and the supervisor on the card: a ``SessionMux`` over a
session on ``cuda`` equals the same mux over a session on the CPU (verdicts,
patch streams, reads, snapshot, digests), with one insert launch per block
apply; sustained quota sheds never demote a doc on the card, where the same
script on the CPU demotes it, and both end in the same reads; a
``GuardedSession`` on ``cuda`` recovers from one injected failure
on the card, and raises on a persistent one without demoting a doc.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serve_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.core.errors import DeviceRoundError
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops import kernel as kernel_mod
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.parallel.supervisor import GuardedSession
from peritext_tpu_torch.serve import (
    ADMIT,
    SHED_SESSION_QUOTA,
    AdmissionController,
    BatchWindowTuner,
    SessionMux,
)
from peritext_tpu_torch.testing.fuzz import generate_workload

pytestmark = pytest.mark.cuda

ACTORS = ("doc1", "doc2", "doc3")
CAPS = dict(num_docs=16, actors=ACTORS, slot_capacity=256, mark_capacity=64, tomb_capacity=128,
            round_insert_capacity=128, round_delete_capacity=64, round_mark_capacity=64,
            static_rounds=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernel has no CPU mode")
    return torch.device("cuda")


def _plans(seed=21, docs=16, ops=48):
    out = []
    for w in generate_workload(seed, num_docs=docs, ops_per_doc=ops):
        changes = [ch for log in w.values() for ch in log]
        out.append([encode_frame(changes[i:i + 6]) for i in range(0, len(changes), 6)])
    return out


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.0007
        return self.t


def _serve(device, plans):
    mux = SessionMux(StreamingMerge(**CAPS, device=device), clock=_Clock(),
                     admission=AdmissionController(max_depth=40, high_watermark=0.6,
                                                   low_watermark=0.3, shed_after=2),
                     tuner=BatchWindowTuner(floor=0.05, ceiling=0.2))
    sids = [mux.open_session(f"c{d}")[0] for d in range(len(plans))]
    record = []
    queues = {sid: list(p) for sid, p in zip(sids, plans)}
    n = 0
    while any(queues.values()):
        for sid in sids:
            if queues[sid]:
                v = mux.submit(sid, queues[sid][0])
                record.append(v.to_json())
                if v.kind != "delay":
                    queues[sid].pop(0)
                n += 1
                if n % 4 == 0 and mux.pump() and n % 20 == 0:
                    record.append(mux.patches(sids[n % len(sids)]))
    mux.flush()
    record += [mux.patches(sid) for sid in sids] + [mux.read(sid) for sid in sids]
    return mux, record


def test_mux_on_the_card_equals_the_mux_on_the_cpu(cuda):
    plans = _plans()
    host, host_record = _serve("cpu", plans)
    applies = GLOBAL_COUNTERS.get("streaming.block_applies")
    insert_batch.launches = 0
    card, card_record = _serve(cuda, plans)
    launches = insert_batch.launches
    assert card.session.device.type == "cuda"
    assert card_record == host_record
    assert card.snapshot() == host.snapshot()
    assert card.session.digest() == host.session.digest()
    assert card.session.read_all() == host.session.read_all()
    assert launches > 0 and launches == GLOBAL_COUNTERS.get("streaming.block_applies") - applies
    assert not any(s.fallback for s in card.session.docs)


def _quota_script(device, frames):
    """One hot client on a two-doc session whose quota is two frames: each
    frame is resubmitted until admitted, with a flush after every 5 quota
    sheds in a row (3 of them are the demotion threshold)."""
    mux = SessionMux(StreamingMerge(**dict(CAPS, num_docs=2), device=device),
                     admission=AdmissionController(max_depth=8, session_quota=0.25),
                     degrade_after=3, clock=_Clock())
    hot, _ = mux.open_session("hot")
    streak = sheds = 0
    for frame in frames:
        while (v := mux.submit(hot, frame)).kind != ADMIT:
            assert v.reason == SHED_SESSION_QUOTA
            sheds, streak = sheds + 1, streak + 1
            if streak == 5:
                mux.flush()
                streak = 0
        streak = 0
    mux.flush()
    return mux, hot, sheds


def test_quota_sheds_never_demote_on_the_card(cuda):
    frames = _plans(docs=1, ops=96)[0]
    host, hot, host_sheds = _quota_script("cpu", frames)
    applies = GLOBAL_COUNTERS.get("streaming.block_applies")
    refused = GLOBAL_COUNTERS.get("serve.degrade_refused_on_device")
    insert_batch.launches = 0
    card, sid, sheds = _quota_script(cuda, frames)
    assert host.sessions()[hot].degraded and host.session.docs[0].fallback
    assert sheds >= 5 and GLOBAL_COUNTERS.get("serve.degrade_refused_on_device") > refused
    assert not card.sessions()[sid].degraded and card.degraded_docs == 0
    assert not any(s.fallback for s in card.session.docs) and not card.session.quarantined()
    assert card.applied == len(frames)
    assert insert_batch.launches > 0
    assert insert_batch.launches == GLOBAL_COUNTERS.get("streaming.block_applies") - applies
    assert card.read(sid) == host.read(hot)


def _frames(plans):
    return [(d, f) for d, plan in enumerate(plans) for f in plan]


def test_guarded_session_recovers_on_the_card(cuda, tmp_path):
    plans = _plans()
    g = GuardedSession(lambda: StreamingMerge(**CAPS, device=cuda), tmp_path,
                       checkpoint_every=1, deadline=60.0, autotune=False)
    frames = _frames(plans)
    half = len(frames) // 2
    g.ingest_frames(frames[:half])
    g.drain()
    g.inject_failure(RuntimeError("injected device fault"))
    g.ingest_frames(frames[half:])
    assert g.drain() == 0  # rolled back, re-drained on the card
    plain = StreamingMerge(**CAPS, device="cpu")
    plain.ingest_frames(frames)
    plain.drain()
    assert g.session.device.type == "cuda"
    assert g.digest() == plain.digest() and g.read_all() == plain.read_all()
    health = g.health()
    assert health["rollbacks"] == 1 and health["scalar_degradations"] == 0
    assert health["fallback_docs"] == 0


def test_persistent_fault_raises_on_the_card(cuda, tmp_path, monkeypatch):
    plans = _plans(docs=16)
    g = GuardedSession(lambda: StreamingMerge(**CAPS, device=cuda), tmp_path,
                       checkpoint_every=1, deadline=60.0, autotune=False)
    g.ingest_frames(_frames(plans)[:20])
    g.drain()

    def fault(*args, **kwargs):
        raise RuntimeError("injected persistent device fault")

    monkeypatch.setattr(kernel_mod, "insert_batch", fault)
    g.ingest_frames(_frames(plans)[20:])
    with pytest.raises(DeviceRoundError, match="persistent"):
        g.drain()
    assert not any(s.fallback for s in g.session.docs)
    assert g.scalar_degradations == 0 and g.rollbacks == 1
