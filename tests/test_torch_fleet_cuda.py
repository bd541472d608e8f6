"""The fused multi-tenant group and the fleet on the card.

* A ``FusedMuxGroup`` with one lane of each layout (padded, paged, ragged)
  on ``cuda`` equals the same group on the CPU (verdicts, patch streams,
  reads, snapshot, each lane's digests), with K1 launches equal to the
  padded lane's block applies plus the paged lane's group applies, and K3
  launches equal to the ragged lane's ragged applies.
* A two-host ``FleetFrontend`` with ``transport=True`` on ``cuda``: a
  migration and a failover ship over TCP, and each ship's receive runs on a
  transport handler thread, on the session's device and the stream of the
  thread that built the host.  Every doc ends digest-equal to a plain
  session fed its frames.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fleet_cuda.py -q
"""

import threading

import pytest
import torch

from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.obs.timeseries import TimeSeriesPlane
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.plan import TenantSpec
from peritext_tpu_torch.serve import (
    AdmissionController,
    FleetFrontend,
    FusedMuxGroup,
    SessionMux,
    default_lane_factory,
)
from peritext_tpu_torch.testing.fuzz import generate_workload

pytestmark = pytest.mark.cuda

ACTORS = ("doc1", "doc2", "doc3")
KW = dict(slot_capacity=256, mark_capacity=64, tomb_capacity=128, round_insert_capacity=128,
          round_delete_capacity=64, round_mark_capacity=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernels have no CPU mode")
    return torch.device("cuda")


def _frames(seed, docs, ops, per=6):
    out = []
    for w in generate_workload(seed, num_docs=docs, ops_per_doc=ops):
        changes = sorted((ch for log in w.values() for ch in log), key=lambda c: (c.actor, c.seq))
        out.append([encode_frame(changes[i::per]) for i in range(per)])
    return out


def _fused(device, frames, names):
    group = FusedMuxGroup([TenantSpec(n, docs=2, layout=("padded", "paged", "ragged")[i % 3])
                           for i, n in enumerate(names)],
                          default_lane_factory(ACTORS, device=device, **KW),
                          clock=lambda: 100.0)
    group.history = TimeSeriesPlane().enable()
    sids = {(n, d): group.open_session(n, f"c{d}")[0] for n in names for d in range(2)}
    record = []
    for w in range(len(frames[0])):
        active = names if w % 2 == 0 else names[w % 3::3]
        for i, n in enumerate(names):
            if n in active or w == len(frames[0]) - 1:
                for d in range(2):
                    plan = frames[2 * i + d]
                    if w < len(plan) and plan[w] is not None:
                        record.append(group.submit(n, sids[n, d], plan[w]).to_json())
                        plan[w] = None
        group.flush()
    for w in range(len(frames[0])):  # frames an odd window skipped
        for i, n in enumerate(names):
            for d in range(2):
                if frames[2 * i + d][w] is not None:
                    record.append(group.submit(n, sids[n, d], frames[2 * i + d][w]).to_json())
        group.flush()
    record += [group.patches(n, sid) for (n, _), sid in sorted(sids.items())]
    record += [group.read(n, sid) for (n, _), sid in sorted(sids.items())]
    return group, record


def test_fused_group_on_the_card_equals_the_cpu(cuda):
    names = [f"t{i}" for i in range(6)]
    host, host_rec = _fused("cpu", _frames(5, 12, 48), names)
    before = {k: GLOBAL_COUNTERS.get(f"streaming.{k}")
              for k in ("block_applies", "group_applies", "ragged_applies")}
    insert_batch.launches = ragged_insert.launches = 0
    card, card_rec = _fused(cuda, _frames(5, 12, 48), names)
    k1, k3 = insert_batch.launches, ragged_insert.launches
    delta = {k: GLOBAL_COUNTERS.get(f"streaming.{k}") - v for k, v in before.items()}
    assert card_rec == host_rec
    assert card.snapshot() == host.snapshot()
    assert [s.layout for s in card._lane_sessions] == ["padded", "paged", "ragged"]
    for mine, cpu in zip(card._lane_sessions, host._lane_sessions):
        assert mine.device.type == "cuda"
        assert mine.digest() == cpu.digest() and mine.read_all() == cpu.read_all()
        assert not any(d.fallback for d in mine.docs)
    assert card.history.occupancy_rows() == host.history.occupancy_rows()
    assert k1 > 0 and k1 == delta["block_applies"] + delta["group_applies"]
    assert k3 > 0 and k3 == delta["ragged_applies"]


def test_two_host_fleet_ships_on_handler_threads_on_the_card(cuda):
    plans = [[encode_frame(p) for p in _chunks(w)] for w in
             generate_workload(9, num_docs=6, ops_per_doc=48)]
    fe = FleetFrontend(lease_rounds=2, checkpoint_every=2)
    try:
        for i in range(2):
            fe.add_host(f"host{i}", SessionMux(
                StreamingMerge(num_docs=16, actors=ACTORS, static_rounds=True, device=cuda,
                               **KW),
                admission=AdmissionController(max_depth=128, session_quota=None)),
                transport=True)
        receives = []
        main = threading.current_thread()
        for host in fe.hosts.values():
            ingest = host.ingest_doc_frames

            def spy(key, frames, base=0, _ingest=ingest, _host=host):
                receives.append((threading.current_thread() is not main,
                                 torch.cuda.current_device(),
                                 torch.cuda.current_stream(cuda) == _host._cuda[1]))
                return _ingest(key, frames, base)

            host.ingest_doc_frames = spy
        keys = [f"doc{d}" for d in range(len(plans))]
        for k in keys:
            assert fe.open_doc(k, "client").admitted
        pending = {k: list(p) for k, p in zip(keys, plans)}
        passes = 0
        while any(pending.values()):
            for k in keys:
                if pending[k] and fe.submit(k, pending[k][0]).admitted:
                    pending[k].pop(0)
            fe.round()
            passes += 1
            if passes == 2:
                src = fe._serving["doc0"]
                fe.migrate("doc0", "host1" if src == "host0" else "host0")
            if passes == 4:
                victim = fe._serving["doc1"]
                fe.hosts[victim].kill()
            assert passes < 100
        while not fe.ledger.dead_hosts():
            fe.round()
        fe.flush()
        assert fe.failovers == 1 and fe.migrations == 1 and fe.stats.accounted()
        assert receives and all(r == (True, cuda.index or 0, True) for r in receives)
        plain = StreamingMerge(num_docs=len(plans), actors=ACTORS, static_rounds=True,
                               device=cuda, **KW)
        for d, plan in enumerate(plans):
            for f in plan:
                plain.ingest_frame(d, f)
        plain.drain()
        for d, k in enumerate(keys):
            assert fe.doc_digest(k) == plain.doc_digest(d)
    finally:
        fe.stop()


def _chunks(w, size=6):
    changes = [ch for log in sorted(w) for ch in w[log]]
    return [changes[i:i + size] for i in range(0, len(changes), size)]
