"""The port's ``GuardedSession`` (``peritext_tpu_torch/parallel/supervisor.py``)
against the reference package's, on the CPU.

Both supervise a session of the same shape, fed the same wire frames, with
the same injected failure and the same injected delay past the watchdog
deadline: rollbacks, checkpoints, ``digest()``, ``read_all()``,
``frontier()`` and the quarantine must be equal.  The last rung's scalar
degradation on the CPU must be equal too.  Then the port's own rules: a
session off the CPU raises at the last rung instead of demoting its docs
(the device-type rule), a kernel that fails to build reaches the caller
from every rung, and the round body runs under the caller's span.
"""

import threading

import pytest
import torch

from peritext_tpu.core.errors import DeviceRoundError as JaxDeviceRoundError
from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.parallel.supervisor import GuardedSession as JaxGuarded
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.api.batch import _oracle_doc
from peritext_tpu_torch.core.errors import DeviceRoundError
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import Tracer
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import REASON_DEVICE_ROUND, StreamingMerge
from peritext_tpu_torch.parallel.supervisor import GuardedSession
from peritext_tpu_torch.utils.nvcc import KernelBuildError

ACTORS = ("doc1", "doc2", "doc3")
DOCS, OPS, ROUNDS = 8, 48, 4
CAPS = dict(num_docs=DOCS, actors=ACTORS, slot_capacity=256, mark_capacity=64,
            tomb_capacity=128, round_insert_capacity=128, round_delete_capacity=64,
            round_mark_capacity=64, static_rounds=True)


@pytest.fixture(scope="module")
def workload():
    """(workloads, per-round frame lists): each doc's changes in ROUNDS
    frames, round r of every doc in one list."""
    workloads = generate_workload(17, num_docs=DOCS, ops_per_doc=OPS)
    rounds = [[] for _ in range(ROUNDS)]
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        step = -(-len(changes) // ROUNDS)
        for r in range(ROUNDS):
            chunk = changes[r * step:(r + 1) * step]
            if chunk:
                rounds[r].append((d, jax_encode_frame(chunk)))
    return workloads, rounds


def _port_workload(w):
    return {a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}


def _pair(tmp_path, **kw):
    kw = dict(dict(deadline=60.0, checkpoint_every=1, autotune=False), **kw)
    ref = JaxGuarded(lambda: JaxStreamingMerge(**CAPS), tmp_path / "ref", **kw)
    port = GuardedSession(lambda: StreamingMerge(**CAPS, device="cpu"), tmp_path / "port", **kw)
    return ref, port


def _quarantine(g):
    return {d: (r.reason, r.detail) for d, r in g.quarantined().items()}


HEALTH_KEYS = ("rounds", "num_docs", "pending_changes", "fallback_docs", "frame_docs",
               "quarantined", "rollbacks", "checkpoints", "journal_frames", "deadline_seconds",
               "deadline_static", "deadline_floor", "deadline_ceiling", "deadline_autotuned")


def _run_faults(g, rounds, delay):
    """Round 0 drains clean; a failure is injected before round 1's drain;
    round 2's step overruns the deadline; then everything drains."""
    out = []
    for r, frames in enumerate(rounds):
        g.ingest_frames(frames)
        if r == 1:
            g.inject_failure(RuntimeError("injected device fault"))
            out.append(g.drain())
        elif r == 2:
            g.deadline = delay / 2
            g.inject_delay(delay)
            out.append(g.step())
            g.deadline = 60.0
        out.append(g.drain())
    return out


@pytest.fixture(scope="module")
def faulted(workload, tmp_path_factory):
    _, rounds = workload
    ref, port = _pair(tmp_path_factory.mktemp("faults"))
    before = set(threading.enumerate())
    # the deadline (half the delay) also bounds the rollback's re-drain: 2.5 s
    # keeps a loaded machine's re-drain well inside it
    out = ref, port, _run_faults(ref, rounds, 5.0), _run_faults(port, rounds, 5.0)
    yield out
    # the reference keeps no handle on the round its watchdog abandoned:
    # wait for every thread the fixture started, so none is killed at exit
    # in the middle of a device call
    for thread in set(threading.enumerate()) - before:
        if thread.name != "peritext-stager":
            thread.join(timeout=30)


def test_rollbacks_and_results_equal(faulted):
    ref, port, ref_out, port_out = faulted
    assert ref_out == port_out
    assert ref.rollbacks == port.rollbacks == 2
    assert ref.checkpoints == port.checkpoints
    assert port.digest() == ref.digest()
    assert port.digest(full=False) == ref.digest(full=False)
    assert port.read_all() == ref.read_all()
    assert port.frontier() == ref.frontier()
    assert _quarantine(port) == _quarantine(ref) == {}
    assert port.pending_count() == ref.pending_count() == 0
    assert port.join_abandoned(timeout=30)


def test_health_equal_but_for_timings(faulted):
    ref, port, _, _ = faulted
    h_ref, h_port = ref.health(), port.health()
    assert {k: h_ref[k] for k in HEALTH_KEYS} == {k: h_port[k] for k in HEALTH_KEYS}
    assert h_port["scalar_degradations"] == 0 and h_port["fallback_docs"] == 0
    assert h_port["flight_recorder"]["faults"] == h_ref["flight_recorder"]["faults"] == 2
    assert h_port["round_latency"]["count"] == h_ref["round_latency"]["count"]


def test_recovered_session_equals_the_oracle(faulted, workload):
    workloads, _ = workload
    _, port, _, _ = faulted
    for d, w in enumerate(workloads):
        assert port.read(d) == _oracle_doc(_port_workload(w)).get_text_with_formatting(["text"])


def test_persistent_failure_degrades_on_the_cpu_as_the_reference(workload, tmp_path,
                                                                 monkeypatch):
    """The last rung on the CPU: every pending doc demoted to scalar replay
    with reason ``device-round``, the same records and reads as the
    reference's."""
    workloads, rounds = workload
    ref, port = _pair(tmp_path)

    def sick(self):
        raise RuntimeError("device still failing")

    out = []
    for g, cls, err in ((ref, JaxGuarded, JaxDeviceRoundError), (port, GuardedSession,
                                                                 DeviceRoundError)):
        for frames in rounds:
            g.ingest_frames(frames)
        monkeypatch.setattr(cls, "_drain_device", sick)
        g.inject_failure(err("first failure"))
        assert g.step() == 0
        monkeypatch.undo()
        out.append((_quarantine(g), [s.fallback for s in g.session.docs]))
        g.drain()
        out.append((g.read_all(), g.digest(), g.frontier(), g.rollbacks))
    assert out[0] == out[2] and out[1] == out[3]
    quarantine, fallback = out[2]
    assert quarantine and all(reason == REASON_DEVICE_ROUND for reason, _ in quarantine.values())
    assert all(fallback) and port.scalar_degradations == 1
    for d, w in enumerate(workloads):
        assert port.read(d) == _oracle_doc(_port_workload(w)).get_text_with_formatting(["text"])


class _StubSession:
    """What the last rung touches of a restored session, on a named device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.demoted = []
        self.tracer = self.recorder = None

    def pending_docs(self):
        return {0, 1}

    def force_fallback(self, d, reason, detail=""):
        self.demoted.append((d, reason))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_last_rung_degrades_only_on_the_cpu(device, tmp_path, monkeypatch):
    """The device-type rule: when the re-drain after a rollback fails too,
    a session on the CPU demotes its pending docs, and a session on any
    other device raises ``DeviceRoundError`` and demotes nothing."""
    g = GuardedSession(lambda: StreamingMerge(**CAPS, device="cpu"), tmp_path)
    stub = _StubSession(device)
    monkeypatch.setattr(GuardedSession, "_restore_base", lambda self: stub)

    def sick(self):
        raise RuntimeError("device still failing")

    monkeypatch.setattr(GuardedSession, "_drain_device", sick)
    monkeypatch.setattr(GuardedSession, "_run_guarded", lambda self, fn, deadline=None: fn())
    g.inject_failure(RuntimeError("first failure"))
    if device == "cpu":
        assert g.step() == 0
        assert stub.demoted == [(0, REASON_DEVICE_ROUND), (1, REASON_DEVICE_ROUND)]
        assert g.scalar_degradations == 1
    else:
        with pytest.raises(DeviceRoundError, match="device still failing"):
            g.step()
        assert stub.demoted == [] and g.scalar_degradations == 0
    assert g.rollbacks == 1 and g.session is stub


@pytest.mark.parametrize("where", ["step", "drain", "re-drain"])
def test_kernel_build_failure_reaches_the_caller(where, workload, tmp_path, monkeypatch):
    """A kernel that cannot be built or loaded is no round fault: it is
    raised from the round, the drain and the rollback's re-drain alike,
    and never demotes a doc."""
    _, rounds = workload
    g = GuardedSession(lambda: StreamingMerge(**CAPS, device="cpu"), tmp_path)
    g.ingest_frames(rounds[0])

    def broken(*args, **kwargs):
        raise KernelBuildError("CUDA build failed: insert.cu")

    if where == "re-drain":
        monkeypatch.setattr(GuardedSession, "_drain_device", lambda self: broken())
        g.inject_failure(RuntimeError("first failure"))
    else:
        monkeypatch.setattr(StreamingMerge, "step" if where == "step" else "drain", broken)
    with pytest.raises(KernelBuildError):
        g.step() if where != "drain" else g.drain()
    assert g.rollbacks == (1 if where == "re-drain" else 0)
    assert not any(s.fallback for s in g.session.docs)


def test_stage_spans_nest_under_the_guarded_round(workload, tmp_path):
    """The round body runs on the watchdog thread, yet the session's stage
    spans parent under ``supervisor.round`` and land in the recorder."""
    _, rounds = workload
    tracer = Tracer()
    seen = []
    tracer.add_sink(seen.append)
    g = GuardedSession(lambda: StreamingMerge(**CAPS, device="cpu"), tmp_path, tracer=tracer)
    g.ingest_frames(rounds[0])
    assert g.step() > 0
    by_name = {sp.name: sp for sp in seen}
    guard, round_ = by_name["supervisor.round"], by_name["streaming.round"]
    assert round_.parent_id == guard.span_id and round_.trace_id == guard.trace_id
    assert by_name["streaming.apply"].parent_id == round_.span_id
    assert round_.tid != guard.tid  # the watchdog thread
    kinds = [e["kind"] for e in g.recorder.entries()]
    assert kinds.count("span") >= 4
    g.close()
    assert seen[-1].name == "supervisor.round"


def test_mesh_is_not_ported(faulted, workload, tmp_path):
    """The mesh is ported: a supervised session over a 4-shard CPU mesh,
    with the same injected failure and delay as the reference's, rolls
    back onto its mesh twice and ends equal to the reference's session."""
    ref, _, ref_out, _ = faulted
    _, rounds = workload
    mesh = make_mesh(4, device="cpu")
    g = GuardedSession(lambda: StreamingMerge(**CAPS, mesh=mesh, device="cpu"), tmp_path,
                       mesh=mesh, deadline=60.0, checkpoint_every=1, autotune=False)
    try:
        assert _run_faults(g, rounds, 5.0) == ref_out
        assert g.rollbacks == ref.rollbacks == 2
        assert g.session.mesh == mesh and g.session._shard_state is not None
        assert (g.digest(), g.read_all(), g.frontier()) == \
            (ref.digest(), ref.read_all(), ref.frontier())
        assert g.join_abandoned(timeout=30)
    finally:
        g.close()
