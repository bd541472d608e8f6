"""The port's chaos harness, session episodes, against the reference's.

Each episode runs on CPU sessions (``device="cpu"``) and on the reference
package's JAX CPU sessions for the same seed.  Both pass their own oracles
(the episodes raise otherwise) and must report the same: final digests,
rollbacks, corrupt and dropped frames, crash restores, incident kinds and
detection rounds.  The quarantine reasons each drain leaves are recorded in
both packages and must be equal too.

* ``run_chaos`` (seed 0 at its defaults) and ``run_campaign``;
* ``run_fused_drain_kill``: the port kills its drain where the reference
  does, at ``StreamingMerge._dispatch_fused_batch``, on the second staged
  batch, after at least one committed batch, and recovers byte-equal;
* ``run_markheavy_chaos``;
* the supervisor's last rung in a chaos-style episode: a CPU session
  demotes its pending docs to the oracle (reason ``device-round``) and ends
  digest-equal to the reference and to a fault-free session; on the card it
  raises (``tests/test_torch_chaos_cuda.py``);
* ``GuardedSession.adopt_session``, the crash-restore's install.
"""

import pytest

from peritext_tpu.parallel.supervisor import GuardedSession as RefGuarded
from peritext_tpu.testing import chaos as ref_chaos
from peritext_tpu_torch.parallel import streaming as port_streaming
from peritext_tpu_torch.parallel.supervisor import GuardedSession
from peritext_tpu_torch.testing import chaos
from peritext_tpu_torch.testing.fuzz import _campaign_session, generate_workload


@pytest.fixture(scope="module")
def reference():
    """Reference episode reports, each run once per module."""
    cache = {}

    def run(name, *args, **kw):
        key = (name, args, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = getattr(ref_chaos, name)(*args, **kw)
        return cache[key]

    return run


@pytest.fixture
def drain_reasons(monkeypatch):
    """Record, in each package, the quarantine reasons every guarded drain
    leaves behind."""
    seen = {"port": [], "reference": []}
    for key, cls in (("port", GuardedSession), ("reference", RefGuarded)):
        original = cls.drain

        def drain(self, *args, _original=original, _key=key, **kw):
            out = _original(self, *args, **kw)
            seen[_key].append(sorted((d, r.reason) for d, r in self.quarantined().items()))
            return out

        monkeypatch.setattr(cls, "drain", drain)
    return seen


def _as_dict(report):
    return report.to_json() if hasattr(report, "to_json") else dict(report)


def test_run_chaos_equals_the_reference(reference, drain_reasons):
    port = chaos.run_chaos(0, device="cpu")
    ref = reference("run_chaos", 0)
    assert _as_dict(port) == _as_dict(ref)
    assert port.rollbacks >= 1 and port.corrupt_frames and port.crash_restores == 1
    assert port.isolation_checked and port.transport_repaired
    assert drain_reasons["port"] == drain_reasons["reference"]
    assert any(reasons for reasons in drain_reasons["port"]), "no drain left a quarantine"
    assert {r for reasons in drain_reasons["port"] for _, r in reasons} <= {
        port_streaming.REASON_DECODE, port_streaming.REASON_DEVICE_ROUND}


def test_run_campaign_is_run_chaos_per_seed(reference, capsys):
    reports = chaos.run_campaign(range(0, 1), verbose=True, device="cpu")
    assert [r.to_json() for r in reports] == [reference("run_chaos", 0).to_json()]
    assert "seed    0: frames=" in capsys.readouterr().out


def test_fused_drain_kill_fires_mid_commit(reference, monkeypatch):
    dispatches = []
    original = port_streaming.StreamingMerge._dispatch_fused_batch

    def counted(self, batch, statics, inputs, **kw):
        dispatches.append((len(batch), statics[0]))
        return original(self, batch, statics, inputs, **kw)

    monkeypatch.setattr(port_streaming.StreamingMerge, "_dispatch_fused_batch", counted)
    port = chaos.run_fused_drain_kill(0, device="cpu")
    assert port == reference("run_fused_drain_kill", 0)
    assert port["rollbacks"] == 1 and port["batches_before_kill"] >= 1
    assert port["incident_kinds"] == ["quarantine-storm"] and port["incident_resolved"]
    # FUSE_MAX_ROUNDS = 2 with round caps of 8: the factory's sessions drain
    # in staged batches of two rounds (the flat form), several of them, as
    # the reference's (a session restored from a checkpoint keeps the
    # class's batch window); the kill hooks the fused dispatch seam
    sizes = [n for n, _ in dispatches]
    assert dispatches[0] == (2, "flat") and sizes.count(2) > 2


def test_fused_drain_kill_keeps_its_checkpoint_root(tmp_path, reference):
    port = chaos.run_fused_drain_kill(0, checkpoint_root=tmp_path, device="cpu")
    assert port["digest"] == reference("run_fused_drain_kill", 0)["digest"]
    assert any(tmp_path.iterdir()), "the caller's checkpoint root holds the checkpoints"


def test_markheavy_chaos_equals_the_reference(reference, drain_reasons):
    port = chaos.run_markheavy_chaos(0, device="cpu")
    assert _as_dict(port) == _as_dict(reference("run_markheavy_chaos", 0))
    assert drain_reasons["port"] == drain_reasons["reference"]


def test_last_rung_degrades_only_the_cpu_session(tmp_path, monkeypatch):
    """When the rollback's re-drain fails too, a CPU session demotes every
    pending doc to scalar replay, as the reference does, and converges
    byte-equal to it and to a fault-free session."""
    from peritext_tpu.parallel.codec import encode_frame as ref_encode
    from peritext_tpu.testing.fuzz import _campaign_session as ref_session
    from peritext_tpu.testing.fuzz import generate_workload as ref_generate
    from peritext_tpu_torch.parallel.codec import encode_frame

    frames = [encode_frame([ch for log in w.values() for ch in log])
              for w in generate_workload(9, num_docs=3, ops_per_doc=24)]
    assert frames == [ref_encode([ch for log in w.values() for ch in log])
                      for w in ref_generate(9, num_docs=3, ops_per_doc=24)]

    def sick(self):
        raise RuntimeError("device still failing")

    out = {}
    for key, cls, factory in (
            ("port", GuardedSession, lambda: _campaign_session(3, 24, device="cpu")),
            ("reference", RefGuarded, lambda: ref_session(3, 24))):
        g = cls(factory, tmp_path / key)
        for d, f in enumerate(frames):
            g.ingest_frame(d, f)
        monkeypatch.setattr(cls, "_drain_device", sick)
        g.inject_failure(RuntimeError("chaos: injected device error"))
        assert g.step() == 0
        monkeypatch.undo()
        g.drain()
        out[key] = (g.rollbacks, sorted((d, r.reason) for d, r in g.quarantined().items()),
                    g.digest(), g.read_all())
    assert out["port"] == out["reference"]
    rollbacks, reasons, digest, _ = out["port"]
    assert rollbacks == 1 and reasons == [(d, port_streaming.REASON_DEVICE_ROUND)
                                          for d in range(3)]
    clean = _campaign_session(3, 24, device="cpu")
    for d, f in enumerate(frames):
        clean.ingest_frame(d, f)
    clean.drain()
    assert digest == clean.digest()


def test_adopt_session_attaches_the_supervisors_telemetry(tmp_path):
    g = GuardedSession(lambda: _campaign_session(2, 8, device="cpu"), tmp_path)
    fresh = _campaign_session(2, 8, device="cpu")
    g.adopt_session(fresh)
    assert g.session is fresh
    assert fresh.tracer is g.tracer and fresh.recorder is g.recorder
