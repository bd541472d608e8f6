"""The port's serving tier (``peritext_tpu_torch/serve/``) against the
reference package's, on the CPU.

Both packages get the same wire frames (the port's ``encode_frame`` is
byte-equal to the reference's on the same changes) and the same injected
clocks (the reference tests' ``FakeClock`` / ``SteppingClock``), so every
comparison is exact: admission verdicts and shed reasons, window-tuner
readouts, each session's patch stream and ``read``, the mux
``snapshot()``, the quota degradation ladder, the corrupt-frame
quarantine, ``build_arrivals`` and the ``run_open_loop`` / ladder
accounting.  The mux runs over the padded layout (``static_rounds=True``)
and once over the paged and once over the ragged layout; 16 sessions of 48
fuzz ops.
"""

import json
import random

import pytest
import torch

from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.serve import AdmissionController as JaxAdmission
from peritext_tpu.serve import BatchWindowTuner as JaxTuner
from peritext_tpu.serve import SessionKeyring as JaxKeyring
from peritext_tpu.serve import SessionMux as JaxMux
from peritext_tpu.serve import build_arrivals as jax_build_arrivals
from peritext_tpu.serve import run_open_loop as jax_run_open_loop
from peritext_tpu.serve import sustained_ladder as jax_sustained_ladder
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import Counters, LatencyPlane, check_sum_consistency
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.serve import (
    ADMIT,
    DELAY,
    SHED,
    SHED_REASONS,
    SHED_SESSION_QUOTA,
    AdmissionController,
    BatchWindowTuner,
    SessionKeyring,
    SessionMux,
    build_arrivals,
    run_open_loop,
    sustained_ladder,
)

ACTORS = ("doc1", "doc2", "doc3")
DOCS, OPS = 16, 48
LAYOUTS = ("padded", "paged", "ragged")


def _kwargs(num_docs, layout):
    kw = dict(num_docs=num_docs, actors=ACTORS, slot_capacity=max(256, 4 * OPS),
              mark_capacity=max(64, OPS), tomb_capacity=max(128, OPS),
              round_insert_capacity=128, round_delete_capacity=64, round_mark_capacity=64)
    if layout == "padded":
        kw["static_rounds"] = True
    else:
        kw["layout"] = layout
    return kw


_REFERENCE_SESSIONS = []


def sessions(num_docs=DOCS, layout="padded"):
    """(reference session, port session on the CPU) of one shape."""
    kw = _kwargs(num_docs, layout)
    ref = JaxStreamingMerge(**kw)
    _REFERENCE_SESSIONS.append(ref)
    return ref, StreamingMerge(**kw, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _close_reference_stagers():
    """The reference sessions stage digest prefetches on a daemon thread;
    close those lanes before the process ends, so none is killed at exit
    in the middle of a device call."""
    yield
    for ref in _REFERENCE_SESSIONS:
        stager = getattr(ref, "_stager", None)
        if stager is not None:
            thread = stager._thread
            stager.close()
            if thread is not None:
                thread.join(timeout=30)
    _REFERENCE_SESSIONS.clear()


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt

    def nap(self, dt):
        """A sleep that always moves the clock: a nap below the clock's
        float resolution would leave an open loop spinning."""
        self.t += max(dt, 1e-6)


class SteppingClock:
    """Advances ``step`` per read: each committed round's measured wall is
    exactly ``step`` times the pump's clock reads around its drain."""

    def __init__(self, step=0.0):
        self.t = 100.0
        self.step = step

    def __call__(self):
        v = self.t
        self.t += self.step
        return v


@pytest.fixture(scope="module")
def plans():
    """Per-doc frame plans: each doc's changes in frames of 6, encoded by
    the reference; the port's encoder gives the same bytes."""
    out = []
    for w in generate_workload(21, num_docs=DOCS, ops_per_doc=OPS):
        changes = [ch for log in w.values() for ch in log]
        frames = [jax_encode_frame(changes[i:i + 6]) for i in range(0, len(changes), 6)]
        port = [Change.from_json(c.to_json()) for c in changes]
        assert frames == [encode_frame(port[i:i + 6]) for i in range(0, len(port), 6)]
        out.append(frames)
    return out


# ---------------------------------------------------------------------------
# admission control and the window tuner
# ---------------------------------------------------------------------------

ADMISSION_CONFIGS = [
    dict(max_depth=10, high_watermark=0.5, low_watermark=0.2, shed_after=3, session_quota=None),
    dict(max_depth=8, high_watermark=0.75, low_watermark=0.5, session_quota=0.25),
    dict(max_depth=16, high_watermark=0.9, low_watermark=0.3, shed_after=4, session_quota=0.5),
]


@pytest.mark.parametrize("config", range(len(ADMISSION_CONFIGS)))
def test_admission_verdict_sequences_equal(config):
    """A seeded script of offers (normal and degraded), out-of-band sheds
    and delays, releases and drain observations gives equal verdicts,
    tails and snapshots."""
    cfg = ADMISSION_CONFIGS[config]
    ref, port = JaxAdmission(**cfg), AdmissionController(**cfg)
    rng = random.Random(config)
    for step in range(300):
        sid = rng.randrange(4)
        pick = rng.random()
        if pick < 0.6:
            cost, degraded = rng.choice((1, 1, 2)), rng.random() < 0.1
            assert ref.offer(sid, cost, degraded).to_json() == \
                port.offer(sid, cost, degraded).to_json()
        elif pick < 0.8:
            n = rng.randrange(1, 3)
            ref.mark_applied(sid, n)
            port.mark_applied(sid, n)
        elif pick < 0.9:
            units, secs = rng.randrange(0, 9), rng.choice((0.0, 0.01, 0.05))
            ref.observe_drain(units, secs)
            port.observe_drain(units, secs)
        elif pick < 0.95:
            reason = rng.choice(SHED_REASONS)
            assert ref.shed_out_of_band(reason).to_json() == \
                port.shed_out_of_band(reason).to_json()
        else:
            assert ref.delay_out_of_band(0.02).to_json() == port.delay_out_of_band(0.02).to_json()
        assert ref.snapshot() == port.snapshot(), step
    for sid in range(4):
        assert ref.verdict_tail(sid) == port.verdict_tail(sid)
        assert ref.session_depth(sid) == port.session_depth(sid)
    s = port.stats
    assert s.submitted == s.admitted + s.delayed + s.shed


@pytest.mark.parametrize("config", range(len(ADMISSION_CONFIGS)))
def test_admission_verdicts_equal_offer_by_offer(config):
    cfg = ADMISSION_CONFIGS[config]
    ref, port = JaxAdmission(**cfg), AdmissionController(**cfg)
    rng = random.Random(100 + config)
    kinds = set()
    for _ in range(400):
        sid, cost, degraded = rng.randrange(4), rng.choice((1, 1, 2)), rng.random() < 0.1
        if rng.random() < 0.7:
            a, b = ref.offer(sid, cost, degraded), port.offer(sid, cost, degraded)
            assert a.to_json() == b.to_json()
            assert a.admitted == b.admitted
            kinds.add(b.kind)
        else:
            ref.mark_applied(sid, cost)
            port.mark_applied(sid, cost)
        assert ref.backpressure == port.backpressure
    assert ref.snapshot() == port.snapshot()
    assert ADMIT in kinds and (DELAY in kinds or SHED in kinds)


def test_admission_rejects_bad_config():
    for kw in (dict(max_depth=0), dict(low_watermark=0.9, high_watermark=0.5)):
        with pytest.raises(ValueError):
            JaxAdmission(**kw)
        with pytest.raises(ValueError):
            AdmissionController(**kw)


def test_window_tuner_readouts_equal():
    rng = random.Random(5)
    ref, port = JaxTuner(floor=0.002, ceiling=0.25, window=16), \
        BatchWindowTuner(floor=0.002, ceiling=0.25, window=16)
    assert ref.window_seconds() == port.window_seconds() == 0.002
    for _ in range(100):
        wall = rng.choice((0.0004, 0.003, 0.02, 0.07, 0.4, 3.0)) * rng.random()
        ref.observe(wall)
        port.observe(wall)
        assert ref.window_seconds() == port.window_seconds()
        assert ref.snapshot() == port.snapshot()
    with pytest.raises(ValueError):
        BatchWindowTuner(floor=0.5, ceiling=0.1)


def test_keyring_tokens_and_rotation_equal():
    ref = JaxKeyring({"k1": b"secret-one", "k0": b"secret-zero"})
    port = SessionKeyring({"k1": b"secret-one", "k0": b"secret-zero"})
    assert ref.mint("alice") == port.mint("alice")
    old = port.mint("alice")
    ref.rotate("k2", b"secret-two")
    port.rotate("k2", b"secret-two")
    assert ref.mint("bob") == port.mint("bob")
    for client, token in (("alice", old), ("bob", old), ("alice", "k9.00"), ("alice", None),
                          ("bob", port.mint("bob")), ("alice", "garbage")):
        assert ref.verify(client, token) == port.verify(client, token)
    ref.retire("k0")
    port.retire("k0")
    assert ref.verify("alice", old) == port.verify("alice", old) is False
    assert ref.snapshot() == port.snapshot()


# ---------------------------------------------------------------------------
# the mux over each layout
# ---------------------------------------------------------------------------


def _drive(mux_cls, adm_cls, tuner_cls, session, plans, auth=None):
    """Open a session per doc, then offer every frame round robin: every
    4th submit is followed by a ``pump()`` (which closes the round on its
    window or under backpressure), so the queue crosses its watermark and
    delays and overload sheds come too; a delayed frame is retried on the
    client's next turn, a shed one is not; every 5th committed pump reads
    the patches of one session.  Returns the mux and the record."""
    clock = SteppingClock(step=0.0007)
    mux = mux_cls(session, admission=adm_cls(max_depth=40, high_watermark=0.6,
                                             low_watermark=0.3, session_quota=0.25,
                                             shed_after=2),
                  tuner=tuner_cls(floor=0.05, ceiling=0.2, window=16), clock=clock,
                  host="h1", auth=auth, degrade_after=64)
    record = []
    sids = []
    for d in range(len(plans)):
        token = auth.mint(f"c{d}") if auth is not None else None
        sid, v = mux.open_session(f"c{d}", token=token)
        record.append(("open", sid, v.to_json()))
        sids.append(sid)
    queues = {sid: list(plan) for sid, plan in zip(sids, plans)}
    pumps = submits = 0
    while any(queues.values()):
        for sid in sids:
            if not queues[sid]:
                continue
            v = mux.submit(sid, queues[sid][0])
            record.append((sid, v.to_json()))
            if v.kind != DELAY:
                queues[sid].pop(0)
            submits += 1
            if submits % 4 == 0 and mux.pump():
                pumps += 1
                if pumps % 5 == 0:
                    reader = sids[pumps % len(sids)]
                    record.append(("patches", reader, mux.patches(reader)))
    record.append(("flush", mux.flush()))
    return mux, record


@pytest.fixture(scope="module", params=LAYOUTS)
def driven(request, plans):
    ref_s, port_s = sessions(layout=request.param)
    ref = _drive(JaxMux, JaxAdmission, JaxTuner, ref_s, plans)
    port = _drive(SessionMux, AdmissionController, BatchWindowTuner, port_s, plans)
    return request.param, ref, port


def test_mux_verdicts_and_patch_streams_equal(driven):
    _, (ref, ref_rec), (port, port_rec) = driven
    assert ref_rec == port_rec
    kinds = {v["kind"] for entry in port_rec if isinstance(entry[0], int)
             for v in [entry[1]] if isinstance(v, dict)}
    assert ADMIT in kinds and DELAY in kinds and SHED in kinds  # every verdict kind ran
    for sid in sorted(port.sessions()):
        assert ref.patches(sid) == port.patches(sid)
        assert ref.read(sid) == port.read(sid)


def test_mux_snapshot_and_session_equal(driven):
    layout, (ref, _), (port, _) = driven
    snap = port.snapshot()
    assert ref.snapshot() == snap
    assert snap["layout"] == layout and ("page_pool" in snap) == (layout != "padded")
    json.dumps(snap)
    assert port.session.digest() == ref.session.digest()
    assert port.session.digest(full=False) == ref.session.digest(full=False)
    assert port.session.read_all() == ref.session.read_all()
    assert not port.session.quarantined() and not ref.session.quarantined()
    stats = port.admission.stats
    assert stats.submitted == stats.admitted + stats.delayed + stats.shed


def test_mux_equals_a_plain_session(driven, plans):
    """What the mux admitted, fed straight to a plain session of the same
    layout, gives the same documents."""
    layout, _, (port, record) = driven
    _, plain = sessions(layout=layout)
    sent = {sid: [] for sid in port.sessions()}
    queues = {sid: list(plan) for sid, plan in zip(sorted(port.sessions()), plans)}
    for entry in record:
        if isinstance(entry[0], int) and isinstance(entry[1], dict):
            sid, v = entry
            if v["kind"] == ADMIT:
                sent[sid].append(queues[sid][0])
            if v["kind"] != DELAY:
                queues[sid].pop(0)
    plain.ingest_frames([(port.sessions()[sid].doc_index, f)
                         for sid in sorted(sent) for f in sent[sid]])
    plain.drain()
    assert plain.read_all() == port.session.read_all()
    assert plain.digest() == port.session.digest()


def test_auth_mux_sheds_unauthorized_equal(plans):
    ref_s, port_s = sessions(num_docs=2)
    ring = dict(keys={"k1": b"s1"})
    ref = JaxMux(ref_s, auth=JaxKeyring(**ring), auth_per_frame=True, clock=SteppingClock(0.001))
    port = SessionMux(port_s, auth=SessionKeyring(**ring), auth_per_frame=True,
                      clock=SteppingClock(0.001))
    out = []
    for mux in (ref, port):
        good = mux.auth.mint("alice")
        rec = [mux.open_session("alice", token="k1.bad")[1].to_json(),
               mux.open_session("alice", token=good)[1].to_json()]
        rec.append(mux.submit(0, plans[0][0], token=None).to_json())
        rec.append(mux.submit(0, plans[0][0], token=good).to_json())
        mux.flush()
        rec.append(mux.snapshot())
        rec.append(mux.read(0))
        out.append(rec)
    assert out[0] == out[1]
    assert out[1][0]["reason"] == "unauthorized" and out[1][3]["kind"] == ADMIT


def test_quota_degradation_ladder_equal(plans):
    """Sustained quota sheds demote the hot session's doc to scalar replay
    in both packages, at the same submission, with the same reads after."""
    out = []
    ref_s, port_s = sessions(num_docs=2)
    for mux_cls, adm_cls, session in ((JaxMux, JaxAdmission, ref_s),
                                      (SessionMux, AdmissionController, port_s)):
        mux = mux_cls(session, admission=adm_cls(max_depth=8, session_quota=0.25),
                      degrade_after=3, clock=SteppingClock(0.001))
        hot, _ = mux.open_session("hot")
        frames = plans[0]
        rec = []
        for i in range(16):
            rec.append(mux.submit(hot, frames[i % len(frames)]).to_json())
            if mux.sessions()[hot].degraded:
                break
        rec.append(mux.sessions()[hot].to_json())
        rec.append(bool(mux.session.docs[0].fallback))
        rec.append({d: (r.reason, r.detail) for d, r in mux.session.quarantined().items()})
        for f in frames:
            rec.append(mux.submit(hot, f).to_json())
        mux.flush()
        rec.append(mux.read(hot))
        rec.append(mux.snapshot())
        out.append(rec)
    assert out[0] == out[1]
    state = next(e for e in out[1] if isinstance(e, dict) and "degraded" in e)
    assert state["degraded"] is True and out[1][-1]["degraded_docs"] == 1


class _DeviceSession:
    """What the quota ladder touches of a session, on a named device."""

    num_docs = 2
    recorder = None

    def __init__(self, device):
        self.device = torch.device(device)
        self.demoted, self.ingested = [], []

    def force_fallback(self, d, reason, detail=""):
        self.demoted.append((d, reason))

    def ingest_frame(self, d, frame, on_corrupt="raise"):
        self.ingested.append((d, frame))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_quota_ladder_demotes_only_on_the_cpu(device):
    """The device-type rule: sustained quota sheds demote the doc of a
    session on the CPU; on any other device they stay sheds, nothing is
    demoted, and each shed past the threshold is counted."""
    session, counters = _DeviceSession(device), Counters()
    mux = SessionMux(session, admission=AdmissionController(max_depth=8, session_quota=0.25),
                     degrade_after=3, clock=SteppingClock(0.001), counters=counters)
    hot, _ = mux.open_session("hot")
    verdicts = [mux.submit(hot, b"frame-%d" % i) for i in range(12)]
    quota_sheds = [v.kind == SHED and v.reason == SHED_SESSION_QUOTA for v in verdicts]
    assert quota_sheds[:5] == [False, False, True, True, True]
    state = mux.sessions()[hot]
    if device == "cpu":
        assert session.demoted == [(0, "capacity")] and state.degraded
        assert mux.degraded_docs == 1 and counters.get("serve.degraded_sessions") == 1
        assert all(v.kind == ADMIT for v in verdicts[5:])  # demoted: ingested at once
        assert [f for _, f in session.ingested] == [b"frame-%d" % i for i in range(5, 12)]
        assert counters.get("serve.degrade_refused_on_device") == 0
    else:
        assert session.demoted == [] and not state.degraded and mux.degraded_docs == 0
        assert all(quota_sheds[2:]) and session.ingested == []
        assert state.quota_shed_streak == 10
        assert counters.get("serve.degrade_refused_on_device") == 10 - 3 + 1
        assert counters.get("serve.degraded_sessions") == 0


def test_corrupt_frame_quarantine_equal(plans):
    ref_s, port_s = sessions(num_docs=2)
    out = []
    for mux in (JaxMux(ref_s, clock=SteppingClock(0.001)),
                SessionMux(port_s, clock=SteppingClock(0.001))):
        sid, _ = mux.open_session("a")
        good = plans[0][0]
        v = mux.submit(sid, good[:-3] + b"\xff\xff\xff")
        mux.flush()  # never raises out of the serving loop
        q = mux.session.quarantined()
        out.append((v.to_json(), {d: (r.reason, r.detail) for d, r in q.items()},
                    mux.snapshot()))
    assert out[0] == out[1]
    assert out[1][1][0][0] == "decode"


# ---------------------------------------------------------------------------
# open-loop traffic
# ---------------------------------------------------------------------------


def test_build_arrivals_equal(plans):
    frames = {sid: plan for sid, plan in enumerate(plans)}
    for rate, duration in ((10, 1.0), (400, 0.05), (3000, 0.5)):
        assert build_arrivals(frames, rate, duration) == jax_build_arrivals(frames, rate, duration)
    assert build_arrivals({}, 5, 1.0) == []
    with pytest.raises(ValueError):
        build_arrivals(frames, 0, 1.0)


def _open_loop(mux_cls, run, session, plans, armed=False):
    clock = FakeClock()
    mux = mux_cls(session, clock=clock, host="h2",
                  tuner=(JaxTuner if mux_cls is JaxMux else BatchWindowTuner)(floor=0.004))
    if armed:
        mux.latency_plane = LatencyPlane().enable()
    frames = {}
    for d in range(len(plans)):
        sid, _ = mux.open_session(f"c{d}")
        frames[sid] = plans[d]
    arrivals = (jax_build_arrivals if mux_cls is JaxMux else build_arrivals)(frames, 800, 0.2)
    res = run(mux, arrivals, clock=clock, sleep=clock.nap, read_every=3 if armed else 0)
    return mux, res


def test_run_open_loop_accounting_equal(plans):
    ref_s, port_s = sessions()
    ref_mux, ref = _open_loop(JaxMux, jax_run_open_loop, ref_s, plans)
    port_mux, port = _open_loop(SessionMux, run_open_loop, port_s, plans)
    assert ref.to_json() == port.to_json()
    assert port.accounted() and port.applied == port.admitted
    assert ref_mux.snapshot() == port_mux.snapshot()
    assert ref_mux.session.digest() == port_mux.session.digest()


def test_open_loop_offers_its_waits_to_the_session(plans, monkeypatch):
    """The open loop offers each wait before the next arrival (800/s: 1.25
    ms apart) to the session's graph captures, cut to what is left of the
    mux's open window; the accounting equals the reference's all the
    same."""
    ref_s, port_s = sessions()
    offers = []
    real_idle = port_s.idle

    def idle(budget_s):
        offers.append(budget_s)
        return real_idle(budget_s)

    monkeypatch.setattr(port_s, "idle", idle)
    _, ref = _open_loop(JaxMux, jax_run_open_loop, ref_s, plans)
    mux, port = _open_loop(SessionMux, run_open_loop, port_s, plans)
    assert ref.to_json() == port.to_json()
    assert offers and all(0 < b <= 1 / 800 + 1e-9 for b in offers)
    assert min(offers) < 1 / 800  # a window closing before the next arrival cuts one
    assert port_s._graphs._deferring  # repeated signatures now wait for idle captures
    clock = mux.clock
    mux._window_opened = clock() - mux.window_seconds()
    offers.clear()
    assert mux.idle(1.0) == 0 and offers == []  # an expired window offers nothing


def test_traced_open_loop_is_sum_consistent(plans):
    """With the latency plane armed and ``read_every`` set, every sampled
    record's stages are nonnegative and sum to its total; the visibility
    stage is filled by the reads."""
    _, port_s = sessions()
    mux, res = _open_loop(SessionMux, run_open_loop, port_s, plans, armed=True)
    lat = res.latency
    assert lat is not None and lat["records"] > 0 and lat["sum_consistent"]
    assert set(lat["stages_ms"]) == {"admit", "window", "stage", "dispatch", "commit",
                                     "visibility"}
    assert all(v >= 0 for v in lat["stages_ms"].values())
    assert check_sum_consistency(mux.latency_plane.last)
    assert mux.latency_plane.snapshot()["pending_visibility"] == 0


def test_sustained_ladder_equal(plans):
    """The ladder against a tiny queue: the second rung breaks by typed
    verdicts and the sweep stops there, in both packages alike."""
    out = []
    for mux_cls, adm_cls, tuner_cls, ladder, pair_index in (
            (JaxMux, JaxAdmission, JaxTuner, jax_sustained_ladder, 0),
            (SessionMux, AdmissionController, BatchWindowTuner, sustained_ladder, 1)):
        clock = FakeClock()

        def factory():
            mux = mux_cls(sessions(num_docs=2)[pair_index], clock=clock,
                          tuner=tuner_cls(floor=0.004),
                          admission=adm_cls(max_depth=4, high_watermark=0.5, low_watermark=0.25,
                                            shed_after=2, session_quota=None))
            frames = {}
            for doc in range(2):
                sid, _ = mux.open_session(f"c{doc}")
                frames[sid] = plans[doc]
            return mux, frames

        rungs, best = ladder(factory, rates=[20.0, 20000.0, 40000.0], slo_p99_s=30.0,
                             duration_s=0.05, clock=clock, sleep=clock.nap)
        out.append(([r.to_json() for r in rungs], best.to_json() if best else None))
    assert out[0] == out[1]
    rungs = out[1][0]
    assert len(rungs) == 2 and rungs[0]["sustained"] and not rungs[1]["sustained"]
