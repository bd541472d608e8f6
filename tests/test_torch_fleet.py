"""The port's fleet tier (``serve/fleet.py``) and its transport
(``parallel/multihost.py``, ``gossip.py``, ``lease.py``, ``router.py``,
``anti_entropy.py``, ``obs/convergence.py``) against the reference
package's, on the CPU.

* ``HeartbeatLedger``, ``FleetRouter``, ``GossipScheduler``,
  ``ConvergenceMonitor``, ``change_digest`` / ``ChangeStore.digest`` /
  ``sync``: the same seeded event sequences through both packages give the
  same verdicts, plans, raised errors and snapshots.
* The wire, over loopback, both ways: a port ``ReplicaServer`` syncing with
  a reference one and back, ``ship_frames`` from each package to the
  other's ship endpoint, and a multi-frame change backlog (``M`` messages)
  decoded by the other side over a socket pair.
* ``FleetFrontend`` in-process (``transport=False``): 3 hosts x 8 docs x 48
  ops (the reference's ``fleet_serve`` shape), a digest-checked migration, a
  forced cutover digest mismatch that rolls back, a rebalance, and a host
  kill with lease detection, failover and client retries.  Verdicts,
  ``stats``, ``snapshot()``, every ``doc_digest`` and the fleet-wide digest
  equal the reference frontend's.

Socket tests bind port 0 on 127.0.0.1, take the address ``start()``
returns, give every socket and join a timeout, and read no clock after
``stop()``.
"""

import random
import socket
import time

import pytest

import peritext_tpu.parallel.codec as jax_codec
import peritext_tpu_torch.parallel.codec as codec
from peritext_tpu.core.doc import Doc as JaxDoc
from peritext_tpu.obs.convergence import ConvergenceMonitor as JaxMonitor
from peritext_tpu.obs.metrics import Counters as JaxCounters
from peritext_tpu.parallel import multihost as jax_mh
from peritext_tpu.parallel.anti_entropy import ChangeStore as JaxStore
from peritext_tpu.parallel.anti_entropy import change_digest as jax_change_digest
from peritext_tpu.parallel.anti_entropy import sync as jax_sync
from peritext_tpu.parallel.causal import causal_sort as jax_causal_sort
from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.parallel.gossip import GossipScheduler as JaxGossip
from peritext_tpu.parallel.lease import HeartbeatLedger as JaxLedger
from peritext_tpu.parallel.router import FleetRouter as JaxRouter
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.serve import AdmissionController as JaxAdmission
from peritext_tpu.serve import CutoverError as JaxCutoverError
from peritext_tpu.serve import FleetFrontend as JaxFrontend
from peritext_tpu.serve import SessionMux as JaxMux
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.core.doc import Doc
from peritext_tpu_torch.core.errors import TransportError
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import ConvergenceMonitor, Counters
from peritext_tpu_torch.parallel import multihost as mh
from peritext_tpu_torch.parallel.anti_entropy import ChangeStore, change_digest, sync
from peritext_tpu_torch.parallel.gossip import GossipScheduler
from peritext_tpu_torch.parallel.lease import HeartbeatLedger
from peritext_tpu_torch.parallel.router import FleetRouter
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.serve import AdmissionController, CutoverError, FleetFrontend, SessionMux

ACTORS = ("doc1", "doc2", "doc3")
TIMEOUT = 10.0


def _port_changes(changes):
    return [Change.from_json(c.to_json()) for c in changes]


def _outcome(res):
    if isinstance(res, BaseException):
        return ("raise", type(res).__name__, str(res))
    return res


# ---------------------------------------------------------------------------
# leases, placement, gossip, convergence
# ---------------------------------------------------------------------------


def _ledger_script(cls, seed):
    rng = random.Random(seed)
    out = []
    with pytest.raises(ValueError):
        cls(0)
    led = cls(rng.randrange(1, 4))
    hosts = [f"h{i}" for i in range(5)]
    for h in hosts[:3]:
        led.track(h)
    for _ in range(40):
        op = rng.random()
        if op < 0.1:
            led.track(rng.choice(hosts))
        elif op < 0.15:
            led.forget(rng.choice(hosts))
        elif op < 0.2:
            led.reset(rng.choice(hosts))
        beats = {h: rng.random() < 0.6 for h in hosts if rng.random() < 0.9}
        out.append((led.tick(beats), led.newly_dead(), led.dead_hosts(), led.hosts(), led.ticks))
    out.append(led.snapshot())
    out.extend((h, led.verdict(h), led.lease(h).to_json()) for h in led.hosts())
    return out


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_ledger_equal(seed):
    assert _ledger_script(HeartbeatLedger, seed) == _ledger_script(JaxLedger, seed)


def _router_script(cls, seed):
    rng = random.Random(seed)
    r = cls(lag_weight=rng.randrange(0, 3))
    out, hosts, docs = [], [], []

    def call(name, *args, **kw):
        try:
            res = getattr(r, name)(*args, **kw)
        except (ValueError, KeyError) as exc:
            res = exc
        out.append((name, args, sorted(kw.items()), _outcome(res), r.snapshot(), r.placement()))
        return res

    for i in range(4):
        call("add_host", f"h{i}", rng.randrange(2, 8))
        hosts.append(f"h{i}")
    call("add_host", "h0", 3)
    call("add_host", "hx", 0)
    for _ in range(90):
        op = rng.randrange(12)
        doc = rng.choice(docs) if docs else "d-none"
        host = rng.choice(hosts)
        if op <= 2:
            docs.append(f"d{len(docs)}")
            call("place", docs[-1], rng.randrange(1, 5), rng.random() < 0.2)
        elif op == 3:
            call("observe", host, slot_load=rng.randrange(0, 20),
                 host_bound_load=rng.randrange(0, 5), lag_ops=rng.randrange(0, 4),
                 page_load=rng.choice([None, rng.randrange(0, 9)]))
        elif op == 4:
            call("move", doc, host)
        elif op == 5:
            plan = call("evacuate", host)
            if isinstance(plan, list) and rng.random() < 0.5:
                call("rollback_moves", plan)
            call("set_draining", host, False)
        elif op == 6:
            plan = call("rebalance", rng.randrange(1, 6))
            if plan and rng.random() < 0.3:
                call("rollback_moves", plan)
        elif op == 7:
            call("fail_host", host)
            call("remove_host", host)
            call("add_host", host, rng.randrange(2, 8))
        elif op == 8:
            call("release", doc)
        elif op == 9:
            call("mark_host_bound", doc, rng.random() < 0.6)
        elif op == 10:
            call("set_draining", host, rng.random() < 0.5)
        else:
            out.append(("host_of", r.host_of(doc), r.hosts()))
    out.append((r.snapshot(), {h: r.host(h).to_json() for h in r.hosts()}))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_fleet_router_equal(seed):
    mine, theirs = _router_script(FleetRouter, seed), _router_script(JaxRouter, seed)
    assert mine == theirs
    assert any(o[3][0] == "raise" for o in mine if len(o) == 6 and isinstance(o[3], tuple))


class _ScriptedServer:
    """A ReplicaServer stand-in for the gossip scheduler: each sync either
    succeeds after observing a frontier some ops ahead, or fails."""

    def __init__(self, monitor, outcome_cls, seed):
        self.monitor = monitor
        self.outcome_cls = outcome_cls
        self.rng = random.Random(seed)

    def try_sync_with(self, host, port, retry=None, peer_name=None):
        behind = self.rng.randrange(0, 40)
        self.monitor.observe_frontier(peer_name, {"a": 3}, {"a": 3 + behind, "b": port % 7})
        if self.rng.random() < 0.65:
            self.monitor.observe_success(peer_name, pulled=behind, pushed=1)
            return self.outcome_cls(pulled=behind, pushed=1)
        self.monitor.observe_failure(peer_name, error="refused")
        return self.outcome_cls(ok=False, error="refused")


def _gossip_script(sched_cls, monitor_cls, counters_cls, outcome_cls, seed):
    monitor = monitor_cls(host="me", counters=counters_cls())
    sched = sched_cls(_ScriptedServer(monitor, outcome_cls, seed),
                      peers=[("10.0.0.1", 7000 + i) for i in range(3)], backoff_cap=4)
    out = [sched.add_peer("10.0.0.9", 7100, name="gateway"), sched.peers()]
    rng = random.Random(seed + 1)
    for i in range(14):
        if i == 6:
            out.append(sched.remove_peer("10.0.0.1:7001"))
        if i == 9:
            sched.wake()
        if i == 11:
            sched.wake("gateway")
        out.append(sched.plan())
        res = sched.round()
        out.append([(n, o.ok, o.pulled, o.pushed, o.error, o.behind) for n, o in res])
        out.append((sched.snapshot(), sched.last_round_order, rng.random()))
    out.append(sched.drain(max_rounds=6))
    out.append((monitor.snapshot(), monitor.counters.snapshot()))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_gossip_scheduler_equal(seed):
    mine = _gossip_script(GossipScheduler, ConvergenceMonitor, Counters, mh.SyncOutcome, seed)
    theirs = _gossip_script(JaxGossip, JaxMonitor, JaxCounters, jax_mh.SyncOutcome, seed)
    assert mine == theirs


def _monitor_script(monitor_cls, counters_cls, seed):
    rng = random.Random(seed)
    m = monitor_cls(host="h", counters=counters_cls())
    peers = ["p0", "p1", "p2", "p3"]
    out = []
    for _ in range(60):
        op, peer = rng.randrange(5), rng.choice(peers)
        if op == 0:
            out.append(m.advance_round())
        elif op == 1:
            local = {a: rng.randrange(0, 5) for a in "abc" if rng.random() < 0.8}
            remote = dict(local) if rng.random() < 0.4 else \
                {a: rng.randrange(0, 5) for a in "abcd" if rng.random() < 0.8}
            digests = (rng.randrange(4), rng.randrange(4)) if rng.random() < 0.7 else (None, None)
            out.append(m.observe_frontier(peer, local, remote, *digests))
        elif op == 2:
            m.observe_success(peer, pulled=rng.randrange(3), pushed=rng.randrange(3))
        elif op == 3:
            m.observe_failure(peer, error=rng.choice([None, "timeout"]))
        else:
            out.append((m.behindness(peer), m.total_lag_ops(), m.divergent_peers()))
    out.append((m.snapshot(), m.counters.snapshot(),
                {k: v.to_json(m.rounds) for k, v in m.peers().items()},
                [(i.peer, i.round, i.local_digest, i.peer_digest, i.clock_size)
                 for i in m.divergence_incidents]))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_convergence_monitor_equal(seed):
    mine = _monitor_script(ConvergenceMonitor, Counters, seed)
    assert mine == _monitor_script(JaxMonitor, JaxCounters, seed)
    assert mine[-1][0]["divergence_incidents"] > 0


@pytest.fixture(scope="module")
def workload_changes():
    """(reference changes, port changes) of one fuzz workload, each in one
    causal order."""
    w = generate_workload(7, num_docs=1, ops_per_doc=60)[0]
    changes = jax_causal_sort([ch for log in w.values() for ch in log], {})
    return changes, _port_changes(changes)


def test_change_digest_store_digest_and_sync_equal(workload_changes):
    ref_changes, changes = workload_changes
    assert [change_digest(c) for c in changes] == [jax_change_digest(c) for c in ref_changes]
    ref_store, store = JaxStore(), ChangeStore()
    for c in sorted(ref_changes, key=lambda c: (c.actor, c.seq)):
        ref_store.append(c)
    for c in sorted(changes, key=lambda c: (c.actor, c.seq)):
        store.append(c)
    assert store.clock() == ref_store.clock()
    assert store.digest() == ref_store.digest()
    rng = random.Random(3)
    for _ in range(8):
        clock = {a: rng.randrange(0, n + 2) for a, n in store.clock().items()}
        assert store.digest(clock) == ref_store.digest(clock)
    n = len(changes)
    for a, b in ((n // 3, 2 * n // 3), (n, n // 4)):
        out = []
        for doc_cls, chs, st, mon_cls, cnt_cls, sync_fn in (
                (JaxDoc, ref_changes, ref_store, JaxMonitor, JaxCounters, jax_sync),
                (Doc, changes, store, ConvergenceMonitor, Counters, sync)):
            left, right = doc_cls("left"), doc_cls("right")
            for c in chs[:a]:
                left.apply_change(c)
            for c in chs[:b]:
                right.apply_change(c)
            mon = mon_cls(host="local", counters=cnt_cls())
            patches = sync_fn(left, right, st, monitor=mon)
            out.append((patches, left.clock, right.clock, mon.snapshot(),
                        left.get_text_with_formatting(["text"]) ==
                        right.get_text_with_formatting(["text"])))
        assert out[0] == out[1]
        assert out[1][-1] and out[1][1] == out[1][2]


# ---------------------------------------------------------------------------
# the wire, both ways
# ---------------------------------------------------------------------------


def _wait_for(cond, polls=1000):
    """Poll ``cond`` every 10 ms, at most ``polls`` times (a handler thread
    finishing its merge); counts polls, reads no clock."""
    for _ in range(polls):
        if cond():
            return
        time.sleep(0.01)
    assert cond()


def _stores(changes, store_cls, actors):
    store = store_cls()
    for c in sorted(changes, key=lambda c: (c.actor, c.seq)):
        if c.actor in actors:
            store.append(c)
    return store


def test_replica_servers_sync_both_ways(workload_changes):
    ref_changes, changes = workload_changes
    port_store = _stores(changes, ChangeStore, {"doc1"})
    ref_store = _stores(ref_changes, JaxStore, {"doc2", "doc3"})
    port_frames, ref_frames = [], []
    port = mh.ReplicaServer(port_store, host="127.0.0.1", port=0, timeout=TIMEOUT,
                            on_frame=port_frames.append)
    ref = jax_mh.ReplicaServer(ref_store, host="127.0.0.1", port=0, timeout=TIMEOUT,
                               on_frame=ref_frames.append)
    try:
        port_addr, ref_addr = port.start(), ref.start()
        pulled, pushed = port.sync_with(*ref_addr, timeout=TIMEOUT)
        assert pulled > 0 and pushed > 0
        # the serving side merges after the client has sent its last message
        _wait_for(lambda: port_store.clock() == ref_store.clock())
        assert port_store.digest() == ref_store.digest()
        assert port_frames and ref_frames
        # the reference side dials the port server: nothing new either way
        assert ref.sync_with(*port_addr, timeout=TIMEOUT) == (0, 0)
        outcome = mh.try_sync_with(ChangeStore(), *ref_addr, retry=mh.RetryPolicy(
            attempts=1, timeout=TIMEOUT))
        assert outcome.ok and outcome.pulled == len(changes)
    finally:
        port.stop()
        ref.stop()
    peer = f"{ref_addr[0]}:{ref_addr[1]}"
    assert port.monitor.snapshot()["peers"][peer]["last_outcome"] == "converged"
    assert port.monitor.snapshot()["total_lag_ops"] == 0


def test_ship_frames_both_ways(workload_changes):
    ref_changes, _ = workload_changes
    frames = [jax_encode_frame(ref_changes[i:i + 6]) for i in range(0, 30, 6)]
    got = {"port": [], "ref": []}

    def receiver(side):
        def on_ship(doc_key, fs, base):
            got[side].append((doc_key, fs, base))
            return base + len(fs)
        return on_ship

    port = mh.ReplicaServer(ChangeStore(), host="127.0.0.1", port=0, timeout=TIMEOUT,
                            on_ship=receiver("port"))
    ref = jax_mh.ReplicaServer(JaxStore(), host="127.0.0.1", port=0, timeout=TIMEOUT,
                               on_ship=receiver("ref"))
    ref_plain = jax_mh.ReplicaServer(JaxStore(), host="127.0.0.1", port=0, timeout=TIMEOUT)
    try:
        port_addr, ref_addr = port.start(), ref.start()
        policy = mh.RetryPolicy(attempts=2, base_delay=0.01, timeout=TIMEOUT)
        assert mh.ship_frames(*ref_addr, "doc-a", frames, base=2, retry=policy) == 7
        assert jax_mh.ship_frames(*port_addr, "doc-b", frames[:3], timeout=TIMEOUT) == 3
        # a server without a ship handler refuses the kind loudly
        with pytest.raises(TransportError):
            mh.ship_frames(*ref_plain.start(), "doc-c", frames,
                           retry=mh.RetryPolicy(attempts=1, timeout=TIMEOUT))
    finally:
        port.stop()
        ref.stop()
        ref_plain.stop()
    assert got == {"ref": [("doc-a", frames, 2)], "port": [("doc-b", frames[:3], 0)]}


@pytest.mark.parametrize("sender", ["port", "reference"])
def test_multi_frame_backlog_crosses(workload_changes, monkeypatch, sender):
    """A backlog past one frame's charge rides ``M`` (session-scoped chunks);
    the other package decodes it to the same changes and v2 frames."""
    ref_changes, changes = workload_changes
    monkeypatch.setattr(codec, "_ENCODE_CHUNK_CHARGE", 40)
    monkeypatch.setattr(jax_codec, "_ENCODE_CHUNK_CHARGE", 40)
    send, recv = (mh, jax_mh) if sender == "port" else (jax_mh, mh)
    a, b = socket.socketpair()
    a.settimeout(TIMEOUT)
    b.settimeout(TIMEOUT)
    with a, b:
        send._send_changes(a, changes if sender == "port" else ref_changes)
        got, frames, ctx = recv._recv_changes(b)
    assert ctx is None and len(frames) > 1
    assert [c.to_json() for c in got] == [c.to_json() for c in ref_changes]
    assert b"".join(frames) == b"".join(
        jax_encode_frame(jax_codec.decode_frame(f)) for f in frames)


def test_replica_server_refuses_unported_mounts():
    """The metrics mounts are ported now (the test keeps its name): each
    mounts a metrics server on an ephemeral port; ``serve=``/``fleet=``
    without ``metrics_port`` mount nothing, as in the reference."""
    for kw in ({"metrics_port": 0}, {"metrics_port": 0, "serve": object()},
               {"metrics_port": 0, "fleet": object()}):
        server = mh.ReplicaServer(ChangeStore(), **kw)
        try:
            routes = server.metrics._httpd._routes
            assert {"/metrics", "/devprof.json", "/convergence.json"} <= set(routes)
            assert ("/serve.json" in routes) == ("serve" in kw)
            assert ("/fleet.json" in routes) == ("fleet" in kw)
        finally:
            server.stop()
    for kw in ({"serve": object()}, {"fleet": object()}):
        server = mh.ReplicaServer(ChangeStore(), **kw)
        assert server.metrics is None and server.metrics_address is None
        server.stop()
    from peritext_tpu_torch.obs import IncidentMonitor

    monitor = IncidentMonitor(host="h")
    server = mh.ReplicaServer(ChangeStore(), host="127.0.0.1", port=0, incidents=monitor)
    try:
        assert server.incidents is monitor
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# FleetFrontend in-process
# ---------------------------------------------------------------------------

DOCS, OPS, HOSTS = 8, 48, 3


class _SteppingClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        v = self.t
        self.t += 0.0013
        return v


def _fleet_plans(seed=31):
    rng = random.Random(seed)
    plans = {}
    for d, w in enumerate(generate_workload(seed, num_docs=DOCS, ops_per_doc=OPS)):
        changes = [ch for log in sorted(w) for ch in w[log]]
        rng.shuffle(changes)
        chunk = rng.randrange(4, 8)
        plans[f"doc{d}"] = [jax_encode_frame(changes[i:i + chunk])
                            for i in range(0, len(changes), chunk)]
    return plans


def _drive_fleet(fe_cls, mux_cls, adm_cls, sess_factory, plans):
    """The fleet episode, the same calls for both packages: traffic in
    round-robin passes with one frontend round each; a migration, a forced
    cutover mismatch (rolled back), a rebalance, then a host kill; lease
    detection, failover, retries until every frame is admitted, a flush."""
    fe = fe_cls(lease_rounds=2, checkpoint_every=2)
    for i in range(HOSTS):
        fe.add_host(f"host{i}", mux_cls(sess_factory(), admission=adm_cls(
            max_depth=128, session_quota=None), clock=_SteppingClock()))
    rec = [fe.open_doc(k, f"client{k}").to_json() for k in sorted(plans)]
    pending = {k: list(v) for k, v in plans.items()}
    passes = 0
    while any(pending.values()):
        for k in sorted(pending):
            if pending[k]:
                v = fe.submit(k, pending[k][0])
                rec.append((k, v.kind, v.reason))
                if v.kind == "admit":
                    pending[k].pop(0)
        rec.append(fe.round())
        passes += 1
        if passes == 2:
            to = sorted(h for h in fe.hosts if h != fe._serving["doc0"])[0]
            fe.migrate("doc0", to)
            rec.append(("migrated", fe._serving["doc0"]))
        if passes == 3:
            to = sorted(h for h in fe.hosts if h != fe._serving["doc1"])[0]
            host = fe.hosts[to]
            honest = host.doc_digest
            host.doc_digest = lambda key: honest(key) ^ (1 if key == "doc1" else 0)
            try:
                fe.migrate("doc1", to)
                rec.append("cutover passed")
            except (CutoverError, JaxCutoverError) as exc:
                rec.append(("rolled back", type(exc).__name__, fe._serving["doc1"],
                            fe.router.host_of("doc1")))
            del host.doc_digest
        if passes == 4:
            rec.append(("rebalance", fe.rebalance(max_moves=2)))
        if passes == 5:
            load = {}
            for key, h in fe._serving.items():
                load[h] = load.get(h, 0) + 1
            victim = max(sorted(load), key=lambda h: load[h])
            fe.hosts[victim].kill()
            rec.append(("killed", victim))
        assert passes < 200
    while not fe.ledger.dead_hosts():
        rec.append(fe.round())
    fe.flush()
    digests = {k: fe.doc_digest(k) for k in sorted(plans)}
    return fe, rec, digests


@pytest.fixture(scope="module")
def fleets():
    plans = _fleet_plans()
    kw = dict(num_docs=12, actors=ACTORS, slot_capacity=max(256, 4 * OPS),
              mark_capacity=max(64, OPS), tomb_capacity=max(128, OPS),
              round_insert_capacity=128, round_delete_capacity=64, round_mark_capacity=64,
              static_rounds=True)
    refs = []

    def ref_session():
        refs.append(JaxStreamingMerge(**kw))
        return refs[-1]

    ref = _drive_fleet(JaxFrontend, JaxMux, JaxAdmission, ref_session, plans)
    port = _drive_fleet(FleetFrontend, SessionMux, AdmissionController,
                        lambda: StreamingMerge(**kw, device="cpu"), plans)
    yield plans, ref, port
    for sess in refs:
        stager = getattr(sess, "_stager", None)
        if stager is not None:
            thread = stager._thread
            stager.close()
            if thread is not None:
                thread.join(timeout=30)


def test_fleet_verdicts_and_stats_equal(fleets):
    _, (ref, ref_rec, _), (port, rec, _) = fleets
    assert rec == ref_rec
    kinds = {entry[1] for entry in rec if isinstance(entry, tuple) and len(entry) == 3}
    assert kinds == {"admit", "delay"}
    assert any(isinstance(e, tuple) and e[:2] == ("rolled back", "CutoverError") for e in rec)
    assert port.stats.to_json() == ref.stats.to_json()
    assert port.stats.accounted()
    assert (port.failovers, port.failover_docs, port.migrations, port.migration_rollbacks) == \
        (ref.failovers, ref.failover_docs, ref.migrations, ref.migration_rollbacks)
    assert port.failovers == 1 and port.migrations >= 1 and port.migration_rollbacks == 1


def test_fleet_snapshot_and_digests_equal(fleets):
    plans, (ref, _, ref_digests), (port, _, digests) = fleets
    assert port.snapshot() == ref.snapshot()
    assert digests == ref_digests
    clean = StreamingMerge(num_docs=DOCS, actors=ACTORS, slot_capacity=256, mark_capacity=64,
                           tomb_capacity=128, round_insert_capacity=128,
                           round_delete_capacity=64, round_mark_capacity=64, static_rounds=True,
                           device="cpu")
    for d, key in enumerate(sorted(plans, key=lambda k: int(k[3:]))):
        for f in plans[key]:
            clean.ingest_frame(d, f)
    clean.drain()
    total = 0
    for d, key in enumerate(sorted(plans, key=lambda k: int(k[3:]))):
        assert digests[key] == clean.doc_digest(d)
        total = (total + digests[key]) & 0xFFFFFFFF
    assert total == clean.digest()
