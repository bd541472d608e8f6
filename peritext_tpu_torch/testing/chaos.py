"""Chaos harness: every fault class composed against the byte-equality oracle.

One :func:`run_chaos` campaign drives a supervised streaming session
(:class:`~..parallel.supervisor.GuardedSession`) through the full fault
space the fault-domain supervisor exists to absorb, in one seeded run:

* **delivery faults** — per-frame drop / duplicate / reorder
  (:class:`~..parallel.faults.FaultSpec`), repaired by redelivery;
* **payload corruption** — truncated / bit-flipped frames
  (:func:`~..parallel.faults.corrupt_detectably`) against a victim subset of
  docs: the codec must reject them (:class:`DecodeError`), the session must
  quarantine exactly those docs with reason ``decode`` and keep the healthy
  docs converging (per-doc fault isolation, checked mid-run);
* **injected device-round failures** — the supervisor's watchdog/rollback
  path: roll back to the last good checkpoint and replay the journal;
* **scalar degradation** — on some seeds one doc is force-demoted to scalar
  replay mid-run (the ladder's last rung) and must still hash byte-equal;
* **peer stall** — a bound-but-unresponsive TCP peer: the transport's
  socket deadline + bounded retry must surface a ``behind``
  :class:`SyncOutcome`, never a hang, and a real peer must then repair;
* **crash-restore** — the supervised session is dropped mid-run and rebuilt
  from its latest checkpoint, then repaired by overlapping redelivery.

The oracle is BYTE EQUALITY: after a final full anti-entropy repair the
chaos session's convergence digest must equal a fault-free session's digest
bit-for-bit, every doc's spans must equal the scalar oracle's, no doc may
remain decode-quarantined (auto re-admission), and nothing may remain
pending.  Any unhandled exception fails the campaign.

The fleet, serving-tier, reconnect-storm, mid-drain kill and host-kill
episodes below hold the transport, the serving tier and the fleet to their
own oracles, the incident plane's among them.  Every episode that builds a
streaming session takes ``device=`` (default ``cuda``), and a session on
the card raises, never falls back to the CPU.  The injected round failures
are Python exceptions raised before any launch, so they never poison the
card's context.  A supervised session on the card raises
:class:`DeviceRoundError` at the supervisor's last rung where a CPU session
demotes its pending docs; no episode here reaches that rung.
"""

from __future__ import annotations

import json
import random
import socket
import tempfile
import threading
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch

from ..api.batch import _oracle_doc
from ..core.errors import DeviceRoundError
from ..core.types import Change
from ..parallel.codec import encode_frame
from ..parallel.faults import FaultSpec, corrupt_detectably
from ..parallel.streaming import REASON_DECODE, REASON_DEVICE_ROUND
from ..parallel.supervisor import GuardedSession
from .fuzz import _campaign_session, generate_workload

#: the composed fault mix one chaos campaign applies to victim docs
CHAOS_SPEC = FaultSpec(
    drop_p=0.15, dup_p=0.15, reorder=True, truncate_p=0.3, bitflip_p=0.3
)


@dataclass
class ChaosReport:
    """Evidence from one seeded chaos campaign (all oracles already held —
    a violated oracle raises instead of returning)."""

    seed: int
    num_docs: int
    delivered_frames: int = 0
    corrupt_frames: int = 0
    dropped_frames: int = 0
    quarantined_peak: int = 0
    rollbacks: int = 0
    crash_restores: int = 0
    transport_behind: int = 0
    transport_repaired: bool = False
    isolation_checked: bool = False
    scalar_degraded_docs: int = 0
    final_digest: int = 0
    #: flight-recorder JSONL dumps the campaign's faults produced (the
    #: quarantine/rollback auto-dumps plus the campaign-end post-mortem)
    flight_dumps: int = 0

    def to_json(self) -> Dict:
        return asdict(self)


class _StallingPeer:
    """A TCP endpoint that accepts connections into its backlog and never
    speaks: the client's connect and first send succeed, then every recv
    stalls — exactly the peer failure `_recv_exact` used to hang on."""

    def __init__(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.address = self._sock.getsockname()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _chaos_transport_episode(workload, report: ChaosReport) -> None:
    """Peer-stall + repair: a stalled peer must yield a ``behind`` outcome
    within the retry budget (no hang, no exception), and a healthy peer must
    then converge the store."""
    from ..parallel.anti_entropy import ChangeStore
    from ..parallel.multihost import ReplicaServer, RetryPolicy, try_sync_with

    full = ChangeStore()
    for log in workload.values():
        for change in log:
            full.append(change)
    local = ChangeStore()
    policy = RetryPolicy(attempts=2, base_delay=0.01, max_delay=0.05,
                         jitter=0.5, timeout=0.3)

    stalled = _StallingPeer()
    try:
        outcome = try_sync_with(local, *stalled.address, retry=policy)
        assert outcome.behind and not outcome.ok, (
            "stalled peer must surface as a behind frontier"
        )
        report.transport_behind += 1
    finally:
        stalled.close()

    server = ReplicaServer(full, timeout=5.0)
    host, port = server.start()
    try:
        outcome = try_sync_with(local, host, port, retry=policy)
        assert outcome.ok and outcome.pulled > 0
    finally:
        server.stop()
    assert local.clock() == full.clock(), "repair round must converge the store"
    report.transport_repaired = True


def run_chaos(
    seed: int,
    num_docs: int = 6,
    ops_per_doc: int = 40,
    deadline: float = 60.0,
    transport: bool = True,
    crash: bool = True,
    checkpoint_every: int = 4,
    workload_gen=generate_workload,
    device: Optional[Union[str, torch.device]] = None,
) -> ChaosReport:
    """One seeded chaos campaign (see module docstring).  Raises on any
    oracle violation or unhandled fault; returns the evidence report.
    ``workload_gen`` selects the workload family (same change-log shape;
    e.g. ``generate_markheavy_workload`` for the editorial-pass family —
    see :func:`run_markheavy_chaos`).  Both sessions run on ``device``."""
    rng = random.Random(seed ^ 0xC4A05)
    report = ChaosReport(seed=seed, num_docs=num_docs)

    workloads = workload_gen(seed, num_docs=num_docs, ops_per_doc=ops_per_doc)
    oracle_docs = [_oracle_doc(w) for w in workloads]

    # fault-free reference session: the byte-equality digest anchor
    clean = _campaign_session(num_docs, ops_per_doc, device=device)
    plans: List[List[bytes]] = []
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        rng.shuffle(changes)
        chunk = rng.randrange(5, 12)
        frames = [
            encode_frame(changes[i:i + chunk])
            for i in range(0, len(changes), chunk)
        ]
        plans.append(frames)
        for f in frames:
            clean.ingest_frame(d, f)
    clean.drain()
    clean_digest = clean.digest()

    # the supervised chaos session
    tmp = tempfile.TemporaryDirectory()
    try:
        from ..obs import FlightRecorder

        factory = lambda: _campaign_session(num_docs, ops_per_doc, device=device)  # noqa: E731
        # unthrottled flight recorder: every fault dumps, so the campaign's
        # post-mortem oracle below can demand the quarantine evidence even
        # across the crash-restore (which discards the in-memory ring)
        recorder = lambda: FlightRecorder(  # noqa: E731
            capacity=1024, dump_dir=Path(tmp.name) / "flight",
            min_dump_interval=0.0,
        )
        guarded = GuardedSession(
            factory, tmp.name, deadline=deadline,
            checkpoint_every=checkpoint_every, recorder=recorder(),
        )
        victims = set(rng.sample(range(num_docs),
                                 max(1, num_docs // 3)))

        # -- faulty delivery pass ------------------------------------------
        device_faults = rng.randrange(1, 3)
        for d, frames in enumerate(plans):
            delivery = []
            for f in frames:
                if rng.random() < CHAOS_SPEC.drop_p:
                    report.dropped_frames += 1
                    continue
                delivery.append(f)
                if rng.random() < CHAOS_SPEC.dup_p:
                    delivery.append(f)
            rng.shuffle(delivery)
            for f in delivery:
                if d in victims:
                    # detectable corruption only — the quarantine path's
                    # whole fault domain; see faults.corrupt_detectably for
                    # why undetectable damage models as clean delivery
                    bad = corrupt_detectably(f, rng, CHAOS_SPEC)
                    if bad is not None:
                        f = bad
                        report.corrupt_frames += 1
                guarded.ingest_frame(d, f)
                report.delivered_frames += 1
                if rng.random() < 0.3:
                    if device_faults and rng.random() < 0.15:
                        guarded.inject_failure(
                            DeviceRoundError("chaos: injected round failure")
                            if rng.random() < 0.5
                            else RuntimeError("chaos: injected device error")
                        )
                        device_faults -= 1
                    guarded.step()
        guarded.drain()
        report.quarantined_peak = max(
            report.quarantined_peak, len(guarded.quarantined())
        )

        # -- per-doc isolation oracle --------------------------------------
        # while >=1 doc sits in quarantine, every healthy doc that received
        # its full frame plan must already equal the oracle
        if report.quarantined_peak:
            quarantined_now = set(guarded.quarantined())
            for d in range(num_docs):
                if d in victims or d in quarantined_now:
                    continue
                # repair healthy docs' dropped frames first (clean redelivery)
                guarded.ingest_frames([(d, f) for f in plans[d]])
            guarded.drain()
            still_quarantined = set(guarded.quarantined())
            for d in range(num_docs):
                if d in victims or d in still_quarantined:
                    continue
                expected = oracle_docs[d].get_text_with_formatting(["text"])
                got = guarded.read(d)
                assert got == expected, (
                    f"seed={seed} doc={d}: healthy doc diverged while "
                    f"{sorted(still_quarantined)} were quarantined"
                )
            report.isolation_checked = bool(still_quarantined)

        # -- scalar-degradation rung (some seeds) --------------------------
        if rng.random() < 0.5:
            victim = rng.randrange(num_docs)
            guarded.session.force_fallback(
                victim, REASON_DEVICE_ROUND, "chaos: forced scalar replay"
            )
            report.scalar_degraded_docs = 1

        # -- peer stall + transport repair ---------------------------------
        if transport:
            _chaos_transport_episode(workloads[rng.randrange(num_docs)], report)

        # -- crash-restore -------------------------------------------------
        if crash:
            guarded.checkpoint()
            # deliver a bit more that the crash will lose
            for d, frames in enumerate(plans):
                if frames and rng.random() < 0.5:
                    guarded.ingest_frame(d, frames[rng.randrange(len(frames))])
            guarded.step()
            old_rollbacks = guarded.rollbacks
            del guarded  # crash: the process state is gone
            guarded = GuardedSession(
                factory, tmp.name, deadline=deadline,
                checkpoint_every=checkpoint_every, recorder=recorder(),
            )
            restored = guarded.manager.latest()
            assert restored is not None
            guarded.adopt_session(restored.session(drain=True))
            guarded.rollbacks = old_rollbacks
            report.crash_restores += 1

        # -- final anti-entropy repair + byte-equality oracle --------------
        for d, frames in enumerate(plans):
            guarded.ingest_frames([(d, f) for f in frames])
        guarded.drain()
        report.rollbacks = guarded.rollbacks

        assert guarded.session.pending_count() == 0, (
            f"seed={seed}: undelivered changes remain after repair"
        )
        decode_q = {
            d: r for d, r in guarded.quarantined().items()
            if r.reason == REASON_DECODE
        }
        assert not decode_q, (
            f"seed={seed}: docs {sorted(decode_q)} still decode-quarantined "
            "after clean redelivery (auto re-admission failed)"
        )
        final = guarded.digest()
        assert final == clean_digest, (
            f"seed={seed}: chaos digest {final:#010x} != fault-free digest "
            f"{clean_digest:#010x}"
        )
        report.final_digest = final
        for d in range(num_docs):
            expected = oracle_docs[d].get_text_with_formatting(["text"])
            got = guarded.read(d)
            assert got == expected, (
                f"seed={seed} doc={d}: spans diverge from oracle after repair"
            )

        # -- flight-recorder oracle ----------------------------------------
        # a campaign that quarantined anything must have produced at least
        # one automatic JSONL dump whose records parse and include the fault
        flight_dir = Path(tmp.name) / "flight"
        auto_dumps = sorted(flight_dir.glob("*.jsonl"))
        final_dump = guarded.recorder.dump(reason="campaign-end")
        records = []
        for dump in auto_dumps + [final_dump]:
            records.extend(
                json.loads(line)
                for line in dump.read_text().splitlines() if line
            )
        if report.corrupt_frames:
            assert auto_dumps, (
                f"seed={seed}: quarantine produced no flight-recorder dump"
            )
            assert any(
                r.get("kind") == "fault" and r.get("reason") == "quarantine"
                for r in records
            ), f"seed={seed}: flight dumps lack the quarantine fault record"
        # campaign-end post-mortem: the ring's spans must reconstruct the
        # recent rounds' stage timeline (guarded rounds + pipeline stages)
        span_names = {r["name"] for r in records if r.get("kind") == "span"}
        assert any(n.startswith("streaming.") for n in span_names) and (
            "supervisor.round" in span_names
        ), f"seed={seed}: flight dump spans missing the round stage timeline"
        report.flight_dumps = len(auto_dumps) + 1
        guarded.close()
    finally:
        tmp.cleanup()
    return report


# ---------------------------------------------------------------------------
# N-host fleet chaos: per-link fault schedules + lag-ordered healing
# ---------------------------------------------------------------------------


class _LinkGate:
    """A DIRECTED TCP gate for one fleet link i→j: host i dials the gate,
    the gate forwards to host j's real replica socket according to its
    current mode.

    * ``open``    — transparent proxy;
    * ``closed``  — accepts and immediately closes (a hard partition: the
      dialer sees a reset/EOF and fails fast);
    * ``rx_only`` — ASYMMETRIC partition: bytes flow dialer→target but the
      target's replies are blackholed.  The target still hears the dialer's
      frontier (how a host keeps learning its lag while unreachable); the
      dialer times out waiting for the response;
    * ``slow``    — transparent but each chunk is delayed ``delay`` seconds
      in both directions (a congested/slow link: exchanges succeed,
      slowly).

    Mode changes apply to NEW connections (each accept snapshots the mode),
    which is exactly a per-round fault schedule's granularity.
    """

    def __init__(self, target: Tuple[str, int], mode: str = "open",
                 delay: float = 0.02) -> None:
        self.target = target
        self.mode = mode
        self.delay = delay
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(16)
        self.address = self._sock.getsockname()
        self._stop = False
        self._links: set = set()  # every bridged socket still open
        self._links_lock = threading.Lock()
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def set_mode(self, mode: str) -> None:
        assert mode in ("open", "closed", "rx_only", "slow"), mode
        self.mode = mode

    def close(self) -> None:
        self._stop = True
        # shutdown() wakes a thread blocked in accept() (close() alone does
        # not on Linux) so the proxy thread exits instead of lingering
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # and the bridges still open: shutdown() wakes their pumps' recv, so
        # no bridge thread outlives the gate
        with self._links_lock:
            links = list(self._links)
        for s in links:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            mode = self.mode
            if mode == "closed":
                conn.close()
                continue
            threading.Thread(
                target=self._bridge, args=(conn, mode), daemon=True
            ).start()

    def _bridge(self, conn: socket.socket, mode: str) -> None:
        try:
            upstream = socket.create_connection(self.target, timeout=5)
        except OSError:
            conn.close()
            return
        with self._links_lock:
            if self._stop:
                conn.close()
                upstream.close()
                return
            self._links.update((conn, upstream))
        delay = self.delay if mode == "slow" else 0.0

        def pump(src: socket.socket, dst: socket.socket,
                 blackhole: bool) -> None:
            try:
                while True:
                    data = src.recv(65536)
                    if not data:
                        break
                    if delay:
                        time.sleep(delay)
                    if not blackhole:
                        dst.sendall(data)
            except OSError:
                pass
            finally:
                # shutdown() first: it wakes the other direction's recv,
                # which close() alone does not on Linux
                for s in (src, dst):
                    with self._links_lock:
                        self._links.discard(s)
                    try:
                        s.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        s.close()
                    except OSError:
                        pass

        up = threading.Thread(
            target=pump, args=(conn, upstream, False), daemon=True
        )
        up.start()
        pump(upstream, conn, mode == "rx_only")
        up.join(timeout=10)


def _fleet_change(actor: str, seq: int) -> "Change":
    """One synthetic map-op change (fast codec path, cheap to mint at fleet
    volumes)."""
    from ..core.opids import ROOT
    from ..core.types import Operation

    return Change(
        actor=actor, seq=seq,
        deps={actor: seq - 1} if seq > 1 else {}, start_op=seq,
        ops=[Operation(action="set", obj=ROOT, opid=(seq, actor),
                       key="n", value=seq)],
    )


def _append_changes(store, actor: str, n: int) -> int:
    start = len(store.log(actor)) + 1
    for seq in range(start, start + n):
        store.append(_fleet_change(actor, seq))
    return n


@dataclass
class FleetReport:
    """Evidence from one N-host fleet partition/heal episode (all oracles
    already held — a violated oracle raises instead of returning)."""

    seed: int
    hosts: int
    partition_rounds: int = 0
    #: host0's per-peer observed lag at heal time (monitor watermarks)
    observed_lag: Dict[str, int] = None
    #: the store-truth lag at the same instant (the acceptance instrument:
    #: monitor numbers must EQUAL these)
    expected_lag: Dict[str, int] = None
    #: host0's first post-heal round order (must follow behind-ness)
    heal_order: List[str] = None
    lag_gauge_seen: bool = False
    heal_rounds: int = 0
    ops_drained: int = 0
    heal_seconds: float = 0.0
    converged: bool = False
    final_digest: int = 0
    divergence_incidents: int = 0

    def to_json(self) -> Dict:
        return asdict(self)


def run_fleet_chaos(
    seed: int,
    hosts: int = 4,
    base_ops: int = 8,
    flap_link: bool = True,
    metrics: bool = True,
) -> FleetReport:
    """One N-host fleet episode: converge a fleet, impose an asymmetric
    partition with per-link fault schedules (host0 can hear inbound
    frontiers but every reply and outbound dial is cut; one healthy link
    flaps; the heal leaves the largest-lag link slow), then heal and assert

    * host0's convergence monitor learned its TRUE per-peer lag (equal to
      the store-derived clock-delta sums) through the partition;
    * ``peritext_convergence_lag_ops`` was visible in host0's ``/metrics``
      during the episode (when ``metrics``);
    * host0's first post-heal gossip round followed behind-ness priority
      (most-behind peer first);
    * the fleet drained to IDENTICAL fleet-wide store digests and clocks.

    Raises on any violation; returns the evidence report."""
    from ..parallel.anti_entropy import ChangeStore
    from ..parallel.gossip import GossipScheduler
    from ..parallel.multihost import ReplicaServer, RetryPolicy

    rng = random.Random(seed ^ 0xF1EE7)
    assert hosts >= 3, "a fleet episode needs at least 3 hosts"
    report = FleetReport(seed=seed, hosts=hosts)
    policy = RetryPolicy(attempts=1, timeout=0.5)

    stores = [ChangeStore() for _ in range(hosts)]
    servers = [
        ReplicaServer(stores[i], timeout=2.0,
                      metrics_port=0 if (metrics and i == 0) else None)
        for i in range(hosts)
    ]
    for s in servers:
        s.start()
    names = [f"{s.address[0]}:{s.address[1]}" for s in servers]
    # one directed gate per ordered pair: host i dials gate[(i, j)]
    gates = {
        (i, j): _LinkGate(servers[j].address)
        for i in range(hosts) for j in range(hosts) if i != j
    }
    scheds = [
        GossipScheduler(servers[i], retry=policy)
        for i in range(hosts)
    ]
    for i in range(hosts):
        for j in range(hosts):
            if i != j:
                scheds[i].add_peer(*gates[(i, j)].address, name=names[j])

    try:
        # -- phase A: converge the healthy fleet ---------------------------
        for i in range(hosts):
            _append_changes(stores[i], f"host{i}", base_ops + i)
        for _ in range(2):
            for sched in scheds:
                sched.round()
        assert all(s.clock() == stores[0].clock() for s in stores), (
            "healthy fleet failed to converge"
        )

        # -- phase B: asymmetric partition + per-link schedules ------------
        # host0: outbound dials cut, inbound replies blackholed (it HEARS
        # every peer's frontier, can repair nothing); peers cut from each
        # other except one flapping 1<->2 link
        for (i, j), gate in gates.items():
            if j == 0:
                gate.set_mode("rx_only")
            else:
                gate.set_mode("closed")
        partition_rounds = 3
        for r in range(partition_rounds):
            if flap_link:
                flap = "open" if r % 2 == 0 else "closed"
                gates[(1, 2)].set_mode(flap)
                gates[(2, 1)].set_mode(flap)
            for j in range(1, hosts):
                _append_changes(
                    stores[j], f"host{j}", 3 + 2 * j + rng.randrange(3)
                )
            _append_changes(stores[0], "host0", 2 + rng.randrange(3))
            for sched in scheds[1:]:
                sched.round()
            scheds[0].round()  # every dial fails: backoff exercised
        report.partition_rounds = partition_rounds
        if flap_link:
            gates[(1, 2)].set_mode("closed")
            gates[(2, 1)].set_mode("closed")
        # final appends DOMINATE the flap cross-merge, so per-peer lags are
        # strictly ordered: host j ends (200 * j) ops ahead of anything a
        # flapped link could have equalized
        for j in range(1, hosts):
            _append_changes(stores[j], f"host{j}", 200 * j)
        for sched in scheds[1:]:
            # one more rx_only dial: host0 hears the FINAL frontiers (wake
            # first — the peers' own backoff would otherwise skip the dial)
            sched.wake()
            sched.round()

        # monitor truth oracle: host0's watermarks == store-derived lag
        from ..obs.convergence import clock_delta_ops

        clock0 = stores[0].clock()
        report.expected_lag = {
            names[j]: clock_delta_ops(clock0, stores[j].clock())
            for j in range(1, hosts)
        }
        peers0 = servers[0].monitor.peers()
        report.observed_lag = {
            names[j]: peers0[names[j]].ops_behind for j in range(1, hosts)
        }
        assert report.observed_lag == report.expected_lag, (
            f"seed={seed}: monitor watermarks {report.observed_lag} != "
            f"store truth {report.expected_lag}"
        )
        assert len(set(report.observed_lag.values())) == hosts - 1, (
            "per-peer lags must be distinct for the priority oracle"
        )

        # the lag gauges are LIVE during the episode
        if metrics:
            import urllib.request

            mh, mp = servers[0].metrics_address
            text = urllib.request.urlopen(
                f"http://{mh}:{mp}/metrics", timeout=5
            ).read().decode()
            gauge_lines = [
                ln for ln in text.splitlines()
                if ln.startswith("peritext_convergence_lag_ops{")
            ]
            assert gauge_lines and any(
                float(ln.rsplit(" ", 1)[1]) > 0 for ln in gauge_lines
            ), "lag gauge absent or all-zero during the partition"
            report.lag_gauge_seen = True

        # -- phase C: heal — most-behind-first drain -----------------------
        for gate in gates.values():
            gate.set_mode("open")
        # the largest-lag link stays SLOW: priority still reaches it first
        gates[(0, hosts - 1)].set_mode("slow")
        t0 = time.perf_counter()
        scheds[0].wake()
        results = scheds[0].round()
        report.heal_order = list(scheds[0].last_round_order)
        expected_order = [
            name for name, _ in sorted(
                report.expected_lag.items(), key=lambda kv: (-kv[1], kv[0])
            )
        ]
        assert report.heal_order == expected_order, (
            f"seed={seed}: heal order {report.heal_order} does not follow "
            f"behind-ness priority {expected_order}"
        )
        assert all(out.ok for _, out in results), (
            f"seed={seed}: healed links still failing: {results}"
        )
        report.ops_drained = sum(out.pulled + out.pushed for _, out in results)
        # remaining hosts drain (host0's round already fanned most of it)
        rounds = 1
        for _ in range(8):
            if all(s.clock() == stores[0].clock() for s in stores):
                break
            for sched in scheds[1:]:
                sched.wake()
                for _, out in sched.round():
                    if out.ok:
                        report.ops_drained += out.pulled + out.pushed
            rounds += 1
        report.heal_seconds = time.perf_counter() - t0
        report.heal_rounds = rounds

        # -- fleet-wide convergence oracle ---------------------------------
        clocks = [s.clock() for s in stores]
        digests = [s.digest() for s in stores]
        assert all(c == clocks[0] for c in clocks), (
            f"seed={seed}: clocks diverged after heal"
        )
        assert all(d == digests[0] for d in digests), (
            f"seed={seed}: digests diverged after heal: {digests}"
        )
        report.converged = True
        report.final_digest = digests[0]
        report.divergence_incidents = sum(
            len(s.monitor.divergence_incidents) for s in servers
        )
        assert report.divergence_incidents == 0, (
            "a lag-only episode must never probe divergent"
        )
    finally:
        for gate in gates.values():
            gate.close()
        for s in servers:
            s.stop()
    return report


def run_divergence_injection(seed: int, dump_dir=None) -> Dict:
    """Seeded same-frontier/different-digest injection: two stores hold the
    SAME vector clock but one change's content differs (a corrupt merge —
    the split-brain failure convergence digests exist to catch).  The
    exchange must classify as a DIVERGENCE incident — counter + latched
    peer flag + flight-recorder dump — never as plain lag.  Returns the
    evidence (asserts already held)."""
    from ..obs import ConvergenceMonitor, FlightRecorder, GLOBAL_COUNTERS
    from ..parallel.anti_entropy import ChangeStore
    from ..parallel.multihost import ReplicaServer, RetryPolicy

    rng = random.Random(seed ^ 0xD1FF)
    n = 4 + rng.randrange(4)
    victim = 1 + rng.randrange(n)
    a, b = ChangeStore(), ChangeStore()
    for seq in range(1, n + 1):
        ch = _fleet_change("shared", seq)
        a.append(ch)
        if seq == victim:
            # same (actor, seq, deps) — different op content
            from ..core.opids import ROOT
            from ..core.types import Operation

            ch = Change(
                actor=ch.actor, seq=ch.seq, deps=ch.deps,
                start_op=ch.start_op,
                ops=[Operation(action="set", obj=ROOT,
                               opid=(ch.start_op, ch.actor),
                               key="n", value=-ch.seq)],
            )
        b.append(ch)
    assert a.clock() == b.clock() and a.digest() != b.digest()

    recorder = FlightRecorder(
        capacity=64, dump_dir=dump_dir, min_dump_interval=0.0,
    ) if dump_dir is not None else None
    monitor = ConvergenceMonitor(host="injector", recorder=recorder)
    before = GLOBAL_COUNTERS.get("convergence.divergence_incidents")
    server = ReplicaServer(b)
    host, port = server.start()
    try:
        from ..parallel.multihost import try_sync_with

        outcome = try_sync_with(
            a, host, port, retry=RetryPolicy(attempts=1, timeout=2.0),
            monitor=monitor,
        )
    finally:
        server.stop()
    peer = f"{host}:{port}"
    rec = monitor.peer(peer)
    assert rec.divergent, "same-frontier/different-digest must latch divergent"
    assert rec.last_outcome != "lag", "divergence must never classify as lag"
    assert monitor.divergence_incidents, "incident record missing"
    incident = monitor.divergence_incidents[0]
    assert incident.local_digest != incident.peer_digest
    assert GLOBAL_COUNTERS.get("convergence.divergence_incidents") > before
    evidence = {
        "seed": seed,
        "peer": peer,
        "outcome_ok": outcome.ok,
        "local_digest": incident.local_digest,
        "peer_digest": incident.peer_digest,
        "counter_incremented": True,
        "dump": None,
    }
    if recorder is not None:
        assert recorder.last_dump_path is not None, (
            "divergence must auto-dump the flight ring"
        )
        dump = Path(recorder.last_dump_path)
        records = [json.loads(line) for line in
                   dump.read_text().splitlines() if line]
        assert any(
            r.get("kind") == "fault" and r.get("reason") == "divergence"
            for r in records
        ), "flight dump lacks the divergence fault record"
        evidence["dump"] = str(dump)

    # -- incident-plane oracle: EXACTLY a divergence incident ---------------
    # delta-triggered on the convergence monitor's incident count, so the
    # heal (no further divergent probes) is quiet rounds, nothing else
    from ..obs import IncidentMonitor

    imon = IncidentMonitor(host="injector", clear_after=2)
    fault_round = imon.rounds
    imon.observe_convergence(monitor)
    imon.advance_round()
    assert imon.incident_kinds() == ["divergence"], (
        f"seed={seed}: divergence injection opened {imon.incident_kinds()},"
        " expected exactly ['divergence']"
    )
    assert len(imon.open_incidents()) == 1
    ttd = imon.time_to_detection("divergence", fault_round)
    assert ttd == 1, f"seed={seed}: detection took {ttd} monitor rounds"
    for _ in range(imon.clear_after):
        imon.observe_convergence(monitor)
        imon.advance_round()
    assert not imon.open_incidents(), (
        f"seed={seed}: divergence incident never resolved post-heal"
    )
    evidence["incident_kinds"] = imon.incident_kinds()
    evidence["incident_resolved"] = True
    evidence["incident_detection_rounds"] = ttd
    return evidence


# ---------------------------------------------------------------------------
# Serving-tier chaos: overload + asymmetric partition against the typed-shed
# and byte-equality oracles
# ---------------------------------------------------------------------------


def _serve_session(num_docs: int, ops_per_doc: int,
                   device: Optional[Union[str, torch.device]] = None):
    """The serving-tier session configuration: `_campaign_session`
    capacities with ``static_rounds`` (one padded apply shape per round),
    on ``device``."""
    from ..parallel.streaming import StreamingMerge

    return StreamingMerge(
        num_docs=num_docs,
        actors=("doc1", "doc2", "doc3"),
        slot_capacity=max(256, 4 * ops_per_doc),
        mark_capacity=max(64, ops_per_doc),
        tomb_capacity=max(128, ops_per_doc),
        round_insert_capacity=128,
        round_delete_capacity=64,
        round_mark_capacity=64,
        static_rounds=True,
        device=device,
    )


@dataclass
class ServeChaosReport:
    """Evidence from one serving-tier overload + partition episode (all
    oracles already held — a violated oracle raises instead of
    returning)."""

    seed: int
    hosts: int
    num_docs: int
    offered: int = 0
    admitted: int = 0
    delayed: int = 0
    shed: int = 0
    shed_reasons: Dict[str, int] = None
    queue_peak: int = 0
    queue_max_depth: int = 0
    partition_lag_ops: int = 0
    heal_rounds: int = 0
    fleet_converged: bool = False
    serve_digest_matches_reference: bool = False
    repaired_digest_matches_clean: bool = False
    final_digest: int = 0
    #: latency-plane evidence: sampled stage records during the episode,
    #: every one sum-consistent (nonnegative stages telescoping to the
    #: commit total) with typed close causes — the plane's oracle rides
    #: the SAME chaos episode the verdict oracles do
    latency_records: int = 0
    latency_sum_consistent: bool = False
    latency_force_close: Dict[str, int] = None
    #: incident-plane oracle: the episode must open EXACTLY these kinds
    incident_kinds: List[str] = None
    incident_resolved: bool = False
    incident_detection_rounds: int = -1
    #: history-plane oracle: the gauge keys the private TimeSeriesPlane
    #: flagged, and how many monitor rounds after the fault it fired
    #: (must be <= incident_detection_rounds)
    anomaly_keys: List[str] = None
    anomaly_detection_rounds: int = -1

    def to_json(self) -> Dict:
        return asdict(self)


def run_serve_chaos(
    seed: int,
    hosts: int = 3,
    num_docs: int = 4,
    ops_per_doc: int = 30,
    max_depth: int = 24,
    overload_factor: float = 2.0,
    device: Optional[Union[str, torch.device]] = None,
) -> ServeChaosReport:
    """One serving-tier chaos episode: a SessionMux takes ``overload_factor``
    times more offered frames than its bounded queue holds WHILE the host
    sits behind an asymmetric partition, then everything heals.  Oracles:

    * **typed sheds only** — every submission returns a verdict, the
      accounting identity ``offered == admitted + delayed + shed`` holds,
      sheds actually happened (the overload was real), and every shed
      reason is in the typed vocabulary — zero silent drops;
    * **bounded queue** — the admission queue's peak depth never exceeds
      its configured bound, overload or not;
    * **no wedge** — the mux keeps applying admitted work mid-partition
      (the serving path does not block on the unreachable peers);
    * **byte equality** — after the episode the mux's device state equals
      a fault-free reference fed exactly the admitted frames (sheds shed
      whole frames, never corrupt one), and after redelivering EVERYTHING
      under normal load the state equals the no-fault session byte-for-bit
      (a shed is retryable, not a write loss);
    * **fleet heal** — the peer stores, diverged under the partition,
      drain to identical digests once the gates open.

    Every session runs on ``device``.  Raises on any violation; returns
    the evidence report."""
    from ..parallel.anti_entropy import ChangeStore
    from ..parallel.gossip import GossipScheduler
    from ..parallel.multihost import ReplicaServer, RetryPolicy
    from ..serve import AdmissionController, SHED_REASONS, SessionMux

    rng = random.Random(seed ^ 0x5E4E)
    assert hosts >= 2, "a serve episode needs at least one peer"
    report = ServeChaosReport(seed=seed, hosts=hosts, num_docs=num_docs,
                              queue_max_depth=max_depth)
    policy = RetryPolicy(attempts=1, timeout=0.5)

    # -- the replica fleet (host0 is the serving host) ----------------------
    stores = [ChangeStore() for _ in range(hosts)]
    servers = [ReplicaServer(stores[i], timeout=2.0) for i in range(hosts)]
    for s in servers:
        s.start()
    names = [f"{s.address[0]}:{s.address[1]}" for s in servers]
    gates = {
        (i, j): _LinkGate(servers[j].address)
        for i in range(hosts) for j in range(hosts) if i != j
    }
    scheds = [GossipScheduler(servers[i], retry=policy) for i in range(hosts)]
    for i in range(hosts):
        for j in range(hosts):
            if i != j:
                scheds[i].add_peer(*gates[(i, j)].address, name=names[j])

    # -- the serving tier on host0 ------------------------------------------
    workloads = generate_workload(seed, num_docs=num_docs,
                                  ops_per_doc=ops_per_doc)
    plans: List[List[bytes]] = []
    for w in workloads:
        changes = [ch for log in w.values() for ch in log]
        rng.shuffle(changes)
        chunk = rng.randrange(4, 8)
        plans.append([
            encode_frame(changes[i:i + chunk])
            for i in range(0, len(changes), chunk)
        ])

    mux = SessionMux(
        _serve_session(num_docs, ops_per_doc, device=device),
        admission=AdmissionController(
            max_depth=max_depth, high_watermark=0.75, low_watermark=0.5,
            session_quota=None,
        ),
        host=names[0],
    )
    # arm a PRIVATE latency plane: the chaos episode doubles as the
    # plane's adversarial oracle (every sampled record must stay
    # sum-consistent under overload + partition), without touching the
    # process-global plane other tests may read
    from ..obs.latency import CLOSE_CAUSES, LatencyPlane, check_sum_consistency
    mux.latency_plane = LatencyPlane().enable()
    sids = []
    for d in range(num_docs):
        sid, verdict = mux.open_session(f"client{d}")
        assert verdict.admitted and sid is not None
        sids.append(sid)

    admitted_frames: List[List[bytes]] = [[] for _ in range(num_docs)]
    try:
        # -- phase A: asymmetric partition + overload at once ---------------
        # host0 can hear inbound frontiers but every reply and outbound dial
        # is cut (the fleet-chaos shape); peers keep appending, so lag builds
        for (i, j), gate in gates.items():
            if j == 0:
                gate.set_mode("rx_only")
            else:
                gate.set_mode("closed")
        for j in range(1, hosts):
            _append_changes(stores[j], f"host{j}", 20 * j)
        for sched in scheds[1:]:
            sched.round()  # rx_only: host0 hears the frontiers, repairs nothing
        scheds[0].round()  # every outbound dial fails

        # the overload burst: offer far more than the queue holds, pumping
        # only occasionally (an ingest spike outrunning device rounds).
        # The incident-plane oracle samples the mux at each pump boundary
        # — BEFORE the flush that lets the tier catch up and clear its
        # recent-shed mark — the cadence a real scrape-fed monitor has
        from ..obs import IncidentMonitor

        imon = IncidentMonitor(host=names[0], clear_after=2)
        shed_fault_round = imon.rounds
        # the history-plane oracle rides the SAME monitor cadence: a
        # PRIVATE TimeSeriesPlane warms a flat baseline on the idle mux,
        # then the overload's first sampled spike must score as an
        # anomaly no later than the round the shed-storm incident opens
        from ..obs.timeseries import TimeSeriesPlane

        tsp = TimeSeriesPlane(sample_every=1, min_frames=4).enable()
        for _ in range(tsp.min_frames + 2):
            tsp.sample(serve=mux)
        anomaly_fault_round = tsp.rounds
        anomaly_round = None
        anomaly_findings: List[Dict] = []
        offered_target = int(overload_factor * max_depth) * 2
        offered = 0
        d = 0
        while offered < offered_target:
            doc = d % num_docs
            frames = plans[doc]
            frame = frames[(offered // num_docs) % len(frames)]
            verdict = mux.submit(sids[doc], frame)
            assert verdict.kind in ("admit", "delay", "shed"), verdict
            if verdict.kind == "admit":
                admitted_frames[doc].append(frame)
            elif verdict.kind == "shed":
                assert verdict.reason in SHED_REASONS, (
                    f"untyped shed reason {verdict.reason!r}"
                )
            assert mux.admission.depth <= max_depth, "queue bound violated"
            offered += 1
            d += 1
            if offered % (max_depth * 2) == 0:
                imon.observe_serve(mux)
                imon.advance_round()
                tsp.sample(serve=mux)
                if anomaly_round is None and tsp.active_anomalies():
                    anomaly_round = tsp.rounds
                    anomaly_findings = tsp.active_anomalies()
                # an occasional pump mid-overload: the device keeps
                # retiring rounds while the partition holds
                mux.flush()
        # incident-plane oracle, detection half: the mid-overload samples
        # must have opened EXACTLY a shed-storm incident
        assert imon.incident_kinds() == ["shed-storm"], (
            f"seed={seed}: overload opened {imon.incident_kinds()}, "
            "expected exactly ['shed-storm']"
        )
        # history-plane oracle, detection half: the overload scored as an
        # anomaly (serve.* keys -> the shed-storm kind) no later than the
        # monitor round the incident opened
        assert anomaly_round is not None, (
            f"seed={seed}: overload never scored as a history anomaly"
        )
        report.anomaly_keys = sorted(a["key"] for a in anomaly_findings)
        report.anomaly_detection_rounds = anomaly_round - anomaly_fault_round
        assert any(a["kind"] == "shed-storm" for a in anomaly_findings), (
            f"seed={seed}: anomaly findings missed the shed-storm "
            f"mapping: {anomaly_findings}"
        )
        detect = imon.time_to_detection("shed-storm", shed_fault_round)
        assert detect is not None and (
            report.anomaly_detection_rounds <= detect
        ), (
            f"seed={seed}: anomaly lagged the incident "
            f"({report.anomaly_detection_rounds} > {detect} rounds)"
        )
        mux.flush()
        stats = mux.admission.stats
        report.offered = stats.submitted
        report.admitted = stats.admitted
        report.delayed = stats.delayed
        report.shed = stats.shed
        report.shed_reasons = dict(sorted(stats.shed_reasons.items()))
        report.queue_peak = mux.admission.peak_depth
        assert stats.submitted == stats.admitted + stats.delayed + stats.shed, (
            f"seed={seed}: verdict accounting leak "
            f"({stats.submitted} != {stats.admitted}+{stats.delayed}+{stats.shed})"
        )
        assert stats.shed > 0, (
            f"seed={seed}: {overload_factor}x overload produced no sheds — "
            "the episode exercised nothing"
        )
        assert report.queue_peak <= max_depth, (
            f"seed={seed}: queue peak {report.queue_peak} exceeded bound "
            f"{max_depth}"
        )
        assert mux.applied > 0, (
            f"seed={seed}: the mux applied nothing mid-partition (wedged)"
        )
        # latency-plane oracle: the overload episode must have sampled
        # stage records, the latest one telescoping cleanly, every close
        # cause drawn from the typed vocabulary — and a read marks the
        # pending records visible so time-to-visibility fills too
        mux.patches(sids[0])
        plane = mux.latency_plane
        assert plane.records > 0, (
            f"seed={seed}: armed latency plane sampled no drain batches"
        )
        assert plane.last is not None and check_sum_consistency(plane.last), (
            f"seed={seed}: latency record not sum-consistent under "
            f"overload: {plane.last}"
        )
        assert set(plane.force_close) <= set(CLOSE_CAUSES), (
            f"seed={seed}: untyped close cause {plane.force_close}"
        )
        assert plane.snapshot()["pending_visibility"] == 0, (
            f"seed={seed}: patch read left records pending visibility"
        )
        report.latency_records = plane.records
        report.latency_sum_consistent = True
        report.latency_force_close = {
            c: n for c, n in sorted(plane.force_close.items()) if n
        }
        # partition truth: host0 really was behind its peers
        from ..obs.convergence import clock_delta_ops

        report.partition_lag_ops = sum(
            clock_delta_ops(stores[0].clock(), stores[j].clock())
            for j in range(1, hosts)
        )
        assert report.partition_lag_ops > 0, "partition built no lag"

        # -- phase B: byte-equality vs a reference fed the admitted set -----
        reference = _serve_session(num_docs, ops_per_doc, device=device)
        for doc in range(num_docs):
            for frame in admitted_frames[doc]:
                reference.ingest_frame(doc, frame)
        reference.drain()
        assert mux.session.digest() == reference.digest(), (
            f"seed={seed}: admitted-set digest mismatch — a shed corrupted "
            "state instead of rejecting cleanly"
        )
        report.serve_digest_matches_reference = True

        # -- phase C: heal the partition + redeliver under normal load ------
        for gate in gates.values():
            gate.set_mode("open")
        for sched in scheds:
            sched.wake()
        heal_rounds = 0
        for _ in range(8):
            heal_rounds += 1
            for sched in scheds:
                sched.round()
            if all(s.clock() == stores[0].clock() for s in stores):
                break
        clocks = [s.clock() for s in stores]
        digests = [s.digest() for s in stores]
        assert all(c == clocks[0] for c in clocks), (
            f"seed={seed}: fleet clocks diverged after heal"
        )
        assert all(dg == digests[0] for dg in digests), (
            f"seed={seed}: fleet digests diverged after heal"
        )
        report.fleet_converged = True
        report.heal_rounds = heal_rounds

        # redelivery (what a client retry / anti-entropy does for shed
        # frames): every doc gets its FULL plan again, paced under the
        # queue bound; the end state must be byte-identical to no-fault
        clean = _serve_session(num_docs, ops_per_doc, device=device)
        for doc, frames in enumerate(plans):
            for frame in frames:
                clean.ingest_frame(doc, frame)
        clean.drain()
        for doc, frames in enumerate(plans):
            for frame in frames:
                while True:
                    verdict = mux.submit(sids[doc], frame)
                    assert mux.admission.depth <= max_depth
                    if verdict.kind == "admit":
                        break
                    mux.flush()  # drain, then the retry must admit
        mux.flush()
        final = mux.session.digest()
        assert final == clean.digest(), (
            f"seed={seed}: post-redelivery digest {final:#010x} != "
            f"fault-free {clean.digest():#010x} — shed frames lost writes"
        )
        report.repaired_digest_matches_clean = True
        report.final_digest = final
        assert mux.session.pending_count() == 0

        # incident-plane oracle, heal half: redelivery committed clean
        # rounds, so recent_sheds cleared — quiet rounds must resolve the
        # shed-storm and nothing else may have opened
        for _ in range(imon.clear_after + 1):
            imon.observe_serve(mux)
            imon.advance_round()
        assert imon.incident_kinds() == ["shed-storm"], (
            f"seed={seed}: heal phase opened {imon.incident_kinds()}"
        )
        assert not imon.open_incidents(), (
            f"seed={seed}: shed-storm incident never resolved post-heal"
        )
        report.incident_kinds = imon.incident_kinds()
        report.incident_resolved = True
        report.incident_detection_rounds = imon.time_to_detection(
            "shed-storm", shed_fault_round
        )
    finally:
        for gate in gates.values():
            gate.close()
        for s in servers:
            s.stop()
    return report


# ---------------------------------------------------------------------------
# Reconnect storm: a peer back from the dead drains a giant backlog through
# gossip while the serving tier stays under load
# ---------------------------------------------------------------------------


@dataclass
class ReconnectStormReport:
    """Evidence from one reconnect-storm episode (all oracles already held
    — a violated oracle raises instead of returning)."""

    seed: int
    backlog_ops: int = 0
    drain_seconds: float = 0.0
    drain_ops_per_sec: float = 0.0
    offered: int = 0
    admitted: int = 0
    shed: int = 0
    delayed: int = 0
    p99_apply_ms: float = 0.0
    served_rounds: int = 0
    queue_peak: int = 0
    converged: bool = False
    serve_digest_ok: bool = False

    def to_json(self) -> Dict:
        return asdict(self)


def run_reconnect_storm(
    seed: int,
    backlog_ops: int = 1500,
    num_docs: int = 4,
    ops_per_doc: int = 30,
    serve_rate_per_s: float = 150.0,
    storm_duration_s: float = 1.5,
    device: Optional[Union[str, torch.device]] = None,
) -> ReconnectStormReport:
    """The first adversarial workload family: a peer returns
    after a long offline window holding a ``backlog_ops``-change backlog
    and drains it through one anti-entropy exchange WHILE the local
    serving tier carries open-loop client traffic.  Oracles:

    * the backlog fully converges (local store clock == peer clock, store
      digests byte-equal);
    * the serving tier stayed live through the storm: typed verdicts only
      (accounting identity), bounded queue, rounds kept committing;
    * the mux's device state still equals a fault-free reference fed the
      same admitted frames (the storm never corrupted the serving path).

    Used as both the reference bench's ``reconnect_storm`` row (rates from
    the report) and a chaos schedule (the assertions).  The serving sessions
    run on ``device``.  Returns the evidence report."""
    from ..parallel.anti_entropy import ChangeStore
    from ..parallel.gossip import GossipScheduler
    from ..parallel.multihost import ReplicaServer, RetryPolicy
    from ..serve import AdmissionController, SessionMux, build_arrivals, run_open_loop

    rng = random.Random(seed ^ 0x570F)
    report = ReconnectStormReport(seed=seed)

    # the returning peer: offline "for weeks", giant append-only backlog
    peer_store = ChangeStore()
    _append_changes(peer_store, "returning-peer", backlog_ops)
    report.backlog_ops = backlog_ops
    peer_server = ReplicaServer(peer_store, timeout=10.0)
    peer_server.start()

    # the serving host: store + gossip + mux under open-loop load
    local_store = ChangeStore()
    _append_changes(local_store, "serving-host", 10)
    local_server = ReplicaServer(local_store, timeout=10.0)
    local_server.start()
    sched = GossipScheduler(
        local_server, retry=RetryPolicy(attempts=1, timeout=10.0),
    )
    sched.add_peer(*peer_server.address)

    workloads = generate_workload(seed, num_docs=num_docs,
                                  ops_per_doc=ops_per_doc)
    mux = SessionMux(
        _serve_session(num_docs, ops_per_doc, device=device),
        admission=AdmissionController(max_depth=256, session_quota=None),
        host="serving-host",
    )
    frames_by_session: Dict[int, List[bytes]] = {}
    for d, w in enumerate(workloads):
        sid, verdict = mux.open_session(f"client{d}")
        assert verdict.admitted
        changes = [ch for log in w.values() for ch in log]
        rng.shuffle(changes)
        chunk = rng.randrange(4, 8)
        frames_by_session[sid] = [
            encode_frame(changes[i:i + chunk])
            for i in range(0, len(changes), chunk)
        ]

    try:
        # warm the device path BEFORE the storm so the measured p99 is
        # the serving tier, not kernel builds and first launches: a
        # THROWAWAY mux (same session shapes) replays the full frame plans
        # with interleaved flushes, walking the pow-2 slot-window ladder the
        # real storm will occupy
        wmux = SessionMux(
            _serve_session(num_docs, ops_per_doc, device=device),
            admission=AdmissionController(max_depth=256, session_quota=None),
        )
        wmap = {}
        for d in range(num_docs):
            wsid, _ = wmux.open_session(f"warm{d}")
            wmap[wsid] = d
        plans = {wsid: frames_by_session[sid] for wsid, sid
                 in zip(sorted(wmap), sorted(frames_by_session))}
        depth = max(len(p) for p in plans.values())
        for k in range(depth):
            for wsid, plan in sorted(plans.items()):
                if k < len(plan):
                    wmux.submit(wsid, plan[k])
            wmux.flush()

        # -- the storm: gossip drain + open-loop serving, concurrently -----
        drain_done = threading.Event()
        drain_result: Dict = {}

        def drain_backlog():
            t0 = time.perf_counter()
            results = sched.round()
            drain_result["seconds"] = time.perf_counter() - t0
            drain_result["ok"] = all(out.ok for _, out in results)
            drain_result["pulled"] = sum(
                out.pulled for _, out in results
            )
            drain_done.set()

        arrivals = build_arrivals(
            frames_by_session, serve_rate_per_s, storm_duration_s,
        )
        storm = threading.Thread(target=drain_backlog, daemon=True)
        storm.start()
        res = run_open_loop(mux, arrivals, deadline_s=storm_duration_s * 4)
        assert drain_done.wait(timeout=30.0), "backlog drain wedged"
        storm.join(timeout=10.0)

        # -- serving-tier oracles ------------------------------------------
        assert res.accounted(), "verdict accounting leak during the storm"
        report.offered = res.offered
        report.admitted = res.admitted
        report.shed = res.shed
        report.delayed = res.delayed
        report.p99_apply_ms = round(res.p99_apply_s * 1e3, 3)
        report.served_rounds = res.rounds
        report.queue_peak = res.queue_peak
        assert res.queue_peak <= mux.admission.max_depth
        assert res.applied > 0 and res.rounds > 0, (
            "the serving tier froze during the backlog drain"
        )

        # -- convergence oracles -------------------------------------------
        assert drain_result["ok"], "reconnect exchange failed"
        assert drain_result["pulled"] == backlog_ops, (
            f"drained {drain_result['pulled']} of {backlog_ops} backlog ops"
        )
        assert local_store.clock() == peer_store.clock()
        assert local_store.digest() == peer_store.digest(), (
            "stores diverged after the reconnect drain"
        )
        report.drain_seconds = round(drain_result["seconds"], 4)
        report.drain_ops_per_sec = round(
            backlog_ops / max(drain_result["seconds"], 1e-9), 1
        )
        report.converged = True

        # the serving path stayed byte-correct through the storm: when
        # nothing was shed/delayed the mux ingested exactly the arrival
        # frames, so a reference session fed the same set must match the
        # mux's device state bit-for-bit (the shed-path digest oracle
        # lives in run_serve_chaos)
        if res.shed == 0 and res.delayed == 0:
            reference = _serve_session(num_docs, ops_per_doc, device=device)
            sessions = mux.sessions()
            for _, sid, frame in arrivals:
                reference.ingest_frame(sessions[sid].doc_index, frame)
            reference.drain()
            assert mux.session.digest() == reference.digest(), (
                "serving state diverged from the reference during the storm"
            )
            report.serve_digest_ok = True
    finally:
        peer_server.stop()
        local_server.stop()
    return report


def run_fused_drain_kill(seed: int, checkpoint_root=None,
                         device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Kill a fused multi-round drain BETWEEN its staged batch commits and
    prove recovery is byte-equal: the fused pipeline commits several
    multi-round device programs per drain, so the nastiest failure point is
    mid-fuse — some batches landed, one died, the donated state is
    half-advanced.  The supervisor must treat the whole fused drain as ONE
    atomic unit: rollback restores the last checkpoint and replays the
    journal (event-sourced ingest), so the recovered session re-derives
    device state from the pre-fuse round boundary — it can never resume
    from a half-applied fused batch.

    Episode: ingest half the workload, drain + checkpoint (the pre-fuse
    boundary is real state, not an empty session); ingest the rest; arm a
    one-shot fault that raises inside the SECOND staged-batch dispatch of
    the next fused drain; guarded drain → watchdog containment → rollback
    → journal replay → clean re-drain.  Oracle: digest + spans byte-equal
    to a fault-free twin, zero pending, exactly one rollback, and the kill
    provably fired mid-fuse (≥ 1 batch committed before it).  Every
    session runs on ``device``; the fault is a Python exception raised
    before the batch's site call."""
    tmp = None
    if checkpoint_root is None:
        tmp = tempfile.TemporaryDirectory(prefix="pt-fused-chaos-")
        checkpoint_root = tmp.name
    try:
        docs, opd = 4, 96
        workloads = generate_workload(seed=seed, num_docs=docs, ops_per_doc=opd)

        def factory():
            s = _campaign_session(docs, opd, device=device)
            # low round caps + a narrow fuse window force the drain into
            # SEVERAL staged batches (the mid-fuse failure point needs a
            # batch boundary to die on)
            s.round_caps = (8, 8, 8, 8)
            s.FUSE_MAX_ROUNDS = 2
            return s

        frames = []
        for d, w in enumerate(workloads):
            ch = [c for log in sorted(w) for c in w[log]]
            half = len(ch) // 2
            frames.append((encode_frame(ch[:half]), encode_frame(ch[half:])))

        clean = factory()
        for d, (a, b) in enumerate(frames):
            clean.ingest_frame(d, a)
            clean.ingest_frame(d, b)
        clean.drain()

        guarded = GuardedSession(
            factory, checkpoint_root, deadline=120.0, checkpoint_every=1000,
        )
        # incident-plane oracle: a private monitor fed guarded.health()
        # sees the rollback delta as EXACTLY a quarantine-storm incident;
        # the clean pre-kill drain is its zero baseline
        from ..obs import IncidentMonitor

        imon = IncidentMonitor(host="fused-chaos", clear_after=2)
        for d, (a, _) in enumerate(frames):
            guarded.ingest_frame(d, a)
        pre_rounds = guarded.drain()
        assert pre_rounds > 0, "first half must commit"
        imon.observe_supervisor(guarded)
        imon.advance_round()
        assert not imon.incident_kinds(), (
            f"seed={seed}: clean drain opened {imon.incident_kinds()}"
        )
        guarded.checkpoint()  # the pre-fuse boundary rollback must land on

        for d, (_, b) in enumerate(frames):
            guarded.ingest_frame(d, b)
        sess = guarded.session
        orig_dispatch = sess._dispatch_fused_batch
        calls = {"n": 0}

        def killer(batch, statics, inputs, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("chaos: device died mid-fuse")
            return orig_dispatch(batch, statics, inputs, **kw)

        sess._dispatch_fused_batch = killer
        rolled = guarded.drain()
        assert rolled == 0, "a killed fused drain must report a rollback"
        assert guarded.rollbacks == 1, guarded.rollbacks
        assert calls["n"] == 2, (
            f"kill must fire on the second staged batch (mid-fuse), "
            f"saw {calls['n']} dispatches"
        )
        # recovery: rollback's guarded re-drain already converged the
        # journal replay; the oracle is byte equality with the clean twin
        assert guarded.pending_count() == 0
        digest, clean_digest = guarded.digest(), clean.digest()
        assert digest == clean_digest, (
            f"mid-fuse kill recovery diverged: {digest:#x} != {clean_digest:#x}"
        )
        assert guarded.read_all() == clean.read_all()

        # incident-plane oracle: the rollback edge opens EXACTLY a
        # quarantine-storm; recovery already replayed the journal, so
        # quiet observations resolve it
        kill_mon_round = imon.rounds
        imon.observe_supervisor(guarded)
        imon.advance_round()
        assert imon.incident_kinds() == ["quarantine-storm"], (
            f"seed={seed}: mid-fuse kill opened {imon.incident_kinds()}, "
            "expected exactly ['quarantine-storm']"
        )
        ttd = imon.time_to_detection("quarantine-storm", kill_mon_round)
        for _ in range(imon.clear_after):
            imon.observe_supervisor(guarded)
            imon.advance_round()
        assert not imon.open_incidents(), (
            f"seed={seed}: quarantine-storm never resolved post-recovery"
        )
        return {
            "seed": seed,
            "rollbacks": guarded.rollbacks,
            "batches_before_kill": calls["n"] - 1,
            "pre_fuse_rounds": pre_rounds,
            "digest": digest,
            "incident_kinds": imon.incident_kinds(),
            "incident_resolved": True,
            "incident_detection_rounds": ttd,
        }
    finally:
        if tmp is not None:
            tmp.cleanup()


def run_markheavy_chaos(seed: int, num_docs: int = 4,
                        ops_per_doc: int = 36, **kw) -> ChaosReport:
    """The mark-heavy editorial-pass chaos schedule: the full
    composed-fault campaign of :func:`run_chaos` — delivery faults,
    detectable corruption + quarantine, injected device rounds,
    crash-restore — run over the span-overlap-explosion workload family,
    against the same byte-equality oracle (``device=`` rides ``kw``)."""
    from .fuzz import generate_markheavy_workload

    return run_chaos(
        seed, num_docs=num_docs, ops_per_doc=ops_per_doc,
        workload_gen=generate_markheavy_workload, **kw,
    )


# ---------------------------------------------------------------------------
# Live fleet failover: kill a serving host mid-traffic
# ---------------------------------------------------------------------------


@dataclass
class HostKillReport:
    """Evidence from one host-kill failover episode (all oracles already
    held — a violated oracle raises instead of returning)."""

    seed: int
    hosts: int
    num_docs: int
    victim: str = ""
    victim_docs: int = 0
    offered: int = 0
    admitted: int = 0
    delayed: int = 0
    shed: int = 0
    shed_reasons: Dict[str, int] = None
    #: frontend rounds between the kill and the lease's dead verdict
    detection_rounds: int = 0
    failovers: int = 0
    failover_docs: int = 0
    #: frames acked (admitted) for victim docs at the instant of the kill
    acked_at_kill: int = 0
    acked_survived: bool = False
    redelivered: bool = False
    converged: bool = False
    final_digest: int = 0
    flight_dumps: int = 0
    traffic_seconds: float = 0.0
    applied_frames: int = 0
    #: incident-plane oracle: the episode must open EXACTLY these kinds
    incident_kinds: List[str] = None
    incident_resolved: bool = False
    #: monitor rounds from the kill to the host-death incident opening
    incident_detection_rounds: int = -1
    #: history-plane oracle: the fleet delay/shed gauge keys the private
    #: TimeSeriesPlane flagged, and how many monitor rounds after the
    #: kill it fired (must be <= incident_detection_rounds)
    anomaly_keys: List[str] = None
    anomaly_detection_rounds: int = -1

    def to_json(self) -> Dict:
        return asdict(self)


def run_host_kill_failover(
    seed: int,
    hosts: int = 3,
    num_docs: int = 6,
    ops_per_doc: int = 24,
    lease_rounds: int = 2,
    transport: bool = True,
    dump_dir=None,
    device: Optional[Union[str, torch.device]] = None,
) -> HostKillReport:
    """Kill a serving host mid-traffic and prove the fleet survives it.

    A ≥3-host :class:`~..serve.FleetFrontend` places ``num_docs`` docs via
    the router and carries round-robin client traffic; mid-traffic, one
    host that serves docs is KILLED (mux dead, ship endpoint closed,
    heartbeats stop).  Oracles:

    * **typed verdicts only** — every submission after the kill still gets
      a typed verdict (``delay`` while the lease drains / failover runs,
      ``shed(failover)`` only if re-placement fails), every shed reason is
      in ``SHED_REASONS``, and the fleet-wide accounting identity
      ``submitted == admitted + delayed + shed`` holds — zero silent drops;
    * **every acked op survives** — immediately after failover (before any
      client retry) each victim doc's state on its NEW host byte-equals a
      reference session fed exactly the frames that were ACKED at kill
      time (the checkpoint ∪ journal invariant);
    * **post-heal byte equality** — after client retries redeliver
      everything, every doc's full-state hash equals a fault-free
      reference run's, and the fleet-wide digest (doc-hash sum) equals the
      fault-free session digest bit-for-bit;
    * **failover timeline dumped** — the flight recorder produced
      host-death and failover-complete dumps that parse (when
      ``dump_dir``);
    * **incident plane** — a private monitor fed the fleet snapshot once
      per frontend round opens EXACTLY ``['host-death']`` within
      ``2 * lease_rounds + 2`` monitor rounds and resolves it post-heal,
      and the kill's delay/shed spike scores as a history anomaly no later.

    Every session runs on ``device``.  Raises on any violation; returns the
    evidence report."""
    from ..obs import FlightRecorder, IncidentMonitor
    from ..serve import (
        AdmissionController, FleetFrontend, SHED_REASONS, SessionMux,
    )

    rng = random.Random(seed ^ 0xFA170)
    assert hosts >= 3, "the acceptance episode needs a >=3-host fleet"
    report = HostKillReport(seed=seed, hosts=hosts, num_docs=num_docs)

    recorder = (
        FlightRecorder(capacity=256, dump_dir=Path(dump_dir),
                       min_dump_interval=0.0, host="frontend")
        if dump_dir is not None else None
    )
    # the incident-plane oracle: a PRIVATE monitor fed the fleet snapshot
    # once per frontend round must open EXACTLY a host-death incident and
    # resolve it once failover re-homes every doc — nothing else
    imon = IncidentMonitor(host="frontend", clear_after=2,
                           recorder=recorder)
    kill_mon_round = 0
    # the history-plane oracle rides the monitor cadence: a PRIVATE
    # TimeSeriesPlane warms a flat baseline before traffic (below); the
    # kill's delay/shed counter spike must then score as an anomaly no
    # later than the monitor round the host-death incident opens.  Only
    # the delay/shed keys count — traffic ramps the admit counters, and
    # a ramp is drift, not a fault signature
    from ..obs.timeseries import TimeSeriesPlane

    tsp = TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    kill_tsp_round = 0
    anomaly_state = {"round": None, "keys": []}

    def monitor_round():
        imon.observe_fleet(fe)
        imon.advance_round()
        tsp.sample(fleet=fe)
        if anomaly_state["round"] is None:
            hits = [a for a in tsp.active_anomalies()
                    if a["key"] in ("fleet.verdicts.delayed",
                                    "fleet.verdicts.shed")]
            if hits:
                anomaly_state["round"] = tsp.rounds
                anomaly_state["keys"] = sorted(a["key"] for a in hits)

    def make_mux():
        return SessionMux(
            _serve_session(max(4, num_docs), ops_per_doc, device=device),
            admission=AdmissionController(max_depth=128, session_quota=None),
        )

    fe = FleetFrontend(lease_rounds=lease_rounds, checkpoint_every=2,
                       recorder=recorder)
    for i in range(hosts):
        fe.add_host(f"host{i}", make_mux(), transport=transport)

    workloads = generate_workload(seed, num_docs=num_docs,
                                  ops_per_doc=ops_per_doc)
    plans: Dict[str, List[bytes]] = {}
    for d, w in enumerate(workloads):
        changes = [ch for log in sorted(w) for ch in w[log]]
        rng.shuffle(changes)
        chunk = rng.randrange(4, 8)
        plans[f"doc{d}"] = [
            encode_frame(changes[i:i + chunk])
            for i in range(0, len(changes), chunk)
        ]
        verdict = fe.open_doc(f"doc{d}", f"client{d}")
        assert verdict.admitted, verdict

    acked: Dict[str, List[bytes]] = {k: [] for k in plans}
    pending: Dict[str, List[bytes]] = {k: list(v) for k, v in plans.items()}
    keys = sorted(plans)

    # flat-baseline warmup: the anomaly scorer needs min_frames quiet
    # frames before the kill's spike can be judged against them
    for _ in range(tsp.min_frames + 2):
        tsp.sample(fleet=fe)

    try:
        t0 = time.perf_counter()
        # -- phase A: traffic, with the kill landing mid-way ----------------
        total_frames = sum(len(v) for v in plans.values())
        kill_after = max(2, int(0.4 * total_frames))
        submitted = 0
        killed = False
        victim = None
        kill_round = 0
        while any(pending.values()):
            for k in keys:
                if not pending[k]:
                    continue
                verdict = fe.submit(k, pending[k][0])
                submitted += 1
                assert verdict.kind in ("admit", "delay", "shed"), verdict
                if verdict.kind == "admit":
                    acked[k].append(pending[k].pop(0))
                elif verdict.kind == "shed":
                    assert verdict.reason in SHED_REASONS, verdict
                if not killed and submitted >= kill_after:
                    # kill a host that actually serves docs, mid-traffic
                    serving_hosts = sorted(set(fe._serving.values()))
                    victim = serving_hosts[rng.randrange(len(serving_hosts))]
                    victim_docs = [
                        dk for dk, h in sorted(fe._serving.items())
                        if h == victim
                    ]
                    assert victim_docs, "victim must hold docs"
                    report.victim = victim
                    report.victim_docs = len(victim_docs)
                    report.acked_at_kill = sum(
                        len(acked[dk]) for dk in victim_docs
                    )
                    acked_at_kill = {dk: list(acked[dk])
                                     for dk in victim_docs}
                    fe.hosts[victim].kill()
                    kill_round = fe.rounds
                    kill_mon_round = imon.rounds
                    kill_tsp_round = tsp.rounds
                    killed = True
                    # the very next submission to a victim doc must answer
                    # TYPED (delay: the lease has not expired yet)
                    probe = fe.submit(victim_docs[0],
                                      plans[victim_docs[0]][0])
                    assert probe.kind in ("delay", "shed"), probe
            fe.round()
            monitor_round()
            if killed and not any(pending.values()):
                break
            if fe.rounds > 200:
                raise AssertionError("traffic loop wedged")
        # drive the lease to the dead verdict + failover
        while victim not in fe.ledger.dead_hosts():
            fe.round()
            monitor_round()
            assert fe.rounds - kill_round <= 2 * lease_rounds + 2, (
                "lease never expired"
            )
        report.detection_rounds = fe.rounds - kill_round
        assert fe.failovers == 1, fe.failovers
        report.failovers = fe.failovers
        report.failover_docs = fe.failover_docs
        assert fe.failover_docs == report.victim_docs, (
            f"seed={seed}: {report.victim_docs} docs on {victim}, only "
            f"{fe.failover_docs} re-placed"
        )
        for dk in acked_at_kill:
            new_host = fe._serving[dk]
            assert new_host != victim and fe.hosts[new_host].alive, (
                f"doc {dk} not re-placed off the dead host"
            )

        # -- acked-op survival (before any client retry) --------------------
        # every frame EVER acked for a victim doc — the pre-kill set (which
        # only survived via checkpoint + journal redelivery) plus anything
        # admitted on the new host after failover — must be reflected in
        # the re-homed doc's state, byte-for-byte
        for dk in acked_at_kill:
            assert acked[dk][:len(acked_at_kill[dk])] == acked_at_kill[dk]
            ref = _serve_session(1, ops_per_doc, device=device)
            for f in acked[dk]:
                ref.ingest_frame(0, f)
            ref.drain()
            got = fe.doc_digest(dk)
            want = ref.doc_digest(0)
            assert got == want, (
                f"seed={seed} doc={dk}: acked ops lost in failover "
                f"({got:#010x} != {want:#010x})"
            )
        report.acked_survived = True

        # -- phase B: client retries redeliver EVERYTHING -------------------
        for attempt in range(80):
            dirty = False
            for k in keys:
                # shed/delayed frames retry; redelivery of acked frames is
                # harmless (duplicate-tolerant), so retry the whole plan
                for f in plans[k]:
                    verdict = fe.submit(k, f)
                    assert verdict.kind in ("admit", "delay", "shed"), verdict
                    if verdict.kind != "admit":
                        dirty = True
            fe.round()
            monitor_round()
            if not dirty:
                break
        else:
            raise AssertionError("redelivery never fully admitted")
        fe.flush()
        report.redelivered = True
        report.traffic_seconds = time.perf_counter() - t0

        # -- fleet-wide byte equality vs the fault-free reference -----------
        clean = _serve_session(num_docs, ops_per_doc, device=device)
        for d in range(num_docs):
            for f in plans[f"doc{d}"]:
                clean.ingest_frame(d, f)
        clean.drain()
        total = 0
        for d in range(num_docs):
            got = fe.doc_digest(f"doc{d}")
            want = clean.doc_digest(d)
            assert got == want, (
                f"seed={seed} doc=doc{d}: post-heal digest {got:#010x} != "
                f"fault-free {want:#010x}"
            )
            total = (total + got) & 0xFFFFFFFF
        assert total == clean.digest(), (
            f"seed={seed}: fleet-wide digest {total:#010x} != fault-free "
            f"session digest {clean.digest():#010x}"
        )
        report.converged = True
        report.final_digest = total

        # -- accounting identity + applied tally ----------------------------
        assert fe.stats.accounted(), fe.stats.to_json()
        stats = fe.stats
        report.offered = stats.submitted
        report.admitted = stats.admitted
        report.delayed = stats.delayed
        report.shed = stats.shed
        report.shed_reasons = dict(sorted(stats.shed_reasons.items()))
        assert stats.delayed + stats.shed > 0, (
            "the kill produced no delay/shed evidence — it landed too late"
        )
        report.applied_frames = sum(
            h.mux.applied for h in fe.hosts.values()
        )

        # -- flight-recorder timeline ---------------------------------------
        if recorder is not None:
            dumps = sorted(Path(dump_dir).glob("*.jsonl"))
            assert dumps, "host death produced no flight dump"
            records = []
            for dump in dumps:
                records.extend(
                    json.loads(line)
                    for line in dump.read_text().splitlines() if line
                )
            reasons = {r.get("reason") for r in records
                       if r.get("kind") == "fault"}
            assert {"host-death", "failover-complete"} <= reasons, (
                f"failover timeline incomplete: {sorted(reasons)}"
            )
            report.flight_dumps = len(dumps)

        # -- incident-plane oracle ------------------------------------------
        # the episode opens EXACTLY a host-death incident; post-heal (docs
        # re-homed, redelivery done) quiet rounds must resolve it
        for _ in range(imon.clear_after + 1):
            monitor_round()
        assert imon.incident_kinds() == ["host-death"], (
            f"seed={seed}: host-kill opened {imon.incident_kinds()}, "
            "expected exactly ['host-death']"
        )
        assert not imon.open_incidents(), (
            f"seed={seed}: host-death incident never resolved post-heal: "
            f"{[i.to_json() for i in imon.open_incidents()]}"
        )
        ttd = imon.time_to_detection("host-death", kill_mon_round)
        assert ttd is not None and ttd <= 2 * lease_rounds + 2, (
            f"seed={seed}: host-death detection took {ttd} monitor rounds"
        )
        report.incident_kinds = imon.incident_kinds()
        report.incident_resolved = True
        report.incident_detection_rounds = ttd

        # history-plane oracle: the kill's delay/shed spike scored as an
        # anomaly no later than the host-death incident opened
        assert anomaly_state["round"] is not None, (
            f"seed={seed}: host kill never scored as a history anomaly"
        )
        report.anomaly_keys = anomaly_state["keys"]
        report.anomaly_detection_rounds = (
            anomaly_state["round"] - kill_tsp_round
        )
        assert report.anomaly_detection_rounds <= ttd, (
            f"seed={seed}: anomaly lagged the incident "
            f"({report.anomaly_detection_rounds} > {ttd} rounds)"
        )
    finally:
        fe.stop()
    return report


def run_campaign(
    seeds: range, num_docs: int = 6, ops_per_doc: int = 40,
    verbose: bool = False, **kw,
) -> List[ChaosReport]:
    """Run one chaos campaign per seed (``kw`` reaches :func:`run_chaos`,
    ``device=`` included); any oracle violation raises with the seed in its
    message.  Returns all evidence reports."""
    reports = []
    for seed in seeds:
        report = run_chaos(seed, num_docs=num_docs, ops_per_doc=ops_per_doc, **kw)
        reports.append(report)
        if verbose:
            print(
                f"seed {seed:4d}: frames={report.delivered_frames} "
                f"corrupt={report.corrupt_frames} "
                f"quarantine_peak={report.quarantined_peak} "
                f"rollbacks={report.rollbacks} "
                f"behind={report.transport_behind} "
                f"digest={report.final_digest:#010x}"
            )
    return reports
