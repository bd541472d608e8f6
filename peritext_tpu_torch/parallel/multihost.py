"""Multi-host replication transport: vector-clock anti-entropy over TCP.

The reference's replication never leaves one process — ``Publisher`` is an
in-memory fan-out (reference src/pubsub.ts:4-25) and the anti-entropy clock
diff runs between two in-process replicas (test/merge.ts:25-38).  This module
is the multi-host equivalent: each host exposes its append-only
:class:`~.anti_entropy.ChangeStore` on a TCP endpoint, and one
``sync_with`` round performs a full bidirectional anti-entropy exchange —
frontiers are swapped, and each side ships exactly the changes the other is
missing, packed as binary codec frames (:mod:`.codec`, the wire format).

Division of labour with the device path: this transport only converges the
*change logs* across hosts (cheap, irregular, host-side).  Each host then
feeds its converged logs to its own card through the normal batched path
(api.DocBatch / parallel.streaming) — cross-host traffic rides the network
once per change, while all per-op work stays on the card.

The wire is byte-compatible with the reference package's transport: a
port endpoint and a reference endpoint sync with each other and ship
checkpoint frames to each other.

Protocol (all messages length-prefixed: 4-byte big-endian length, 1-byte
type, body):

* ``F`` frontier — JSON vector clock ``{actor: seq}``.
* ``C`` changes  — one binary codec frame.
* ``M`` changes  — several codec frames (a large backlog).
* ``S`` ship     — one doc's checkpoint frames (the fleet's migration leg),
  answered by ``A`` with the receiver's frame count.

Exchange, from the client's side::

    connect -> send F(mine) -> recv C(what I lack) + F(theirs)
            -> send C(what they lack) -> close

Both sides merge with :func:`merge_changes`, which tolerates duplicates and
out-of-order arrival (per-actor seq ordering restores log order), so repeated
or concurrent syncs against many peers are safe — the store is a CRDT of
append-only logs.

Fault domains (the supervisor layer): every socket operation runs under a
per-socket deadline — a stalled peer raises :class:`TransportError` (via
``socket.timeout``) instead of hanging ``_recv_exact`` forever.  The retry
layer (:class:`RetryPolicy`) wraps one anti-entropy round in bounded
exponential backoff with jitter; :func:`try_sync_with` absorbs terminal
transport failures into a :class:`SyncOutcome` whose ``behind`` flag simply
means "this peer's changes are still missing" — exactly the state a later
anti-entropy round repairs, because the store is append-only and
duplicate-tolerant.  Callers above the transport never need to see a
transport exception to stay correct.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..core.errors import DecodeError, PeritextError, TransportError
from ..core.types import Change, Clock
from ..obs import GLOBAL_COUNTERS, GLOBAL_HISTOGRAMS, GLOBAL_TRACER, TraceContext
from .anti_entropy import ChangeStore
from .codec import (
    WIRE_CAPS,
    WireSession,
    decode_frame,
    encode_frame,
    encode_frame_checked,
    encode_frame_chunks,
    encode_frame_traced,
    iter_frames,
    strip_trace_context,
)

_LEN = struct.Struct(">I")
_MAX_MESSAGE = 1 << 28  # 256 MiB: far above any sane frame, guards corrupt peers

MSG_FRONTIER = b"F"
MSG_CHANGES = b"C"
#: multi-frame change payload (concatenated encode_frame_chunks output).
#: A DISTINCT kind, not MSG_CHANGES with trailing frames: a pre-chunking
#: peer's decoder read one frame and silently IGNORED trailing bytes, so
#: reusing "C" would truncate large backlogs against old peers without any
#: error.  Old peers reject the unknown kind loudly (sync aborts, store
#: untouched); small backlogs still ride "C" for full compatibility.
MSG_CHANGES_MULTI = b"M"
#: checkpoint-frame ship (the fleet tier's doc-state migration leg): body =
#: 4-byte big-endian JSON-header length + header + packed frame blob
#: (checkpoint.pack_doc_frames).  The header names the doc key and carries
#: the sender's ``base`` (how many frames it believes the receiver already
#: holds — the frame-count frontier of this anti-entropy-shaped exchange).
#: A peer without a ship handler rejects the kind loudly; nothing about the
#: frontier/changes exchange changes.
MSG_SHIP = b"S"
#: ship acknowledgement: JSON ``{"doc": key, "have": n}`` — the receiver's
#: post-merge frame count, so the shipper can diff and re-ship a tail that
#: landed while this leg was in flight (the catch-up round).
MSG_SHIP_ACK = b"A"


# -- retry policy ------------------------------------------------------------


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff + jitter for one transport leg.

    ``attempts`` counts TOTAL tries (1 = no retry).  Delay before try k+1 is
    ``min(max_delay, base_delay * 2**k)`` scaled by a uniform jitter in
    ``[1, 1 + jitter]`` — jitter desynchronizes a fleet of peers retrying
    against the same recovered host.  ``timeout`` is the per-SOCKET deadline
    applied to connect and every send/recv of the attempt, so one stalled
    peer costs at most ``attempts * timeout`` wall-clock, never forever."""

    attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    timeout: float = 30.0

    def delay(self, attempt: int, rng: random.Random) -> float:
        base = min(self.max_delay, self.base_delay * (2 ** attempt))
        return base * (1.0 + self.jitter * rng.random())


#: single-attempt policy — the pre-supervisor behavior, minus the hangs
NO_RETRY = RetryPolicy(attempts=1)


@dataclass
class SyncOutcome:
    """Result of one :func:`try_sync_with` round.  ``behind=True`` means the
    peer could not be reached within the retry budget: nothing was lost (the
    store is untouched or merely partially ahead), the local frontier is
    simply behind that peer until a later anti-entropy round succeeds."""

    pulled: int = 0
    pushed: int = 0
    ok: bool = True
    error: Optional[str] = None

    @property
    def behind(self) -> bool:
        return not self.ok


# -- framing ----------------------------------------------------------------


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout as exc:
            raise TransportError(
                f"peer stalled: recv deadline exceeded with {n - len(buf)} "
                "bytes outstanding"
            ) from exc
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
    return bytes(buf)


def _send_message(sock: socket.socket, kind: bytes, body: bytes) -> None:
    try:
        sock.sendall(_LEN.pack(len(body) + 1) + kind + body)
    except socket.timeout as exc:
        raise TransportError("peer stalled: send deadline exceeded") from exc


def _recv_message(sock: socket.socket) -> Tuple[bytes, bytes]:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if not 1 <= length <= _MAX_MESSAGE:
        raise ConnectionError(f"bad message length {length}")
    payload = _recv_exact(sock, length)
    return payload[:1], payload[1:]


# Frontier metadata sentinels (observability): the
# frontier stays a ``{str: int}`` JSON map — exactly what every deployed
# peer validates — and capability/trace metadata rides as keys that can
# never collide with an actor id (actor ids are printable; these start with
# NUL).  An OLD peer accepts them as unknown "actors" whose seqs it never
# looks up (``missing_changes`` iterates only the SOURCE clock), so the
# negotiation is invisible to it; a NEW peer strips them before any clock
# math.  ``caps`` advertises the sender's max decodable wire version —
# trace-context (v5) frames are sent only to a peer that advertised
# ``caps >= WIRE_CAPS``, which is how old peers keep decoding everything.
_META_CAPS = "\x00caps"
_META_TRACE = "\x00trace"
_META_SPAN = "\x00span"
#: convergence observability: the sender's COMMUTATIVE
#: store digest at the advertised frontier (ChangeStore.digest — the
#: divergence probe: equal frontiers must carry equal digests), and the
#: sender's own replica LISTENING port so the serving side can attribute the
#: observation to a stable peer identity (peer-IP + advertised port) for its
#: ConvergenceMonitor.  Both are ints, so old peers' {str: int} frontier
#: validation accepts-and-ignores them like every other sentinel.
_META_DIGEST = "\x00digest"
_META_PORT = "\x00port"
#: incident observability: the sender's compact incident summary
#: (``IncidentMonitor.wire_summary``: open count packed above a 32-bit
#: digest of the observation-derived incident view), so two frontends can
#: tell whether they AGREE on what is broken.  An int, so old peers'
#: {str: int} frontier validation accepts-and-ignores it like every other
#: sentinel.
_META_INCIDENTS = "\x00incidents"
_META_KEYS = {_META_CAPS: "caps", _META_TRACE: "trace", _META_SPAN: "span",
              _META_DIGEST: "digest", _META_PORT: "port",
              _META_INCIDENTS: "incidents"}


def _frontier_meta(tracer, span, digest=None, port=None,
                   incidents=None) -> dict:
    """The metadata this endpoint attaches to an outbound frontier: always
    its wire caps; the current span's trace context when tracing is live,
    so the peer's handler span can join OUR trace; the store digest at the
    advertised frontier (divergence probe); for endpoints that serve a
    replica socket, the listening port (peer attribution); and, when an
    incident monitor is armed, its packed incident summary (fleet incident
    agreement)."""
    meta = {_META_CAPS: WIRE_CAPS}
    if span is not None and tracer is not None and tracer.active():
        meta[_META_TRACE] = int(span.trace_id)
        meta[_META_SPAN] = int(span.span_id)
    if digest is not None:
        meta[_META_DIGEST] = int(digest)
    if port is not None:
        meta[_META_PORT] = int(port)
    if incidents is not None:
        meta[_META_INCIDENTS] = int(incidents)
    return meta


def _send_frontier(sock: socket.socket, clock: Clock,
                   meta: Optional[dict] = None) -> None:
    payload = dict(clock)
    if meta:
        payload.update(meta)
    _send_message(sock, MSG_FRONTIER, json.dumps(payload).encode("utf-8"))


def _parse_frontier(body: bytes) -> Tuple[Clock, dict]:
    """Decode and validate a frontier message: must be ``{actor: seq}`` with
    string keys and int seqs — anything else is a protocol error, typed as
    :class:`DecodeError` (a ValueError) so both endpoints' error contracts
    stay uniform and ``try_sync_with`` can absorb a corrupt peer as a
    ``behind`` outcome.  Returns ``(clock, meta)`` with the metadata
    sentinels (caps / trace context) stripped out of the clock."""
    try:
        clock = json.loads(body)
    except json.JSONDecodeError as exc:
        raise DecodeError(f"bad frontier: {exc}") from exc
    if not isinstance(clock, dict) or not all(
        isinstance(k, str) and isinstance(v, int) and not isinstance(v, bool)
        for k, v in clock.items()
    ):
        raise DecodeError("bad frontier: expected {actor: seq}")
    meta = {
        name: clock.pop(key)
        for key, name in _META_KEYS.items()
        if key in clock
    }
    return clock, meta


def _meta_ctx(meta: dict) -> Optional[TraceContext]:
    """The peer's wire-carried trace context, when its frontier sent one."""
    if "trace" in meta and "span" in meta:
        return TraceContext(meta["trace"], meta["span"])
    return None


def _expect(sock: socket.socket, expected: bytes) -> bytes:
    kind, body = _recv_message(sock)
    if kind != expected:
        raise ConnectionError(f"expected message {expected!r}, got {kind!r}")
    return body


def _send_changes(sock: socket.socket, changes: List[Change],
                  peer_caps: int = 0,
                  ctx: Optional[TraceContext] = None) -> None:
    """One MSG_CHANGES frame when the backlog fits a single frame's decode
    budget (the overwhelmingly common case, wire-identical to old peers),
    else MSG_CHANGES_MULTI: session-scoped (v4) chunks sharing one string
    dictionary + deflate — the string table and repeated attrs are paid once
    per backlog, not once per chunk.  Single-frame version negotiation, by
    the peer's advertised caps: ``caps >= 6`` rides wire v6 (CRC32-checked,
    trace context embedded when one is live); a ``caps == 5`` peer with a
    live trace context gets v5 (traced, unchecked — its maximum); everyone
    else gets plain v2.  Large MULTI backlogs fall back to untraced v3/v4
    chunks — the frontier already carried the context."""
    from .codec import _ENCODE_CHUNK_CHARGE, _VERSION_TRACED

    if sum(1 + len(c.deps or {}) for c in changes) <= _ENCODE_CHUNK_CHARGE:
        if peer_caps >= WIRE_CAPS:
            frame = encode_frame_checked(
                changes, *(ctx if ctx is not None else (0, 0))
            )
        elif ctx is not None and peer_caps >= _VERSION_TRACED:
            frame = encode_frame_traced(changes, ctx.trace_id, ctx.span_id)
        else:
            frame = encode_frame(changes)
        _send_message(sock, MSG_CHANGES, frame)
        return
    chunks = encode_frame_chunks(changes, session=WireSession(compress=True))
    _send_message(sock, MSG_CHANGES_MULTI, b"".join(chunks))


def _recv_changes(
    sock: socket.socket, want_frames: bool = True,
) -> Tuple[List[Change], List[bytes], Optional[TraceContext]]:
    """Receive either changes kind; returns (changes, self-contained frames
    for ``on_frame`` consumers — MULTI chunks are normalized to v2 so a
    consumer can store or re-ingest each frame independently, and a traced
    v5 single frame is stripped the same way — plus the frame-carried trace
    context when there was one).  Pass ``want_frames=False`` when no
    on_frame consumer exists: normalization is a full re-encode of the
    backlog, wasted on discarded output."""
    kind, body = _recv_message(sock)
    if kind == MSG_CHANGES:
        ctx, plain = strip_trace_context(body)
        return (
            decode_frame(plain),
            [plain] if want_frames else [],
            TraceContext(*ctx) if ctx is not None else None,
        )
    if kind == MSG_CHANGES_MULTI:
        sess = WireSession()
        changes: List[Change] = []
        frames: List[bytes] = []
        for raw in iter_frames(body):
            if want_frames:
                part, v2 = sess.decode_frame_normalized(raw)
                frames.append(v2)
            else:
                part = sess.decode_frame(raw)
            changes.extend(part)
        return changes, frames, None
    raise ConnectionError(f"expected changes message, got {kind!r}")


# -- store merge ------------------------------------------------------------


def merge_changes(store: ChangeStore, changes: List[Change]) -> List[Change]:
    """Merge remotely-received changes into ``store``; returns the changes
    that were actually new.  Duplicates (seq already present) are skipped;
    per-actor seq sorting restores append order, so arbitrary arrival order
    is fine as long as each actor's suffix is contiguous — which the clock
    diff guarantees (reference getMissingChanges ships ``log[have:seq]``)."""
    fresh: List[Change] = []
    for change in sorted(changes, key=lambda c: (c.actor, c.seq)):
        have = len(store.log(change.actor))
        if change.seq <= have:
            continue  # duplicate from a concurrent sync
        store.append(change)  # raises on a genuine gap
        fresh.append(change)
    return fresh


# -- server -----------------------------------------------------------------


class ReplicaServer:
    """Serves one host's ChangeStore for anti-entropy pulls from peers.

    ``on_changes`` (optional) is invoked with each batch of newly-merged
    remote changes — the hook where a host forwards fresh changes into its
    device pipeline (e.g. ``StreamingMerge.ingest``).  It runs on the
    connection-handler thread; keep it quick or hand off to a queue.
    """

    def __init__(
        self,
        store: ChangeStore,
        host: str = "127.0.0.1",
        port: int = 0,
        on_changes: Optional[Callable[[List[Change]], None]] = None,
        on_frame: Optional[Callable[[bytes], None]] = None,
        timeout: float = 30.0,
        tracer=None,
        recorder=None,
        metrics_port: Optional[int] = None,
        monitor=None,
        serve=None,
        on_ship: Optional[Callable[[str, List[bytes], int], int]] = None,
        fleet=None,
        incidents=None,
    ) -> None:
        """``on_changes`` receives each batch of newly-merged decoded
        changes; ``on_frame`` receives the RAW inbound frame bytes whenever
        it carried anything new — the zero-copy hook for feeding a device
        session's ``ingest_frame`` (frames are duplicate-tolerant, so
        redelivered changes inside the frame are harmless).  ``timeout`` is
        the per-connection socket deadline: a peer that stalls mid-exchange
        holds a handler thread for at most this long.

        Observability: ``tracer`` (default the process tracer) produces
        anti-entropy spans that join a traced peer's trace via the
        wire-carried context; ``recorder`` gets a ``fault`` record on
        transport give-ups (``try_sync_with``) and divergence incidents;
        ``monitor`` (default: a fresh
        :class:`~..obs.convergence.ConvergenceMonitor`) ingests every
        frontier this server exchanges, inbound and outbound, maintaining
        per-peer lag watermarks and divergence probes; ``incidents`` (an
        :class:`~..obs.incidents.IncidentMonitor`) rides every frontier
        this endpoint sends as the ``"\x00incidents"`` summary and records
        every peer's summary it hears (``observe_peer_summary``, on the
        handler thread for inbound exchanges); ``metrics_port`` (0 =
        ephemeral) mounts an :class:`~..obs.MetricsServer` exposing
        ``/metrics`` (Prometheus, with ``peritext_convergence_*`` and the
        device profiler's ``peritext_device_*`` gauges), ``/health.json``,
        ``/convergence.json``, ``/devprof.json`` and ``/trace.json`` — its
        bound address is :attr:`metrics_address` after :meth:`start`;
        ``serve`` (a :class:`~..serve.SessionMux`) additionally mounts
        ``/serve.json`` and the ``peritext_serve_*`` gauges, ``fleet`` (a
        :class:`~..serve.fleet.FleetFrontend`) ``/fleet.json`` and the
        ``peritext_fleet_*`` gauges, on the same server.

        ``on_ship`` is the checkpoint-ship receiver
        ``(doc_key, frames, base) -> total frame count now held``: the
        fleet tier's doc-state migration lands here (frames are
        duplicate-tolerant, so a retried or overlapping ship is
        idempotent).  It runs on a connection-handler thread.  Without a
        handler, MSG_SHIP connections are refused loudly — this endpoint
        does not accept migrations."""
        from ..obs.convergence import ConvergenceMonitor

        #: optional :class:`~..obs.incidents.IncidentMonitor`: when armed,
        #: outbound frontiers carry its packed summary (the
        #: ``"\x00incidents"`` sentinel) and inbound ones feed
        #: ``observe_peer_summary`` — the fleet incident-agreement view
        self.incidents = incidents
        self.store = store
        self.on_changes = on_changes
        self.on_frame = on_frame
        self.on_ship = on_ship
        self.timeout = timeout
        self.tracer = tracer if tracer is not None else GLOBAL_TRACER
        self.recorder = recorder
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address: Tuple[str, int] = self._sock.getsockname()
        self.monitor = monitor if monitor is not None else ConvergenceMonitor(
            host=f"{self.address[0]}:{self.address[1]}", recorder=recorder,
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.metrics = None
        self.metrics_address: Optional[Tuple[str, int]] = None
        if metrics_port is not None:
            from ..obs import GLOBAL_DEVPROF, MetricsServer

            try:
                self.metrics = MetricsServer(
                    host=host, port=metrics_port,
                    tracer=self.tracer, recorder=self.recorder,
                    convergence=self.monitor,
                    # the process profiler is mounted even while disabled:
                    # /devprof.json answers (enabled: false) and the gauges
                    # appear the moment an operator arms GLOBAL_DEVPROF
                    devprof=GLOBAL_DEVPROF,
                    serve=serve,
                    fleet=fleet,
                )
            except OSError:
                # metrics port unavailable: release the bound replica socket
                # too, or a caller's retry finds it held by this dead instance
                self._sock.close()
                raise
            self.metrics_address = self.metrics.address

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        if self.metrics is not None:
            self.metrics_address = self.metrics.start()
        return self.address

    def stop(self) -> None:
        self._stop.set()
        # shutdown() BEFORE close(): closing a listening socket does not
        # wake a thread already blocked in accept() on Linux — the accept
        # loop would strand until the join timeout below (a flat 5 s per
        # server teardown, multiplied across every test/chaos episode that
        # builds a fleet).  shutdown() fails accept() immediately.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.metrics is not None:
            self.metrics.stop()

    # internals

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            threading.Thread(
                target=self._serve_one, args=(conn,), daemon=True
            ).start()

    def sync_with(
        self, host: str, port: int, timeout: Optional[float] = None,
        retry: Optional[RetryPolicy] = None,
        peer_name: Optional[str] = None,
    ) -> Tuple[int, int]:
        """Outbound anti-entropy round sharing this server's store lock, so a
        node that serves peers and pulls from peers concurrently stays
        consistent."""
        return sync_with(
            self.store, host, port,
            on_changes=self.on_changes, timeout=timeout, lock=self._lock,
            on_frame=self.on_frame, retry=retry, tracer=self.tracer,
            monitor=self.monitor, advertise_port=self.address[1],
            peer_name=peer_name, incidents=self.incidents,
        )

    def try_sync_with(
        self, host: str, port: int, retry: Optional[RetryPolicy] = None,
        peer_name: Optional[str] = None,
    ) -> SyncOutcome:
        """Non-raising outbound round: terminal transport failure becomes a
        ``behind`` outcome for the next anti-entropy pass."""
        return try_sync_with(
            self.store, host, port,
            on_changes=self.on_changes, lock=self._lock,
            on_frame=self.on_frame, retry=retry, tracer=self.tracer,
            recorder=self.recorder, monitor=self.monitor,
            advertise_port=self.address[1], peer_name=peer_name,
            incidents=self.incidents,
        )

    def _handle_ship(self, conn: socket.socket, body: bytes) -> None:
        """One inbound checkpoint ship: parse the header + packed frames,
        hand them to ``on_ship`` (which merges idempotently and returns the
        doc's total frame count), and ack with that count — the shipper's
        catch-up input."""
        from ..checkpoint import unpack_doc_frames

        if self.on_ship is None:
            raise ConnectionError("this endpoint accepts no checkpoint ships")
        try:
            (hlen,) = _LEN.unpack(body[:_LEN.size])
            header = json.loads(body[_LEN.size:_LEN.size + hlen])
            doc_key = str(header["doc"])
            base = int(header.get("base", 0))
            frames = unpack_doc_frames(body[_LEN.size + hlen:])
        except (ValueError, KeyError, TypeError, struct.error) as exc:
            # struct.error (short body), KeyError/TypeError (header not a
            # dict / missing "doc"), json/unpack ValueError: all must stay
            # inside _serve_one's bad-peer guard — a malformed ship is a
            # counted, swallowed protocol error, never a dead thread
            raise DecodeError(f"malformed checkpoint ship: {exc!r}") from exc
        with self.tracer.span(
            "fleet.ship.receive", doc=doc_key, frames=len(frames),
        ):
            have = int(self.on_ship(doc_key, frames, base))
        GLOBAL_COUNTERS.add("fleet.ship_frames_received", len(frames))
        _send_message(
            conn, MSG_SHIP_ACK,
            json.dumps({"doc": doc_key, "have": have}).encode("utf-8"),
        )

    def _serve_one(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(self.timeout)
                kind, first = _recv_message(conn)
                if kind == MSG_SHIP:
                    self._handle_ship(conn, first)
                    return
                if kind != MSG_FRONTIER:
                    raise ConnectionError(
                        f"expected message {MSG_FRONTIER!r} or {MSG_SHIP!r}, "
                        f"got {kind!r}"
                    )
                peer_clock, meta = _parse_frontier(first)
                # peer attribution for the convergence monitor: a frontier
                # that advertised the sender's replica port names a stable
                # identity (peer IP + that port); bare clients (no replica
                # socket) stay anonymous and are not tracked
                peer_name = None
                if "port" in meta:
                    try:
                        peer_name = (
                            f"{conn.getpeername()[0]}:{int(meta['port'])}"
                        )
                    except OSError:
                        peer_name = None
                # the peer's frontier carried its trace context: this
                # handler's span (and every child span it opens — ingest,
                # merge) joins the PEER's trace, so a two-host exchange
                # renders as one timeline in the merged Perfetto trace
                with self.tracer.span(
                    "anti-entropy.serve", ctx=_meta_ctx(meta),
                ) as sp:
                    with self._lock:
                        my_clock = self.store.clock()
                        my_digest = self.store.digest(my_clock)
                        outbound = self.store.missing_changes(my_clock, peer_clock)
                    if peer_name is not None and self.monitor is not None:
                        # inbound frontiers count too: under an asymmetric
                        # partition (we can hear but not dial), this is how
                        # the host still learns how far behind it is
                        self.monitor.observe_frontier(
                            peer_name, my_clock, peer_clock,
                            local_digest=my_digest,
                            peer_digest=meta.get("digest"),
                        )
                    if (peer_name is not None and self.incidents is not None
                            and "incidents" in meta):
                        self.incidents.observe_peer_summary(
                            peer_name, meta["incidents"]
                        )
                    # chunked: a large backlog splits into multiple frames so
                    # no single frame approaches the peer's decode dep budget
                    _send_changes(
                        conn, outbound, peer_caps=int(meta.get("caps", 0)),
                        ctx=sp.context if self.tracer.active() else None,
                    )
                    _send_frontier(
                        conn, my_clock, meta=_frontier_meta(
                            self.tracer, sp, digest=my_digest,
                            port=self.address[1],
                            incidents=(self.incidents.wire_summary()
                                       if self.incidents is not None
                                       else None),
                        )
                    )
                    # the frame-level ctx is redundant HERE: this handler
                    # span already adopted the same context from the peer's
                    # frontier, and the on_frame/on_changes delivery below
                    # runs inside it (the client side of the exchange is
                    # where the frame field is load-bearing — sync_with)
                    inbound, frames, _ = _recv_changes(
                        conn, want_frames=self.on_frame is not None
                    )
                    with self._lock:
                        fresh = merge_changes(self.store, inbound)
                    if peer_name is not None and self.monitor is not None:
                        self.monitor.observe_success(
                            peer_name, pulled=len(fresh),
                            pushed=len(outbound),
                        )
                    sp.args.update(pulled=len(fresh), pushed=len(outbound))
                    if fresh:
                        # on_frame first: consumers that ingest via on_frame
                        # and account via on_changes must never observe the
                        # count ahead of the ingestion
                        if self.on_frame is not None:
                            for one in frames:
                                self.on_frame(one)
                        if self.on_changes is not None:
                            self.on_changes(fresh)
                GLOBAL_HISTOGRAMS.observe("transport.serve_seconds", sp.duration)
        except (ConnectionError, ValueError, OSError, PeritextError):
            # a bad peer (bad framing, corrupt frame, malformed frontier, or a
            # change batch with log gaps) must not take the server down
            GLOBAL_COUNTERS.add("transport.server_errors")
            return


# -- client -----------------------------------------------------------------


def _sync_once(
    store: ChangeStore,
    host: str,
    port: int,
    timeout: float,
    lock: threading.Lock,
    want_frames: bool,
    tracer,
    monitor=None,
    advertise_port: Optional[int] = None,
    peer_name: Optional[str] = None,
    incidents=None,
) -> Tuple[List[Change], int, List[bytes], Optional[TraceContext]]:
    """One attempt of the bidirectional exchange (see :func:`sync_with`).
    The store mutates only AFTER the socket closes cleanly, so a failed
    attempt is side-effect free and safe to retry.  Returns the freshly
    merged changes, the pushed count, the raw inbound frames, and the
    peer's frame-carried trace context — on_frame/on_changes delivery
    happens in the CALLER, outside the retried region: a callback failure
    after a successful merge is a local error, and retrying it would skip
    the callbacks entirely (the reconnect pulls only duplicates).

    A ``monitor`` (:class:`~..obs.convergence.ConvergenceMonitor`) ingests
    the peer's frontier AS SOON AS IT PARSES — before the exchange
    completes — so an attempt that dies mid-transfer (slow link, stall)
    still updates the peer's lag watermark with what the frontier taught
    us."""
    with tracer.span("anti-entropy.sync", peer=f"{host}:{port}") as sp:
        with socket.create_connection((host, port), timeout=timeout) as sock:
            sock.settimeout(timeout)  # per-socket deadline on every send/recv
            with lock:
                my_clock = store.clock()
                my_digest = store.digest(my_clock)
            # the frontier carries our caps + this span's trace context, so
            # the peer's handler span joins THIS trace (cross-host spans);
            # plus the store digest at this frontier (divergence probe) and
            # our replica port when we serve one (peer attribution)
            _send_frontier(sock, my_clock, meta=_frontier_meta(
                tracer, sp, digest=my_digest, port=advertise_port,
                incidents=(incidents.wire_summary()
                           if incidents is not None else None),
            ))
            inbound, frames, in_ctx = _recv_changes(sock, want_frames=want_frames)
            peer_clock, meta = _parse_frontier(_expect(sock, MSG_FRONTIER))
            if incidents is not None and "incidents" in meta:
                incidents.observe_peer_summary(
                    peer_name or f"{host}:{port}", meta["incidents"]
                )
            if monitor is not None:
                # telemetry only, observed against the PRE-merge snapshot:
                # both frontiers are pre-exchange positions, so the
                # clock-delta sums are this round's true lag watermarks
                monitor.observe_frontier(
                    peer_name or f"{host}:{port}", my_clock, peer_clock,
                    local_digest=my_digest, peer_digest=meta.get("digest"),
                )
            with lock:
                outbound = store.missing_changes(store.clock(), peer_clock)
            _send_changes(
                sock, outbound, peer_caps=int(meta.get("caps", 0)),
                ctx=sp.context if tracer.active() else None,
            )
        with lock:
            fresh = merge_changes(store, inbound)
        sp.args.update(pulled=len(fresh), pushed=len(outbound))
    GLOBAL_HISTOGRAMS.observe("transport.sync_seconds", sp.duration)
    return fresh, len(outbound), frames, in_ctx


#: what a retry may absorb: connect/stall/teardown (OSError family, incl.
#: socket.timeout and our TransportError) and protocol corruption
#: (ValueError, incl. DecodeError).  A CausalityError from merge_changes is
#: NOT transport — a genuine log gap propagates to the caller.
_RETRYABLE = (OSError, ValueError)


def sync_with(
    store: ChangeStore,
    host: str,
    port: int,
    on_changes: Optional[Callable[[List[Change]], None]] = None,
    timeout: Optional[float] = None,
    lock: Optional[threading.Lock] = None,
    on_frame: Optional[Callable[[bytes], None]] = None,
    retry: Optional[RetryPolicy] = None,
    tracer=None,
    monitor=None,
    advertise_port: Optional[int] = None,
    peer_name: Optional[str] = None,
    incidents=None,
) -> Tuple[int, int]:
    """One full bidirectional anti-entropy round against a peer.

    Returns ``(pulled, pushed)`` change counts.  Every socket operation runs
    under a per-socket deadline — an explicitly-passed ``timeout`` wins,
    else the retry policy's ``timeout`` (30 s with no policy) — so a stalled
    peer raises :class:`TransportError` instead of hanging.  With a
    :class:`RetryPolicy`, transport-level failures (connect refused, stall,
    teardown, corrupt protocol bytes) retry with exponential backoff +
    jitter; a terminal connect/stall/teardown failure raises
    :class:`TransportError`, while terminal protocol corruption keeps its
    typed :class:`~..core.errors.DecodeError`/ValueError surface (the
    pre-retry contract).  Retrying is always safe: the store mutates only
    after a complete exchange, logs are append-only, and merge_changes
    skips duplicates.  ``on_frame``/``on_changes`` run once, after the
    successful attempt — an exception they raise propagates unwrapped (it
    is a local failure, not transport).  Pass ``lock`` when other threads
    (e.g. a ReplicaServer on the same store) mutate the store concurrently.
    """
    lock = lock or threading.Lock()
    policy = retry or NO_RETRY
    tracer = tracer if tracer is not None else GLOBAL_TRACER
    deadline = timeout if timeout is not None else policy.timeout
    rng = random.Random()
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.attempts)):
        if attempt:
            GLOBAL_COUNTERS.add("transport.retries")
            time.sleep(policy.delay(attempt - 1, rng))
        try:
            fresh, pushed, frames, in_ctx = _sync_once(
                store, host, port, deadline, lock, on_frame is not None,
                tracer, monitor=monitor, advertise_port=advertise_port,
                peer_name=peer_name, incidents=incidents,
            )
        except _RETRYABLE as exc:
            last = exc
            continue
        if monitor is not None:
            # the pull merged: the observed lag drained, staleness resets
            monitor.observe_success(
                peer_name or f"{host}:{port}", pulled=len(fresh),
                pushed=pushed,
            )
        if fresh:
            # delivery runs after the sync span closed (outside the retried
            # region), so the peer's FRAME-carried context is what links the
            # consumer's ingest spans into the exchange's trace — this is
            # the client-side consumer of wire v5 (the serve side's ingest
            # nests under its handler span, which adopted the frontier ctx)
            with tracer.span(
                "anti-entropy.deliver", ctx=in_ctx, pulled=len(fresh),
            ):
                if on_frame is not None:  # before on_changes; see ReplicaServer
                    for one in frames:
                        on_frame(one)
                if on_changes is not None:
                    on_changes(fresh)
        return len(fresh), pushed
    if isinstance(last, ValueError) and not isinstance(last, OSError):
        raise last  # protocol corruption: keep the typed DecodeError surface
    raise TransportError(
        f"sync with {host}:{port} failed after {max(1, policy.attempts)} "
        f"attempt(s): {last!r}"
    ) from last


def try_sync_with(
    store: ChangeStore,
    host: str,
    port: int,
    on_changes: Optional[Callable[[List[Change]], None]] = None,
    lock: Optional[threading.Lock] = None,
    on_frame: Optional[Callable[[bytes], None]] = None,
    retry: Optional[RetryPolicy] = None,
    tracer=None,
    recorder=None,
    monitor=None,
    advertise_port: Optional[int] = None,
    peer_name: Optional[str] = None,
    incidents=None,
) -> SyncOutcome:
    """Anti-entropy round that NEVER raises on transport failure: a peer
    that stays unreachable through the retry budget yields a ``behind``
    :class:`SyncOutcome` — the local store is simply behind that peer's
    frontier, and the next successful round repairs it (append-only,
    duplicate-tolerant).  A peer shipping corrupt protocol bytes through
    the retry budget (:class:`DecodeError`) is the same state — behind
    until a clean round.  Non-transport errors (e.g. a genuine log gap, or
    a failure inside the caller's own on_frame/on_changes callback) still
    propagate: they indicate local problems a retry cannot fix."""
    policy = retry or RetryPolicy()

    # fence the caller's callbacks off from the exchange's own error space:
    # a DecodeError raised INSIDE on_frame/on_changes is a local delivery
    # failure (the store already merged the pull — "behind" would be a lie
    # no later round repairs), so it must propagate, while the same type
    # from the exchange itself is a corrupt peer and absorbs as behind
    class _CallbackFailed(Exception):
        pass

    def _fenced(cb):
        if cb is None:
            return None

        def run(arg):
            try:
                cb(arg)
            except Exception as exc:  # graftlint: boundary(fenced: rewrapped and re-raised below)
                raise _CallbackFailed() from exc

        return run

    try:
        pulled, pushed = sync_with(
            store, host, port, on_changes=_fenced(on_changes),
            lock=lock, on_frame=_fenced(on_frame), retry=policy,
            tracer=tracer, monitor=monitor, advertise_port=advertise_port,
            peer_name=peer_name, incidents=incidents,
        )
    except _CallbackFailed as exc:
        raise exc.__cause__
    except (TransportError, DecodeError) as exc:
        GLOBAL_COUNTERS.add("transport.behind_peers")
        if monitor is not None:
            # the behind state is no longer forgotten: the monitor keeps the
            # peer's last lag estimate and grows its staleness/failure
            # counts — the gossip scheduler's healing priority inputs
            monitor.observe_failure(
                peer_name or f"{host}:{port}", error=str(exc)
            )
        if recorder is not None:
            # transport give-up: the flight recorder turns "that peer was
            # behind all soak" into a post-mortem with the attempts' spans
            recorder.fault(
                "transport-give-up", peer=f"{host}:{port}", error=str(exc)
            )
        return SyncOutcome(ok=False, error=str(exc))
    return SyncOutcome(pulled=pulled, pushed=pushed)


# -- checkpoint ship (the fleet tier's doc-state migration leg) --------------


def ship_frames(
    host: str,
    port: int,
    doc_key: str,
    frames: List[bytes],
    base: int = 0,
    retry: Optional[RetryPolicy] = None,
    timeout: Optional[float] = None,
    tracer=None,
) -> int:
    """Ship one doc's checkpoint frame history to a peer's ship endpoint
    (``ReplicaServer(on_ship=...)``) and return the peer's post-merge frame
    count — the frame-count frontier of this anti-entropy-shaped exchange,
    which the caller diffs against its own history to ship the tail that
    landed mid-move (the catch-up round).

    Rides the SAME bounded-retry transport discipline as the anti-entropy
    sync: per-socket deadlines (a stalled peer raises
    :class:`TransportError`, never hangs), exponential backoff + jitter
    between attempts.  Retrying is always safe: the receiver's merge is
    idempotent (frames are duplicate-tolerant), so a ship that died after
    partial delivery simply re-ships.  ``base`` advertises how many frames
    the sender believes the receiver already holds — a fresh target gets 0,
    a catch-up leg gets the previous ack's ``have``."""
    from ..checkpoint import pack_doc_frames

    policy = retry or NO_RETRY
    deadline = timeout if timeout is not None else policy.timeout
    tracer = tracer if tracer is not None else GLOBAL_TRACER
    header = json.dumps({"doc": doc_key, "base": int(base)}).encode("utf-8")
    body = _LEN.pack(len(header)) + header + pack_doc_frames(frames)
    rng = random.Random()
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.attempts)):
        if attempt:
            GLOBAL_COUNTERS.add("transport.retries")
            time.sleep(policy.delay(attempt - 1, rng))
        try:
            with tracer.span(
                "fleet.ship", peer=f"{host}:{port}", doc=doc_key,
                frames=len(frames),
            ):
                with socket.create_connection((host, port), timeout=deadline) as sock:
                    sock.settimeout(deadline)
                    _send_message(sock, MSG_SHIP, body)
                    ack = json.loads(_expect(sock, MSG_SHIP_ACK))
        except _RETRYABLE as exc:
            last = exc
            continue
        if str(ack.get("doc")) != doc_key:
            raise DecodeError(
                f"ship ack names doc {ack.get('doc')!r}, shipped {doc_key!r}"
            )
        GLOBAL_COUNTERS.add("fleet.ship_frames_sent", len(frames))
        GLOBAL_COUNTERS.add("fleet.ship_bytes_sent", len(body))
        return int(ack["have"])
    if isinstance(last, ValueError) and not isinstance(last, OSError):
        raise last
    raise TransportError(
        f"ship to {host}:{port} failed after {max(1, policy.attempts)} "
        f"attempt(s): {last!r}"
    ) from last
