"""Streaming merge (BASELINE config 5): a server holding many collaborative
documents.

The batch path (``api.batch.DocBatch``) converges a *closed* set of change
logs in one shot.  This session converges an *open* stream: changes for up
to ``num_docs`` documents arrive over time (:meth:`StreamingMerge.ingest`),
and each round applies only the newly admissible changes on top of the
document state carried on the card — the device never replays history.
Reads, cursors and a convergence digest are served between rounds.

Design, as in the reference package's session:

* **Static round widths** — per-round op streams are padded to the
  ``round_*_capacity`` widths (shrunk by a power-of-two shift for trickle
  rounds); a doc whose pending work exceeds them defers the rest to the
  next round.
* **Batched rounds** — :meth:`drain` schedules up to
  :attr:`FUSE_MAX_ROUNDS` rounds on the host first (admission needs only
  host clocks), then commits them in causal order.  Each round uploads its
  flat streams once and launches the insert kernel once (ops/insert.py)
  with its slot window bounded by the cumulative admitted inserts.
* **Block-chunked state** — sessions larger than ``read_chunk`` docs pad
  the doc axis to a block multiple and apply, resolve and sweep per block.
* **Event-sourced fallback** — the session keeps every doc's change log, so
  a doc the device cannot serve (undeclared actor, inexpressible op,
  change wider than a round, capacity overflow) replays through the scalar
  oracle; reads and digests route it there.
* **Incremental digest** — per-row full-state hashes are carried in a host
  plane; a digest re-hashes only the rows rounds touched.

Ported here: the padded layout without a mesh, with object-path ingest.
The mesh, the paged and ragged layouts, and frame ingest are listed in
ROADMAP.md (queue 1, items 5b, 7, 8 and 11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core.doc import Doc
from ..core.types import Change, Clock, FormatSpan
from ..obs import GLOBAL_COUNTERS, GLOBAL_TRACER, MergeStats
from ..ops.decode import CompactBlock, decode_doc_spans
from ..ops.encode import MAP_STREAM_COLS, MARK_COLS, DocEncoder, _DocStreams
from ..ops.kernel import apply_batch_compact
from ..ops.packed import VK_DELETED, VK_STR, PackedDocs, empty_docs
from ..ops.resolve import COMMENT_TYPE, LINK_TYPE, ResolvedDocs, resolve
from ..utils.device import resolve_device
from ..utils.interning import Interner, OrderedActorTable
from ..utils.shapes import next_pow2
from .causal import causal_schedule
from .mesh import (
    M32,
    convergence_digest,
    doc_digest_host,
    per_doc_format_digest,
    per_doc_register_digest,
    per_doc_text_digest,
)

# -- device programs (plain torch; the insert phase inside apply_batch is the
# one hand kernel on this path) ------------------------------------------------


def _resolve_digest(state: PackedDocs, comment_capacity: int, row_mask) -> tuple:
    """Span resolution without the comment planes + the TEXT-ONLY digest:
    ``(digest, overflow)``, a uint32 value (0-d int64) and the (D,) bool
    vector.  Masked docs contribute zero; their host replay hash is summed
    in instead (:meth:`StreamingMerge.digest`)."""
    resolved = resolve(state, comment_capacity, with_comments=False)
    mask = row_mask & ~resolved.overflow
    return convergence_digest(resolved.char, resolved.visible, doc_mask=mask), resolved.overflow


def _per_doc_full_digest(state, resolved, row_mask, sess_attr, sess_key,
                         comment_hash, row_map, obj_attr, obj_key) -> torch.Tensor:
    """(D,) per-doc FULL-STATE hashes (uint32 words as int64): visible text,
    resolved formatting (LWW winner bits, link url, comment-id sets) and the
    map-register table.  Interned identities enter only through content-hash
    tables: the session's (``sess_attr``/``sess_key``, flat, broadcast to
    rows here) and the per-doc overrides of object-path docs (``row_map``
    into ``obj_attr``/``obj_key``), so digests compare across sessions with
    different intern orders.  Masked or overflowed rows contribute ZERO
    (their host-side replay hash is summed in instead)."""
    d = row_map.shape[0]
    if obj_attr.shape[0]:
        safe = row_map.to(torch.int64).clamp(0, obj_attr.shape[0] - 1)
        is_obj = (row_map >= 0)[:, None]
        attr_hash = torch.where(is_obj, obj_attr[safe], sess_attr[None, :])
        key_hash = torch.where(is_obj, obj_key[safe], sess_key[None, :])
    else:
        attr_hash = sess_attr[None, :].expand(d, -1)
        key_hash = sess_key[None, :].expand(d, -1)
    mask = row_mask & ~resolved.overflow
    per_doc = per_doc_text_digest(resolved.char, resolved.visible)
    per_doc = per_doc + per_doc_format_digest(
        resolved.visible, resolved.lww_active, resolved.link_attr,
        resolved.comment_bits, attr_hash, comment_hash, COMMENT_TYPE, LINK_TYPE,
    )
    per_doc = per_doc + per_doc_register_digest(
        state.r_obj, state.r_key, state.r_op, state.r_kind, state.r_val,
        key_hash, VK_DELETED, VK_STR,
    )
    return torch.where(mask, per_doc & M32, 0)


def _resolve_block_digest(state: PackedDocs, comment_capacity: int, row_mask, *tables):
    """One block's span resolution (what every read path needs) plus its
    (D,) per-doc full-state hash vector: digest() and the reads share the
    resolution (the per-round block cache), and a digest-only sync point
    fetches just the vector and the overflow flags.  The resolution holds
    no view of ``state`` (block-chunked sessions write blocks back in
    place; a cached resolution must keep describing its own round)."""
    resolved = resolve(state, comment_capacity, with_comments=True)
    resolved = resolved._replace(char=resolved.char.clone())
    return resolved, _per_doc_full_digest(state, resolved, row_mask, *tables)


def _rows_digest(sub: PackedDocs, comment_capacity: int, row_mask, *tables):
    """Per-doc full-state hashes of a GATHERED row subset (the rows rounds
    touched, padded to a power of two; padding rows hash to zero):
    ``(per_doc, overflow)``."""
    resolved = resolve(sub, comment_capacity, with_comments=True)
    return _per_doc_full_digest(sub, resolved, row_mask, *tables), resolved.overflow


def _compact_packed(resolved: ResolvedDocs, elem_id: torch.Tensor, width: int) -> torch.Tensor:
    """Gather a resolved block's planes to a visible-prefix layout of
    ``width`` columns (visible chars keep their slot order) and concatenate
    everything into one (D, 2 + 4*width + words*width) int32 buffer:
    ``[n_vis | overflow | char | elem | link | lww | comment words]`` per
    row — one device->host transfer per block.  The LWW planes pack to one
    bitmask column group; the comment words (uint32 held in int64) are
    stored with their bit pattern in int32 and viewed as uint32 on the
    host."""
    if resolved.lww_active.shape[1] > 8:
        raise ValueError("the lww bitmask plane holds at most 8 mark types")
    # stable sort on an integer key: visible slots first, in slot order
    order = torch.argsort((~resolved.visible).to(torch.int32), dim=1, stable=True)[:, :width]
    take = lambda x: torch.gather(x, 1, order)  # noqa: E731
    n_vis = resolved.visible.sum(dim=1, dtype=torch.int32)
    lww_bits = torch.zeros(resolved.char.shape, dtype=torch.int32, device=order.device)
    for t in range(resolved.lww_active.shape[1]):
        lww_bits = lww_bits | (resolved.lww_active[:, t, :].to(torch.int32) << t)
    words = resolved.comment_bits & M32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)
    parts = [
        n_vis[:, None],
        resolved.overflow.to(torch.int32)[:, None],
        take(resolved.char.to(torch.int32)),
        take(elem_id.to(torch.int32)),
        take(resolved.link_attr.to(torch.int32)),
        take(lww_bits),
    ] + [take(words[:, w, :]) for w in range(words.shape[1])]
    return torch.cat(parts, dim=1)


def _unpack_compact(buf: np.ndarray, width: int, words: int) -> CompactBlock:
    """Host-side CompactBlock view over one packed sweep buffer."""
    w = width
    comment = (
        np.ascontiguousarray(buf[:, 2 + 4 * w:]).view(np.uint32).reshape(buf.shape[0], words, w)
        if words
        else np.zeros((buf.shape[0], 0, w), np.uint32)
    )
    return CompactBlock(
        buf[:, 0], buf[:, 2:2 + w], buf[:, 2 + w:2 + 2 * w], buf[:, 2 + 2 * w:2 + 3 * w],
        buf[:, 2 + 3 * w:2 + 4 * w].astype(np.uint8), comment, buf[:, 1].astype(bool),
    )


def _max_visible(visible: torch.Tensor) -> int:
    return int(visible.sum(dim=1).max()) if visible.shape[0] else 0


class _BlockResolution:
    """Per-(round, block) resolution: the resolved planes on the card, the
    per-doc full-state hash vector, and LAZY host copies.  Digest-only
    sync points fetch the hash vector and the overflow flags (D words and D
    bools); only span and patch reads pay the (D, S) plane transfer."""

    __slots__ = ("device", "digest_dev", "on_device", "_np", "_overflow", "_digest_vec")

    def __init__(self, device: ResolvedDocs, digest_dev: torch.Tensor, on_device: np.ndarray):
        self.device = device
        self.digest_dev = digest_dev  # (D,) per-doc hash vector, on the card
        self.on_device = on_device  # fallback mask the digest was made with
        self._np = None
        self._overflow = None
        self._digest_vec = None

    @property
    def digest_per_doc(self) -> np.ndarray:
        if self._digest_vec is None:
            self._digest_vec = self.digest_dev.cpu().numpy().astype(np.uint32)
        return self._digest_vec

    @property
    def overflow(self) -> np.ndarray:
        if self._overflow is None:
            self._overflow = self.device.overflow.cpu().numpy()
        return self._overflow

    def to_np(self) -> ResolvedDocs:
        if self._np is None:
            self._np = ResolvedDocs(*(x.cpu().numpy() for x in self.device))
            self._overflow = self._np.overflow
        return self._np


def _width_bucket(n: int) -> int:
    """Power-of-two width, at least 8: stream paddings, table widths and the
    insert kernel's slot window follow the reference package's buckets."""
    return max(8, next_pow2(n))


#: byte budget for the per-round CompactBlock cache (read_all and
#: read_patches_all share one transfer per block while it fits)
_COMPACT_CACHE_BYTES = 512 * 1024 * 1024

#: quarantine reasons of this slice: ``capacity`` (a change wider than the
#: round widths) and ``encode`` (a change the device cannot express) — the
#: doc left the device path for scalar replay (degraded but correct);
#: ``device-round`` is :meth:`StreamingMerge.force_fallback`'s default
REASON_CAPACITY = "capacity"
REASON_ENCODE = "encode"
REASON_DEVICE_ROUND = "device-round"


@dataclass
class QuarantineRecord:
    """Why one doc is quarantined (typed reason + free-form detail), and at
    which session round the quarantine was imposed."""

    reason: str
    detail: str = ""
    round: int = 0


@dataclass
class _DocSession:
    encoder: Optional[DocEncoder] = None
    clock: Clock = field(default_factory=dict)
    pending: List[Change] = field(default_factory=list)
    log: List[Change] = field(default_factory=list)
    fallback: bool = False


class _RoundBuffers:
    """One round's padded stream staging arrays (host side).  Fresh zeros
    each round (a calloc: untouched rows cost no page writes); only rows
    with scheduled work are filled."""

    __slots__ = ("ins_ref", "ins_op", "ins_char", "del_target", "marks",
                 "map_ops", "ins_count", "del_count", "mark_count",
                 "map_count", "num_ops")

    def __init__(self, d: int, ki: int, kd: int, km: int, kp: int) -> None:
        self.ins_ref = np.zeros((d, ki), np.int32)
        self.ins_op = np.zeros((d, ki), np.int32)
        self.ins_char = np.zeros((d, ki), np.int32)
        self.del_target = np.zeros((d, kd), np.int32)
        self.marks = {col: np.zeros((d, km), np.int32) for col in MARK_COLS}
        self.map_ops = {col: np.zeros((d, kp), np.int32) for col in MAP_STREAM_COLS}
        self.ins_count = np.zeros(d, np.int32)
        self.del_count = np.zeros(d, np.int32)
        self.mark_count = np.zeros(d, np.int32)
        self.map_count = np.zeros(d, np.int32)
        self.num_ops = np.zeros(d, np.int32)


def _upload(arrays: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Every int32 array of ``arrays`` on ``device`` through ONE copy of one
    concatenated buffer; returns views of it, shaped as the arrays.  The
    buffer is pageable and made here, so the copy has completed when this
    returns."""
    flat = np.concatenate([np.ascontiguousarray(a, np.int32).reshape(-1) for a in arrays.values()]) \
        if arrays else np.zeros(0, np.int32)
    dev = torch.from_numpy(flat).to(device)
    out, off = {}, 0
    for name, a in arrays.items():
        out[name] = dev[off:off + a.size].view(a.shape)
        off += a.size
    return out


class StreamingMerge:
    """Incremental multi-round merge of up to ``num_docs`` documents.

    ``actors`` declares the replica set whose changes may arrive (needed up
    front: packed op-ID order requires a complete ordered actor table; an
    undeclared actor demotes that doc to scalar-replay fallback).

    The constructor takes the reference package's arguments and defaults,
    plus ``device`` (default ``cuda``; raises without a card — pass
    ``device="cpu"`` for the plain torch path).  ``mesh=`` and the
    ``"paged"``/``"ragged"`` layouts are not ported yet and raise
    ``NotImplementedError``.
    """

    #: max rounds drain() schedules before committing them; bounds the host
    #: memory of a batch's staging buffers
    FUSE_MAX_ROUNDS = 8

    def __init__(
        self,
        num_docs: int,
        actors: Sequence[str],
        slot_capacity: int = 256,
        mark_capacity: int = 128,
        tomb_capacity: int = 128,
        round_insert_capacity: int = 64,
        round_delete_capacity: int = 32,
        round_mark_capacity: int = 32,
        round_map_capacity: int = 16,
        comment_capacity: int = 32,
        map_capacity: int = 32,
        read_chunk: int = 8192,
        mesh=None,
        tracer=None,
        static_rounds: bool = False,
        layout: str = "padded",
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        if layout not in ("padded", "paged", "ragged"):
            raise ValueError(f"unknown layout: {layout!r}")
        if layout == "paged":
            raise NotImplementedError(
                "layout='paged' is not ported yet (ROADMAP.md queue 1 item 7: 'Paged streaming')")
        if layout == "ragged":
            raise NotImplementedError(
                "layout='ragged' is not ported yet (ROADMAP.md queue 1 item 8: 'Ragged streaming')")
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet (ROADMAP.md queue 1 item 11: 'Multi-GPU mesh')")
        self.device = resolve_device(device)
        self.num_docs = num_docs
        self.actors = list(actors)
        self.mesh = None
        self._slot_capacity = int(slot_capacity)
        self._mark_capacity = int(mark_capacity)
        self._tomb_capacity = int(tomb_capacity)
        self._map_capacity = int(map_capacity)
        #: serving-tier shape discipline: every round through the padded
        #: (D, K) apply at the configured widths (no adaptive shrink)
        self.static_rounds = bool(static_rounds)
        self.tracer = tracer if tracer is not None else GLOBAL_TRACER
        #: MergeStats of the most recent committed round batch
        self.last_round_stats: Optional[MergeStats] = None
        #: per-drain schedule/apply span sums (reset by drain())
        self.last_drain_marks: Optional[Dict[str, float]] = None
        self._pad_real_ops = 0
        self._pad_capacity = 0
        self.round_caps = (round_insert_capacity, round_delete_capacity,
                           round_mark_capacity, round_map_capacity)
        self.comment_capacity = comment_capacity
        # sessions larger than a read block pad the doc axis to a block
        # multiple; padded rows are permanently empty docs (all-zero streams
        # are no-ops), invisible in the public API
        if num_docs > read_chunk:
            self._padded_docs = -(-num_docs // read_chunk) * read_chunk
        else:
            self._padded_docs = num_docs
        self._read_chunk_requested = read_chunk
        self._read_chunk = max(1, min(read_chunk, max(num_docs, 1)))
        self.docs = [_DocSession() for _ in range(num_docs)]
        self._quarantine: Dict[int, QuarantineRecord] = {}
        self.rounds = 0
        self._patch_base: Dict[int, list] = {}
        # per-round cache of block resolutions: (rounds, {block: entry})
        self._resolved_cache = (-1, {})
        # incremental convergence digest: per-ROW full-state hashes carried
        # across rounds; a round invalidates only the rows it applied ops to
        self._digest_plane = np.zeros(self._padded_docs, np.uint32)
        self._digest_ov = np.zeros(self._padded_docs, bool)
        self._digest_row_valid = np.zeros(self._padded_docs, bool)
        # physical placement: logical doc d lives in device row _row_of[d];
        # _doc_at is the inverse (-1 = pad row).  Identity in this slice
        # (reshard, which moves rows, is not ported yet)
        self._row_of = np.arange(num_docs, dtype=np.int64)
        self._doc_at = np.full(self._padded_docs, -1, np.int64)
        self._doc_at[:num_docs] = np.arange(num_docs)
        self._digest_tables_cache: Dict = {}
        self._compact_cache: tuple = (-1, {}, 0)
        #: per-block visible-prefix widths (-1 = session-wide prior)
        self._compact_width: Dict[int, int] = {}
        self._actor_table = OrderedActorTable(self.actors)
        # session-level interners: the digest's session tables and the key
        # table of docs that never encoded (every object doc interns its
        # own attrs and keys; frame ingest, not ported, shares these)
        self._session_attrs = Interner()
        self._map_keys = Interner()
        self._object_pending: set = set()
        #: when True, a drain of a one-block session ends with the block's
        #: resolution and digest already computed, so the next digest() or
        #: read finds them cached
        self.prefetch_digest = False
        #: the reference's compat switch (its per-round commit discipline);
        #: every round commits the same way here, and False only turns the
        #: drain-end digest prefetch off
        self.fused_pipeline = True
        # per-row cumulative admitted inserts: an upper bound on each row's
        # slot occupancy; its power-of-two bucket bounds the insert kernel's
        # slot window each round
        self._cum_ins = np.zeros(self._padded_docs, np.int64)
        self.state: PackedDocs = empty_docs(
            self._padded_docs, slot_capacity, mark_capacity, tomb_capacity,
            map_capacity=map_capacity, device=self.device,
        )

    # -- ingestion ---------------------------------------------------------

    def ingest(self, doc_index: int, changes: Iterable[Change]) -> None:
        """Queue newly-arrived changes for one document (any order, dups ok)."""
        sess = self.docs[doc_index]
        changes = list(changes)
        if not changes:
            return
        sess.pending.extend(changes)
        self._object_pending.add(doc_index)

    # -- quarantine ----------------------------------------------------------

    def quarantine_doc(self, doc_index: int, reason: str, detail: str = "") -> None:
        """Quarantine one doc with a typed reason (idempotent per doc: the
        first record stays)."""
        if doc_index not in self._quarantine:
            self._quarantine[doc_index] = QuarantineRecord(
                reason=reason, detail=detail, round=self.rounds
            )

    def quarantined(self) -> Dict[int, QuarantineRecord]:
        """Snapshot of the quarantine registry (doc -> record)."""
        return dict(self._quarantine)

    def _demote(self, doc_index: int, reason: str, detail: str) -> None:
        sess = self.docs[doc_index]
        if not sess.fallback:
            sess.fallback = True
            GLOBAL_COUNTERS.add("streaming.fallback_docs")
        self.quarantine_doc(doc_index, reason, detail)

    def force_fallback(self, doc_index: int, reason: str = REASON_DEVICE_ROUND,
                       detail: str = "") -> None:
        """Demote one doc to scalar replay (degraded but correct) and
        quarantine it with ``reason``; pending work folds into the replay
        log."""
        sess = self.docs[doc_index]
        self._demote(doc_index, reason, detail)
        sess.log.extend(sess.pending)
        sess.pending = []
        self._object_pending.discard(doc_index)

    # -- the incremental device round --------------------------------------

    def step(self) -> int:
        """Apply every admissible pending change in one device round; returns
        the number of changes scheduled."""
        with self.tracer.span("streaming.round") as rsp:
            with self.tracer.span("streaming.schedule") as ssp:
                enc, widths, scheduled = self._schedule_round()
            if scheduled:
                with self.tracer.span("streaming.apply", rounds=1) as asp:
                    self._commit_rounds([(enc, widths)])
                self._emit_round_stats([(enc, widths)], scheduled, ssp.duration, asp.duration)
            rsp.args["scheduled"] = scheduled
        return scheduled

    def _emit_round_stats(self, batch, scheduled: int, schedule_s: float, apply_s: float) -> None:
        """Per-commit MergeStats: ``encode_seconds`` is the schedule span,
        ``apply_seconds`` the host dispatch wall of the commit (device work
        is asynchronous; reads are the sync points)."""
        touched: set = set()
        real = capacity = 0
        for enc, widths in batch:
            touched.update(int(r) for r in np.nonzero(enc.num_ops)[0])
            real += int(enc.num_ops.sum())
            capacity += self._padded_docs * sum(widths)
        self.last_round_stats = MergeStats(
            docs=len(touched),
            device_docs=len(touched),
            device_ops=real,
            encode_seconds=schedule_s,
            apply_seconds=apply_s,
            padding_efficiency=real / capacity if capacity else 0.0,
            extras={"rounds": len(batch), "scheduled_changes": scheduled},
        )
        if self.last_drain_marks is not None:
            self.last_drain_marks["schedule_seconds"] += schedule_s
            self.last_drain_marks["apply_seconds"] += apply_s
            self.last_drain_marks["rounds"] += len(batch)
        self._pad_real_ops += real
        self._pad_capacity += capacity

    def _schedule_round(self):
        """The HOST half of a round: causal admission of every object doc's
        pending changes into staging buffers, and width selection — no
        device work.  Returns ``(enc, widths, scheduled)``."""
        ki, kd, km, kp = self.round_caps
        scheduled = 0
        obj_streams: Dict[int, _DocStreams] = {}
        for i in sorted(self._object_pending):
            sess = self.docs[i]
            if sess.fallback:
                sess.log.extend(sess.pending)
                sess.pending = []
                self._object_pending.discard(i)
                continue
            if sess.encoder is None:
                sess.encoder = DocEncoder(self.actors)
            ordered, stuck = causal_schedule(sess.pending, sess.clock)
            # admit the longest causal prefix whose streams fit the widths;
            # the rest waits for a later round
            admitted, deferred = self._budget(ordered, ki, kd, km, kp)
            if not admitted and ordered and self._never_fits(ordered[0], ki, kd, km, kp):
                # a change wider than a round can never be admitted: demote
                # instead of wedging the doc forever
                self._demote(i, REASON_CAPACITY, "change exceeds round stream widths")
            streams, ok = sess.encoder.encode_increment(admitted)
            if not ok:
                self._demote(i, REASON_ENCODE, "change not device-expressible")
            else:
                for ch in admitted:
                    sess.clock[ch.actor] = ch.seq
                scheduled += len(admitted)
                if streams.ins or streams.dels or streams.marks or streams.maps:
                    obj_streams[i] = streams
            sess.log.extend(admitted)
            sess.pending = deferred + stuck
            if sess.fallback:
                sess.log.extend(sess.pending)
                sess.pending = []
            if not sess.pending:
                self._object_pending.discard(i)

        if scheduled == 0:
            return None, None, 0
        # adaptive widths: a shared power-of-two shift per stream kind for
        # trickle rounds; block-chunked and static-round sessions keep the
        # configured widths
        if self._padded_docs <= self._read_chunk and not self.static_rounds:
            ki, kd, km, kp = self._round_widths(obj_streams, ki, kd, km, kp)

        enc = _RoundBuffers(self._padded_docs, ki, kd, km, kp)
        for i, streams in obj_streams.items():
            r = int(self._row_of[i])
            if streams.ins:
                arr = np.asarray(streams.ins, np.int32)
                enc.ins_ref[r, : len(arr)] = arr[:, 0]
                enc.ins_op[r, : len(arr)] = arr[:, 1]
                enc.ins_char[r, : len(arr)] = arr[:, 2]
            if streams.dels:
                enc.del_target[r, : len(streams.dels)] = streams.dels
            if streams.marks:
                arr = np.asarray(streams.marks, np.int32)
                for c, col in enumerate(MARK_COLS):
                    enc.marks[col][r, : len(arr)] = arr[:, c]
                enc.mark_count[r] = len(arr)
            if streams.maps:
                arr = np.asarray(streams.maps, np.int32)
                for c, col in enumerate(MAP_STREAM_COLS):
                    enc.map_ops[col][r, : len(arr)] = arr[:, c]
                enc.map_count[r] = len(arr)
            enc.ins_count[r] = len(streams.ins)
            enc.del_count[r] = len(streams.dels)
            enc.num_ops[r] = (len(streams.ins) + len(streams.dels)
                              + len(streams.marks) + len(streams.maps))
        GLOBAL_COUNTERS.add("streaming.scheduled_changes", scheduled)
        return enc, (ki, kd, km, kp), scheduled

    @staticmethod
    def _round_widths(obj_streams, ki: int, kd: int, km: int, kp: int):
        """Shrink this round's stream widths: each kind to the power-of-two
        bucket (at least 8) of its largest admitted doc, never past the
        configured width."""
        need = [max((len(getattr(s, f)) for s in obj_streams.values()), default=0)
                for f in ("ins", "dels", "marks", "maps")]
        return tuple(min(cap, _width_bucket(max(n, 8)))
                     for cap, n in zip((ki, kd, km, kp), need))

    @staticmethod
    def _op_counts(change: Change) -> tuple:
        """(inserts, deletes, marks, map-register ops) — the round-width cost
        model shared by admission budgeting and the never-fits check."""
        ci = cd = cm = cp = 0
        for op in change.ops:
            if op.action == "set" and op.insert:
                ci += 1
            elif op.action == "del" and op.elem_id is not None:
                cd += 1
            elif op.action in ("addMark", "removeMark"):
                cm += 1
            else:  # map set/del/makeMap/makeList -> one register row
                cp += 1
        return ci, cd, cm, cp

    @classmethod
    def _never_fits(cls, change: Change, ki: int, kd: int, km: int, kp: int) -> bool:
        ci, cd, cm, cp = cls._op_counts(change)
        return ci > ki or cd > kd or cm > km or cp > kp

    @classmethod
    def _budget(cls, ordered: List[Change], ki: int, kd: int, km: int, kp: int):
        """Admit the longest causal prefix whose op streams fit the round
        widths."""
        ins = dels = marks = maps = 0
        admitted: List[Change] = []
        for idx, ch in enumerate(ordered):
            ci, cd, cm, cp = cls._op_counts(ch)
            if ins + ci > ki or dels + cd > kd or marks + cm > km or maps + cp > kp:
                return admitted, ordered[idx:]
            ins, dels, marks, maps = ins + ci, dels + cd, marks + cm, maps + cp
            admitted.append(ch)
        return admitted, []

    # -- committing rounds -----------------------------------------------------
    #
    # Every committed round takes one path: its flat streams, one upload and
    # one apply_batch_compact per touched block, bounded by the round's slot
    # window.  The reference's dispatch forms (staged and stacked batches,
    # single-round forms) exist to share XLA compiles and to overlap uploads
    # with scheduling; torch compiles nothing, and no result depends on the
    # form (ROADMAP.md queue 1 item 5b).

    def _fused_eligible(self) -> bool:
        """Whether a drain ends with the digest prefetch (when armed): the
        compat switch is on and the session is one block.  Every round
        commits the same way either way."""
        return self.fused_pipeline and self._padded_docs <= self._read_chunk

    def _loop_slots(self) -> Optional[int]:
        """The insert kernel's slot window for the round just admitted
        (after ``_cum_ins`` absorbed it): the power-of-two bucket of the
        largest row's admitted inserts, or None (the whole capacity)."""
        bound = _width_bucket(int(self._cum_ins.max()))
        return bound if bound < self._slot_capacity else None

    def _commit_rounds(self, batch) -> None:
        """The DEVICE half: commit scheduled rounds ``[(enc, widths), ...]``
        in causal order, one at a time."""
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            self._apply_compact(enc, widths, self._loop_slots())
            self._digest_row_valid[np.nonzero(enc.num_ops)[0]] = False
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")

    @staticmethod
    def _flatten_round(enc: _RoundBuffers, widths, lo: int, hi: int):
        """Doc-major flat streams + counts for rows [lo, hi) of a round."""
        ki, kd, km, kp = widths
        ic, dc = enc.ins_count[lo:hi], enc.del_count[lo:hi]
        mc, pc = enc.mark_count[lo:hi], enc.map_count[lo:hi]
        mi = np.arange(ki, dtype=np.int32)[None, :] < ic[:, None]
        md = np.arange(kd, dtype=np.int32)[None, :] < dc[:, None]
        mm = np.arange(km, dtype=np.int32)[None, :] < mc[:, None]
        mp = np.arange(kp, dtype=np.int32)[None, :] < pc[:, None]
        return (
            (ic, dc, mc, pc),
            (enc.ins_ref[lo:hi][mi], enc.ins_op[lo:hi][mi], enc.ins_char[lo:hi][mi]),
            enc.del_target[lo:hi][md],
            {col: enc.marks[col][lo:hi][mm] for col in MARK_COLS},
            {col: enc.map_ops[col][lo:hi][mp] for col in MAP_STREAM_COLS},
        )

    @staticmethod
    def _pad(v: np.ndarray, cap: int) -> np.ndarray:
        out = np.zeros(cap, np.int32)
        out[: len(v)] = v
        return out

    def _apply_compact(self, enc: _RoundBuffers, widths, loop_slots: Optional[int]) -> None:
        """One round through the flat-stream apply.  Sessions larger than a
        read block apply BLOCK-CHUNKED: each touched block's rows take their
        flat streams (every block padded to one shared power-of-two bucket
        per stream kind), apply on a view of the block, and are written back
        into the session state in place; untouched blocks are not read.
        Each touched block launches the insert kernel once
        (``streaming.block_applies`` counts them)."""
        d = self._padded_docs
        n_blocks = -(-d // self._read_chunk)
        touched = [bi for bi in range(n_blocks)
                   if enc.num_ops[slice(*self._block_bounds(bi))].any()]
        if not touched:
            return
        flats = {bi: self._flatten_round(enc, widths, *self._block_bounds(bi)) for bi in touched}
        if n_blocks == 1:
            buckets = None
        else:
            buckets = (
                _width_bucket(max(len(f[1][0]) for f in flats.values())),
                _width_bucket(max(len(f[2]) for f in flats.values())),
                _width_bucket(max(len(f[3][MARK_COLS[0]]) for f in flats.values())),
                _width_bucket(max(len(f[4][MAP_STREAM_COLS[0]]) for f in flats.values())),
            )
        for bi in touched:
            counts, ins, dels, marks, maps = flats[bi]
            b_ins, b_del, b_mark, b_map = buckets or (
                _width_bucket(len(ins[0])), _width_bucket(len(dels)),
                _width_bucket(len(marks[MARK_COLS[0]])), _width_bucket(len(maps[MAP_STREAM_COLS[0]])))
            arrays = {f"n{j}": c for j, c in enumerate(counts)}
            arrays.update({f"ins{j}": self._pad(v, b_ins) for j, v in enumerate(ins)})
            arrays["del"] = self._pad(dels, b_del)
            arrays.update({f"mark.{c}": self._pad(marks[c], b_mark) for c in MARK_COLS})
            arrays.update({f"map.{c}": self._pad(maps[c], b_map) for c in MAP_STREAM_COLS})
            t = _upload(arrays, self.device)
            new = apply_batch_compact(
                self._state_block(bi), tuple(t[f"n{j}"] for j in range(4)),
                (t["ins0"], t["ins1"], t["ins2"]), t["del"],
                {c: t[f"mark.{c}"] for c in MARK_COLS},
                {c: t[f"map.{c}"] for c in MAP_STREAM_COLS},
                widths=widths, insert_loop_slots=loop_slots,
            )
            GLOBAL_COUNTERS.add("streaming.block_applies")
            if n_blocks == 1:
                self.state = new
            else:
                lo, hi = self._block_bounds(bi)
                for x, y in zip(self.state, new):
                    x[lo:hi] = y

    # -- drains ------------------------------------------------------------------

    def drain(self, max_rounds: int = 1_000) -> int:
        """Drain all admissible pending work; returns rounds run.

        Scheduling is host-only (causal clocks), so drain schedules a batch
        of up to :attr:`FUSE_MAX_ROUNDS` rounds first and then commits it.
        With :attr:`prefetch_digest` armed (and :meth:`_fused_eligible`),
        the drain ends with the block's resolution and digest computed, so
        the next digest() or read finds them cached."""
        self.last_drain_marks = {"schedule_seconds": 0.0, "apply_seconds": 0.0, "rounds": 0}
        fused = self._fused_eligible()
        rounds = 0
        while rounds < max_rounds:
            batch, scheduled_total, ssp = self._schedule_batch(rounds, max_rounds)
            if not batch:
                break
            with self.tracer.span("streaming.apply", rounds=len(batch)) as asp:
                self._commit_rounds(batch)
            if fused:
                GLOBAL_COUNTERS.add("streaming.fused_dispatches")
            self._emit_round_stats(batch, scheduled_total, ssp.duration, asp.duration)
            rounds += len(batch)
        if rounds and fused and self.prefetch_digest:
            self._digest_resolution(0)
            GLOBAL_COUNTERS.add("streaming.digest_chained")
        return rounds

    def _schedule_batch(self, rounds: int, max_rounds: int):
        """Schedule the next batch: up to FUSE_MAX_ROUNDS rounds within the
        drain's ``max_rounds``."""
        batch = []
        scheduled_total = 0
        with self.tracer.span("streaming.schedule") as ssp:
            while len(batch) < self.FUSE_MAX_ROUNDS and rounds + len(batch) < max_rounds:
                enc, widths, scheduled = self._schedule_round()
                if not scheduled:
                    break
                batch.append((enc, widths))
                scheduled_total += scheduled
        return batch, scheduled_total, ssp

    # -- block-cached resolution ---------------------------------------------
    #
    # Reads resolve the doc axis in blocks of ``read_chunk`` docs: a whole-
    # batch resolution at 100K docs would materialize multi-GB comment
    # planes.  Blocks are cached per round with at most two resident.

    @staticmethod
    def _replay_changes(sess: _DocSession) -> List[Change]:
        """A doc's full change history for scalar replay."""
        return sess.log + sess.pending

    @staticmethod
    def _attr_tables(sess: _DocSession):
        """(attr table, comment-id table) for decode: object docs intern
        both in their encoder's attr table."""
        attrs = sess.encoder.attrs if sess.encoder else None
        return attrs, attrs

    def _block_bounds(self, block_index: int):
        lo = block_index * self._read_chunk
        return lo, min(lo + self._read_chunk, self._padded_docs)

    def _n_blocks(self) -> int:
        return -(-self._padded_docs // self._read_chunk)

    def _state_block(self, block_index: int) -> PackedDocs:
        """The session state's rows of one block (views, not copies)."""
        lo, hi = self._block_bounds(block_index)
        if lo == 0 and hi == self._padded_docs:
            return self.state
        return PackedDocs(*(x[lo:hi] for x in self.state))

    def _block_fallback_mask(self, block_index: int) -> np.ndarray:
        """(block,) bool: rows currently served by the device (a real doc's
        row, and that doc not fallback)."""
        lo, hi = self._block_bounds(block_index)
        on_device = np.zeros(hi - lo, bool)
        for local, d in enumerate(self._doc_at[lo:hi]):
            if d >= 0:
                on_device[local] = not self.docs[d].fallback
        return on_device

    def _resolution(self, block_index: int) -> _BlockResolution:
        """Per-round cached resolution + full-state digest vector of one doc
        block (digest() and the read paths share it).  The cached digest's
        doc mask is validated only by the digest consumers; reads route each
        doc on its current ``fallback`` flag first."""
        stamp, cache = self._resolved_cache
        if stamp != self.rounds:
            cache = {}
            self._resolved_cache = (self.rounds, cache)
        if block_index in cache:
            entry = cache.pop(block_index)  # re-insert: LRU, not FIFO
            cache[block_index] = entry
            return entry
        lo, hi = self._block_bounds(block_index)
        on_device = self._block_fallback_mask(block_index)
        with self.tracer.span("streaming.resolve", block=block_index):
            resolved, digest_dev = _resolve_block_digest(
                self._state_block(block_index), self.comment_capacity,
                torch.from_numpy(on_device).to(self.device), *self._digest_tables(lo, hi),
            )
        entry = _BlockResolution(resolved, digest_dev, on_device)
        if len(cache) >= 2:  # bound device memory at large scale
            cache.pop(next(iter(cache)))  # least-recently-used
        cache[block_index] = entry
        return entry

    def _digest_resolution(self, block_index: int) -> _BlockResolution:
        """_resolution plus doc-mask freshness: a fallback transition without
        a round bump invalidates the digest's mask — recompute the block."""
        entry = self._resolution(block_index)
        if not np.array_equal(entry.on_device, self._block_fallback_mask(block_index)):
            self._resolved_cache[1].pop(block_index, None)
            entry = self._resolution(block_index)
        return entry

    def _resolved_doc(self, doc_index: int):
        """(numpy resolved block, index of the doc within it)."""
        row = int(self._row_of[doc_index])
        bi = row // self._read_chunk
        return self._resolution(bi).to_np(), row - bi * self._read_chunk

    # -- reads (synchronization points) ------------------------------------

    def read(self, doc_index: int) -> List[FormatSpan]:
        sess = self.docs[doc_index]
        if sess.fallback:
            return _replay_spans(self._replay_changes(sess))
        resolved, local = self._resolved_doc(doc_index)
        if bool(resolved.overflow[local]):
            return _replay_spans(self._replay_changes(sess))
        attrs, comments = self._attr_tables(sess)
        return decode_doc_spans(resolved, local, attrs, comments)

    def read_patches(self, doc_index: int) -> List:
        """Incremental reference-shaped patches since this doc's previous
        ``read_patches`` call (the first call builds the doc from empty):
        the doc's state is diffed host-side between reads (ops/patches.py),
        keyed on stable element identities."""
        from ..ops.patches import diff_patches

        chars = self._doc_chars(doc_index)
        patches = diff_patches(self._patch_base.get(doc_index, []), chars)
        self._patch_base[doc_index] = chars
        return patches

    def _doc_chars(self, doc_index: int):
        from ..ops.patches import doc_chars_device, doc_chars_scalar

        sess = self.docs[doc_index]
        if sess.fallback:
            return doc_chars_scalar(_replay_doc(self._replay_changes(sess)))
        resolved, local = self._resolved_doc(doc_index)
        if bool(resolved.overflow[local]):
            return doc_chars_scalar(_replay_doc(self._replay_changes(sess)))
        attrs, comments = self._attr_tables(sess)
        bi = int(self._row_of[doc_index]) // self._read_chunk
        elem = self._state_block(bi).elem_id[local].cpu().numpy()
        return doc_chars_device(resolved, local, attrs, elem, self._actor_table, comments)

    def resolve_cursors(self, doc_index: int, cursors) -> List[int]:
        """Resolve stable cursors (reference ``Cursor`` dicts) for one doc;
        see :meth:`resolve_cursors_batch`."""
        return self.resolve_cursors_batch({doc_index: list(cursors)})[doc_index]

    def resolve_cursors_batch(self, cursor_map) -> Dict[int, List[int]]:
        """Resolve cursors for many docs, one batched device call per block.
        ``cursor_map``: {doc_index: [Cursor, ...]}.  Fallback and overflowed
        docs resolve by scalar replay.  Returns visible indices per doc, -1
        for absent elements."""
        from ..ops.resolve import oracle_cursor_positions, pack_cursor_rows, resolve_cursors

        device_map, replay_docs = {}, []
        for d, cursors in cursor_map.items():
            if self.docs[d].fallback:
                replay_docs.append(d)
                continue
            row = int(self._row_of[d])
            bi = row // self._read_chunk
            if bool(self._resolution(bi).overflow[row - bi * self._read_chunk]):
                replay_docs.append(d)
            else:
                device_map[d] = cursors
        out: Dict[int, List[int]] = {}
        by_block: Dict[int, Dict[int, list]] = {}
        for d, cursors in device_map.items():
            by_block.setdefault(int(self._row_of[d]) // self._read_chunk, {})[d] = cursors
        for bi, block_map in by_block.items():
            lo, hi = self._block_bounds(bi)
            local_map = {int(self._row_of[d]) - lo: c for d, c in block_map.items()}
            cursor_elem = pack_cursor_rows(local_map, hi - lo, lambda d: self._actor_table)
            positions = resolve_cursors(
                self._state_block(bi), self._resolution(bi).device.visible,
                torch.from_numpy(cursor_elem).to(self.device),
            ).cpu().numpy()
            for d, cursors in block_map.items():
                out[d] = [int(p) for p in positions[int(self._row_of[d]) - lo, : len(cursors)]]
        for d in replay_docs:
            doc = _replay_doc(self._replay_changes(self.docs[d]))
            out[d] = oracle_cursor_positions(doc, cursor_map[d])
        return out

    def read_root(self, doc_index: int) -> dict:
        """One doc's root map (nested maps + the text character list):
        device docs decode their LWW register table, fallback docs replay
        through the oracle."""
        from ..ops.decode import decode_doc_root

        sess = self.docs[doc_index]
        if sess.fallback:
            return _replay_doc(self._replay_changes(sess)).root
        resolved, local = self._resolved_doc(doc_index)
        if bool(resolved.overflow[local]):
            return _replay_doc(self._replay_changes(sess)).root
        block = self._state_block(int(self._row_of[doc_index]) // self._read_chunk)
        regs = SimpleNamespace(**{
            f: getattr(block, f)[local:local + 1].cpu().numpy()
            for f in ("r_obj", "r_key", "r_op", "r_kind", "r_val", "num_regs")
        })
        one = ResolvedDocs(*(x[local:local + 1] for x in resolved))
        keys = sess.encoder.keys if sess.encoder else self._map_keys
        return decode_doc_root(regs, one, 0, keys)

    def _block_tables(self, lo: int):
        """(attr_of, comment_of) accessors for block-local ROW indices."""
        def attr_of(local: int):
            return self._attr_tables(self.docs[int(self._doc_at[lo + local])])[0]

        def comment_of(local: int):
            table = self._attr_tables(self.docs[int(self._doc_at[lo + local])])[1]
            return table if table is not None else Interner()

        return attr_of, comment_of

    def _block_device_mask(self, compact: CompactBlock, lo: int, hi: int) -> np.ndarray:
        """Rows of a block served from device state (not fallback/overflow)."""
        return self._block_fallback_mask(lo // self._read_chunk) & ~compact.overflow[: hi - lo]

    # -- the visible-prefix sweep ------------------------------------------------

    def _compact_cached(self, block_index: int):
        if self._compact_cache[0] != self.rounds:
            self._compact_cache = (self.rounds, {}, 0)
        return self._compact_cache[1].get(block_index)

    def _compact_store(self, block_index: int, c: CompactBlock) -> None:
        stamp, cache, nbytes = self._compact_cache
        if nbytes + c.nbytes <= _COMPACT_CACHE_BYTES:
            cache[block_index] = c
            self._compact_cache = (stamp, cache, nbytes + c.nbytes)

    def _compact_width_for(self, block_index: int, entry: _BlockResolution) -> int:
        """Visible-prefix width for a block's packed transfer.  The first
        block pays one device read for its max visible count; later blocks
        start from the session-wide prior, and _finish_compact widens on
        the rare miss."""
        width = self._compact_width.get(block_index) or self._compact_width.get(-1)
        if width is None:
            width = min(_width_bucket(_max_visible(entry.device.visible)), self._slot_capacity)
            self._compact_width[-1] = width
        self._compact_width[block_index] = width
        return width

    def _dispatch_compact(self, block_index: int):
        """Queue one block's packed visible-prefix gather; returns
        ``(device_buf, width)`` for :meth:`_finish_compact`."""
        entry = self._resolution(block_index)
        width = self._compact_width_for(block_index, entry)
        return _compact_packed(entry.device, self._state_block(block_index).elem_id, width), width

    def _finish_compact(self, block_index: int, buf: torch.Tensor, width: int) -> CompactBlock:
        """Fetch + unpack a packed buffer, re-fetching wider if any live
        row's visible count outgrew the width (never truncating)."""
        words = (buf.shape[1] - 2 - 4 * width) // max(width, 1)
        c = _unpack_compact(buf.cpu().numpy(), width, words)
        live = ~c.overflow & self._block_fallback_mask(block_index)
        if live.any():
            need = int(c.n_vis[live].max())
            if need > width:
                entry = self._resolution(block_index)
                wide = min(_width_bucket(need), self._slot_capacity,
                           int(entry.device.char.shape[1]))
                self._compact_width[block_index] = wide
                self._compact_width[-1] = max(self._compact_width.get(-1) or 0, wide)
                buf = _compact_packed(entry.device, self._state_block(block_index).elem_id, wide)
                c = _unpack_compact(buf.cpu().numpy(), wide, words)
        return c

    def _sweep_compact(self):
        """Iterate ``(block_index, CompactBlock)`` over the live blocks, with
        the next block's gather queued on the card while the caller decodes
        the current one."""
        blocks = [bi for bi in range(self._n_blocks())
                  if (self._doc_at[slice(*self._block_bounds(bi))] >= 0).any()]
        inflight: Dict[int, tuple] = {}
        for j, bi in enumerate(blocks):
            for b in blocks[j:j + 2]:
                if self._compact_cached(b) is None and b not in inflight:
                    inflight[b] = self._dispatch_compact(b)
            hit = self._compact_cached(bi)
            if hit is None:
                hit = self._finish_compact(bi, *inflight.pop(bi))
                self._compact_store(bi, hit)
            else:
                inflight.pop(bi, None)
            yield bi, hit

    def read_all(self) -> List[List[FormatSpan]]:
        """Span sweep over every doc: device docs decode in one vectorized
        pass per block over its visible-prefix transfer; fallback and
        overflow docs replay."""
        from ..ops.decode import decode_block_spans_compact

        with self.tracer.span("streaming.decode", docs=self.num_docs):
            out: List[Optional[List[FormatSpan]]] = [None] * self.num_docs
            for bi, compact in self._sweep_compact():
                lo, hi = self._block_bounds(bi)
                mask = self._block_device_mask(compact, lo, hi)
                attr_of, comment_of = self._block_tables(lo)
                spans = decode_block_spans_compact(compact, attr_of, comment_of, doc_mask=mask)
                for local, d in enumerate(self._doc_at[lo:hi]):
                    if d < 0:
                        continue
                    out[d] = spans[local] if mask[local] else \
                        _replay_spans(self._replay_changes(self.docs[d]))
            return out

    def read_patches_all(self) -> List[List]:
        """Batched incremental-patch sweep: one vectorized char-state
        extraction per block, then the per-doc identity diff; shares the
        per-block transfer with read_all within a round."""
        from ..ops.decode import block_char_states_compact
        from ..ops.patches import diff_patches, doc_chars_scalar

        with self.tracer.span("streaming.patch-scatter", docs=self.num_docs):
            out: List[List] = [None] * self.num_docs
            for bi, compact in self._sweep_compact():
                lo, hi = self._block_bounds(bi)
                mask = self._block_device_mask(compact, lo, hi)
                attr_of, comment_of = self._block_tables(lo)
                chars_block = block_char_states_compact(
                    compact, self._actor_table, attr_of, comment_of, doc_mask=mask)
                for local, d in enumerate(self._doc_at[lo:hi]):
                    if d < 0:
                        continue
                    chars = chars_block[local] if mask[local] else doc_chars_scalar(
                        _replay_doc(self._replay_changes(self.docs[d])))
                    out[d] = diff_patches(self._patch_base.get(d, []), chars)
                    self._patch_base[d] = chars
            return out

    # -- convergence digests -------------------------------------------------

    def _digest_tables(self, lo: int, hi: int):
        """Content-hash tables of rows [lo, hi) for the full digest, on the
        card: session attr and key tables (flat, broadcast to rows on the
        card), the per-doc overrides of object-path docs (``row_map`` into
        ``obj_attr``/``obj_key``, -1 = session tables) and per-row comment-id
        hashes.  Widths are power-of-two buckets, as the reference sizes
        them (an id past a table's width clips to its last column).  Cached
        until an interner grows or the object docs change."""
        sess_attr = self._session_attrs.content_hashes()
        sess_keys = self._map_keys.content_hashes()
        enc = {
            row: self.docs[d].encoder
            for row in range(lo, hi)
            if (d := int(self._doc_at[row])) >= 0 and self.docs[d].encoder is not None
        }
        key = (len(sess_attr), len(sess_keys),
               tuple((row, len(e.attrs), len(e.keys)) for row, e in sorted(enc.items())))
        cached = self._digest_tables_cache.get((lo, hi))
        if cached is not None and cached[0] == key:
            return cached[1]
        tables = self._hash_tables(hi - lo, sess_attr, sess_keys,
                                   {row - lo: e for row, e in enc.items()},
                                   _width_bucket(len(enc)) if enc else 0)
        self._digest_tables_cache[(lo, hi)] = (key, tables)
        return tables

    def _digest_tables_rows(self, rows: np.ndarray, n_real: int):
        """:meth:`_digest_tables` for a GATHERED row subset, by position in
        ``rows``; only the first ``n_real`` positions are real (the rest is
        power-of-two padding whose table entries stay zero)."""
        enc = {}
        for i in range(n_real):
            d = int(self._doc_at[rows[i]])
            if d >= 0 and self.docs[d].encoder is not None:
                enc[i] = self.docs[d].encoder
        return self._hash_tables(len(rows), self._session_attrs.content_hashes(),
                                 self._map_keys.content_hashes(), enc,
                                 _width_bucket(len(enc)) if enc else 0)

    def _hash_tables(self, n_rows: int, sess_attr, sess_keys, enc: Dict[int, DocEncoder],
                     n_obj: int):
        a_w = _width_bucket(max([len(sess_attr)] + [len(e.attrs) for e in enc.values()]))
        k_w = _width_bucket(max([len(sess_keys)] + [len(e.keys) for e in enc.values()]))
        c_w = self.comment_capacity
        sess_attr_t = np.zeros(a_w, np.int64)
        sess_attr_t[: len(sess_attr)] = sess_attr
        sess_key_t = np.zeros(k_w, np.int64)
        sess_key_t[: len(sess_keys)] = sess_keys
        row_map = np.full(n_rows, -1, np.int64)
        obj_attr = np.zeros((n_obj, a_w), np.int64)
        obj_key = np.zeros((n_obj, k_w), np.int64)
        comment_hash = np.zeros((n_rows, c_w), np.int64)
        # override rows in row order: row_map depends only on which rows
        # hold object docs
        for i, (row, e) in enumerate(sorted(enc.items())):
            ah = e.attrs.content_hashes()
            kh = e.keys.content_hashes()
            row_map[row] = i
            obj_attr[i, : len(ah)] = ah
            obj_key[i, : len(kh)] = kh
            # object-path comment marks index the same per-doc attr interner
            comment_hash[row, : min(c_w, len(ah))] = ah[: min(c_w, len(ah))]
        t = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return (t(sess_attr_t), t(sess_key_t), t(comment_hash), t(row_map),
                t(obj_attr), t(obj_key))

    def _on_device_mask(self) -> np.ndarray:
        """(padded,) bool: rows backed by device state (their doc not
        fallback)."""
        on_dev = np.zeros(self._padded_docs, bool)
        for d, s in enumerate(self.docs):
            if not s.fallback:
                on_dev[self._row_of[d]] = True
        return on_dev

    def _schedule_rows_digest(self, rest: np.ndarray):
        """The gathered sub-batch hash program for dirty rows ``rest``
        (padded to a power of two); returns ``(per_doc, overflow)`` on the
        card — the first ``len(rest)`` entries are the rows'."""
        k = _width_bucket(len(rest))
        rows_idx = np.zeros(k, np.int64)
        rows_idx[: len(rest)] = rest
        mask = np.zeros(k, bool)
        mask[: len(rest)] = True
        idx = torch.from_numpy(rows_idx).to(self.device)
        sub = PackedDocs(*(x[idx] for x in self.state))
        return _rows_digest(sub, self.comment_capacity, torch.from_numpy(mask).to(self.device),
                            *self._digest_tables_rows(rows_idx, len(rest)))

    def _refresh_digest_rows(self) -> np.ndarray:
        """Bring the carried per-row hash plane current for every on-device
        real-doc row, re-hashing only invalid rows: heavily-dirty blocks
        (over a quarter of their rows) through the block resolution shared
        with the reads, the remaining dirty rows in ONE gathered sub-batch."""
        on_dev = self._on_device_mask()
        need = ~self._digest_row_valid & on_dev & (self._doc_at >= 0)
        if not need.any():
            return on_dev
        for bi in range(self._n_blocks()):
            lo, hi = self._block_bounds(bi)
            if int(need[lo:hi].sum()) > (hi - lo) // 4:
                entry = self._digest_resolution(bi)
                self._digest_plane[lo:hi] = entry.digest_per_doc
                self._digest_ov[lo:hi] = entry.overflow
                self._digest_row_valid[lo:hi] = on_dev[lo:hi] & (self._doc_at[lo:hi] >= 0)
                need[lo:hi] = False
        rest = np.nonzero(need)[0]
        if len(rest):
            per_doc, ov = self._schedule_rows_digest(rest)
            self._digest_plane[rest] = per_doc.cpu().numpy()[: len(rest)].astype(np.uint32)
            self._digest_ov[rest] = ov.cpu().numpy()[: len(rest)]
            self._digest_row_valid[rest] = True
        return on_dev

    def digest(self, full: bool = True, refresh: bool = False) -> int:
        """Global convergence digest: two sessions that converged hold equal
        digests.

        ``full=True`` (default) digests the complete document state —
        visible text, resolved formatting and map registers, interned
        identities folded as content hashes; ``full=False`` is the cheaper
        text-only digest.  Device docs hash on the card; fallback and
        overflowed docs hash host-side with the bit-identical per-doc
        formula, so converged peers agree whatever their demotion histories.

        The full digest sums a carried per-row plane mod 2**32, re-hashing
        only rows invalidated since the last call; ``refresh=True`` re-hashes
        every row from the current state."""
        with self.tracer.span("streaming.digest", full=full, refresh=refresh):
            return self._digest(full, refresh)

    def _digest(self, full: bool, refresh: bool) -> int:
        if refresh:
            self._digest_row_valid[:] = False
            self._resolved_cache = (-1, {})
        replay_docs = [i for i, s in enumerate(self.docs) if s.fallback]
        if full:
            on_device_all = self._refresh_digest_rows()
            ok = self._digest_row_valid & on_device_all & ~self._digest_ov & (self._doc_at >= 0)
            total = int(self._digest_plane[ok].sum(dtype=np.uint32))
            replay_docs.extend(
                int(self._doc_at[r])
                for r in np.nonzero(self._digest_ov & on_device_all & (self._doc_at >= 0))[0]
            )
        else:
            on_device_all = self._on_device_mask()
            total = 0
            for bi in range(self._n_blocks()):
                lo, hi = self._block_bounds(bi)
                digest, overflow = _resolve_digest(
                    self._state_block(bi), self.comment_capacity,
                    torch.from_numpy(on_device_all[lo:hi]).to(self.device),
                )
                total = (total + int(digest)) & M32
                ov = overflow.cpu().numpy()
                replay_docs.extend(
                    int(self._doc_at[int(r) + lo])
                    for r in np.nonzero(ov & on_device_all[lo:hi])[0]
                    if int(self._doc_at[int(r) + lo]) >= 0
                )
        for i in replay_docs:
            total = (total + self._host_digest(i, full)) & M32
        return total

    def _host_digest(self, doc_index: int, full: bool = True) -> int:
        """A doc's digest term from its scalar replay."""
        doc = _replay_doc(self._replay_changes(self.docs[doc_index]))
        cps, slots = _doc_char_slots(doc)
        part = doc_digest_host(cps, slots, self._slot_capacity)
        if full:
            part = (part + _doc_full_extras_host(doc, slots, self._actor_table)) & M32
        return part

    def doc_digest(self, doc_index: int) -> int:
        """ONE doc's full-state convergence hash — exactly the per-doc term
        :meth:`digest` sums, so ``sum(doc_digest(i)) mod 2**32 == digest()``;
        comparable across sessions."""
        if not self.docs[doc_index].fallback:
            on_device_all = self._refresh_digest_rows()
            row = int(self._row_of[doc_index])
            if on_device_all[row] and not self._digest_ov[row]:
                return int(self._digest_plane[row])
        return self._host_digest(doc_index)

    # -- session state ---------------------------------------------------------

    @property
    def config(self) -> Dict[str, int]:
        """Constructor-shape configuration."""
        return {
            "num_docs": self.num_docs,
            "slot_capacity": self._slot_capacity,
            "mark_capacity": self._mark_capacity,
            "tomb_capacity": self._tomb_capacity,
            "round_insert_capacity": self.round_caps[0],
            "round_delete_capacity": self.round_caps[1],
            "round_mark_capacity": self.round_caps[2],
            "round_map_capacity": self.round_caps[3],
            "comment_capacity": self.comment_capacity,
            "map_capacity": self._map_capacity,
            "read_chunk": self._read_chunk_requested,
            "layout": self.layout,
        }

    def frontier(self) -> Clock:
        """Merged vector-clock frontier across all docs, keys sorted."""
        merged: Clock = {}
        for sess in self.docs:
            for actor, seq in sorted(sess.clock.items()):
                merged[actor] = max(merged.get(actor, 0), seq)
        return dict(sorted(merged.items()))

    def overflow_count(self) -> int:
        """Docs the device read path cannot serve (apply-time overflow or
        resolve-time errors) — the docs read() routes to scalar replay."""
        return sum(int(self._resolution(bi).overflow.sum()) for bi in range(self._n_blocks()))

    def pending_count(self) -> int:
        return sum(len(s.pending) for s in self.docs)

    def pending_rounds_estimate(self) -> int:
        """Upper-bound estimate of the rounds a full ``drain()`` needs: the
        deepest per-doc pending queue."""
        return max((len(s.pending) for s in self.docs), default=0)

    @property
    def layout(self) -> str:
        """Resident-state storage layout."""
        return "padded"

    def sync_device(self) -> None:
        """Block until all queued device work has completed."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _doc_text_list_id(doc: Doc):
    """The doc's text list object id, or None: the earliest-created list
    (minimum (ctr, actor) opid), located by object, not by key."""
    list_ids = [oid for oid, meta in doc._metadata.items()
                if isinstance(meta, list) and oid in doc._objects]
    if not list_ids:
        return None
    return min(list_ids)


def _doc_char_slots(doc: Doc):
    """(visible codepoints, their slot positions in full element order incl.
    tombstones) for a scalar replica's text list — the inputs of the device
    text digest (mesh.doc_digest_host)."""
    list_id = _doc_text_list_id(doc)
    if list_id is None:
        return [], []
    meta = doc._metadata[list_id]
    text = doc._objects[list_id]
    cps, slots, vis = [], [], 0
    for i, el in enumerate(meta):
        if not el.deleted:
            cps.append(ord(text[vis]))
            slots.append(i)
            vis += 1
    return cps, slots


def _doc_path_of_object(doc: Doc, target) -> Optional[list]:
    """Key path from the root map to ``target`` (BFS over map children)."""
    from ..core.doc import MapMeta
    from ..core.opids import ROOT

    queue = [(ROOT, [])]
    seen = set()
    while queue:
        oid, path = queue.pop(0)
        if oid in seen:
            continue
        seen.add(oid)
        meta = doc._metadata.get(oid)
        if not isinstance(meta, MapMeta):
            continue
        for key, child in sorted(meta.children.items()):
            if child == target:
                return path + [key]
            queue.append((child, path + [key]))
    return None


def _doc_full_extras_host(doc: Doc, slot_positions, actor_table) -> int:
    """Formatting + map-register digest term of ONE scalar-replay doc,
    bit-identical to the device sums (mesh.format_digest_host and
    register_digest_host).  ``slot_positions`` are the visible characters'
    element-order slots from :func:`_doc_char_slots`."""
    import json

    from ..core.doc import MapMeta
    from ..core.opids import ROOT
    from ..ops.packed import (MAX_CTR, OBJ_ROOT, VK_FALSE, VK_INT, VK_NULL, VK_OBJ,
                              VK_TEXT, VK_TRUE, pack_id)
    from ..schema import ALL_MARKS
    from ..utils.interning import content_hash32
    from .mesh import format_digest_host, register_digest_host

    marks_per_char: list = []
    list_id = _doc_text_list_id(doc)
    if list_id is not None and slot_positions:
        path = _doc_path_of_object(doc, list_id)
        if path is not None:
            for span in doc.get_text_with_formatting(path):
                marks_per_char.extend([span["marks"]] * len(span["text"]))
    if len(marks_per_char) != len(slot_positions):
        # degenerate doc (unreachable list): formatting contributes nothing
        marks_per_char = [{}] * len(slot_positions)
    total = format_digest_host(slot_positions, marks_per_char, ALL_MARKS, COMMENT_TYPE)

    def packed_u32(opid) -> int:
        ctr, actor = opid
        idx = actor_table.get(actor)
        if idx is None or ctr > MAX_CTR:
            # no device peer can hold this doc; a deterministic stand-in
            # keeps fallback peers equal
            return content_hash32(f"{ctr}@{actor}")
        return pack_id(ctr, idx) & M32

    rows = []
    for oid, meta in doc._metadata.items():
        if not isinstance(meta, MapMeta):
            continue
        obj_u32 = (OBJ_ROOT & M32) if oid is ROOT else packed_u32(oid)
        for key, value in doc._objects.get(oid, {}).items():
            if isinstance(value, bool):
                kind, val = (VK_TRUE, 0) if value else (VK_FALSE, 0)
            elif isinstance(value, int):
                kind, val = VK_INT, value & M32
            elif isinstance(value, str):
                kind, val = VK_STR, content_hash32(value)
            elif value is None:
                kind, val = VK_NULL, 0
            elif isinstance(value, dict):
                kind, val = VK_OBJ, packed_u32(meta.children[key])
            elif isinstance(value, list):
                kind, val = VK_TEXT, packed_u32(meta.children[key])
            else:
                # device-inexpressible value: the doc is in fallback on
                # every peer; hash a canonical JSON form
                kind = 255
                val = content_hash32(json.dumps(value, sort_keys=True))
            rows.append((obj_u32, content_hash32(key), kind, val))
    return (total + register_digest_host(rows)) & M32


def _replay_doc(changes: List[Change]) -> Doc:
    doc = Doc("streaming-fallback")
    ordered, _ = causal_schedule(changes)
    for ch in ordered:
        doc.apply_change(ch)
    return doc


def _replay_spans(changes: List[Change]) -> List[FormatSpan]:
    return _replay_doc(changes).get_text_with_formatting(["text"])


def rebalance(workload_sizes: Sequence[int], num_shards: int) -> List[List[int]]:
    """Greedy load-balance: assign doc indices to shards equalizing total op
    counts (host-side placement, before transfer)."""
    order = sorted(range(len(workload_sizes)), key=lambda i: -workload_sizes[i])
    shards: List[List[int]] = [[] for _ in range(num_shards)]
    loads = [0] * num_shards
    for i in order:
        target = loads.index(min(loads))
        shards[target].append(i)
        loads[target] += workload_sizes[i]
    return shards
