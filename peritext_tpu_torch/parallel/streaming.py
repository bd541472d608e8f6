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
* **The fused round pipeline** — :meth:`drain` schedules up to
  :attr:`FUSE_MAX_ROUNDS` rounds on the host first (admission needs only
  host clocks), then commits them as ONE batch: flattened into one int32
  buffer and uploaded (pinned, non-blocking) on the staging lane's worker
  (parallel/staging.py) while the next batch schedules, then applied as
  one site call of a multi-round form (ops/kernel.py; the flat staged
  form, the stacked form for ``static_rounds``, ``stacked_multi`` under a
  fusion window), which on the card is one CUDA-graph replay
  (utils/graphs.py) once the batch's signature repeats, updating the
  resident state in place.  Each round launches the insert kernel once
  (ops/insert.py), its slot window bounded by the cumulative admitted
  inserts.  With the digest prefetch armed, the drain's final batch chains
  the block's resolve and digest into its own call.  ``fused_pipeline =
  False`` commits round by round (the equality oracle).
* **Block-chunked state** — sessions larger than ``read_chunk`` docs pad
  the doc axis to a block multiple and apply, resolve and sweep per block.
* **Event-sourced fallback** — the session keeps every doc's change log, so
  a doc the device cannot serve (undeclared actor, inexpressible op,
  change wider than a round, capacity overflow) replays through the scalar
  oracle; reads and digests route it there.
* **Incremental digest** — per-row full-state hashes are carried in a host
  plane; a digest re-hashes only the rows rounds touched.

* **Frame-native ingest** — :meth:`StreamingMerge.ingest_frames` takes
  binary wire frames (parallel/codec.py); one native call parses a whole
  batch into flat arrays (ops/frames.py), which pool per session, and each
  round one native call schedules every frame doc's pooled changes into
  its padded row.  No per-change Python object exists on that path.

* **Layouts** — the constructor is a factory: ``layout="paged"`` and
  ``layout="ragged"`` build the page-pool sessions of store/session.py
  (``PagedStreamingMerge``, ``RaggedStreamingMerge``); the padded layout
  stays the byte-equality oracle.
* **Placement** — :meth:`StreamingMerge.reshard` moves docs between read
  blocks behind the ``_row_of``/``_doc_at`` indirection; reads, ingest and
  digests do not see it.

* **Mesh** — ``mesh=`` (parallel/mesh.Mesh) shards the doc axis: it pads
  to a multiple of the shard count, and each shard's rows are one block on
  the shard's device.  A committed round launches the insert kernel once
  per touched shard, on that shard's device; reads resolve and digests
  hash per shard, and the digest sums the shards' uint32 partial sums on
  the host.  :meth:`StreamingMerge.reshard` balances over the shards and
  copies rows between their devices.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import native
from ..core.doc import Doc
from ..core.errors import DecodeError
from ..core.types import Change, Clock, FormatSpan
from ..obs import (
    GLOBAL_COUNTERS,
    GLOBAL_DEVPROF,
    GLOBAL_HISTOGRAMS,
    GLOBAL_TRACER,
    SIZE_BUCKETS,
    MergeStats,
    TraceContext,
    occupancy_key,
)
from ..ops.decode import CompactBlock, decode_doc_spans
from ..ops.encode import MAP_STREAM_COLS, MARK_COLS, DocEncoder, _DocStreams
from ..ops.frames import (
    FRAME_CORRUPT,
    FRAME_DEMOTE,
    FRAME_OK,
    KIND_MARK,
    ParsedChanges,
    parse_frames_bulk,
)
from ..ops.kernel import (
    _stacked_multi_chain,
    _stacked_rounds_chain,
    _staged_rounds_chain,
    apply_batch,
    apply_batch_compact,
    note_form,
    resolve_state_donation,
    rounds_plan,
)
from ..ops.packed import VK_DELETED, VK_STR, PackedDocs, empty_docs
from ..ops.resolve import COMMENT_TYPE, LINK_TYPE, ResolvedDocs, resolve
from ..schema import MARK_INDEX
from ..utils.device import pack_int32, resolve_device, unpack_int32, upload_int32
from ..utils.graphs import GraphCache
from ..utils.interning import Interner, OrderedActorTable
from ..utils.shapes import next_pow2
from .causal import causal_schedule
from .codec import decode_frame, encode_frame, strip_trace_context
from .mesh_fused import permute_shard_rows
from .staging import CopyLane, FrameStager
from .mesh import (
    M32,
    Mesh,
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

    __slots__ = ("device", "digest_dev", "on_device", "_np", "_overflow", "_digest_vec",
                 "_readback")

    def __init__(self, device: ResolvedDocs, digest_dev: torch.Tensor, on_device: np.ndarray):
        self.device = device
        self.digest_dev = digest_dev  # (D,) per-doc hash vector, on the card
        self.on_device = on_device  # fallback mask the digest was made with
        self._np = None
        self._overflow = None
        self._digest_vec = None
        #: (event, pinned digest, pinned overflow) of a started readback
        self._readback = None

    def start_readback(self) -> None:
        """Start copying the digest vector and the overflow flags into
        pinned host memory without waiting; the first read of either waits
        on the copy's event.  A no-op on the CPU or when already started."""
        if self._readback is not None or self.digest_dev.device.type != "cuda":
            return
        host_d = torch.empty(self.digest_dev.shape, dtype=self.digest_dev.dtype, pin_memory=True)
        host_o = torch.empty(self.device.overflow.shape, dtype=torch.bool, pin_memory=True)
        host_d.copy_(self.digest_dev, non_blocking=True)
        host_o.copy_(self.device.overflow, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.digest_dev.device))
        self._readback = (event, host_d, host_o)

    def _host(self, index: int, dev: torch.Tensor) -> np.ndarray:
        if self._readback is None:
            return dev.cpu().numpy()
        self._readback[0].synchronize()
        return self._readback[index].numpy().copy()

    @property
    def digest_per_doc(self) -> np.ndarray:
        if self._digest_vec is None:
            self._digest_vec = self._host(1, self.digest_dev).astype(np.uint32)
        return self._digest_vec

    @property
    def overflow(self) -> np.ndarray:
        if self._overflow is None:
            self._overflow = self._host(2, self.device.overflow)
        return self._overflow

    def to_np(self) -> ResolvedDocs:
        if self._np is None:
            self._np = ResolvedDocs(*(x.cpu().numpy() for x in self.device))
            self._overflow = self._np.overflow
        return self._np


def _compact_args(t: Dict[str, torch.Tensor]):
    """``(counts, ins, dels, marks, maps)`` for apply_batch_compact from a
    round's arrays by name (``StreamingMerge._compact_named``)."""
    return (tuple(t[f"n{j}"] for j in range(4)), (t["ins0"], t["ins1"], t["ins2"]), t["del"],
            {c: t[f"mark.{c}"] for c in MARK_COLS}, {c: t[f"map.{c}"] for c in MAP_STREAM_COLS})


def _staged_args(t: Dict[str, torch.Tensor]):
    """``(counts_all, ins_all, del_all, mark_all, map_all)`` of the staged
    flat form from its packed arrays by name."""
    return (t["counts"], (t["ins0"], t["ins1"], t["ins2"]), t["del"],
            {c: t[f"mark.{c}"] for c in MARK_COLS}, {c: t[f"map.{c}"] for c in MAP_STREAM_COLS})


def _padded_named(enc) -> Dict[str, np.ndarray]:
    """A round's padded (D, K) staging planes by name (the static-round
    forms' inputs)."""
    arrays = {"ins_ref": enc.ins_ref, "ins_op": enc.ins_op, "ins_char": enc.ins_char,
              "del": enc.del_target, "mark_count": enc.mark_count, "map_count": enc.map_count}
    arrays.update({f"mark.{c}": enc.marks[c] for c in MARK_COLS})
    arrays.update({f"map.{c}": enc.map_ops[c] for c in MAP_STREAM_COLS})
    return arrays


def _padded_args(t: Dict[str, torch.Tensor]):
    """The apply_batch 8-tuple from padded planes by name (with any leading
    round and tenant axes)."""
    return (t["ins_ref"], t["ins_op"], t["ins_char"], t["del"],
            {c: t[f"mark.{c}"] for c in MARK_COLS}, t["mark_count"],
            {c: t[f"map.{c}"] for c in MAP_STREAM_COLS}, t["map_count"])


def _write_resident(resident: Sequence[torch.Tensor], new: Sequence[torch.Tensor]) -> None:
    """Copy a commit's result into the resident buffers, in place (the
    port's form of the reference's donated state)."""
    for dst, src in zip(resident, new):
        if src is not dst:
            dst.copy_(src)


def _width_bucket(n: int) -> int:
    """Power-of-two width, at least 8: stream paddings, table widths and the
    insert kernel's slot window follow the reference package's buckets."""
    return max(8, next_pow2(n))


#: byte budget for the per-round CompactBlock cache (read_all and
#: read_patches_all share one transfer per block while it fits)
_COMPACT_CACHE_BYTES = 512 * 1024 * 1024

#: quarantine reasons: ``decode`` (a corrupt wire frame was discarded; the
#: doc stays on the device path, and the record lifts on its own once a
#: clean delivery arrived and the doc drained, see
#: :meth:`StreamingMerge._sweep_decode_quarantine`); ``capacity`` (a change
#: wider than the round widths), ``schedule`` (a frame the batched
#: scheduler cannot put on the device) and ``encode`` (a change the device
#: cannot express) — the doc left the device path for scalar replay
#: (degraded but correct); ``device-round`` is
#: :meth:`StreamingMerge.force_fallback`'s default
REASON_DECODE = "decode"
REASON_CAPACITY = "capacity"
REASON_SCHEDULE = "schedule"
REASON_ENCODE = "encode"
REASON_DEVICE_ROUND = "device-round"


@dataclass
class QuarantineRecord:
    """Why one doc is quarantined (typed reason + free-form detail), and at
    which session round the quarantine was imposed."""

    reason: str
    detail: str = ""
    round: int = 0
    #: a clean delivery for the doc has arrived since the corrupt one: the
    #: first half of the ``decode`` re-admission condition (the second half
    #: is the doc draining with no pending work)
    clean_delivery: bool = False


@dataclass
class _DocSession:
    encoder: Optional[DocEncoder] = None
    clock: Clock = field(default_factory=dict)
    pending: List[Change] = field(default_factory=list)
    log: List[Change] = field(default_factory=list)
    fallback: bool = False
    # frame mode (ops/frames.py): the raw wire frames are the event source;
    # pending parsed changes live in the session's pool, applied clocks in
    # its clock matrix, attrs in its session interner
    frame_mode: bool = False
    frames: List[bytes] = field(default_factory=list)
    text_obj: int = 0


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


class StreamingMerge:
    """Incremental multi-round merge of up to ``num_docs`` documents.

    ``actors`` declares the replica set whose changes may arrive (needed up
    front: packed op-ID order requires a complete ordered actor table; an
    undeclared actor demotes that doc to scalar-replay fallback).

    The constructor takes the reference package's arguments and defaults,
    plus ``device`` (default ``cuda``; raises without a card — pass
    ``device="cpu"`` for the plain torch path).  It is the factory of the
    layouts: ``layout="paged"`` or ``"ragged"`` builds the matching
    subclass (store/session.py).  ``mesh=`` (a parallel/mesh.Mesh) shards
    the doc axis over the mesh's devices; ``device`` then defaults to the
    first shard's and may only name the mesh's device type.
    """

    #: storage layout of this class (the page-pool subclasses override it)
    _layout = "padded"

    def __new__(cls, *args, **kwargs):
        layout = kwargs.get("layout", "padded")
        if layout not in ("padded", "paged", "ragged"):
            raise ValueError(f"unknown layout: {layout!r}")
        if cls is StreamingMerge and layout == "paged":
            from ..store.session import PagedStreamingMerge

            return super().__new__(PagedStreamingMerge)
        if cls is StreamingMerge and layout == "ragged":
            from ..store.session import RaggedStreamingMerge

            return super().__new__(RaggedStreamingMerge)
        return super().__new__(cls)

    #: max rounds drain() schedules before committing them; bounds the host
    #: memory of a batch's staging buffers
    FUSE_MAX_ROUNDS = 8

    #: whether a fused-eligible drain counts ``streaming.fused_dispatches``,
    #: one per scheduled batch: the reference counts the padded layout's
    #: batch program only (its paged and ragged commits count none), and
    #: FusedMuxGroup.dispatches reads deltas of the counter
    _COUNTS_FUSED_DISPATCHES = True

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
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
            if device is not None and torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not the mesh's device type "
                                 f"({mesh.device_type})")
            self.device = resolve_device(mesh.devices[0])
        else:
            self.device = resolve_device(device)
        self.num_docs = num_docs
        self.actors = list(actors)
        self.mesh = mesh
        self._slot_capacity = int(slot_capacity)
        self._mark_capacity = int(mark_capacity)
        self._tomb_capacity = int(tomb_capacity)
        self._map_capacity = int(map_capacity)
        #: serving-tier shape discipline: every round through the padded
        #: (D, K) apply at the configured widths (no adaptive shrink)
        self.static_rounds = bool(static_rounds)
        self.tracer = tracer if tracer is not None else GLOBAL_TRACER
        #: flight recorder (``obs/recorder.py``) a quarantine reports to, with
        #: an auto-dump of its ring; a supervisor attaches its own
        self.recorder = None
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
        # multiple, mesh sessions to a shard multiple (each shard is one
        # block); padded rows are permanently empty docs (all-zero streams
        # are no-ops), invisible in the public API
        if mesh is not None:
            self._padded_docs = -(-num_docs // mesh.size) * mesh.size
        elif num_docs > read_chunk:
            self._padded_docs = -(-num_docs // read_chunk) * read_chunk
        else:
            self._padded_docs = num_docs
        self._read_chunk_requested = read_chunk
        self._read_chunk = (max(1, self._padded_docs // mesh.size) if mesh is not None
                            else max(1, min(read_chunk, max(num_docs, 1))))
        self.docs = [_DocSession() for _ in range(num_docs)]
        self._quarantine: Dict[int, QuarantineRecord] = {}
        self.rounds = 0
        #: cumulative host seconds in the wire parse of frame ingest
        self.host_parse_seconds = 0.0
        self._patch_base: Dict[int, list] = {}
        #: doc -> (history size, scalar replay) of docs read by replay
        self._replay_cache: Dict[int, tuple] = {}
        # per-round cache of block resolutions: (rounds, {block: entry})
        self._resolved_cache = (-1, {})
        # incremental convergence digest: per-ROW full-state hashes carried
        # across rounds; a round invalidates only the rows it applied ops to
        self._digest_plane = np.zeros(self._padded_docs, np.uint32)
        self._digest_ov = np.zeros(self._padded_docs, bool)
        self._digest_row_valid = np.zeros(self._padded_docs, bool)
        # physical placement: logical doc d lives in device row _row_of[d];
        # _doc_at is the inverse (-1 = pad row).  reshard() moves rows and
        # bumps the placement epoch, which every row-keyed cache carries
        self._row_of = np.arange(num_docs, dtype=np.int64)
        self._doc_at = np.full(self._padded_docs, -1, np.int64)
        self._doc_at[:num_docs] = np.arange(num_docs)
        self._placement_epoch = 0
        self._digest_tables_cache: Dict = {}
        self._compact_cache: tuple = (-1, {}, 0)
        #: per-block visible-prefix widths (-1 = session-wide prior)
        self._compact_width: Dict[int, int] = {}
        self._actor_table = OrderedActorTable(self.actors)
        # frame-mode state: parsed-but-unscheduled changes pool as
        # (doc_of_change, ParsedChanges) chunks; applied frontiers as one
        # (D, A) clock matrix; link and other attrs in one session interner
        # (object docs intern their own attrs and keys)
        self._pool: List = []
        self._frame_mode = np.zeros(num_docs, bool)
        self._clock_mat = np.zeros((num_docs, len(self._actor_table)), np.int32)
        self._frame_attrs = Interner()
        # map keys and string values of frame docs (and of docs that never
        # encoded) share one session interner
        self._map_keys = Interner()
        # comment-mark ids are PER-DOC dense (they index the capacity-C
        # comment planes)
        self._doc_comment_ids: Dict[int, Interner] = {}
        # object docs with pending changes that a schedule pass may admit
        self._object_pending: set = set()
        # object docs whose last pass admitted nothing: every pending change
        # waits on a clock only an ingest() to the doc can move, so passes
        # skip them until then (a port-only shortcut; no result changes)
        self._object_waiting: set = set()
        #: the fused pipeline's staging lane (built by the first pipelined
        #: drain), its uploads, and the session's captured commit graphs
        self._stager: Optional[FrameStager] = None
        self._copy_lane = CopyLane(self.device)
        self._graphs = GraphCache(self.device)
        self._row_mask_dev = None
        # engine capture (the reference's hook, see _capture_rounds): None,
        # or the list each committed round's device-ready inputs append to
        self._captured: Optional[list] = None
        #: when True, a drain of a one-block session ends with the block's
        #: resolution and digest already computed, so the next digest() or
        #: read finds them cached
        self.prefetch_digest = False
        #: compat switch: False restores the per-round commit discipline
        #: (one upload and one apply per round and touched block, an
        #: unpipelined drain), the equality tests' oracle side
        self.fused_pipeline = True
        #: cross-tenant fusion window extents (plan/fusion.FusionGroup
        #: window_rows): ``(row_bases, block_docs)``, set by the serve
        #: tier's FusedMuxGroup around a drain whose window touched a
        #: SUBSET of the lane's tenants, None otherwise.  While set, a
        #: static-round commit stages only the active tenants' row blocks
        #: and rebuilds the full (D, K) planes on the device (the
        #: ``stacked_multi`` form)
        self.fusion_rows = None
        # per-row cumulative admitted inserts: an upper bound on each row's
        # slot occupancy; its power-of-two bucket bounds the insert kernel's
        # slot window each round
        self._cum_ins = np.zeros(self._padded_docs, np.int64)
        # the page-pool layouts keep their element planes in the pool their
        # subclass builds after this init: they have no (D, S) batch.  A
        # mesh session holds one (R, S) batch per shard, on its device
        self.state: Optional[PackedDocs] = None
        self._shard_state: Optional[List[PackedDocs]] = None
        if self._layout == "padded" and mesh is None:
            self.state = empty_docs(self._padded_docs, slot_capacity, mark_capacity,
                                    tomb_capacity, map_capacity=map_capacity, device=self.device)
        elif self._layout == "padded":
            self._shard_state = [
                empty_docs(self._read_chunk if self._padded_docs else 0, slot_capacity,
                           mark_capacity, tomb_capacity, map_capacity=map_capacity, device=dev)
                for dev in mesh.devices]

    # -- ingestion ---------------------------------------------------------

    def ingest(self, doc_index: int, changes: Iterable[Change]) -> None:
        """Queue newly-arrived changes for one document (any order, dups ok)."""
        sess = self.docs[doc_index]
        changes = list(changes)
        if not changes:
            return  # a zero-change frame would only grow durable history
        if sess.frame_mode:
            # the doc's pending state lives as parsed arrays; route object
            # arrivals through the same frame parse
            self.ingest_frame(doc_index, encode_frame(changes))
            return
        sess.pending.extend(changes)
        self._object_pending.add(doc_index)
        self._object_waiting.discard(doc_index)

    def ingest_frame(self, doc_index: int, data: bytes, on_corrupt: str = "raise") -> None:
        """Queue one binary change frame (parallel/codec.py) for one
        document: the single-frame form of :meth:`ingest_frames`."""
        self.ingest_frames([(doc_index, data)], on_corrupt=on_corrupt)

    def ingest_frames(self, items: Iterable, on_corrupt: str = "raise") -> None:
        """Bulk-queue binary change frames, many docs per call: ONE native
        call parses every frame (header, string tables, varint payload,
        packed identifiers) into flat arrays; no ``Change`` objects unless a
        doc leaves the fast path.

        ``items`` is an iterable of ``(doc_index, frame_bytes)``.  Frames are
        processed in order; a corrupt frame contributes nothing and
        quarantines its doc (reason ``decode``) without blocking the other
        docs' frames, which are all queued first.  ``on_corrupt="raise"``
        (default) then raises one :class:`DecodeError` naming the affected
        docs; ``"quarantine"`` leaves the registry and counters as the only
        signal.  A decode quarantine lifts once a later clean delivery for
        the doc has arrived and its pending work has drained."""
        if on_corrupt not in ("raise", "quarantine"):
            raise ValueError(f"unknown on_corrupt mode: {on_corrupt!r}")
        items = list(items)
        # traced (v5) and checked (v6) frames normalize to the v2 storage
        # form here; a v6 frame whose CRC fails passes through unchanged and
        # is rejected as corrupt by the per-doc parse below
        ctx: Optional[TraceContext] = None
        for j, (d, data) in enumerate(items):
            c, plain = strip_trace_context(data)
            if plain is not data:
                items[j] = (d, plain)
            if c is not None and ctx is None:
                ctx = TraceContext(*c)
        with self.tracer.span("streaming.ingest", ctx=ctx, frames=len(items)):
            self._ingest_items(items, on_corrupt)

    def _ingest_items(self, items: List, on_corrupt: str) -> None:
        fast: List = []
        corrupt: List[int] = []
        use_native = native.available()
        for doc_index, data in items:
            sess = self.docs[doc_index]
            object_bound = sess.fallback or sess.encoder is not None or bool(
                sess.pending or sess.log)
            if (not sess.frame_mode and object_bound) or not use_native:
                try:
                    self.ingest(doc_index, decode_frame(data))
                except ValueError:
                    corrupt.append(doc_index)
            else:
                fast.append((doc_index, data))
        if fast:
            corrupt.extend(self._ingest_frames_native(fast))
        bad = set(corrupt)
        # repair, first half: note which decode-quarantined docs saw a clean
        # delivery (re-admission waits until the doc also drains)
        for d in {int(d) for d, _ in items} - bad:
            rec = self._quarantine.get(int(d))
            if rec is not None and rec.reason == REASON_DECODE:
                rec.clean_delivery = True
        if bad:
            GLOBAL_COUNTERS.add("streaming.corrupt_frames", len(corrupt))
            for d in sorted(bad):  # deterministic registry order
                self.quarantine_doc(int(d), REASON_DECODE, "corrupt wire frame discarded")
            if on_corrupt == "raise":
                raise DecodeError(f"corrupt frame(s) for doc(s) {sorted(bad)}")

    def _ingest_frames_native(self, items: List) -> List[int]:
        """Bulk-parse frames of frame-mode (or fresh) docs; returns the doc
        indices of corrupt frames."""
        doc_ids = np.asarray([d for d, _ in items], np.int64)
        frames = [data for _, data in items]
        frame_off = np.concatenate(
            [[0], np.cumsum([len(f) for f in frames], dtype=np.int64)]).astype(np.int64)
        text_objs: Dict[int, int] = {}
        for d in doc_ids:
            d = int(d)
            sess = self.docs[d]
            if not sess.frame_mode:
                sess.frame_mode = True
                self._frame_mode[d] = True
            text_objs.setdefault(d, sess.text_obj)

        t0 = time.perf_counter()
        parsed, f_ch_off, status = parse_frames_bulk(
            b"".join(frames), frame_off, self._actor_table, self._frame_attrs, doc_ids,
            text_objs, keys=self._map_keys,
        )
        self.host_parse_seconds += time.perf_counter() - t0

        # comment-mark attr ids: from the session table to PER-DOC dense ids
        # (they index capacity-C planes), interned only for rows of frames
        # that passed every corrupt/demote check — a discarded frame must not
        # spend a doc's comment-id space
        ops = parsed.ops
        sel = np.nonzero((ops[:, 0] == KIND_MARK) & (ops[:, 4] == MARK_INDEX["comment"])
                         & (ops[:, 9] > 0))[0]
        if len(sel):
            ch_idx = np.searchsorted(parsed.ops_off, sel, side="right") - 1
            f_idx = np.searchsorted(f_ch_off, ch_idx, side="right") - 1
            ok = status[f_idx] == FRAME_OK
            sel, ch_idx, f_idx = sel[ok], ch_idx[ok], f_idx[ok]
        if len(sel):
            docs_of_rows = doc_ids[f_idx].astype(np.int64)
            keycode = (docs_of_rows << 32) | ops[sel, 9].astype(np.int64)
            uniq, inv = np.unique(keycode, return_inverse=True)
            local_ids = np.empty(len(uniq), np.int32)
            for j, kc in enumerate(uniq):
                doc, gid = int(kc >> 32), int(kc & 0xFFFFFFFF)
                table = self._doc_comment_ids.setdefault(doc, Interner())
                local_ids[j] = table.intern(self._frame_attrs.lookup(gid))
            ops[sel, 9] = local_ids[inv]

        # per-frame bookkeeping in arrival order: a demotion mid-call routes
        # the same doc's later frames to the object path (its pooled changes
        # drop at gather time; the frame-history replay covers them)
        corrupt: List[int] = []
        keep_frame = np.zeros(len(items), bool)
        for f, (d, data) in enumerate(items):
            d = int(d)
            sess = self.docs[d]
            if not sess.frame_mode:  # demoted earlier in this call
                try:
                    self.ingest(d, decode_frame(data))
                except ValueError:
                    corrupt.append(d)
                continue
            if status[f] == FRAME_CORRUPT:
                corrupt.append(d)
            elif status[f] == FRAME_DEMOTE:
                try:
                    extra = decode_frame(data)
                except ValueError:
                    # natively parseable but not object-decodable: corrupt
                    # semantics, the doc's state is kept
                    corrupt.append(d)
                    continue
                self._demote_frame_doc(d, extra=extra, reason=REASON_SCHEDULE,
                                       detail="frame parseable but not device-expressible")
            else:
                sess.frames.append(data)
                sess.text_obj = text_objs[d]
                keep_frame[f] = True

        counts = np.diff(f_ch_off).astype(np.int64)
        if keep_frame.all() and parsed.num_changes:
            self._pool.append((np.repeat(doc_ids, counts), parsed))
        elif parsed.num_changes:
            sel = np.nonzero(np.repeat(keep_frame, counts))[0]
            if len(sel):
                self._pool.append((np.repeat(doc_ids, counts)[sel], parsed.select(sel)))
        return corrupt

    # -- quarantine ----------------------------------------------------------

    def quarantine_doc(self, doc_index: int, reason: str, detail: str = "") -> None:
        """Quarantine one doc with a typed reason.  Idempotent per doc, with
        one escalation rule: a demotion-class reason overwrites a ``decode``
        record (the doc's routing really changed), and a repeated corrupt
        frame voids a decode record's repair evidence."""
        rec = self._quarantine.get(doc_index)
        if rec is None:
            self._quarantine[doc_index] = QuarantineRecord(
                reason=reason, detail=detail, round=self.rounds)
            GLOBAL_COUNTERS.add("streaming.quarantined_docs")
            if self.recorder is not None:
                # the quarantine becomes a post-mortem: fault() dumps the
                # recent span/event ring as JSONL
                self.recorder.fault(
                    "quarantine", doc=doc_index, quarantine_reason=reason,
                    detail=detail, round=self.rounds,
                )
        elif rec.reason == REASON_DECODE and reason != REASON_DECODE:
            self._quarantine[doc_index] = QuarantineRecord(
                reason=reason, detail=detail, round=self.rounds)
        elif rec.reason == REASON_DECODE:
            rec.clean_delivery = False

    def readmit(self, doc_index: int) -> bool:
        """Lift a doc's quarantine (any reason); returns whether a record was
        present.  A demoted doc stays on the scalar path: re-admission
        clears the health record, not the routing."""
        if self._quarantine.pop(doc_index, None) is not None:
            GLOBAL_COUNTERS.add("streaming.readmitted_docs")
            return True
        return False

    def _sweep_decode_quarantine(self) -> None:
        """Re-admission, second half: a ``decode``-quarantined doc lifts once
        a clean delivery arrived AND the doc has no pending work left (a
        causal gap the corrupt frame tore keeps its dependents pending).
        Only ``decode`` records lift."""
        candidates = [d for d, r in sorted(self._quarantine.items())
                      if r.reason == REASON_DECODE and r.clean_delivery]
        if not candidates:
            return
        pending = self.pending_docs()
        for d in candidates:
            if d not in pending:
                self.readmit(d)

    def quarantined(self) -> Dict[int, QuarantineRecord]:
        """Snapshot of the quarantine registry (doc -> record), after a sweep
        of the ``decode`` records whose re-admission condition now holds."""
        self._sweep_decode_quarantine()
        return dict(self._quarantine)

    def pending_docs(self) -> set:
        """Docs with undelivered (pending or pooled) changes."""
        out = {d for d, s in enumerate(self.docs) if s.pending}
        for doc_of, _ in self._pool:
            out.update(int(x) for x in np.unique(doc_of))
        return out

    def _demote(self, doc_index: int, reason: str, detail: str) -> None:
        sess = self.docs[doc_index]
        if not sess.fallback:
            sess.fallback = True
            GLOBAL_COUNTERS.add("streaming.fallback_docs")
        self.quarantine_doc(doc_index, reason, detail)

    def force_fallback(self, doc_index: int, reason: str = REASON_DEVICE_ROUND,
                       detail: str = "") -> None:
        """Demote one doc to scalar replay (degraded but correct) and
        quarantine it with ``reason``.  Frame docs replay their frame
        history; object docs fold pending work into the replay log."""
        sess = self.docs[doc_index]
        if sess.frame_mode:
            self._demote_frame_doc(doc_index, reason=reason, detail=detail)
            return
        self._demote(doc_index, reason, detail)
        sess.log.extend(sess.pending)
        sess.pending = []
        self._object_pending.discard(doc_index)
        self._object_waiting.discard(doc_index)

    def health(self) -> Dict:
        """One snapshot of the session's fault-domain state, as a fleet
        health endpoint would export it: counts, the quarantine registry,
        and the padding efficiency (real ops over the op-stream capacity
        paid) of the last committed round batch and of the session."""
        last = self.last_round_stats
        return {
            "rounds": self.rounds,
            "num_docs": self.num_docs,
            "pending_changes": self.pending_count(),
            "fallback_docs": sum(1 for s in self.docs if s.fallback),
            "frame_docs": int(self._frame_mode.sum()),
            "round_padding_efficiency": (
                round(last.padding_efficiency, 4) if last is not None else None),
            "padding_efficiency_cum": (
                round(self._pad_real_ops / self._pad_capacity, 4) if self._pad_capacity else None),
            "quarantined": {
                d: {"reason": r.reason, "detail": r.detail, "round": r.round}
                for d, r in sorted(self.quarantined().items())
            },
        }

    def _demote_frame_doc(self, doc_index: int, extra: Sequence[Change] = (),
                          reason: str = REASON_CAPACITY, detail: str = "") -> None:
        """Take a frame doc off the fast path: it becomes a scalar-replay
        fallback fed by its decoded frame history (its device row may hold
        applied ops already, so only the oracle path is still correct)."""
        sess = self.docs[doc_index]
        changes = [ch for f in sess.frames for ch in decode_frame(f)]
        changes.extend(extra)
        sess.log.extend(changes)
        # fold the applied frontier into the object clock, so frontier()
        # stays truthful across the demotion
        row = self._clock_mat[doc_index]
        for idx in np.nonzero(row)[0]:
            actor = self._actor_table.lookup(int(idx))
            sess.clock[actor] = max(sess.clock.get(actor, 0), int(row[idx]))
        self._clock_mat[doc_index] = 0
        sess.frame_mode = False
        self._frame_mode[doc_index] = False
        sess.frames = []
        sess.text_obj = 0
        sess.fallback = True
        GLOBAL_COUNTERS.add("streaming.fallback_docs")
        self.quarantine_doc(doc_index, reason, detail)

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
        self._sweep_decode_quarantine()
        return scheduled

    def _emit_round_stats(self, batch, scheduled: int, schedule_s: float, apply_s: float,
                          origin: str = "streaming.round") -> None:
        """Per-commit MergeStats: ``encode_seconds`` is the schedule span,
        ``apply_seconds`` the host dispatch wall of the commit (device work
        is asynchronous; reads are the sync points).  Profiled, a padded
        session's rounds land in the device profiler's occupancy table
        under ``origin`` (the reference's labels: ``streaming.fused`` for a
        drain of a one-block session, else ``streaming.round``; the pooled
        layouts observe theirs at commit), and the commit ends with a
        memory sample."""
        touched: set = set()
        real = capacity = 0
        for enc, widths in batch:
            touched.update(int(r) for r in np.nonzero(enc.num_ops)[0])
            round_real = int(enc.num_ops.sum())
            round_cap = self._round_capacity(enc, widths)
            real += round_real
            capacity += round_cap
            if GLOBAL_DEVPROF.enabled and self._layout == "padded":
                GLOBAL_DEVPROF.observe_round(occupancy_key(self._padded_docs, *widths),
                                             round_real, round_cap, origin=origin)
        if GLOBAL_DEVPROF.enabled:
            GLOBAL_DEVPROF.sample_memory(self.device)
        extras = {"rounds": len(batch), "scheduled_changes": scheduled}
        if self._layout != "padded":
            extras[f"layout_{self._layout}"] = 1.0
        self.last_round_stats = MergeStats(
            docs=len(touched),
            device_docs=len(touched),
            device_ops=real,
            encode_seconds=schedule_s,
            apply_seconds=apply_s,
            padding_efficiency=real / capacity if capacity else 0.0,
            extras=extras,
        )
        if self.last_drain_marks is not None:
            self.last_drain_marks["schedule_seconds"] += schedule_s
            self.last_drain_marks["apply_seconds"] += apply_s
            self.last_drain_marks["rounds"] += len(batch)
        self._pad_real_ops += real
        self._pad_capacity += capacity
        GLOBAL_HISTOGRAMS.observe("streaming.round_seconds", schedule_s + apply_s)
        GLOBAL_HISTOGRAMS.observe(
            "streaming.round_scheduled_changes", scheduled, buckets=SIZE_BUCKETS)

    def _round_capacity(self, enc: _RoundBuffers, widths) -> int:
        """Op-stream capacity one committed round paid: every row at the
        round widths (the page-pool layouts pay only what they launch)."""
        return self._padded_docs * sum(widths)

    def _schedule_round(self):
        """The HOST half of a round: causal admission of every object doc's
        pending changes (per doc) and of every frame doc's pooled changes
        (one native call) into staging buffers, and width selection — no
        device work.  Returns ``(enc, widths, scheduled)``."""
        ki, kd, km, kp = self.round_caps
        scheduled = 0
        obj_streams: Dict[int, _DocStreams] = {}
        GLOBAL_COUNTERS.add("streaming.schedule_passes")
        GLOBAL_COUNTERS.add("streaming.docs_scanned", len(self._object_pending))
        GLOBAL_COUNTERS.add("streaming.docs_skipped", len(self._object_waiting))
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
            elif not admitted:
                # nothing admissible (an undemoted doc that admits nothing
                # had an empty ordered list): every pending change waits on
                # a clock that only an ingest() to this doc can move
                self._object_pending.discard(i)
                self._object_waiting.add(i)

        pool = self._gather_pool()
        if scheduled == 0 and pool is None:
            return None, None, 0
        # adaptive widths: a power-of-two bucket per stream kind for trickle
        # rounds; block-chunked and static-round sessions keep the
        # configured widths (a mesh is one logical block, as the
        # reference's mesh session, whose one block is the padded batch)
        if self._one_block() and not self.static_rounds:
            ki, kd, km, kp = self._round_widths(pool, obj_streams, ki, kd, km, kp)

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

        # the frame pass: ONE native call schedules and splits every frame
        # doc's pooled changes into its padded row
        if pool is not None:
            scheduled += self._step_frame_docs(pool, enc, (ki, kd, km, kp))
        if scheduled == 0:
            return None, None, 0
        GLOBAL_COUNTERS.add("streaming.scheduled_changes", scheduled)
        return enc, (ki, kd, km, kp), scheduled

    #: fraction of frame-pool docs whose whole pending need must fit the
    #: round width; the skewed tail above it defers to later rounds instead
    #: of widening every doc's padded streams
    ROUND_WIDTH_QUANTILE = 0.98

    def _round_widths(self, pool, obj_streams, ki: int, kd: int, km: int, kp: int):
        """Shrink this round's stream widths, each kind to the power-of-two
        bucket (at least 8) of its need, never past the configured width.
        Object docs were admitted at the full widths, so their exact usage
        is a floor.  Frame docs defer what does not fit anyway, so their
        need is the ROUND_WIDTH_QUANTILE of per-doc pending need, but at
        least the largest single pooled change (every doc still admits a
        change a round)."""
        need = [max((len(getattr(s, f)) for s in obj_streams.values()), default=0)
                for f in ("ins", "dels", "marks", "maps")]
        if pool is not None:
            doc_of, parsed = pool
            starts = np.nonzero(np.concatenate([[True], doc_of[1:] != doc_of[:-1]]))[0]
            for j, (cap, cnt) in enumerate(((ki, parsed.cnt_ins), (kd, parsed.cnt_del),
                                            (km, parsed.cnt_mark), (kp, parsed.cnt_map))):
                per_doc = np.minimum(np.add.reduceat(cnt, starts), cap)
                floor = int(cnt.max()) if len(cnt) else 0  # largest single change
                want = max(floor, int(np.quantile(per_doc, self.ROUND_WIDTH_QUANTILE))
                           if len(per_doc) else 0)
                need[j] = max(need[j], min(cap, want))
        return tuple(min(cap, _width_bucket(max(n, 8)))
                     for cap, n in zip((ki, kd, km, kp), need))

    def _gather_pool(self):
        """Merge the pooled parsed-change chunks into one doc-grouped batch
        ``(doc_of_change, ParsedChanges)`` sorted by doc, dropping demoted
        docs' entries (their frame-history replay covers them)."""
        if not self._pool:
            return None
        chunks = self._pool
        self._pool = []
        doc_of = chunks[0][0] if len(chunks) == 1 else np.concatenate([d for d, _ in chunks])
        parsed = ParsedChanges.concat_many([p for _, p in chunks])
        keep = self._frame_mode[doc_of]
        if not keep.all():
            idx = np.nonzero(keep)[0]
            if not len(idx):
                return None
            doc_of, parsed = doc_of[idx], parsed.select(idx)
        if np.any(doc_of[:-1] > doc_of[1:]):
            order = np.argsort(doc_of, kind="stable")
            doc_of, parsed = doc_of[order], parsed.select(order)
        return doc_of, parsed

    def _step_frame_docs(self, pool, enc: _RoundBuffers, caps) -> int:
        """Schedule every frame doc's pooled changes into its padded row in
        one native call; deferred changes go back to the pool as one chunk.
        Returns the changes admitted."""
        doc_of, parsed = pool
        frame_docs = np.unique(doc_of)
        frame_rows = self._row_of[frame_docs]
        ch_off = np.concatenate(
            [np.searchsorted(doc_of, frame_docs), [len(doc_of)]]).astype(np.int32)
        # the scheduled docs' clock rows, scattered back after the call
        clock = np.ascontiguousarray(self._clock_mat[frame_docs], np.int32)
        text_obj = np.asarray([self.docs[int(i)].text_obj for i in frame_docs], np.int32)
        _, n_ins, n_del, n_mark, n_map, n_admitted, admitted, status = native.schedule_split_batch(
            len(self._actor_table), ch_off, frame_rows.astype(np.int32), text_obj,
            (parsed.ch_actor, parsed.ch_seq, parsed.dep_off, parsed.dep_actor,
             parsed.dep_seq, parsed.ops_off, parsed.ops),
            clock, caps, (enc.ins_ref, enc.ins_op, enc.ins_char), enc.del_target,
            enc.marks, enc.map_ops,
        )
        self._clock_mat[frame_docs] = clock
        enc.ins_count[frame_rows] = n_ins
        enc.del_count[frame_rows] = n_del
        enc.mark_count[frame_rows] = n_mark
        enc.map_count[frame_rows] = n_map
        enc.num_ops[frame_rows] = n_ins + n_del + n_mark + n_map
        scheduled = int(n_admitted.sum())
        demoted = frame_docs[status != 0] if status.any() else None
        if demoted is not None:
            for i in demoted:  # rare: the native call zeroed the rows
                r = int(self._row_of[int(i)])
                enc.ins_count[r] = enc.del_count[r] = enc.mark_count[r] = 0
                enc.map_count[r] = enc.num_ops[r] = 0
                # folds and zeroes the doc's clock row
                self._demote_frame_doc(int(i), reason=REASON_SCHEDULE,
                                       detail="batched scheduler demoted the doc's round")
        defer = admitted == 0
        if demoted is not None:
            defer &= ~np.isin(doc_of, demoted)
        if defer.any():
            idx = np.nonzero(defer)[0]
            self._pool.append((doc_of[idx], parsed.select(idx)))
        return scheduled

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
    # A one-block session (padded or paged, meshless) commits through the
    # fused round pipeline, as the reference's default drain does: a batch
    # of up to FUSE_MAX_ROUNDS rounds is prepared on this thread, flattened
    # and uploaded as ONE contiguous int32 buffer on the staging lane
    # (parallel/staging.py), and applied as ONE site call of a multi-round
    # form (ops/kernel.py), which on the card is one CUDA-graph replay
    # (utils/graphs.py) that updates the resident state in place.  Mesh,
    # block-chunked, ragged and engine-capture sessions, and
    # ``fused_pipeline=False`` (the per-round oracle), commit each round on
    # its own: one upload and one apply_batch_compact per touched block.

    @property
    def _capture_rounds(self) -> Optional[list]:
        """The engine-capture hook: None, or a list a caller (a bench)
        assigns.  While it is a list, every committed round of a padded
        session applies the WHOLE batch as one block and appends
        ``(round_inputs, widths, loop_slots)``: ``round_inputs`` is
        ``(counts, ins, dels, marks, maps)`` (4 count vectors, 3 insert
        streams, the delete stream, dicts of mark and map columns; flat
        streams each padded to its own power-of-two bucket; tensors on the
        session's device), the reference's tuple, which
        ``testing/engine.replay_rounds`` replays.  The page-pool layouts
        ignore it, as the reference's do.  A padded mesh session refuses a
        list (ValueError): its shards hold no whole-batch state."""
        return self._captured

    @_capture_rounds.setter
    def _capture_rounds(self, rounds: Optional[list]) -> None:
        if rounds is not None and self.mesh is not None and self._layout == "padded":
            raise ValueError("a mesh session cannot capture rounds: its shards hold no "
                             "whole-batch state to apply over")
        self._captured = rounds

    def _fused_eligible(self) -> bool:
        """Whether commits route through the fused round pipeline: the
        compat switch is on, no engine capture is armed (capture records
        per-ROUND inputs, the replay's contract), and the session is one
        block, or a mesh (whose blocks are its shards, as the reference's
        mesh sessions always qualify).  A mesh still commits per shard and
        round (:meth:`_pipelined`), counted and labelled as fused."""
        return self.fused_pipeline and self._captured is None and self._one_block()

    def _pipelined(self) -> bool:
        """Whether commits take the fused forms and the pipelined drain: a
        fused-eligible meshless session of the padded or paged layout (the
        ragged and mesh forms are not ported)."""
        return self._fused_eligible() and self.mesh is None and self._layout != "ragged"

    def _one_block(self) -> bool:
        """A one-block session, or a mesh (whose blocks are shards of what
        the reference's mesh session holds as one block)."""
        return self.mesh is not None or self._padded_docs <= self._read_chunk

    def _loop_slots(self) -> Optional[int]:
        """The insert kernel's slot window for the round just admitted
        (after ``_cum_ins`` absorbed it): the power-of-two bucket of the
        largest row's admitted inserts, or None (the whole capacity)."""
        bound = _width_bucket(int(self._cum_ins.max()))
        return bound if bound < self._slot_capacity else None

    def _commit_rounds(self, batch) -> None:
        """The DEVICE half: commit scheduled rounds ``[(enc, widths), ...]``
        in causal order: as ONE fused form when :meth:`_pipelined` (prep,
        stage and dispatch on this thread), else one round at a time."""
        if self._pipelined():
            statics = self._prep_fused_batch(batch)
            self._dispatch_fused_batch(batch, statics, self._stage_fused_batch(batch, statics))
            return
        self._commit_rounds_serial(batch)

    def _commit_rounds_serial(self, batch) -> None:
        """The per-round discipline (the ``fused_pipeline=False`` oracle):
        each round one upload and one apply per touched block."""
        for enc, widths in batch:
            self._cum_ins += enc.ins_count
            self._apply_compact(enc, widths, self._loop_slots())
            self._digest_row_valid[np.nonzero(enc.num_ops)[0]] = False
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")
        if self.mesh is not None and GLOBAL_DEVPROF.enabled:
            GLOBAL_DEVPROF.observe_mesh(self._mesh_stats())

    def _mesh_stats(self) -> Dict:
        """Per-shard load snapshot behind the ``peritext_mesh_*`` gauges:
        shard count, per-shard cumulative admitted inserts (the padded
        layout's live-slot proxy) and the max/mean imbalance ratio.  The
        page-pool sessions report their pools' real per-shard occupancy."""
        n = self.mesh.size
        rows = self._padded_docs // n
        per = np.asarray(self._cum_ins).reshape(n, rows).sum(axis=1)
        mean = float(per.mean())
        return {
            "shards": n,
            "rows_per_shard": rows,
            "shard_load": [int(x) for x in per],
            "shard_utilization": [round(float(x) / (rows * self._slot_capacity), 4)
                                  for x in per],
            "imbalance_ratio": round(float(per.max()) / mean, 4) if mean > 0 else 1.0,
            "ici_page_moves": 0,
        }

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

    def _round_inputs(self, flat, buckets, device: torch.device):
        """One upload of a flattened round (:meth:`_flatten_round`) to
        ``device``, as ``(counts, ins, dels, marks, maps)`` for
        :func:`apply_batch_compact`; each stream kind padded to its bucket in
        ``buckets`` (ins, del, mark, map), or with None to its own."""
        return _compact_args(upload_int32(self._compact_named(flat, buckets), device))

    @classmethod
    def _compact_named(cls, flat, buckets) -> Dict[str, np.ndarray]:
        """A flattened round's arrays by name, each stream kind padded to
        its bucket in ``buckets`` (ins, del, mark, map), or with None to its
        own (:func:`_compact_args` reads them back)."""
        counts, ins, dels, marks, maps = flat
        b_ins, b_del, b_mark, b_map = buckets or (
            _width_bucket(len(ins[0])), _width_bucket(len(dels)),
            _width_bucket(len(marks[MARK_COLS[0]])), _width_bucket(len(maps[MAP_STREAM_COLS[0]])))
        arrays = {f"n{j}": c for j, c in enumerate(counts)}
        arrays.update({f"ins{j}": cls._pad(v, b_ins) for j, v in enumerate(ins)})
        arrays["del"] = cls._pad(dels, b_del)
        arrays.update({f"mark.{c}": cls._pad(marks[c], b_mark) for c in MARK_COLS})
        arrays.update({f"map.{c}": cls._pad(maps[c], b_map) for c in MAP_STREAM_COLS})
        return arrays

    def _apply_compact(self, enc: _RoundBuffers, widths, loop_slots: Optional[int]) -> None:
        """One round through the flat-stream apply.  Sessions larger than a
        read block apply BLOCK-CHUNKED: each touched block's rows take their
        flat streams (every block padded to one shared power-of-two bucket
        per stream kind), apply on a view of the block, and are written back
        into the session state in place; untouched blocks are not read.  A
        mesh session's blocks are its shards, each applied on its own
        device.  With the engine capture armed (:attr:`_capture_rounds`)
        the whole batch applies as one block, whatever the round touched,
        and the round's inputs are recorded.  Each apply launches the insert
        kernel once (``streaming.block_applies`` counts them)."""
        if self._captured is not None:
            inputs = self._round_inputs(self._flatten_round(enc, widths, 0, self._padded_docs),
                                        None, self.device)
            self.state = apply_batch_compact(self.state, *inputs, widths=widths,
                                             insert_loop_slots=loop_slots)
            GLOBAL_COUNTERS.add("streaming.block_applies")
            self._captured.append((inputs, widths, loop_slots))
            return
        n_blocks = self._n_blocks()
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
            new = apply_batch_compact(
                self._state_block(bi), *self._round_inputs(flats[bi], buckets, self._block_device(bi)),
                widths=widths, insert_loop_slots=loop_slots,
            )
            GLOBAL_COUNTERS.add("streaming.block_applies")
            if self.mesh is not None:
                self._shard_state[bi] = new
            elif n_blocks == 1:
                self.state = new
            else:
                lo, hi = self._block_bounds(bi)
                for x, y in zip(self.state, new):
                    x[lo:hi] = y

    # -- the fused round pipeline ---------------------------------------------------
    #
    # Split into prep (this thread: advances _cum_ins, derives the form and
    # its statics), stage (worker-safe: pure reads of the batch's own
    # staging buffers, one packed int32 buffer, one upload) and dispatch
    # (this thread: one site call of the form, then the round bookkeeping),
    # so the pipelined drain can overlap them.

    def _prep_fused_batch(self, batch):
        """The statics of one batch's commit, tagged with its form: ``flat``
        (staged flat streams, shared per-kind buckets), ``stacked`` (static
        rounds: the padded planes at the session's fixed widths, stacked),
        ``stacked_multi`` (static rounds under ``fusion_rows``: only the
        active tenants' row blocks, ``T`` power-of-two bucketed), or, for a
        one-round batch on the CPU, ``compact1`` / ``static1`` (the
        per-round discipline's own apply).  The reference's tuples."""
        loop_seq = []
        for enc, _ in batch:
            self._cum_ins += enc.ins_count
            loop_seq.append(self._loop_slots())
        donate = resolve_state_donation(self.state.elem_id)
        if self.static_rounds:
            if self.fusion_rows is not None:
                bases, block = self.fusion_rows
                return ("stacked_multi", tuple(loop_seq), tuple(bases), int(block),
                        _width_bucket(len(bases)))
            if len(batch) == 1 and not donate:
                return ("static1", loop_seq[0])
            return ("stacked", tuple(loop_seq))
        if len(batch) == 1 and not donate:
            return ("compact1", loop_seq[0], batch[0][1])
        k = len(batch)
        buckets = [_width_bucket(max(int(getattr(enc, f).sum()) for enc, _ in batch))
                   for f in ("ins_count", "del_count", "mark_count", "map_count")]
        return ("flat", tuple(loop_seq), tuple(w for _, w in batch),
                *((b,) * k for b in buckets))

    def _stage_fused_batch(self, batch, statics):
        """Flatten the batch into ONE int32 buffer and upload it: returns
        ``(StagedUpload, layout)``.  Reads only the batch's own staging
        buffers, never session state, so the pipelined drain runs it on the
        staging lane while this thread schedules the next batch."""
        form = statics[0]
        d = self._padded_docs
        if form == "compact1":
            arrays = self._compact_named(self._flatten_round(batch[0][0], statics[2], 0, d), None)
        elif form == "static1":
            arrays = _padded_named(batch[0][0])
        elif form == "stacked":
            per_round = [_padded_named(enc) for enc, _ in batch]
            arrays = {name: np.stack([r[name] for r in per_round]) for name in per_round[0]}
        elif form == "stacked_multi":
            _, _, bases, block, t_pad = statics

            def blocks(plane):
                out = np.zeros((t_pad, block) + plane.shape[1:], plane.dtype)
                for t, b in enumerate(bases):
                    out[t] = plane[b:b + block]
                return out

            per_round = [{n: blocks(a) for n, a in _padded_named(enc).items()} for enc, _ in batch]
            arrays = {name: np.stack([r[name] for r in per_round]) for name in per_round[0]}
            row_base = np.zeros(t_pad, np.int32)
            row_base[: len(bases)] = bases
            arrays["row_base"] = row_base
        else:
            _, _, widths_seq, ins_lens, del_lens, mark_lens, map_lens = statics
            arrays = {"counts": np.zeros((len(batch), 4, d), np.int32)}
            arrays.update({f"ins{j}": np.zeros(sum(ins_lens), np.int32) for j in range(3)})
            arrays["del"] = np.zeros(sum(del_lens), np.int32)
            arrays.update({f"mark.{c}": np.zeros(sum(mark_lens), np.int32) for c in MARK_COLS})
            arrays.update({f"map.{c}": np.zeros(sum(map_lens), np.int32)
                           for c in MAP_STREAM_COLS})
            io = do = mo = po = 0
            for r, (enc, widths) in enumerate(batch):
                counts, ins, dels, marks, maps = self._flatten_round(enc, widths, 0, d)
                arrays["counts"][r] = np.stack(counts)
                for j, v in enumerate(ins):
                    arrays[f"ins{j}"][io:io + len(v)] = v
                arrays["del"][do:do + len(dels)] = dels
                for c in MARK_COLS:
                    arrays[f"mark.{c}"][mo:mo + len(marks[c])] = marks[c]
                for c in MAP_STREAM_COLS:
                    arrays[f"map.{c}"][po:po + len(maps[c])] = maps[c]
                io, do = io + ins_lens[r], do + del_lens[r]
                mo, po = mo + mark_lens[r], po + map_lens[r]
        flat, layout = pack_int32(arrays)
        return self._copy_lane.upload(flat), layout

    def _dispatch_fused_batch(self, batch, statics, inputs, chain_digest: bool = False) -> bool:
        """Apply the whole batch as ONE site call of its form, then the
        per-round bookkeeping.  With ``chain_digest`` (the drain's FINAL
        batch, digest prefetch armed) the multi-round forms chain the
        block's resolve and digest into the same call and seed the block
        cache with them; returns True when that happened."""
        GLOBAL_COUNTERS.add("streaming.fused_dispatches")
        form = statics[0]
        if chain_digest and form in ("stacked", "flat"):
            self._dispatch_fused_batch_digest(batch, statics, inputs)
            return True
        upload, layout = inputs
        buf = upload.consume()
        if form == "compact1":
            self.state = apply_batch_compact(self.state, *_compact_args(unpack_int32(buf, layout)),
                                             widths=statics[2], insert_loop_slots=statics[1])
        elif form == "static1":
            self.state = apply_batch(self.state, _padded_args(unpack_int32(buf, layout)),
                                     insert_loop_slots=statics[1])
        else:
            self._run_form(statics, buf, layout)
        self._fused_bookkeeping(batch)
        return False

    def _fused_bookkeeping(self, batch) -> None:
        """A committed batch's rounds: dirty digest rows, the round count,
        one insert launch a round (``streaming.block_applies``)."""
        for enc, _ in batch:
            self._digest_row_valid[np.nonzero(enc.num_ops)[0]] = False
            self.rounds += 1
            GLOBAL_COUNTERS.add("streaming.rounds")
            GLOBAL_COUNTERS.add("streaming.block_applies")

    def _dispatch_fused_batch_digest(self, batch, statics, inputs) -> None:
        """The ``chain_digest`` arm of :meth:`_dispatch_fused_batch`: the
        final batch's apply AND the block's resolve and per-doc digest in
        one site call (one graph on the card), seeding the per-round block
        cache, so the drain-end digest costs no further dispatch."""
        on_device = self._block_fallback_mask(0)
        upload, layout = inputs
        resolved, digest_dev = self._run_form(
            statics, upload.consume(), layout,
            digest=(self._row_mask(on_device), self._digest_tables(0, self._padded_docs)))
        self._fused_bookkeeping(batch)
        entry = _BlockResolution(resolved, digest_dev, on_device)
        self._resolved_cache = (self.rounds, {0: entry})
        self._start_digest_readback(entry)
        GLOBAL_COUNTERS.add("streaming.digest_chained")

    def _row_mask(self, on_device: np.ndarray) -> torch.Tensor:
        """The fallback mask on the card, uploaded again only when it
        changed."""
        key = on_device.tobytes()
        if self._row_mask_dev is None or self._row_mask_dev[0] != key:
            self._row_mask_dev = (key, torch.from_numpy(on_device).to(self.device))
        return self._row_mask_dev[1]

    def _run_form(self, statics, buf: torch.Tensor, layout, digest=None):
        """One multi-round form over the resident state: its chain of
        per-round applies, ending with the result copied into the resident
        buffers, run by the session's graph cache (eagerly on the CPU and
        on a signature's first occurrence, else one CUDA-graph replay) under
        the form's reference site name.  With ``digest`` = ``(row_mask,
        tables)`` the chain ends with the block's resolve and per-doc digest
        and returns them."""
        form = statics[0]
        shapes = dict(layout)
        loop_seq = statics[1]
        if form == "flat":
            _, _, widths_seq, *lens = statics
            site, ks = "apply_batch_staged_rounds", [w[0] for w in widths_seq]

            def chain(state, b):
                return _staged_rounds_chain(state, *_staged_args(unpack_int32(b, layout)),
                                            widths_seq, loop_seq, *lens)
        elif form == "stacked":
            site, ks = "apply_batch_stacked_rounds", [shapes["ins_ref"][-1]] * len(loop_seq)

            def chain(state, b):
                return _stacked_rounds_chain(state, _padded_args(unpack_int32(b, layout)),
                                             loop_seq)
        else:
            site, ks = "apply_batch_stacked_rounds_multi", [shapes["ins_ref"][-1]] * len(loop_seq)

            def chain(state, b):
                t = unpack_int32(b, layout)
                return _stacked_multi_chain(state, _padded_args(t), t["row_base"], loop_seq)
        state = self.state
        resident = tuple(state)
        if digest is None:
            def body(b):
                _write_resident(resident, chain(PackedDocs(*resident), b))
            inputs = (buf,)
        else:
            site = {"flat": "_fused_rounds_digest", "stacked": "_stacked_rounds_digest"}[form]
            row_mask, tables = digest
            cc = self.comment_capacity

            def body(b, mask, *tabs):
                new = chain(PackedDocs(*resident), b)
                _write_resident(resident, new)
                return _resolve_block_digest(new, cc, mask, *tabs)
            inputs = (buf, row_mask) + tuple(tables)
        return note_form(
            site, (state, buf),
            lambda: self._graphs.run(statics + (layout,), site, body, inputs, binds=resident),
            lambda: rounds_plan(state, ks, loop_seq, (("statics", statics[1:]),)),
            device=state.elem_id.device)

    def _ensure_stager(self) -> FrameStager:
        """The session's staging lane (lazy; rebuilt if closed).  Its jobs
        run under a ``staging.stage`` span, so the stage wall is measured on
        the worker thread."""
        if self._stager is None or self._stager._closed:
            self._stager = FrameStager()
            self._stager.span_factory = lambda: self.tracer.span("staging.stage")
        return self._stager

    def _commit_pending(self, pending, chain_digest: bool = False) -> bool:
        """Land one staged batch: wait its staging handle (a staging fault
        surfaces HERE, inside whatever guard wraps the drain) and dispatch
        it.  Returns whether the dispatch chained the digest in."""
        handle, batch, statics, scheduled, ssp = pending
        with self.tracer.span("streaming.apply", rounds=len(batch)) as asp:
            inputs = handle.wait()
            chained = bool(self._dispatch_fused_batch(batch, statics, inputs,
                                                      chain_digest=chain_digest))
        self._emit_round_stats(batch, scheduled, ssp.duration, asp.duration,
                               origin="streaming.fused")
        return chained

    def _prefetch_digest(self) -> None:
        """Compute the (single) block's resolution and digest now, with the
        host copy of its digest planes started, so the next digest() or
        read finds them ready."""
        self._start_digest_readback(self._digest_resolution(0))

    @staticmethod
    def _start_digest_readback(entry: "_BlockResolution") -> None:
        """Start the non-blocking device-to-host copy of a resolved block's
        digest planes (a no-op on the CPU)."""
        entry.start_readback()

    # -- drains ------------------------------------------------------------------

    def idle(self, budget_s: float) -> int:
        """The caller commits nothing for ``budget_s`` seconds (a serving
        mux's open window): the session's graph cache captures the repeated
        signatures whose capture fits, so no capture lands on a commit
        (``utils/graphs.py``).  Returns the graphs captured."""
        return self._graphs.idle(budget_s)

    def drain(self, max_rounds: int = 1_000) -> int:
        """Drain all admissible pending work; returns rounds run.

        Scheduling is host-only (causal clocks): drain schedules a batch of
        up to :attr:`FUSE_MAX_ROUNDS` rounds, then commits it.  A
        :meth:`_pipelined` session runs the PIPELINED form: batch k is
        flattened and uploaded on the staging lane's worker while batch k+1
        schedules on this thread and batch k-1 runs on the device.  With
        :attr:`prefetch_digest` armed, the drain ends with the block's
        resolution and digest computed (chained into the final batch's
        form where it is a multi-round one), so the next digest() or read
        finds them cached.  Byte-equal to the per-round discipline."""
        self.last_drain_marks = {"schedule_seconds": 0.0, "apply_seconds": 0.0, "rounds": 0}
        if not self._pipelined():
            return self._drain_serial(max_rounds)
        rounds = 0
        committed = chained = False
        pending = None  # (handle, batch, statics, scheduled, schedule span)
        while True:
            batch, scheduled_total, ssp = self._schedule_batch(rounds, max_rounds)
            if pending is not None:
                # an empty schedule means the batch in flight is the drain's
                # final one: with the prefetch armed, its dispatch chains
                # the resolve and digest in
                chained = self._commit_pending(
                    pending, chain_digest=self.prefetch_digest and not batch)
                committed = True
                pending = None
            if not batch:
                break
            statics = self._prep_fused_batch(batch)
            handle = self._ensure_stager().submit(self._stage_fused_batch, batch, statics)
            pending = (handle, batch, statics, scheduled_total, ssp)
            rounds += len(batch)
        if committed and self.prefetch_digest and not chained:
            # the single-round forms and the paged layout keep the
            # separate resolve
            self._prefetch_digest()
        self._sweep_decode_quarantine()
        return rounds

    def _drain_serial(self, max_rounds: int) -> int:
        """Unpipelined drain (mesh, block-chunked, ragged and engine-capture
        sessions, and ``fused_pipeline=False``): schedule, then commit, per
        batch.  A mesh drain counts as fused (one batch, one
        ``streaming.fused_dispatches``) and ends with the digest prefetch
        when armed, as the reference's mesh drain."""
        fused = self._fused_eligible()
        rounds = 0
        while rounds < max_rounds:
            batch, scheduled_total, ssp = self._schedule_batch(rounds, max_rounds)
            if not batch:
                break
            with self.tracer.span("streaming.apply", rounds=len(batch)) as asp:
                self._commit_rounds(batch)
            if fused and (self._COUNTS_FUSED_DISPATCHES or self.mesh is not None):
                GLOBAL_COUNTERS.add("streaming.fused_dispatches")
            self._emit_round_stats(batch, scheduled_total, ssp.duration, asp.duration,
                                   origin="streaming.fused" if fused else "streaming.round")
            rounds += len(batch)
        if rounds and fused and self.prefetch_digest:
            for bi in range(self._n_blocks()):
                self._digest_resolution(bi)
            GLOBAL_COUNTERS.add("streaming.digest_chained")
        self._sweep_decode_quarantine()
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
        """A doc's full change history for scalar replay: its decoded wire
        frames in frame mode, the object log otherwise."""
        if sess.frame_mode:
            return [ch for f in sess.frames for ch in decode_frame(f)]
        return sess.log + sess.pending

    def _replayed(self, doc_index: int) -> Doc:
        """The doc's scalar replay (the read path of fallback and overflowed
        docs), kept until its history grows: every read of a long fallback
        doc would otherwise replay all of it again.  Callers only read it."""
        sess = self.docs[doc_index]
        key = (sess.frame_mode, len(sess.frames), len(sess.log) + len(sess.pending))
        hit = self._replay_cache.get(doc_index)
        if hit is None or hit[0] != key:
            hit = self._replay_cache[doc_index] = (key, _replay_doc(self._replay_changes(sess)))
        return hit[1]

    def _attr_tables(self, sess: _DocSession, doc_index: int):
        """(link/general attr table, comment-id table) for decode: frame
        docs use the session table and their per-doc comment ids; object
        docs intern both in their encoder's attr table."""
        if sess.frame_mode:
            return self._frame_attrs, self._doc_comment_ids.get(doc_index)
        attrs = sess.encoder.attrs if sess.encoder else None
        return attrs, attrs

    def _block_bounds(self, block_index: int):
        lo = block_index * self._read_chunk
        return lo, min(lo + self._read_chunk, self._padded_docs)

    def _n_blocks(self) -> int:
        if self.mesh is not None:
            return self.mesh.size
        return -(-self._padded_docs // self._read_chunk)

    def _block_device(self, block_index: int) -> torch.device:
        """The device a block's state lives on: its shard's under a mesh."""
        return self.mesh.devices[block_index] if self.mesh is not None else self.device

    def _state_block(self, block_index: int) -> PackedDocs:
        """The session state's rows of one block (views, not copies; a mesh
        session's block is its shard's own state)."""
        if self._shard_state is not None:
            return self._shard_state[block_index]
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
        on_device = self._block_fallback_mask(block_index)
        with self.tracer.span("streaming.resolve", block=block_index):
            resolved, digest_dev = self._block_resolve_digest(
                block_index, torch.from_numpy(on_device).to(self._block_device(block_index)))
        entry = _BlockResolution(resolved, digest_dev, on_device)
        if len(cache) >= 2:  # bound device memory at large scale
            cache.pop(next(iter(cache)))  # least-recently-used
        cache[block_index] = entry
        return entry

    def _block_resolve_digest(self, block_index: int, row_mask: torch.Tensor):
        """The program :meth:`_resolution` caches: one block's resolution
        and its per-doc full-state hash vector."""
        lo, hi = self._block_bounds(block_index)
        return _resolve_block_digest(self._state_block(block_index), self.comment_capacity,
                                     row_mask, *self._digest_tables(lo, hi))

    def _block_text_digest(self, block_index: int, row_mask: torch.Tensor):
        """One block's text-only digest and overflow vector."""
        return _resolve_digest(self._state_block(block_index), self.comment_capacity, row_mask)

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
            return _doc_spans(self._replayed(doc_index))
        resolved, local = self._resolved_doc(doc_index)
        if bool(resolved.overflow[local]):
            return _doc_spans(self._replayed(doc_index))
        attrs, comments = self._attr_tables(sess, doc_index)
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
            return doc_chars_scalar(self._replayed(doc_index))
        resolved, local = self._resolved_doc(doc_index)
        if bool(resolved.overflow[local]):
            return doc_chars_scalar(self._replayed(doc_index))
        attrs, comments = self._attr_tables(sess, doc_index)
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
                torch.from_numpy(cursor_elem).to(self._block_device(bi)),
            ).cpu().numpy()
            for d, cursors in block_map.items():
                out[d] = [int(p) for p in positions[int(self._row_of[d]) - lo, : len(cursors)]]
        for d in replay_docs:
            out[d] = oracle_cursor_positions(self._replayed(d), cursor_map[d])
        return out

    def read_root(self, doc_index: int) -> dict:
        """One doc's root map (nested maps + the text character list):
        device docs decode their LWW register table, fallback docs replay
        through the oracle."""
        from ..ops.decode import decode_doc_root

        sess = self.docs[doc_index]
        if sess.fallback:
            return copy.deepcopy(self._replayed(doc_index).root)
        resolved, local = self._resolved_doc(doc_index)
        if bool(resolved.overflow[local]):
            return copy.deepcopy(self._replayed(doc_index).root)
        block = self._state_block(int(self._row_of[doc_index]) // self._read_chunk)
        regs = SimpleNamespace(**{
            f: getattr(block, f)[local:local + 1].cpu().numpy()
            for f in ("r_obj", "r_key", "r_op", "r_kind", "r_val", "num_regs")
        })
        one = ResolvedDocs(*(x[local:local + 1] for x in resolved))
        keys = self._map_keys if sess.frame_mode or sess.encoder is None else sess.encoder.keys
        return decode_doc_root(regs, one, 0, keys)

    def _block_tables(self, lo: int):
        """(attr_of, comment_of) accessors for block-local ROW indices."""
        def attr_of(local: int):
            d = int(self._doc_at[lo + local])
            return self._attr_tables(self.docs[d], d)[0]

        def comment_of(local: int):
            d = int(self._doc_at[lo + local])
            table = self._attr_tables(self.docs[d], d)[1]
            return table if table is not None else Interner()

        return attr_of, comment_of

    def _block_device_mask(self, compact: CompactBlock, lo: int, hi: int) -> np.ndarray:
        """Rows of a block served from device state (not fallback/overflow)."""
        return self._block_fallback_mask(lo // self._read_chunk) & ~compact.overflow[: hi - lo]

    # -- the visible-prefix sweep ------------------------------------------------

    def _compact_cached(self, block_index: int):
        """CompactBlock cache lookup for the current (round, placement)."""
        stamp = (self.rounds, self._placement_epoch)
        if self._compact_cache[0] != stamp:
            self._compact_cache = (stamp, {}, 0)
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
                    out[d] = spans[local] if mask[local] else _doc_spans(self._replayed(d))
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
                        self._replayed(d))
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
        sess_attr = self._frame_attrs.content_hashes()
        sess_keys = self._map_keys.content_hashes()
        enc = {
            row: self.docs[d].encoder
            for row in range(lo, hi)
            if (d := int(self._doc_at[row])) >= 0 and not self.docs[d].frame_mode
            and self.docs[d].encoder is not None
        }
        comments = {
            int(self._row_of[d]) - lo: t for d, t in sorted(self._doc_comment_ids.items())
            if lo <= int(self._row_of[d]) < hi and self.docs[d].frame_mode
        }
        key = (len(sess_attr), len(sess_keys), self._placement_epoch,
               tuple((row, len(e.attrs), len(e.keys)) for row, e in sorted(enc.items())),
               tuple((row, len(t)) for row, t in comments.items()))
        cached = self._digest_tables_cache.get((lo, hi))
        if cached is not None and cached[0] == key:
            return cached[1]
        tables = self._hash_tables(hi - lo, sess_attr, sess_keys,
                                   {row - lo: e for row, e in enc.items()}, comments,
                                   _width_bucket(len(enc)) if enc else 0,
                                   self._block_device(lo // self._read_chunk))
        self._digest_tables_cache[(lo, hi)] = (key, tables)
        return tables

    def _digest_tables_rows(self, rows: np.ndarray, n_real: int, device: torch.device):
        """:meth:`_digest_tables` for a GATHERED row subset, by position in
        ``rows``, on ``device``; only the first ``n_real`` positions are
        real (the rest is power-of-two padding whose table entries stay
        zero)."""
        enc, comments = {}, {}
        for i in range(n_real):
            d = int(self._doc_at[rows[i]])
            if d < 0:
                continue
            if self.docs[d].frame_mode:
                if d in self._doc_comment_ids:
                    comments[i] = self._doc_comment_ids[d]
            elif self.docs[d].encoder is not None:
                enc[i] = self.docs[d].encoder
        return self._hash_tables(len(rows), self._frame_attrs.content_hashes(),
                                 self._map_keys.content_hashes(), enc, comments,
                                 _width_bucket(len(enc)) if enc else 0, device)

    def _hash_tables(self, n_rows: int, sess_attr, sess_keys, enc: Dict[int, DocEncoder],
                     comments: Dict[int, Interner], n_obj: int, device: torch.device):
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
        for row, table in comments.items():  # frame docs' per-doc comment ids
            ch = table.content_hashes()
            comment_hash[row, : min(c_w, len(ch))] = ch[: min(c_w, len(ch))]
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
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

    def _rows_digest_parts(self, rest: np.ndarray) -> list:
        """``[(rows, per_doc, overflow), ...]``: the sub-batch hash programs
        of dirty rows ``rest``, one per shard that holds some under a mesh
        (each on its device), else one."""
        if self.mesh is None:
            return [(rest, *self._schedule_rows_digest(rest))]
        shard = rest // self._read_chunk
        return [(rest[shard == s], *self._schedule_rows_digest(rest[shard == s]))
                for s in np.unique(shard)]

    def _schedule_rows_digest(self, rest: np.ndarray):
        """The gathered sub-batch hash program for dirty rows ``rest`` (of
        one shard under a mesh), padded to a power of two; returns
        ``(per_doc, overflow)`` on the rows' device — the first
        ``len(rest)`` entries are the rows'."""
        k = _width_bucket(len(rest))
        rows_idx = np.zeros(k, np.int64)
        rows_idx[: len(rest)] = rest
        mask = np.zeros(k, bool)
        mask[: len(rest)] = True
        bi = int(rest[0]) // self._read_chunk if self.mesh is not None else 0
        dev = self._block_device(bi)
        local = rows_idx.copy()
        local[: len(rest)] -= self._block_bounds(bi)[0]
        idx = torch.from_numpy(local).to(dev)
        state = self._state_block(bi) if self.mesh is not None else self.state
        sub = PackedDocs(*(x[idx] for x in state))
        return _rows_digest(sub, self.comment_capacity, torch.from_numpy(mask).to(dev),
                            *self._digest_tables_rows(rows_idx, len(rest), dev))

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
            for rows, per_doc, ov in self._rows_digest_parts(rest):
                self._digest_plane[rows] = per_doc.cpu().numpy()[: len(rows)].astype(np.uint32)
                self._digest_ov[rows] = ov.cpu().numpy()[: len(rows)]
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
                digest, overflow = self._block_text_digest(
                    bi, torch.from_numpy(on_device_all[lo:hi]).to(self._block_device(bi)))
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
        doc = self._replayed(doc_index)
        cps, slots = _doc_char_slots(doc)
        part = doc_digest_host(cps, slots, self._slot_capacity)
        if full:
            part = (part + _doc_full_extras_host(doc, slots, self._actor_table)) & M32
        return part

    def digest_async(self) -> "_PendingDigest":
        """Queue the full-state digest without waiting for the card: the
        hash programs of the invalid rows are enqueued, and the handle's
        ``wait()`` fetches only their hash and overflow vectors.

        The device hashes describe the state at scheduling time.  Docs that
        were fallback then, or that the overflow vectors route to scalar
        replay, hash at ``wait()`` from their current history, so call
        ``wait()`` before further ingestion when such docs exist.  A round
        or reshard before ``wait()`` keeps the fetched hashes out of the
        carried plane (they describe rows that have since changed)."""
        on_dev = self._on_device_mask()
        need = ~self._digest_row_valid & on_dev & (self._doc_at >= 0)
        parts = []
        for bi in range(self._n_blocks()):
            lo, hi = self._block_bounds(bi)
            if int(need[lo:hi].sum()) > (hi - lo) // 4:
                entry = self._digest_resolution(bi)
                # only the vectors: the resolved planes stay evictable
                parts.append((np.arange(lo, hi), entry.digest_dev, entry.device.overflow))
                need[lo:hi] = False
        rest = np.nonzero(need)[0]
        if len(rest):
            parts.extend(self._rows_digest_parts(rest))
        snapshot = (
            self._digest_plane.copy(), self._digest_ov.copy(), self._digest_row_valid.copy(),
            on_dev, self._doc_at.copy(), [i for i, s in enumerate(self.docs) if s.fallback],
        )
        return _PendingDigest(self, parts, snapshot, self.rounds, self._placement_epoch)

    def doc_digest(self, doc_index: int) -> int:
        """ONE doc's full-state convergence hash — exactly the per-doc term
        :meth:`digest` sums, so ``sum(doc_digest(i)) mod 2**32 == digest()``;
        comparable across sessions.  A doc whose carried hash is current
        reads it without a refresh pass (which walks every doc)."""
        if not self.docs[doc_index].fallback:
            row = int(self._row_of[doc_index])
            if not self._digest_row_valid[row]:
                self._refresh_digest_rows()
            if not self._digest_ov[row]:
                return int(self._digest_plane[row])
        return self._host_digest(doc_index)

    # -- durable history ---------------------------------------------------------

    def doc_history_frames(self, doc_index: int) -> List[bytes]:
        """The doc's full ingested history as wire frames (re-ingesting them
        rebuilds the doc exactly; duplicates are tolerated).  Frame docs
        return their raw frames; object and fallback docs re-encode their
        log."""
        sess = self.docs[doc_index]
        if sess.frame_mode:
            return list(sess.frames)
        changes = self._replay_changes(sess)
        return [encode_frame(changes)] if changes else []

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
        if self._clock_mat.size:
            col_max = self._clock_mat.max(axis=0)  # frame docs
            for idx in np.nonzero(col_max)[0]:
                merged[self._actor_table.lookup(int(idx))] = int(col_max[idx])
        for sess in self.docs:
            for actor, seq in sorted(sess.clock.items()):
                merged[actor] = max(merged.get(actor, 0), seq)
        return dict(sorted(merged.items()))

    def overflow_count(self) -> int:
        """Docs the device read path cannot serve (apply-time overflow or
        resolve-time errors) — the docs read() routes to scalar replay."""
        return sum(int(self._resolution(bi).overflow.sum()) for bi in range(self._n_blocks()))

    def pending_count(self) -> int:
        pooled = sum(int(self._frame_mode[d].sum()) for d, _ in self._pool)
        return pooled + sum(len(s.pending) for s in self.docs)

    def pending_rounds_estimate(self) -> int:
        """Upper-bound estimate of the rounds a full ``drain()`` needs: the
        deepest per-doc pending queue (pooled frame changes included)."""
        if not self.num_docs:
            return 0
        per_doc = np.zeros(self.num_docs, np.int64)
        for doc_of, _ in self._pool:
            live = np.asarray(doc_of)[self._frame_mode[doc_of]]
            if live.size:
                per_doc += np.bincount(live, minlength=self.num_docs)
        for d, sess in enumerate(self.docs):
            per_doc[d] += len(sess.pending)
        return int(per_doc.max())

    @property
    def layout(self) -> str:
        """Resident-state storage layout."""
        return self._layout

    # -- placement -------------------------------------------------------------

    def reshard(self, assignment: Optional[Sequence[int]] = None) -> dict:
        """Balance doc placement across shards: the mesh's shards, or
        without a mesh the read blocks (a block bounds a read's and a
        digest's latency).

        Docs are placed at first sight and never move otherwise, so skewed
        arrival leaves hot blocks.  This moves doc rows between blocks by
        one permutation of the row axis (:meth:`_permute_rows`), while every
        logical doc id, clock, interner, pending queue and fallback flag
        stays put: placement lives behind ``_row_of``/``_doc_at``, so reads,
        ingest and digests do not change (the digest is a sum over docs).

        ``assignment`` maps each doc to a shard (length ``num_docs``).  The
        default places the largest doc first onto the least loaded shard
        with a free row.  Quarantined and fallback docs are host-bound
        (scalar replay runs on the host), so they place first and balance
        their own load before the slot load; device docs weigh slot load
        first.  Returns ``{"moved": n, "shard_load": [...],
        "host_bound_load": [...]}``."""
        n_shards = self._n_blocks()
        if n_shards <= 1 or self.num_docs == 0:
            return {"moved": 0, "shard_load": [0] * max(n_shards, 1),
                    "host_bound_load": [0] * max(n_shards, 1)}
        if self._padded_docs % n_shards:
            raise ValueError("padded doc axis must divide the shard count")
        rows_per_shard = self._padded_docs // n_shards
        sizes = self._reshard_sizes()
        host_bound = {d for d in range(self.num_docs)
                      if self.docs[d].fallback or d in self._quarantine}
        if assignment is None:
            order = sorted(range(self.num_docs),
                           key=lambda d: (d not in host_bound, -int(sizes[d])))
            load = [0] * n_shards
            hb_load = [0] * n_shards
            free = [rows_per_shard] * n_shards
            assignment = [0] * self.num_docs
            for d in order:
                key = ((lambda s: (hb_load[s], load[s])) if d in host_bound
                       else (lambda s: (load[s], hb_load[s])))
                s = min((s for s in range(n_shards) if free[s] > 0), key=key)
                assignment[d] = s
                load[s] += int(sizes[d])
                if d in host_bound:
                    hb_load[s] += int(sizes[d])
                free[s] -= 1
        else:
            assignment = [int(s) for s in assignment]
            if len(assignment) != self.num_docs:
                raise ValueError("assignment must cover every doc")
            for s, count in zip(*np.unique(assignment, return_counts=True)):
                if not 0 <= s < n_shards:
                    raise ValueError(f"shard {s} out of range")
                if count > rows_per_shard:
                    raise ValueError(f"shard {s} over capacity: {count} docs")

        next_row = [s * rows_per_shard for s in range(n_shards)]
        new_row = np.empty(self.num_docs, np.int64)
        for d, s in enumerate(assignment):
            new_row[d] = next_row[s]
            next_row[s] += 1
        moved = int((new_row != self._row_of).sum())
        if moved:
            # new row r takes old row src[r]; rows holding no doc recycle
            # the old empty rows, so src is a full permutation
            src = np.full(self._padded_docs, -1, np.int64)
            src[new_row] = self._row_of
            spare = iter(sorted(set(range(self._padded_docs)) - set(self._row_of.tolist())))
            for r in range(self._padded_docs):
                if src[r] < 0:
                    src[r] = next(spare)
            self._permute_rows(src)
            self._cum_ins = self._cum_ins[src]  # the occupancy bound rides the rows
            self._row_of = new_row
            self._doc_at = np.full(self._padded_docs, -1, np.int64)
            self._doc_at[new_row] = np.arange(self.num_docs)
            # every row-keyed cache is stale, and a pending async digest
            # must not write back (it checks the epoch)
            self._resolved_cache = (-1, {})
            self._digest_row_valid[:] = False
            self._placement_epoch += 1
        shard_load = [0] * n_shards
        host_bound_load = [0] * n_shards
        for d, s in enumerate(assignment):
            shard_load[s] += int(sizes[d])
            if d in host_bound:
                host_bound_load[s] += int(sizes[d])
        return {"moved": moved, "shard_load": shard_load, "host_bound_load": host_bound_load}

    def _reshard_sizes(self) -> np.ndarray:
        """(num_docs,) per-doc load for reshard's balancing: live device
        slots (the page-pool layouts balance pages)."""
        states = self._shard_state if self.mesh is not None else [self.state]
        slots = np.concatenate([st.num_slots.cpu().numpy() for st in states])
        return slots[self._row_of[: self.num_docs]]

    def _permute_rows(self, src: np.ndarray) -> None:
        """New row r takes old row src[r]: one gather over the doc axis, or
        under a mesh one per destination shard from every source shard."""
        if self.mesh is not None:
            self._shard_state = permute_shard_rows(self._shard_state, src, self.mesh)
            return
        idx = torch.from_numpy(src).to(self.device)
        self.state = PackedDocs(*(x[idx] for x in self.state))

    def sync_device(self) -> None:
        """Block until all queued device work has completed (on every card
        of a mesh)."""
        if self.mesh is not None:
            self.mesh.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class _PendingDigest:
    """The handle :meth:`StreamingMerge.digest_async` returns.

    Holds the queued per-row hash and overflow vectors (never the resolved
    planes) and a scheduling-time snapshot of the carried plane and masks;
    ``wait`` merges the fetched vectors into the snapshot, adds the host
    replay hashes as ``digest()`` does, and writes the fresh hashes back
    into the live plane only when no round or reshard came in between."""

    __slots__ = ("_session", "_parts", "_snapshot", "_value", "_stamp", "_epoch")

    def __init__(self, session: StreamingMerge, parts, snapshot, stamp: int, epoch: int) -> None:
        self._session = session
        self._parts = parts
        self._snapshot = snapshot
        self._value: Optional[int] = None
        self._stamp = stamp  # session round at scheduling time
        self._epoch = epoch  # placement epoch at scheduling time

    def wait(self) -> int:
        if self._value is not None:
            return self._value
        s = self._session
        plane, ovp, valid, on_dev, doc_at, fallback_docs = self._snapshot
        writeback = s.rounds == self._stamp and s._placement_epoch == self._epoch
        for rows, vec_dev, ov_dev in self._parts:
            vec = vec_dev.cpu().numpy()[: len(rows)].astype(np.uint32)
            ov = ov_dev.cpu().numpy()[: len(rows)]
            plane[rows], ovp[rows] = vec, ov
            valid[rows] = on_dev[rows] & (doc_at[rows] >= 0)
            if writeback:
                s._digest_plane[rows] = vec
                s._digest_ov[rows] = ov
                s._digest_row_valid[rows] = valid[rows]
        ok = valid & on_dev & ~ovp & (doc_at >= 0)
        total = int(plane[ok].sum(dtype=np.uint32))
        replay_docs = list(fallback_docs)
        replay_docs.extend(int(doc_at[r]) for r in np.nonzero(ovp & on_dev & (doc_at >= 0))[0])
        for i in replay_docs:
            total = (total + s._host_digest(i)) & M32
        self._value = total
        self._parts = ()  # release the device refs
        self._snapshot = None
        return total


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


def _doc_spans(doc: Doc) -> List[FormatSpan]:
    return doc.get_text_with_formatting(["text"])


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
