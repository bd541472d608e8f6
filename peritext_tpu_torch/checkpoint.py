"""Checkpoint / resume.

The reference has no checkpointing; its durable state is the per-actor change
logs themselves — any replica is reconstructible by replaying changes (event
sourcing; reference ``queues`` test/fuzz.ts:160-163, failed-state traces
test/fuzz.ts:16-20).  This module makes that durability real and adds a fast
path for the device state:

* **Change-log persistence** — the source of truth.  A :class:`ChangeStore`
  round-trips through JSON-lines in the reference's exact change wire format,
  so checkpoints interoperate with recorded reference traces.
* **Replica restore by replay** — rebuild any ``Doc`` from the log.
* **Packed-state snapshots** — the batched device state (``PackedDocs``) is a
  NamedTuple of int tensors; it serializes to one ``.npz`` with the JAX
  package's keys, so either package loads the other's snapshots.  Restoring
  a snapshot skips replaying history for long-lived batches; the change log
  still guards against snapshot loss.
* **CheckpointManager** — step-tagged checkpoint directories with atomic
  publish (write to temp, rename) and retention, so a long streaming run can
  resume after a failure (SURVEY §5.4 *Build* item).

Failed fuzz states serialize via :func:`save_failed_trace` in the same
queues-plus-evidence shape the reference writes to ``traces/*.json``
(test/fuzz.ts:16-20), replayable by ``testing/traces.py``.

Every file format equals the JAX package's, and nothing written names a
device: a checkpoint saved from a session on the card restores on the CPU,
and the reverse.  The entry points that build device state
(:func:`load_packed`, :func:`restore_session`, :meth:`Checkpoint.session`)
run on ``cuda`` unless given a ``device``, and raise without a card.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .core.doc import Doc
from .core.types import Change
from .ops.packed import PackedDocs, packed_from_numpy
from .parallel.anti_entropy import ChangeStore, apply_changes
from .utils.device import resolve_device



# ---------------------------------------------------------------------------
# Change-log persistence (the durable source of truth)
# ---------------------------------------------------------------------------


def save_change_log(store: ChangeStore, path: str | Path) -> int:
    """Write every change as one JSON line (wire format); returns the count."""
    path = Path(path)
    count = 0
    with open(path, "w") as f:
        for actor in sorted(store.actors()):
            for change in store.log(actor):
                f.write(json.dumps(change.to_json()) + "\n")
                count += 1
    return count


def load_change_log(path: str | Path) -> ChangeStore:
    store = ChangeStore()
    by_actor: Dict[str, List[Change]] = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                change = Change.from_json(json.loads(line))
                by_actor.setdefault(change.actor, []).append(change)
    # logs must append in seq order regardless of file order
    for changes in by_actor.values():
        for change in sorted(changes, key=lambda c: c.seq):
            store.append(change)
    return store


def doc_from_store(store: ChangeStore, actor_id: str = "restored") -> Doc:
    """Rebuild a replica by replaying the full log (event-sourcing restore)."""
    doc = Doc(actor_id)
    changes = [ch for actor in store.actors() for ch in store.log(actor)]
    apply_changes(doc, changes)
    return doc


# ---------------------------------------------------------------------------
# Packed device-state snapshots
# ---------------------------------------------------------------------------


def save_packed(state: PackedDocs, path: str | Path) -> None:
    """Snapshot the batched device state to one ``.npz`` (host transfer of
    every field, then a single file write).  Fields may be tensors on any
    device or numpy arrays."""
    arrays = {name: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
              for name, x in zip(PackedDocs._fields, state)}
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_packed(path: str | Path,
                device: Optional[Union[str, torch.device]] = None) -> PackedDocs:
    """Load a packed snapshot as tensors on ``device`` (default ``cuda``).
    Fields absent from the file (snapshots written before the schema gained
    them, e.g. the map-register table) default to empty: zeros are exactly
    the state a doc without those ops holds, so old snapshots stay
    loadable."""
    dev = resolve_device(device)
    with np.load(path) as data:
        num_docs = data["elem_id"].shape[0]

        def field(name: str) -> np.ndarray:
            if name in data:
                return data[name]
            if name == "overflow":
                return np.zeros((num_docs,), bool)
            if name in ("num_slots", "num_tombs", "num_marks", "num_regs"):
                return np.zeros((num_docs,), np.int32)
            return np.zeros((num_docs, 32), np.int32)  # table default width

        return packed_from_numpy([field(name) for name in PackedDocs._fields], dev)


# ---------------------------------------------------------------------------
# Streaming-session checkpoints (event-sourced: the frame log IS the state)
# ---------------------------------------------------------------------------

_LEN = "<I"


def _write_frames(path: Path, frames: List[bytes]) -> None:
    path.write_bytes(pack_doc_frames(frames))


def _read_frames(path: Path) -> List[bytes]:
    try:
        return unpack_doc_frames(path.read_bytes())
    except ValueError as exc:
        raise ValueError(f"truncated frame file: {path}") from exc


def pack_doc_frames(frames: List[bytes]) -> bytes:
    """One doc's checkpoint frame history as a single SHIPPABLE blob —
    the unit a checkpoint ship moves between hosts.  Same
    length-prefix framing as the on-disk ``doc_*.frames`` files, so a
    shipped checkpoint and a saved one are byte-interchangeable.
    Re-ingesting the unpacked frames reconstructs the doc exactly
    (event sourcing), and frames are duplicate-tolerant, so overlap
    between a shipped checkpoint and later journal redelivery is
    harmless."""
    import struct

    out = bytearray()
    for frame in frames:
        out += struct.pack(_LEN, len(frame))
        out += frame
    return bytes(out)


def unpack_doc_frames(data: bytes) -> List[bytes]:
    """Inverse of :func:`pack_doc_frames`; raises ``ValueError`` on a
    truncated blob (a partial ship must fail loudly, never ingest a
    half-frame)."""
    import struct

    frames: List[bytes] = []
    pos = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("truncated doc-frame blob")
        (length,) = struct.unpack_from(_LEN, data, pos)
        pos += 4
        if pos + length > len(data):
            raise ValueError("truncated doc-frame blob")
        frames.append(data[pos:pos + length])
        pos += length
    return frames


def save_session(session, directory: str | Path) -> Dict[str, Any]:
    """Checkpoint a :class:`~.parallel.streaming.StreamingMerge` session.

    Durable form = per-doc wire-frame histories (event sourcing): restoring
    re-ingests the frames, which reconstructs device state, clocks, attr
    tables, and fallback routing exactly — no device-state serialization to
    keep consistent.  Frames are duplicate-tolerant, so overlap between a
    checkpoint and post-checkpoint redelivery is harmless.

    Layout-agnostic by the same token: a paged session (store/) checkpoints
    as the identical frame history — pages, page tables and the pool are
    derived state the restore rebuilds — and the ``layout`` (plus
    ``page_size``) rides in the config, so restore constructs the same
    backend.  The top-level ``layout`` key mirrors it for scrapers that
    read checkpoint metadata without parsing the config.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    total = 0
    for i in range(session.num_docs):
        frames = session.doc_history_frames(i)
        if not frames:
            continue  # untouched doc: no file (restore treats absent as empty)
        total += len(frames)
        _write_frames(directory / f"doc_{i:06d}.frames", frames)
    meta = {
        "kind": "streaming-session",
        "actors": list(session.actors),
        "rounds": session.rounds,
        "frames": total,
        "layout": getattr(session, "layout", "padded"),
        "config": session.config,
    }
    (directory / "session.json").write_text(json.dumps(meta, indent=2))
    return meta


def restore_session(directory: str | Path, mesh=None, drain: bool = True,
                    device: Optional[Union[str, torch.device]] = None):
    """Rebuild a session from :func:`save_session` output by re-ingesting
    every doc's frame history in one bulk call (and draining, unless
    ``drain=False``), on
    ``device`` (default ``cuda``).  The ``StreamingMerge`` factory builds
    the layout the config names (padded, paged or ragged).  ``mesh`` (a
    parallel/mesh.Mesh) restores onto a mesh, whatever mesh (or none) the
    saved session ran on: the saved state is each doc's frame history, so
    a mesh session restores meshless and the reverse, with equal digests."""
    from .parallel.streaming import StreamingMerge

    directory = Path(directory)
    meta = json.loads((directory / "session.json").read_text())
    # the config dict is written verbatim from StreamingMerge.config, so the
    # key set can never drift between save and restore
    session = StreamingMerge(actors=meta["actors"], mesh=mesh, device=device, **meta["config"])
    # every doc's frames, in doc and frame order, through ONE bulk
    # ingest_frames call: the same state as one ingest_frame per frame (the
    # bulk form processes frames in order), without a native parse per frame
    items = []
    for i in range(session.num_docs):
        path = directory / f"doc_{i:06d}.frames"
        if path.exists():
            items.extend((i, frame) for frame in _read_frames(path))
    session.ingest_frames(items)
    if drain:
        # drain() caps rounds per call; keep draining until no admissible
        # work remains so a huge history never silently restores truncated.
        # Changes still pending after that are causally stuck — normal for a
        # mid-stream checkpoint (their deps had not arrived at save time);
        # they stay pending exactly as they did in the saved session.
        while session.drain() > 0:
            pass
    return session


# ---------------------------------------------------------------------------
# Step-tagged checkpoints with atomic publish + retention
# ---------------------------------------------------------------------------

_STEP_PREFIX = "step_"

#: staging dirs older than this are crash leftovers; younger ones may be a
#: concurrent saver's live staging (see CheckpointManager.__init__)
_STAGING_STALE_SECONDS = 3600.0


@dataclass
class Checkpoint:
    step: int
    directory: Path
    meta: Dict[str, Any]
    #: where :attr:`packed` and :meth:`session` build state (None: ``cuda``)
    device: Optional[Union[str, torch.device]] = None

    @property
    def store(self) -> ChangeStore:
        return load_change_log(self.directory / "changes.jsonl")

    @property
    def packed(self) -> Optional[PackedDocs]:
        path = self.directory / "packed.npz"
        return load_packed(path, device=self.device) if path.exists() else None

    def session(self, mesh=None, drain: bool = True,
                device: Optional[Union[str, torch.device]] = None):
        """Restore the streaming session saved in this checkpoint (None if
        the checkpoint holds no session), on ``device`` (default: the
        checkpoint's)."""
        path = self.directory / "session"
        if not path.exists():
            return None
        return restore_session(path, mesh=mesh, drain=drain,
                               device=self.device if device is None else device)


class CheckpointManager:
    """Directory of step-tagged checkpoints.

    Each checkpoint is staged in a temp dir and published with an atomic
    rename, so a crash mid-save never corrupts the latest good checkpoint.
    ``keep`` bounds how many checkpoints are retained (oldest pruned).
    ``device`` is where the checkpoints it returns build state (default
    ``cuda``); saving reads whatever device the state is on.
    """

    def __init__(self, root: str | Path, keep: int = 3,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.device = device
        # a crash mid-save (kill -9 between mkdtemp and the atomic rename)
        # leaves a staging dir behind; it was never published, so it is
        # garbage — sweep it rather than leak one per crash.  Only STALE
        # dirs are swept: a freshly-modified one may belong to a live saver
        # on the same root (supervisor restart racing the old process's
        # in-flight save), whose rename must not be sabotaged.
        import time

        cutoff = time.time() - _STAGING_STALE_SECONDS
        for stale in self.root.glob(".staging_*"):
            try:
                if stale.stat().st_mtime < cutoff:
                    shutil.rmtree(stale, ignore_errors=True)
            except OSError:
                pass  # raced with its owner's rename/cleanup

    def save(
        self,
        step: int,
        store: Optional[ChangeStore] = None,
        packed: Optional[PackedDocs] = None,
        session=None,
        meta: Optional[Dict[str, Any]] = None,
    ) -> Path:
        if store is None and packed is None and session is None:
            raise ValueError(
                "nothing to checkpoint: need a store, packed state, or session"
            )
        final = self.root / f"{_STEP_PREFIX}{step:012d}"
        staging = Path(tempfile.mkdtemp(prefix=".staging_", dir=self.root))
        try:
            payload_meta = dict(meta or {})
            payload_meta["step"] = step
            if store is not None:
                payload_meta["changes"] = save_change_log(store, staging / "changes.jsonl")
            if packed is not None:
                save_packed(packed, staging / "packed.npz")
                payload_meta["num_docs"] = int(packed.num_docs)
            if session is not None:
                payload_meta["session"] = save_session(session, staging / "session")
            (staging / "meta.json").write_text(json.dumps(payload_meta, indent=2))
            if final.exists():
                shutil.rmtree(final)
            os.rename(staging, final)
        except BaseException:  # graftlint: boundary(staging cleanup then re-raise; KeyboardInterrupt must not leak a half-written checkpoint)
            shutil.rmtree(staging, ignore_errors=True)
            raise
        self._prune()
        return final

    def steps(self) -> List[int]:
        # only PUBLISHED checkpoints count: the atomic rename guarantees a
        # step_* dir is complete, but a meta.json check keeps a manually
        # damaged (or foreign) directory from masking the last good one
        return sorted(
            int(p.name[len(_STEP_PREFIX):])
            for p in self.root.iterdir()
            if p.is_dir() and p.name.startswith(_STEP_PREFIX)
            and (p / "meta.json").exists()
        )

    def latest(self) -> Optional[Checkpoint]:
        steps = self.steps()
        return self.restore(steps[-1]) if steps else None

    def restore(self, step: int) -> Checkpoint:
        directory = self.root / f"{_STEP_PREFIX}{step:012d}"
        meta = json.loads((directory / "meta.json").read_text())
        return Checkpoint(step=step, directory=directory, meta=meta, device=self.device)

    def _prune(self) -> None:
        steps = self.steps()
        for step in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / f"{_STEP_PREFIX}{step:012d}")


# ---------------------------------------------------------------------------
# Failed-state traces (reference saveFailedTrace, test/fuzz.ts:16-20)
# ---------------------------------------------------------------------------


def save_failed_trace(
    path: str | Path,
    store: ChangeStore,
    evidence: Optional[Dict[str, Any]] = None,
) -> None:
    """Serialize a failing multi-replica state: replayable per-actor change
    ``queues`` plus free-form divergence evidence.  The ``queues`` are ground
    truth; evidence fields are diagnostics only (the reference's trace files
    carry divergent final texts — SURVEY §2.15's oracle caution)."""
    payload: Dict[str, Any] = {
        "queues": {
            actor: [ch.to_json() for ch in store.log(actor)]
            for actor in sorted(store.actors())
        }
    }
    if evidence:
        payload.update(evidence)
    Path(path).write_text(json.dumps(payload, indent=2))
