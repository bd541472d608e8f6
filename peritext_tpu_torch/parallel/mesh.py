"""The device mesh over the document axis, and the convergence digests:
the device functions and their host mirrors.

The merge workload is data-parallel over documents.  A :class:`Mesh` is an
ordered tuple of torch devices, one per shard; shard ``s`` owns doc rows
``[s * R, (s + 1) * R)`` of a doc axis padded to a multiple of the shard
count (:func:`pad_doc_axis`, ``R = padded / size``), and every per-shard
tensor lives on its shard's device (:func:`shard_docs`).  One process
drives the whole mesh: kernels launch per shard on that shard's device,
and what the reference's programs do with collectives is host-driven here
(a digest is a host sum of the shards' uint32 partial sums; rows and pages
move between shards as ``tensor.to(device)`` copies, peer copies between
cards).

Two sessions that converged hold equal digests.  The device functions hash
every doc of a batch at once; the host mirrors hash one scalar-replay doc
with the same formula, bit for bit, so fallback and device docs sum into
one comparable value.

The arithmetic is uint32 with wraparound.  ``torch.uint32`` implements
neither sums nor shifts on every device, so every value here is an int64
holding an unsigned 32-bit word, masked with ``& 0xFFFFFFFF`` after each
step.  A product of two such words can reach 2**64, past int64's range,
and signed overflow is undefined in the CUDA kernels torch runs; so
:func:`_mul32` multiplies by each constant in two 16-bit halves, keeping
every partial product below 2**48.  Sums over slots and docs are int64
sums of values below 2**32, masked at the end.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.capture import captured
from ..utils.interning import content_hash32
from ..utils.platform import mesh_devices

DOC_AXIS = "docs"


class Mesh:
    """A 1-D mesh over the doc axis: one torch device per shard, in shard
    order (module doc).  Devices may repeat (virtual shards on one
    device); a mesh that mixes device types raises.  Equal meshes hold
    equal device tuples and axis names."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 axis_name: str = DOC_AXIS) -> None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        types = {d.type for d in devs}
        if len(types) != 1:
            raise ValueError(f"a mesh cannot mix device types: {sorted(types)}")
        if devs[0].type not in ("cuda", "cpu"):
            raise ValueError(f"a mesh runs on cuda or cpu devices, not {devs[0]}")
        if devs[0].type == "cuda":
            # a bare "cuda" names whichever card is current; a shard must
            # stay on its card, so it is pinned to an index here
            devs = tuple(d if d.index is not None else torch.device("cuda", 0) for d in devs)
        self.devices: Tuple[torch.device, ...] = devs
        self.axis_name = axis_name
        self.axis_names = (axis_name,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def synchronize(self) -> None:
        """Block until every card of the mesh has finished its queued work."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and (self.devices, self.axis_name) == (
            other.devices, other.axis_name)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_name))

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_name={self.axis_name!r})"


def make_mesh(num_devices: Optional[int] = None, axis_name: str = DOC_AXIS, *,
              device: Optional[Union[str, torch.device]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A 1-D mesh: over ``devices`` when given (repeats allowed), else over
    ``num_devices`` shards from :func:`~..utils.platform.mesh_devices`
    (the first cards by default, raising when too few exist; ``device=
    "cpu"`` or ``"cuda:0"`` for virtual shards).  ``num_devices`` None
    takes every card."""
    if devices is not None:
        if num_devices is not None and num_devices != len(devices):
            raise ValueError(f"num_devices {num_devices} != {len(devices)} devices given")
        return Mesh(devices, axis_name)
    if num_devices is None:
        if device is not None and torch.device(device).type == "cpu":
            raise ValueError("a CPU mesh needs num_devices")
        num_devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num_devices == 0:
            raise RuntimeError("need at least 1 CUDA device for a mesh, have 0; pass "
                               "num_devices and device='cpu' for virtual shards")
    return Mesh(mesh_devices(num_devices, device), axis_name)


def doc_sharding(mesh: Mesh, num_rows: int) -> List[Tuple[int, int]]:
    """The row range ``(lo, hi)`` each shard owns of a ``num_rows`` doc
    axis (a multiple of the mesh size, :func:`pad_doc_axis`)."""
    if num_rows % mesh.size:
        raise ValueError(f"{num_rows} doc rows do not split into {mesh.size} equal shards")
    r = num_rows // mesh.size
    return [(s * r, (s + 1) * r) for s in range(mesh.size)]


def pad_doc_axis(array, multiple: int):
    """Pad the leading axis up to a multiple (shards need equal rows).
    Padded rows are all-zero: PAD ops and empty docs, which the kernels
    treat as no-ops.  Takes and returns a numpy array or a torch tensor."""
    if int(multiple) < 1:
        raise ValueError(f"pad multiple must be at least 1, got {multiple}")
    d = array.shape[0]
    target = -(-d // multiple) * multiple
    if target == d:
        return array
    if isinstance(array, torch.Tensor):
        pad = array.new_zeros((target - d,) + tuple(array.shape[1:]))
        return torch.cat([array, pad])
    return np.pad(array, [(0, target - d)] + [(0, 0)] * (array.ndim - 1))


def _split_leaf(x, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of one leaf as a fresh tensor on ``device`` (never a
    view of the source, even on the same device)."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return t[lo:hi].to(device, copy=True)


def shard_docs(tree, mesh: Mesh) -> list:
    """Split every leaf's leading (doc) axis into the mesh's shards: returns
    one tree per shard, its leaves torch tensors on the shard's device.
    Leaves are tensors or numpy arrays; containers are named tuples,
    tuples, lists and dicts (kept as such)."""
    def rows(t):
        if isinstance(t, dict):
            return next((rows(v) for v in t.values()), None)
        if isinstance(t, (tuple, list)):
            return next((r for r in (rows(v) for v in t) if r is not None), None)
        return int(t.shape[0])

    total = rows(tree)
    bounds = doc_sharding(mesh, total or 0)

    def split(t, lo, hi, dev):
        if isinstance(t, dict):
            return {k: split(v, lo, hi, dev) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(split(v, lo, hi, dev) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(split(v, lo, hi, dev) for v in t)
        return _split_leaf(t, lo, hi, dev)

    return [split(tree, lo, hi, dev) for (lo, hi), dev in zip(bounds, mesh.devices)]

#: mask of one unsigned 32-bit word
M32 = 0xFFFFFFFF

# -- digest mixing constants (device and host mirrors share these) ---------
# Distinct odd 32-bit multipliers; the final avalanche (*_KF; x ^= x >> 15)
# matches across every part so host stand-ins are bit-identical.
_KC1 = 2654435761  # char / register-object
_KP = 40503  # slot position
_KF = 2246822519  # final multiply before the xor-shift avalanche
_KT = 374761393  # LWW mark-type salt
_KL = 3266489917  # link url content hash salt
_KCM = 461845907  # comment id content hash salt
_KK = 668265263  # register key salt
_KV = 2869860233  # register value salt
_KKIND = 951274213  # register value-kind salt
_PAD_SEED = 0x9E3779B9


def _av_host(x: int) -> int:
    """Host mirror of the device avalanche (uint32 wraparound)."""
    x = (x * _KF) & M32
    return x ^ (x >> 15)


def format_digest_host(
    slot_positions, marks_per_char, mark_names, comment_type: int
) -> int:
    """Host mirror of :func:`per_doc_format_digest` for one scalar-replay
    doc: per visible character (at element-order slot ``s``), the active LWW
    mark types, the link url content hash, and the active comment-id content
    hashes — bit-identical to the device sums, so fallback docs participate
    in full-state digest comparison."""
    acc = 0
    for s, marks in zip(slot_positions, marks_per_char):
        for t, name in enumerate(mark_names):
            if t == comment_type:
                continue
            m = marks.get(name)
            if m and m.get("active"):
                acc = (acc + _av_host((((t + 1) * _KT) & M32) ^ ((s * _KP) & M32))) & M32
        link = marks.get("link")
        # None-check, not truthiness: an EMPTY url string is interned on the
        # device side (id >= 1, so link_attr > 0 includes it) and must hash
        # here too or fallback/device peers diverge
        if link and link.get("active") and link.get("url") is not None:
            lh = content_hash32(link["url"])
            acc = (acc + _av_host(((lh * _KL) & M32) ^ ((s * _KP) & M32))) & M32
        for c in marks.get("comment", []):
            ch = content_hash32(c["id"])
            acc = (acc + _av_host(((ch * _KCM) & M32) ^ ((s * _KP) & M32))) & M32
    return acc


def register_digest_host(rows) -> int:
    """Host mirror of :func:`per_doc_register_digest`.  ``rows`` iterates
    ``(obj_u32, key_hash, kind, val_u32)`` for every LIVE register (deleted
    keys are absent, as in the materialized doc)."""
    acc = 0
    for obj_u32, key_h, kind, val_u32 in rows:
        x = (
            ((obj_u32 * _KC1) & M32)
            ^ ((key_h * _KK) & M32)
            ^ ((kind * _KKIND) & M32)
            ^ ((val_u32 * _KV) & M32)
        )
        acc = (acc + _av_host(x)) & M32
    return acc


def doc_digest_host(codepoints, slot_positions, slot_capacity: int) -> int:
    """uint32 digest of ONE document, bit-identical to its contribution in
    :func:`convergence_digest` — computed host-side.

    Lets scalar-replay (fallback/overflow) docs participate in cross-session
    digest comparison: the device formula depends only on visible codepoints,
    their slot positions in the convergent element order (tombstones
    included), and the pad-slot count — all of which a scalar replica can
    reproduce whenever the doc fits the device capacities.  ``codepoints``
    and ``slot_positions`` are the visible characters and their indices in
    full element order."""
    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        k1, k2, k3 = np.uint32(_KC1), np.uint32(_KP), np.uint32(_KF)
        pad = np.uint32(_PAD_SEED) * k3
        pad = pad ^ (pad >> np.uint32(15))
        cps = np.asarray(codepoints, np.uint32)
        pos = np.asarray(slot_positions, np.uint32)
        x = (cps * k1) ^ (pos * k2)
        x = x * k3
        x = x ^ (x >> np.uint32(15))
        n_pad = np.uint32(max(slot_capacity - len(cps), 0))
        total = np.uint32(x.sum(dtype=np.uint32)) + n_pad * pad
    return int(total & np.uint32(M32))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor as int64 words holding its uint32 bit pattern (a
    negative int32 maps to its two's complement, as a uint32 cast does)."""
    return x.to(torch.int64) & M32


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``(x * k) mod 2**32`` for int64 words ``x`` below 2**32 and a
    constant ``k`` below 2**32, with no partial product reaching 2**48:
    ``x * k = x * k_lo + (x * k_hi) << 16``, and only the low 16 bits of
    ``x * k_hi`` survive the shift mod 2**32."""
    k_hi, k_lo = (k >> 16) & 0xFFFF, k & 0xFFFF
    return (x * k_lo + (((x * k_hi) & 0xFFFF) << 16)) & M32


def _avalanche(x: torch.Tensor) -> torch.Tensor:
    x = _mul32(x, _KF)
    return x ^ (x >> 15)


def _positions(s: int, device) -> torch.Tensor:
    """(1, S) slot positions premultiplied by the position salt."""
    return _mul32(torch.arange(s, dtype=torch.int64, device=device)[None, :], _KP)


def _masked_sum(on: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(D,) uint32 sum over the last axis of ``x`` where ``on``."""
    return torch.where(on, x, 0).sum(dim=-1) & M32


@captured
def per_doc_text_digest(chars: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """(D,) uint32 (as int64) per-doc digest of visible text (char,
    position, pad)."""
    x = _mul32(_u32(chars), _KC1) ^ _positions(chars.shape[1], chars.device)
    x = torch.where(visible, x, _PAD_SEED)
    return _avalanche(x).sum(dim=1) & M32


def convergence_digest(
    chars: torch.Tensor, visible: torch.Tensor, doc_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Order-sensitive scalar digest of all documents' visible text (a 0-d
    int64 tensor holding the uint32 value).

    ``doc_mask`` (bool (D,)) zeroes excluded docs' contributions ENTIRELY —
    an excluded doc must not add even the pad-slot constant, so its host-side
    stand-in (:func:`doc_digest_host`) can be summed in instead.
    """
    per_doc = per_doc_text_digest(chars, visible)
    if doc_mask is not None:
        per_doc = torch.where(doc_mask, per_doc, 0)
    return per_doc.sum() & M32


@captured(static=("comment_type", "link_type"))
def per_doc_format_digest(
    visible: torch.Tensor,
    lww_active: torch.Tensor,
    link_attr: torch.Tensor,
    comment_bits: torch.Tensor,
    attr_hash: torch.Tensor,
    comment_hash: torch.Tensor,
    comment_type: int,
    link_type: int,
) -> torch.Tensor:
    """(D,) uint32 digest of per-character FORMATTING state, gated by
    visibility (two docs with equal text but divergent marks must digest
    apart).

    Contributions are position-mixed sums, so they are independent of mark
    TABLE row order and — because interned ids enter only through the
    gathered content-hash tables ``attr_hash`` (D, A) / ``comment_hash``
    (D, C), uint32 words as int64 — independent of each session's intern
    order.  Comment sets fold as unordered sums over active ids.
    ``comment_bits`` is (D, W, S) int64 holding uint32 words."""
    d, s = visible.shape
    pos = _positions(s, visible.device)
    acc = torch.zeros((d,), dtype=torch.int64, device=visible.device)

    # LWW active bits per type (strong/em/link; comments handled as sets)
    for t in range(lww_active.shape[1]):
        if t == comment_type:
            continue
        x = _avalanche(((t + 1) * _KT & M32) ^ pos)
        acc = acc + _masked_sum(visible & lww_active[:, t, :], x.expand(d, s))

    # link winner url (content hash gathered through the session table;
    # ids beyond the table clip to its last column)
    a_cap = attr_hash.shape[1]
    index = link_attr.to(torch.int64).clamp(0, a_cap - 1)
    lh = torch.gather(attr_hash, 1, index)
    x = _avalanche(_mul32(lh, _KL) ^ pos)
    link_on = visible & lww_active[:, link_type, :] & (link_attr > 0)
    acc = acc + _masked_sum(link_on, x)

    # comment id sets: unordered sum over active dense ids of the id's
    # content hash mixed with position; each term is a (D, S) masked sum
    for word in range(comment_bits.shape[1]):
        bits = comment_bits[:, word, :]
        for k in range(32):
            c = word * 32 + k
            if c >= comment_hash.shape[1]:
                break
            x = _avalanche(_mul32(comment_hash[:, c][:, None], _KCM) ^ pos)
            acc = acc + _masked_sum(visible & (((bits >> k) & 1) == 1), x)
    return acc & M32


@captured
def per_doc_register_digest(
    r_obj: torch.Tensor,
    r_key: torch.Tensor,
    r_op: torch.Tensor,
    r_kind: torch.Tensor,
    r_val: torch.Tensor,
    key_hash: torch.Tensor,
    vk_deleted: int,
    vk_str: int,
) -> torch.Tensor:
    """(D,) uint32 digest of the map-register table (LWW winner per
    (object, key) across root and nested maps).

    A row contributes iff it holds a live winner (r_op != 0 and not a
    deletion).  The sum is row-order independent and intern-order
    independent: keys and string values enter through the gathered
    content-hash table ``key_hash`` (D, K), uint32 words as int64; object
    ids and child-object values are packed (ctr, actor) ids."""
    k_cap = key_hash.shape[1]
    kh = torch.gather(key_hash, 1, r_key.to(torch.int64).clamp(0, k_cap - 1))
    vh_str = torch.gather(key_hash, 1, r_val.to(torch.int64).clamp(0, k_cap - 1))
    vh = torch.where(r_kind == vk_str, vh_str, _u32(r_val))
    x = (
        _mul32(_u32(r_obj), _KC1)
        ^ _mul32(kh, _KK)
        ^ _mul32(_u32(r_kind), _KKIND)
        ^ _mul32(vh, _KV)
    )
    live = (r_op != 0) & (r_kind != vk_deleted)
    return _masked_sum(live, _avalanche(x))
