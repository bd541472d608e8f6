"""Convergence digests of the document axis: the device functions and their
host mirrors.

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

The device mesh (``Mesh``, sharding) is not ported yet (ROADMAP.md queue 1
item 11); only the digests live here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.interning import content_hash32

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
