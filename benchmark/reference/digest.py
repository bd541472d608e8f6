"""A document's convergence digest term, worked out from the reference's own
replica: the visible characters and their places in the full element order
(tombstones included), the resolved formatting of each character, and the
map registers.  The session digest is the sum of the docs' terms mod 2**32.

Frozen copy, at commit a8ed934, of the host formulas the program holds
bit-identical to its device hashes: ``doc_digest_host``,
``format_digest_host``, ``register_digest_host`` (``parallel/mesh.py``),
``_doc_char_slots``, ``_doc_path_of_object`` and ``_doc_full_extras_host``
(``parallel/streaming.py``), ``content_hash32`` (``utils/interning.py``),
``pack_id`` and the value kinds (``ops/packed.py``).
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence

import numpy as np

from .doc import Doc, MapMeta
from .opids import ROOT
from .schema import ALL_MARKS, MARK_INDEX

M32 = 0xFFFFFFFF
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

ACTOR_BITS = 10
MAX_CTR = (1 << (31 - ACTOR_BITS)) - 1
OBJ_ROOT = -1
VK_STR, VK_INT, VK_TRUE, VK_FALSE, VK_NULL, VK_OBJ, VK_TEXT = 1, 2, 3, 4, 5, 6, 7
COMMENT_TYPE = MARK_INDEX["comment"]


def content_hash32(s: str) -> int:
    """FNV-1a 32-bit over UTF-8 bytes."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def actor_index(actors: Sequence[str]) -> Dict[str, int]:
    """The sorted actor table, numbered from 1 (0 means none)."""
    return {a: i + 1 for i, a in enumerate(sorted(set(actors)))}


def _av(x: int) -> int:
    x = (x * _KF) & M32
    return x ^ (x >> 15)


def _format_digest(slot_positions, marks_per_char) -> int:
    acc = 0
    for s, marks in zip(slot_positions, marks_per_char):
        for t, name in enumerate(ALL_MARKS):
            if t == COMMENT_TYPE:
                continue
            m = marks.get(name)
            if m and m.get("active"):
                acc = (acc + _av((((t + 1) * _KT) & M32) ^ ((s * _KP) & M32))) & M32
        link = marks.get("link")
        if link and link.get("active") and link.get("url") is not None:
            lh = content_hash32(link["url"])
            acc = (acc + _av(((lh * _KL) & M32) ^ ((s * _KP) & M32))) & M32
        for c in marks.get("comment", []):
            ch = content_hash32(c["id"])
            acc = (acc + _av(((ch * _KCM) & M32) ^ ((s * _KP) & M32))) & M32
    return acc


def _register_digest(rows) -> int:
    acc = 0
    for obj_u32, key_h, kind, val_u32 in rows:
        x = (((obj_u32 * _KC1) & M32) ^ ((key_h * _KK) & M32)
             ^ ((kind * _KKIND) & M32) ^ ((val_u32 * _KV) & M32))
        acc = (acc + _av(x)) & M32
    return acc


def _text_digest(codepoints, slot_positions, slot_capacity: int) -> int:
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


def _text_list_id(doc: Doc):
    list_ids = [oid for oid, meta in doc._metadata.items()
                if isinstance(meta, list) and oid in doc._objects]
    return min(list_ids) if list_ids else None


def _char_slots(doc: Doc):
    list_id = _text_list_id(doc)
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


def _path_of_object(doc: Doc, target) -> Optional[list]:
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


def _extras(doc: Doc, slot_positions, actors: Dict[str, int]) -> int:
    marks_per_char: list = []
    list_id = _text_list_id(doc)
    if list_id is not None and slot_positions:
        path = _path_of_object(doc, list_id)
        if path is not None:
            for span in doc.get_text_with_formatting(path):
                marks_per_char.extend([span["marks"]] * len(span["text"]))
    if len(marks_per_char) != len(slot_positions):
        marks_per_char = [{}] * len(slot_positions)
    total = _format_digest(slot_positions, marks_per_char)

    def packed_u32(opid) -> int:
        ctr, actor = opid
        idx = actors.get(actor)
        if idx is None or ctr > MAX_CTR:
            return content_hash32(f"{ctr}@{actor}")
        return ((ctr << ACTOR_BITS) | idx) & M32

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
                kind = 255
                val = content_hash32(json.dumps(value, sort_keys=True))
            rows.append((obj_u32, content_hash32(key), kind, val))
    return (total + _register_digest(rows)) & M32


def doc_digest(doc: Doc, slot_capacity: int, actors: Dict[str, int]) -> int:
    """One document's full-state digest term."""
    cps, slots = _char_slots(doc)
    return (_text_digest(cps, slots, slot_capacity) + _extras(doc, slots, actors)) & M32
