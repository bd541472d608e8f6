"""Packed device-side document state.

The scalar oracle's per-element metadata list (core/doc.py ListItemMeta;
reference ``ListItemMetadata`` src/micromerge.ts:341-357) becomes a
struct-of-arrays over a padded ``(D docs x S slots)`` tensor, and the
reference's per-gap mark-op *sets* become a grow-only ``(D x M)`` mark-op
table.  The convergent semantics is a pure function of (element order, mark
table), so the device path stores only the table and resolves spans at read
time (see ops/resolve.py).

Element and op identifiers are single int32s: ``(counter << ACTOR_BITS) |
actor_index`` with actor indices assigned in sorted-actor-string order
(ops/encode.py), so plain integer comparison IS the reference's op-ID order
(counter first, then lexicographic actor; src/micromerge.ts:1389-1403).

Field order and dtypes equal the reference package's ``PackedDocs``, so
state crosses between the two as numpy arrays (:func:`packed_from_numpy`,
:func:`to_numpy`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

# Identifier packing: id = (ctr << ACTOR_BITS) | actor_index.
# actor 0 is reserved; packed id 0 means HEAD / empty slot.
ACTOR_BITS = 10
MAX_ACTORS = (1 << ACTOR_BITS) - 1  # 1023 actors per document
MAX_CTR = (1 << (31 - ACTOR_BITS)) - 1  # ~2M ops per document


def pack_id(ctr: int, actor_index: int) -> int:
    return (ctr << ACTOR_BITS) | actor_index


def unpack_id(packed: int):
    return packed >> ACTOR_BITS, packed & MAX_ACTORS


# Boundary-kind encoding (core/types.py Boundary kinds)
BK_BEFORE = 0
BK_AFTER = 1
BK_START_OF_TEXT = 2
BK_END_OF_TEXT = 3

# Mark action encoding
MA_ADD = 1
MA_REMOVE = 2

# Map-register value kinds (device LWW registers for map objects; the scalar
# semantics is core/doc.py:_apply_op's map branch, reference
# src/micromerge.ts:1151-1175).  A register row (r_op != 0) is the current
# LWW winner for one (object, key) pair.
VK_DELETED = 0  # winning op was a del: key absent
VK_STR = 1  # r_val = interned string id
VK_INT = 2  # r_val = the value (int32 range)
VK_TRUE = 3
VK_FALSE = 4
VK_NULL = 5
VK_OBJ = 6  # r_val = packed id of a child map (its makeMap's op id)
VK_TEXT = 7  # r_val = packed id of the document's text list

#: ROOT object encoding in packed object columns (0 means HEAD/empty)
OBJ_ROOT = -1

#: canonical column order of a map-register stream row (host encode ->
#: device kernel share this single definition)
MAP_STREAM_COLS = ("p_obj", "p_key", "p_op", "p_kind", "p_val")


class PackedDocs(NamedTuple):
    """Batched document state; leading axis D is the doc axis.

    Slots [0, num_slots[d]) of doc d hold its elements in document order,
    tombstones included.  Every plane is int32 except ``overflow`` (bool).
    """

    # element axis (D, S)
    elem_id: torch.Tensor  # packed (ctr << ACTOR_BITS | actor)
    char: torch.Tensor  # codepoint
    # tombstone table (D, T): packed ids of deleted elements (append-only)
    tomb_id: torch.Tensor
    # mark-op table (D, M)
    m_action: torch.Tensor  # MA_ADD / MA_REMOVE (0 = empty row)
    m_type: torch.Tensor  # schema.MARK_INDEX
    m_start_kind: torch.Tensor  # BK_*
    m_start_elem: torch.Tensor  # packed
    m_end_kind: torch.Tensor
    m_end_elem: torch.Tensor  # packed
    m_op: torch.Tensor  # packed op id
    m_attr: torch.Tensor  # interned attr (url/comment id); 0 = none
    # map register table (D, R): LWW winner per (map object, key)
    r_obj: torch.Tensor  # container object (OBJ_ROOT = root; row empty iff r_op == 0)
    r_key: torch.Tensor  # interned key
    r_op: torch.Tensor  # packed winning op id (0 = empty row)
    r_kind: torch.Tensor  # VK_*
    r_val: torch.Tensor  # payload per VK_*
    # scalars per doc (D,)
    num_slots: torch.Tensor
    num_tombs: torch.Tensor
    num_marks: torch.Tensor
    num_regs: torch.Tensor
    overflow: torch.Tensor  # bool: capacity exceeded or invalid reference

    @property
    def num_docs(self) -> int:
        return self.elem_id.shape[0]

    @property
    def slot_capacity(self) -> int:
        return self.elem_id.shape[1]

    @property
    def tomb_capacity(self) -> int:
        return self.tomb_id.shape[1]

    @property
    def mark_capacity(self) -> int:
        return self.m_action.shape[1]

    @property
    def map_capacity(self) -> int:
        return self.r_obj.shape[1]


def empty_docs(
    num_docs: int,
    slot_capacity: int,
    mark_capacity: int,
    tomb_capacity: Optional[int] = None,
    map_capacity: int = 32,
    *,
    device: Union[str, torch.device],
) -> PackedDocs:
    """Fresh empty batch on ``device`` (documents are built by applying
    their change logs)."""
    d, s, m = num_docs, slot_capacity, mark_capacity
    t = tomb_capacity if tomb_capacity is not None else s
    r = map_capacity
    zi = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    return PackedDocs(
        elem_id=zi(d, s),
        char=zi(d, s),
        tomb_id=zi(d, t),
        m_action=zi(d, m),
        m_type=zi(d, m),
        m_start_kind=zi(d, m),
        m_start_elem=zi(d, m),
        m_end_kind=zi(d, m),
        m_end_elem=zi(d, m),
        m_op=zi(d, m),
        m_attr=zi(d, m),
        r_obj=zi(d, r),
        r_key=zi(d, r),
        r_op=zi(d, r),
        r_kind=zi(d, r),
        r_val=zi(d, r),
        num_slots=zi(d),
        num_tombs=zi(d),
        num_marks=zi(d),
        num_regs=zi(d),
        overflow=torch.zeros((d,), dtype=torch.bool, device=device),
    )


def packed_from_numpy(
    arrays: Sequence[np.ndarray], device: Union[str, torch.device]
) -> PackedDocs:
    """A ``PackedDocs`` on ``device`` from its fields as numpy arrays, in
    field order (for instance the reference package's state, converted
    with ``np.asarray`` field by field)."""
    if len(arrays) != len(PackedDocs._fields):
        raise ValueError(
            f"expected {len(PackedDocs._fields)} arrays, got {len(arrays)}"
        )
    out = []
    for name, a in zip(PackedDocs._fields, arrays):
        dtype = torch.bool if name == "overflow" else torch.int32
        out.append(torch.from_numpy(np.array(a)).to(device=device, dtype=dtype))
    return PackedDocs(*out)


def to_numpy(state: PackedDocs) -> PackedDocs:
    """The same state with every field as a host numpy array."""
    return PackedDocs(*(x.detach().cpu().numpy() for x in state))
