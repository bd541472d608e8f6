# Frozen copy of peritext_tpu_torch/core/opids.py at commit a8ed934
# (imports made local to this folder): part of the benchmark's plain reference.
"""Operation identifiers and sentinel objects for the CRDT core.

The reference encodes op IDs as strings ``"counter@actorId"`` and compares them
by counter first, then lexicographically by actor (reference:
``src/micromerge.ts:1389-1403``).  We represent them natively as tuples
``(counter, actor)`` so Python's tuple ordering *is* the CRDT ordering, and only
serialize to the string form at the JSON wire boundary.  On device, actor IDs
are interned to dense int32 indices so an op ID becomes an ``(int32, int32)``
lexicographic pair (see :mod:`peritext_tpu_torch.utils.interning`).
"""

from __future__ import annotations

from typing import Tuple, Union

#: An operation identifier: ``(counter, actor_id)``.  Natural tuple ordering
#: matches the reference's ``compareOpIds``: counter first, then actor string.
OpId = Tuple[int, str]


class _Sentinel:
    """Unique singleton markers (compared by identity, like JS Symbols)."""

    __slots__ = ("_name",)

    def __init__(self, name: str) -> None:
        self._name = name

    def __repr__(self) -> str:
        return self._name

    # Sentinels sometimes end up in sorted containers next to opids; make them
    # hashable but never orderable so misuse fails loudly.
    def __hash__(self) -> int:
        return id(self)

    # identity is the point (``op.obj is ROOT``): unpickle to the module's
    # own instance, not a copy (workloads cross process boundaries)
    def __reduce__(self) -> str:
        return self._name


#: The document root object (reference ``src/micromerge.ts:7``).
ROOT = _Sentinel("ROOT")
#: The virtual list head an insert at index 0 references (``:8``).
HEAD = _Sentinel("HEAD")

#: An object ID is the op ID of the op that created the object, or ROOT.
ObjectId = Union[OpId, _Sentinel]
#: A list-element reference: the op ID of the insert that created it, or HEAD.
ElemRef = Union[OpId, _Sentinel]

# Wire encodings used by the reference's JSON (`traces/*.json`): HEAD is a JS
# Symbol, dropped entirely by JSON.stringify, so "missing elemId" means HEAD.
_HEAD_WIRE = "_head"
_ROOT_WIRE = "_root"


def compare_opids(a: OpId, b: OpId) -> int:
    """Three-way compare, semantics of reference ``compareOpIds`` (:1389)."""
    if a == b:
        return 0
    return -1 if a < b else 1


def format_opid(opid: OpId) -> str:
    """``(3, "alice")`` -> ``"3@alice"`` (reference wire format)."""
    return f"{opid[0]}@{opid[1]}"


def parse_opid(s: str) -> OpId:
    """``"3@alice"`` -> ``(3, "alice")``.  Actor may itself contain ``@``."""
    counter, _, actor = s.partition("@")
    return (int(counter), actor)


def format_elem_ref(ref: ElemRef) -> str:
    if ref is HEAD:
        return _HEAD_WIRE
    return format_opid(ref)  # type: ignore[arg-type]


def parse_elem_ref(s: Union[str, None]) -> ElemRef:
    if s is None or s == _HEAD_WIRE:
        return HEAD
    return parse_opid(s)


def format_object_id(obj: ObjectId) -> str:
    if obj is ROOT:
        return _ROOT_WIRE
    return format_opid(obj)  # type: ignore[arg-type]


def parse_object_id(s: Union[str, None]) -> ObjectId:
    if s is None or s == _ROOT_WIRE:
        return ROOT
    return parse_opid(s)
