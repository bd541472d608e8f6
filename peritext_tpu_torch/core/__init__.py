"""Scalar CRDT core: the specification layer of the framework."""

from .doc import Doc, ListItemMeta, MapMeta, Micromerge
from .errors import (
    CapacityExceeded,
    CausalityError,
    IndexOutOfBounds,
    MissingObject,
    PeritextError,
)
from .opids import HEAD, ROOT, OpId, compare_opids, format_opid, parse_opid
from .spans import add_characters_to_spans, ops_to_marks, spans_text
from .types import Boundary, Change, Clock, InputOperation, Operation, Patch, span

__all__ = [
    "Doc",
    "Micromerge",
    "ListItemMeta",
    "MapMeta",
    "Boundary",
    "Change",
    "Clock",
    "InputOperation",
    "Operation",
    "Patch",
    "span",
    "HEAD",
    "ROOT",
    "OpId",
    "compare_opids",
    "format_opid",
    "parse_opid",
    "add_characters_to_spans",
    "ops_to_marks",
    "spans_text",
    "PeritextError",
    "CausalityError",
    "IndexOutOfBounds",
    "MissingObject",
    "CapacityExceeded",
]
