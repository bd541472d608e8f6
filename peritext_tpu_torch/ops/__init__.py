"""Packed state, host encode/decode, and the batched device phases."""

from .encode import EncodedBatch, encode_workloads
from .insert import insert_batch, insert_batch_reference
from .kernel import apply_batch, apply_batch_paged, encoded_arrays_of
from .packed import ACTOR_BITS, PackedDocs, empty_docs, pack_id, packed_from_numpy, to_numpy, unpack_id
from .ragged import apply_batch_ragged
from .resolve import ResolvedDocs, resolve, resolve_cursors

__all__ = [
    "ACTOR_BITS",
    "EncodedBatch",
    "PackedDocs",
    "ResolvedDocs",
    "apply_batch",
    "apply_batch_paged",
    "apply_batch_ragged",
    "empty_docs",
    "encode_workloads",
    "encoded_arrays_of",
    "insert_batch",
    "insert_batch_reference",
    "pack_id",
    "packed_from_numpy",
    "resolve",
    "resolve_cursors",
    "to_numpy",
    "unpack_id",
]
