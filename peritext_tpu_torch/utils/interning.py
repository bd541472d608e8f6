"""String interning for the device boundary.

Actor IDs and mark attributes (urls, comment ids) are strings at the API
boundary but int32 on device.  Actor indices must preserve the reference's
*string* ordering (op IDs tie-break on lexicographic actor comparison,
reference src/micromerge.ts:1389-1403), so actor tables are built from the
full sorted actor set of a workload.  Attribute interning needs no ordering,
only per-id identity — except link URLs, whose winner is picked by op ID, not
URL order.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np


def content_hash32(s: str) -> int:
    """FNV-1a 32-bit over UTF-8 bytes — the cross-session identity of an
    interned string.  Interned IDS are session-local (they depend on arrival
    order); digests and other cross-session comparisons gather these content
    hashes through per-session id->hash tables instead, so two sessions that
    interned the same strings in different orders still agree."""
    h = 2166136261
    for b in s.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


class Interner:
    """Bidirectional string <-> int32 table; index 0 is reserved for 'none'."""

    def __init__(self, strings: Iterable[str] = ()) -> None:
        self._to_int: Dict[str, int] = {}
        self._to_str: List[Optional[str]] = [None]
        self._hashes: Optional[np.ndarray] = None
        for s in strings:
            self.intern(s)

    def content_hashes(self) -> np.ndarray:
        """uint32 array mapping every interned id to its content hash (id 0,
        the reserved none slot, maps to 0).  Cached; rebuilt only after the
        table has grown."""
        n = len(self._to_str)
        if self._hashes is None or len(self._hashes) != n:
            self._hashes = np.asarray(
                [0 if s is None else content_hash32(s) for s in self._to_str],
                np.uint32,
            )
        return self._hashes

    def intern(self, s: str) -> int:
        idx = self._to_int.get(s)
        if idx is None:
            idx = len(self._to_str)
            self._to_int[s] = idx
            self._to_str.append(s)
        return idx

    def lookup(self, idx: int) -> Optional[str]:
        return self._to_str[idx]

    def get(self, s: str) -> Optional[int]:
        return self._to_int.get(s)

    def __len__(self) -> int:
        return len(self._to_str)

    def __contains__(self, s: str) -> bool:
        return s in self._to_int


class OrderedActorTable(Interner):
    """Actor interner whose int ordering equals string ordering.

    Built from the complete actor set up front (sorted), so
    ``idx(a) < idx(b) iff a < b`` — the property the device's int32
    lexicographic op-ID comparison relies on.  ``intern`` of an unseen actor
    raises: growing the table could violate the order invariant; rebuild with
    the enlarged actor set instead (cheap, host-side).
    """

    def __init__(self, actors: Iterable[str]) -> None:
        super().__init__()
        for actor in sorted(set(actors)):
            Interner.intern(self, actor)

    def intern(self, s: str) -> int:
        idx = self.get(s)
        if idx is None:
            raise KeyError(
                f"Actor {s!r} not in the ordered actor table; rebuild the table "
                "with the full actor set (ordering must match string order)"
            )
        return idx
