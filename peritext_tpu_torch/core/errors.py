"""Exception types for the CRDT core."""


class PeritextError(Exception):
    """Base class for framework errors."""


class CausalityError(PeritextError):
    """A change arrived before its causal dependencies were satisfied
    (reference raises RangeError, src/micromerge.ts:894-902).  Delivery layers
    catch this and requeue the change (test/merge.ts:4-23)."""


class IndexOutOfBounds(PeritextError, IndexError):
    """A list index was outside the visible sequence
    (reference RangeError, src/micromerge.ts:1380)."""


class MissingObject(PeritextError):
    """An operation referenced an object that does not exist."""


class CapacityExceeded(PeritextError):
    """A packed device buffer (slots / mark table / op stream) overflowed its
    static capacity; callers should rebucket or fall back to the host path."""


class DecodeError(PeritextError, ValueError):
    """A wire frame failed decode or validation (truncated bytes, bit-flips,
    malformed varints, out-of-range indices, bad checksum).  Subclasses
    ValueError so every pre-existing ``except ValueError`` corrupt-frame
    handler keeps working; fault-domain code catches the typed form to
    quarantine the affected doc instead of failing the whole batch."""


class TransportError(PeritextError, ConnectionError):
    """A multihost transport operation failed after its timeout/retry budget
    (connect refused, peer stalled past the socket deadline, connection torn
    mid-message).  Subclasses ConnectionError so existing handlers keep
    working; carries no protocol state — the store is append-only and
    duplicate-tolerant, so the caller's next anti-entropy round repairs by
    re-shipping whatever the peer is still missing."""


class DeviceRoundError(PeritextError):
    """A guarded device round failed or overran its wall-clock deadline.
    The fault-domain supervisor translates this into a rollback to the last
    good checkpoint plus scalar-fallback replay (degraded but correct)."""
