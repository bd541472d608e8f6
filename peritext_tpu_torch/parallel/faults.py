"""Delivery fault injection, for the fault-domain tests of the streaming
session (quarantine, ``force_fallback``, ``health()``).

* **reorder**: an arbitrary permutation of a delivery batch (the causal
  layer must hold back and resequence);
* **duplication**: redelivered changes must be idempotent;
* **drop**: lost changes are repaired by a later anti-entropy round
  (vector-clock diffs re-ship anything missing, so drops delay but never
  prevent convergence);
* **payload corruption**: truncated or bit-flipped wire frames must be
  rejected at the codec (:class:`~..core.errors.DecodeError`) and contained
  to the affected doc (per-doc quarantine), never applied as garbage.

Entry points: :func:`perturb_delivery` for harnesses that move changes by
hand, :func:`perturb_frame` for harnesses that move raw wire bytes,
:func:`corrupt_detectably`, the one definition of which corruption a
harness delivers, and :class:`FaultyPublisher`, the editor bridge's
in-process transport with these faults on every delivery.  They make the reference package's rng calls, so one
seed perturbs both alike.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core.errors import DecodeError
from ..core.types import Change
from .pubsub import Publisher


@dataclass(frozen=True)
class FaultSpec:
    """Probabilities for one delivery hop.

    ``drop_p``/``dup_p``/``reorder`` act on whole changes (delivery faults);
    ``truncate_p``/``bitflip_p`` act on the encoded frame bytes (payload
    faults): a corrupting link or store, which exercises the codec's
    :class:`DecodeError` surface rather than the causal layer."""

    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder: bool = True
    #: per-frame probability the frame arrives truncated at a random cut
    truncate_p: float = 0.0
    #: per-frame probability 1..4 random bits arrive flipped
    bitflip_p: float = 0.0

    def any_faults(self) -> bool:
        return (self.drop_p > 0 or self.dup_p > 0 or self.reorder
                or self.any_payload_faults())

    def any_payload_faults(self) -> bool:
        return self.truncate_p > 0 or self.bitflip_p > 0


def perturb_delivery(changes: List[Change], rng: random.Random, spec: FaultSpec) -> List[Change]:
    """Apply drop / duplicate / reorder faults to one delivery batch;
    dropped changes are simply absent (the caller's next anti-entropy round
    re-ships them)."""
    delivered: List[Change] = []
    for change in changes:
        if rng.random() < spec.drop_p:
            continue
        delivered.append(change)
        while rng.random() < spec.dup_p:
            delivered.append(change)
    if spec.reorder:
        rng.shuffle(delivered)
    return delivered


def perturb_frame(data: bytes, rng: random.Random, spec: FaultSpec) -> bytes:
    """Apply payload faults (truncation, bit flips) to one encoded wire
    frame; returns the (possibly corrupted) bytes, which may or may not
    decode.  With no payload faults configured, or an empty frame, the
    bytes pass through untouched (the same object)."""
    if not data or not spec.any_payload_faults():
        return data
    out = data
    if rng.random() < spec.truncate_p:
        out = out[: rng.randrange(len(out))]
    if out and rng.random() < spec.bitflip_p:
        buf = bytearray(out)
        for _ in range(rng.randint(1, 4)):
            pos = rng.randrange(len(buf))
            buf[pos] ^= 1 << rng.randrange(8)
        out = bytes(buf)
    return out


def corrupt_detectably(frame: bytes, rng: random.Random, spec: FaultSpec) -> Optional[bytes]:
    """Apply payload faults to one encoded frame and return the corrupted
    bytes only when the codec detects the damage (:class:`DecodeError`);
    None when no corruption fired or when the mutated frame still decodes.
    Undetectable corruption counts as clean delivery: link-level integrity
    (TCP/TLS) is assumed to catch what frame validation cannot, and
    delivering decoded garbage would make replicas diverge by design."""
    from .codec import decode_frame

    bad = perturb_frame(frame, rng, spec)
    if bad is frame:
        return None
    try:
        decode_frame(bad)
    except DecodeError:
        return bad
    return None


class FaultyPublisher(Publisher):
    """A ``Publisher`` whose deliveries suffer per-subscriber faults.

    Dropped updates are recorded per subscriber; :meth:`redeliver_lost`
    models the transport-level retransmission that a real deployment gets
    from anti-entropy, letting tests assert convergence-after-repair.

    With payload faults configured (``truncate_p``/``bitflip_p``) every
    delivery round-trips through the real wire codec — encode, corrupt the
    bytes, decode — so the :class:`DecodeError` surface is exercised, not
    just delivery ordering.  A batch whose corrupted frame fails decode is
    counted as lost in full (the transport analog: a corrupt frame
    contributes nothing, anti-entropy re-ships it later).
    """

    def __init__(self, spec: FaultSpec, seed: int = 0, monitor=None) -> None:
        super().__init__(monitor=monitor)
        self.spec = spec
        self.rng = random.Random(seed)
        self.lost: Dict[str, List[List[Change]]] = {}
        self.delivered_count = 0
        self.dropped_count = 0
        #: deliveries whose frame failed decode after payload corruption
        self.corrupt_count = 0

    def _through_codec(self, batch: List[Change]) -> Optional[List[Change]]:
        """Encode → corrupt → decode one delivery batch; None = frame lost
        to DETECTABLE corruption (the whole batch, like a dropped TCP
        message); undetectable corruption models as clean delivery (the
        :func:`corrupt_detectably` policy)."""
        from .codec import decode_frame, encode_frame

        if not batch:
            return batch
        frame = encode_frame(batch)
        if corrupt_detectably(frame, self.rng, self.spec) is not None:
            return None
        return decode_frame(frame)

    def publish(self, sender: str, update: List[Change]) -> None:
        # sorted, not subscription order: fault draws consume the rng in
        # subscriber-key order, so a run is reproducible from (seed, spec)
        # alone regardless of subscription timing (PTL001)
        for key, callback in sorted(self._subscribers.items()):
            if key == sender:
                continue
            perturbed = perturb_delivery(list(update), self.rng, self.spec)
            if self.spec.any_payload_faults():
                decoded = self._through_codec(perturbed)
                if decoded is None:
                    self.corrupt_count += 1
                    perturbed = []
                else:
                    perturbed = decoded
            dropped = [
                c for c in update
                if not any(d.actor == c.actor and d.seq == c.seq for d in perturbed)
            ]
            if dropped:
                self.lost.setdefault(key, []).append(dropped)
                self.dropped_count += len(dropped)
                if self.monitor is not None:
                    # the lossy hop surfaces like a failed exchange: the
                    # subscriber's failure count grows until redelivery
                    self.monitor.observe_failure(
                        key, error=f"dropped {len(dropped)} change(s)"
                    )
            self.delivered_count += len(perturbed)
            if perturbed:
                callback(perturbed)
                if self.monitor is not None and not dropped:
                    self.monitor.observe_success(key, pulled=len(perturbed))

    def redeliver_lost(self) -> int:
        """Re-deliver every recorded drop (faithfully, no new faults);
        returns how many changes were retransmitted."""
        count = 0
        for key, batches in sorted(self.lost.items()):  # deterministic repair order
            callback = self._subscribers.get(key)
            if callback is None:
                continue
            redelivered = 0
            for batch in batches:
                callback(list(batch))
                redelivered += len(batch)
            count += redelivered
            if batches and self.monitor is not None:
                # repair delivered: the subscriber's failure streak clears
                self.monitor.observe_success(key, pulled=redelivered)
            self.lost[key] = []
        return count
