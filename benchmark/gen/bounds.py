"""The least time the card could take for some work: the larger of its
bytes over the HBM bandwidth and its operations over the int32 issue rate.

Frozen copy of ``bound`` and the peaks in ``chip_smoke.py`` at commit
a8ed934 (NVIDIA's H100 SXM data sheet for HBM3; the Hopper white paper for
int32: 132 SMs x 64 int32 lanes x 1.98 GHz boost).  A card whose power
limit is below 700 W runs below these peaks; the result line gives the
card's name and limit beside each share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

#: bytes one insert needs at the least: its reference, op id and character
#: read once (three int32) and its element id and character written once
INSERT_BYTES = 5 * 4
#: bytes a digested element needs at the least: its id and character (int32)
#: and its deleted flag (one byte), read once
ELEMENT_BYTES = 4 + 4 + 1
#: bytes a mark operation needs at the least: its two anchors, its op id
#: and its attribute (int32 each) and its type (one byte), read once
MARK_BYTES = 4 * 4 + 1
#: bytes a digested row writes: its uint32 hash
ROW_DIGEST_BYTES = 4


def bound_s(nbytes: float, nops: float) -> float:
    """Seconds: the larger of bytes over bandwidth and ops over the int32
    rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S)
