#!/usr/bin/env python3
"""Generate the v4 preset deflate dictionary (wire option ``preset``), the
port's twin of ``scripts/gen_wire_dict.py``.

A protocol preset dictionary primes each fresh link's deflate window with
representative UNCOMPRESSED session-frame bodies, so a link's first frames
back-reference it the way later frames reference the live window.  The
corpus is deterministic: seeded fuzz workloads (seed 999, 4 docs x 192
ops, disjoint from every bench seed), the FIFO arrival model in 4 rounds
(``testing.arrival.build_arrival(..., arrival_model="fifo")``), one
``WireSession(compress=False)`` per doc, and the last 8192 bytes of the
concatenated bodies.  The dictionary is a protocol constant: the output
must equal ``peritext_tpu_torch/parallel/wire_preset.bin`` (and the
reference package's) byte for byte.  This script writes only to ``--out``
and refuses to overwrite either checked-in copy.  Host work only: no
device.

    python3 scripts/torch_gen_wire_dict.py --out /tmp/wire_preset.bin
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SIZE = 8192
#: the checked-in dictionaries this script never overwrites
PROTECTED = (ROOT / "peritext_tpu" / "parallel" / "wire_preset.bin",
             ROOT / "peritext_tpu_torch" / "parallel" / "wire_preset.bin")


def preset_blob() -> bytes:
    """The dictionary: the tail ``SIZE`` bytes of the corpus's frame bodies."""
    from peritext_tpu_torch.parallel.codec import WireSession
    from peritext_tpu_torch.testing.arrival import build_arrival
    from peritext_tpu_torch.testing.fuzz import generate_workload

    train = generate_workload(seed=999, num_docs=4, ops_per_doc=192)
    arr = build_arrival(train, 4, 999, arrival_model="fifo")
    bodies = []
    for doc_batches in arr:
        s = WireSession(compress=False)
        for b in doc_batches:
            bodies.append(s.encode_frame(sorted(b, key=lambda c: (c.actor, c.seq))))
    return b"".join(bodies)[-SIZE:]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", default="wire_preset.bin", help="file to write")
    args = parser.parse_args(argv)
    out = Path(args.out)
    if out.resolve() in {p.resolve() for p in PROTECTED}:
        print(f"torch_gen_wire_dict: refusing to overwrite the checked-in {out}",
              file=sys.stderr)
        return 2
    blob = preset_blob()
    out.write_bytes(blob)
    print(f"wrote {len(blob)} bytes to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
