#!/usr/bin/env python3
"""Host-side attribution of config 5b's build loop on one card: the port's
twin of ``scripts/ingest_profile.py``.

cProfiles the build loop of BASELINE config 5b (``demos/scale_demo.py``'s
session: one fuzz doc of 220 ops asked for, seed 200, as two v2 frames sent
to every doc; slots 512, marks 160, tombstones 192, round widths
192/96/96), one ``ingest_frames`` and one ``drain()`` a frame, so the
dominant host term is measured, not guessed.  The loop's clock ends in a
synchronize.

    python3 scripts/torch_ingest_profile.py [docs] [--device cuda|cpu]

``docs`` defaults to 16,384 (the twin's cut); 100000 is config 5b itself.
The first line names the device (the card's name and power limit, or
``cpu``).  The port adds the insert kernel's launches against the session's
block applies.  Exits non-zero without a card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device, synchronize  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("docs", type=int, nargs="?", default=16384)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_ingest_profile")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.testing.fuzz import generate_workload

    d = args.docs
    w = generate_workload(seed=200, num_docs=1, ops_per_doc=220)[0]
    changes = [ch for log in w.values() for ch in log]
    half = len(changes) // 2
    frames = [encode_frame(changes[:half]), encode_frame(changes[half:])]
    total_ops = sum(len(c.ops) for c in changes) * d

    sess = StreamingMerge(
        num_docs=d, actors=("doc1", "doc2", "doc3"),
        slot_capacity=512, mark_capacity=160, tomb_capacity=192,
        round_insert_capacity=192, round_delete_capacity=96,
        round_mark_capacity=96, device=device,
    )
    launches, applies = insert_batch.launches, GLOBAL_COUNTERS.get("streaming.block_applies")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for frame in frames:
        sess.ingest_frames((doc, frame) for doc in range(d))
        sess.drain()
    synchronize(device)
    prof.disable()
    wall = time.perf_counter() - t0
    print(f"docs={d} build={wall:.2f}s ops/s={total_ops / wall:,.0f}")
    s = io.StringIO()
    ps = pstats.Stats(prof, stream=s).sort_stats("cumulative")
    ps.print_stats(30)
    print(s.getvalue())
    print(f"K1 launches {insert_batch.launches - launches}, block applies "
          f"{int(GLOBAL_COUNTERS.get('streaming.block_applies') - applies)}, rounds "
          f"{sess.rounds}, read blocks {sess._n_blocks()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
