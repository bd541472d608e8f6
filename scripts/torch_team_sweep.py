#!/usr/bin/env python3
"""Time the two teams of the port's insert kernels against each other on
one NVIDIA card, to choose ``WARP_TEAM_MAX_SLOTS`` (peritext_tpu_torch/ops/insert.py).

    python3 scripts/torch_team_sweep.py

1. The padded insert kernel at windows of 512 to 8192 slots, each doc filling
   its window from empty (``synth_streams``), with every window on the warp
   team, then on the block team at 256, 512 and 1024 threads (fewer for a
   window of fewer slots), to choose ``BLOCK_TEAM_SLOTS_PER_THREAD`` and
   ``BLOCK_TEAM_MAX_THREADS`` too; every result must equal the warp team's
   bit for bit.
2. The ragged insert kernel on ``mixed_10k`` (chip_smoke.py: 9216 docs of
   179 inserts, 896 of 1024 and 128 of 4096, pages of 64) with the
   threshold at each value of THRESHOLDS; every result must equal the
   first.

Prints one JSON line per timing (device time by CUDA events with the host
kept ahead, testing.devtime.device_time_ms: mean over a few launches after a
warm-up) and, last, the card's name and power limit and a summary
object.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: (docs, window slots = inserts) of the padded shapes; docs shrink as windows
#: grow, as in a mixed drain
PADDED = ((1024, 512), (896, 1024), (512, 2048), (128, 4096), (64, 8192))
THRESHOLDS = (512, 1024, 2048, 4096, 8192)  # the mixed drain's windows: 192, 1024, 4096


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("team sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import MIXED_10K, mixed_streams, ragged_args, synth_args
    from peritext_tpu_torch.testing.devtime import device_time_ms
    from peritext_tpu_torch.ops import insert as insert_mod
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    device = torch.device("cuda")
    default = insert_mod.WARP_TEAM_MAX_SLOTS
    threads_of = insert_mod.block_team_threads
    rows = []

    for docs, window in PADDED:
        args = synth_args(device, docs=docs, slots=window, inserts=window, seed=1)
        first = None
        for team, limit, cap in (("warp", 1 << 30, None), ("block", 0, 256), ("block", 0, 512),
                                 ("block", 0, 1024)):
            insert_mod.WARP_TEAM_MAX_SLOTS = limit
            # a block of `cap` threads, or fewer for a window of fewer slots
            insert_mod.block_team_threads = lambda s, cap=cap: min(cap, -(-s // 32) * 32)
            got = insert_batch(*args)
            if first is None:
                first = got
            elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                raise AssertionError(f"{team} team ({cap}) differs at {docs} x {window}")
            ms = device_time_ms(lambda: insert_batch(*args), reps=3, warmup=1)
            threads = 32 if team == "warp" else insert_mod.block_team_threads(window)
            row = dict(kernel="rga_insert", docs=docs, window=window, team=team,
                       threads_per_doc=threads, ms=ms)
            print(json.dumps(row), flush=True)
            rows.append(row)
        insert_mod.block_team_threads = threads_of
        del args, first, got

    args = ragged_args(device, MIXED_10K["slots"], mixed_streams())
    pages = args[5].cpu().numpy()
    first = None
    for limit in THRESHOLDS:
        insert_mod.WARP_TEAM_MAX_SLOTS = limit
        mine = [a.clone() if i < 2 else a for i, a in enumerate(args)]
        got = (mine[0], mine[1], *ragged_insert(*mine, page_count_host=pages))
        if first is None:
            first = got
        elif not all(torch.equal(a, b) for a, b in zip(got, first)):
            raise AssertionError(f"mixed_10k differs at threshold {limit}")
        ms = device_time_ms(lambda: ragged_insert(*mine, page_count_host=pages), reps=3, warmup=1)
        row = dict(kernel="ragged_insert", shape="mixed_10k", threshold=limit, ms=ms)
        print(json.dumps(row), flush=True)
        rows.append(row)
    insert_mod.WARP_TEAM_MAX_SLOTS = default

    print(f"card: {card}")
    print(json.dumps({"team_sweep": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
