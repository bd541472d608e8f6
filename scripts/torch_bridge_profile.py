#!/usr/bin/env python3
"""Where an editor transaction's time goes on one NVIDIA card: the bridge
phase's fuzzed editing session of chip_smoke.py (``BRIDGE``: three
``Editor(backend="tpu")`` editors and a scalar one, the transaction mix and
the session capacities) on a document grown to about 2400 characters first
(150 typed runs of 16 characters from the scalar editor, synced in tens, so
no change is wider than a round).  Then ``--transactions`` transactions of
the mix, three times, each on a fresh set of editors:

1. plain: dispatch and remote-apply latency (p50, p99, mean);
2. under ``torch.profiler``: the card's busy time over the wall, kernel
   launches per transaction, and the ops with the most device and host time;
3. under ``cProfile``: the bridge's and session's host functions by their
   own and cumulative time.

    python3 scripts/torch_bridge_profile.py [--transactions 200]

Prints one JSON line per run and, last, the card's name and power limit.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: host functions whose cumulative time the cProfile run reports
HOST_FUNCTIONS = (
    "dispatch_input_ops", "_receive", "_backend_ingest", "_backend_view_sync", "ingest",
    "drain", "_schedule_batch", "_commit_rounds", "read_patches", "_doc_chars", "_resolution",
    "_resolve_block_digest", "resolve", "_per_doc_full_digest", "doc_chars_device",
    "diff_patches", "patch_to_steps", "change", "apply_change", "synchronize",
)


def _quantiles(ms):
    import numpy as np

    a = np.asarray(ms, np.float64)
    return {"n": int(a.size), "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "mean": float(a.mean())}


def grow(seed: int):
    """Editors as chip_smoke's bridge phase on a grown document."""
    from chip_smoke import BRIDGE
    from peritext_tpu_torch.bridge import commands, create_editor, initialize_docs
    from peritext_tpu_torch.parallel.pubsub import Publisher

    cfg = BRIDGE
    rng = random.Random(seed)
    pub = Publisher()
    actors = tuple(cfg["editors"]) + ("oracle",)
    editors = [create_editor(name, pub, backend="tpu", actors=actors,
                             backend_config=dict(cfg["backend_config"]))
               for name in cfg["editors"]]
    oracle = create_editor("oracle", pub)
    initialize_docs(editors + [oracle], "Grown by typed runs.")
    for k in range(150):
        run = "".join(rng.choice("abcdefgh ") for _ in range(16))
        commands.type_text(oracle, rng.randint(1, len(oracle.view) + 1), run)
        if k % 10 == 9:
            oracle.sync()
    return rng, pub, editors, oracle


def transact(state, transactions: int):
    """``transactions`` timed transactions of the mix on grown editors;
    returns the latencies and the document's length."""
    from chip_smoke import BRIDGE, _fuzz_transaction
    from peritext_tpu_torch.bridge import commands

    cfg = BRIDGE
    rng, pub, editors, oracle = state
    remote_ms = []
    for ed in editors:
        inner = pub._subscribers[ed.actor_id]

        def timed(changes, inner=inner):
            t0 = time.perf_counter()
            inner(changes)
            remote_ms.append((time.perf_counter() - t0) * 1e3)
        pub._subscribers[ed.actor_id] = timed
    dispatch_ms = []
    for i in range(transactions):
        ed = editors[rng.randrange(len(editors))]
        name, args = _fuzz_transaction(rng, cfg, len(ed.view), i)
        t0 = time.perf_counter()
        getattr(commands, name)(ed, *args)
        dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        if i % cfg["sync_every"] == cfg["sync_every"] - 1:
            for e in editors + [oracle]:
                e.sync()
    for e in editors + [oracle]:
        e.sync()
    if any(ed.view != oracle.view or ed.session.docs[0].fallback for ed in editors):
        raise AssertionError("bridge profile: the editors diverged or a doc left the card")
    return dispatch_ms, remote_ms, len(oracle.view)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bridge profile: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--transactions", type=int, default=200)
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    n = args.transactions

    transact(grow(seed=1), 20)  # loads every kernel module the path uses
    dispatch_ms, remote_ms, chars = transact(grow(seed=2), n)
    print(json.dumps({"run": "plain", "transactions": n, "chars": chars,
                      "dispatch_ms": _quantiles(dispatch_ms),
                      "remote_apply_ms": _quantiles(remote_ms)}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    state = grow(seed=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch_ms, remote_ms, _ = transact(state, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernels = sum(e.count for e in events
                  if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA)
    top = lambda key: [{"op": e.key, "calls": e.count, "ms": getattr(e, key) / 1e3}  # noqa: E731
                       for e in sorted(events, key=lambda e: getattr(e, key), reverse=True)[:12]]
    print(json.dumps({"run": "torch.profiler", "wall_s": wall, "device_busy_ms": busy_ms,
                      "device_idle_share": 1.0 - busy_ms / 1e3 / wall,
                      "device_kernels": kernels, "kernels_per_transaction": kernels / n,
                      "deliveries": len(remote_ms),
                      "top_device": top("self_device_time_total"),
                      "top_host": top("self_cpu_time_total")}), flush=True)

    state = grow(seed=2)
    profiler = cProfile.Profile()
    profiler.enable()
    transact(state, n)
    profiler.disable()
    stats = pstats.Stats(profiler, stream=io.StringIO())
    funcs = {}
    for (path, line, name), (_, calls, tottime, cumtime, _) in stats.stats.items():
        if name in HOST_FUNCTIONS and ("peritext_tpu_torch" in path or name == "synchronize"):
            funcs[f"{Path(path).name}:{line} {name}"] = {"calls": calls, "own_s": tottime,
                                                         "cum_s": cumtime}
    own = sorted(stats.stats.items(), key=lambda kv: kv[1][2], reverse=True)[:15]
    print(json.dumps({"run": "cProfile", "functions": funcs,
                      "top_own": [{"fn": f"{Path(p).name}:{line} {name}", "calls": v[1],
                                   "own_s": v[2]} for (p, line, name), v in own]}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
