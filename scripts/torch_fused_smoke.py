#!/usr/bin/env python3
"""fused-pipeline smoke: the fused round pipeline's contract, the port's
twin of ``scripts/fused_smoke.py``.

Asserts, on ``--device`` (the card by default), four promises:

* **byte equality** — the fused pipeline (multi-round forms, pipelined
  drain, staging lane, digest prefetch) is indistinguishable from the
  per-round dispatch discipline on the same workload: spans, incremental
  patches and full-state digests bit-equal, padded AND paged layouts,
  several fuzz seeds;
* **staging overlaps** — the staging lane actually staged the drain's
  batches off the scheduling thread (lane counters), and on a card the
  serialized (sync-per-drain) twin is no FASTER than the pipelined drain
  beyond noise (the twin's 2x guard; on the CPU both walls are reported,
  not held: a CPU session pays its digest prefetch on the calling thread,
  and contention for the host's cores moves the walls by more than 2x);
* **steady state** — a fresh session replaying the same workload shapes
  builds and loads no kernel library (``obs.RecompileSentinel``), and its
  graph cache captures no signature twice (a graph lives with its
  session: on the card a fresh session captures what it repeats once,
  then replays);
* **observable** — devprof sees the fused dispatch sites
  (``apply_batch_staged_rounds``) and the fused-origin occupancy rows.

Artifacts (``fused-report.json``, a devprof snapshot) are written to
``--out``.

    python3 scripts/torch_fused_smoke.py --out /tmp/pt-fused [--seeds 5 19] [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402


def _session(device, layout, fused, static_rounds=False, num_docs=8):
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    s = StreamingMerge(
        num_docs=num_docs, actors=("doc1", "doc2", "doc3"),
        slot_capacity=256, mark_capacity=96, tomb_capacity=128,
        round_insert_capacity=24, round_delete_capacity=12,
        round_mark_capacity=12, round_map_capacity=8,
        static_rounds=static_rounds, layout=layout, device=device,
    )
    s.fused_pipeline = fused
    s.prefetch_digest = fused
    return s


def _feed(s, workloads, seed, chunks=3, per_round=False, sync=False):
    """One seeded feed plan shared by every arm (fused, per-round oracle,
    lock-step serialized): the equality assertions depend on all arms
    deriving the SAME frame plan.  ``sync`` blocks after each drain (the
    overlap smoke's serialized arm)."""
    from peritext_tpu_torch.parallel.codec import encode_frame

    rng = random.Random(seed)
    plans = []
    for w in workloads:
        ch = [c for a in sorted(w) for c in w[a]]
        rng.shuffle(ch)
        size = -(-len(ch) // chunks)
        plans.append([ch[i:i + size] for i in range(0, len(ch), size)])
    t0 = time.perf_counter()
    for r in range(chunks):
        s.ingest_frames(
            (d, encode_frame(sorted(p[r], key=lambda c: (c.actor, c.seq))))
            for d, p in enumerate(plans) if r < len(p)
        )
        if per_round:
            while s.step() > 0:
                pass
        else:
            s.drain()
            if sync:
                s.sync_device()
    digest = s.digest()
    return time.perf_counter() - t0, digest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seeds", type=int, nargs="*", default=[5, 19])
    parser.add_argument("--out", default="fused-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_fused_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import GLOBAL_DEVPROF
    from peritext_tpu_torch.observability import RecompileSentinel
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"seeds": args.seeds, "layouts": {}}

    GLOBAL_DEVPROF.reset()
    with GLOBAL_DEVPROF:
        # -- equivalence sweep: fused vs per-round, both layouts ------------
        for layout in ("padded", "paged"):
            rows = []
            for seed in args.seeds:
                wl = generate_workload(seed=seed, num_docs=8, ops_per_doc=48)
                fused = _session(device, layout, True)
                _, dg_f = _feed(fused, wl, seed)
                oracle = _session(device, layout, False)
                _, dg_o = _feed(oracle, wl, seed, per_round=True)
                assert dg_f == dg_o, (
                    f"{layout} seed {seed}: fused digest {dg_f:#x} != per-round {dg_o:#x}")
                assert fused.read_all() == oracle.read_all(), (
                    f"{layout} seed {seed}: span sweep diverged")
                assert fused.read_patches_all() == oracle.read_patches_all(), (
                    f"{layout} seed {seed}: patch sweep diverged")
                assert fused.rounds == oracle.rounds
                rows.append({"seed": seed, "digest": dg_f, "rounds": fused.rounds,
                             "stager": fused._stager.stats() if fused._stager else None})
            report["layouts"][layout] = rows

        # -- staging-overlap smoke ------------------------------------------
        wl = generate_workload(seed=args.seeds[0], num_docs=8, ops_per_doc=48)
        pipelined = _session(device, "padded", True)
        t_pipe, dg_a = _feed(pipelined, wl, args.seeds[0])
        lane = pipelined._stager.stats()
        assert lane["staged"] > 0, "the staging lane must have staged batches"
        assert lane["errors"] == 0, lane
        serial = _session(device, "padded", True)
        serial.prefetch_digest = False
        # same feed plan, but lock-step: sync after every drain
        t_serial, dg_b = _feed(serial, wl, args.seeds[0], sync=True)
        assert dg_a == dg_b
        report["staging_overlap"] = {
            "pipelined_s": round(t_pipe, 4),
            "serialized_s": round(t_serial, 4),
            "lane": lane,
        }
        # overlap must never COST wall beyond run noise (2x guard: a smoke
        # direction check, not a perf gate).  It is held where the work runs
        # on a card beside the host; a CPU session's ops run on the calling
        # thread, so its digest prefetch is paid in wall and the host's core
        # contention moves both walls past 2x: there they are reported only
        if device.type == "cuda":
            assert t_pipe <= 2.0 * t_serial, report["staging_overlap"]

        # -- steady state: no build, no signature captured twice ------------
        wl = generate_workload(seed=77, num_docs=6, ops_per_doc=40)
        cold = _session(device, "padded", True, num_docs=6)
        _, dg_cold = _feed(cold, wl, 77)
        with RecompileSentinel() as sentinel:
            sentinel.mark()
            warm = _session(device, "padded", True, num_docs=6)
            _, dg_warm = _feed(warm, wl, 77)
            sentinel.assert_fresh_sessions_steady("fused pipeline repeat workload",
                                                  len(warm._graphs))
        assert dg_warm == dg_cold
        report["steady_state_compiles"] = 0

    snap = GLOBAL_DEVPROF.snapshot()
    assert any(site.startswith("apply_batch_staged_rounds")
               for site in snap["sites"]), sorted(snap["sites"])
    assert any(o["origin"] == "streaming.fused"
               for o in snap["occupancy"].values()), "fused occupancy origin"
    report["devprof_sites"] = sorted(snap["sites"])

    (out / "fused-report.json").write_text(json.dumps(report, indent=2))
    (out / "devprof-snapshot.json").write_text(json.dumps(snap, indent=2))
    print(json.dumps({"ok": True,
                      "staging_overlap": report["staging_overlap"],
                      "layouts": {k: len(v) for k, v in report["layouts"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
