#!/usr/bin/env python3
"""latency smoke: the time-to-visibility plane end to end, the port's twin
of ``scripts/latency_smoke.py``.

Drives a real serve session on ``--device`` (the card by default)
open-loop with the latency plane armed, asserts the plane sampled
sum-consistent stage records and marked visibility, writes the artifacts
(``latency.json``, ``latency.prom``, ``why-ledger.jsonl``, ``why.json``)
to ``--out``, checks the ``obs why`` exit contract (0 clean / 1 regressed
/ 2 unreadable), and pins the arming overhead on a card: the armed arm's
best-of-N wall must stay within the budget of the disabled arm's (2% plus
a 10 ms floor).  On the CPU both walls are printed and not held: contention
for the host's cores moves them by more than the budget.

    python3 scripts/torch_latency_smoke.py --out /tmp/pt-latency [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402

#: arming overhead budget: relative bound plus a small absolute floor so
#: a sub-millisecond smoke row can't fail on scheduler noise alone
OVERHEAD_FRAC = 0.02
OVERHEAD_FLOOR_S = 0.010


def fail(msg: str) -> int:
    print(f"latency-smoke FAIL: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--docs", type=int, default=4)
    parser.add_argument("--ops-per-doc", type=int, default=40)
    parser.add_argument("--seed", type=int, default=23)
    parser.add_argument("--repeats", type=int, default=5,
                        help="best-of-N walls for the overhead pin")
    parser.add_argument("--out", default="latency-artifacts")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_latency_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import prometheus_text
    from peritext_tpu_torch.obs.__main__ import main as obs_main
    from peritext_tpu_torch.obs.latency import STAGES, LatencyPlane, attribute, check_sum_consistency
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.serve import SessionMux
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    d, opd = args.docs, args.ops_per_doc

    plans = []
    for w in generate_workload(args.seed, num_docs=d, ops_per_doc=opd):
        changes = [ch for log in w.values() for ch in log]
        plans.append([encode_frame(changes[i:i + 6]) for i in range(0, len(changes), 6)])

    def build_mux(blocks=1):
        """A mux over a session of ``blocks`` copies of the ``d`` docs: a
        drive of block ``b`` submits the frames to docs ``b*d .. b*d+d-1``."""
        session = StreamingMerge(
            num_docs=d * blocks, actors=("doc1", "doc2", "doc3"),
            slot_capacity=max(256, 4 * opd), mark_capacity=max(64, opd),
            tomb_capacity=max(128, opd),
            round_insert_capacity=128, round_delete_capacity=64,
            round_mark_capacity=64, static_rounds=True, device=device,
        )
        mux = SessionMux(session, host="latency-smoke")
        sids = []
        for doc in range(d * blocks):
            sid, verdict = mux.open_session(f"client{doc}")
            assert verdict.admitted
            sids.append(sid)
        return mux, sids

    def drive(mux, sids, read=True, block=0):
        sids = sids[block * d:(block + 1) * d]
        t0 = time.perf_counter()
        for k in range(max(len(p) for p in plans)):
            for doc, plan in enumerate(plans):
                if k < len(plan):
                    mux.submit(sids[doc], plan[k])
            mux.flush()
            if read:
                mux.patches(sids[0])
        return time.perf_counter() - t0

    # -- the traced serve session -------------------------------------------
    mux, sids = build_mux()
    plane = LatencyPlane().enable()
    mux.latency_plane = plane
    drive(mux, sids)

    snap = plane.snapshot()
    (out / "latency.json").write_text(json.dumps(snap, indent=2))
    prom = prometheus_text(latency=plane)
    (out / "latency.prom").write_text(prom)

    if snap["records"] == 0:
        return fail("armed plane sampled no drain batches")
    if snap["pending_visibility"] != 0:
        return fail(f"{snap['pending_visibility']} records never marked "
                    "visible despite per-window reads")
    if snap["last"] is None or not check_sum_consistency(snap["last"]):
        return fail(f"last record not sum-consistent: {snap['last']}")
    for stage in STAGES:
        if snap["stages"][stage]["count"] == 0:
            return fail(f"stage {stage!r} histogram is empty")
        if f"peritext_latency_{stage}_seconds_count" not in prom:
            return fail(f"peritext_latency_{stage}_seconds family missing from the exposition")
    dec = plane.decomposition()
    if not dec["sum_consistent"]:
        return fail(f"decomposition inconsistent: {dec}")

    # -- obs why exit contract ----------------------------------------------
    def ledger_rec(sha, value, stages_ms):
        return {
            "sha": sha, "config": "latency-smoke",
            "device": {"platform": "cpu", "kind": "smoke"},
            "rows": [{"row": "serve_sustained", "unit": "docs/s", "value": value,
                      "latency": {"stages_ms": stages_ms, "total_ms": dec["total_ms"]}}],
        }

    base = dict(dec["stages_ms"])
    refs = [ledger_rec(f"ref{i}", 100.0, base) for i in range(5)]
    clean_path = out / "why-ledger-clean.jsonl"
    clean_path.write_text("".join(
        json.dumps(r) + "\n" for r in refs + [ledger_rec("cand", 99.0, base)]))
    regressed = dict(base)
    regressed["window"] = (regressed.get("window") or 0.0) + 50.0
    why_path = out / "why-ledger.jsonl"
    why_path.write_text("".join(
        json.dumps(r) + "\n" for r in refs + [ledger_rec("cand", 40.0, regressed)]))

    rc_clean = obs_main(["why", str(clean_path), "--tolerance", "10"])
    if rc_clean != 0:
        return fail(f"obs why exit {rc_clean} on a clean ledger (want 0)")
    rc_bad = obs_main(["why", str(why_path), "--tolerance", "10", "--json"])
    if rc_bad != 1:
        return fail(f"obs why exit {rc_bad} on a regressed ledger (want 1)")
    rc_unreadable = obs_main(["why", str(out / "missing.jsonl")])
    if rc_unreadable != 2:
        return fail(f"obs why exit {rc_unreadable} on unreadable input (want 2)")
    report = attribute([json.loads(line) for line in why_path.read_text().splitlines()],
                       tolerance=0.1)
    (out / "why.json").write_text(json.dumps(report, indent=2))
    if report["verdict"] != "regression-attributed" or report["dominant_stage"] != "window":
        return fail(f"attribution named {report.get('dominant_stage')!r} "
                    "for a synthetic window regression")

    # -- arming overhead pin (best-of-N, identical replay) -------------------
    # The twin builds a fresh mux per drive, its compiled programs warm from
    # the process-wide compile cache.  A session of the port captures its
    # CUDA graphs itself, so a fresh session per drive would time an eager
    # pass and a capture in every drive; here each arm is ONE mux over
    # ``repeats + 1`` blocks of the docs, block 0's drive (untimed) runs
    # every signature eager and captures it, and each timed drive replays
    # the same frames into a block of its own on warm graphs.
    n = max(1, args.repeats)
    arms = {armed: build_mux(blocks=n + 1) for armed in (False, True)}
    arms[True][0].latency_plane = LatencyPlane().enable()
    for m, s in arms.values():
        drive(m, s, block=0)
    # the arms alternate, so a host whose speed drifts over the seconds the
    # pin takes moves both bests alike
    walls = [(drive(*arms[False], block=b), drive(*arms[True], block=b))
             for b in range(1, n + 1)]
    off = min(w[0] for w in walls)
    on = min(w[1] for w in walls)
    overhead = (on - off) / off if off else 0.0
    budget = off * OVERHEAD_FRAC + OVERHEAD_FLOOR_S
    print(f"latency-smoke: overhead best-of-{args.repeats}: "
          f"off={off * 1e3:.2f}ms on={on * 1e3:.2f}ms "
          f"({overhead * 100:+.2f}%, budget {OVERHEAD_FRAC * 100:.0f}% "
          f"+ {OVERHEAD_FLOOR_S * 1e3:.0f}ms floor)")
    # held where the session runs on a card; a CPU session's walls move
    # with contention for the host's cores by more than the budget, so
    # there they are reported only
    if device.type == "cuda" and on - off > budget:
        return fail(f"arming the plane cost {(on - off) * 1e3:.2f}ms over "
                    f"the {budget * 1e3:.2f}ms budget")

    print(f"latency-smoke OK: {snap['records']} records, "
          f"force_close={ {k: v for k, v in snap['force_close'].items() if v} }, "
          f"slo_burn={snap['slo']['burn_rate']}, artifacts in {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
