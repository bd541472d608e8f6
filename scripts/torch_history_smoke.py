#!/usr/bin/env python3
"""history smoke: the fleet history plane end to end, the port's twin of
``scripts/history_smoke.py``.

Drives a REAL armed serve session on ``--device`` (the card by default)
and asserts the plane retains frames, rolls JSONL segments over, cascades
the retention tiers, and replays the persisted segments back into a
byte-identical ring; runs the serve-overload chaos episode and asserts the
injected fault scores as an anomaly no later than the round its incident
opens; exercises the ``obs history`` exit contract (0 clean / 1 active
anomaly / 2 unreadable) and the history-weighted ``obs plan`` replay (same
occupancy history -> byte-identical proposal, and a proposal that DIFFERS
from the snapshot-only one on a bimodal fixture); and pins the arming
cost: sampling over steady-state serve rounds builds and loads no kernel
library and captures no signature twice (``obs.RecompileSentinel``), and a
synthetic feed stays wall-clock cheap.  Artifacts (``history.json``,
``history.prom``, ``serve_chaos.json``, ``plan.json``, ``segments/``) land
in ``--out``.

    python3 scripts/torch_history_smoke.py --out /tmp/pt-history [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402

#: feeding budget: 2k advance_round samples of a busy plane must stay
#: under this wall — retention is dict folds, not device work
FEED_ROUNDS = 2000
FEED_BUDGET_S = 2.0

#: bimodal occupancy fixture: p90 lands on the dense mode, flipping the
#: planner's width-shrink gate vs the snapshot-only point estimate
BIMODAL = [0.05] * 12 + [0.9] * 4


def fail(msg: str) -> int:
    print(f"history-smoke FAIL: {msg}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--out", default="history-artifacts")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_history_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import (
        RecompileSentinel,
        TimeSeriesPlane,
        prometheus_text,
        replay_segments,
    )
    from peritext_tpu_torch.obs.__main__ import main as obs_main
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.plan import propose
    from peritext_tpu_torch.serve import SessionMux
    from peritext_tpu_torch.testing.chaos import run_serve_chaos
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seg_dir = out / "segments"

    # -- a REAL armed serve session: retention + segments + steady state -----
    def make_mux():
        return SessionMux(
            StreamingMerge(
                num_docs=1, actors=("doc1", "doc2", "doc3"),
                slot_capacity=256, mark_capacity=64, tomb_capacity=128,
                round_insert_capacity=32, round_delete_capacity=16,
                round_mark_capacity=16, static_rounds=True, device=device,
            ),
            host="smoke",
        )

    def drive(mux, plane=None):
        sid, verdict = mux.open_session("client")
        assert verdict.admitted
        if plane is not None:
            mux.history_plane = plane
        for frame in frames:
            assert mux.submit(sid, frame).admitted
            mux.flush()

    w = generate_workload(seed=args.seed, num_docs=1, ops_per_doc=80)[0]
    changes = sorted((ch for log in w.values() for ch in log), key=lambda c: (c.actor, c.seq))
    frames = [encode_frame(changes[i::40]) for i in range(40)]
    t0 = time.perf_counter()
    drive(make_mux())  # cold: every first call runs OUTSIDE arming
    plane = TimeSeriesPlane(sample_every=1, tier_capacity=8, merge_factor=2,
                            tiers=3, min_frames=4, segment_frames=16,
                            dir=seg_dir, host="smoke").enable()
    with RecompileSentinel() as sentinel:
        sentinel.mark()
        t_armed = time.perf_counter()
        armed = make_mux()
        drive(armed, plane=plane)
        plane.note_overhead(time.perf_counter() - t_armed)
        try:
            sentinel.assert_fresh_sessions_steady(
                "armed history sampling over steady-state serve rounds",
                len(armed.session._graphs))
        except AssertionError as exc:
            return fail(f"arming built kernels or recaptured graphs: {exc}")
    serve_s = time.perf_counter() - t0
    snap = plane.snapshot()
    if plane.frames_sampled < len(frames):
        return fail(f"armed session retained {plane.frames_sampled} frames, "
                    f"want >= {len(frames)}")
    if plane.segments() < 2:
        return fail(f"{plane.frames_sampled} frames never rolled a segment "
                    f"over (segments={plane.segments()})")
    if sum(1 for n in snap["tier_frames"][1:] if n) == 0:
        return fail(f"retention never cascaded past tier 0: {snap['tier_frames']}")
    replayed = replay_segments(seg_dir, tier_capacity=8, merge_factor=2, tiers=3, host="smoke")
    if replayed.frames_json() != plane.frames_json():
        return fail("segment replay did not reconstruct the ring byte-identically")
    print(f"history-smoke: armed serve session OK in {serve_s:.1f}s "
          f"({plane.frames_sampled} frames, {plane.segments()} segments, "
          f"tiers {snap['tier_frames']}, replay byte-identical, 0 compiles)")

    # -- the chaos oracle: injected overload scores as an anomaly ------------
    t0 = time.perf_counter()
    report = run_serve_chaos(args.seed, hosts=3, device=device)
    chaos_s = time.perf_counter() - t0
    (out / "serve_chaos.json").write_text(json.dumps(report.to_json(), indent=2))
    if not report.anomaly_keys:
        return fail("serve chaos flagged no anomaly keys")
    if any(not k.startswith("serve.") for k in report.anomaly_keys):
        return fail(f"anomaly keys off the serve plane: {report.anomaly_keys}")
    if report.anomaly_detection_rounds < 0:
        return fail("anomaly detection round missing from the episode report")
    print(f"history-smoke: serve-chaos episode OK in {chaos_s:.1f}s "
          f"(anomalies {report.anomaly_keys} after "
          f"{report.anomaly_detection_rounds} round(s))")

    # -- the obs history exit contract ---------------------------------------
    quiet = TimeSeriesPlane(min_frames=4).enable()
    for i in range(8):
        quiet.sample(serve={"admitted": float(i * 2), "depth": 1.0})
    spiked = TimeSeriesPlane(min_frames=4).enable()
    for _ in range(6):
        spiked.sample(serve={"shed": 0.0})
    spiked.sample(serve={"shed": 50.0})
    clean_dir = out / "clean"
    hot_dir = out / "hot"
    clean_dir.mkdir(exist_ok=True)
    hot_dir.mkdir(exist_ok=True)
    (clean_dir / "timeseries.json").write_text(json.dumps(quiet.snapshot(), default=str))
    (hot_dir / "timeseries.json").write_text(json.dumps(spiked.snapshot(), default=str))
    (out / "history.json").write_text(json.dumps(snap, default=str))
    rc = obs_main(["history", str(clean_dir)])
    if rc != 0:
        return fail(f"obs history exit {rc} on a clean snapshot (want 0)")
    rc = obs_main(["history", str(clean_dir), "--key", "serve.admitted", "--rate"])
    if rc != 0:
        return fail(f"obs history --key exit {rc} on a clean gauge (want 0)")
    rc = obs_main(["history", str(hot_dir)])
    if rc != 1:
        return fail(f"obs history exit {rc} with an active anomaly (want 1)")
    rc = obs_main(["history", str(out / "missing")])
    if rc != 2:
        return fail(f"obs history exit {rc} on unreadable input (want 2)")

    # -- the history-weighted planner replay ---------------------------------
    devprof_path = ROOT / "perf" / "plan_devprof.json"
    devprof = json.loads(devprof_path.read_text())
    base = propose(devprof)
    weighted = propose(devprof, history=BIMODAL)
    again = propose(devprof, history=list(BIMODAL))
    if (json.dumps(weighted.to_json(), sort_keys=True)
            != json.dumps(again.to_json(), sort_keys=True)):
        return fail("same occupancy history produced two different proposals")
    if weighted.to_json() == base.to_json():
        return fail("bimodal occupancy history did not move the proposal")
    if "history" not in weighted.modeled:
        return fail("history-weighted proposal lacks the modeled history block")
    (out / "plan.json").write_text(json.dumps(weighted.to_json(), indent=2))
    hist_plane = TimeSeriesPlane(min_frames=4).enable()
    for occ in BIMODAL:
        hist_plane.record_occupancy(0, occ)
    hist_path = out / "occupancy.json"
    hist_path.write_text(json.dumps(hist_plane.snapshot(), default=str))
    renders = []
    for _ in range(2):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = obs_main(["plan", str(devprof_path), "--history", str(hist_path), "--json"])
        if rc not in (0, 1):
            return fail(f"obs plan --history exit {rc} (want 0 or 1)")
        renders.append(buf.getvalue())
    if renders[0] != renders[1]:
        return fail("obs plan --history replay was not deterministic")
    if '"weighted_terms"' not in renders[0]:
        return fail("obs plan --history omitted the history-weighted terms")
    print("history-smoke: planner replay OK (history-weighted proposal "
          f"deviates from snapshot-only: insert_width {base.insert_width} "
          f"-> {weighted.insert_width}, byte-stable across replays)")

    # -- gauges --------------------------------------------------------------
    text = prometheus_text(history=plane)
    (out / "history.prom").write_text(text)
    for needle in ("peritext_history_frames_retained ", "peritext_history_segments ",
                   'peritext_history_tier_frames{tier="0"}', "peritext_build_info{"):
        if needle not in text:
            return fail(f"{needle!r} missing from the exposition")

    # -- feeding cost: nothing built, loaded or captured; cheap wall ---------
    with RecompileSentinel() as sentinel:
        before = sentinel.total
        feed = TimeSeriesPlane(sample_every=4, min_frames=8).enable()
        t0 = time.perf_counter()
        for n in range(FEED_ROUNDS):
            feed.advance_round(serve={"depth": n % 5, "admitted": n},
                               fleet={"hosts": 3, "dead": 0})
        wall = time.perf_counter() - t0
        feed.note_overhead(wall)
        if sentinel.total != before:
            return fail("feeding the history plane built, loaded or captured kernels")
    if wall > FEED_BUDGET_S:
        return fail(f"{FEED_ROUNDS} sampled rounds took {wall:.2f}s (budget {FEED_BUDGET_S}s)")

    print(f"history-smoke OK: {plane.frames_sampled} serve frames across "
          f"{plane.segments()} segment(s), {FEED_ROUNDS} synthetic rounds in "
          f"{wall * 1e3:.0f}ms, 0 compiles, artifacts in {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
