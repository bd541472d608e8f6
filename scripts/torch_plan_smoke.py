#!/usr/bin/env python3
"""device-as-OS planner smoke: the cross-tenant fusion + closed-loop
planner contract, the port's twin of ``scripts/plan_smoke.py``.

Asserts, on ``--device`` (the card by default):

* **one commit per window** — 32 one-doc tenants fused onto one shared
  ``static_rounds`` lane commit every batching window as ONE fused
  dispatch (dispatch-counter deltas); sparse windows ride the
  multi-tenant offset-plane form; dispatch amortization vs the
  per-session twin fleet is >= 8x;
* **byte equality / isolation** — every tenant's patch stream and
  rendered spans bit-equal to its standalone twin's;
* **steady state** — a fresh fused group replaying the same window plan
  builds and loads no kernel library (``obs.RecompileSentinel``) and
  captures no signature twice;
* **closed loop** — the devprof snapshot captured DURING the fused run
  (``capture_costs`` on) feeds ``plan.propose()``: the proposal is
  deterministic (two calls, identical JSON), the ``obs plan`` CLI obeys
  its exit-code contract (0/1 on the tolerance band, 2 on garbage), and
  the proposed statics REPLAY through a fresh fused group byte-equal to
  the standalone oracle.  On the card the proposal is the observed
  configuration (the budget is the allocator's peak), which still
  replays.

Artifacts (``plan-report.json``, the devprof snapshot, the proposal) are
written to ``--out``.

    python3 scripts/torch_plan_smoke.py --out /tmp/pt-plan [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402

ACTORS = ("doc1", "doc2", "doc3")


def _frame_plans(names, windows, seed, opd):
    """One workload per tenant, split causally across ``windows`` frames
    (striping one sorted change list keeps (actor, seq) causality)."""
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.testing.fuzz import generate_workload

    workloads = generate_workload(seed=seed, num_docs=len(names), ops_per_doc=opd)
    plans = {}
    for name, w in zip(names, workloads):
        changes = sorted((ch for log in w.values() for ch in log),
                         key=lambda c: (c.actor, c.seq))
        plans[name] = [encode_frame(changes[i::windows]) for i in range(windows)]
    return plans


def _window_plan(names, frame_plans, windows):
    """Alternating full and sparse windows (the sparse ones exercise the
    offset-plane multi-tenant form), leftovers in a final full window."""
    plan = []
    cursor = {n: 0 for n in names}
    for w in range(windows):
        active = list(names) if w % 2 == 0 else names[(w // 2) % 4::4]
        step = []
        for n in active:
            if cursor[n] < windows:
                step.append((n, frame_plans[n][cursor[n]]))
                cursor[n] += 1
        plan.append(step)
    tail = [(n, frame_plans[n][c]) for n in names for c in range(cursor[n], windows)]
    if tail:
        plan.append(tail)
    return plan


def _build_group(names, session_kw):
    from peritext_tpu_torch.plan.fusion import TenantSpec
    from peritext_tpu_torch.serve import FusedMuxGroup, default_lane_factory

    group = FusedMuxGroup(
        [TenantSpec(tenant=n, docs=1) for n in names],
        default_lane_factory(ACTORS, **session_kw),
        host="plan-smoke",
    )
    sids = {}
    for n in names:
        sid, verdict = group.open_session(n, "client")
        assert verdict.admitted, verdict
        sids[n] = sid
    return group, sids


def _build_solo(names, session_kw):
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.serve import SessionMux

    muxes, sids = {}, {}
    for n in names:
        mux = SessionMux(
            StreamingMerge(num_docs=1, actors=ACTORS, static_rounds=True, **session_kw),
            host="plan-smoke-solo",
        )
        sid, verdict = mux.open_session("client")
        assert verdict.admitted, verdict
        muxes[n], sids[n] = mux, sid
    return muxes, sids


def _drive_group(group, sids, plan):
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS

    d0 = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
    for step in plan:
        for n, frame in step:
            verdict = group.submit(n, sids[n], frame)
            assert verdict.admitted, verdict
        group.flush()
    return int(GLOBAL_COUNTERS.get("streaming.fused_dispatches") - d0)


def _drive_solo(muxes, sids, plan):
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS

    d0 = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
    for step in plan:
        touched = []
        for n, frame in step:
            verdict = muxes[n].submit(sids[n], frame)
            assert verdict.admitted, verdict
            touched.append(n)
        for n in dict.fromkeys(touched):
            muxes[n].flush()
    return int(GLOBAL_COUNTERS.get("streaming.fused_dispatches") - d0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tenants", type=int, default=32)
    parser.add_argument("--windows", type=int, default=6)
    parser.add_argument("--ops-per-doc", type=int, default=24)
    parser.add_argument("--seed", type=int, default=29)
    parser.add_argument("--out", default="plan-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_plan_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import GLOBAL_DEVPROF
    from peritext_tpu_torch.obs.__main__ import main as obs_main
    from peritext_tpu_torch.observability import RecompileSentinel
    from peritext_tpu_torch.plan import propose

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    names = [f"tenant{i:03d}" for i in range(args.tenants)]
    frame_plans = _frame_plans(names, args.windows, args.seed, args.ops_per_doc)
    plan = _window_plan(names, frame_plans, args.windows)
    session_kw = dict(
        slot_capacity=128, mark_capacity=64, tomb_capacity=96,
        round_insert_capacity=32, round_delete_capacity=16,
        round_mark_capacity=16, device=device,
    )
    report = {"tenants": args.tenants, "windows": len(plan), "seed": args.seed}

    GLOBAL_DEVPROF.reset()
    GLOBAL_DEVPROF.enable(capture_costs=True)
    try:
        # -- fused vs per-session: one commit per window, byte equality
        group, gsids = _build_group(names, session_kw)
        fused_dispatches = _drive_group(group, gsids, plan)
        muxes, ssids = _build_solo(names, session_kw)
        solo_dispatches = _drive_solo(muxes, ssids, plan)
        assert fused_dispatches == len(plan), (
            f"expected one fused dispatch per window: "
            f"{fused_dispatches} dispatches over {len(plan)} windows")
        amortization = solo_dispatches / fused_dispatches
        assert amortization >= 8.0, (
            f"dispatch amortization {amortization:.2f}x < 8x "
            f"({solo_dispatches} per-session vs {fused_dispatches} fused)")
        solo_patches, solo_spans = {}, {}
        for n in names:
            solo_patches[n] = muxes[n].patches(ssids[n])
            solo_spans[n] = muxes[n].read(ssids[n])
            assert group.patches(n, gsids[n]) == solo_patches[n], (
                f"fused/unfused patch divergence for {n}")
            assert group.read(n, gsids[n]) == solo_spans[n], (
                f"fused/unfused span divergence for {n}")
        fusion = group.fusion_snapshot()
        assert fusion["grouped"] and fusion["lanes"] == 1, fusion
        report["fused_dispatches"] = fused_dispatches
        report["per_session_dispatches"] = solo_dispatches
        report["amortization_x"] = round(amortization, 2)
        report["fusion"] = fusion

        # -- steady state on a repeat window plan
        with RecompileSentinel() as sentinel:
            sentinel.mark()
            warm, wsids = _build_group(names, session_kw)
            _drive_group(warm, wsids, plan)
            sentinel.assert_fresh_sessions_steady(
                "fused multi-tenant repeat window plan",
                sum(len(s._graphs) for s in warm._lane_sessions))
        for n in names:
            assert warm.read(n, wsids[n]) == solo_spans[n]
        report["steady_state_compiles"] = 0
    finally:
        GLOBAL_DEVPROF.disable()

    snap = GLOBAL_DEVPROF.snapshot()
    assert snap["sites"], "devprof captured no dispatch sites"
    assert snap["occupancy"], "devprof captured no occupancy rows"
    report["devprof_sites"] = sorted(snap["sites"])
    snap_path = out / "devprof-snapshot.json"
    snap_path.write_text(json.dumps(snap, indent=2, sort_keys=True))

    # -- closed loop: deterministic proposal from the captured snapshot
    proposal = propose(snap)
    assert proposal.to_json() == propose(snap).to_json(), (
        "propose() must be a pure function of the snapshot")
    report["proposal"] = proposal.to_json()
    report["beats_current"] = proposal.beats_current()
    (out / "proposal.json").write_text(json.dumps(report["proposal"], indent=2))

    # -- the operator surface obeys its exit-code contract
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_main(["plan", str(snap_path), "--json"])
    assert rc == (1 if proposal.beats_current() else 0), (
        f"obs plan exit {rc} disagrees with beats_current={proposal.beats_current()}")
    cli_body = json.loads(buf.getvalue())
    assert cli_body["proposal"] == report["proposal"]["proposal"], (
        "CLI proposal diverges from the library proposal")
    garbage = out / "garbage.json"
    garbage.write_text("{not json")
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        assert obs_main(["plan", str(garbage), "--json"]) == 2
    report["cli_exit"] = rc

    # -- replay the proposed statics: advice must stay byte-equal before
    #    anyone re-pins a static (smaller widths just mean more rounds)
    replay_kw = dict(
        session_kw,
        slot_capacity=max(proposal.slot_capacity, 64),
        round_insert_capacity=proposal.insert_width,
        round_delete_capacity=proposal.delete_width,
        round_mark_capacity=proposal.mark_width,
    )
    replay, rsids = _build_group(names, replay_kw)
    _drive_group(replay, rsids, plan)
    for n in names:
        assert replay.patches(n, rsids[n]) == solo_patches[n], (
            f"proposed statics diverge from the oracle for {n}")
        assert replay.read(n, rsids[n]) == solo_spans[n]
    report["replay_byte_equal"] = True

    (out / "plan-report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({
        "ok": True,
        "amortization_x": report["amortization_x"],
        "fused_dispatches": fused_dispatches,
        "per_session_dispatches": solo_dispatches,
        "beats_current": report["beats_current"],
        "replay_byte_equal": True,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
