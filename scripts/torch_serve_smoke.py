#!/usr/bin/env python3
"""serve smoke: the serving tier's contract, the port's twin of
``scripts/serve_smoke.py``.

Runs the serving tier end to end on ``--device`` (the card by default)
and asserts its three promises:

* **typed verdicts under overload** — a burst far beyond the bounded
  ingest queue produces ``delay``/``shed`` verdicts from the typed
  vocabulary, the accounting identity holds (zero silent drops), and the
  queue depth never exceeds its bound;
* **byte equality** — after the overload clears and shed frames are
  redelivered, the mux's device state equals a fault-free reference
  session bit-for-bit;
* **observable** — ``/serve.json`` snapshots render through
  ``python -m peritext_tpu_torch.obs serve``, which exits 1 on the
  overloaded snapshot and 0 on the drained one.

A short open-loop rung also runs so the artifact carries a latency
readout.  On the card a mux sheds and never demotes a doc to the scalar
path; the verdicts stay the typed vocabulary.  Artifacts
(``serve-report.json``, the two ``/serve.json`` snapshots) are written to
``--out``.

    python3 scripts/torch_serve_smoke.py --out /tmp/pt-serve [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--out", default="serve-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_serve_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs.__main__ import main as obs_main
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.serve import (
        SHED_REASONS,
        AdmissionController,
        SessionMux,
        build_arrivals,
        run_open_loop,
    )
    from peritext_tpu_torch.testing.chaos import _serve_session
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    num_docs, ops_per_doc, max_depth = 6, 40, 24
    workloads = generate_workload(args.seed, num_docs=num_docs, ops_per_doc=ops_per_doc)
    plans = []
    for w in workloads:
        changes = [ch for log in w.values() for ch in log]
        plans.append([encode_frame(changes[i:i + 5]) for i in range(0, len(changes), 5)])

    mux = SessionMux(
        _serve_session(num_docs, ops_per_doc, device=device),
        admission=AdmissionController(max_depth=max_depth, session_quota=None),
        host="serve-smoke",
    )
    sids = []
    for d in range(num_docs):
        sid, verdict = mux.open_session(f"client{d}")
        assert verdict.admitted, verdict
        sids.append(sid)

    # -- overload burst: typed verdicts, bounded queue ----------------------
    admitted = [[] for _ in range(num_docs)]
    for k in range(max_depth * 6):
        doc = k % num_docs
        frame = plans[doc][(k // num_docs) % len(plans[doc])]
        verdict = mux.submit(sids[doc], frame)
        assert mux.admission.depth <= max_depth, "queue bound violated"
        if verdict.kind == "admit":
            admitted[doc].append(frame)
        elif verdict.kind == "shed":
            assert verdict.reason in SHED_REASONS, verdict
    stats = mux.admission.stats
    assert stats.submitted == stats.admitted + stats.delayed + stats.shed
    assert stats.shed > 0, "the overload burst must shed"
    # freeze the burst-phase verdict counts: `stats` is live and the
    # redelivery below keeps counting into it
    burst = stats.to_json()
    burst_peak = mux.admission.peak_depth
    overloaded_snap = out / "serve-overloaded.json"
    overloaded_snap.write_text(json.dumps(mux.snapshot(), indent=1))

    # the health-check contract: overloaded/shedding scrape exits 1
    rc = obs_main(["serve", str(overloaded_snap)])
    assert rc == 1, f"obs serve must flag the overloaded snapshot (rc={rc})"

    # -- drain + redeliver: byte equality -----------------------------------
    mux.flush()
    reference = _serve_session(num_docs, ops_per_doc, device=device)
    for doc, frames in enumerate(admitted):
        for f in frames:
            reference.ingest_frame(doc, f)
    reference.drain()
    assert mux.session.digest() == reference.digest(), (
        "admitted-set digest mismatch after the overload drained")
    clean = _serve_session(num_docs, ops_per_doc, device=device)
    for doc, frames in enumerate(plans):
        for f in frames:
            clean.ingest_frame(doc, f)
    clean.drain()
    for doc, frames in enumerate(plans):
        for f in frames:
            while True:
                if mux.submit(sids[doc], f).kind == "admit":
                    break
                mux.flush()
    mux.flush()
    assert mux.session.digest() == clean.digest(), (
        "redelivered state must equal the fault-free session byte-for-bit")

    # -- a short open-loop rung for the latency readout ---------------------
    lat_mux = SessionMux(
        _serve_session(num_docs, ops_per_doc, device=device),
        admission=AdmissionController(max_depth=256, session_quota=None),
        host="serve-smoke",
    )
    frames_by_session = {}
    for d in range(num_docs):
        sid, _ = lat_mux.open_session(f"open{d}")
        frames_by_session[sid] = plans[d]
    rung = run_open_loop(lat_mux, build_arrivals(frames_by_session, 120.0, 0.5), deadline_s=4.0)
    assert rung.accounted()
    healthy_snap = out / "serve-healthy.json"
    healthy_snap.write_text(json.dumps(lat_mux.snapshot(), indent=1))
    rc = obs_main(["serve", str(healthy_snap)])
    assert rc == 0, f"obs serve must pass the healthy snapshot (rc={rc})"

    report = {
        "seed": args.seed,
        "overload": {**burst, "queue_peak": burst_peak, "queue_max_depth": max_depth},
        "open_loop": rung.to_json(),
        "digest": f"{clean.digest():#010x}",
    }
    (out / "serve-report.json").write_text(json.dumps(report, indent=1))
    print(
        f"serve smoke: offered {burst['submitted']} under overload -> "
        f"{burst['admitted']} admitted / {burst['delayed']} delayed / "
        f"{burst['shed']} shed ({burst['shed_reasons']}), "
        f"queue peak {burst_peak}/{max_depth}; open loop "
        f"{rung.rate_per_s:.0f}/s p99 {rung.p99_apply_s * 1e3:.1f} ms; "
        f"byte-equal after redelivery"
    )
    print(f"serve smoke: artifacts in {out}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
