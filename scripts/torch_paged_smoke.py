#!/usr/bin/env python3
"""paged-storage smoke: the store/ subsystem's contract, the port's twin of
``scripts/paged_smoke.py``.

Runs a small long-tail session through BOTH layouts on ``--device`` (the
card by default) and asserts the paged subsystem's three promises:

* **byte equality** — a paged streaming session fed the same frames as a
  padded one produces identical spans, patches and full-state digests,
  and a paged ``DocBatch`` merge matches the padded merge doc-for-doc;
* **the waste goes away** — on the long-tail shape (one essay among
  tweets) the paged layout burns measurably less padded stream capacity
  than the padded layout (the smoke pins the direction);
* **observable** — the ``peritext_page_*`` gauges render in the
  Prometheus exposition, the devprof snapshot carries the ``page_pool``
  section, and ``health_snapshot`` composes it.

Artifacts (``paged-report.json``, a devprof snapshot, the Prometheus
exposition) are written to ``--out``.

    python3 scripts/torch_paged_smoke.py --out /tmp/pt-paged [--device cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Exits non-zero on any violation, and without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from peritext_tpu_torch.utils.device import script_device  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=8)
    parser.add_argument("--out", default="paged-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_paged_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.obs import GLOBAL_DEVPROF, health_snapshot, prometheus_text
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"seed": args.seed}

    # long-tail workload: a tweet fleet plus one essay
    tweets = generate_workload(seed=args.seed, num_docs=24, ops_per_doc=8)
    essay = generate_workload(seed=args.seed + 90_001, num_docs=1, ops_per_doc=300)
    workloads = tweets + essay

    # -- batch byte equality + waste direction -------------------------------
    padded = DocBatch(slot_capacity=512, mark_capacity=128, device=device).merge(workloads)
    paged_batch = DocBatch(slot_capacity=512, mark_capacity=128, layout="paged", device=device)
    paged = paged_batch.merge(workloads)
    assert padded.spans == paged.spans, "paged batch diverged from padded"
    assert padded.roots == paged.roots, "paged roots diverged from padded"
    assert padded.fallback_docs == paged.fallback_docs
    assert paged.stats.padding_efficiency > padded.stats.padding_efficiency, (
        "paged layout did not improve stream occupancy on the long tail")
    report["batch"] = {
        "docs": len(workloads),
        "padding_efficiency_padded": padded.stats.padding_efficiency,
        "padding_efficiency_paged": paged.stats.padding_efficiency,
        "page_pool": paged_batch.last_store.pool_stats(),
        "byte_equal": True,
    }
    print(f"paged-smoke: batch equal; stream efficiency "
          f"{padded.stats.padding_efficiency:.3f} -> {paged.stats.padding_efficiency:.3f}")

    # -- streaming byte equality under the page pool --------------------------
    rng = random.Random(args.seed)
    arrival = []
    for w in workloads[:12]:
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        half = max(1, len(chs) // 2)
        arrival.append([
            encode_frame(sorted(chs[:half], key=lambda c: (c.actor, c.seq))),
            encode_frame(sorted(chs[half:], key=lambda c: (c.actor, c.seq))),
        ])

    def build(layout):
        s = StreamingMerge(
            num_docs=len(arrival), actors=("doc1", "doc2", "doc3"),
            slot_capacity=512, mark_capacity=128, tomb_capacity=128,
            layout=layout, device=device,
        )
        for r in range(2):
            s.ingest_frames((d, b[r]) for d, b in enumerate(arrival))
            s.drain()
        return s

    GLOBAL_DEVPROF.reset()
    sp = build("padded")
    with GLOBAL_DEVPROF:
        sq = build("paged")
        dq = sq.digest()
    dp = sp.digest()
    assert dp == dq, f"digest diverged: padded {dp:#x} paged {dq:#x}"
    assert sp.read_all() == sq.read_all(), "streaming spans diverged"
    assert sp.read_patches_all() == sq.read_patches_all(), "patches diverged"
    report["streaming"] = {
        "docs": len(arrival),
        "digest": f"{dq:#010x}",
        "rounds": sq.rounds,
        "page_pool": sq.store.pool_stats(),
        "byte_equal": True,
    }
    print(f"paged-smoke: streaming equal (digest {dq:#010x}, "
          f"{sq.store.pool_stats()['pages_in_use']} pages in use)")

    # -- telemetry surfaces ---------------------------------------------------
    snap = GLOBAL_DEVPROF.snapshot()
    assert snap["page_pool"] is not None, "devprof page_pool section missing"
    # a paged session's rows: "streaming.paged" per round, "streaming.paged.fused"
    # per fused batch (the reference's origins; its fused paged drain is the default)
    assert any(o["origin"].startswith("streaming.paged") for o in snap["occupancy"].values()), (
        "paged occupancy rows missing")
    text = prometheus_text(devprof=GLOBAL_DEVPROF, session=sq)
    for gauge in ("peritext_page_pool_pages", "peritext_page_pages_in_use",
                  "peritext_page_pool_utilization", "peritext_page_internal_frag_ratio"):
        assert gauge in text, f"gauge {gauge} missing from exposition"
    health = health_snapshot(session=sq, devprof=GLOBAL_DEVPROF)
    assert health["session"]["page_pool"]["pages_in_use"] > 0
    assert health["devprof"]["page_pool"] is not None
    report["telemetry"] = {"gauges": True, "devprof_page_pool": snap["page_pool"]}
    print("paged-smoke: peritext_page_* gauges + /devprof.json section OK")

    (out / "paged-report.json").write_text(json.dumps(report, indent=2))
    (out / "devprof-snapshot.json").write_text(json.dumps(snap, indent=2))
    (out / "metrics.prom").write_text(text)
    print(f"paged-smoke: PASS (artifacts in {out})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
