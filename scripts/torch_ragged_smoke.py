#!/usr/bin/env python3
"""ragged-layout smoke: the ops/ragged.py contract, the port's twin of
``scripts/ragged_smoke.py``.

Runs the long-tail shape through ``layout="ragged"`` on ``--device`` (the
card by default) and asserts the ragged subsystem's three promises:

* **byte equality, kernel-first** — the ragged insert kernel (K3, CUDA)
  and its plain torch version both reproduce the padded apply
  (``apply_batch``, K1 on the card) field by field, and the ragged
  ``DocBatch`` merge / streaming session match the padded oracle end to
  end (spans, roots, patches, digest).  On the CPU only the plain version
  runs (a CPU tensor never launches a kernel);
* **the buckets are gone** — the merge reports
  ``padding_efficiency == 1.0`` (trip counts are data: zero padded-op
  waste, where even the paged layout burns its pow-2 page buckets);
* **observable** — the ``peritext_ragged_*`` gauges render in the
  Prometheus exposition and ``devprof.snapshot()`` carries the
  ``ragged`` section (docs/pages walked, padded-slot waste 0).

Artifacts (``ragged-report.json``, a devprof snapshot, the Prometheus
exposition) are written to ``--out``.

    python3 scripts/torch_ragged_smoke.py --out /tmp/pt-ragged [--device cpu]

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


def _plain_ragged_insert(*args, page_count_host=None, launch_plan=None):
    """The ragged insert wrapper's call, run by its plain torch version."""
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert_reference

    return ragged_insert_reference(*args)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seed", type=int, default=8)
    parser.add_argument("--out", default="ragged-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_ragged_smoke")
    if device is None:
        return 2

    import numpy as np
    import torch

    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.obs import GLOBAL_DEVPROF, prometheus_text
    from peritext_tpu_torch.ops import ragged as ragged_ops
    from peritext_tpu_torch.ops.encode import encode_doc_streams, pad_doc_streams
    from peritext_tpu_torch.ops.kernel import apply_batch, encoded_arrays_of
    from peritext_tpu_torch.ops.packed import empty_docs
    from peritext_tpu_torch.ops.ragged import apply_batch_ragged, plan_arrays, stream_counts
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.store.paged import PagedDocStore, group_stream_arrays
    from peritext_tpu_torch.store.ragged import ragged_plan
    from peritext_tpu_torch.testing.fuzz import generate_workload

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"seed": args.seed}

    # long-tail workload: a tweet fleet plus one essay
    tweets = generate_workload(seed=args.seed, num_docs=24, ops_per_doc=8)
    essay = generate_workload(seed=args.seed + 90_001, num_docs=1, ops_per_doc=300)
    workloads = tweets + essay

    # -- kernel differential: K3 and its plain version against the padded apply
    per_doc, fallback, actor_tables, attr_tables, map_tables = encode_doc_streams(workloads)
    enc = pad_doc_streams(per_doc, fallback, actor_tables, attr_tables, map_tables)
    d = enc.ins_ref.shape[0]
    ins_counts, _ = stream_counts(enc)
    oracle = apply_batch(empty_docs(d, 512, 128, device=device), encoded_arrays_of(enc, device))
    impls = ("cuda", "plain") if device.type == "cuda" else ("plain",)
    for impl in impls:
        store = PagedDocStore(d, 512, 128, device=device)
        rows = np.arange(d, dtype=np.int64)
        store.ensure_rows(rows, np.asarray(ins_counts, np.int64))
        swapped = ragged_ops.ragged_insert
        if impl == "plain":
            ragged_ops.ragged_insert = _plain_ragged_insert
        try:
            apply_batch_ragged(store.pool_elem, store.pool_char, store.aux,
                               *plan_arrays(ragged_plan(store), device),
                               group_stream_arrays(enc, None, d, device),
                               torch.from_numpy(np.asarray(ins_counts, np.int32)).to(device))
        finally:
            ragged_ops.ragged_insert = swapped
        got = store.materialize_rows(rows, bucket_pages=store.max_doc_pages)
        for f in oracle._fields:
            a = getattr(oracle, f).cpu()
            b = getattr(got, f).cpu()
            if f in ("elem_id", "char"):
                b = b[:, : a.shape[1]]
            assert torch.equal(a, b), f"ragged/{impl} diverges on {f}"
    report["kernel"] = {"docs": d, "impls": list(impls), "byte_equal": True}
    print(f"ragged-smoke: kernel equal on {d} docs ({' + '.join(impls)})")

    # -- batch byte equality + zero waste ------------------------------------
    GLOBAL_DEVPROF.reset()
    padded = DocBatch(slot_capacity=512, mark_capacity=128, device=device).merge(workloads)
    with GLOBAL_DEVPROF:
        ragged_batch = DocBatch(slot_capacity=512, mark_capacity=128, layout="ragged",
                                device=device)
        ragged = ragged_batch.merge(workloads)
    assert padded.spans == ragged.spans, "ragged batch diverged from padded"
    assert padded.roots == ragged.roots, "ragged roots diverged from padded"
    assert padded.fallback_docs == ragged.fallback_docs
    assert ragged.stats.padding_efficiency == 1.0, (
        "ragged layout reported padded-op waste; trip counts must be data")
    report["batch"] = {
        "docs": len(workloads),
        "padding_efficiency_padded": padded.stats.padding_efficiency,
        "padding_efficiency_ragged": ragged.stats.padding_efficiency,
        "page_pool": ragged_batch.last_store.pool_stats(),
        "byte_equal": True,
    }
    print(f"ragged-smoke: batch equal; stream efficiency "
          f"{padded.stats.padding_efficiency:.3f} -> {ragged.stats.padding_efficiency:.3f}")

    # -- streaming byte equality through the ragged drain ---------------------
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

    sp = build("padded")
    with GLOBAL_DEVPROF:
        sq = build("ragged")
        dq = sq.digest()
    dp = sp.digest()
    assert dp == dq, f"digest diverged: padded {dp:#x} ragged {dq:#x}"
    assert sp.read_all() == sq.read_all(), "streaming spans diverged"
    assert sp.read_patches_all() == sq.read_patches_all(), "patches diverged"
    report["streaming"] = {
        "docs": len(arrival),
        "digest": f"{dq:#010x}",
        "rounds": sq.rounds,
        "page_pool": sq.store.pool_stats(),
        "byte_equal": True,
    }
    print(f"ragged-smoke: streaming equal (digest {dq:#010x}, "
          f"{sq.store.pool_stats()['pages_in_use']} pages in use)")

    # -- telemetry surfaces ---------------------------------------------------
    snap = GLOBAL_DEVPROF.snapshot()
    rg = snap["ragged"]
    assert rg is not None, "devprof ragged section missing"
    assert rg["padded_slot_waste"] == 0, "ragged padded-slot waste must be 0"
    assert rg["docs_walked"] > 0 and rg["pages_walked"] > 0
    text = prometheus_text(devprof=GLOBAL_DEVPROF, session=sq)
    for gauge in ("peritext_ragged_dispatches", "peritext_ragged_docs_walked",
                  "peritext_ragged_pages_walked", "peritext_ragged_padded_slot_waste"):
        assert gauge in text, f"gauge {gauge} missing from exposition"
    report["telemetry"] = {"gauges": True, "devprof_ragged": rg}
    print("ragged-smoke: peritext_ragged_* gauges + devprof section OK")

    (out / "ragged-report.json").write_text(json.dumps(report, indent=2))
    (out / "devprof-snapshot.json").write_text(json.dumps(snap, indent=2))
    (out / "metrics.prom").write_text(text)
    print(f"ragged-smoke: PASS (artifacts in {out})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
