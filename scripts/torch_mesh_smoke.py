#!/usr/bin/env python3
"""mesh-sharded smoke: the doc-axis mesh's contract, the port's twin of
``scripts/mesh_smoke.py``.

Asserts, on 1/2/4/8 shards of ``--device`` (the card by default: virtual
shards of ``cuda:0``, asked for explicitly as
``make_mesh(devices=[cuda:0] * n)``; ``--device cpu`` gives CPU shards):

* **byte equality** — a drain on a 1/2/4/8-shard doc-axis mesh is
  indistinguishable from the meshless fused path: spans, incremental
  patches and full-state digests bit-equal across ALL three storage
  layouts (padded, paged, ragged), several fuzz seeds;
* **one commit per drain batch** — the whole mesh commits a drain batch
  as one ``streaming.fused_dispatches``, made of one ``.mesh`` site call
  per shard holding work (each shard's graph cache runs it once);
* **steady state** — fresh sessions replaying the same shapes on an
  equivalent mesh build and load no kernel library
  (``obs.RecompileSentinel``) and capture no signature twice;
* **the reshard preserves bytes** — the sharded page pool's
  ``reshard()`` moves pages between shards (``parallel/mesh_fused.py``
  ``move_pages``) without changing a single observable byte, and counts
  its moves (``store.ici_page_moves``);
* **observable** — devprof grows a ``mesh`` section (per-shard load /
  utilization, imbalance watermark) and the ``peritext_mesh_*`` gauges
  render in the Prometheus exposition.

Artifacts (``mesh-report.json``, the devprof snapshot, the gauge text)
are written to ``--out``.

    python3 scripts/torch_mesh_smoke.py --out /tmp/pt-mesh [--seeds 3 21] [--device cpu]

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

LAYOUTS = ("padded", "paged", "ragged")


def _mesh(device, n):
    from peritext_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[device] * n)


def _changes(workloads):
    return [[ch for log in w.values() for ch in log] for w in workloads]


def _replay(device, layout, mesh, changes, **kw):
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    kw.setdefault("slot_capacity", 256)
    kw.setdefault("mark_capacity", 128)
    kw.setdefault("tomb_capacity", 128)
    sess = StreamingMerge(
        num_docs=len(changes), actors=("doc1", "doc2", "doc3"),
        layout=layout, mesh=mesh, device=device, **kw,
    )
    for doc, log in enumerate(changes):
        sess.ingest(doc, log)
    sess.drain()
    return sess


def _snapshot(sess):
    # read_patches_all consumes the patch stream: capture once per session
    return sess.digest(), sess.read_all(), sess.read_patches_all()


def _shard_calls(sess):
    """Per shard, the site calls its graph cache ran (eager runs and
    replays, a capture's own first replay included)."""
    return [sum(row["eager"] + row["replays"] for row in g.stats().values())
            for g in sess._shard_graphs]


def _shards_holding_work(sess, n):
    """The shards whose rows hold a doc (every doc of the smoke has ops)."""
    rows = sess._padded_docs // n
    return sorted({int(r) // rows for r in sess._row_of[: sess.num_docs]})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--seeds", type=int, nargs="*", default=[3, 21])
    parser.add_argument("--out", default="mesh-artifacts", help="artifact directory")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_mesh_smoke")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF
    from peritext_tpu_torch.obs.exporters import prometheus_text
    from peritext_tpu_torch.observability import RecompileSentinel
    from peritext_tpu_torch.testing.fuzz import generate_workload

    shard_counts = (1, 2, 4, 8)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"seeds": args.seeds, "shard_counts": list(shard_counts), "layouts": {}}

    GLOBAL_DEVPROF.reset()
    with GLOBAL_DEVPROF:
        # -- equality sweep: every layout x shard count vs meshless ----------
        for layout in LAYOUTS:
            rows = []
            for seed in args.seeds:
                changes = _changes(generate_workload(seed, num_docs=16, ops_per_doc=40))
                digest, spans, patches = _snapshot(_replay(device, layout, None, changes))
                for n in shard_counts:
                    d0 = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
                    sess = _replay(device, layout, _mesh(device, n), changes)
                    dispatches = GLOBAL_COUNTERS.get("streaming.fused_dispatches") - d0
                    calls = _shard_calls(sess)
                    holding = _shards_holding_work(sess, n)
                    tag = f"{layout} seed {seed} shards {n}"
                    assert sess.digest() == digest, f"{tag}: digest diverged"
                    assert sess.read_all() == spans, f"{tag}: spans diverged"
                    assert sess.read_patches_all() == patches, f"{tag}: patches diverged"
                    assert dispatches == 1, (
                        f"{tag}: drain batch took {dispatches} staged programs, the mesh "
                        "contract is ONE")
                    assert calls == [int(s in holding) for s in range(n)], (
                        f"{tag}: site calls per shard {calls}, shards holding work {holding}: "
                        "one call per shard holding work")
                    rows.append({"seed": seed, "shards": n, "digest": digest,
                                 "fused_dispatches": dispatches, "shard_calls": calls,
                                 "mesh": sess._mesh_stats() if n > 1 else None})
            report["layouts"][layout] = rows

        # -- steady state on an equivalent mesh -----------------------------
        changes = _changes(generate_workload(seed=45, num_docs=16, ops_per_doc=32))
        for layout in LAYOUTS:
            _replay(device, layout, _mesh(device, 8), changes)  # cold: first calls
        with RecompileSentinel() as sentinel:
            sentinel.mark()
            warm = [_replay(device, layout, _mesh(device, 8), changes) for layout in LAYOUTS]
            sentinel.assert_fresh_sessions_steady(
                "fresh-session mesh replay",
                sum(len(g) for s in warm for g in s._shard_graphs))
        report["steady_state_compiles"] = 0

        # -- the sharded pool's reshard --------------------------------------
        changes = _changes(generate_workload(seed=77, num_docs=16, ops_per_doc=40))
        digest, spans, patches = _snapshot(_replay(device, "paged", None, changes))
        sess = _replay(device, "paged", _mesh(device, 4), changes)
        before = GLOBAL_COUNTERS.get("store.ici_page_moves")
        sess.reshard()
        assert sess.digest() == digest, "post-reshard digest diverged"
        assert sess.read_all() == spans, "post-reshard spans diverged"
        assert sess.read_patches_all() == patches, "post-reshard patches"
        moved = GLOBAL_COUNTERS.get("store.ici_page_moves") - before
        stats = sess._store.shard_stats()
        report["reshard"] = {"ici_page_moves": moved, "shard_stats": stats,
                             "equality": "byte-identical"}

    # -- the observability surface ------------------------------------------
    snap = GLOBAL_DEVPROF.snapshot()
    assert snap["mesh"] is not None, "devprof mesh section never populated"
    assert snap["mesh"]["shards"] >= 2, snap["mesh"]
    gauges = prometheus_text(devprof=GLOBAL_DEVPROF)
    for metric in ("peritext_mesh_shards", "peritext_mesh_shard_load",
                   "peritext_mesh_shard_imbalance_ratio", "peritext_mesh_peak_imbalance_ratio"):
        assert f"# TYPE {metric} gauge" in gauges, f"{metric} gauge missing"
    report["devprof_mesh"] = snap["mesh"]

    (out / "mesh-report.json").write_text(json.dumps(report, indent=2))
    (out / "devprof-snapshot.json").write_text(json.dumps(snap, indent=2))
    (out / "mesh-gauges.prom").write_text(gauges)
    print(json.dumps({"ok": True,
                      "reshard": report["reshard"]["ici_page_moves"],
                      "mesh": report["devprof_mesh"],
                      "layouts": {k: len(v) for k, v in report["layouts"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
