#!/usr/bin/env python3
"""Weak scaling of the device mesh: the port's twin of
``scripts/weak_scaling.py``.

A mesh (``parallel/mesh.Mesh``) of 1, 2, 4 and 8 shards over the doc axis,
the same merge paths at each size, at FIXED docs per shard.  Per size it
measures:

* the batch merge (``DocBatch(mesh=)``): wall time and ops/s per shard;
* the streaming merge (``StreamingMerge(mesh=)``), split into host ingest,
  schedule + apply (ending in a synchronize) and digest;
* a fixed-work probe: the same docs at every size, so a slowdown against
  one shard is the mesh's own overhead;
* the digest after a fixed 16-doc round (touched) and with no round
  (idle);
* skewed arrival (a quarter of the docs three times as long, all first)
  and ``reshard()``: shard loads before and after, digest unchanged;
* the digest of a fixed 16-doc probe, which must be identical at every
  size (resharding never changes content).

Shards: ``--device cuda`` (default) gives virtual shards on one card
(``make_mesh(devices=[cuda:0] * n)``, as ``chip_smoke.py`` phase 5j does);
``--cards N`` puts shard i on card ``cuda:(i mod N)`` and raises with
fewer than N cards; ``--device cpu`` gives CPU shards.  ``--layout
paged|ragged`` runs the streaming sessions in that storage layout (the
ragged one launches K3); the batch merge stays padded.

    python3 scripts/torch_weak_scaling.py [--docs-per-device 64] [--sizes 1 2 4 8]

The first line names the device (the card's name and power limit, or
``cpu``).  Prints one JSON line per mesh size, then a summary line.  Exits
non-zero without a card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from peritext_tpu_torch.utils.device import script_device  # noqa: E402

ACTORS = ("doc1", "doc2", "doc3")


def mesh_of(n: int, device, cards: int):
    """A mesh of ``n`` shards: on ``cards`` cards round-robin, or ``n``
    virtual shards on ``device``."""
    import torch

    from peritext_tpu_torch.parallel.mesh import make_mesh

    if cards:
        return make_mesh(devices=[torch.device("cuda", i % cards) for i in range(n)])
    return make_mesh(devices=[device] * n)


def frames_of(workloads):
    from peritext_tpu_torch.parallel.codec import encode_frame

    return [encode_frame([ch for log in w.values() for ch in log]) for w in workloads]


def total_ops(workloads) -> int:
    return sum(len(ch.ops) for w in workloads for log in w.values() for ch in log)


def shard_loads(sess, n: int):
    """Per shard, the summed load (``reshard``'s per-doc measure: live
    slots, or pages in the page-pool layouts) of the docs it holds."""
    rows = sess._padded_docs // n
    shard = sess._row_of[: sess.num_docs] // rows
    return np.bincount(shard, weights=sess._reshard_sizes(), minlength=n).astype(int).tolist()


def run_size(n, mesh, args, probe, device):
    from peritext_tpu_torch.testing.devtime import generate
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    opd = args.ops_per_doc
    docs = args.docs_per_device * n
    workloads = generate(args.seed, docs, opd)
    ops = total_ops(workloads)

    # ---- batch merge over the mesh ----
    batch = DocBatch(slot_capacity=4 * opd, mark_capacity=2 * opd, comment_capacity=32,
                     mesh=mesh)
    batch.merge(workloads)  # warm: kernel builds, allocator pools
    mesh.synchronize()
    t0 = time.perf_counter()
    report = batch.merge(workloads)
    mesh.synchronize()
    batch_s = time.perf_counter() - t0
    if report.fallback_docs:
        raise AssertionError(f"weak scaling: batch merge fell back on {report.fallback_docs}")

    # ---- streaming merge over the mesh ----
    def mk(num_docs, **caps):
        caps = dict(dict(slot_capacity=4 * opd, mark_capacity=2 * opd, tomb_capacity=2 * opd,
                         round_insert_capacity=128, round_delete_capacity=64,
                         round_mark_capacity=64), **caps)
        return StreamingMerge(num_docs=num_docs, actors=ACTORS, mesh=mesh, layout=args.layout,
                              **caps)

    frames = frames_of(workloads)
    s = mk(docs)  # warm
    s.ingest_frames(list(enumerate(frames)))
    s.drain()
    s.digest()
    t0 = time.perf_counter()
    s = mk(docs)
    s.ingest_frames(list(enumerate(frames)))
    t_ingest = time.perf_counter() - t0
    s.drain()
    # drain() only enqueues the applies; without a sync their device time
    # would land in the digest stage below
    s.sync_device()
    t_drain = time.perf_counter() - t0 - t_ingest
    s.digest()
    t_digest = time.perf_counter() - t0 - t_ingest - t_drain
    stream_s = t_ingest + t_drain + t_digest
    # shard count: the session's doc axis really spans n shards
    shards = len(s._shard_state) if s._shard_state is not None else s.mesh.size
    if s.mesh.size != n or shards != n:
        raise AssertionError(f"weak scaling: expected {n} shards, got {s.mesh.size} / {shards}")

    # ---- the mesh's own overhead: the SAME work at every size ----
    fixed_w = generate(args.seed ^ 0xF1, args.docs_per_device, opd)
    fixed_frames = frames_of(fixed_w)

    def fixed_run():
        fs = mk(args.docs_per_device)
        fs.ingest_frames(list(enumerate(fixed_frames)))
        fs.drain()
        fs.digest()

    fixed_run()  # warm
    t0 = time.perf_counter()
    fixed_run()
    fixed_s = time.perf_counter() - t0

    # ---- touched-round digest: a converged session absorbs a fixed 16-doc
    # round (the held-back last third of those docs' histories, so causality
    # holds); the incremental digest re-resolves only what it touched
    warm_round, held, first_frames = {}, {}, []
    for i, w in enumerate(workloads):
        ch = [c for log in w.values() for c in log]
        if i < 16:
            first_frames.append(encode_frame(ch[: len(ch) // 3]))
            warm_round[i] = encode_frame(ch[len(ch) // 3: 2 * len(ch) // 3])
            held[i] = encode_frame(ch[2 * len(ch) // 3:])
        else:
            first_frames.append(encode_frame(ch))
    ts = mk(docs)
    ts.ingest_frames(list(enumerate(first_frames)))
    ts.drain()
    ts.digest()  # warm the carried row plane
    ts.ingest_frames(list(warm_round.items()))
    ts.drain()
    ts.digest()  # warm the touched-rows path
    ts.ingest_frames(list(held.items()))
    ts.drain()
    ts.sync_device()  # the apply in its own stage
    t0 = time.perf_counter()
    ts.digest()
    touched_digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts.digest()
    idle_digest_s = time.perf_counter() - t0

    # ---- skewed arrival + reshard: first-seen placement pins the heavy
    # docs where they arrived; the reshard must restore per-shard balance
    # with the digest unchanged
    skew_stats = None
    if n > 1:
        sk_docs = args.docs_per_device * n
        heavy = generate(args.seed ^ 0x5E, sk_docs // 4, opd * 3)
        light = generate(args.seed ^ 0x5F, sk_docs - len(heavy), max(8, opd // 4))
        sk = mk(sk_docs, slot_capacity=12 * opd, mark_capacity=6 * opd,
                tomb_capacity=6 * opd, round_insert_capacity=256, round_delete_capacity=128,
                round_mark_capacity=128)
        sk.ingest_frames(enumerate(frames_of(heavy + light)))
        sk.drain()
        d_before = sk.digest()
        loads_before = shard_loads(sk, n)
        t0 = time.perf_counter()
        moved = sk.reshard()
        sk.sync_device()  # the row moves
        reshard_s = time.perf_counter() - t0
        loads_after = shard_loads(sk, n)
        if sk.digest() != d_before:
            raise AssertionError("weak scaling: reshard changed the digest")
        skew_stats = {
            "docs": sk_docs,
            "moved_docs": moved["moved"],
            "reshard_seconds": round(reshard_s, 3),
            "shard_load_before": loads_before,
            "shard_load_after": loads_after,
            "imbalance_before": round(max(loads_before) / max(1, min(loads_before)), 2),
            "imbalance_after": round(max(loads_after) / max(1, min(loads_after)), 2),
        }

    # ---- fixed-probe digest: content must not depend on the mesh size ----
    ps = mk(16, slot_capacity=256, mark_capacity=128, tomb_capacity=128,
            round_insert_capacity=64, round_delete_capacity=32, round_mark_capacity=32)
    for d, w in enumerate(probe):
        ps.ingest(d, [ch for log in w.values() for ch in log])
    ps.drain()
    return {
        "mesh_devices": n,
        "docs": docs,
        "total_ops": ops,
        "batch_seconds": round(batch_s, 3),
        "batch_ops_per_sec_total": round(ops / batch_s, 1),
        "batch_ops_per_sec_per_device": round(ops / batch_s / n, 1),
        "streaming_seconds": round(stream_s, 3),
        "streaming_ops_per_sec_total": round(ops / stream_s, 1),
        "streaming_ops_per_sec_per_device": round(ops / stream_s / n, 1),
        "streaming_stage_seconds": {
            "ingest_host": round(t_ingest, 3),
            "schedule_apply": round(t_drain, 3),
            "digest": round(t_digest, 3),
        },
        "fixed_work_seconds": round(fixed_s, 3),
        "fixed_work_ops_per_sec": round(total_ops(fixed_w) / fixed_s, 1),
        "touched_round_digest_seconds": round(touched_digest_s, 3),
        "idle_round_digest_seconds": round(idle_digest_s, 4),
        "skewed_arrival_reshard": skew_stats,
        "probe_digest": ps.digest(),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--docs-per-device", type=int, default=64)
    parser.add_argument("--ops-per-doc", type=int, default=96)
    parser.add_argument("--seed", type=int, default=11)
    parser.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--cards", type=int, default=0,
                        help="put the shards on this many cards (default: virtual shards "
                        "on one device)")
    parser.add_argument("--layout", default="padded", choices=("padded", "paged", "ragged"))
    args = parser.parse_args(argv)
    device = script_device(args.device if not args.cards else "cuda:0", "torch_weak_scaling")
    if device is None:
        return 2
    if args.cards:
        import torch

        have = torch.cuda.device_count()
        if have < args.cards:
            raise RuntimeError(f"--cards {args.cards}: need {args.cards} CUDA devices, have "
                               f"{have}")

    from peritext_tpu_torch.testing.fuzz import generate_workload

    probe = generate_workload(args.seed ^ 0xD16, num_docs=16, ops_per_doc=48)
    digests = {}
    for n in args.sizes:
        row = run_size(n, mesh_of(n, device, args.cards), args, probe, device)
        digests[n] = row["probe_digest"]
        print(json.dumps(row), flush=True)
    if len(set(digests.values())) != 1:
        raise AssertionError(f"digest mismatch across meshes: {digests}")
    print(json.dumps({
        "summary": "weak-scaling",
        "sizes": args.sizes,
        "digest_equal_across_mesh_sizes": True,
        "probe_digest": digests[args.sizes[0]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
