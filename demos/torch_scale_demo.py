#!/usr/bin/env python
"""Pod-scale streaming demo on the PyTorch/CUDA port: converge N docs on
carried device state.

One collaborative editing session (3 replicas, fuzz-generated) is streamed
to N independent documents as binary wire frames over two arrival rounds —
the config-5 shape of BASELINE.md.  Ingest takes the frame-native fast path
(C++ parse + one-call round scheduling); reads and the convergence digest
resolve the doc axis in memory-bounded blocks, so N scales to 100K docs
(BASELINE.md row 5b: 22.6M ops) on one card, with zero fallbacks or
overflows.  The sessions run on ``peritext_tpu_torch`` (CUDA by default;
``--device cpu`` takes the plain torch path); ``--layout`` picks the storage
layout (padded, paged, ragged).

Run: python demos/torch_scale_demo.py [--docs N] [--layout L] [--device D]
     (default 2000 docs on cuda; try --docs 100000)
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run(docs: int, ops_per_doc: int = 220, seed: int = 200, device: str = "cuda",
        **session_kwargs) -> dict:
    """The demo's session, checked.  ``session_kwargs`` go to
    ``StreamingMerge`` (``layout``, ``read_chunk``).  Returns the digest, per
    arrival round the ingest, drain and digest-schedule seconds and the wait
    for that round's digest, the wall, the final wait, the two sweeps'
    seconds, the patch count, the session's commit counters over the run,
    and the session itself."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.parallel.codec import encode_frame
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.testing.fuzz import generate_workload

    d = docs
    w = generate_workload(seed=seed, num_docs=1, ops_per_doc=ops_per_doc)[0]
    changes = [ch for log in w.values() for ch in log]
    half = len(changes) // 2
    frames = [encode_frame(changes[:half]), encode_frame(changes[half:])]
    expected = _oracle_doc(w).get_text_with_formatting(["text"])
    ops = sum(len(c.ops) for c in changes)

    sess = StreamingMerge(
        num_docs=d, actors=("doc1", "doc2", "doc3"),
        slot_capacity=512, mark_capacity=160, tomb_capacity=192,
        round_insert_capacity=192, round_delete_capacity=96,
        round_mark_capacity=96, device=device, **session_kwargs,
    )
    names = ("block_applies", "group_applies", "ragged_applies", "fused_dispatches")
    start = {n: GLOBAL_COUNTERS.get(f"streaming.{n}") for n in names}
    rounds = []
    t_all = time.perf_counter()
    pending = None
    for frame in frames:
        if pending is not None:
            # fetch LAST round's digest BEFORE this round's ingest mutates
            # any change history (digest_async's precondition for sessions
            # that could hold fallback/overflow docs)
            t0 = time.perf_counter()
            pending.wait()
            rounds[-1]["digest_wait"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess.ingest_frames((doc, frame) for doc in range(d))
        t_ing = time.perf_counter() - t0
        t0 = time.perf_counter()
        sess.drain()
        t_drain = time.perf_counter() - t0
        t0 = time.perf_counter()
        pending = sess.digest_async()  # per-round convergence sync point
        rounds.append(dict(ingest=t_ing, drain=t_drain, digest=time.perf_counter() - t0))
    wall = time.perf_counter() - t_all

    t0 = time.perf_counter()
    digest = pending.wait()
    t_digest = time.perf_counter() - t0
    rounds[-1]["digest_wait"] = t_digest
    assert digest == sess.digest(), "async digest != sync digest"
    for doc in (0, d // 2, d - 1):
        assert sess.read(doc) == expected, f"doc {doc} diverged"
    assert not any(s.fallback for s in sess.docs), "docs demoted to scalar replay"
    # overflowed docs silently read via scalar replay and are masked from the
    # digest — the demo's claim is DEVICE convergence, so none may overflow
    assert sess.overflow_count() == 0, (
        f"{sess.overflow_count()} docs overflowed device capacities"
    )

    # full-sweep reads: every doc's spans and incremental patches in one
    # vectorized pass per block
    t0 = time.perf_counter()
    all_spans = sess.read_all()
    t_read = time.perf_counter() - t0
    assert all(s == expected for s in all_spans), "full-sweep read diverged"
    t0 = time.perf_counter()
    n_patches = sum(len(p) for p in sess.read_patches_all())
    t_patches = time.perf_counter() - t0
    return dict(
        digest=digest, docs=d, doc_ops=ops, total_ops=ops * d, rounds=rounds,
        wall=wall, final_wait=t_digest, read_all_seconds=t_read,
        read_patches_seconds=t_patches, patches=n_patches,
        counters={n: int(GLOBAL_COUNTERS.get(f"streaming.{n}") - v) for n, v in start.items()},
        session=sess,
    )


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--docs", type=int, default=2000)
    parser.add_argument("--ops-per-doc", type=int, default=220)
    parser.add_argument("--seed", type=int, default=200)
    parser.add_argument("--layout", choices=("padded", "paged", "ragged"), default="padded")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the session (default cuda; raises without a card)")
    args = parser.parse_args(argv)

    d = args.docs
    out = run(d, args.ops_per_doc, args.seed, args.device, layout=args.layout)
    total_ops = out["total_ops"]
    print(f"{d} docs x {out['doc_ops']} ops ({total_ops / 1e6:.1f}M total), 2 arrival rounds "
          "of wire frames\n")
    for r, rnd in enumerate(out["rounds"]):
        print(f"round {r}: ingest {rnd['ingest']:.1f}s, device rounds {rnd['drain']:.1f}s, "
              f"digest scheduled in {rnd['digest'] * 1000:.0f}ms (async)")
    wall = out["wall"]
    print(f"\nconverged ON DEVICE: digest {out['digest']:#010x} "
          f"(final wait {out['final_wait']:.2f}s; per-round sync is the async schedule above)")
    print(f"{total_ops / 1e6:.1f}M ops in {wall:.1f}s "
          f"({total_ops / wall / 1e3:.0f}K ops/s end-to-end incl. host ingest)")
    print(f"full span sweep {out['read_all_seconds']:.1f}s, full patch sweep "
          f"{out['read_patches_seconds']:.1f}s ({out['patches']} patches) across {d} docs")
    print("ALL docs verified against the scalar oracle; 0 fallbacks")


if __name__ == "__main__":
    main()
