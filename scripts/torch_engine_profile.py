#!/usr/bin/env python3
"""Where an engine pass's time goes on one card: the port's twin of
``scripts/engine_profile.py``.

Both granularities run over the same captured-round replay: a live
``StreamingMerge`` with its engine capture armed
(``StreamingMerge._capture_rounds``) records every committed round's
device-ready inputs, which are then applied again with no host parse,
schedule or upload.

* default (coarse): the apply chain (one ``apply_batch_compact`` a round,
  each launching K1) and the digest (``_resolve_block_digest``) apart,
  each behind its own synchronize, and the pass behind one; ``--sweep``
  runs it over round depth x docs to find where the fixed cost bends.
  The port adds the same rounds as ``testing/engine.EngineReplay``: one
  ``apply_batch_compact_rounds`` site call and the digest as one captured
  CUDA graph (pass 1 eager, pass 2 captured, later passes one replay),
  whose digest must equal the session's.
* ``--fine``: a synchronize with nothing queued, a one-op program and its
  read-back, each captured round's apply alone, the chained applies and
  the digest, so a pass splits into launch, compute and sync terms; then
  the fused drain against the same session with ``sync_device()`` after
  every drain: how much of the host's parse the pipelined drain hides
  (``host_parse_seconds``, ``overlap_hidden_s``, ``parse_overlap_ratio``).

Both run under the device profiler (``obs/devprof.py``): ``--devprof-out
PATH`` writes its snapshot as JSON, and ``--ledger PATH`` appends a perf
ledger record (throughput rows + snapshot) that ``python -m
peritext_tpu_torch.obs perf`` reads.  ``--profile DIR`` writes a
``torch.profiler`` trace (CPU and CUDA activities) of one pass into DIR.

    python3 scripts/torch_engine_profile.py [--fine | --sweep] [--device cuda|cpu]

The first line names the device (the card's name and power limit, or
``cpu``).  Host times end in a synchronize; on a card the port adds each
stage's device busy ms (``torch.profiler``'s device events) and the graph
replay's device ms from CUDA events with the host kept ahead.  Exits
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
import torch  # noqa: E402

from peritext_tpu_torch.utils.device import script_device, synchronize  # noqa: E402

ACTORS = ("doc1", "doc2", "doc3")
#: the twin's sweep: (docs, rounds, ops a doc)
SWEEP = ((2048, 4, 192), (2048, 1, 192), (2048, 2, 192), (2048, 8, 192), (2048, 16, 192),
         (512, 4, 192), (8192, 4, 192))


class Staged:
    """A captured-round replay: the live session, its captured rounds
    ``(round_inputs, widths, loop_slots)`` (already on the device), an
    empty state at its capacities, its digest tables, its digest and the
    ops its workload holds."""

    def __init__(self, device, docs, rounds, opd, slots, marks, round_caps=(256, 128, 128)):
        from peritext_tpu_torch.testing.devtime import generate
        from peritext_tpu_torch.ops.packed import empty_docs
        from peritext_tpu_torch.parallel.streaming import StreamingMerge
        from peritext_tpu_torch.testing.arrival import build_arrival

        workloads = generate(0, docs, opd)
        arrival, _ = build_arrival(workloads, rounds, 0, as_frames=True)
        captured = []
        ki, kd, km = round_caps
        s = StreamingMerge(
            num_docs=docs, actors=ACTORS, slot_capacity=slots, mark_capacity=marks,
            tomb_capacity=slots, round_insert_capacity=ki, round_delete_capacity=kd,
            round_mark_capacity=km, device=device)
        s._capture_rounds = captured
        for r in range(rounds):
            s.ingest_frames((doc, b[r]) for doc, b in enumerate(arrival) if r < len(b))
            s.drain()
        self.expected = s.digest()
        if s.overflow_count():
            raise AssertionError(f"engine profile: {s.overflow_count()} overflowed docs would "
                                 "skew the replay")
        self.device, self.session, self.staged = device, s, captured
        self.caps = s.config
        self.state0 = empty_docs(s._padded_docs, slots, marks, tomb_capacity=slots,
                                 map_capacity=self.caps["map_capacity"], device=device)
        self.tables = s._digest_tables(0, s._padded_docs)
        self.row_mask = torch.ones(s._padded_docs, dtype=torch.bool, device=device)
        self.total_ops = sum(len(ch.ops) for w in workloads for log in w.values() for ch in log)

    def apply_chain(self):
        from peritext_tpu_torch.ops.kernel import apply_batch_compact

        st = self.state0
        for (c, i, dl, mk, mp), w, ls in self.staged:
            st = apply_batch_compact(st, c, i, dl, mk, mp, widths=w, insert_loop_slots=ls)
        return st

    def per_doc(self, st):
        from peritext_tpu_torch.parallel.streaming import _resolve_block_digest

        return _resolve_block_digest(st, self.session.comment_capacity, self.row_mask,
                                     *self.tables)[1]

    def digest_of(self, st) -> int:
        from peritext_tpu_torch.testing.engine import replay_digest

        return replay_digest(self.per_doc(st))

    def engine(self):
        from peritext_tpu_torch.testing.engine import EngineReplay

        return EngineReplay(self.staged, self.session._padded_docs, self.caps, self.device,
                            self.tables)


def _device_ms(device, busy, held=None) -> str:
    """On a card, each ``busy`` value's device busy ms per call (the device
    events ``torch.profiler`` records: a round's few hundred launches
    overrun the queue a spin kernel can hold the host ahead of), and each
    ``held`` value's (one graph launch a call) device ms from CUDA events
    with the host kept ahead; on the CPU, "not measured"."""
    if device.type != "cuda":
        return "device busy ms: not measured (cpu)"
    from peritext_tpu_torch.testing.devtime import DeviceBusy, device_time_ms

    with DeviceBusy() as profiled:
        for name, fn in busy.items():
            profiled.measure(name, fn, reps=2)
    line = f"device ms ({profiled.source}): " + ", ".join(
        f"{name} {ms:.4f}" for name, ms in profiled.ms.items())
    if held:
        line += "; device ms (CUDA events, host kept ahead): " + ", ".join(
            f"{name} {device_time_ms(fn, reps=3):.4f}" for name, fn in held.items())
    return line


def measure_engine(rp: "Staged", passes: int = 3) -> dict:
    """The port's graph form of the replay: pass 1 eager, pass 2 captured,
    then ``passes`` replays; each pass's digest must equal the session's."""
    from peritext_tpu_torch.testing.engine import replay_digest

    engine = rp.engine()
    seconds = []
    for _ in range(2 + passes):
        t0 = time.perf_counter()
        got = replay_digest(engine())
        seconds.append(time.perf_counter() - t0)
        if got != rp.expected:
            raise AssertionError(f"engine profile: replay digest {got:#x} != session "
                                 f"{rp.expected:#x}")
    row = dict(eager_ms=seconds[0] * 1e3, capture_ms=seconds[1] * 1e3,
               replay_ms=min(seconds[2:]) * 1e3, digest=f"{got:#010x}",
               graphs=engine.graphs.stats())
    print(f"engine replay: pass 1 (eager) {row['eager_ms']:.3f} ms, pass 2 (capture) "
          f"{row['capture_ms']:.3f} ms, replay {row['replay_ms']:.3f} ms (min of {passes}); "
          f"digest {row['digest']} = session {rp.expected:#010x}; graphs "
          f"{json.dumps(row['graphs'])}")
    return dict(row, engine=engine)


def measure(device, docs, rounds, opd, slots=384, marks=96, passes=3, profile_dir=None):
    """Coarse attribution: apply chain vs digest, each behind its own sync."""
    rp = Staged(device, docs, rounds, opd, slots, marks)

    st = rp.apply_chain()  # warm
    if rp.digest_of(st) != rp.expected:
        raise AssertionError("engine profile: the replayed chain's digest != the session's")
    apply_t, digest_t, total_t = [], [], []
    for _ in range(passes):
        t0 = time.perf_counter()
        st = rp.apply_chain()
        synchronize(device)
        t1 = time.perf_counter()
        dg = rp.digest_of(st)
        t2 = time.perf_counter()
        apply_t.append(t1 - t0)
        digest_t.append(t2 - t1)
        # combined single-sync (the bench row's definition)
        t0 = time.perf_counter()
        dg = rp.digest_of(rp.apply_chain())
        total_t.append(time.perf_counter() - t0)
    if dg != rp.expected:
        raise AssertionError("engine profile: a timed pass's digest != the session's")

    n_staged = len(rp.staged)
    row = dict(docs=docs, rounds=rounds, staged_rounds=n_staged, ops=rp.total_ops,
               apply_s=round(min(apply_t), 4),
               apply_per_round_ms=round(1e3 * min(apply_t) / n_staged, 2),
               digest_s=round(min(digest_t), 4),
               total_s=round(min(total_t), 4),
               ops_per_sec=round(rp.total_ops / min(total_t), 1))
    print(row)
    engine = measure_engine(rp, passes)
    print(_device_ms(device, dict(apply_chain=rp.apply_chain, digest=lambda: rp.per_doc(st)),
                     dict(engine_replay=engine["engine"])))
    if profile_dir:
        profile_pass(rp, Path(profile_dir) / f"engine_{docs}x{rounds}x{opd}.json")
    return row


def profile_pass(rp: "Staged", path: Path) -> None:
    """One apply chain and digest under ``torch.profiler``, its Chrome
    trace written to ``path``; the device time its device events hold, or
    where they hold none, the pass's span between CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    device = rp.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        rp.digest_of(rp.apply_chain())
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    if device.type != "cuda":
        print(f"profile: trace -> {path}; device time: not measured (cpu)")
        return
    from peritext_tpu_torch.testing.devtime import traced_device_ms

    busy_ms = traced_device_ms(prof)
    if busy_ms > 0:
        print(f"profile: trace -> {path}; device busy {busy_ms:.3f} ms in the trace")
        return
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    per_doc = rp.per_doc(rp.apply_chain())
    end.record()
    synchronize(device)
    del per_doc
    print(f"profile: trace -> {path}; the trace holds no device time; CUDA events around "
          f"the pass {start.elapsed_time(end):.3f} ms")


def measure_fine(device, docs, rounds, opd, slots=384, marks=96):
    """Fine attribution with honest syncs: bare sync, per-round applies,
    chained applies, digest."""
    from peritext_tpu_torch.ops.kernel import apply_batch_compact

    rp = Staged(device, docs, rounds, opd, slots, marks)
    print("round widths:", [(tuple(w), ls) for _, w, ls in rp.staged])

    st = rp.apply_chain()  # warm every path
    synchronize(device)
    if rp.digest_of(st) != rp.expected:
        raise AssertionError("engine profile: the replayed chain's digest != the session's")

    # bare read-back of a ready tiny array, then a one-op program and its read-back
    tiny = torch.zeros(8, dtype=torch.int32, device=device) + 1
    tiny.cpu()
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        tiny.cpu()
        rtts.append(time.perf_counter() - t0)
    print(f"bare fetch of ready tiny array: {min(rtts)*1e3:.1f} ms")
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        (tiny + 1).cpu()
        rtts.append(time.perf_counter() - t0)
    print(f"dispatch+fetch tiny:            {min(rtts)*1e3:.1f} ms")

    # each captured round on the empty state alone, behind its own sync
    rounds_ms = []
    for k, ((c, i, dl, mk, mp), w, ls) in enumerate(rp.staged):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            apply_batch_compact(rp.state0, c, i, dl, mk, mp, widths=w, insert_loop_slots=ls)
            synchronize(device)
            ts.append(time.perf_counter() - t0)
        rounds_ms.append(min(ts) * 1e3)
        print(f"round {k} apply (dispatch+sync): {min(ts)*1e3:7.1f} ms  widths={tuple(w)}")

    chain_ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        st = rp.apply_chain()
        synchronize(device)
        chain_ts.append(time.perf_counter() - t0)
    print(f"chained {len(rp.staged)} applies + sync:   {min(chain_ts)*1e3:7.1f} ms")

    digest_ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        dg = rp.digest_of(st)
        digest_ts.append(time.perf_counter() - t0)
    if dg != rp.expected:
        raise AssertionError("engine profile: the digest != the session's")
    print(f"digest (dispatch+sync):         {min(digest_ts)*1e3:7.1f} ms")
    fns = {f"round_{k}": (lambda r=r: apply_batch_compact(rp.state0, *r[0], widths=r[1],
                                                          insert_loop_slots=r[2]))
           for k, r in enumerate(rp.staged)}
    print(_device_ms(device, dict(fns, apply_chain=rp.apply_chain, digest=lambda: rp.per_doc(st))))
    # the pass total is apply chain + digest: the digest loop alone would
    # overstate engine throughput several-fold in the ledger
    total = min(chain_ts) + min(digest_ts)
    return dict(docs=docs, rounds=rounds, staged_rounds=len(rp.staged), ops=rp.total_ops,
                mode="fine", apply_s=round(min(chain_ts), 4), digest_s=round(min(digest_ts), 4),
                total_s=round(total, 4), ops_per_sec=round(rp.total_ops / max(total, 1e-9), 1))


def measure_fused_pipeline(device, docs, rounds, opd, slots=384, marks=96):
    """How much of the host's parse and schedule wall the pipelined drain
    hides behind device work, over the same live workload:
    ``pipelined_s`` (the default drain), ``serialized_s`` (a
    ``sync_device()`` after every drain, so host and device strictly
    alternate) and ``host_parse_s`` (the session's wire-parse wall);
    ``overlap_hidden_s = serialized_s - pipelined_s`` and
    ``parse_overlap_ratio = clamp(hidden / host_parse, 0, 1)``."""
    from peritext_tpu_torch.testing.devtime import generate
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.testing.arrival import build_arrival

    workloads = generate(0, docs, opd)
    arrival, _ = build_arrival(workloads, rounds, 0, as_frames=True)
    total_ops = sum(len(ch.ops) for w in workloads for log in w.values() for ch in log)

    def run(serialize: bool):
        s = StreamingMerge(
            num_docs=docs, actors=ACTORS, slot_capacity=slots, mark_capacity=marks,
            tomb_capacity=slots, round_insert_capacity=64, round_delete_capacity=32,
            round_mark_capacity=32, round_map_capacity=16, device=device)
        t0 = time.perf_counter()
        for r in range(rounds):
            s.ingest_frames((doc, b[r]) for doc, b in enumerate(arrival) if r < len(b))
            s.drain()
            if serialize:
                s.sync_device()
        digest = s.digest()
        return time.perf_counter() - t0, digest, s

    run(False)  # warm
    run(True)
    pipe, dg_a, s_pipe = min((run(False) for _ in range(3)), key=lambda x: x[0])
    serial, dg_b, _ = min((run(True) for _ in range(3)), key=lambda x: x[0])
    if dg_a != dg_b:
        raise AssertionError("fused pipeline: the overlap changed the digest")
    hidden = max(0.0, serial - pipe)
    parse = max(s_pipe.host_parse_seconds, 1e-9)
    row = dict(
        docs=docs, rounds=rounds, staged_rounds=s_pipe.rounds, ops=total_ops, mode="fused",
        pipelined_s=round(pipe, 4), serialized_s=round(serial, 4),
        host_parse_s=round(s_pipe.host_parse_seconds, 4), overlap_hidden_s=round(hidden, 4),
        parse_overlap_ratio=round(min(1.0, hidden / parse), 3),
        ops_per_sec=round(total_ops / pipe, 1))
    print(f"fused pipeline: pipelined {pipe*1e3:7.1f} ms  serialized {serial*1e3:7.1f} ms  "
          f"parse {s_pipe.host_parse_seconds*1e3:6.1f} ms  hidden {hidden*1e3:6.1f} ms  "
          f"overlap_ratio {row['parse_overlap_ratio']}")
    print(f"fused pipeline digest {dg_a:#010x}; graphs {json.dumps(s_pipe._graphs.stats())}")
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fine", action="store_true",
                        help="honest-sync launch/compute/sync decomposition")
    parser.add_argument("--sweep", action="store_true",
                        help="sweep round depth x docs (coarse mode only)")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="write a torch.profiler trace of one pass into DIR")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--docs", type=int, default=2048)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--ops-per-doc", type=int, default=192)
    parser.add_argument("--slots", type=int, default=384)
    parser.add_argument("--marks", type=int, default=96)
    parser.add_argument("--devprof-out", default=None, metavar="PATH",
                        help="write the devprof snapshot (shape buckets, occupancy, memory "
                        "watermarks) as JSON to PATH, the schema the perf ledger stores")
    parser.add_argument("--ledger", default=None, metavar="PATH",
                        help="append a perf-ledger record (throughput rows + devprof "
                        "snapshot) to PATH")
    args = parser.parse_args(argv)
    device = script_device(args.device, "torch_engine_profile")
    if device is None:
        return 2

    from peritext_tpu_torch.obs import GLOBAL_DEVPROF

    was_enabled, was_costs = GLOBAL_DEVPROF.enabled, GLOBAL_DEVPROF.capture_costs
    GLOBAL_DEVPROF.enable(capture_costs=True)
    try:
        return _run(args, device, GLOBAL_DEVPROF)
    finally:
        GLOBAL_DEVPROF.capture_costs = was_costs
        if not was_enabled:
            GLOBAL_DEVPROF.disable()


def _run(args, device, devprof) -> int:
    if args.fine:
        results = [measure_fine(device, args.docs, args.rounds, args.ops_per_doc, args.slots,
                                args.marks),
                   measure_fused_pipeline(device, args.docs, args.rounds, args.ops_per_doc,
                                          args.slots, args.marks)]
    else:
        shapes = SWEEP if args.sweep else [(args.docs, args.rounds, args.ops_per_doc)]
        results = [measure(device, docs, rounds, opd, args.slots, args.marks,
                           profile_dir=args.profile)
                   for docs, rounds, opd in shapes]

    if args.devprof_out:
        with open(args.devprof_out, "w") as fh:
            json.dump(devprof.snapshot(), fh, indent=1)
        print(f"devprof snapshot -> {args.devprof_out}")
    if args.ledger:
        from peritext_tpu_torch.obs import ledger as _ledger

        # fine mode measures a two-sync pass (chain + digest apart), coarse
        # mode a single-sync pass: distinct row identities, so neither
        # pollutes the other's rolling reference
        rows = [
            dict(row=({"fine": "engine_profile_fine", "fused": "fused_pipeline"}.get(
                r.get("mode"), "engine_profile")) + f"[{r['docs']}x{r['staged_rounds']}]",
                 metric="engine_profile_ops_per_sec", value=r["ops_per_sec"], unit="ops/s",
                 docs=r["docs"], rounds=r["rounds"])
            for r in results
        ]
        _ledger.append_record(args.ledger, _ledger.ledger_record(
            rows, config="engine_profile", devprof=devprof.snapshot()))
        print(f"perf-ledger record -> {args.ledger}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
