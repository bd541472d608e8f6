#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card, and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's error is passed over):

1. card: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the paths, one nvcc each, all at once, and
   the package's native host library (g++), which must load; a build
   sentinel (``obs.RecompileSentinel``) armed here counts the whole run's
   builds and loads, and at the end each library must have loaded exactly
   once and built at most once;
3. padded slice: ``DocBatch(device="cuda").merge`` with cursors on 1024
   fuzz docs x 256 ops (BASELINE config 3; slots 512, marks 128, comment
   ids 64), with the launch counts set to 0 just before and read just
   after; no doc may fall back, and spans, roots and cursors must equal
   the scalar oracle on a seeded sample of 64 docs;
4. pooled slice: the same 1024 docs plus a long tail of 8 docs x 1024 ops
   merged through each layout (padded, paged, ragged; slots 1024, marks
   512, comment ids 64, pages of 64 slots), each with the launch counts
   set to 0 just before and read just after: the ragged merge launches the
   ragged insert kernel once per non-empty doc class of its plan (warp
   team, block team) and the padded one never, the paged merge the padded
   one once per page-bucket group; no doc may fall back; paged and
   ragged must equal padded on every doc, and a seeded sample of 64 docs
   the scalar oracle;
5. streaming: ``StreamingMerge(device="cuda")`` (BASELINE config 5, the
   reference's streaming bench row: 2048 fuzz docs x 192 ops, 4 shuffled
   arrival rounds; per round ingest, then ``drain()``; then ``digest()``,
   ``read_all()`` and ``read_patches_all()``).  An untimed warm-up session
   (by frames), then session A in two object-ingest arms (default and
   ``fused_pipeline=False``; phase 5m's stacked arms drive the
   ``static_rounds=True`` commit form, by frames) that must agree, and its
   frame arm (the
   reference bench's default wire path: each round's batch of a doc as one
   v2 wire frame, one ``ingest_frames`` call per round, parsed and
   scheduled by the native library, which must have served it), which
   must equal A on every doc; B, A's workload in read blocks of 512 docs,
   must equal A; C, 10240 docs in two blocks of 8192 by frames (C_frames),
   and its object arm on its first 5120 docs in two blocks of 4096, which
   must agree with C_frames on those docs.  Each session's insert launches, counted
   from 0 over its run, must equal its applies (one per touched block of
   every committed round); A, C and their frame arms must keep digest() ==
   digest(refresh=True) == the sum of doc_digest(), and a seeded sample of
   64 docs (with every fallback doc) must equal the scalar oracle in
   spans, roots, cursors and the host mirror's digest, and
   digest_async().wait() must equal digest();
5b. streaming layouts: A in the paged and the ragged layout (pages of 64
   slots), by objects and by frames, each equal to A on every doc; B in
   the paged layout with a ``reshard()`` after its second round (4
   blocks), equal to A, its digest unchanged by the reshard; C's frame arm
   in the ragged layout at full width (16384 rows), equal to C_frames;
   and the long-tail session (the reference bench's ``longdoc`` shape:
   1024 docs x 8 ops and one essay of 3072 ops, slots 8192, by frames in
   4 rounds) in all three layouts, paged and ragged equal to padded on
   every doc, the essay overflowed and replayed on the host in each.  A paged session launches the insert kernel once per (round,
   page group) (``streaming.group_applies``) and never the ragged one; a
   ragged session the ragged insert kernel once per non-empty doc class of
   each round's plan (``streaming.ragged_applies``) and never the padded
   one.  Each session prints its ``health()`` and passes phase 5's checks;
   C_frames, C_frames_ragged and A_paged_frames are saved where they end
   (``save_session``);
5h. device planes (:data:`PLANES`): A_frames three times disarmed and
   three times with the device profiler armed without costs, interleaved
   (the ratio of the medians of their rounds' seconds is printed, a
   reading); an armed ``apply_batch_compact`` on a captured round of A
   under ``device_time_ms``, which fails if a hook waits for the card;
   then A_frames, A_paged_frames and C_frames_ragged with
   ``GLOBAL_DEVPROF`` armed with costs, a ``RecompileSentinel`` and a
   ``MetricsServer``, each equal to its earlier arm's digest: per site
   the dispatches equal the commits (one fused form's call per committed
   batch, ``streaming.fused_dispatches`` for the padded
   ``apply_batch_staged_rounds``, the graph cache's calls for the paged
   ``apply_batch_paged_groups``; one ``apply_batch_ragged`` call per round
   of the block-chunked C_frames_ragged), the sites' launches (dispatches x each bucket's
   ``kernel_launches``) equal the commit counters and the kernels' own
   launch counts, the occupancy table's real ops the session's applied
   ops, the page-pool section the session's ``pool_stats()``, the memory
   watermarks are the allocator's (available, a peak above 0), every
   bucket has device ms and bytes above 0, nothing is built or loaded
   after the first round and no more graphs are captured than the
   session's cache holds, and ``/metrics``, ``/devprof.json`` and
   ``/health.json`` answer with the reference's golden key sets; the
   bucket table is printed (device ms against ``kernel_bytes`` over HBM
   bandwidth); one ``ledger_record`` of the sessions' rows with the
   profiler's snapshot names this card (platform ``gpu``); each row
   carries the session's stage decomposition (``latency.stages_ms``);
5i. planner and CLI (:data:`PLANNER`), over 5h's snapshot and ledger
   record: ``plan.propose`` twice (identical JSON), and ``python -m
   peritext_tpu_torch.obs plan --json`` in a subprocess, whose exit code
   must be the proposal's ``beats_current()`` and whose proposal must be
   the in-process one (a garbage snapshot exits 2); the observed and
   proposed statics, the modeled terms and ``budget_bytes`` are printed;
   then A's frames replayed at the proposal's stream widths and slot
   capacity on a padded and a ragged session (the proposal's page size),
   each equal to A in every doc's spans and patches and in the digest
   (corrected for the pad term of the slot capacity), the docs sent to the
   oracle printed; a ``MetricsServer`` with ``GLOBAL_DEVPROF`` and the
   proposal over the ragged replay, whose ``obs status --json`` exits with
   its worst row and has one row per JSON route; ``obs perf --gate`` on
   the card record twice exits 0, and with one row made slower than the
   band (TestPerfGate's 60% drop, each stage 2.5x) ``perf --gate`` and
   ``obs why`` exit 1, ``why`` naming the stage that grew most; within
   20 s;
5j. the device mesh (:data:`MESH`): ``make_mesh(4)`` over ``cuda:0..3``
   where four cards exist, else a virtual mesh of 4 shards on ``cuda:0``
   (asked for explicitly; the phase prints which): (a) ``DocBatch(mesh=)``
   on config 3, equal to phase 3's merge in spans, roots, cursors and the
   fallback set, with one K1 launch per shard; (b) A's frames over the
   mesh in the padded, paged and ragged layouts on the fused drain (per
   shard one staged upload and one site call a batch, through the
   shard's own graph cache), each equal to A on every doc and passing
   phase 5's checks, and to its per-round mesh twin
   (``fused_pipeline=False``, which stages nothing), its launches equal
   to its commit counter (K1 once per (round, shard) of a padded batch
   and once per (round, shard, page group) of a paged one, K3 once per
   (round, non-empty doc class) of each shard that holds an op in the
   batch), its session ops/s and graph statistics per shard printed
   beside A_frames'; (d) a reshard of the paged mesh session: digest and reads
   unchanged, no character changed, the pages moved between shards
   counted (``store.ici_page_moves``); (c) C's frames at full width over
   the mesh (10,240 docs, 4 shards of 2,560 rows), equal to C_frames and
   to its per-round mesh twin, with each card's peak memory; (f) A's
   workload in ``fine_rounds`` arrival rounds over the padded mesh, equal
   to A, every shard's graph cache replaying and hitting; (e)
   ``run_crash_restore`` seed 12 with the mesh, restored meshless; the
   kernel inputs of one round of a shard (padded: K1; ragged: K3) are
   captured for phase 6; within 120 s;
5k. the scalar baseline and the engine replay (:data:`BASELINE`): (a) the
   C++ scalar apply (``native.scalar_apply``, one host core) at the
   reference bench's baseline shape, 16 fuzz docs x 256 ops at seed 7, its
   op matrices from ``testing/baseline.py``, every doc equal to the oracle,
   its ops/s the best of 3 sweeps of 20 repetitions; the same docs through
   ``DocBatch(device="cuda").merge``, one K1 launch, each doc's text equal
   to the scalar apply's; (b) the reference bench's engine row at
   A_frames' shape: a session with the engine capture armed
   (``_capture_rounds``), no fallback and no overflowed doc, equal to A
   and its digest to A_frames', and its uncaptured twin; the captured
   rounds replayed on the card (``testing/engine.EngineReplay``: every
   round in one ``apply_batch_compact_rounds`` call over resident buffers;
   the first pass eager, the second captures a CUDA graph, every later
   pass one replay), the digest equal to the session's on every pass, one
   K1 launch per captured round of each pass, counted from 0, the graph
   cache's counts exact; the eager and capture passes' seconds,
   single-pass ops/s (best of 3 replays) and steady ops/s (``passes``
   replays enqueued back to back, synced once) beside both sessions'
   end-to-end ops/s (ingest to digest); the inputs of the third round's
   insert call of a fresh replay are kept for phase 6; within 30 s;
5l. the fused round pipeline (:data:`FUSED_PIPE`) at A_frames' shape:
   A_frames (the fused default) and its per-round twin
   (``fused_pipeline=False``), both equal to A_frames' digest and to A:
   one pinned host-to-device copy per committed batch (the per-round twin
   none through the lane), K1 launches equal to the commit counters, the
   drain wall and ``streaming.apply`` seconds of each; A's workload cut
   into ``fine_rounds`` arrival rounds, padded and paged, so signatures
   repeat: graph captures, replays and hits per form, a forced reshard
   (over two read blocks, then one again) after ``reshard_after`` rounds
   that must bump the graph epoch and be followed by new captures, a page
   pool (pages of 32 slots, one page a doc to start) that grows between
   drains, bumping the paged session's epoch;
   both equal to A; A_frames on the ragged layout, fused and per round,
   both equal to A_frames' digest and to A, one staged copy per batch (the
   graph cache's calls; the ragged forms count no fused dispatch, as the
   reference's) and none for the twin; the fine arrival on a ragged
   session whose pool grows likewise, replaying and hitting, no signature
   captured twice within a graph epoch, equal to its per-round twin, the
   ragged insert's inputs of the first round of a replayed batch kept for
   phase 6; the engine replay's eager, capture, single-pass and steady
   seconds of phase 5k beside the 51.6 ms of a host-enqueued pass; within
   50 s;
5m. the capture audit (:data:`CAPTURE_AUDIT`): phases 5j to 5m run with
   the capture audit armed (``testing/capture_audit.CaptureAudit`` on every
   graph cache), so the first capture of each (form, site) runs under the
   thread's profiler, which lists every package function run inside it;
   5m drives, on A's fine arrival at A_frames' shape, each listed form the
   earlier phases left uncaptured (the padded forms' digest twins, the
   stacked form and its multi-tenant twin, the paged mesh form), each
   session equal to A; then a ``capture audit`` line (per form and site,
   the functions seen and those outside the set the traced-code rules
   scan), which must cover every listed form with none outside; within
   90 s (the port's analysis CLI, static and host-only, is held by
   ``tests/test_torch_analysis.py``, not run here);
5c. bridge: the editor bridge's device backend, ``Editor(backend="tpu")``
   on ``cuda`` (each transaction one ``ingest``, ``drain()`` and
   ``read_patches``): the nine ``tests/pm_fixtures`` sessions through two
   such editors each, equal to their ``expected_doc``; a fuzzed session of
   1000 transactions through ``bridge/commands.py`` on three of them and a
   scalar editor, the oracle (:data:`BRIDGE`), every view equal to the
   oracle's and to its own CRDT render, no doc demoted or overflowed, with
   dispatch and remote-apply latency; and two editors with
   ``start_queue=True`` that must converge by timer flushes alone.  Every
   insert launch of the phase is one block apply;
5d. durability: the three saved sessions restored on the card
   (``restore_session``), each equal to its source in ``digest()``,
   ``digest(full=False)``, ``read_all()``, a fresh ``read_patches_all()``,
   ``frontier()``, ``pending_count()`` and its fallback set, with its
   launches equal to its commit counter over the restore, and its save and
   restore seconds, checkpoint bytes and peak memory; ``run_crash_restore``
   at seeds 11 and 12 (64 docs x 120 ops); and ``DocBatch(guard=True)`` on
   the padded slice's docs: without a fault it launches the insert kernel
   and equals the unguarded merge; one injected failure at the kernel
   wrapper raises on the card, guarded or not (the guard never moves a
   card's work to the CPU), and degrades only a CPU batch, which then
   replays all docs through the oracle with equal results;
5e. serve: the serving tier (``serve/``) over padded static-round sessions
   on ``cuda`` (:data:`SERVE`): (a) the reference bench's
   ``serve_sustained`` row at its own shape, 64 client sessions on one
   ``SessionMux``: the warm-up walk of batch sizes, the open-loop
   ``sustained_ladder`` with its midpoint rung, and a traced rung with the
   latency and history planes armed, whose stage decomposition must be
   sum-consistent with no negative stage (docs/s at the SLO, the
   sustained and breaking rungs, ``stages_ms``, the window); then one hot
   client whose session quota sheds past the mux's demotion threshold,
   whose doc must stay on the card (the sheds stay backpressure) and equal
   a plain session on the CPU and the oracle; (b) the same
   server at config 5's width, 2048 sessions: a ladder, then a full feed
   of every session's frames through the mux, which must equal a plain
   session fed the same frames (``digest()``, ``digest(full=False)``,
   ``read_all()``, ``mux.read`` on a seeded sample of 64) and, on that
   sample, the scalar oracle, with no doc off the card (peak memory);
   (c) ``GuardedSession`` over session A's shape on the card, fed A's four
   frame rounds, recovering from one injected failure and one injected
   delay past its deadline by rollback, equal to A_frames, with no scalar
   degradation; then a persistent fault that raises on the card without
   demoting a doc and degrades a CPU session to the oracle.  Each part's
   insert launches equal its block applies (the abandoned round of (c)
   waited for first);
5f. fused and fleet serving (:data:`FUSED`, :data:`FLEET`), on ``cuda``:
   (a) the reference bench's ``serve_multitenant`` row at its own shape:
   32 one-doc tenants on one ``FusedMuxGroup`` lane against 32 standalone
   muxes, same frames and windows, both arms walked once and then
   measured; every tenant's patch stream equal to its twin's, the armed
   latency plane sum-consistent, occupancy rows in the history plane
   (dispatches of both arms and their ratio, walls, p99 apply latencies);
   (b) the group at config 5's width: serve_2048's workload as 256
   tenants x 8 docs on a padded (1024 rows), a paged (512) and a ragged
   (512) lane, on the same alternating windows: each lane equal to a plain
   session of its layout fed the same frames in the same windows, 16
   tenants equal to standalone muxes, 64 docs to the oracle, no doc off
   the card, K1 launches equal to the block plus group applies and K3
   launches to the ragged applies (``fusion_snapshot()``, window walls,
   peak memory); (c) the host-kill failover episode over TCP ship
   endpoints: 3 ``FleetHost``s of 1536 rows, 2048 docs, 16 migrations and
   a rebalance at half the frames, then the busiest host killed: typed
   verdicts with ``submitted == admitted + delayed + shed``, acked ops
   surviving on 64 sampled victim docs before any retry, every doc's
   digest and the fleet-wide sum equal to a fault-free session after the
   resubmissions, 64 docs equal to the oracle, K1 launches over the hosts
   equal to their block applies (applied frames/s, detection rounds,
   failover docs and seconds, ships, migrations, rollbacks); and the
   reference episode's incident plane: a private ``IncidentMonitor`` and
   ``TimeSeriesPlane`` fed once per frontend round open exactly
   ``['host-death']`` within ``2 * lease_rounds + 2`` monitor rounds,
   resolve it after the heal, flag the delay/shed anomaly no later, and
   the frontend's flight dumps merge into one timeline (detection rounds,
   the monitor's digest); after the heal the frontend is mounted on a
   ``ReplicaServer(metrics_port=0, fleet=...)`` and one ``/fleet.json``
   scrape must read its hosts, docs, failovers and rounds;
5g. chaos and differential fuzz (:data:`CHAOS`), every session on
   ``cuda``: the port's ``testing/chaos.py`` episodes at the shapes the
   reference runs them (``run_chaos`` seeds 0-3 at its defaults, the
   mid-drain kill, the mark-heavy campaign, the divergence injection, the
   serving-tier overload, the reference bench's ``reconnect_storm``,
   ``fleet_serve`` and ``fleet_heal`` rows, the last with host0's
   ``/metrics`` lag scrape), each passing its own oracles;
   ``run_differential`` at ``make fuzz``'s shape on a padded and on a
   ragged ``DocBatch`` and ``run_differential_frames``, each against the
   scalar oracle; each path's launches counted from 0 over its run (a
   session's K1 launches equal its block applies); one chaos drain under
   ``obs.profile_trace``, whose trace must hold an insert-kernel event;
5n. demos (:data:`DEMOS`), the port's own front doors, each loaded from
   its file in ``demos/``: (a) config 5b's session through
   ``torch_scale_demo.run`` (the JAX demo's fuzz sessions of 226 ops, seed
   200) at 16,384 docs (two read blocks: the block-chunked serial drain)
   padded, paged and ragged, every assertion of the demo holding (the
   async digest equals the sync one, every ``read_all`` doc equals the
   oracle, no fallback, no overflow), its frames parsed and scheduled by
   the native library, one digest across the layouts, K1 launches = the
   block or group applies, K3 = the ragged applies; per round the ingest,
   drain and digest seconds, the wall and end-to-end ops/s, the sweeps,
   the peak memory (config 5b at its full 100,000 docs runs in
   ``scripts/torch_scale_layouts.py``, a chip call of its own); (b)
   ``web/torch_server.Handler`` on 127.0.0.1:0 over
   ``Session(backend="tpu")``: tests/test_web_demo.py's requests and
   ``web_cycles`` edit-and-sync cycles, every answer equal to a scalar
   session's, the page the file on disk, both panes converged, K1 = block
   applies = the editors' rounds, each route's latency p50/p99; then
   ``web/torch_essay_server`` with ``backend="tpu"`` playing the whole
   essay trace through ``/step``, both editors equal to a scalar session's
   essay, steps/s; (c) ``torch_multihost_demo.run``: three TCP hosts
   converge to one digest; (d) ``torch_two_editors --backend tpu`` on the
   card prints what ``--device cpu`` prints; each part's launches counted
   from 0;
5o. scripts (:data:`SCRIPTS`): the JAX side's measurement scripts as the
   port's ``scripts/torch_*.py``, each loaded from its file and run through
   its ``main`` on ``cuda`` at the smallest size that still launches K1:
   dispatch latency, apply phase cost and its floor probe, roofline,
   engine profile, engine A/B, ingest profile, weak scaling at 1, 2 and 4
   virtual shards on the card, and two chaos seeds at their defaults; every
   exit code 0, the engine profile's and the engine A/B's replay digests
   equal to their sessions' and to each other, the weak-scaling probe
   digest one value at every size, both chaos seeds clean; each script's
   K1 launches counted from 0 (each > 0; the ingest profile's = its block
   applies) and, for phase 6, the insert inputs of the engine profile's
   first replayed round;
5p. smokes (:data:`SMOKES`): the JAX side's CI smokes and append A/Bs as
   the port's ``scripts/torch_*.py``, each loaded from its file and run
   through its ``main`` on ``cuda`` at the twin's defaults, each smoke's
   artifacts written under a temporary directory: obs, paged, ragged,
   fused, mesh (1/2/4/8 virtual shards of the card), plan, serve, latency,
   incident, history, fleet and fleet-serve, then the append and flat
   append A/Bs; every exit code 0, the card named first, each script's
   launches counted from 0 (K1 and K3 as its layouts give them, none for
   the host-only fleet episode and the flat A/B), the A/B arms equal, the
   phase within its time limit;
6. kernels: each kernel against its plain torch version on the card, bit
   for bit, at the inputs each merge above gives it (for the insert kernel
   the padded slice's, the pooled padded merge's and each paged group's,
   gathered pages, padding rows and null-page entries included; for the
   ragged one the ragged merge's and one streaming round of ragged
   C_frames; for the insert kernel also one streaming round of A and one
   of A's frame arm, each at its ``loop_slots``, every page group of one
   streaming round of paged A, one editor round of the bridge's fuzzed
   session, one committed mux round of the serve phase's full feed, the
   fused padded lane's round in a sparse window, every page group of the
   fused paged lane's round there, one failover re-drain round of a
   fleet host and the first round of chaos seed 0; for the ragged one also
   the first round of the ragged restore, the fused ragged lane's round in
   the sparse window and the first call of the ragged differential; and
   each the captured round of a mesh shard of phase 5j; for the insert
   kernel also the third replayed round of phase 5k and the first block
   round of 5n's padded demo session; for the ragged one also the first
   round of a replayed ragged batch of phase 5l and the first round of 5n's
   ragged demo; for the insert kernel also the engine profile's first
   replayed round in phase 5o)
   and at larger shapes: for the insert
   kernel the ``batch_8k`` bench shape (8192 docs x 384 slots x
   179 inserts, with and without ``loop_slots``), the forced global-memory
   variant and a long-doc shape past the shared-memory budget; for the
   ragged insert kernel ``batch_8k_ragged`` (the same streams over a page
   pool), ``mixed_10k`` (10240 docs of 179, 1024 and 4096 inserts in
   pages of 64, also with the global-memory variant forced) and
   ``long_doc_ragged`` (64 docs x 32768 slots x 4096 inserts, whose window
   takes the global variant unforced); with the kernel's device time
   (CUDA events with the host kept ahead: ``device_time_ms``), its time
   per back-to-back call from an idle card, host work included
   (``call_ms``), the plain version's time per call, the least time the
   card could take (bound), and each call's launches with their teams
   (threads per doc, docs per block).

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

sys.path.insert(0, str(ROOT))
from peritext_tpu_torch.testing.devtime import (  # noqa: E402
    Generation, cuda_time_ms, device_time_ms, workload)

#: H100 SXM peaks (NVIDIA data sheet; Hopper white paper for int32): HBM3
#: bandwidth, and int32 ALU issue (132 SMs x 64 int32 lanes x 1.98 GHz boost)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

BATCH_8K = dict(docs=8192, slots=384, inserts=179)
LONG_DOC = dict(docs=64, slots=32768, inserts=4096)
#: BASELINE config 3 at the reference's differential capacities, but with 64
#: comment ids: at 32, one doc of this seed (35 distinct attrs) falls back
SLICE = dict(docs=1024, ops=256, slot_capacity=512, mark_capacity=128,
             comment_capacity=64, sample=64, seed=7)
#: the pooled layouts' merge: config 3 plus a long tail, at capacities the
#: long docs fit (340-370 inserts, 285-320 mark ops, up to 64 attrs each)
POOLED = dict(tail_docs=8, tail_ops=1024, tail_seed=8, slot_capacity=1024,
              mark_capacity=512, comment_capacity=64, page_size=64, sample=64)
#: BASELINE config 4's scale ("10K-doc batch, mixed ops ... 4K ops/doc") as
#: a mixed drain: (docs, inserts per doc, synth seed) per size class
MIXED_10K = dict(slots=4096, groups=((9216, 179, 1), (896, 1024, 2), (128, 4096, 3)))
LONG_DOC_RAGGED = dict(docs=64, slots=32768, inserts=4096, seed=2)
#: the long-tail session: the reference bench's ``longdoc`` row (bench.py
#: --mode longdoc, defaults 1024 x 8 and 8192; docs from seed 1, the essay
#: from seed 90001; slots: the power of two covering the bench's 8192-op
#: essay; marks: 8192 / 4) moved to streaming: 4 shuffled arrival rounds by
#: v2 frames; the round widths are session A's, which every change fits
#: (checked).  One cut, for the time limit: the essay has 3072 ops, not
#: 8192 (the capacities stay the bench's; 4096 before phase 5n).  It
#: overflows at these capacities (more mark ops and comment ids than the
#: tables hold; checked in every layout), so every session replays it on
#: the host, a cost that grows faster than the essay: at 8192 ops 118 s a
#: session on an H100 machine's host, at 6144 ops 45-56 s, at 4096 ops
#: 12.8-29 s
LONGTAIL = dict(docs=1024, ops=8, seed=1, essay_ops=3072, essay_seed=90001, rounds=4,
                slot_capacity=8192, mark_capacity=2048, tomb_capacity=8192,
                comment_capacity=64, page_size=64, round_caps=(256, 128, 128, 16), sample=64)
#: the streaming sessions: BASELINE config 5 as the reference's streaming
#: bench row (2048 fuzz docs x 192 ops, seed 0, 4 arrival rounds, shuffle
#: model; slots 384, marks 96, round widths 256/128/128/16), by object
#: ingest and by the bench's default wire path (v2 frames); B the same with
#: read blocks of 512 docs; C 10240 docs at the default block of 8192 (two
#: blocks, 16384 rows), its object arm cut to its first ``c_object_docs``
#: docs in two blocks of ``c_object_read_chunk`` (for phase 5n: 25.1-29.1 s
#: at 10240 docs on an H100 machine's host, the object schedule 92% of it)
STREAM = dict(docs=2048, ops=192, seed=0, rounds=4, slot_capacity=384, tomb_capacity=384,
              mark_capacity=96, comment_capacity=32, round_caps=(256, 128, 128, 16),
              sample=64, b_read_chunk=512, c_docs=10240, c_object_docs=5120,
              c_object_read_chunk=4096, wire="v2")


#: the bridge phase's fuzzed editing session: three ``"tpu"`` editors and
#: one scalar editor (the oracle, which only receives) on one document
#: seeded with 40 words; 1000 transactions (typing runs of 1-3 characters
#: 62%, deletes of 1-2 characters 22%, bold and italic toggles, links from
#: 8 urls and comments over 24 ids, spans of 2-40 characters, 16%), each
#: through ``bridge/commands.py``, on a random one of the three; every
#: editor syncs after every 20th.  The sessions get the reference's round
#: widths with 4096 slots and 512 mark rows (what 3000 transactions of this
#: mix need: about 3800 characters inserted, 480 mark ops) and 2048
#: tombstone rows (about 1000 characters deleted; the reference's default
#: of 128 would overflow).  Cut from 3000 transactions for the time limit
#: (to 1500, then to 1000 to make room for phase 5i, then to 500 for phase
#: 5n): every read decodes the whole document, so the session's cost grows
#: faster than its length (256-315 s at 3000 on an H100 machine, 61.9 s at
#: 1000).
#: ``capture_at`` is the transaction whose insert call is held against the
#: plain version
BRIDGE = dict(editors=("e0", "e1", "e2"), transactions=500, sync_every=20, seed=3,
              initial_words=40, comment_ids=24, urls=8, capture_at=375,
              backend_config=dict(slot_capacity=4096, mark_capacity=512, tomb_capacity=2048))
#: durability: the sessions checkpointed where they end and restored in
#: the durability phase, the crash campaign's seeds and size, and the docs
#: of the padded slice a faulted CPU batch of the guarded merge replays
#: through the oracle (cut from all 1024 for phase 5n: 16.3 s at 1024 on an
#: H100 machine's host; the card's guarded merges keep all 1024)
DURABLE = ("C_frames", "C_frames_ragged", "A_paged_frames")
CRASH = dict(seeds=(11, 12), docs=64, ops=120)
GUARDED_CPU_DOCS = 256
#: phase 5e, the serving tier: ``row`` is the reference bench's
#: ``serve_sustained`` row at its own shape (``bench.py --mode serve``
#: defaults: 64 docs x 96 ops, workload seed 11; each doc's changes in v2
#: frames of 6; capacities max(256, 4 ops), max(64, ops), max(128, ops);
#: round widths 128/64/64; static rounds; a queue of max(256, 4 docs) with
#: no session quota; rates 50 * 2**i for i < 12 in rungs of 1.5 s against a
#: 250 ms p99 apply-latency SLO, one midpoint rung, then a traced rung with
#: a read every 4th pump); ``wide`` the same server at config 5's width
#: (2048 docs x 192 ops, a ladder of at most 8 rungs from 400 frames/s),
#: then a full feed whose ``capture_pump``-th pump's round is held against
#: the plain insert.  No rung runs uncounted first: the bench's ``warmup=2``
#: keeps XLA compiles out of its percentiles, and a torch session compiles
#: nothing; the warm-up walk of batch sizes runs before each ladder
SERVE = dict(row=dict(docs=64, ops=96, base_rate=50.0, rungs=12),
             wide=dict(docs=2048, ops=192, base_rate=400.0, rungs=8, sample=64, capture_pump=10),
             seed=11, frame_changes=6, round_caps=(128, 64, 64, 16), rung_seconds=1.5,
             slo_ms=250.0, read_every=4)
#: phase 5e (c), the supervisor: session A's shape (:data:`STREAM`) under
#: ``GuardedSession`` with a fixed watchdog deadline, an injected delay past
#: it, and the persistent fault's session size
SUPERVISED = dict(deadline=5.0, delay=7.0, persistent_docs=64)
#: phase 5f, fused and fleet serving.  ``row`` is the reference bench's
#: ``serve_multitenant`` row at its own shape (``bench.py --mode
#: serve-fused`` defaults: 32 one-doc tenants x 96 ops from workload seed
#: 13; each doc's changes, sorted by actor and seq, in 6 strided frames;
#: every tenant active in even windows, every 4th in odd ones, then a tail
#: window; capacities max(256, 4 ops), max(64, ops), max(128, ops); round
#: widths 128/64/64; one padded static-round lane against 32 standalone
#: muxes).  ``wide`` is the group at config 5's width: serve_2048's
#: workload (:data:`SERVE` ``wide``: 2048 docs x 192 ops, seed 11, v2
#: frames of 6 changes, its capacities) as 256 tenants of 8 docs, 128 on a
#: padded lane of 1024 rows, 64 on a paged lane of 512 (pages of 64) and 64
#: on a ragged lane of 512, on the same alternating full and sparse windows
#: until every frame is in.  ``fleet`` is the reference's host-kill
#: failover episode (``testing/chaos.py`` ``run_host_kill_failover``, the
#: ``fleet_serve`` row's) at the same width: 3 hosts with TCP ship
#: endpoints on 127.0.0.1, each a mux over a padded static-round session of
#: 1536 rows, leases of 2 rounds, a checkpoint every 4; at half the frames
#: 16 directed migrations and one rebalance, then the busiest host killed,
#: with the episode's incident and history planes armed
FUSED = dict(row=dict(tenants=32, ops=96, seed=13, windows=6),
             wide=dict(tenants=256, docs=8, lanes=(("padded", 128), ("paged", 64), ("ragged", 64)),
                       lane_capacity=1024, sample_tenants=16, sample_docs=64, seed=5))
FLEET = dict(hosts=3, rows=1536, lease_rounds=2, checkpoint_every=4, migrate=16, sample=64,
             seed=7)
#: phase 5g, the chaos harness and the differential fuzz on the card, each
#: at the shape the reference runs it: ``run_chaos`` at its defaults (6 docs
#: x 40 ops) for seeds 0-3, and the mid-drain kill, the mark-heavy campaign,
#: the divergence injection and the serving-tier overload for one seed at
#: theirs; the reference bench's ``reconnect_storm`` row (``bench.py --mode
#: storm``: seed 3, 8 docs x 64 ops, a backlog of 4000 ops, 250 frames/s for
#: 1.5 s), its ``fleet_serve`` row (``--mode fleet-serve``: seed 29, 3 hosts,
#: 8 docs x 48 ops, TCP ship endpoints) and its ``fleet_heal`` row (4 hosts,
#: seed 0, with host0's ``/metrics`` lag scrape); ``run_differential`` at ``make fuzz``'s
#: defaults (32 docs x 160 ops; slots 512, marks 128, comment ids 32) for
#: seeds 0-3 on a padded and on a ragged ``DocBatch`` (pages of 64), and
#: ``run_differential_frames`` at the same shape for seeds 0-1
CHAOS = dict(chaos_seeds=(0, 1, 2, 3), seed=0,
             storm=dict(seed=3, backlog_ops=4000, num_docs=8, ops_per_doc=64,
                        serve_rate_per_s=250.0, storm_duration_s=1.5),
             failover=dict(seed=29, hosts=3, num_docs=8, ops_per_doc=48, transport=True),
             fleet_heal=dict(seed=0, hosts=4),
             differential=dict(seeds=(0, 1, 2, 3), docs=32, ops=160,
                               capacities=dict(slot_capacity=512, mark_capacity=128,
                                               comment_capacity=32)),
             frames_seeds=(0, 1))
#: phase 5h, the device planes, on session A's and C's frames (:data:`STREAM`):
#: ``overhead_pairs`` runs of A_frames disarmed and armed (costs off),
#: interleaved; then A_frames, A_paged_frames and C_frames_ragged with costs
#: captured, a build sentinel and a mounted metrics server; ``sync_reps``
#: calls of an armed ``apply_batch_compact`` under :func:`device_time_ms`:
#: one, since a call queues hundreds of small kernels (the delete, mark and
#: map phases), and more calls queued behind the spin fill the stream's
#: launch queue, so the host blocks as if a call had synchronized
PLANES = dict(overhead_pairs=3, sync_reps=1,
              sessions=(("A_frames", "padded", "apply_batch_staged_rounds"),
                        ("A_paged_frames", "paged", "apply_batch_paged_groups"),
                        ("C_frames_ragged", "ragged", "apply_batch_ragged")))
#: phase 5i, the planner and the ``obs`` CLI over 5h's snapshot and record:
#: the phase's time limit, and the factor that makes a row of the card
#: record regress (the reference's TestPerfGate drops 1000 ops/s to 400;
#: ops/s regress below half the reference)
PLANNER = dict(seconds=20.0, regress=0.4)
#: phase 5j, the device mesh: 4 shards (``cuda:0..3`` where four cards
#: exist, else 4 virtual shards on ``cuda:0``), the crash campaign's seed,
#: and the phase's time limit
MESH = dict(shards=4, crash_seed=12, seconds=120.0)
#: phase 5k, the scalar baseline and the engine replay.  ``scalar``: the
#: reference bench's native baseline at its own shape (bench.py
#: ``measure_native_baseline``: 16 fuzz docs x 256 ops, seed 7, the best of
#: 3 sweeps of 20 repetitions), with DocBatch's merge of the same docs
#: (config 3's capacities, :data:`SLICE`); the engine row (bench.py
#: ``--mode engine``) on A_frames' workload and frames (:data:`STREAM`),
#: ``passes`` replays enqueued back to back for the steady rate
BASELINE = dict(scalar=dict(docs=16, ops=256, seed=7, sweeps=3, reps=20), passes=4,
                round_index=2, seconds=30.0)
#: phase 5l, the fused round pipeline at A_frames' shape (:data:`STREAM`):
#: A's workload also cut into ``fine_rounds`` arrival rounds (the drains'
#: signatures repeat; phase 5j's fine mesh arm too), a forced reshard after
#: ``reshard_after`` of them, and the phase's time limit
FUSED_PIPE = dict(fine_rounds=24, reshard_after=8, seconds=50.0)
#: phase 5m, the capture audit: every (form, site) a capture must have
#: audited by the end of the phase (the padded forms flat, stacked,
#: mesh_stacked and stacked_multi with the digest twins, the paged and the
#: ragged forms, meshless and mesh, and the engine replay), with the
#: session arms that capture each on A's fine arrival when phases 5j-5l
#: did not (the engine's: phase 5k always captures it), and the phase's
#: time limit
CAPTURE_AUDIT = dict(
    forms={("flat", "apply_batch_staged_rounds"): {},
           ("flat", "_fused_rounds_digest"): dict(prefetch_digest=True),
           ("stacked", "apply_batch_stacked_rounds"): dict(static_rounds=True),
           ("stacked", "_stacked_rounds_digest"): dict(static_rounds=True, prefetch_digest=True),
           ("stacked_multi", "apply_batch_stacked_rounds_multi"): dict(static_rounds=True,
                                                                      fusion_rows=True),
           ("mesh_stacked", "apply_batch_stacked_rounds.mesh"): dict(mesh=True),
           ("mesh_stacked", "_stacked_rounds_digest"): dict(mesh=True, prefetch_digest=True),
           ("paged", "apply_batch_paged_groups"): dict(layout="paged"),
           ("paged", "apply_batch_paged_groups.mesh"): dict(layout="paged", mesh=True),
           ("ragged", "apply_batch_ragged"): dict(layout="ragged"),
           ("ragged", "apply_batch_ragged.mesh"): dict(layout="ragged", mesh=True),
           ("engine", "apply_batch_compact_rounds"): None},
    seconds=90.0)
#: phase 5n, the port's demos (``demos/torch_*.py``): ``scale`` is BASELINE
#: config 5b's session through ``demos/torch_scale_demo.py`` at the JAX
#: demo's defaults (``demos/scale_demo.py``: each doc one fuzz session of 220
#: ops asked for, 226 made, seed 200, in two arrival rounds of v2 frames;
#: slots 512, marks 160, tombstones 192, round widths 192/96/96; its 100,000
#: docs run in ``scripts/torch_scale_layouts.py``), read blocks of 8192;
#: ``arm_docs`` the demo's padded, paged and ragged runs at two read blocks;
#: ``web_cycles`` edit-and-sync cycles sent to the two-editor
#: server after tests/test_web_demo.py's requests; ``essay_step`` the trace
#: events a ``/step`` request of the essay server asks for
DEMOS = dict(scale=dict(ops=220, seed=200), arm_docs=16_384, web_cycles=40,
             essay_step=20)
#: phase 5o, the port's twins of the JAX side's measurement scripts
#: (``scripts/torch_*.py``), each at the smallest size that still launches
#: K1 on the card (its ``main``'s arguments; ``--device cuda`` is added), and
#: the phase's time limit.  The engine profile and the engine A/B share a
#: session shape (slots 384, marks 96, round widths 256/128/128), so their
#: digests are one value
SCRIPTS = dict(
    runs={"dispatch_latency": ("torch_dispatch_latency", ["--docs", "256", "--slots", "128"]),
          "apply_phase_cost": ("torch_apply_phase_cost", ["--docs", "256", "--slots", "128"]),
          "apply_phase_floor": ("torch_apply_phase_cost",
                                ["--floor", "--docs", "256", "--slots", "128"]),
          "roofline": ("torch_roofline", ["--copy-docs", "256", "512", "1024", "--docs", "512"]),
          "engine_profile": ("torch_engine_profile",
                             ["--docs", "64", "--rounds", "2", "--ops-per-doc", "48"]),
          "engine_ab": ("torch_engine_ab", ["--docs", "64", "--rounds", "2", "--ops-per-doc", "48"]),
          "ingest_profile": ("torch_ingest_profile", ["1024"]),
          "weak_scaling": ("torch_weak_scaling", ["--docs-per-device", "16", "--ops-per-doc", "24",
                                                  "--sizes", "1", "2", "4"]),
          "chaos_soak": ("torch_chaos_soak", ["--seeds", "2"])},
    seconds=45.0)
#: phase 5p, the port's twins of the JAX side's CI smokes and append A/Bs
#: (``scripts/torch_*.py``), each at its twin's defaults (its ``main``'s
#: arguments; ``--device cuda`` is added, and ``--out`` under a temporary
#: directory for a smoke), with the kernels its layouts launch (``rga``: K1,
#: ``ragged``: K3; the fleet episode is host work, the flat A/B runs torch
#: ops only), and the phase's time limit
SMOKES = dict(
    runs={"obs": ("torch_obs_smoke", [], ("rga",)),
          "paged": ("torch_paged_smoke", [], ("rga",)),
          "ragged": ("torch_ragged_smoke", [], ("rga", "ragged")),
          "fused": ("torch_fused_smoke", [], ("rga",)),
          "mesh": ("torch_mesh_smoke", [], ("rga", "ragged")),
          "plan": ("torch_plan_smoke", [], ("rga",)),
          "serve": ("torch_serve_smoke", [], ("rga",)),
          "latency": ("torch_latency_smoke", [], ("rga",)),
          "incident": ("torch_incident_smoke", [], ("rga",)),
          "history": ("torch_history_smoke", [], ("rga",)),
          "fleet": ("torch_fleet_smoke", [], ()),
          "fleet_serve": ("torch_fleet_serve_smoke", [], ("rga",)),
          "append_ab": ("torch_append_ab", [], ("rga",)),
          "append_flat_ab": ("torch_append_flat_ab", [], ())},
    seconds=75.0)
#: the reference package's golden key sets of a devprof snapshot
#: (tests/test_devprof.py), which the port's snapshot keeps
GOLDEN_DEVPROF_KEYS = {"enabled", "capture_costs", "sites", "occupancy", "occupancy_totals",
                       "memory", "page_pool", "ragged", "mesh"}
GOLDEN_SITE_KEYS = {"distinct_shapes", "dispatches", "buckets"}
GOLDEN_BUCKET_KEYS = {"dispatches", "sig", "cost", "memory"}
GOLDEN_MEMORY_KEYS = {"available", "samples", "bytes_in_use", "peak_bytes_in_use"}
GOLDEN_DEVICE_GAUGES = ("peritext_device_distinct_shapes", "peritext_device_dispatches",
                        "peritext_device_flops_total", "peritext_device_bytes_accessed_total",
                        "peritext_device_peak_bytes", "peritext_device_rounds_total",
                        "peritext_device_real_ops_total", "peritext_device_padded_ops_total",
                        "peritext_device_padding_waste_ratio")
#: the fuzz workloads' three replicas (every session's actor table)
ACTORS = ("doc1", "doc2", "doc3")
WORDS = ("the of and a to in is you that it he was for on are as with his they at be this "
         "have from or one had by word but not what all were we when your can said there "
         "use an each which she do how their if will up other about out many then them "
         "these so some her would make like him into time has look two more write go see "
         "number no way could people my than first water been call who its now find long "
         "down day did get come made may part").split()


def log(*parts) -> None:
    print(*parts, flush=True)


def _essay(seed: int, ops: int):
    """One fuzz doc of ``ops`` ops (seed ``seed``) and its scalar-oracle
    replay: the long-tail session's essay, made in a worker."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.testing.fuzz import generate_workload

    workloads = generate_workload(seed, 1, ops)
    return workloads, _oracle_doc(workloads[0])


def replay_ops(elem, num_slots, ins_ref, ins_op, s_loop) -> int:
    """Operations a sequential algorithm needs for these insert steps on a
    window of ``s_loop`` slots: per live step (p + 1) compares to find the
    reference, (q - p) to find the skip slot, and 2 (n - q + 1) element
    moves to splice; replayed with the plain version's own step
    arithmetic."""
    import torch

    elem = elem[:, :s_loop].clone()
    n = num_slots.clone().to(torch.int64)
    pos = torch.arange(s_loop, device=elem.device)[None, :]
    ops = torch.zeros((), dtype=torch.int64, device=elem.device)
    for k in range(ins_op.shape[1]):
        ref, op = ins_ref[:, k:k + 1], ins_op[:, k:k + 1]
        nn = n[:, None]
        match = (elem == ref) & (pos < nn)
        first = torch.where(match, pos, s_loop).amin(dim=1, keepdim=True)
        found = (ref == 0) | (first < s_loop)
        p = torch.where(ref == 0, -1, first)
        q = torch.where((pos > p) & (pos < nn) & (elem < op), pos, nn).amin(dim=1, keepdim=True)
        ok = (op != 0) & found & (nn < s_loop)
        work = (p + 1) + (q - p) + 2 * (nn - q + 1)
        ops += torch.where(ok, work, 0).sum()
        shifted = torch.roll(elem, 1, dims=1)
        new = torch.where(pos < q, elem, torch.where(pos == q, op, shifted))
        elem = torch.where(ok, new, elem)
        n = n + ok[:, 0]
    return int(ops)


def bound(nbytes: int, nops: int):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the int32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def insert_bound(args, loop_slots):
    """(bound_ms, bound_by, bytes, ops) of one insert call on these inputs.

    Bytes: every input read once and every output written once
    (``ops/insert.insert_batch_bytes``, the device profiler's count).
    Operations: :func:`replay_ops`."""
    from peritext_tpu_torch.ops.insert import effective_loop_slots, insert_batch_bytes

    elem_id, char, num_slots, overflow, ins_ref, ins_op, ins_char = args
    d, s_cap = elem_id.shape
    nbytes = insert_batch_bytes(d, s_cap, ins_op.shape[1])
    nops = replay_ops(elem_id, num_slots, ins_ref, ins_op, effective_loop_slots(s_cap, loop_slots))
    return (*bound(nbytes, nops), nbytes, nops)


def ragged_bound(args):
    """(bound_ms, bound_by, bytes, ops) of one ragged insert call on these
    inputs (before it runs).

    Bytes: each doc's pages gathered and scattered (both planes), its
    streams read up to its own count, and per doc n and overflow in and
    out, its page count, insert count and page-table row
    (``ops/ragged_insert.ragged_insert_bytes``, the device profiler's
    count).  Operations: :func:`replay_ops` per group of docs with one page
    count, each doc on its own window (page_count * P slots) for its own
    steps."""
    import torch

    from peritext_tpu_torch.ops.ragged_insert import ragged_insert_bytes

    (pool_elem, _, _, _, _, page_count, page_table, num_slots, _, ins_counts,
     ins_ref, ins_op, _) = args
    p = pool_elem.shape[1]
    gmax = page_table.shape[1]
    nbytes = ragged_insert_bytes(page_count.cpu().numpy(), ins_counts.cpu().numpy(), p, gmax)
    nops = 0
    for g in torch.unique(page_count).tolist():
        if g == 0:  # rows holding no pages (a session's padding rows) take no step
            continue
        rows = (page_count == g).nonzero()[:, 0]
        k = int(ins_counts[rows].max())
        elem = pool_elem[page_table[rows, :g].long()].reshape(len(rows), g * p)
        nops += replay_ops(elem, num_slots[rows], ins_ref[rows, :k], ins_op[rows, :k], g * p)
    return (*bound(nbytes, nops), nbytes, nops)


def team_columns(teams, launched):
    """A kernel row's team columns: per launch of the call, the team's
    threads per doc, docs per block, docs and window (slots); and the
    launches the call made, which must be one per planned class."""
    if launched != len(teams):
        raise AssertionError(f"{launched} launches for a plan of {len(teams)} classes")
    return dict(team=[t.threads_per_doc for t in teams],
                docs_per_block=[t.docs_per_block for t in teams],
                class_docs=[t.num_docs for t in teams],
                class_window=[t.window for t in teams], launches=launched)


def check_insert(name, args, loop_slots=None, smem_budget=None, reps=20, plain_reps=2):
    """Kernel vs plain on the card (exact), then times and bound."""
    import torch

    from peritext_tpu_torch.ops.insert import (
        SMEM_BUDGET,
        effective_loop_slots,
        insert_batch,
        insert_batch_reference,
        insert_teams,
        num_sms,
    )

    budget = SMEM_BUDGET if smem_budget is None else smem_budget
    s_loop = effective_loop_slots(args[0].shape[1], loop_slots)
    before = insert_batch.launches
    got = insert_batch(*args, loop_slots=loop_slots, smem_budget=budget)
    launched = insert_batch.launches - before
    want = insert_batch_reference(*args, loop_slots=loop_slots)
    torch.cuda.synchronize()
    err = 0
    for a, b, field in zip(got, want, ("elem_id", "char", "num_slots", "overflow")):
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
        if diff != 0:
            raise AssertionError(f"insert kernel != plain at {name}: {field} max |diff| {diff}")
        err = max(err, diff)
    call = lambda: insert_batch(*args, loop_slots=loop_slots, smem_budget=budget)  # noqa: E731
    ms = device_time_ms(call, reps)
    call_ms = cuda_time_ms(call, reps)
    plain_ms = cuda_time_ms(lambda: insert_batch_reference(*args, loop_slots=loop_slots),
                            plain_reps, warmup=1)
    bound_ms, bound_by, nbytes, nops = insert_bound(args, loop_slots)
    teams = insert_teams(args[0].shape[0], s_loop, budget, num_sms(args[0].device))
    row = dict(shape=name, docs=args[0].shape[0], slots=args[0].shape[1],
               inserts=args[4].shape[1], loop_slots=loop_slots,
               s_loop=s_loop, shared=2 * s_loop * 4 <= budget, **team_columns(teams, launched),
               max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, int_ops=nops,
               overflow_docs=int(got[3].sum().item()))
    log("insert", json.dumps(row))
    return row


def check_ragged(name, args, budgets=(None,), reps=5):
    """Ragged kernel vs plain on the card (exact, every page of both pool
    planes, n and overflow), once per shared-memory budget (None = the
    default), then times and bound.  The plain version runs once for the
    check, timed; the kernel is timed over ``reps`` launches
    after warm-up (its docs start empty, so every launch does the same
    work: the steps read only slots below n)."""
    import torch

    from peritext_tpu_torch.ops.insert import SMEM_BUDGET, num_sms
    from peritext_tpu_torch.ops.ragged_insert import (
        ragged_insert,
        ragged_insert_reference,
        ragged_teams,
    )

    bound_ms, bound_by, nbytes, nops = ragged_bound(args)
    pages = args[5].cpu().numpy()  # the plan's host page counts, as the merge passes them
    fresh = lambda: [a.clone() if i < 2 else a for i, a in enumerate(args)]  # noqa: E731
    plain = fresh()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = (plain[0], plain[1], *ragged_insert_reference(*plain))
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)  # one run: seconds long at the big shapes
    rows = []
    for budget in budgets:
        budget = SMEM_BUDGET if budget is None else budget
        mine = fresh()
        before = ragged_insert.launches
        got = (mine[0], mine[1], *ragged_insert(*mine, smem_budget=budget, page_count_host=pages))
        launched = ragged_insert.launches - before
        torch.cuda.synchronize()
        for a, b, field in zip(got, want, ("pool_elem", "pool_char", "num_slots", "overflow")):
            diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() if a.numel() else 0
            if diff != 0:
                raise AssertionError(f"ragged kernel != plain at {name}: {field} max |diff| {diff}")
        call = lambda: ragged_insert(*mine, smem_budget=budget, page_count_host=pages)  # noqa: E731
        ms = device_time_ms(call, reps)
        call_ms = cuda_time_ms(call, reps)
        b, gmax = args[6].shape
        p = args[0].shape[1]
        teams = ragged_teams(pages, p, gmax, budget, num_sms(args[0].device))
        row = dict(shape=name if budget == SMEM_BUDGET else f"{name}_global_memory",
                   docs=b, page_size=p, gmax=gmax,
                   pages=int(pages.sum()), pool_pages=args[0].shape[0],
                   inserts=int(args[9].sum()), max_count=int(args[9].max()),
                   shared=[t.shared for t in teams], **team_columns(teams, launched),
                   max_abs_err=0, ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bytes=nbytes, int_ops=nops,
                   overflow_docs=int(got[3].sum().item()))
        log("ragged_insert", json.dumps(row))
        rows.append(row)
    return rows


def synth_args(device, docs, slots, inserts, seed):
    import torch

    from peritext_tpu_torch.ops.packed import empty_docs
    from peritext_tpu_torch.testing.synth import synth_streams

    state = empty_docs(docs, slots, 8, tomb_capacity=8, device=device)
    streams = synth_streams(docs, inserts_per_doc=inserts, seed=seed)[:3]
    return [state.elem_id, state.char, state.num_slots, state.overflow,
            *(torch.as_tensor(a).to(device) for a in streams)]


def ragged_args(device, slots, streams):
    """Ragged insert inputs for empty docs: a page store sized to the docs'
    true page need (as the ragged merge sizes it), every row allocated, the
    plan, and the streams (numpy (B, K) int32, left-packed)."""
    import torch

    from peritext_tpu_torch.ops.ragged import plan_arrays
    from peritext_tpu_torch.store import DEFAULT_PAGE_SIZE, PagedDocStore, ragged_plan

    refs, ops, chars = streams
    counts = np.count_nonzero(ops, axis=1).astype(np.int32)
    b = len(counts)
    need = -(-np.maximum(counts, 1) // DEFAULT_PAGE_SIZE)
    store = PagedDocStore(b, slots, 8, tomb_capacity=8, initial_pages=1 + int(need.sum()),
                          device=device)
    store.ensure_rows(np.arange(b), counts)
    planes = plan_arrays(ragged_plan(store), device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return [store.pool_elem, store.pool_char, *planes[1:],
            torch.zeros(b, dtype=torch.int32, device=device),
            torch.zeros(b, dtype=torch.bool, device=device),
            t(counts), t(refs), t(ops), t(chars)]


def mixed_streams():
    """MIXED_10K's streams: each size class from synth_streams, zero-padded
    to the longest class, rows in a seeded shuffle (a drain mixes sizes)."""
    from peritext_tpu_torch.testing.synth import synth_streams

    width = max(k for _, k, _ in MIXED_10K["groups"])
    planes = [[], [], []]
    for docs, k, seed in MIXED_10K["groups"]:
        for plane, a in zip(planes, synth_streams(docs, inserts_per_doc=k, seed=seed)[:3]):
            plane.append(np.pad(a, ((0, 0), (0, width - k))))
    order = np.random.default_rng(4).permutation(sum(d for d, _, _ in MIXED_10K["groups"]))
    return [np.concatenate(p)[order] for p in planes]


def run_slice(device, job):
    """The padded path: one padded merge of BASELINE config 3 on the card
    (its workload from ``job``, a :class:`Generation`)."""
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.testing.fuzz import sample_cursors

    cfg = SLICE
    t0 = time.perf_counter()
    workloads = job.result()
    cursors = sample_cursors(workloads, 4, cfg["seed"])
    log(f"slice: {cfg['docs']} docs x {cfg['ops']} ops ready in "
        f"{time.perf_counter() - t0:.1f} s after the build")
    freeze_arrived("slice")
    batch = DocBatch(slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
                     comment_capacity=cfg["comment_capacity"], device=device)
    batch.merge(workloads[:8], cursors[:8])  # warm-up: allocator and library load

    insert_batch.launches = 0
    report = batch.merge(workloads, cursors)
    launches = {"rga_insert": insert_batch.launches}
    log("slice stats", json.dumps(report.stats.to_json()))
    log("slice launches", json.dumps(launches))
    if report.fallback_docs:
        raise AssertionError(f"slice: docs fell back to the oracle: {report.fallback_docs[:20]}")
    if launches["rga_insert"] == 0:
        raise AssertionError("slice: the insert kernel was not launched")

    sample = sorted(random.Random(cfg["seed"]).sample(range(cfg["docs"]), cfg["sample"]))
    check_oracle("slice", workloads, cursors, report, sample)
    return batch, workloads, cursors, launches, report


def check_oracle(phase, workloads, cursors, report, sample) -> None:
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.ops.resolve import oracle_cursor_positions

    for d in sample:
        doc = _oracle_doc(workloads[d])
        if report.spans[d] != doc.get_text_with_formatting(["text"]):
            raise AssertionError(f"{phase}: doc {d} spans differ from the oracle")
        if report.roots[d] != doc.root:
            raise AssertionError(f"{phase}: doc {d} root differs from the oracle")
        if report.cursor_positions[d] != oracle_cursor_positions(doc, cursors[d]):
            raise AssertionError(f"{phase}: doc {d} cursors differ from the oracle")
    log(f"{phase}: {len(sample)} sampled docs equal the oracle (spans, roots, cursors)")


def run_pooled(device, workloads, cursors, tail_job):
    """The pooled slice: the same workloads, plus a long tail (from
    ``tail_job``, started with the script), through all three layouts;
    returns the ragged DocBatch, the workloads and each layout's launch
    counts."""
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.ops.insert import SMEM_BUDGET, insert_batch, num_sms
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert, ragged_teams
    from peritext_tpu_torch.store import ragged_plan
    from peritext_tpu_torch.testing.fuzz import sample_cursors

    cfg = POOLED
    t0 = time.perf_counter()
    tail = tail_job.get(timeout=900)
    workloads = workloads + tail
    cursors = cursors + sample_cursors(tail, 4, cfg["tail_seed"])
    log(f"pooled: {cfg['tail_docs']} docs x {cfg['tail_ops']} ops ready in "
        f"{time.perf_counter() - t0:.1f} s after the slice; {len(workloads)} docs in all")
    freeze_arrived("pooled")
    reports, launches, batches = {}, {}, {}
    for layout in ("padded", "paged", "ragged"):
        batch = batches[layout] = DocBatch(
            slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
            comment_capacity=cfg["comment_capacity"], page_size=cfg["page_size"],
            layout=layout, device=device)
        batch.merge(workloads[:8], cursors[:8])  # warm-up
        insert_batch.launches = 0
        ragged_insert.launches = 0
        report = reports[layout] = batch.merge(workloads, cursors)
        launches[layout] = {"rga_insert": insert_batch.launches,
                            "ragged_insert": ragged_insert.launches}
        log(f"pooled {layout} stats", json.dumps(report.stats.to_json()))
        log(f"pooled {layout} launches", json.dumps(launches[layout]))
        if report.fallback_docs:
            raise AssertionError(f"pooled {layout}: docs fell back: {report.fallback_docs[:20]}")

    groups = len(batches["paged"]._encode_paged(workloads))
    plan = ragged_plan(batches["ragged"].last_store)
    classes = ragged_teams(plan.page_count, cfg["page_size"], plan.page_table.shape[1],
                           SMEM_BUDGET, num_sms(device))
    log("pooled ragged classes", json.dumps(
        [dict(team=t.team, docs=t.num_docs, window=t.window) for t in classes]))
    expected = {"padded": {"rga_insert": 1, "ragged_insert": 0},
                "paged": {"rga_insert": groups, "ragged_insert": 0},
                "ragged": {"rga_insert": 0, "ragged_insert": len(classes)}}
    if launches != expected:
        raise AssertionError(f"pooled: launches {launches}, expected {expected}")
    padded = reports["padded"]
    for layout in ("paged", "ragged"):
        r = reports[layout]
        for field in ("spans", "roots", "cursor_positions", "fallback_docs", "device_ops"):
            if getattr(r, field) != getattr(padded, field):
                raise AssertionError(f"pooled {layout}: {field} differ from the padded layout")
    log(f"pooled: paged ({groups} groups) and ragged equal padded on all {len(workloads)} docs")
    head = len(workloads) - cfg["tail_docs"]
    sample = sorted(random.Random(cfg["tail_seed"]).sample(range(head), cfg["sample"] - cfg["tail_docs"]))
    check_oracle("pooled", workloads, cursors, reports["ragged"], sample + list(range(head, len(workloads))))
    return batches, workloads, launches


def _oracle_digest(doc, slot_capacity, actor_table) -> int:
    """A replayed doc's full-state digest term by the host mirrors."""
    from peritext_tpu_torch.parallel.mesh import doc_digest_host
    from peritext_tpu_torch.parallel.streaming import _doc_char_slots, _doc_full_extras_host

    cps, slots = _doc_char_slots(doc)
    return (doc_digest_host(cps, slots, slot_capacity)
            + _doc_full_extras_host(doc, slots, actor_table)) & 0xFFFFFFFF


def freeze_arrived(what: str) -> None:
    """Move every object alive now into the cyclic collector's permanent
    generation (``gc.freeze``), once ``what`` (workloads, arrivals: millions
    of tracked objects that live for phases) has arrived, so a collection
    walks only what was made after it.  Unfrozen, the collector's walks of
    the workloads took 8.3 and 9.75 s of two of A's 2048-doc sessions and
    9.99 s for one full collection (an H100 machine's slow host).  A frozen
    object is still freed when its last reference goes."""
    gc.freeze()
    log(f"{what}: {gc.get_freeze_count()} objects frozen")


class GcClock:
    """Host seconds spent in Python's cyclic garbage collector while it is
    registered (``gc.callbacks``): a collection is a pause of the host,
    charged to whatever stage it falls in."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase, info) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


#: the session counters each streaming report gives as deltas over its run
SESSION_COUNTERS = ("streaming.schedule_passes", "streaming.docs_scanned",
                    "streaming.docs_skipped", "streaming.fused_dispatches")


def _clone_tree(tree):
    """A copy of a tensor tree (tuples, named tuples, dicts)."""
    import torch

    if torch.is_tensor(tree):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_clone_tree(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _arm_capture(capture, layout):
    """Patch the path's kernel wrapper to record the inputs of one armed
    round (``capture["armed"]``), and return the undo.  Padded: the first
    insert call; paged: every insert call of one round's group chain (one
    per page group, the per-round or the fused form's chain); ragged: the
    first ragged insert call.  While armed, a fused form's graph cache runs
    its body eagerly, so the wrapper is called with the batch's own inputs
    (a replay calls no Python; a capture's would be graph memory)."""
    from peritext_tpu_torch.ops import kernel as kernel_mod
    from peritext_tpu_torch.ops import ragged as ragged_mod
    from peritext_tpu_torch.store import session as session_mod
    from peritext_tpu_torch.utils.graphs import GraphCache

    clone = lambda args: [a.clone() for a in args]  # noqa: E731
    originals = [(kernel_mod, "insert_batch", kernel_mod.insert_batch),
                 (session_mod, "apply_batch_paged_groups", session_mod.apply_batch_paged_groups),
                 (ragged_mod, "ragged_insert", ragged_mod.ragged_insert),
                 (session_mod, "_apply_groups", session_mod._apply_groups),
                 (GraphCache, "run", GraphCache.run)]
    insert, groups, ragged, chain, graph_run = (o[2] for o in originals)

    def insert_rec(*args, loop_slots=None, **kw):
        if capture.get("armed") and layout == "padded":
            capture.update(armed=False, loop_slots=loop_slots, args=clone(args))
        elif capture.get("recording"):
            capture["groups"].append(clone(args))
        return insert(*args, loop_slots=loop_slots, **kw)

    def groups_rec(*args, **kw):
        if not capture.get("armed") or layout != "paged":
            return groups(*args, **kw)
        capture.update(armed=False, recording=True, groups=[])
        try:
            return groups(*args, **kw)
        finally:
            capture["recording"] = False

    def ragged_rec(*args, **kw):
        if capture.get("armed") and layout == "ragged":
            capture.update(armed=False, args=clone(args))
        return ragged(*args, **kw)

    def chain_rec(*args, **kw):
        if not capture.get("armed") or layout != "paged":
            return chain(*args, **kw)
        capture.update(armed=False, recording=True, groups=[])
        try:
            return chain(*args, **kw)
        finally:
            capture["recording"] = False

    def run_rec(cache, key, form, body, inputs, binds=()):
        if capture.get("armed") and cache.device.type == "cuda":
            return body(*inputs)
        return graph_run(cache, key, form, body, inputs, binds)

    for (mod, name, _), rec in zip(originals, (insert_rec, groups_rec, ragged_rec, chain_rec,
                                               run_rec)):
        setattr(mod, name, rec)
    return lambda: [setattr(mod, name, fn) for mod, name, fn in originals]


#: the insert-launch counter each layout's commits keep, one per launch
APPLY_COUNTER = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
                 "ragged": "streaming.ragged_applies"}


def run_stream_session(device, cfg, workloads, arrival, name, capture=None, wire_bytes=None,
                       after_round=None, **arm):
    """One streaming session over ``arrival``: per arrival round ingest (one
    ``ingest`` per doc, or, when ``wire_bytes`` is given, the arrival is
    wire frames and one ``ingest_frames`` call takes the round), then
    ``drain()`` (synchronized, so its apply time covers the kernels it
    queued); then ``digest()``, ``read_all()`` and ``read_patches_all()``.
    ``arm`` may name a ``layout`` (padded, paged, ragged), the
    ``fused_pipeline``/``static_rounds`` switches, a ``mesh`` (each
    synchronize then covers every card of the mesh, and the report adds
    each card's peak memory), an ``engine_capture`` list (the session's
    ``_capture_rounds`` hook), ``prefetch_digest`` (the drain-end digest
    chain the serving tier arms) and ``fusion_rows`` (a fusion window's
    tenant rows, as ``serve.FusedMuxGroup`` sets them).  Both kernels' launch
    counts are set to 0 just before and read just after: the layout's
    kernel must have launched exactly as often as its commits counted
    (:data:`APPLY_COUNTER`), the other never.  A frame session must have
    been parsed and scheduled by the native library.  ``capture`` (a dict)
    asks for the kernel inputs of one round of the third drain
    (:func:`_arm_capture`); ``after_round(s, r)`` runs after round r's
    drain.  Returns the session and its report."""
    import torch

    from peritext_tpu_torch import native
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    layout = arm.get("layout", "padded")
    mesh = arm.get("mesh")
    cards = list(dict.fromkeys(mesh.devices)) if mesh is not None else [torch.device("cuda")]

    def sync():
        for card in cards:
            torch.cuda.synchronize(card)

    ki, kd, km, kp = cfg["round_caps"]
    pooled = {} if layout == "padded" else dict(page_size=cfg.get("page_size", 64),
                                                pool_pages=arm.get("pool_pages"))
    s = StreamingMerge(
        num_docs=len(workloads), actors=("doc1", "doc2", "doc3"),
        slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
        tomb_capacity=cfg["tomb_capacity"], round_insert_capacity=ki,
        round_delete_capacity=kd, round_mark_capacity=km, round_map_capacity=kp,
        comment_capacity=cfg["comment_capacity"], read_chunk=cfg.get("read_chunk", 8192),
        static_rounds=arm.get("static_rounds", False), layout=layout, device=device,
        mesh=mesh, **pooled,
    )
    s.fused_pipeline = arm.get("fused_pipeline", True)
    s._capture_rounds = arm.get("engine_capture")
    s.prefetch_digest = arm.get("prefetch_digest", False)
    s.fusion_rows = arm.get("fusion_rows")
    undo = _arm_capture(capture, layout) if capture is not None else None
    stages = dict.fromkeys(("ingest", "schedule", "apply", "digest", "read_all",
                            "read_patches_all"), 0.0)
    sync()
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    frames = wire_bytes is not None
    counters = {c: GLOBAL_COUNTERS.get(c) for c in SESSION_COUNTERS + tuple(APPLY_COUNTER.values())}
    native_calls = dict(native.calls)
    insert_batch.launches = 0
    ragged_insert.launches = 0
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    extra = {}
    t_all = time.perf_counter()
    try:
        for r in range(max(len(b) for b in arrival)):
            t0 = time.perf_counter()
            if frames:
                s.ingest_frames((d, batches[r]) for d, batches in enumerate(arrival)
                                if r < len(batches))
            else:
                for d, batches in enumerate(arrival):
                    if r < len(batches):
                        s.ingest(d, batches[r])
            t1 = time.perf_counter()
            if capture is not None and r == 2:
                capture["armed"] = True
            s.drain()
            t_sync = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            # apply: the commits' spans and the wait for the card; schedule:
            # the rest of the drain, with its passes that admit nothing
            apply = s.last_drain_marks["apply_seconds"] + (t2 - t_sync)
            stages["ingest"] += t1 - t0
            stages["schedule"] += (t2 - t1) - apply
            stages["apply"] += apply
            if after_round is not None:
                t0 = time.perf_counter()
                extra.update(after_round(s, r) or {})
                stages["after_round"] = stages.get("after_round", 0.0) + time.perf_counter() - t0
        for stage, fn in (("digest", s.digest), ("read_all", s.read_all),
                          ("read_patches_all", s.read_patches_all)):
            t0 = time.perf_counter()
            out = fn()
            stages[stage] = time.perf_counter() - t0
            if stage == "digest":
                digest = out
            elif stage == "read_all":
                spans = out
            else:
                patches = out
    finally:
        if undo is not None:
            undo()
        gc.callbacks.remove(gc_clock)
    wall = time.perf_counter() - t_all
    launches = {"rga_insert": insert_batch.launches, "ragged_insert": ragged_insert.launches}
    counts = {c.split(".")[1]: int(GLOBAL_COUNTERS.get(c) - n) for c, n in counters.items()}
    applies = counts[APPLY_COUNTER[layout].split(".")[1]]
    ops = sum(len(ch.ops) for w in workloads for log in w.values() for ch in log)
    fallback = [d for d, sess in enumerate(s.docs) if sess.fallback]
    passes = max(counts["schedule_passes"], 1)
    native_delta = {k: v - native_calls.get(k, 0) for k, v in native.calls.items()
                    if v != native_calls.get(k, 0)}
    report = dict(session=name, layout=layout, ingest="frames" if frames else "objects",
                  docs=len(workloads), padded_docs=s._padded_docs,
                  blocks=-(-s._padded_docs // s._read_chunk), rounds=s.rounds,
                  round_caps=list(s.round_caps), ops=ops, wall_seconds=wall,
                  ops_per_second=ops / wall,
                  stage_seconds=dict(stages, host_parse=s.host_parse_seconds),
                  gc_seconds=gc_clock.seconds,
                  wire_bytes_per_op=wire_bytes / ops if frames else None,
                  schedule_passes=counts["schedule_passes"],
                  object_docs_scanned_per_pass=counts["docs_scanned"] / passes,
                  object_docs_scanned_per_pass_without_skip=(
                      counts["docs_scanned"] + counts["docs_skipped"]) / passes,
                  native_calls=native_delta,
                  rga_insert_launches=launches["rga_insert"],
                  ragged_insert_launches=launches["ragged_insert"],
                  block_applies=counts["block_applies"], group_applies=counts["group_applies"],
                  ragged_applies=counts["ragged_applies"],
                  fused_dispatches=counts["fused_dispatches"], graphs=s._graphs.stats(),
                  h2d_copies=sum(lane.copies for lane in s._shard_lanes),
                  fallback_docs=len(fallback), overflow_docs=s.overflow_count(),
                  peak_memory_bytes=torch.cuda.max_memory_allocated(cards[0]), health=s.health(),
                  **extra)
    if mesh is not None:
        report.update(mesh_shards=mesh.size, mesh_devices=[str(d) for d in mesh.devices],
                      mesh_stats=s._mesh_stats(),
                      shard_graphs=[g.stats() for g in s._shard_graphs],
                      peak_memory_bytes_by_card={str(c): torch.cuda.max_memory_allocated(c)
                                                 for c in cards})
    log("streaming", json.dumps(report))
    kernel = "ragged_insert" if layout == "ragged" else "rga_insert"
    other = "rga_insert" if layout == "ragged" else "ragged_insert"
    if launches[kernel] == 0 or launches[kernel] != applies or launches[other]:
        raise AssertionError(f"streaming {name}: launches {launches} for {applies} "
                             f"{APPLY_COUNTER[layout]} (one {kernel} launch each)")
    if frames and not (native_delta.get("parse_frames") and native_delta.get("schedule_split_batch")):
        raise AssertionError(f"streaming {name}: the frames were not parsed and scheduled by the "
                             f"native library (native calls {native_delta})")
    if s.pending_count():
        raise AssertionError(f"streaming {name}: {s.pending_count()} changes still pending")
    return s, dict(report, digest=digest, spans=spans, patches=patches, fallback=fallback)


def check_stream_session(name, s, out, workloads, cfg, sample, oracle=None) -> None:
    """A session's digest invariants (``digest()`` == ``digest(refresh=True)``
    == the sum of ``doc_digest`` == ``digest_async().wait()``), and a seeded
    doc sample (with every fallback doc) against the scalar oracle: spans,
    root, cursors and the per-doc digest against the host mirrors of the
    replayed doc.  ``oracle`` (a dict) keeps the replayed docs for the
    next session of the same workloads."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.ops.resolve import oracle_cursor_positions
    from peritext_tpu_torch.testing.fuzz import sample_cursors

    oracle = {} if oracle is None else oracle
    if s.digest() != out["digest"] or s.digest(refresh=True) != out["digest"]:
        raise AssertionError(f"streaming {name}: digest() != digest(refresh=True)")
    total = sum(s.doc_digest(d) for d in range(s.num_docs)) & 0xFFFFFFFF
    if total != out["digest"]:
        raise AssertionError(f"streaming {name}: the doc_digest sum != digest()")
    if s.digest_async().wait() != out["digest"]:
        raise AssertionError(f"streaming {name}: digest_async().wait() != digest()")
    docs = sorted(set(sample) | set(out["fallback"]))
    cursors = sample_cursors([workloads[d] for d in docs], 4, cfg["seed"])
    got_cursors = s.resolve_cursors_batch(dict(zip(docs, cursors)))
    for d, cur in zip(docs, cursors):
        if d not in oracle:
            oracle[d] = _oracle_doc(workloads[d])
        doc = oracle[d]
        if out["spans"][d] != doc.get_text_with_formatting(["text"]) or \
                s.read(d) != out["spans"][d]:
            raise AssertionError(f"streaming {name}: doc {d} spans differ from the oracle")
        if s.read_root(d) != doc.root:
            raise AssertionError(f"streaming {name}: doc {d} root differs from the oracle")
        if got_cursors[d] != oracle_cursor_positions(doc, cur):
            raise AssertionError(f"streaming {name}: doc {d} cursors differ from the oracle")
        if s.doc_digest(d) != _oracle_digest(doc, cfg["slot_capacity"], s._actor_table):
            raise AssertionError(f"streaming {name}: doc {d} digest differs from the host mirror")
    log(f"streaming {name}: digest == refresh == sum of doc digests == async; {len(docs)} docs "
        f"({len(out['fallback'])} fallback) equal the oracle (spans, roots, cursors, digests)")


def compare_arms(name, other, base, base_name) -> None:
    """Two arms of one workload hold the same documents."""
    for key in ("spans", "patches", "digest", "fallback"):
        if other[key] != base[key]:
            raise AssertionError(f"streaming: {name} {key} differ from {base_name}")


def compare_prefix(name, s, other, base, base_name) -> None:
    """Session ``s`` (report ``other``) holds ``base``'s documents as its
    first docs: their spans, patches and fallback, and the sum of their
    ``doc_digest`` equal to ``base``'s digest."""
    n = len(base["spans"])
    for key in ("spans", "patches"):
        if other[key][:n] != base[key]:
            raise AssertionError(f"streaming: {name} {key} differ from {base_name}")
    if [d for d in other["fallback"] if d < n] != base["fallback"]:
        raise AssertionError(f"streaming: {name} fallback differs from {base_name}")
    if sum(s.doc_digest(d) for d in range(n)) & 0xFFFFFFFF != base["digest"]:
        raise AssertionError(f"streaming: {name}'s first {n} doc digests differ from {base_name}")


def run_streaming(device, ckpts, jobs):
    """The streaming slice: an untimed warm-up session, then sessions A
    (two object arms and a frame arm), B (block-chunked) and C (scale,
    an object and a frame arm), each checked; returns the K1 captures of a
    mid-session round of A's object and frame arms, the per-session
    reports, and what the layouts phase reuses (workloads, arrivals,
    samples, oracle docs, A_default's and C_frames' results).  C_frames is
    checkpointed where it ends, into ``ckpts``.  A's workload and C's other
    docs come from ``jobs["stream"]`` and ``jobs["stream_more"]``
    (:class:`Generation`, started with the script)."""
    from peritext_tpu_torch.testing.arrival import build_arrival

    cfg = STREAM
    t0 = time.perf_counter()
    workloads = jobs["stream"].result()
    arrival = build_arrival(workloads, cfg["rounds"], cfg["seed"])
    wire, wire_bytes = build_arrival(workloads, cfg["rounds"], cfg["seed"], as_frames=True,
                                     wire=cfg["wire"])
    log(f"streaming: {cfg['docs']} docs x {cfg['ops']} ops and their {cfg['wire']} frames "
        f"({wire_bytes} bytes) ready in {time.perf_counter() - t0:.1f} s")
    freeze_arrived("streaming")
    sample = sorted(random.Random(cfg["seed"]).sample(range(cfg["docs"]), cfg["sample"]))
    return _run_streaming(device, ckpts, cfg, workloads, arrival, wire, wire_bytes, sample,
                          jobs["stream_more"])


def _run_streaming(device, ckpts, cfg, workloads, arrival, wire, wire_bytes, sample, more_job):
    """:func:`run_streaming` once A's workload is made and C's is being made."""
    from peritext_tpu_torch.testing.arrival import build_arrival

    # the first session on the card pays its cold start (kernel modules,
    # allocator growth); the timed arms run warm.  It ingests by frames:
    # by objects it took 14.1 s on an H100 machine, 10.6 s of it the object
    # schedule, which the object arms below time themselves
    run_stream_session(device, cfg, workloads, wire, "warm_up", wire_bytes=wire_bytes)
    capture = {}
    arms = {}
    for arm, kw in (("A_default", {}), ("A_fused_pipeline_off", dict(fused_pipeline=False))):
        arms[arm] = run_stream_session(
            device, cfg, workloads, arrival, arm,
            capture=capture if arm == "A_fused_pipeline_off" else None, **kw)
    s_a, a = arms["A_default"]
    compare_arms("A_fused_pipeline_off", arms["A_fused_pipeline_off"][1], a, "A_default")
    log("streaming: the two arms of A agree (read_all, read_patches_all, digest, fallback)")
    oracle_a = {}
    check_stream_session("A_default", s_a, a, workloads, cfg, sample, oracle_a)
    capture_frames = {}
    s_f, f = run_stream_session(device, cfg, workloads, wire, "A_frames", capture=capture_frames,
                                wire_bytes=wire_bytes)
    compare_arms("A_frames", f, a, "A_default")
    log(f"streaming: A_frames equals A_default on all {cfg['docs']} docs "
        "(read_all, read_patches_all, digest, fallback)")
    check_stream_session("A_frames", s_f, f, workloads, cfg, sample, oracle_a)
    reports = [out for _, out in arms.values()] + [f]
    del arms, s_f

    s_b, b = run_stream_session(device, dict(cfg, read_chunk=cfg["b_read_chunk"]), workloads,
                                arrival, "B_block_chunked")
    compare_arms("B_block_chunked", b, a, "A_default")
    log(f"streaming: B ({b['blocks']} blocks) equals A on all {cfg['docs']} docs and the digest")
    del s_a, s_b

    t0 = time.perf_counter()
    more = more_job.result()
    workloads_c = workloads + more
    log(f"streaming: {len(more)} more docs generated since the script started; waited "
        f"{time.perf_counter() - t0:.1f} s for them")
    # C's object arm: its first docs in two read blocks (the constant's cut)
    n_obj = cfg["c_object_docs"]
    s_c, c = run_stream_session(device, dict(cfg, read_chunk=cfg["c_object_read_chunk"]),
                                workloads_c[:n_obj],
                                build_arrival(workloads_c[:n_obj], cfg["rounds"], cfg["seed"]),
                                "C_scale")
    sample_c = sorted(random.Random(cfg["seed"] + 1).sample(range(len(workloads_c)), cfg["sample"]))
    oracle_c = {}
    check_stream_session("C_scale", s_c, c, workloads_c[:n_obj], cfg,
                         sorted(random.Random(cfg["seed"] + 1).sample(range(n_obj), cfg["sample"])),
                         oracle_c)
    del s_c
    wire_c, wire_bytes_c = build_arrival(workloads_c, cfg["rounds"], cfg["seed"], as_frames=True,
                                         wire=cfg["wire"])
    freeze_arrived("streaming C")
    s_cf, cf = run_stream_session(device, cfg, workloads_c, wire_c, "C_frames",
                                  wire_bytes=wire_bytes_c)
    compare_prefix("C_frames", s_cf, cf, c, "C_scale")
    log(f"streaming: C_frames equals C_scale on its {n_obj} docs (read_all, read_patches_all, "
        "fallback, the sum of their digests)")
    check_stream_session("C_frames", s_cf, cf, workloads_c, cfg, sample_c, oracle_c)
    checkpoint_session(ckpts, "C_frames", s_cf, cf)
    del s_cf
    ctx = dict(workloads=workloads, arrival=arrival, wire=wire, wire_bytes=wire_bytes,
               frames_ops_per_second=f["ops_per_second"], frames_digest=f["digest"],
               sample=sample, oracle_a=oracle_a, a=a, workloads_c=workloads_c, wire_c=wire_c,
               wire_bytes_c=wire_bytes_c, sample_c=sample_c, oracle_c=oracle_c, cf=cf)
    return capture, capture_frames, reports + [b, c, cf], ctx


def run_stream_layouts(device, ctx, longtail_jobs, ckpts):
    """The streaming-layouts phase: session A in the paged and the ragged
    layout, by objects and by frames, each equal to A_default on every doc;
    B in the paged layout with a reshard() after its second round (4 read
    blocks, so 4 shards), equal to A, its digest unchanged by the reshard;
    C_frames in the ragged layout at full width (10240 docs, 16384 rows),
    equal to C_frames; and the long-tail session (:data:`LONGTAIL`) in all
    three layouts, paged and ragged equal to padded on every doc.  Each
    session's checks as :func:`check_stream_session`.  Returns the captured
    paged round (K1 inputs, one per group), the captured ragged round of
    ragged C_frames (K3 inputs) and the reports.  A_paged_frames and
    C_frames_ragged are checkpointed where they end, into ``ckpts``."""
    cfg = STREAM
    reports, capture_paged, capture_ragged = [], {}, {}
    for layout in ("paged", "ragged"):
        for frames in (False, True):
            name = f"A_{layout}" + ("_frames" if frames else "")
            s, out = run_stream_session(
                device, cfg, ctx["workloads"], ctx["wire"] if frames else ctx["arrival"], name,
                capture=capture_paged if name == "A_paged" else None,
                wire_bytes=ctx["wire_bytes"] if frames else None, layout=layout)
            compare_arms(name, out, ctx["a"], "A_default")
            log(f"streaming: {name} equals A_default on all {cfg['docs']} docs "
                "(read_all, read_patches_all, digest, fallback)")
            check_stream_session(name, s, out, ctx["workloads"], cfg, ctx["sample"], ctx["oracle_a"])
            if name in DURABLE:
                checkpoint_session(ckpts, name, s, out)
            reports.append(out)
            del s

    def reshard_after_second_round(s, r):
        if r != 1:
            return None
        before = s.digest()
        placed = s.reshard()
        after, refreshed = s.digest(), s.digest(refresh=True)
        log(f"streaming B_paged_reshard: reshard after round 2 moved {placed['moved']} docs; "
            f"page_load {placed['page_load']}; digest {before} before, {after} after")
        if not placed["moved"] or after != before or refreshed != before:
            raise AssertionError(f"streaming B_paged_reshard: reshard {placed}, digest {before} "
                                 f"before, {after} after ({refreshed} refreshed)")
        return dict(reshard=placed)

    s, b = run_stream_session(device, dict(cfg, read_chunk=cfg["b_read_chunk"]), ctx["workloads"],
                              ctx["arrival"], "B_paged_reshard",
                              after_round=reshard_after_second_round, layout="paged")
    compare_arms("B_paged_reshard", b, ctx["a"], "A_default")
    check_stream_session("B_paged_reshard", s, b, ctx["workloads"], cfg, ctx["sample"],
                         ctx["oracle_a"])
    log(f"streaming: B_paged_reshard ({b['blocks']} blocks, resharded) equals A on all "
        f"{cfg['docs']} docs and the digest")
    reports.append(b)
    del s

    s, cr = run_stream_session(device, cfg, ctx["workloads_c"], ctx["wire_c"], "C_frames_ragged",
                               capture=capture_ragged, wire_bytes=ctx["wire_bytes_c"],
                               layout="ragged")
    compare_arms("C_frames_ragged", cr, ctx["cf"], "C_frames")
    check_stream_session("C_frames_ragged", s, cr, ctx["workloads_c"], cfg, ctx["sample_c"],
                         ctx["oracle_c"])
    checkpoint_session(ckpts, "C_frames_ragged", s, cr)
    log(f"streaming: C_frames_ragged equals C_frames on all {len(ctx['workloads_c'])} docs; "
        f"peak memory {cr['peak_memory_bytes']} bytes (padded C_frames "
        f"{ctx['cf']['peak_memory_bytes']})")
    reports.append(cr)
    del s
    reports += run_longtail(device, *longtail_jobs)
    return capture_paged, capture_ragged, reports


def _scrape(address, path):
    import urllib.request

    with urllib.request.urlopen(f"http://{address[0]}:{address[1]}{path}", timeout=30) as resp:
        return resp.read().decode()


def _check_planes_session(name, layout, site, s, out, before, after, sentinel, server):
    """Phase 5h's checks of one armed session: its site's dispatches and
    launches against the commit counters and the kernels' launch counts,
    its applied ops against the occupancy table's, its pool against the
    page-pool section, the memory watermarks, every bucket costed, no
    build or load after the first round and no more graph captures than
    graphs held, and the mounted server's
    endpoints with the golden key sets."""
    rec = after["sites"].get(site)
    if rec is None or set(after["sites"]) - set(before["sites"]) - {site}:
        raise AssertionError(f"planes {name}: sites {sorted(after['sites'])}, want {site}")
    prior = before["sites"].get(site, {"dispatches": 0, "buckets": {}})
    dispatches = rec["dispatches"] - prior["dispatches"]
    launches = sum(b["dispatches"] * b["cost"]["kernel_launches"] for b in rec["buckets"].values()) \
        - sum(b["dispatches"] * b["cost"]["kernel_launches"] for b in prior["buckets"].values())
    counter, kernel = {"padded": ("block_applies", "rga_insert_launches"),
                       "paged": ("group_applies", "rga_insert_launches"),
                       "ragged": ("ragged_applies", "ragged_insert_launches")}[layout]
    # one fused form's call per committed batch (padded: the session's
    # fused dispatches; paged and ragged: the graph cache's calls), or, on
    # a block-chunked session's per-round path, one ragged call a round
    graph_calls = sum(row["eager"] + row["captures"] + row["hits"]
                      for row in s._graphs.stats().values())
    want_dispatches = (out["fused_dispatches"] if layout == "padded"
                       else graph_calls if s._pipelined() else s.rounds)
    if dispatches != want_dispatches or launches != out[counter] or launches != out[kernel]:
        raise AssertionError(f"planes {name}: {site} dispatched {dispatches} (want "
                             f"{want_dispatches}) with {launches} launches; the session counted "
                             f"{out[counter]} {counter} and {out[kernel]} {kernel}")
    real = after["occupancy_totals"]["real_ops"] - before["occupancy_totals"]["real_ops"]
    if real != s._pad_real_ops or real <= 0:
        raise AssertionError(f"planes {name}: occupancy real_ops {real}, the session applied "
                             f"{s._pad_real_ops}")
    if layout != "padded":
        pool = dict(after["page_pool"])
        pool.pop("peak_utilization")
        if json.loads(json.dumps(pool)) != json.loads(json.dumps(s.store.pool_stats())):
            raise AssertionError(f"planes {name}: page_pool {pool} != pool_stats() "
                                 f"{s.store.pool_stats()}")
    mem = after["memory"]
    if not mem["available"] or not mem["peak_bytes_in_use"] or \
            mem["samples"] <= before["memory"]["samples"]:
        raise AssertionError(f"planes {name}: memory {mem}")
    for key, bucket in rec["buckets"].items():
        cost = bucket["cost"] or {}
        if not cost.get("device_ms") or not cost.get("kernel_bytes") or \
                set(bucket) != GOLDEN_BUCKET_KEYS:
            raise AssertionError(f"planes {name}: bucket {key} uncosted: {bucket}")
    since = sentinel.since_mark()
    built = {k: n for k, n in since.items() if not k.startswith("graph.")}
    # a graph capture after the first round is one signature's, held since:
    # no more captures than the graphs the session's cache holds (a
    # signature recaptured batch after batch would exceed them)
    captured = sum(n for k, n in since.items() if k.startswith("graph."))
    if built or captured > len(s._graphs):
        raise AssertionError(f"planes {name}: built or loaded {built} after the first round, "
                             f"{captured} graph captures for {len(s._graphs)} graphs held")
    text = _scrape(server.address, "/metrics")
    missing = [g for g in GOLDEN_DEVICE_GAUGES + ("peritext_recompiles_total",)
               if f"# TYPE {g} " not in text]
    if missing or f'peritext_device_dispatches{{site="{site}"}} {rec["dispatches"]}' not in text \
            or 'torch="' not in text.splitlines()[1]:
        raise AssertionError(f"planes {name}: /metrics lacks {missing} or its {site} gauges")
    snap = json.loads(_scrape(server.address, "/devprof.json"))
    health = json.loads(_scrape(server.address, "/health.json"))
    if set(snap) != GOLDEN_DEVPROF_KEYS or set(snap["memory"]) != GOLDEN_MEMORY_KEYS or \
            any(set(r) != GOLDEN_SITE_KEYS for r in snap["sites"].values()) or \
            set(health) != {"counters", "histograms", "session", "recompiles", "devprof"} or \
            set(health["devprof"]) != GOLDEN_DEVPROF_KEYS:
        raise AssertionError(f"planes {name}: /devprof.json keys {sorted(snap)}, /health.json "
                             f"keys {sorted(health)}")
    return dispatches, launches, real


def run_device_planes(device, ctx, whole):
    """Phase 5h, the device planes (:data:`PLANES`): the profiler's
    overhead on A_frames (ratio of the medians of the rounds' seconds,
    armed without costs over disarmed, interleaved: a reading, not a
    gate); A_frames, A_paged_frames and C_frames_ragged with costs
    captured, each equal to its earlier arm's digest and checked by
    :func:`_check_planes_session`, with its bucket table printed (device
    ms against the bytes bound, ``kernel_bytes`` over HBM bandwidth); an
    armed ``apply_batch_compact`` under :func:`device_time_ms`, which
    fails if a hook synchronizes; and one ledger record of the phase's
    rows with the profiler's snapshot, whose device is this card; each row
    carries its session's stage decomposition (:func:`_session_latency`).
    ``whole`` is the run's build sentinel.  Returns the report, each armed
    session's launches, the snapshot and the record."""
    import torch

    from peritext_tpu_torch.obs import GLOBAL_DEVPROF, MetricsServer, RecompileSentinel
    from peritext_tpu_torch.obs.ledger import evaluate, ledger_record
    from peritext_tpu_torch.ops import kernel as kernel_mod

    cfg = STREAM
    t_phase = time.perf_counter()
    arrivals = {"A_frames": (ctx["workloads"], ctx["wire"], ctx["wire_bytes"], ctx["a"]["digest"]),
                "A_paged_frames": (ctx["workloads"], ctx["wire"], ctx["wire_bytes"],
                                   ctx["a"]["digest"]),
                "C_frames_ragged": (ctx["workloads_c"], ctx["wire_c"], ctx["wire_bytes_c"],
                                    ctx["cf"]["digest"])}
    captured = {}
    compact = kernel_mod._apply_batch_compact

    def capture_compact(state, counts, ins, dels, marks, maps, widths, loop_slots):
        # a round of a fused form's chain, taken from an eager run (a
        # capture's tensors would be graph memory)
        if "args" not in captured and not torch.cuda.is_current_stream_capturing():
            captured.update(args=_clone_tree((counts, ins, dels, marks, maps)),
                            state=_clone_tree(state),
                            kw=dict(widths=widths, insert_loop_slots=loop_slots))
        return compact(state, counts, ins, dels, marks, maps, widths, loop_slots)

    # the overhead pairs: the same session, disarmed and armed without costs
    seconds = {"disarmed": [], "armed": []}
    workloads, wire, wire_bytes, digest = arrivals["A_frames"]
    kernel_mod._apply_batch_compact = capture_compact
    try:
        for i in range(PLANES["overhead_pairs"]):
            for armed in ((False, True) if i % 2 == 0 else (True, False)):
                GLOBAL_DEVPROF.reset()
                if armed:
                    GLOBAL_DEVPROF.enable(capture_costs=False)
                try:
                    _, out = run_stream_session(device, cfg, workloads, wire,
                                                f"A_frames_{'armed' if armed else 'disarmed'}_{i}",
                                                wire_bytes=wire_bytes)
                finally:
                    GLOBAL_DEVPROF.disable()
                if out["digest"] != digest:
                    raise AssertionError(f"planes: A_frames armed={armed} digest differs from A's")
                st = out["stage_seconds"]
                seconds["armed" if armed else "disarmed"].append(
                    st["ingest"] + st["schedule"] + st["apply"])
    finally:
        kernel_mod._apply_batch_compact = compact
    ratio = float(np.median(seconds["armed"]) / np.median(seconds["disarmed"]))
    log(f"planes overhead: A_frames rounds armed (costs off) {seconds['armed']} s, disarmed "
        f"{seconds['disarmed']} s; ratio of medians {ratio:.4f}")

    # no hook synchronizes: the armed compact call keeps the host ahead
    GLOBAL_DEVPROF.reset()
    GLOBAL_DEVPROF.enable(capture_costs=False)
    try:
        args, kw, state = captured["args"], captured["kw"], captured["state"]
        call = lambda: kernel_mod.apply_batch_compact(state, *args, **kw)  # noqa: E731
        armed_ms = device_time_ms(call, PLANES["sync_reps"])
        calls = GLOBAL_DEVPROF.snapshot()["sites"]["apply_batch_compact"]["dispatches"]
    finally:
        GLOBAL_DEVPROF.disable()
    disarmed_ms = device_time_ms(call, PLANES["sync_reps"])
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    log(f"planes sync: armed apply_batch_compact {armed_ms:.6f} ms device time with the host "
        f"ahead over {calls} profiled calls (disarmed {disarmed_ms:.6f} ms); one call runs "
        f"{kernels} device events (torch.profiler)")

    # the armed sessions, costs captured, server mounted
    GLOBAL_DEVPROF.reset()
    GLOBAL_DEVPROF.enable(capture_costs=True)
    sentinel = RecompileSentinel().start()
    server = None
    rows, table, launches = [], [], {}
    try:
        for name, layout, site in PLANES["sessions"]:
            workloads, wire, wire_bytes, digest = arrivals[name]
            before = GLOBAL_DEVPROF.snapshot()
            t0 = time.perf_counter()
            s, out = run_stream_session(
                device, cfg, workloads, wire, f"{name}_armed", wire_bytes=wire_bytes,
                after_round=lambda s, r: sentinel.mark() if r == 0 else None, layout=layout)
            if out["digest"] != digest:
                raise AssertionError(f"planes {name}: the armed session's digest differs")
            after = GLOBAL_DEVPROF.snapshot()
            server = MetricsServer(devprof=GLOBAL_DEVPROF, sentinel=sentinel, session=s)
            server.start()
            dispatches, n_launch, real = _check_planes_session(
                name, layout, site, s, out, before, after, sentinel, server)
            server.stop()
            server = None
            launches[name] = n_launch
            for key, b in sorted(after["sites"][site]["buckets"].items()):
                if key in before["sites"].get(site, {}).get("buckets", {}):
                    continue
                cost = b["cost"]
                table.append(dict(session=name, site=site, bucket=key,
                                  dispatches=b["dispatches"], launches=cost["kernel_launches"],
                                  device_ms=cost["device_ms"], kernel_bytes=cost["kernel_bytes"],
                                  bytes_bound_ms=cost["kernel_bytes"] / HBM_BYTES_PER_S * 1e3,
                                  peak_bytes=b["memory"]["peak_bytes"]))
            rows.append(dict(row=name, metric="session_ops_per_s", value=out["ops_per_second"],
                             unit="ops/s", docs=len(workloads), ops_per_doc=cfg["ops"],
                             rounds=cfg["rounds"], latency=_session_latency(out)))
            log(f"planes {name}: {site} {dispatches} calls, {n_launch} launches = "
                f"{out['rga_insert_launches'] + out['ragged_insert_launches']} kernel launches; "
                f"occupancy real ops {real}; memory peak {after['memory']['peak_bytes_in_use']} "
                f"bytes; endpoints ok; {time.perf_counter() - t0:.2f} s")
            del s
        snap = GLOBAL_DEVPROF.snapshot()
    finally:
        if server is not None:
            server.stop()
        sentinel.stop()
        GLOBAL_DEVPROF.disable()
        GLOBAL_DEVPROF.reset()
    for row in table:
        log("planes bucket", json.dumps(row))
    record = ledger_record(rows, config="chip_smoke.planes", devprof=snap)
    if record["device"]["platform"] != "gpu" or \
            record["device"]["kind"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"planes: ledger device {record['device']}")
    verdicts = evaluate([record])
    report = dict(overhead_ratio=ratio, overhead_seconds=seconds, sync_armed_ms=armed_ms,
                  sync_disarmed_ms=disarmed_ms, call_device_events=kernels, buckets=len(table),
                  launches=launches,
                  ledger=dict(device=record["device"], sha=record["sha"], rows=record["rows"],
                              statuses=[v["status"] for v in verdicts["rows"]]),
                  sentinel=dict(counts=sentinel.counts, whole_run=dict(whole.counts)),
                  seconds=time.perf_counter() - t_phase)
    log("planes", json.dumps(report))
    return report, launches, snap, record


def _session_latency(out):
    """A session report's stages in the latency plane's taxonomy, as a
    ledger row's ``latency``: ``stage`` its ingest, ``dispatch`` the drains
    less their applies, ``commit`` the applies, ``visibility`` the first
    read (``read_all``); ``total_ms`` all but visibility, as the plane
    sums it."""
    st = out["stage_seconds"]
    stages = {"stage": st["ingest"] * 1e3, "dispatch": st["schedule"] * 1e3,
              "commit": st["apply"] * 1e3, "visibility": st["read_all"] * 1e3}
    return {"stages_ms": stages,
            "total_ms": sum(v for s, v in stages.items() if s != "visibility")}


def _pad_corrected(digest, spans, from_slots, to_slots):
    """``digest`` of docs held at ``from_slots`` slots, moved to
    ``to_slots``: each doc's pad term (``doc_digest_host`` of no
    characters) counts its empty slots, slots less visible characters and
    none below 0, the only part of the digest that depends on the slot
    capacity."""
    from peritext_tpu_torch.parallel.mesh import doc_digest_host

    for doc in spans:
        visible = sum(len(span["text"]) for span in doc)
        digest += (doc_digest_host([], [], max(to_slots - visible, 0))
                   - doc_digest_host([], [], max(from_slots - visible, 0)))
    return digest & 0xFFFFFFFF


def _overflowed_docs(s):
    """The docs whose state the device read path cannot serve (the
    resolutions' overflow rows), which read through the scalar oracle."""
    docs = []
    for bi in range(s._n_blocks()):
        lo, _ = s._block_bounds(bi)
        rows = np.nonzero(s._resolution(bi).overflow)[0] + lo
        docs += [int(s._doc_at[r]) for r in rows if s._doc_at[r] >= 0]
    return sorted(docs)


def _obs_cli(argv):
    """``python -m peritext_tpu_torch.obs`` in this process: its exit code,
    stdout and stderr."""
    import contextlib
    import io

    from peritext_tpu_torch.obs.__main__ import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = main([str(a) for a in argv])
    return code, out.getvalue(), err.getvalue()


def run_planner(device, ctx, snap, record, root):
    """Phase 5i, the planner and the ``obs`` CLI (:data:`PLANNER`) over
    5h's devprof snapshot ``snap`` and ledger ``record``, with files under
    ``root`` (module doc).  Returns the report, the replays' launches by
    layout, and the captured round of each replay (K1's padded inputs and
    their ``loop_slots``, K3's inputs)."""
    from peritext_tpu_torch.obs import GLOBAL_DEVPROF, MetricsServer
    from peritext_tpu_torch.obs.latency import STAGES
    from peritext_tpu_torch.obs.ledger import append_record
    from peritext_tpu_torch.plan import CostModel, propose

    # the heap holds every earlier phase's workloads: a full collection of
    # it takes seconds (5.4-8.4 s on an H100 machine's host, once inside a
    # replay's reads), so it runs here, counted apart from the phase
    t0 = time.perf_counter()
    gc.collect()
    log(f"planner: full collection before the phase {time.perf_counter() - t0:.2f} s")
    t_phase = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    snap_path, ledger_path = root / "devprof.json", root / "ledger.jsonl"
    snap_path.write_text(json.dumps(snap))
    append_record(ledger_path, record)

    # propose: in process twice, then the real entry point
    proposal = propose(snap, [record])
    body = proposal.to_json()
    again = propose(json.loads(snap_path.read_text()), [record]).to_json()
    if json.dumps(again, sort_keys=True) != json.dumps(body, sort_keys=True):
        raise AssertionError("planner: two proposals from one snapshot differ")
    stale = proposal.beats_current()
    proc = subprocess.run(
        [sys.executable, "-m", "peritext_tpu_torch.obs", "plan", str(snap_path), "--ledger",
         str(ledger_path), "--json"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    cli = json.loads(proc.stdout) if proc.stdout.strip() else {}
    if proc.returncode != int(stale) or cli.get("beats_current") != stale or \
            {k: cli.get(k) for k in body} != json.loads(json.dumps(body)):
        raise AssertionError(f"planner: obs plan exited {proc.returncode} (beats_current "
                             f"{stale}) with {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    garbage = root / "garbage.json"
    garbage.write_text("{not json")
    code, _, _ = _obs_cli(["plan", garbage])
    if code != 2:
        raise AssertionError(f"planner: obs plan on a garbage file exited {code}, want 2")
    modeled = body["modeled"]
    log(f"planner: observed statics {json.dumps(body['current'])}")
    log(f"planner: proposed statics {json.dumps(body['proposal'])}; beats current {stale} "
        f"(obs plan exited {proc.returncode})")
    log(f"planner: modeled {json.dumps(modeled)}; budget_bytes {modeled['budget_bytes']}")

    # replay A's frames at the proposed statics, on K1 and on K3
    a = ctx["a"]
    cfg = dict(STREAM, slot_capacity=proposal.slot_capacity,
               round_caps=(proposal.insert_width, proposal.delete_width, proposal.mark_width,
                           proposal.map_width),
               page_size=min(proposal.page_size, proposal.slot_capacity))
    want_digest = _pad_corrected(a["digest"], a["spans"], STREAM["slot_capacity"],
                                 cfg["slot_capacity"])
    captures = {"padded": {}, "ragged": {}}
    launches, replays = {}, {}
    GLOBAL_DEVPROF.reset()
    GLOBAL_DEVPROF.enable(capture_costs=False)
    server = None
    try:
        for layout in ("padded", "ragged"):
            name = f"plan_replay_{layout}"
            s, out = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"], name,
                                        capture=captures[layout], wire_bytes=ctx["wire_bytes"],
                                        layout=layout)
            for key in ("spans", "patches"):
                if out[key] != a[key]:
                    raise AssertionError(f"planner {name}: {key} differ from A_default")
            if out["digest"] != want_digest:
                raise AssertionError(f"planner {name}: digest {out['digest']}, A's at "
                                     f"{cfg['slot_capacity']} slots {want_digest}")
            kernel = "ragged_insert_launches" if layout == "ragged" else "rga_insert_launches"
            launches[layout] = out[kernel]
            overflowed = _overflowed_docs(s)
            replays[layout] = dict(launches=out[kernel], demoted=out["fallback"],
                                   overflowed=overflowed, wall_seconds=out["wall_seconds"])
            log(f"planner {name}: equals A on all {len(out['spans'])} docs (spans, patches, "
                f"digest at {cfg['slot_capacity']} slots); {len(out['fallback'])} docs demoted "
                f"{out['fallback']}, {len(overflowed)} overflowed {overflowed}")
        replay_snap = GLOBAL_DEVPROF.snapshot()
        log(f"planner: the replays observed as {json.dumps(CostModel(replay_snap).observed_config())}")

        # the operator surface: the proposal mounted beside the profiler
        server = MetricsServer(devprof=GLOBAL_DEVPROF, plan=proposal, session=s)
        host, port = server.start()
        status_code, text, _ = _obs_cli(["status", f"http://{host}:{port}", "--json"])
        status = json.loads(text)
        routes = {path[1:-len(".json")] for path in server._httpd._routes if path.endswith(".json")}
    finally:
        if server is not None:
            server.stop()
        GLOBAL_DEVPROF.disable()
        GLOBAL_DEVPROF.reset()
    rows = {r["plane"]: r for r in status["planes"]}
    if status_code != max(r["exit"] for r in rows.values()) or status_code != status["exit"] or \
            set(rows) != routes or rows["plan"]["exit"] != int(stale) or \
            " ops site(s)" not in rows["devprof"]["summary"]:
        raise AssertionError(f"planner: obs status exited {status_code} with rows {rows} "
                             f"(routes {sorted(routes)})")
    log(f"planner: obs status exited {status_code}: " + "; ".join(
        f"{p} {r['status']} ({r['summary']})" for p, r in sorted(rows.items())))

    # the perf gate and its attribution on the card record
    gate = root / "gate.jsonl"
    for _ in range(2):
        append_record(gate, record)
    code, _, _ = _obs_cli(["perf", gate, "--gate"])
    if code != 0:
        raise AssertionError(f"planner: obs perf --gate on the card record twice exited {code}")
    bad = json.loads(json.dumps(record))
    row = bad["rows"][0]
    row["value"] *= PLANNER["regress"]
    row["latency"]["stages_ms"] = {k: v / PLANNER["regress"]
                                   for k, v in row["latency"]["stages_ms"].items()}
    append_record(gate, bad)
    perf_code, _, _ = _obs_cli(["perf", gate, "--gate"])
    why_code, _, why_err = _obs_cli(["why", gate])
    why_json = json.loads(_obs_cli(["why", gate, "--json"])[1])
    stages = record["rows"][0]["latency"]["stages_ms"]
    moved = max(STAGES, key=lambda s: (stages.get(s, 0.0), -STAGES.index(s)))
    if perf_code != 1 or why_code != 1 or why_json["dominant_stage"] != moved or \
            f"dominant moved stage is '{moved}'" not in why_err:
        raise AssertionError(f"planner: perf --gate exited {perf_code}, why {why_code} "
                             f"({why_json.get('dominant_stage')}, want {moved}): {why_err}")
    log(f"planner: perf --gate 0 on the card record twice, 1 with {row['row']} at "
        f"{PLANNER['regress']}x; why exited 1 naming '{moved}' "
        f"(+{why_json['stage_deltas_ms'][moved]:.3f} ms)")
    seconds = time.perf_counter() - t_phase
    report = dict(proposal=body["proposal"], current=body["current"], modeled=modeled,
                  beats_current=stale, replays=replays, status_exit=status_code,
                  why_stage=moved, seconds=seconds)
    log("planner", json.dumps(report))
    log(f"planner: phase 5i {seconds:.2f} s")
    if seconds > PLANNER["seconds"]:
        raise AssertionError(f"planner: phase 5i took {seconds:.2f} s, over "
                             f"{PLANNER['seconds']} s")
    return report, launches, captures


def phase_mesh():
    """The mesh of phase 5j: ``make_mesh(4)`` over ``cuda:0..3`` when four
    cards exist, else (asked for explicitly) 4 virtual shards on
    ``cuda:0``; and which of the two it is."""
    import torch

    from peritext_tpu_torch.parallel.mesh import make_mesh

    n = MESH["shards"]
    if torch.cuda.device_count() >= n:
        return make_mesh(n), "real"
    return make_mesh(devices=[torch.device("cuda", 0)] * n), "virtual"


def run_mesh(device, ctx, slice_run):
    """Phase 5j, the device mesh on the card (module doc): returns the K1
    launch counts of its paths, the K3 ones, and the kernel inputs of one
    captured mesh round of a shard (padded: K1; ragged: K3)."""
    import torch

    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.testing.fuzz import run_crash_restore

    t_phase = time.perf_counter()
    mesh, kind = phase_mesh()
    cards = list(dict.fromkeys(mesh.devices))
    log(f"mesh: a {kind} mesh of {mesh.size} shards over {[str(d) for d in mesh.devices]}")
    rga, ragged, captures = {}, {}, {"padded": {}, "ragged": {}}

    # (a) DocBatch(mesh=) on config 3, against the meshless merge of phase 3
    workloads, cursors, clean = slice_run
    cfg = SLICE
    batch = DocBatch(slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
                     comment_capacity=cfg["comment_capacity"], mesh=mesh)
    t0 = time.perf_counter()
    insert_batch.launches = 0
    report = batch.merge(workloads, cursors)
    for card in cards:
        torch.cuda.synchronize(card)
    rga["mesh_docbatch"] = insert_batch.launches
    for key in ("spans", "roots", "cursor_positions", "fallback_docs"):
        if getattr(report, key) != getattr(clean, key):
            raise AssertionError(f"mesh: DocBatch(mesh=) {key} differ from the meshless merge")
    if rga["mesh_docbatch"] != mesh.size:
        raise AssertionError(f"mesh: DocBatch(mesh=) launched K1 {rga['mesh_docbatch']} times "
                             f"for {mesh.size} shards")
    log(f"mesh: DocBatch(mesh=) on config 3 equals the meshless merge (spans, roots, cursors, "
        f"fallback set), {rga['mesh_docbatch']} K1 launches, {time.perf_counter() - t0:.3f} s; "
        f"stats {json.dumps(report.stats.to_json())}")

    # (b) A_frames over the mesh in each layout, on the fused drain (each
    # shard one staged upload and one site call a batch, through its own
    # graph cache), against phase 5's twin and the per-round mesh twin
    cfg = STREAM
    sessions = {}
    for layout in ("padded", "paged", "ragged"):
        name = f"A_frames_mesh_{layout}"
        s, out = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"], name,
                                    capture=captures.get(layout), wire_bytes=ctx["wire_bytes"],
                                    layout=layout, mesh=mesh)
        compare_arms(name, out, ctx["a"], "A_default")
        check_stream_session(name, s, out, ctx["workloads"], cfg, ctx["sample"], ctx["oracle_a"])
        _, twin = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"],
                                     f"{name}_per_round", wire_bytes=ctx["wire_bytes"],
                                     layout=layout, mesh=mesh, fused_pipeline=False)
        compare_arms(f"{name}_per_round", twin, out, name)
        _check_mesh_fused(name, out, twin)
        paths = ragged if layout == "ragged" else rga
        kernel = "ragged_insert_launches" if layout == "ragged" else "rga_insert_launches"
        paths[name], paths[f"{name}_per_round"] = out[kernel], twin[kernel]
        log(f"mesh: {name} equals A on all {cfg['docs']} docs and its per-round mesh twin; "
            f"{out['ops_per_second']:.1f} session ops/s (per round "
            f"{twin['ops_per_second']:.1f}) against meshless A_frames' "
            f"{ctx['frames_ops_per_second']:.1f} (ratio "
            f"{out['ops_per_second'] / ctx['frames_ops_per_second']:.4f}); graphs per shard "
            f"{json.dumps(out['shard_graphs'])}")
        sessions[layout] = s

    # (d) a paged reshard under the mesh: pages move between shards
    s = sessions.pop("paged")
    digest, spans = s.digest(), s.read_all()
    moves, counted = s.store.ici_page_moves, GLOBAL_COUNTERS.get("store.ici_page_moves")
    t0 = time.perf_counter()
    out = s.reshard()
    seconds = time.perf_counter() - t0
    moved = s.store.ici_page_moves - moves
    if s.digest() != digest or s.digest(refresh=True) != digest or s.read_all() != spans:
        raise AssertionError("mesh: the paged reshard changed a read or the digest")
    if any(s.read_patches_all()):
        raise AssertionError("mesh: the paged reshard changed a doc's characters")
    if not out["moved"] or not moved or \
            GLOBAL_COUNTERS.get("store.ici_page_moves") - counted != moved:
        raise AssertionError(f"mesh: reshard moved {out['moved']} docs and {moved} pages "
                             "between shards, and the counter must count them")
    log(f"mesh: paged reshard in {seconds:.3f} s moved {out['moved']} docs and {moved} pages "
        f"between shards; digest and reads unchanged; shard stats {json.dumps(s._mesh_stats())}")
    del sessions, s

    # (c) C_frames at full width over the mesh, against phase 5's C_frames
    # and the per-round mesh twin
    s_c, c = run_stream_session(device, cfg, ctx["workloads_c"], ctx["wire_c"], "C_frames_mesh",
                                wire_bytes=ctx["wire_bytes_c"], mesh=mesh)
    compare_arms("C_frames_mesh", c, ctx["cf"], "C_frames")
    check_stream_session("C_frames_mesh", s_c, c, ctx["workloads_c"], cfg, ctx["sample_c"],
                         ctx["oracle_c"])
    del s_c
    _, c_twin = run_stream_session(device, cfg, ctx["workloads_c"], ctx["wire_c"],
                                   "C_frames_mesh_per_round", wire_bytes=ctx["wire_bytes_c"],
                                   mesh=mesh, fused_pipeline=False)
    compare_arms("C_frames_mesh_per_round", c_twin, c, "C_frames_mesh")
    _check_mesh_fused("C_frames_mesh", c, c_twin)
    rga["C_frames_mesh"] = c["rga_insert_launches"]
    rga["C_frames_mesh_per_round"] = c_twin["rga_insert_launches"]
    log(f"mesh: C_frames_mesh ({c['padded_docs']} rows, {mesh.size} shards of "
        f"{c['padded_docs'] // mesh.size}) equals C_frames and its per-round mesh twin; "
        f"{c['ops_per_second']:.1f} session ops/s (per round {c_twin['ops_per_second']:.1f}); "
        f"peak memory by card {json.dumps(c['peak_memory_bytes_by_card'])}; graphs per shard "
        f"{json.dumps(c['shard_graphs'])}")

    # (f) A's workload in fine arrival rounds over the padded mesh: the
    # signatures repeat, and every shard's graph cache replays
    from peritext_tpu_torch.testing.arrival import build_arrival

    t0 = time.perf_counter()
    ctx["fine"] = build_arrival(ctx["workloads"], FUSED_PIPE["fine_rounds"], cfg["seed"],
                                as_frames=True, wire=cfg["wire"])
    ctx["fine_seconds"] = time.perf_counter() - t0
    _, fine = run_stream_session(device, cfg, ctx["workloads"], ctx["fine"][0],
                                 "A_frames_mesh_fine", wire_bytes=ctx["fine"][1], mesh=mesh)
    compare_arms("A_frames_mesh_fine", fine, ctx["a"], "A_default")
    per_shard = [_graph_totals(stats) for stats in fine["shard_graphs"]]
    if any(t["replays"] == 0 or t["hits"] == 0 for t in per_shard):
        raise AssertionError(f"mesh: A_frames_mesh_fine graphs per shard {per_shard}: every "
                             "shard must replay its repeated signatures")
    rga["A_frames_mesh_fine"] = fine["rga_insert_launches"]
    log(f"mesh: A_frames_mesh_fine ({fine['rounds']} rounds) equals A; graphs per shard "
        f"{json.dumps(per_shard)}; {fine['ops_per_second']:.1f} session ops/s")

    # (e) the crash campaign with the mesh, restoring meshless
    start = _phase_counts()
    t0 = time.perf_counter()
    redelivered = run_crash_restore(MESH["crash_seed"], num_docs=CRASH["docs"],
                                    ops_per_doc=CRASH["ops"], mesh=mesh, device=device)
    delta = _phase_delta(start)
    _check_padded_launches("mesh crash restore", delta)
    rga[f"mesh_crash_seed{MESH['crash_seed']}"] = delta["rga_insert"]
    log(f"mesh: run_crash_restore seed {MESH['crash_seed']} ({CRASH['docs']} docs x "
        f"{CRASH['ops']} ops) with the mesh, restored meshless, passed in "
        f"{time.perf_counter() - t0:.3f} s, {redelivered} frames redelivered; launches "
        f"{json.dumps(delta)}")
    for layout, cap in captures.items():
        if "args" not in cap:
            raise AssertionError(f"mesh: no {layout} round of a shard was captured")
    seconds = time.perf_counter() - t_phase
    log(f"mesh: phase 5j took {seconds:.1f} s; K1 launches {json.dumps(rga)}, K3 launches "
        f"{json.dumps(ragged)}")
    if seconds > MESH["seconds"]:
        raise AssertionError(f"mesh: phase 5j took {seconds:.1f} s, over {MESH['seconds']} s")
    return rga, ragged, captures


def _check_mesh_fused(name, out, twin) -> None:
    """A mesh session on the fused drain and its per-round twin: the fused
    one counted its batches and staged every upload on its shards' copy
    lanes (at least one a batch), the twin neither."""
    if not out["fused_dispatches"] or out["h2d_copies"] < out["fused_dispatches"] or \
            twin["fused_dispatches"] or twin["h2d_copies"]:
        raise AssertionError(f"mesh: {name} made {out['h2d_copies']} staged copies for "
                             f"{out['fused_dispatches']} batches, its per-round twin "
                             f"{twin['h2d_copies']} for {twin['fused_dispatches']}")


def _record_insert_call(index):
    """Patch the padded path's kernel wrapper to keep the inputs of its
    ``index``-th call (cloned) and its ``loop_slots``; returns the record
    and the undo."""
    from peritext_tpu_torch.ops import kernel as kernel_mod

    insert = kernel_mod.insert_batch
    record = {"calls": 0}

    def rec(*args, loop_slots=None, **kw):
        if record["calls"] == index:
            record.update(args=[a.clone() for a in args], loop_slots=loop_slots)
        record["calls"] += 1
        return insert(*args, loop_slots=loop_slots, **kw)

    kernel_mod.insert_batch = rec
    return record, lambda: setattr(kernel_mod, "insert_batch", insert)


def run_baseline_engine(device, ctx):
    """Phase 5k (module doc): (a) the C++ scalar baseline at the reference
    bench's shape, against the oracle and against ``DocBatch`` on the card;
    (b) a capture session at A_frames' shape and its uncaptured twin, then
    the captured rounds replayed on the card (testing/engine.py): the
    digest on every pass, the launches per pass, single-pass and steady
    ops/s.  Returns the K1 launch counts of its paths and the inputs of one
    replayed round's insert call."""
    import torch

    from peritext_tpu_torch import native
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.testing.baseline import (
        check_scalar_apply_matches_oracle,
        workload_op_matrices,
    )
    from peritext_tpu_torch.testing.engine import EngineReplay, replay_digest, replay_rounds
    from peritext_tpu_torch.testing.fuzz import generate_workload

    t_phase = time.perf_counter()
    launches = {}

    # (a) the scalar baseline (bench.py measure_native_baseline)
    cfg = BASELINE["scalar"]
    workloads = generate_workload(cfg["seed"], cfg["docs"], cfg["ops"])
    matrices, total = workload_op_matrices(workloads)
    check_scalar_apply_matches_oracle(workloads, matrices)
    calls = native.calls.get("scalar_apply", 0)
    best = None
    for _ in range(cfg["sweeps"]):
        t0 = time.perf_counter()
        for _ in range(cfg["reps"]):
            for m in matrices:
                native.scalar_apply(m)
        dt = (time.perf_counter() - t0) / cfg["reps"]
        best = dt if best is None or dt < best else best
    if native.calls["scalar_apply"] - calls != cfg["sweeps"] * cfg["reps"] * len(matrices):
        raise AssertionError("baseline: the native library did not serve every scalar apply")
    scalar_ops = total / best
    texts = ["".join(chr(int(c)) for c in native.scalar_apply(m)[1]) for m in matrices]
    batch = DocBatch(slot_capacity=SLICE["slot_capacity"], mark_capacity=SLICE["mark_capacity"],
                     comment_capacity=SLICE["comment_capacity"], device=device)
    insert_batch.launches = 0
    t0 = time.perf_counter()
    report = batch.merge(workloads)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    launches["baseline_merge"] = insert_batch.launches
    if report.fallback_docs or launches["baseline_merge"] != 1:
        raise AssertionError(f"baseline: DocBatch fell back on {report.fallback_docs} and "
                             f"launched K1 {launches['baseline_merge']} times (one launch)")
    for d, spans in enumerate(report.spans):
        if "".join(sp["text"] for sp in spans) != texts[d]:
            raise AssertionError(f"baseline: doc {d}'s text on the card != the scalar apply's")
    log("baseline", json.dumps(dict(docs=cfg["docs"], ops_per_doc=cfg["ops"], seed=cfg["seed"],
                                    total_ops=total, sweep_seconds=best,
                                    scalar_ops_per_second=scalar_ops,
                                    docbatch_merge_seconds=merge_s,
                                    docbatch_k1_launches=launches["baseline_merge"])))
    log(f"baseline: the scalar apply equals the oracle and DocBatch(device=cuda) on all "
        f"{cfg['docs']} docs; {scalar_ops:.1f} scalar ops/s on one host core")

    # (b) the engine replay (bench.py run_engine) at A_frames' shape
    cfg = STREAM
    captured = []
    s, out = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"], "A_frames_capture",
                                wire_bytes=ctx["wire_bytes"], engine_capture=captured)
    launches["engine_capture"] = out["rga_insert_launches"]
    compare_arms("A_frames_capture", out, ctx["a"], "A_default")
    if out["fallback"] or s.overflow_count():
        raise AssertionError(f"engine: {len(out['fallback'])} fallback and {s.overflow_count()} "
                             "overflowed docs would skew the replay and its digest")
    if out["digest"] != ctx["frames_digest"] or len(captured) != s.rounds or \
            out["block_applies"] != len(captured):
        raise AssertionError(f"engine: capture digest {out['digest']:#x} (A_frames "
                             f"{ctx['frames_digest']:#x}), {len(captured)} captured rounds of "
                             f"{s.rounds}, {out['block_applies']} block applies")
    _, twin = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"], "A_frames_twin",
                                 wire_bytes=ctx["wire_bytes"])
    launches["engine_twin"] = twin["rga_insert_launches"]
    compare_arms("A_frames_twin", twin, out, "A_frames_capture")
    digest = out["digest"]
    tables = s._digest_tables(0, s._padded_docs)
    caps = s.config

    engine = EngineReplay(captured, s._padded_docs, caps, device, tables)

    def counted_pass(run=engine):
        insert_batch.launches = 0
        got = replay_digest(run())
        if got != digest or insert_batch.launches != len(captured):
            raise AssertionError(f"engine: replay digest {got:#x} != session {digest:#x}, or "
                                 f"{insert_batch.launches} K1 launches for {len(captured)} rounds")

    # pass 1 runs eagerly, pass 2 captures the graph and replays it, every
    # later pass is one replay
    timed = []
    for _ in range(5):
        t0 = time.perf_counter()
        counted_pass()
        timed.append(time.perf_counter() - t0)
        launches.setdefault("engine_replay", insert_batch.launches)
    eager_s, capture_s, single = timed[0], timed[1], timed[2:]
    passes = BASELINE["passes"]
    insert_batch.launches = 0
    t0 = time.perf_counter()
    per_docs = [engine() for _ in range(passes)]
    last = replay_digest(per_docs[-1])
    steady = (time.perf_counter() - t0) / passes
    digests = [replay_digest(p) for p in per_docs[:-1]] + [last]
    if any(g != digest for g in digests) or insert_batch.launches != passes * len(captured):
        raise AssertionError(f"engine: steady passes gave {[hex(g) for g in digests]} with "
                             f"{insert_batch.launches} K1 launches (session {digest:#x})")
    graphs = engine.graphs.stats()
    want = {"apply_batch_compact_rounds": dict(eager=1, captures=1, replays=4 + passes,
                                               hits=3 + passes)}
    if graphs != want:
        raise AssertionError(f"engine: graph cache {graphs}, want {want}")
    # one replayed round's insert inputs, from a fresh replay's eager pass
    record, undo = _record_insert_call(BASELINE["round_index"])
    try:
        counted_pass(lambda: replay_rounds(captured, s._padded_docs, caps, device, tables))
    finally:
        undo()
    if "args" not in record:
        raise AssertionError("engine: no replayed round was captured")
    ops = out["ops"]
    stages = ("ingest", "schedule", "apply", "digest")
    e2e = {n: ops / sum(r["stage_seconds"][k] for k in stages)
           for n, r in (("capture", out), ("twin", twin))}
    row = dict(docs=len(ctx["workloads"]), ops=ops, rounds=len(captured),
               widths=[list(w) for _, w, _ in captured], loop_slots=[ls for _, _, ls in captured],
               steady_passes=passes, engine_steady_ops_per_second=ops / steady,
               engine_single_pass_ops_per_second=ops / min(single),
               engine_pass_seconds=min(single), engine_steady_seconds=steady,
               engine_eager_pass_seconds=eager_s, engine_capture_pass_seconds=capture_s,
               engine_graphs=graphs,
               capture_end_to_end_ops_per_second=e2e["capture"],
               twin_end_to_end_ops_per_second=e2e["twin"],
               capture_session_ops_per_second=out["ops_per_second"],
               twin_session_ops_per_second=twin["ops_per_second"],
               steady_vs_end_to_end=ops / steady / e2e["twin"],
               k1_launches_per_pass=launches["engine_replay"])
    log("engine", json.dumps(row))
    ctx["engine_row"] = row
    seconds = time.perf_counter() - t_phase
    log(f"engine: the replay of {len(captured)} captured rounds equals the capture session's "
        f"and A_frames' digest {digest:#x} on every pass, {len(captured)} K1 launches a pass; "
        f"steady {ops / steady:.1f} ops/s, single pass {ops / min(single):.1f} ops/s, "
        f"end to end {e2e['twin']:.1f} ops/s (ratio {ops / steady / e2e['twin']:.3f})")
    log(f"baseline: phase 5k took {seconds:.2f} s; K1 launches {json.dumps(launches)}")
    if seconds > BASELINE["seconds"]:
        raise AssertionError(f"baseline: phase 5k took {seconds:.2f} s, over "
                             f"{BASELINE['seconds']} s")
    return launches, record


def forced_reshard(s):
    """``reshard()`` of a one-block session over two read blocks (over one
    it moves no row), then one block again: the rows move by one
    permutation, so the session's state is new tensors."""
    chunk = s._read_chunk
    s._read_chunk = s._padded_docs // 2
    try:
        return s.reshard()
    finally:
        s._read_chunk = chunk


def _graph_totals(stats):
    return {k: sum(row[k] for row in stats.values())
            for k in ("eager", "captures", "replays", "hits")}


def run_fused_pipeline(device, ctx):
    """Phase 5l (module doc).  Returns the K1 and the K3 launch counts of
    its sessions, and the K3 inputs of one replayed ragged round."""
    from peritext_tpu_torch.testing.arrival import build_arrival

    cfg = STREAM
    t_phase = time.perf_counter()
    launches, ragged, rows = {}, {}, {}

    # (a) A_frames fused and per round
    outs = {}
    for name, kw in (("A_frames_fused", {}), ("A_frames_per_round", dict(fused_pipeline=False))):
        _, out = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"], name,
                                    wire_bytes=ctx["wire_bytes"], **kw)
        compare_arms(name, out, ctx["a"], "A_default")
        if out["digest"] != ctx["frames_digest"]:
            raise AssertionError(f"fused pipeline {name}: digest differs from A_frames'")
        outs[name] = out
        launches[name] = out["rga_insert_launches"]
    fused, twin = outs["A_frames_fused"], outs["A_frames_per_round"]
    if not fused["fused_dispatches"] or fused["h2d_copies"] != fused["fused_dispatches"] or \
            twin["h2d_copies"] or twin["fused_dispatches"]:
        raise AssertionError(f"fused pipeline: A_frames made {fused['h2d_copies']} staged copies "
                             f"for {fused['fused_dispatches']} batches (one each), the per-round "
                             f"twin {twin['h2d_copies']} for {twin['fused_dispatches']}")
    for name, out in outs.items():
        rows[name] = dict(rounds=out["rounds"], batches=out["fused_dispatches"],
                          h2d_copies=out["h2d_copies"], graphs=out["graphs"],
                          k1_launches=out["rga_insert_launches"],
                          block_applies=out["block_applies"], wall_seconds=out["wall_seconds"],
                          apply_seconds=out["stage_seconds"]["apply"],
                          drain_seconds=out["stage_seconds"]["schedule"]
                          + out["stage_seconds"]["apply"],
                          ops_per_second=out["ops_per_second"])

    # (a') A_frames on the ragged layout, fused and per round: a batch is
    # one staged upload and one site call (the ragged forms count no fused
    # dispatch, as the reference's: the graph cache's calls count batches)
    for name, kw in (("A_frames_ragged_fused", {}),
                     ("A_frames_ragged_per_round", dict(fused_pipeline=False))):
        _, out = run_stream_session(device, cfg, ctx["workloads"], ctx["wire"], name,
                                    wire_bytes=ctx["wire_bytes"], layout="ragged", **kw)
        compare_arms(name, out, ctx["a"], "A_default")
        if out["digest"] != ctx["frames_digest"]:
            raise AssertionError(f"fused pipeline {name}: digest differs from A_frames'")
        totals = _graph_totals(out["graphs"])
        ragged[name] = out["ragged_insert_launches"]
        rows[name] = dict(rounds=out["rounds"], graphs=out["graphs"],
                          batches=totals["eager"] + totals["captures"] + totals["hits"],
                          h2d_copies=out["h2d_copies"], k3_launches=out["ragged_insert_launches"],
                          ragged_applies=out["ragged_applies"], wall_seconds=out["wall_seconds"],
                          apply_seconds=out["stage_seconds"]["apply"],
                          drain_seconds=out["stage_seconds"]["schedule"]
                          + out["stage_seconds"]["apply"],
                          ops_per_second=out["ops_per_second"])
    fused, twin = rows["A_frames_ragged_fused"], rows["A_frames_ragged_per_round"]
    if not fused["batches"] or fused["h2d_copies"] != fused["batches"] or \
            twin["h2d_copies"] or twin["batches"]:
        raise AssertionError(f"fused pipeline: A_frames_ragged made {fused['h2d_copies']} staged "
                             f"copies for {fused['batches']} batches (one each), the per-round "
                             f"twin {twin['h2d_copies']} for {twin['batches']}")
    log(f"fused pipeline: A_frames_ragged fused graphs {json.dumps(fused['graphs'])}, "
        f"{fused['batches']} batches, apply {fused['apply_seconds']:.6f} s against "
        f"{twin['apply_seconds']:.6f} s per round")

    # (b) A's workload in fine rounds: padded with a forced reshard, paged
    # and ragged with their pools growing (the ragged arm against its
    # per-round twin, and K3 held on the first round of a replayed batch)
    t0 = time.perf_counter()
    if "fine" not in ctx:
        ctx["fine"] = build_arrival(ctx["workloads"], FUSED_PIPE["fine_rounds"], cfg["seed"],
                                    as_frames=True, wire=cfg["wire"])
    fine, fine_bytes = ctx["fine"]
    gen_seconds = ctx.get("fine_seconds", time.perf_counter() - t0)
    marks = {}
    replayed = {}

    def reshard_after(s, r):
        if r == FUSED_PIPE["reshard_after"] - 1:
            marks.update(epoch=s._graphs.epoch, captures=_graph_totals(s._graphs.stats())["captures"],
                         moved=forced_reshard(s)["moved"])

    def growth(s, r):
        if r == 0:
            marks.update(growths0=s.store.growths)
            if s.layout == "ragged":
                _record_ragged_replay(s, replayed)
        held = marks.setdefault("held", {})
        held[s._graphs.epoch] = max(held.get(s._graphs.epoch, 0), len(s._graphs))

    # the pooled arms: pages of 32 slots and a pool of one page per doc, so
    # the pool grows once docs pass their first page, between drains
    for name, layout, hook, arm_cfg, arm in (
            ("A_frames_fine", "padded", reshard_after, cfg, {}),
            ("A_paged_frames_fine", "paged", growth, dict(cfg, page_size=32),
             dict(pool_pages=cfg["docs"] + 1)),
            ("A_ragged_frames_fine", "ragged", growth, dict(cfg, page_size=32),
             dict(pool_pages=cfg["docs"] + 1))):
        marks.pop("held", None)
        s, out = run_stream_session(device, arm_cfg, ctx["workloads"], fine, name,
                                    wire_bytes=fine_bytes, after_round=hook, layout=layout,
                                    **arm)
        compare_arms(name, out, ctx["a"], "A_default")
        totals = _graph_totals(out["graphs"])
        if layout == "ragged":
            ragged[name] = out["ragged_insert_launches"]
        else:
            launches[name] = out["rga_insert_launches"]
        row = dict(rounds=out["rounds"], graphs=out["graphs"], totals=totals,
                   h2d_copies=out["h2d_copies"], k1_launches=out["rga_insert_launches"],
                   k3_launches=out["ragged_insert_launches"],
                   epoch=s._graphs.epoch, apply_seconds=out["stage_seconds"]["apply"],
                   wall_seconds=out["wall_seconds"], ops_per_second=out["ops_per_second"])
        calls = totals["eager"] + totals["captures"] + totals["hits"]
        if totals["captures"] == 0 or totals["replays"] == 0 or out["h2d_copies"] != calls:
            raise AssertionError(f"fused pipeline {name}: graphs {totals} over "
                                 f"{out['h2d_copies']} staged copies (one per batch); the "
                                 "repeated signatures must capture and replay")
        if layout == "padded":
            after = totals["captures"] - marks["captures"]
            row.update(reshard_moved=marks["moved"], epoch_before_reshard=marks["epoch"],
                       captures_after_reshard=after)
            if not marks["moved"] or s._graphs.epoch != marks["epoch"] + 1 or after <= 0:
                raise AssertionError(f"fused pipeline {name}: the reshard moved {marks['moved']} "
                                     f"rows, epoch {marks['epoch']} -> {s._graphs.epoch}, "
                                     f"{after} captures after it")
        else:
            row.update(growths=s.store.growths, growths_after_first_round=s.store.growths
                       - marks["growths0"], held_by_epoch=marks["held"])
            if s.store.growths <= marks["growths0"] or s._graphs.epoch < 1:
                raise AssertionError(f"fused pipeline {name}: pool growths {s.store.growths} "
                                     f"({marks['growths0']} after round 0), epoch "
                                     f"{s._graphs.epoch}: a growth between drains must bump it")
        if layout == "ragged":
            # no signature captured twice within an epoch; the digest equals
            # the per-round twin's
            if totals["hits"] == 0 or totals["captures"] > sum(marks["held"].values()):
                raise AssertionError(f"fused pipeline {name}: graphs {totals}, held by epoch "
                                     f"{marks['held']}")
            _, twin = run_stream_session(device, arm_cfg, ctx["workloads"], fine,
                                         f"{name}_per_round", wire_bytes=fine_bytes,
                                         layout=layout, fused_pipeline=False, **arm)
            compare_arms(f"{name}_per_round", twin, out, name)
            ragged[f"{name}_per_round"] = twin["ragged_insert_launches"]
            row.update(per_round_apply_seconds=twin["stage_seconds"]["apply"],
                       per_round_ops_per_second=twin["ops_per_second"])
        rows[name] = row
        del s
    if "args" not in replayed:
        raise AssertionError("fused pipeline: no replayed ragged batch was recorded")

    engine = ctx.get("engine_row", {})
    seconds = time.perf_counter() - t_phase
    report = dict(sessions=rows, fine_arrival_seconds=gen_seconds,
                  engine=dict(eager_pass_ms=engine.get("engine_eager_pass_seconds", 0) * 1e3,
                              capture_pass_ms=engine.get("engine_capture_pass_seconds", 0) * 1e3,
                              single_pass_ms=engine.get("engine_pass_seconds", 0) * 1e3,
                              steady_ms=engine.get("engine_steady_seconds", 0) * 1e3,
                              pr15_single_pass_ms=51.6, graphs=engine.get("engine_graphs")),
                  seconds=seconds)
    log("fused pipeline", json.dumps(report))
    log(f"fused pipeline: A_frames fused apply {rows['A_frames_fused']['apply_seconds']:.6f} s, "
        f"per round {rows['A_frames_per_round']['apply_seconds']:.6f} s; drain "
        f"{rows['A_frames_fused']['drain_seconds']:.6f} s against "
        f"{rows['A_frames_per_round']['drain_seconds']:.6f} s; engine single pass "
        f"{report['engine']['single_pass_ms']:.3f} ms (PR 15: 51.6 ms), steady "
        f"{report['engine']['steady_ms']:.3f} ms; phase 5l {seconds:.2f} s")
    if seconds > FUSED_PIPE["seconds"]:
        raise AssertionError(f"fused pipeline: phase 5l took {seconds:.2f} s, over "
                             f"{FUSED_PIPE['seconds']} s")
    return launches, ragged, replayed


def run_capture_audit(device, ctx, audit):
    """Phase 5m (module doc), inside the audit window that phases 5j-5l
    opened: the sessions that capture each listed (form, site) still
    unaudited, and the ``capture audit`` line and its checks.  Returns the
    K1 and the K3 launch counts of its sessions."""
    cfg = STREAM
    t_phase = time.perf_counter()
    fine, fine_bytes = ctx["fine"]
    launches, ragged, driven = {}, {}, []
    for (form, site), arm in CAPTURE_AUDIT["forms"].items():
        if (form, site) in audit.reports or arm is None:
            continue
        arm = dict(arm)
        if arm.pop("mesh", False):
            arm["mesh"] = phase_mesh()[0]
        if arm.pop("fusion_rows", False):
            half = cfg["docs"] // 2
            arm["fusion_rows"] = ((0, half), half)  # two tenants, every row
        name = f"audit_{form}_{site}".replace(".", "_")
        s, out = run_stream_session(device, cfg, ctx["workloads"], fine, name,
                                    wire_bytes=fine_bytes, **arm)
        compare_arms(name, out, ctx["a"], "A_default")
        if out["layout"] == "ragged":
            ragged[name] = out["ragged_insert_launches"]
        else:
            launches[name] = out["rga_insert_launches"]
        graphs = ([g.stats() for g in s._shard_graphs] if "mesh" in arm
                  else s._graphs.stats())
        driven.append(name)
        log(f"capture audit: {name} equals A; graphs {json.dumps(graphs)}")
        del s
    summary = audit.summary()
    log("capture audit", json.dumps({
        "forms": {k: {"seen": v["seen"], "outside": len(v["outside"])}
                  for k, v in summary.items()},
        "driven_in_5m": driven, "captured_set": len(audit.captured)}))
    missing = [f"{form}/{site}" for form, site in CAPTURE_AUDIT["forms"]
               if (form, site) not in audit.reports]
    outside = audit.outside()
    if missing or outside:
        raise AssertionError(f"capture audit: forms never captured {missing}; functions run "
                             f"inside a capture outside the captured set (each a missing "
                             f"capture-root marker) {outside}")
    seconds = time.perf_counter() - t_phase
    log(f"capture audit: phase 5m {seconds:.2f} s")
    if seconds > CAPTURE_AUDIT["seconds"]:
        raise AssertionError(f"capture audit: phase 5m took {seconds:.2f} s, over "
                             f"{CAPTURE_AUDIT['seconds']} s")
    return launches, ragged


def _record_ragged_replay(s, capture) -> None:
    """Record, into ``capture["args"]``, the ragged insert's inputs for the
    first round of the first batch of ``s`` (a meshless ragged session)
    that its graph cache replays: the pool planes as the replay finds them
    (cloned on the stream, in order), the batch's plan planes and its
    first round's streams and counts, as the graph copies them in."""
    from peritext_tpu_torch.ops.kernel import PAGED_AUX_FIELDS
    from peritext_tpu_torch.utils.device import unpack_int32
    from peritext_tpu_torch.utils.graphs import _binds_signature

    cache = s._graphs
    run = cache.run
    num_slots = PAGED_AUX_FIELDS.index("num_slots")
    overflow = PAGED_AUX_FIELDS.index("overflow")

    def recording(key, form, body, inputs, binds=()):
        full = (cache.epoch, form, key, tuple((tuple(x.shape), x.dtype) for x in inputs))
        if "args" not in capture and form == "apply_batch_ragged" and full in cache._graphs \
                and _binds_signature(binds) == cache._binds:
            buf, row_idx, *planes = inputs[:7]
            t = unpack_int32(buf, key[-1])
            aux = binds[2:]
            rows = row_idx.long()
            capture["args"] = [binds[0].clone(), binds[1].clone(), *(p.clone() for p in planes[:5]),
                               aux[num_slots][rows].clone(), aux[overflow][rows].clone(),
                               *(t[f"0.{n}"].clone() for n in ("ins_counts", "ins_ref", "ins_op",
                                                               "ins_char"))]
            capture["round"] = s.rounds
        return run(key, form, body, inputs, binds)
    cache.run = recording


def round_need(workloads):
    """The largest (inserts, deletes, marks, map ops) of any one change:
    round widths at least this wide never demote a change for width."""
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    need = [0, 0, 0, 0]
    for w in workloads:
        for log_ in w.values():
            for ch in log_:
                need = [max(a, b) for a, b in zip(need, StreamingMerge._op_counts(ch))]
    return need


def run_longtail(device, essay_job, docs_job):
    """The long-tail session (:data:`LONGTAIL`), the reference bench's
    ``longdoc`` shape moved to streaming, by frames, in the padded, paged
    and ragged layouts: paged and ragged must equal padded on every doc and
    in the digest, and every session passes :func:`check_stream_session`
    with the essay in its oracle sample."""
    from peritext_tpu_torch.testing.arrival import build_arrival

    cfg = LONGTAIL
    t0 = time.perf_counter()
    essay_workloads, essay_doc = essay_job.get(timeout=900)
    workloads = docs_job.get(timeout=900) + essay_workloads
    need = round_need(workloads)
    if any(n > c for n, c in zip(need, cfg["round_caps"])):
        raise AssertionError(f"longtail: a change needs {need}, wider than {cfg['round_caps']}")
    wire, wire_bytes = build_arrival(workloads, cfg["rounds"], cfg["seed"], as_frames=True,
                                     wire="v2")
    log(f"longtail: {cfg['docs']} docs x {cfg['ops']} ops + an essay of {cfg['essay_ops']} ops "
        f"(seed {cfg['essay_seed']}) ready in {time.perf_counter() - t0:.1f} s after the earlier "
        f"phases; widest change {need}; round widths {list(cfg['round_caps'])}")
    essay = len(workloads) - 1
    sample = sorted(random.Random(cfg["seed"]).sample(range(essay), cfg["sample"] - 1))
    oracle, outs = {essay: essay_doc}, {}
    for layout in ("padded", "paged", "ragged"):
        s, outs[layout] = run_stream_session(device, cfg, workloads, wire, f"longtail_{layout}",
                                             wire_bytes=wire_bytes, layout=layout)
        check_stream_session(f"longtail_{layout}", s, outs[layout], workloads, cfg,
                             sample + [essay], oracle)
        del s
    for layout, out in outs.items():
        log(f"longtail {layout}: wall {out['wall_seconds']:.3f} s, {out['ops_per_second']:.1f} "
            f"ops/s, peak memory {out['peak_memory_bytes']} bytes, fallback docs "
            f"{out['fallback']}, overflow docs {out['overflow_docs']}, pool_stats "
            f"{json.dumps(out['health'].get('page_pool'))}")
    for layout, out in outs.items():
        if not out["overflow_docs"]:
            raise AssertionError(f"longtail_{layout}: the essay did not overflow, so the host "
                                 "replay of an overflowed doc went untested")
    for layout in ("paged", "ragged"):
        compare_arms(f"longtail_{layout}", outs[layout], outs["padded"], "longtail_padded")
    log(f"longtail: paged and ragged equal padded on all {len(workloads)} docs (read_all, "
        "read_patches_all, digest, fallback)")
    return list(outs.values())


# ---------------------------------------------------------------------------
# the editor bridge's device backend
# ---------------------------------------------------------------------------


def _quantiles(ms):
    a = np.asarray(ms, np.float64)
    return dict(n=int(a.size), p50=float(np.percentile(a, 50)), p99=float(np.percentile(a, 99)),
                mean=float(a.mean()), max=float(a.max()))


def _phase_counts():
    """The insert kernels' launch counts and the padded commit counter, read
    at the start of a phase; :func:`_phase_delta` gives what the phase
    added."""
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert

    insert_batch.launches = 0
    ragged_insert.launches = 0
    return {c: GLOBAL_COUNTERS.get(c) for c in APPLY_COUNTER.values()}


def _phase_delta(start):
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert

    out = {"rga_insert": insert_batch.launches, "ragged_insert": ragged_insert.launches}
    out.update({c.split(".")[1]: int(GLOBAL_COUNTERS.get(c) - n) for c, n in start.items()})
    return out


def _check_padded_launches(phase, delta):
    """Every launch of a padded-session phase is one block apply."""
    if delta["rga_insert"] == 0 or delta["rga_insert"] != delta["block_applies"] or \
            delta["ragged_insert"]:
        raise AssertionError(f"{phase}: launches {delta} (one rga_insert launch per block apply)")


def _check_editors(phase, editors, oracle=None):
    """Each device-backed view equals its replica's full render (and the
    scalar oracle's view), and no session demoted or overflowed its doc."""
    from peritext_tpu_torch.bridge import editor_doc_from_crdt

    for ed in editors:
        if ed.view != editor_doc_from_crdt(ed.doc):
            raise AssertionError(f"{phase}: {ed.actor_id}'s view differs from its CRDT render")
        if oracle is not None and ed.view != oracle.view:
            raise AssertionError(f"{phase}: {ed.actor_id}'s view differs from the scalar editor's")
        if ed.session is not None:
            if ed.session.device.type != "cuda":
                raise AssertionError(f"{phase}: {ed.actor_id}'s session is on {ed.session.device}")
            if ed.session.docs[0].fallback or ed.session.overflow_count():
                raise AssertionError(f"{phase}: {ed.actor_id}'s doc left the card")


def run_pm_fixtures():
    """The nine ProseMirror-wire sessions of ``tests/pm_fixtures`` (plain
    JSON), each through two ``"tpu"`` editors on the reference defaults:
    both views must serialize to the fixture's ``expected_doc``."""
    from peritext_tpu_torch.bridge import create_editor, initialize_docs
    from peritext_tpu_torch.bridge.pm import editor_doc_to_pm, transaction_from_pm
    from peritext_tpu_torch.parallel.pubsub import Publisher

    paths = sorted((ROOT / "tests" / "pm_fixtures").glob("*.json"))
    if len(paths) != 9:
        raise AssertionError(f"bridge: {len(paths)} PM fixtures, expected 9")
    start = _phase_counts()
    for path in paths:
        spec = json.loads(path.read_text())
        pub = Publisher()
        editors = [create_editor(name, pub, backend="tpu", actors=("alice", "bob"))
                   for name in ("alice", "bob")]
        by_name = {ed.actor_id: ed for ed in editors}
        initialize_docs(editors, spec["initial"])
        for event in spec["events"]:
            if event.get("sync"):
                for ed in editors:
                    ed.sync()
            else:
                by_name[event["editor"]].dispatch(transaction_from_pm(event["steps"]))
        for ed in editors:
            ed.sync()
        for ed in editors:
            if editor_doc_to_pm(ed.view) != spec["expected_doc"]:
                raise AssertionError(f"bridge: fixture {path.stem}: {ed.actor_id}'s view != "
                                     "expected_doc")
        _check_editors(f"bridge fixture {path.stem}", editors)
    delta = _phase_delta(start)
    _check_padded_launches("bridge pm fixtures", delta)
    log(f"bridge: the {len(paths)} PM fixtures on two tpu editors each equal expected_doc; "
        f"launches {json.dumps(delta)}")
    return delta


def _fuzz_transaction(rng, cfg, n, i):
    """One transaction of the fuzzed session, as (command, args)."""
    r = rng.random()
    if r < 0.62 or n < 8:
        return "type_text", (rng.randint(1, n + 1), (rng.choice(WORDS) + " ")[:rng.randint(1, 3)])
    if r < 0.84:
        a = rng.randint(1, n)
        return "delete_range", (a, a + min(n + 1 - a, rng.randint(1, 2)))
    a = rng.randint(1, n - 1)
    b = min(n + 1, a + rng.randint(2, 40))
    m = rng.random()
    if m < 0.35:
        return "toggle_bold", (a, b)
    if m < 0.7:
        return "toggle_italic", (a, b)
    if m < 0.85:
        return "set_link", (a, b, f"https://{rng.randrange(cfg['urls'])}.example")
    return "add_comment", (a, b, f"c{i % cfg['comment_ids']}")


def run_bridge_fuzz(capture):
    """The fuzzed editing session (:data:`BRIDGE`): three ``"tpu"`` editors
    on the card and one scalar editor, the oracle.  Dispatch latency is
    each command's wall; remote apply latency each delivery's, from
    ``_receive`` to the view updated.  ``capture`` records the insert call
    of transaction ``capture_at``."""
    import torch

    from peritext_tpu_torch.bridge import commands, create_editor, initialize_docs
    from peritext_tpu_torch.parallel.pubsub import Publisher

    torch.cuda.reset_peak_memory_stats()
    cfg = BRIDGE
    rng = random.Random(cfg["seed"])
    pub = Publisher()
    editors = [create_editor(name, pub, backend="tpu", actors=cfg["editors"],
                             backend_config=dict(cfg["backend_config"]))
               for name in cfg["editors"]]
    oracle = create_editor("oracle", pub)
    remote_ms = []
    for ed in editors:  # time each delivery to a device-backed editor
        inner = pub._subscribers[ed.actor_id]

        def timed(changes, inner=inner):
            t0 = time.perf_counter()
            inner(changes)
            remote_ms.append((time.perf_counter() - t0) * 1e3)
        pub._subscribers[ed.actor_id] = timed
    undo = _arm_capture(capture, "padded")
    start = _phase_counts()
    kinds = {}
    dispatch_ms = []
    t_all = time.perf_counter()
    try:
        initial = " ".join(rng.choice(WORDS) for _ in range(cfg["initial_words"])) + "."
        initialize_docs(editors + [oracle], initial)
        for i in range(cfg["transactions"]):
            ed = editors[rng.randrange(len(editors))]
            name, args = _fuzz_transaction(rng, cfg, len(ed.view), i)
            kinds[name] = kinds.get(name, 0) + 1
            if i == cfg["capture_at"]:
                capture["armed"] = True
            t0 = time.perf_counter()
            getattr(commands, name)(ed, *args)
            dispatch_ms.append((time.perf_counter() - t0) * 1e3)
            if i % cfg["sync_every"] == cfg["sync_every"] - 1:
                for e in editors + [oracle]:
                    e.sync()
            if i % 500 == 499:
                _check_editors(f"bridge fuzz at {i + 1}", editors, oracle)
        for e in editors + [oracle]:
            e.sync()
    finally:
        undo()
    wall = time.perf_counter() - t_all
    delta = _phase_delta(start)
    _check_editors("bridge fuzz", editors, oracle)
    _check_padded_launches("bridge fuzz", delta)
    report = dict(transactions=cfg["transactions"], kinds=kinds, chars=len(oracle.view),
                  wall_seconds=wall, dispatch_ms=_quantiles(dispatch_ms),
                  remote_apply_ms=_quantiles(remote_ms), launches=delta,
                  rounds=[ed.session.rounds for ed in editors],
                  peak_memory_bytes=torch.cuda.max_memory_allocated())
    log("bridge fuzz", json.dumps(report))
    if sum(report["rounds"]) != delta["block_applies"]:
        raise AssertionError(f"bridge fuzz: {report['rounds']} rounds, "
                             f"{delta['block_applies']} block applies")
    log(f"bridge: dispatch latency p50 {report['dispatch_ms']['p50']:.3f} ms, "
        f"p99 {report['dispatch_ms']['p99']:.3f} ms")
    log(f"bridge: remote apply latency p50 {report['remote_apply_ms']['p50']:.3f} ms, "
        f"p99 {report['remote_apply_ms']['p99']:.3f} ms")
    log(f"bridge: K1 launches {delta['rga_insert']} = block applies {delta['block_applies']} "
        f"= the sessions' committed rounds {report['rounds']} (one block each)")
    log(f"bridge: {cfg['transactions']} transactions on three tpu editors equal the scalar "
        f"editor and their CRDT renders ({len(oracle.view)} characters); no doc left the card")
    if "args" not in capture:
        raise AssertionError("bridge: no insert call was captured")
    return report


def run_bridge_timer():
    """Two ``"tpu"`` editors with ``start_queue=True``: no sync() call, the
    queues' timer threads alone must converge them."""
    import threading

    from peritext_tpu_torch.bridge import commands, create_editor, initialize_docs
    from peritext_tpu_torch.parallel.pubsub import Publisher

    names = ("alice", "bob")
    rng = random.Random(5)
    pub = Publisher()
    start = _phase_counts()
    editors = [create_editor(name, pub, queue_interval=0.005, start_queue=True, backend="tpu",
                             actors=names) for name in names]
    t0 = time.perf_counter()
    try:
        initialize_docs(editors, "Timers alone flush this session.")
        for i in range(60):
            ed = editors[i % 2]
            with ed.lock:  # the peer's timer thread delivers to ed meanwhile
                cmd, args = _fuzz_transaction(rng, BRIDGE, len(ed.view), i)
                getattr(commands, cmd)(ed, *args)
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline:
            a, b = editors
            if not len(a.queue) and not len(b.queue) and a.doc.clock == b.doc.clock \
                    and a.view == b.view:
                break
            time.sleep(0.01)
        converged = time.perf_counter() - t0
    finally:
        for ed in editors:
            ed.disconnect()
        for t in threading.enumerate():
            if isinstance(t, threading.Timer):
                t.join(timeout=10)
    a, b = editors
    if a.view != b.view or a.doc.clock != b.doc.clock:
        raise AssertionError("bridge timer: the editors did not converge by timer flushes")
    _check_editors("bridge timer", editors)
    delta = _phase_delta(start)
    _check_padded_launches("bridge timer", delta)
    log(f"bridge: two tpu editors converged by timer flushes alone in {converged:.3f} s "
        f"({len(a.view)} characters); launches {json.dumps(delta)}")
    return delta


# ---------------------------------------------------------------------------
# durability: checkpoints, the crash campaign, the guarded merge
# ---------------------------------------------------------------------------


def checkpoint_session(ckpts, name, s, out) -> None:
    """Save a session where it ends (``save_session``) and keep what its
    restore must equal."""
    from peritext_tpu_torch.checkpoint import save_session

    directory = ckpts["root"] / name
    t0 = time.perf_counter()
    meta = save_session(s, directory)
    seconds = time.perf_counter() - t0
    ckpts[name] = dict(
        directory=directory, layout=s.layout, docs=s.num_docs, frames=meta["frames"],
        save_seconds=seconds, bytes=sum(f.stat().st_size for f in directory.iterdir()),
        digest=s.digest(), digest_text=s.digest(full=False), frontier=s.frontier(),
        pending=s.pending_count(), fallback=out["fallback"], spans=out["spans"],
        patches=out["patches"])
    log(f"durability: saved {name} ({s.layout}, {s.num_docs} docs, {meta['frames']} frames, "
        f"{ckpts[name]['bytes']} bytes) in {seconds:.3f} s")


def run_restores(ckpts, capture):
    """Restore each checkpointed session on the card (:data:`DURABLE`) and
    hold it to its source: digests, reads, a fresh patch sweep, frontier,
    pending count and fallback set; its insert launches must equal its
    commit counter over the restore.  ``capture`` records the first ragged
    insert call of the ragged restore."""
    import torch

    from peritext_tpu_torch.checkpoint import restore_session

    reports = []
    for name in DURABLE:
        c = ckpts.pop(name)
        layout = c["layout"]
        undo = _arm_capture(capture, layout) if layout == "ragged" else None
        capture["armed"] = layout == "ragged"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = _phase_counts()
        try:
            t0 = time.perf_counter()
            r = restore_session(c["directory"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            if undo is not None:
                undo()
        delta = _phase_delta(start)
        peak = torch.cuda.max_memory_allocated()
        kernel = "ragged_insert" if layout == "ragged" else "rga_insert"
        other = "rga_insert" if layout == "ragged" else "ragged_insert"
        applies = delta[APPLY_COUNTER[layout].split(".")[1]]
        if delta[kernel] == 0 or delta[kernel] != applies or delta[other]:
            raise AssertionError(f"restore {name}: launches {delta} for {applies} "
                                 f"{APPLY_COUNTER[layout]}")
        if r.layout != layout or r.device.type != "cuda":
            raise AssertionError(f"restore {name}: {r.layout} on {r.device}")
        checks = {"digest()": (r.digest(), c["digest"]),
                  "digest(full=False)": (r.digest(full=False), c["digest_text"]),
                  "read_all()": (r.read_all(), c["spans"]),
                  "read_patches_all()": (r.read_patches_all(), c["patches"]),
                  "frontier()": (r.frontier(), c["frontier"]),
                  "pending_count()": (r.pending_count(), c["pending"]),
                  "fallback": ([d for d, sess in enumerate(r.docs) if sess.fallback],
                               c["fallback"])}
        for what, (got, want) in checks.items():
            if got != want:
                raise AssertionError(f"restore {name}: {what} differs from the saved session")
        report = dict(session=name, layout=layout, docs=c["docs"], frames=c["frames"],
                      checkpoint_bytes=c["bytes"], save_seconds=c["save_seconds"],
                      restore_seconds=seconds, rounds=r.rounds, launches=delta,
                      peak_memory_bytes=peak)
        log("restore", json.dumps(report))
        log(f"durability: {name} restored in {seconds:.3f} s ({r.rounds} rounds, {delta[kernel]} "
            f"{kernel} launches = {APPLY_COUNTER[layout]}); digests, reads, patches, frontier, "
            "pending count and fallback set equal the saved session")
        reports.append(report)
        del r, c
        gc.collect()
        torch.cuda.empty_cache()
    if "args" not in capture:
        raise AssertionError("durability: no ragged insert call was captured in the restore")
    return reports


def run_crash_campaigns():
    """``run_crash_restore`` on the card at each seed of :data:`CRASH`."""
    from peritext_tpu_torch.testing.fuzz import run_crash_restore

    out = {}
    for seed in CRASH["seeds"]:
        start = _phase_counts()
        t0 = time.perf_counter()
        redelivered = run_crash_restore(seed, num_docs=CRASH["docs"], ops_per_doc=CRASH["ops"])
        seconds = time.perf_counter() - t0
        delta = _phase_delta(start)
        _check_padded_launches(f"crash restore seed {seed}", delta)
        out[seed] = delta
        log(f"durability: run_crash_restore seed {seed} ({CRASH['docs']} docs x {CRASH['ops']} "
            f"ops) passed in {seconds:.3f} s, {redelivered} frames redelivered; launches "
            f"{json.dumps(delta)}")
    return out


def run_guarded(workloads, cursors, clean):
    """``DocBatch(guard=True)`` on config 3: without a fault it launches the
    insert kernel once and equals the unguarded report ``clean`` on every
    doc.  One injected failure at the kernel wrapper raises on the card,
    guarded or not; on a CPU batch the guard replays the whole batch
    through the oracle (the same spans, roots and cursors) and counts one
    guarded fallback."""
    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.ops import kernel as kernel_mod
    from peritext_tpu_torch.ops.insert import insert_batch

    cfg = SLICE
    kw = dict(slot_capacity=cfg["slot_capacity"], mark_capacity=cfg["mark_capacity"],
              comment_capacity=cfg["comment_capacity"])
    batch = DocBatch(guard=True, **kw)
    insert_batch.launches = 0
    report = batch.merge(workloads, cursors)
    launches = insert_batch.launches
    if launches != 1 or "guarded_fallback" in report.stats.extras:
        raise AssertionError(f"guarded merge: {launches} launches, extras {report.stats.extras}")
    for field in ("spans", "roots", "cursor_positions", "fallback_docs", "device_ops"):
        if getattr(report, field) != getattr(clean, field):
            raise AssertionError(f"guarded merge: {field} differ from the unguarded merge")

    real = kernel_mod.insert_batch

    def fault(*args, **kwargs):
        raise RuntimeError("injected device-stage failure")

    kernel_mod.insert_batch = fault
    try:
        for name, card_batch in (("guard=True", batch), ("guard=False", DocBatch(**kw))):
            try:
                card_batch.merge(workloads, cursors)
            except RuntimeError as exc:
                if "injected" not in str(exc):
                    raise
            else:
                raise AssertionError(f"guarded merge: {name} on the card did not raise the fault")
        before = GLOBAL_COUNTERS.get("merge.guarded_fallbacks")
        n = GUARDED_CPU_DOCS
        t0 = time.perf_counter()
        degraded = DocBatch(guard=True, device="cpu", **kw).merge(workloads[:n], cursors[:n])
        seconds = time.perf_counter() - t0
        if GLOBAL_COUNTERS.get("merge.guarded_fallbacks") != before + 1:
            raise AssertionError("guarded merge: merge.guarded_fallbacks did not count the fault")
        if degraded.fallback_docs != list(range(n)) or \
                degraded.stats.extras.get("guarded_fallback") != 1.0:
            raise AssertionError("guarded merge: the faulted merge did not degrade the batch")
        for field in ("spans", "roots", "cursor_positions"):
            if getattr(degraded, field) != getattr(clean, field)[:n]:
                raise AssertionError(f"guarded merge: degraded {field} differ from the clean merge")
    finally:
        kernel_mod.insert_batch = real
    log(f"durability: guarded merge of {len(workloads)} docs launched rga_insert {launches} "
        f"time(s) and equals the unguarded merge; one injected failure raised on the card, "
        f"guarded and unguarded; on a CPU batch of its first {n} docs it degraded all {n} to "
        f"the oracle in {seconds:.3f} s ({degraded.stats.extras['guarded_error']}), equal in "
        "spans, roots and cursors")
    return launches


# ---------------------------------------------------------------------------
# the serving tier and the supervisor
# ---------------------------------------------------------------------------


def serve_frames(workloads):
    """Each doc's changes (actor by actor, as the reference bench's serve
    row lists them) in v2 frames of ``SERVE["frame_changes"]`` changes."""
    from peritext_tpu_torch.parallel.codec import encode_frame

    n = SERVE["frame_changes"]
    plans = []
    for w in workloads:
        changes = [ch for log in w.values() for ch in log]
        plans.append([encode_frame(changes[i:i + n]) for i in range(0, len(changes), n)])
    return plans


def serve_session(device, docs, ops):
    """The serve row's session: the bench's capacities for ``ops`` ops a
    doc, its round widths, static rounds."""
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    return StreamingMerge(num_docs=docs, actors=ACTORS, static_rounds=True, device=device,
                          **_serve_widths(ops))


def _serve_widths(ops):
    """The serve row's capacities for ``ops`` ops a doc and its round widths."""
    ki, kd, km, kp = SERVE["round_caps"]
    return dict(slot_capacity=max(256, 4 * ops), mark_capacity=max(64, ops),
                tomb_capacity=max(128, ops), round_insert_capacity=ki,
                round_delete_capacity=kd, round_mark_capacity=km, round_map_capacity=kp)


def serve_factory(device, docs, ops, plans):
    """A fresh mux over a fresh session with one open client session per
    doc, and each session's frames: what every ladder rung starts from."""
    from peritext_tpu_torch.serve import AdmissionController, SessionMux

    def factory():
        mux = SessionMux(serve_session(device, docs, ops),
                         admission=AdmissionController(max_depth=max(256, 4 * docs),
                                                       session_quota=None),
                         host="chip_smoke")
        frames = {}
        for doc in range(docs):
            sid, verdict = mux.open_session(f"client{doc}")
            if not verdict.admitted:
                raise AssertionError(f"serve: session for doc {doc} refused: {verdict.to_json()}")
            frames[sid] = plans[doc]
        return mux, frames

    return factory


def serve_warm_walk(factory, docs):
    """The bench's warm-up: batches of 1, 2, 4, ... 2 * docs frames, each
    flushed, on a throwaway mux, so the allocator has grown for every
    batch size before a rung is measured."""
    mux, frames = factory()
    sids = sorted(frames)
    cursor = dict.fromkeys(sids, 0)
    batch = 1
    while batch <= 2 * docs:
        for i in range(batch):
            sid = sids[i % len(sids)]
            mux.submit(sid, frames[sid][cursor[sid] % len(frames[sid])])
            cursor[sid] += 1
        mux.flush()
        batch *= 2


def _rung_line(name, rung):
    r = rung.result
    return (f"{name} rung {rung.rate_per_s:.1f}/s: {'sustained' if rung.sustained else 'broke'}, "
            f"offered {r.offered}, admitted {r.admitted}, delayed {r.delayed}, shed {r.shed}, "
            f"p50 {r.p50_apply_s * 1e3:.3f} ms, p99 {r.p99_apply_s * 1e3:.3f} ms, rounds "
            f"{r.rounds}, window {r.window_seconds * 1e3:.3f} ms, wall {r.wall_seconds:.3f} s")


def serve_ladder(name, factory, base_rate, count, midpoint):
    """``sustained_ladder`` at ``base_rate * 2**i`` for i < ``count`` in
    rungs of ``SERVE["rung_seconds"]`` against the p99 SLO; with
    ``midpoint``, one more rung at 1.5x the best sustained rate when a rung
    broke (the bench's refinement).  Every rung must account for every
    offered frame.  Returns (rungs, best, broke)."""
    from peritext_tpu_torch.serve import sustained_ladder

    slo = SERVE["slo_ms"] / 1e3
    duration = SERVE["rung_seconds"]
    rungs, best = sustained_ladder(factory, [base_rate * 2 ** i for i in range(count)],
                                   slo_p99_s=slo, duration_s=duration)
    broke = next((r for r in rungs if not r.sustained), None)
    if midpoint and best is not None and broke is not None:
        mid, mid_best = sustained_ladder(factory, [best.rate_per_s * 1.5], slo_p99_s=slo,
                                         duration_s=duration)
        rungs += mid
        best = mid_best or best
    for rung in rungs:
        if not rung.result.accounted():
            raise AssertionError(f"{name}: a rung lost frames: {rung.to_json()}")
        log(_rung_line(name, rung))
    return rungs, best, broke


def _check_served(name, mux):
    _check_on_card(name, mux.session)


def _check_on_card(name, s):
    """No doc of session ``s`` fell back, was quarantined or overflowed."""
    fallback = [d for d, sess in enumerate(s.docs) if sess.fallback]
    if fallback or s.quarantined() or s.overflow_count():
        raise AssertionError(f"{name}: fallback {fallback[:20]}, quarantine "
                             f"{sorted(s.quarantined())[:20]}, overflow {s.overflow_count()}")


def run_serve_row(device):
    """Phase 5e (a): the reference bench's ``serve_sustained`` row at its
    own shape (:data:`SERVE` ``row``): the warm-up walk, the ladder with
    its midpoint rung, then the traced rung with the latency and history
    planes armed and a read every 4th committed pump, whose decomposition
    must be sum-consistent with no negative stage.  Returns the report and
    the insert launches of the phase (equal to its block applies)."""
    from peritext_tpu_torch.obs import LatencyPlane, TimeSeriesPlane, check_sum_consistency
    from peritext_tpu_torch.serve import build_arrivals, run_open_loop
    from peritext_tpu_torch.testing.fuzz import generate_workload

    cfg = SERVE["row"]
    t_phase = time.perf_counter()
    plans = serve_frames(generate_workload(SERVE["seed"], cfg["docs"], cfg["ops"]))
    factory = serve_factory(device, cfg["docs"], cfg["ops"], plans)
    start = _phase_counts()
    serve_warm_walk(factory, cfg["docs"])
    rungs, best, broke = serve_ladder("serve_row", factory, cfg["base_rate"], cfg["rungs"],
                                      midpoint=True)
    value = best.rate_per_s if best is not None else 0.0
    tmux, tframes = factory()
    plane = tmux.latency_plane = LatencyPlane().enable()
    history = tmux.history_plane = TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    duration = SERVE["rung_seconds"]
    trace_rate = max(cfg["base_rate"], value / 2.0) if value else cfg["base_rate"]
    traced = run_open_loop(tmux, build_arrivals(tframes, trace_rate, duration),
                           deadline_s=max(duration * 4, duration + 2.0),
                           read_every=SERVE["read_every"])
    lat = traced.latency
    if lat is None or not lat["records"] or not lat["sum_consistent"] or \
            not check_sum_consistency(plane.last) or \
            any(v < 0 for v in lat["stages_ms"].values()):
        raise AssertionError(f"serve_row: traced rung's decomposition is not sum-consistent: {lat}")
    if not traced.accounted():
        raise AssertionError(f"serve_row: the traced rung lost frames: {traced.to_json()}")
    _check_served("serve_row traced", tmux)
    delta = _phase_delta(start)
    _check_padded_launches("serve_row", delta)
    report = dict(
        docs_per_s_at_slo=value, slo_ms=SERVE["slo_ms"],
        sustained=best.to_json() if best is not None else None,
        breaking=broke.to_json() if broke is not None else None,
        rungs=[r.to_json() for r in rungs], traced=traced.to_json(),
        stages_ms=lat["stages_ms"], time_to_visibility_ms=lat["time_to_visibility_ms"],
        window=tmux.tuner.snapshot(), history_frames=history.snapshot()["frames_sampled"],
        graphs=tmux.session._graphs.stats(), launches=delta,
        seconds=time.perf_counter() - t_phase)
    log("serve_row", json.dumps(report))
    log(f"serve_row: {value:.1f} docs/s at the {SERVE['slo_ms']:.0f} ms p99 SLO "
        f"({cfg['docs']} sessions); traced rung at {trace_rate:.1f}/s: stages_ms "
        f"{json.dumps(lat['stages_ms'])}, time to visibility {lat['time_to_visibility_ms']} ms, "
        f"window {tmux.window_seconds() * 1e3:.3f} ms; {delta['rga_insert']} rga_insert "
        f"launches = block applies; {report['seconds']:.1f} s")
    return report, delta["rga_insert"]


def run_serve_quota(device):
    """Phase 5e (a), the quota rung: one hot client on the serve row's
    server whose quota is a quarter of a queue of 8 frames, submitting its
    doc's frames in order, each resubmitted until admitted, with a flush
    after every ``2 * degrade_after`` quota sheds in a row.  Its streak must
    pass the mux's demotion threshold, and the doc must stay on the card
    (the sheds stay backpressure: no demotion, no fallback), equal a plain
    session on the CPU fed the same frames and the scalar oracle; the
    insert launches must equal the block applies.  Returns the launches."""
    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.obs import GLOBAL_COUNTERS
    from peritext_tpu_torch.serve import (
        ADMIT,
        SHED_SESSION_QUOTA,
        AdmissionController,
        SessionMux,
    )
    from peritext_tpu_torch.testing.fuzz import generate_workload

    cfg = SERVE["row"]
    workload = generate_workload(SERVE["seed"], 1, cfg["ops"])[0]  # the row's doc 0
    frames = serve_frames([workload])[0]
    t0 = time.perf_counter()
    start = _phase_counts()
    refused = GLOBAL_COUNTERS.get("serve.degrade_refused_on_device")
    mux = SessionMux(serve_session(device, cfg["docs"], cfg["ops"]),
                     admission=AdmissionController(max_depth=8, session_quota=0.25),
                     host="chip_smoke")
    hot, _ = mux.open_session("hot")
    streak = sheds = longest = 0
    for frame in frames:
        while (verdict := mux.submit(hot, frame)).kind != ADMIT:
            if verdict.reason != SHED_SESSION_QUOTA:
                raise AssertionError(f"serve_quota: {verdict.to_json()}")
            sheds, streak = sheds + 1, streak + 1
            longest = max(longest, streak)
            if streak == 2 * mux.degrade_after:
                mux.flush()
                streak = 0
        streak = 0
    mux.flush()
    refused = int(GLOBAL_COUNTERS.get("serve.degrade_refused_on_device") - refused)
    if longest < mux.degrade_after or not refused:
        raise AssertionError(f"serve_quota: the shed streak ({longest}) never passed the "
                             f"demotion threshold ({mux.degrade_after})")
    if mux.sessions()[hot].degraded or mux.degraded_docs:
        raise AssertionError("serve_quota: the hot session was demoted on the card")
    _check_served("serve_quota", mux)
    delta = _phase_delta(start)  # before the CPU session's applies move the counter
    _check_padded_launches("serve_quota", delta)
    plain = serve_session("cpu", 1, cfg["ops"])
    plain.ingest_frames([(0, f) for f in frames])
    plain.drain()
    got = mux.read(hot)
    if got != plain.read(0) or got != _oracle_doc(workload).get_text_with_formatting(["text"]):
        raise AssertionError("serve_quota: the hot doc differs from the plain session or oracle")
    log(f"serve_quota: {len(frames)} frames of one hot client, {sheds} quota sheds (longest "
        f"streak {longest}, demotion threshold {mux.degrade_after}, {refused} demotions refused "
        f"on the card); the doc stayed on the card and equals a plain CPU session and the "
        f"oracle; {delta['rga_insert']} rga_insert launches = block applies; "
        f"{time.perf_counter() - t0:.1f} s")
    return delta["rga_insert"]


def run_serve_wide(device, workload_job, capture):
    """Phase 5e (b): the same server at config 5's width (:data:`SERVE`
    ``wide``): the warm-up walk, the ladder, then a full feed — every frame
    of every session submitted once, in each session's order, round robin,
    each submit followed by ``pump()`` (a delayed frame is retried after a
    flush), then flushed.  The session must equal a plain session fed the
    same frames by ``ingest_frames`` and ``drain()`` (digests, ``read_all``,
    ``mux.read`` on a seeded sample), a seeded sample must equal the scalar
    oracle, no doc may leave the card, and the insert launches of the phase
    must equal its block applies.  The workload comes from
    ``workload_job``, made in a worker since the start.  ``capture``
    records one committed round's insert call of the feed."""
    import torch

    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.serve import ADMIT

    cfg = SERVE["wide"]
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    workloads = workload_job.get(timeout=900)
    plans = serve_frames(workloads)
    n_frames = sum(len(p) for p in plans)
    log(f"serve_2048: {cfg['docs']} docs x {cfg['ops']} ops ({n_frames} frames) ready in "
        f"{time.perf_counter() - t0:.1f} s after the earlier phases")
    freeze_arrived("serve_2048")
    factory = serve_factory(device, cfg["docs"], cfg["ops"], plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = _phase_counts()
    serve_warm_walk(factory, cfg["docs"])
    rungs, best, broke = serve_ladder("serve_2048", factory, cfg["base_rate"], cfg["rungs"],
                                      midpoint=False)

    mux, frames = factory()
    sids = sorted(frames)
    undo = _arm_capture(capture, "padded")
    retried = pumps = 0
    t0 = time.perf_counter()
    try:
        for k in range(max(len(f) for f in frames.values())):
            for sid in sids:
                if k >= len(frames[sid]):
                    continue
                verdict = mux.submit(sid, frames[sid][k])
                if verdict.kind != ADMIT:
                    retried += 1
                    mux.flush()
                    verdict = mux.submit(sid, frames[sid][k])
                    if verdict.kind != ADMIT:
                        raise AssertionError(f"serve_2048: a retry after a flush was not "
                                             f"admitted: {verdict.to_json()}")
                if mux.pump():
                    pumps += 1
                    if pumps == cfg["capture_pump"]:
                        capture["armed"] = True
        if "args" not in capture:  # a feed of fewer pumps: the final flush's round
            capture["armed"] = True
        mux.flush()
        torch.cuda.synchronize()
    finally:
        undo()
    feed_seconds = time.perf_counter() - t0
    if mux.applied != n_frames or mux.admission.stats.shed:
        raise AssertionError(f"serve_2048: {mux.applied} of {n_frames} frames applied, "
                             f"{mux.admission.stats.shed} shed")
    _check_served("serve_2048", mux)

    t0 = time.perf_counter()
    plain = serve_session(device, cfg["docs"], cfg["ops"])
    plain.ingest_frames([(d, f) for d, plan in enumerate(plans) for f in plan])
    plain.drain()
    plain_seconds = time.perf_counter() - t0
    s = mux.session
    checks = {"digest()": (s.digest(), plain.digest()),
              "digest(full=False)": (s.digest(full=False), plain.digest(full=False)),
              "read_all()": (s.read_all(), plain.read_all()),
              "pending_count()": (s.pending_count(), 0)}
    for what, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"serve_2048: the mux's session {what} differs from the plain "
                                 "session's")
    sample = sorted(random.Random(SERVE["seed"]).sample(sids, cfg["sample"]))
    for sid in sample:
        doc = mux.sessions()[sid].doc_index
        got = mux.read(sid)
        if got != plain.read(doc):
            raise AssertionError(f"serve_2048: mux.read({sid}) differs from the plain session")
        if got != _oracle_doc(workloads[doc]).get_text_with_formatting(["text"]):
            raise AssertionError(f"serve_2048: doc {doc} differs from the oracle")
    delta = _phase_delta(start)
    _check_padded_launches("serve_2048", delta)
    peak = torch.cuda.max_memory_allocated()
    report = dict(
        docs=cfg["docs"], frames=n_frames, docs_per_s_at_slo=best.rate_per_s if best else 0.0,
        sustained=best.to_json() if best is not None else None,
        breaking=broke.to_json() if broke is not None else None,
        rungs=[r.to_json() for r in rungs], feed_seconds=feed_seconds,
        feed_frames_per_s=n_frames / feed_seconds, feed_pumps=mux.rounds, feed_retried=retried,
        feed_rounds=s.rounds, feed_window=mux.tuner.snapshot(), plain_seconds=plain_seconds,
        launches=delta, peak_memory_bytes=peak, seconds=time.perf_counter() - t_phase)
    log("serve_2048", json.dumps(report))
    log(f"serve_2048: {report['docs_per_s_at_slo']:.1f} docs/s at the SLO ({cfg['docs']} "
        f"sessions); full feed of {n_frames} frames in {feed_seconds:.3f} s ({mux.rounds} pumps, "
        f"{s.rounds} rounds, {retried} retried) equals the plain session (digests, read_all, "
        f"{len(sample)} sampled reads) and the oracle on the sample; no fallback; "
        f"{delta['rga_insert']} rga_insert launches = block applies; peak memory {peak} bytes; "
        f"{report['seconds']:.1f} s")
    if "args" not in capture:
        raise AssertionError("serve_2048: no insert call was captured in the full feed")
    return report, delta["rga_insert"]


def _supervisor_script(g, rounds, delay):
    """The supervised session's arrival: per round one ``ingest_frames``;
    a failure injected before round 2's drain; round 3's ``step()`` held
    past its deadline by an injected delay; every round drained.  Returns
    the seconds of each rolled-back call: the rollback (restore and
    re-drain), and for the delayed round the deadline's wait too."""
    seconds = []
    for r, items in enumerate(rounds):
        g.ingest_frames(items)
        if r in (1, 2):
            t0 = time.perf_counter()
            if r == 1:
                g.inject_failure(RuntimeError("injected device fault"))
                rolled = g.drain() == 0
            else:
                g.inject_delay(delay)
                rolled = g.step() == 0
            seconds.append(time.perf_counter() - t0)
            if not rolled:
                raise AssertionError(f"supervisor: the fault injected in round {r + 1} did not "
                                     "roll back")
        g.drain()
    return seconds


def run_supervisor(device, sup, ckpt_root):
    """Phase 5e (c): ``GuardedSession`` on the card over session A's shape
    (:data:`STREAM`), fed A's four frame rounds with ``checkpoint_every=1``
    and a fixed deadline; one injected failure before round 2 and one
    injected delay past the deadline in round 3 must both roll back and
    recover on the card, equal to A (digest, read_all), with no fallback
    and no scalar degradation; the abandoned round is waited for, then the
    insert launches must equal the block applies.  Then a persistent fault
    (every insert call raises) on a 64-doc session: on the card the drain
    raises and no doc is demoted; on the CPU the same script degrades every
    pending doc (reason ``device-round``) and reads equal the oracle."""
    import torch

    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.core.errors import DeviceRoundError
    from peritext_tpu_torch.ops import kernel as kernel_mod
    from peritext_tpu_torch.parallel.streaming import REASON_DEVICE_ROUND, StreamingMerge
    from peritext_tpu_torch.parallel.supervisor import GuardedSession

    cfg, scfg = STREAM, SUPERVISED
    ki, kd, km, kp = cfg["round_caps"]

    def factory(docs, dev):
        return lambda: StreamingMerge(
            num_docs=docs, actors=("doc1", "doc2", "doc3"), slot_capacity=cfg["slot_capacity"],
            mark_capacity=cfg["mark_capacity"], tomb_capacity=cfg["tomb_capacity"],
            round_insert_capacity=ki, round_delete_capacity=kd, round_mark_capacity=km,
            round_map_capacity=kp, comment_capacity=cfg["comment_capacity"], device=dev)

    wire = sup["wire"]
    rounds = [[(d, batches[r]) for d, batches in enumerate(wire) if r < len(batches)]
              for r in range(cfg["rounds"])]
    t_phase = time.perf_counter()
    start = _phase_counts()
    g = GuardedSession(factory(cfg["docs"], device), ckpt_root / "supervisor",
                       deadline=scfg["deadline"], checkpoint_every=1, autotune=False)
    t0 = time.perf_counter()
    rollback_seconds = _supervisor_script(g, rounds, scfg["delay"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not g.join_abandoned(timeout=120):
        raise AssertionError("supervisor: the abandoned round did not end")
    delta = _phase_delta(start)
    _check_padded_launches("supervisor", delta)
    health = g.health()
    if g.session.device.type != device.type or health["rollbacks"] != 2 or \
            health["scalar_degradations"] or health["fallback_docs"] or health["quarantined"]:
        raise AssertionError(f"supervisor: health {json.dumps(health, default=str)[:2000]}")
    if g.digest() != sup["digest"] or g.read_all() != sup["spans"]:
        raise AssertionError("supervisor: the recovered session differs from A_frames")
    report = dict(docs=cfg["docs"], rounds=g.session.rounds, seconds=seconds,
                  rollback_seconds=rollback_seconds,
                  rollbacks=health["rollbacks"], checkpoints=health["checkpoints"],
                  scalar_degradations=health["scalar_degradations"],
                  flight_recorder=health["flight_recorder"], launches=delta,
                  supervisor_round_seconds=health["round_latency"])
    g.close()
    del g

    docs = scfg["persistent_docs"]
    small = [[(d, f) for d, f in items if d < docs] for items in rounds]
    real = kernel_mod.insert_batch

    def fault(*args, **kwargs):
        raise RuntimeError("injected persistent device fault")

    outcomes = {}
    for dev in (device, torch.device("cpu")):
        g = GuardedSession(factory(docs, dev), ckpt_root / f"persistent_{dev.type}",
                           deadline=60.0, checkpoint_every=1, autotune=False)
        g.ingest_frames(small[0])
        g.drain()
        kernel_mod.insert_batch = fault
        try:
            for items in small[1:]:
                g.ingest_frames(items)
            g.drain()
        except DeviceRoundError as exc:
            outcomes[dev.type] = repr(exc)[:160]
        else:
            outcomes[dev.type] = None
        finally:
            kernel_mod.insert_batch = real
        demoted = {d: r.reason for d, r in g.quarantined().items()}
        if dev.type != "cpu":
            if outcomes[dev.type] is None or demoted or any(s.fallback for s in g.session.docs):
                raise AssertionError(f"supervisor: the persistent fault on the card did not raise "
                                     f"or demoted docs ({outcomes[dev.type]}, {demoted})")
        else:
            if outcomes["cpu"] is not None or g.scalar_degradations != 1 or not demoted or \
                    set(demoted.values()) != {REASON_DEVICE_ROUND}:
                raise AssertionError(f"supervisor: the CPU session did not degrade "
                                     f"({outcomes['cpu']}, {demoted})")
            g.drain()
            for d in range(docs):
                if g.read(d) != _oracle_doc(sup["workloads"][d]).get_text_with_formatting(["text"]):
                    raise AssertionError(f"supervisor: degraded doc {d} differs from the oracle")
            report["cpu_demoted_docs"] = len(demoted)
        g.close()
    report.update(persistent=outcomes, phase_seconds=time.perf_counter() - t_phase)
    log("supervisor", json.dumps(report))
    log(f"supervisor: {cfg['docs']} docs recovered on the card from one injected failure and one "
        f"injected {scfg['delay']:.1f} s delay (deadline {scfg['deadline']:.1f} s): 2 rollbacks "
        f"({rollback_seconds[0]:.3f} s; {rollback_seconds[1]:.3f} s with the deadline's wait), "
        f"0 scalar degradations, equal to A_frames; {delta['rga_insert']} rga_insert launches = "
        f"block applies (the abandoned round included); the persistent fault raised on the card "
        f"with no doc demoted, and degraded {report['cpu_demoted_docs']} docs on the CPU, equal "
        f"to the oracle; {report['phase_seconds']:.1f} s")
    return report, delta["rga_insert"]


# ---------------------------------------------------------------------------
# fused multi-tenant and fleet serving
# ---------------------------------------------------------------------------

def _check_lane(name, s):
    """The lane session is on the card and no doc of it left the card."""
    if s.device.type != "cuda":
        raise AssertionError(f"{name}: the session is on {s.device}")
    _check_on_card(name, s)


def _p99_ms(values):
    return float(np.percentile(np.asarray(values, np.float64), 99) * 1e3) if values else None


def fused_row_plan(names, workloads, windows):
    """The reference bench's ``serve_multitenant`` plan: each doc's changes
    (sorted by actor and seq) in ``windows`` strided frames; every tenant
    in even windows, every 4th in odd ones; leftovers in a tail window.
    Returns [[(tenant, frame), ...] per window]."""
    from peritext_tpu_torch.parallel.codec import encode_frame

    frames = {}
    for name, w in zip(names, workloads):
        changes = sorted((ch for log in w.values() for ch in log), key=lambda c: (c.actor, c.seq))
        frames[name] = [encode_frame(changes[i::windows]) for i in range(windows)]
    cursor = dict.fromkeys(names, 0)
    plan = []
    for w in range(windows):
        step = []
        for n in (names if w % 2 == 0 else names[(w // 2) % 4::4]):
            if cursor[n] < windows:
                step.append((n, frames[n][cursor[n]]))
                cursor[n] += 1
        plan.append(step)
    tail = [(n, frames[n][c]) for n in names for c in range(cursor[n], windows)]
    return plan + ([tail] if tail else [])


def run_fused_row(device):
    """Phase 5f (a): the reference bench's ``serve_multitenant`` row
    (:data:`FUSED` ``row``): a ``FusedMuxGroup`` of one-doc tenants on one
    padded lane against the same tenants as standalone muxes, same frames,
    same windows; both arms walked once, then measured.  Every tenant's
    patch stream must equal its twin's; the armed latency plane must be
    sum-consistent with no negative stage, and the history plane must hold
    occupancy rows.  Returns the report and the group's insert launches
    (equal to its block applies)."""
    import torch

    from peritext_tpu_torch.obs import GLOBAL_COUNTERS, LatencyPlane, TimeSeriesPlane
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.plan import TenantSpec
    from peritext_tpu_torch.serve import FusedMuxGroup, SessionMux, default_lane_factory
    from peritext_tpu_torch.testing.fuzz import generate_workload

    cfg = FUSED["row"]
    t_phase = time.perf_counter()
    names = [f"tenant{i:03d}" for i in range(cfg["tenants"])]
    plan = fused_row_plan(names, generate_workload(cfg["seed"], cfg["tenants"], cfg["ops"]),
                          cfg["windows"])
    kw = dict(_serve_widths(cfg["ops"]), device=device)

    def build_group():
        group = FusedMuxGroup([TenantSpec(tenant=n, docs=1) for n in names],
                              default_lane_factory(ACTORS, **kw), host="chip_smoke-fused")
        sids = {}
        for n in names:
            sid, verdict = group.open_session(n, "client")
            if not verdict.admitted:
                raise AssertionError(f"fused_row: {n} refused: {verdict.to_json()}")
            sids[n] = sid
            group.muxes[n].latency_sink = []
        return group, sids

    def build_solo():
        muxes, sids = {}, {}
        for n in names:
            muxes[n] = SessionMux(StreamingMerge(num_docs=1, actors=ACTORS, static_rounds=True,
                                                 **kw), host="chip_smoke-solo")
            sids[n], verdict = muxes[n].open_session("client")
            if not verdict.admitted:
                raise AssertionError(f"fused_row: solo {n} refused: {verdict.to_json()}")
            muxes[n].latency_sink = []
        return muxes, sids

    def drive(submit, flush):
        d0 = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in plan:
            for n, frame in step:
                verdict = submit(n, frame)
                if not verdict.admitted:
                    raise AssertionError(f"fused_row: {n}: {verdict.to_json()}")
            flush(step)
        torch.cuda.synchronize()
        return int(GLOBAL_COUNTERS.get("streaming.fused_dispatches") - d0), \
            time.perf_counter() - t0

    def drive_group(group, sids):
        return drive(lambda n, f: group.submit(n, sids[n], f), lambda step: group.flush())

    def drive_solo(muxes, sids):
        return drive(lambda n, f: muxes[n].submit(sids[n], f),
                     lambda step: [muxes[n].flush() for n in dict.fromkeys(n for n, _ in step)])

    drive_group(*build_group())  # the warm-up walk of both arms
    drive_solo(*build_solo())
    group, gsids = build_group()
    plane = LatencyPlane().enable()
    history = TimeSeriesPlane(sample_every=1, min_frames=4)
    group.history = history.enable()
    for n in names:
        group.muxes[n].latency_plane = plane
    start = _phase_counts()
    fused_dispatches, fused_wall = drive_group(group, gsids)
    delta = _phase_delta(start)
    _check_padded_launches("fused_row", delta)
    muxes, ssids = build_solo()
    solo_dispatches, solo_wall = drive_solo(muxes, ssids)
    for n in names:
        if group.patches(n, gsids[n]) != muxes[n].patches(ssids[n]):
            raise AssertionError(f"fused_row: {n}'s patch stream differs from its standalone twin")
    _check_lane("fused_row", group._lane_sessions[0])
    lat = plane.decomposition()
    if not lat["records"] or not lat["sum_consistent"] or \
            any(v < 0 for v in lat["stages_ms"].values()):
        raise AssertionError(f"fused_row: latency decomposition: {lat}")
    if not history.occupancy_rows():
        raise AssertionError("fused_row: the armed history plane recorded no occupancy rows")
    if not fused_dispatches:
        raise AssertionError("fused_row: the fused arm counted no dispatches")
    report = dict(
        tenants=len(names), ops_per_doc=cfg["ops"], windows=len(plan),
        serve_multitenant_dispatch_amortization=solo_dispatches / fused_dispatches,
        fused_dispatches=fused_dispatches, per_session_dispatches=solo_dispatches,
        fused_wall_s=fused_wall, per_session_wall_s=solo_wall,
        fused_p99_apply_ms=_p99_ms([x for n in names for x in group.muxes[n].latency_sink]),
        per_session_p99_apply_ms=_p99_ms([x for n in names for x in muxes[n].latency_sink]),
        fusion=group.fusion_snapshot(), stages_ms=lat["stages_ms"],
        occupancy=history.snapshot()["occupancy"], launches=delta,
        seconds=time.perf_counter() - t_phase)
    log("fused_row", json.dumps(report))
    log(f"fused_row: {len(names)} tenants' patch streams equal their standalone twins; "
        f"dispatches {fused_dispatches} fused vs {solo_dispatches} per session "
        f"(amortization {report['serve_multitenant_dispatch_amortization']:.2f}x); walls "
        f"{fused_wall:.4f} s vs {solo_wall:.4f} s; p99 apply {report['fused_p99_apply_ms']:.3f} "
        f"vs {report['per_session_p99_apply_ms']:.3f} ms; {delta['rga_insert']} rga_insert "
        f"launches = block applies; {report['seconds']:.1f} s")
    return report, delta["rga_insert"]


def fused_wide_plan(names, docs, frames_of):
    """The row's window plan at any depth: every tenant in even windows,
    every 4th in odd ones, each active tenant's docs one frame further a
    window, until every frame is in.  Returns [[(tenant, doc, frame), ...]]."""
    cursor = {(n, d): 0 for n in names for d in range(docs)}
    plan, w = [], 0
    while any(cursor[k] < len(frames_of[k]) for k in cursor):
        step = []
        for n in (names if w % 2 == 0 else names[(w // 2) % 4::4]):
            for d in range(docs):
                if cursor[n, d] < len(frames_of[n, d]):
                    step.append((n, d, frames_of[n, d][cursor[n, d]]))
                    cursor[n, d] += 1
        if step:
            plan.append(step)
        w += 1
    return plan


def run_fused_wide(device, workloads, captures):
    """Phase 5f (b): the group at config 5's width (:data:`FUSED` ``wide``):
    three lanes, one per layout, on the alternating window plan.  Each lane
    must equal a plain session of its layout fed the same frames in the
    same windows (digests, ``read_all``); a seeded sample of tenants' patch
    streams must equal standalone muxes on the card, and a seeded sample
    of docs the scalar oracle; no doc may leave the card; K1 launches must
    equal the padded lane's block applies plus the paged lane's group
    applies, K3 launches the ragged lane's ragged applies.  ``captures``
    (one per layout) record the lanes' kernel calls of the first sparse
    window.  Returns the report and the (K1, K3) launches."""
    import torch

    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.parallel.streaming import StreamingMerge
    from peritext_tpu_torch.plan import TenantSpec
    from peritext_tpu_torch.serve import FusedMuxGroup, SessionMux, default_lane_factory

    cfg = FUSED["wide"]
    t_phase = time.perf_counter()
    ops = SERVE["wide"]["ops"]
    frames = serve_frames(workloads)
    names = [f"tenant{i:03d}" for i in range(cfg["tenants"])]
    layout_of = {}
    for layout, count in cfg["lanes"]:
        for n in names[len(layout_of):len(layout_of) + count]:
            layout_of[n] = layout
    docs = cfg["docs"]
    frames_of = {(n, d): frames[i * docs + d] for i, n in enumerate(names) for d in range(docs)}
    plan = fused_wide_plan(names, docs, frames_of)
    kw = dict(_serve_widths(ops), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group = FusedMuxGroup([TenantSpec(n, docs=docs, layout=layout_of[n]) for n in names],
                          default_lane_factory(ACTORS, **kw), lane_capacity=cfg["lane_capacity"],
                          host="chip_smoke-fused2048")
    lanes = [(p.layout, p.docs) for p in group.group.lanes]
    if lanes != [(layout, count * docs) for layout, count in cfg["lanes"]]:
        raise AssertionError(f"fused_2048: lanes {lanes}")
    sids = {}
    for n in names:
        for d in range(docs):
            sid, verdict = group.open_session(n, f"client{d}")
            if not verdict.admitted:
                raise AssertionError(f"fused_2048: {n} doc {d} refused: {verdict.to_json()}")
            sids[n, d] = sid
    undo = [_arm_capture(captures[layout], layout) for layout in ("padded", "paged", "ragged")]
    start = _phase_counts()
    walls, sparse = [], None
    t0 = time.perf_counter()
    try:
        for i, step in enumerate(plan):
            for n, d, frame in step:
                verdict = group.submit(n, sids[n, d], frame)
                if not verdict.admitted:
                    raise AssertionError(f"fused_2048: {n} doc {d}: {verdict.to_json()}")
            if sparse is None and len(step) < len(names) * docs:
                sparse = i
                for c in captures.values():
                    c["armed"] = True
            tw = time.perf_counter()
            group.flush()
            walls.append(time.perf_counter() - tw)
        torch.cuda.synchronize()
    finally:
        for u in reversed(undo):
            u()
    feed_seconds = time.perf_counter() - t0
    delta = _phase_delta(start)
    peak = torch.cuda.max_memory_allocated()
    if delta["rga_insert"] != delta["block_applies"] + delta["group_applies"] or \
            delta["ragged_insert"] != delta["ragged_applies"] or not delta["block_applies"] or \
            not delta["group_applies"] or not delta["ragged_applies"]:
        raise AssertionError(f"fused_2048: launches {delta} (K1 = block + group applies, "
                             "K3 = ragged applies)")
    for plan_lane, s in zip(group.group.lanes, group._lane_sessions):
        _check_lane(f"fused_2048 lane {plan_lane.lane}", s)

    t1 = time.perf_counter()
    slot = group.group.slots
    plains = [StreamingMerge(num_docs=p.docs, actors=ACTORS, layout=p.layout,
                             static_rounds=p.layout == "padded", **kw) for p in group.group.lanes]
    for step in plan:
        per_lane = {}
        for n, d, frame in step:
            per_lane.setdefault(slot[n].lane, []).append((slot[n].doc_base + d, frame))
        for lane, items in sorted(per_lane.items()):
            plains[lane].ingest_frames(items)
            plains[lane].drain()
    for p, s, plain in zip(group.group.lanes, group._lane_sessions, plains):
        for what, got, want in (("digest()", s.digest(), plain.digest()),
                                ("digest(full=False)", s.digest(full=False),
                                 plain.digest(full=False)),
                                ("read_all()", s.read_all(), plain.read_all())):
            if got != want:
                raise AssertionError(f"fused_2048: lane {p.lane} ({p.layout}) {what} differs "
                                     "from a plain session of its layout")
    rng = random.Random(cfg["seed"])
    twins = sorted(rng.sample(names, cfg["sample_tenants"]))
    for n in twins:
        twin = SessionMux(StreamingMerge(num_docs=docs, actors=ACTORS, layout=layout_of[n],
                                         static_rounds=layout_of[n] == "padded", **kw))
        tsids = [twin.open_session(f"client{d}")[0] for d in range(docs)]
        for step in plan:
            mine = [(d, f) for m, d, f in step if m == n]
            for d, f in mine:
                twin.submit(tsids[d], f)
            if mine:
                twin.flush()
        for d in range(docs):
            if group.patches(n, sids[n, d]) != twin.patches(tsids[d]):
                raise AssertionError(f"fused_2048: {n} doc {d}'s patch stream differs from "
                                     "its standalone twin's")
    sample = sorted(rng.sample(range(len(names) * docs), cfg["sample_docs"]))
    for i in sample:
        n, d = names[i // docs], i % docs
        if group.read(n, sids[n, d]) != \
                _oracle_doc(workloads[i]).get_text_with_formatting(["text"]):
            raise AssertionError(f"fused_2048: doc {i} ({n} doc {d}) differs from the oracle")
    report = dict(
        tenants=len(names), docs=len(names) * docs, lanes=lanes, windows=len(plan),
        frames=sum(len(f) for f in frames), sparse_window=sparse,
        fusion=group.fusion_snapshot(), feed_seconds=feed_seconds,
        window_ms=_quantiles([w * 1e3 for w in walls]), lane_rounds=[s.rounds for s in
                                                                      group._lane_sessions],
        launches=delta, peak_memory_bytes=peak, check_seconds=time.perf_counter() - t1,
        seconds=time.perf_counter() - t_phase)
    log("fused_2048", json.dumps(report))
    log(f"fused_2048: {len(names)} tenants x {docs} docs on lanes {lanes}, {len(plan)} windows "
        f"in {feed_seconds:.3f} s (window p50 {report['window_ms']['p50']:.3f} ms, p99 "
        f"{report['window_ms']['p99']:.3f} ms); each lane equals a plain session of its layout, "
        f"{len(twins)} tenants equal their standalone twins, {len(sample)} docs the oracle; "
        f"fusion {json.dumps(report['fusion'])}; K1 {delta['rga_insert']} = block "
        f"{delta['block_applies']} + group {delta['group_applies']} applies, K3 "
        f"{delta['ragged_insert']} = ragged applies; peak memory {peak} bytes; "
        f"{report['seconds']:.1f} s")
    for layout, c in captures.items():
        if not c.get("groups" if layout == "paged" else "args"):
            raise AssertionError(f"fused_2048: no {layout} kernel call captured in window {sparse}")
    return report, delta["rga_insert"], delta["ragged_insert"]


def run_fleet(device, workloads, capture, flight_dir):
    """Phase 5f (c): the host-kill failover episode (:data:`FLEET`) at
    config 5's width, over TCP ship endpoints, with the incident plane
    armed as the reference's episode arms it.  Round-robin client traffic,
    one frontend ``round()`` a pass, each frame submitted once; at half the
    frames 16 directed migrations (digest-checked cutover) and one
    ``rebalance()``, then the busiest host killed; the lease detects it and
    failover re-places its docs.  Oracles (the reference's): typed verdicts
    only with ``submitted == admitted + delayed + shed``; before any retry,
    a seeded sample of victim docs equals a plain session fed exactly their
    acked frames; after the clients resubmit what was not admitted and the
    frontend flushes, every doc's digest and the fleet-wide sum equal a
    fault-free plain session's, and a sample equals the scalar oracle; K1
    launches, over all hosts, equal their block applies.  A private
    ``IncidentMonitor`` and ``TimeSeriesPlane``, fed the fleet's snapshot
    once per frontend round, must open exactly ``['host-death']`` within
    ``2 * lease_rounds + 2`` monitor rounds of the kill, resolve it within
    ``clear_after + 1`` quiet rounds after the heal, and score the kill's
    delay/shed spike as an anomaly no later; the flight recorder they share
    with the frontend (dumps in ``flight_dir``) must hold the host-death
    and failover-complete faults, and its dumps must merge into one
    timeline.  ``capture`` records the first insert call of the failover's
    re-drains.  Returns the report and the fleet's insert launches."""
    import torch

    from peritext_tpu_torch.api.batch import _oracle_doc
    from peritext_tpu_torch.obs import (
        GLOBAL_COUNTERS,
        FlightRecorder,
        IncidentMonitor,
        TimeSeriesPlane,
        merge_flight_dumps,
    )
    from peritext_tpu_torch.ops.insert import insert_batch
    from peritext_tpu_torch.parallel.anti_entropy import ChangeStore
    from peritext_tpu_torch.parallel.multihost import ReplicaServer
    from peritext_tpu_torch.serve import (
        ADMIT,
        SHED,
        SHED_REASONS,
        AdmissionController,
        FleetFrontend,
        SessionMux,
    )

    cfg = FLEET
    t_phase = time.perf_counter()
    ops = SERVE["wide"]["ops"]
    plans = serve_frames(workloads)
    keys = [f"doc{d}" for d in range(len(plans))]
    n_frames = sum(len(p) for p in plans)
    counters = ("fleet.ship_frames_sent", "fleet.ship_bytes_sent", "fleet.ship_frames_received")
    c0 = {c: GLOBAL_COUNTERS.get(c) for c in counters}
    recorder = FlightRecorder(capacity=256, dump_dir=flight_dir, min_dump_interval=0.0,
                              host="frontend")
    imon = IncidentMonitor(host="frontend", clear_after=2, recorder=recorder)
    tsp = TimeSeriesPlane(sample_every=1, min_frames=4).enable()
    plane = {"kill_mon": None, "kill_tsp": None, "anomaly": None, "keys": [], "seconds": 0.0}
    fe = FleetFrontend(lease_rounds=cfg["lease_rounds"], checkpoint_every=cfg["checkpoint_every"],
                       recorder=recorder)

    def monitor_round():
        """The incident and history planes' feed, once per frontend round."""
        t_mon = time.perf_counter()
        imon.observe_fleet(fe)
        imon.advance_round()
        tsp.sample(fleet=fe)
        if plane["anomaly"] is None:
            hits = [a for a in tsp.active_anomalies()
                    if a["key"] in ("fleet.verdicts.delayed", "fleet.verdicts.shed")]
            if hits:
                plane.update(anomaly=tsp.rounds, keys=sorted(a["key"] for a in hits))
        plane["seconds"] += time.perf_counter() - t_mon

    try:
        for i in range(cfg["hosts"]):
            fe.add_host(f"host{i}", SessionMux(
                serve_session(device, cfg["rows"], ops),
                admission=AdmissionController(max_depth=4 * cfg["rows"], session_quota=None),
                host=f"host{i}"), transport=True)
        for k in keys:
            verdict = fe.open_doc(k, f"client-{k}")
            if not verdict.admitted:
                raise AssertionError(f"fleet_2048: {k} not placed: {verdict.to_json()}")
        failover = {}
        inner = fe._failover

        def timed_failover(name):
            capture["armed"] = True
            t0 = time.perf_counter()
            inner(name)
            failover.update(host=name, seconds=time.perf_counter() - t0, round=fe.rounds)

        fe._failover = timed_failover
        for _ in range(tsp.min_frames + 2):  # the history plane's flat baseline
            tsp.sample(fleet=fe)
        undo = _arm_capture(capture, "padded")
        start = _phase_counts()
        plain_k1 = plain_applies = 0
        acked = {k: [] for k in keys}
        missed = {k: [] for k in keys}
        kinds = {}
        rng = random.Random(cfg["seed"])
        half = max(len(p) for p in plans) // 2
        victim = kill_round = None
        t0 = time.perf_counter()
        try:
            for k_frame in range(max(len(p) for p in plans)):
                for d, k in enumerate(keys):
                    if k_frame >= len(plans[d]):
                        continue
                    frame = plans[d][k_frame]
                    verdict = fe.submit(k, frame)
                    kinds[verdict.kind] = kinds.get(verdict.kind, 0) + 1
                    if verdict.kind == ADMIT:
                        acked[k].append(frame)
                    else:
                        if verdict.kind == SHED and verdict.reason not in SHED_REASONS:
                            raise AssertionError(f"fleet_2048: untyped shed {verdict.to_json()}")
                        missed[k].append(frame)
                fe.round()
                monitor_round()
                if k_frame == half:
                    moved = sorted(rng.sample(keys, cfg["migrate"]), key=lambda k: int(k[3:]))
                    hosts = sorted(fe.hosts)
                    for k in moved:
                        src = fe._serving[k]
                        fe.migrate(k, hosts[(hosts.index(src) + 1) % len(hosts)])
                    rebalanced = fe.rebalance()
                    load = {}
                    for h in fe._serving.values():
                        load[h] = load.get(h, 0) + 1
                    victim = max(sorted(load), key=lambda h: load[h])
                    victim_docs = sorted((k for k, h in fe._serving.items() if h == victim),
                                         key=lambda k: int(k[3:]))
                    fe.hosts[victim].kill()
                    kill_round = fe.rounds
                    plane.update(kill_mon=imon.rounds, kill_tsp=tsp.rounds)
            while victim not in fe.ledger.dead_hosts():
                fe.round()
                monitor_round()
                if fe.rounds - kill_round > 2 * cfg["lease_rounds"] + 2:
                    raise AssertionError("fleet_2048: the lease never expired")
            detection_rounds = failover["round"] - kill_round
            if fe.failovers != 1 or fe.failover_docs != len(victim_docs):
                raise AssertionError(f"fleet_2048: {fe.failovers} failovers re-placed "
                                     f"{fe.failover_docs} of {len(victim_docs)} docs")
            # acked ops survive: before any retry, each sampled victim doc on
            # its new host equals a plain session fed exactly its acked frames
            sample = sorted(rng.sample(victim_docs, min(cfg["sample"], len(victim_docs))),
                            key=lambda k: int(k[3:]))
            k1, applies = insert_batch.launches, GLOBAL_COUNTERS.get("streaming.block_applies")
            plain = serve_session(device, len(sample), ops)
            plain.ingest_frames([(j, f) for j, k in enumerate(sample) for f in acked[k]])
            plain.drain()
            survived = [fe.doc_digest(k) == plain.doc_digest(j) for j, k in enumerate(sample)]
            plain_k1 += insert_batch.launches - k1
            plain_applies += int(GLOBAL_COUNTERS.get("streaming.block_applies") - applies)
            if not all(survived):
                raise AssertionError(f"fleet_2048: acked ops lost in failover on "
                                     f"{survived.count(False)} of {len(sample)} sampled docs")
            if any(fe._serving[k] == victim for k in victim_docs):
                raise AssertionError("fleet_2048: a doc still served by the dead host")
            retried = 0
            for _ in range(20):
                if not any(missed.values()):
                    break
                for k in keys:
                    left = []
                    for frame in missed[k]:
                        verdict = fe.submit(k, frame)
                        retried += 1
                        kinds[verdict.kind] = kinds.get(verdict.kind, 0) + 1
                        (acked[k] if verdict.kind == ADMIT else left).append(frame)
                    missed[k] = left
                fe.round()
                monitor_round()
            if any(missed.values()):
                raise AssertionError("fleet_2048: resubmissions never all admitted")
            fe.flush()
            torch.cuda.synchronize()
        finally:
            undo()
        episode = time.perf_counter() - t0
        delta = _phase_delta(start)
        delta["rga_insert"] -= plain_k1
        delta["block_applies"] -= plain_applies
        _check_padded_launches("fleet_2048", delta)
        stats = fe.stats
        if not stats.accounted() or set(kinds) - {"admit", "delay", "shed"} or \
                not stats.delayed + stats.shed:
            raise AssertionError(f"fleet_2048: verdicts {kinds}, stats {stats.to_json()}")
        applied = sum(h.mux.applied for h in fe.hosts.values())
        for name, host in sorted(fe.hosts.items()):
            if host.alive:
                _check_served(f"fleet_2048 {name}", host.mux)
        # the incident plane (the reference episode's oracles): post-heal,
        # quiet rounds resolve the one incident the kill opened
        for _ in range(imon.clear_after + 1):
            monitor_round()
        ttd = imon.time_to_detection("host-death", plane["kill_mon"])
        if imon.incident_kinds() != ["host-death"] or imon.open_incidents() or ttd is None or \
                ttd > 2 * cfg["lease_rounds"] + 2:
            raise AssertionError(f"fleet_2048: incidents {imon.incidents_json()}, detection "
                                 f"{ttd} monitor rounds")
        if plane["anomaly"] is None or plane["anomaly"] - plane["kill_tsp"] > ttd:
            raise AssertionError(f"fleet_2048: the delay/shed anomaly at history round "
                                 f"{plane['anomaly']} lags the incident (kill at "
                                 f"{plane['kill_tsp']}, detection {ttd})")
        dumps = sorted(Path(flight_dir).glob("*.jsonl"))
        merged = merge_flight_dumps(dumps)
        reasons = {r.get("reason") for r in merged["timeline"] if r.get("kind") == "fault"}
        if not {"host-death", "failover-complete"} <= reasons or "frontend" not in merged["hosts"]:
            raise AssertionError(f"fleet_2048: flight dumps {[d.name for d in dumps]} hold "
                                 f"faults {sorted(reasons)} from hosts {merged['hosts']}")
        incidents = dict(kinds=imon.incident_kinds(), detection_rounds=ttd,
                         anomaly_rounds=plane["anomaly"] - plane["kill_tsp"],
                         anomaly_keys=plane["keys"], digest=imon.digest(),
                         wire_summary=imon.wire_summary(), monitor_rounds=imon.rounds,
                         opened_round=imon.incidents()[0].opened_round,
                         resolved_round=imon.incidents()[0].resolved_round,
                         flight_dumps=len(dumps), timeline_records=merged["records"],
                         monitor_seconds=plane["seconds"])

        t1 = time.perf_counter()
        clean = serve_session(device, len(plans), ops)
        clean.ingest_frames([(d, f) for d, p in enumerate(plans) for f in p])
        clean.drain()
        total = 0
        for d, k in enumerate(keys):
            got = fe.doc_digest(k)
            if got != clean.doc_digest(d):
                raise AssertionError(f"fleet_2048: {k}'s post-heal digest differs from the "
                                     "fault-free session's")
            total = (total + got) & 0xFFFFFFFF
        if total != clean.digest():
            raise AssertionError("fleet_2048: the fleet-wide digest differs from the "
                                 "fault-free session's")
        for d in sorted(rng.sample(range(len(keys)), cfg["sample"])):
            host = fe.hosts[fe._serving[keys[d]]]
            if host.mux.read(host.session_of(keys[d])) != \
                    _oracle_doc(workloads[d]).get_text_with_formatting(["text"]):
                raise AssertionError(f"fleet_2048: {keys[d]} differs from the oracle")
        # the frontend's metrics mount: one /fleet.json scrape after the heal
        replica = ReplicaServer(ChangeStore(), metrics_port=0, fleet=fe)
        replica.start()
        try:
            t_scrape = time.perf_counter()
            body = json.loads(_scrape(replica.metrics_address, "/fleet.json"))
            scrape = dict(seconds=time.perf_counter() - t_scrape, hosts=len(body["hosts"]),
                          docs=body["router"]["docs"], failovers=body["failovers"])
        finally:
            replica.stop()
        if scrape["failovers"] != fe.failovers or scrape["docs"] != len(keys) or \
                set(body["hosts"]) != set(fe.hosts) or body["rounds"] != fe.rounds:
            raise AssertionError(f"fleet_2048: /fleet.json reads {scrape}, rounds {body['rounds']}")
        ships = {c.split(".", 1)[1]: int(GLOBAL_COUNTERS.get(c) - c0[c]) for c in counters}
        report = dict(
            docs=len(keys), frames=n_frames, hosts=cfg["hosts"], victim=victim,
            victim_docs=len(victim_docs), episode_seconds=episode,
            fleet_serve_applied_frames_per_sec=applied / episode, applied_frames=applied,
            detection_rounds=detection_rounds, failover_docs=fe.failover_docs,
            failover_seconds=failover["seconds"], migrations=fe.migrations,
            migration_rollbacks=fe.migration_rollbacks, rebalance_moves=len(rebalanced),
            resubmitted=retried, verdicts=stats.to_json(), acked_survived=len(sample),
            ships=ships, checkpoint_ships=fe.checkpoint_ships, rounds=fe.rounds,
            incidents=incidents, fleet_json=scrape, launches=delta,
            check_seconds=time.perf_counter() - t1,
            seconds=time.perf_counter() - t_phase)
    finally:
        fe.stop()
    log("fleet_2048", json.dumps(report))
    log(f"fleet_2048: {len(keys)} docs on {cfg['hosts']} hosts; {victim} killed with "
        f"{len(victim_docs)} docs, dead after {detection_rounds} rounds, failover in "
        f"{failover['seconds']:.3f} s; {fe.migrations} migrations ({len(rebalanced)} by "
        f"rebalance), {fe.migration_rollbacks} rollbacks; {ships['ship_frames_sent']} frames "
        f"shipped ({ships['ship_bytes_sent']} bytes); {applied / episode:.1f} applied frames/s "
        f"over {episode:.3f} s; acked ops survived on {len(sample)} sampled victim docs; "
        f"post-heal digests equal the fault-free session; {delta['rga_insert']} rga_insert "
        f"launches = block applies; {report['seconds']:.1f} s")
    log(f"fleet_2048 incidents: kinds {incidents['kinds']}, host-death opened "
        f"{incidents['detection_rounds']} monitor rounds after the kill (round "
        f"{incidents['opened_round']}, resolved at {incidents['resolved_round']}), the "
        f"{incidents['anomaly_keys']} anomaly {incidents['anomaly_rounds']} rounds after the kill; "
        f"digest {incidents['digest']:#010x}; {incidents['flight_dumps']} flight dumps merged "
        f"into {incidents['timeline_records']} records; monitor and history planes "
        f"{incidents['monitor_seconds']:.3f} s")
    if "args" not in capture:
        raise AssertionError("fleet_2048: no insert call was captured in the failover")
    return report, delta["rga_insert"]


def run_chaos_phase(device, trace_dir):
    """Phase 5g: every episode of :data:`CHAOS` on ``device``, each passing
    its own oracles (they raise).  Each path's launch counts are set to 0
    just before it and read just after: an episode's sessions are padded,
    so its K1 launches must equal its block applies and K3 must not launch;
    the padded differential launches K1 only, the ragged one K3 only; the
    divergence injection and the fleet heal build no session and launch
    nothing.  The first insert call of ``run_chaos`` seed 0 and the first
    ragged insert call of the ragged differential are captured for the
    kernel rows, and the mid-drain kill runs under ``obs.profile_trace``
    (trace in ``trace_dir``), whose trace must hold an insert-kernel event.
    Returns the report, each kernel's launches by path and the captures."""
    import torch

    from peritext_tpu_torch.api.batch import DocBatch
    from peritext_tpu_torch.obs import profile_trace
    from peritext_tpu_torch.testing import chaos
    from peritext_tpu_torch.testing.fuzz import run_differential, run_differential_frames

    cfg = CHAOS
    t_phase = time.perf_counter()
    captures = {"padded": {}, "ragged": {}}
    reports, seconds = {}, {}
    paths = {"rga_insert": {}, "ragged_insert": {}}

    def episode(name, fn, launches, capture=None):
        """Run one path with its counts from 0; ``launches`` says which
        kernels it must launch: ``session`` (K1 = block applies), ``rga``,
        ``ragged`` or ``none``."""
        undo = None
        if capture is not None:
            captures[capture]["armed"] = True
            undo = _arm_capture(captures[capture], capture)
        start = _phase_counts()
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            if undo is not None:
                undo()
        seconds[name] = time.perf_counter() - t0
        delta = _phase_delta(start)
        if launches == "session":
            _check_padded_launches(f"chaos {name}", delta)
        elif (launches == "rga") != (delta["rga_insert"] > 0) or \
                (launches == "ragged") != (delta["ragged_insert"] > 0):
            raise AssertionError(f"chaos {name}: launches {delta}, expected {launches}")
        if delta["rga_insert"]:
            paths["rga_insert"][f"chaos_{name}"] = delta["rga_insert"]
        if delta["ragged_insert"]:
            paths["ragged_insert"][f"chaos_{name}"] = delta["ragged_insert"]
        reports[name] = dict(out.to_json() if hasattr(out, "to_json") else
                             out if isinstance(out, dict) else {"result": out},
                             launches=delta, seconds=seconds[name])
        log(f"chaos {name}", json.dumps(reports[name], default=str))
        return out

    for seed in cfg["chaos_seeds"]:
        episode(f"run_chaos_seed{seed}", lambda: chaos.run_chaos(seed, device=device), "session",
                capture="padded" if seed == cfg["chaos_seeds"][0] else None)
    with profile_trace(trace_dir):
        episode("fused_drain_kill", lambda: chaos.run_fused_drain_kill(cfg["seed"], device=device),
                "session")
    events = [e for path in sorted(Path(trace_dir).glob("*.json"))
              for e in json.loads(path.read_text()).get("traceEvents", [])]
    k1_events = [e for e in events if e.get("cat") == "kernel" and "insert_kernel" in e.get("name", "")]
    if not k1_events:
        raise AssertionError(f"chaos: the profile_trace of the mid-drain kill holds no insert "
                             f"kernel event ({len(events)} events)")
    reports["profile_trace"] = dict(events=len(events), insert_kernel_events=len(k1_events),
                                    insert_kernel_us=sum(float(e.get("dur", 0)) for e in k1_events))
    log("chaos profile_trace", json.dumps(reports["profile_trace"]))
    episode("markheavy", lambda: chaos.run_markheavy_chaos(cfg["seed"], device=device), "session")
    episode("divergence_injection", lambda: chaos.run_divergence_injection(cfg["seed"]), "none")
    episode("serve_chaos", lambda: chaos.run_serve_chaos(cfg["seed"], device=device), "session")
    storm = dict(cfg["storm"])
    episode("reconnect_storm", lambda: chaos.run_reconnect_storm(storm.pop("seed"), device=device,
                                                                 **storm), "session")
    failover = dict(cfg["failover"])
    episode("host_kill_failover", lambda: chaos.run_host_kill_failover(
        failover.pop("seed"), device=device, **failover), "session")
    episode("fleet_heal", lambda: chaos.run_fleet_chaos(
        cfg["fleet_heal"]["seed"], hosts=cfg["fleet_heal"]["hosts"], metrics=True), "none")
    diff = cfg["differential"]
    padded = DocBatch(device=device, **diff["capacities"])
    ragged = DocBatch(device=device, layout="ragged", **diff["capacities"])
    for seed in diff["seeds"]:
        for name, batch, kind in (("padded", padded, "rga"), ("ragged", ragged, "ragged")):
            on_device = episode(
                f"differential_{name}_seed{seed}",
                lambda: run_differential(seed, diff["docs"], diff["ops"], batch=batch), kind,
                capture="ragged" if name == "ragged" and seed == diff["seeds"][0] else None)
            if on_device != diff["docs"]:
                raise AssertionError(f"chaos differential {name} seed {seed}: "
                                     f"{diff['docs'] - on_device} docs fell back")
    for seed in cfg["frames_seeds"]:
        episode(f"differential_frames_seed{seed}", lambda: run_differential_frames(
            seed, diff["docs"], diff["ops"], device=device), "session")
    total = time.perf_counter() - t_phase
    log(f"chaos: {len(seconds)} paths passed every oracle on the card in {total:.1f} s "
        f"(per path: {json.dumps({k: round(v, 3) for k, v in seconds.items()})})")
    for layout, c in captures.items():
        if "args" not in c:
            raise AssertionError(f"chaos: no {layout} kernel call was captured")
    return dict(paths=reports, seconds=total), paths, captures


# ---------------------------------------------------------------------------
# the port's demos
# ---------------------------------------------------------------------------


def _load(folder, name):
    """A script of ``folder`` (``demos``, ``demos/web``, ``scripts``),
    loaded from its file as a user runs it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{folder}_{name}".replace("/", "_"), ROOT / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demo(name):
    """A demo of ``demos/`` (``web/...`` for the browser servers)."""
    return _load("demos", name)


def run_scale_arm(scale, name, device, docs, layout, capture=None):
    """``demos/torch_scale_demo.run`` at ``docs`` docs in ``layout``, every
    assertion of the demo holding, with the launch counts set to 0 just
    before and read just after: the layout's kernel once per commit its
    counter counts (:data:`APPLY_COUNTER`), the other never; the frames
    parsed and scheduled by the native library.  ``capture`` asks for the
    kernel inputs of the run's first launch (:func:`_arm_capture`).
    Prints per arrival round the ingest, drain and digest seconds, then the
    wall and end-to-end ops/s, the sweeps and the peak memory."""
    import torch

    from peritext_tpu_torch import native

    cfg = DEMOS["scale"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native_calls = dict(native.calls)
    undo = None
    if capture is not None:
        capture["armed"] = True
        undo = _arm_capture(capture, layout)
    start = _phase_counts()
    t0 = time.perf_counter()
    try:
        out = scale.run(docs, cfg["ops"], cfg["seed"], str(device), layout=layout)
    finally:
        if undo is not None:
            undo()
    seconds = time.perf_counter() - t0
    delta = _phase_delta(start)
    s = out.pop("session")
    native_delta = {k: v - native_calls.get(k, 0) for k, v in native.calls.items()
                    if v != native_calls.get(k, 0)}
    kernel = "ragged_insert" if layout == "ragged" else "rga_insert"
    counter = APPLY_COUNTER[layout].split(".")[1]
    report = dict(session=name, layout=layout, docs=docs, padded_docs=s._padded_docs,
                  blocks=s._n_blocks(), rounds=s.rounds, ops=out["total_ops"],
                  arrival_rounds=out["rounds"], wall_seconds=out["wall"],
                  ops_per_second=out["total_ops"] / out["wall"], final_wait=out["final_wait"],
                  read_all_seconds=out["read_all_seconds"],
                  read_patches_all_seconds=out["read_patches_seconds"], patches=out["patches"],
                  run_seconds=seconds, launches=delta, counters=out["counters"],
                  native_calls=native_delta, overflow_docs=s.overflow_count(),
                  fallback_docs=sum(1 for d in s.docs if d.fallback),
                  peak_memory_bytes=torch.cuda.max_memory_allocated(), digest=out["digest"])
    del s, out
    log("demo scale", json.dumps(report))
    for r, rnd in enumerate(report["arrival_rounds"]):
        log(f"demo {name}: round {r}: ingest {rnd['ingest']:.3f} s, drain {rnd['drain']:.3f} s, "
            f"digest scheduled in {rnd['digest']:.3f} s, waited {rnd['digest_wait']:.3f} s")
    log(f"demo {name}: {docs} docs x {report['ops'] // docs} ops ({report['ops']} ops, "
        f"{report['padded_docs']} rows, {report['blocks']} read blocks) converged in "
        f"{report['wall_seconds']:.3f} s, {report['ops_per_second'] / 1e6:.3f} M ops/s end to end "
        f"(host ingest included); span sweep {report['read_all_seconds']:.3f} s, patch sweep "
        f"{report['read_patches_all_seconds']:.3f} s; peak memory {report['peak_memory_bytes']} "
        f"bytes; {delta[kernel]} {kernel} launches = {counter} {delta[counter]}")
    other = "rga_insert" if layout == "ragged" else "ragged_insert"
    if delta[kernel] == 0 or delta[kernel] != delta[counter] or delta[other]:
        raise AssertionError(f"demo {name}: launches {delta} (one {kernel} launch per "
                             f"{APPLY_COUNTER[layout]})")
    if not (native_delta.get("parse_frames") and native_delta.get("schedule_split_batch")):
        raise AssertionError(f"demo {name}: the frames were not parsed and scheduled by the "
                             f"native library (native calls {native_delta})")
    if report["overflow_docs"] or report["fallback_docs"]:
        raise AssertionError(f"demo {name}: {report['overflow_docs']} overflowed, "
                             f"{report['fallback_docs']} fallback docs")
    if capture is not None and "args" not in capture:
        raise AssertionError(f"demo {name}: no kernel call was captured")
    return report


def _serve_demo(mod, session):
    """``mod.Handler`` over ``session`` on 127.0.0.1:0 in a thread; returns
    the server and its URL."""
    import threading
    from http.server import ThreadingHTTPServer

    mod.SESSION = session
    server = ThreadingHTTPServer(("127.0.0.1", 0), mod.Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_port}"


def _http(url, path, payload=None):
    """(status, body bytes, ms) of one request; a POST when ``payload`` is given."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url + path, data=data),
                                    timeout=120) as res:
            status, body = res.status, res.read()
    except urllib.error.HTTPError as err:
        status, body = err.code, err.read()
    return status, body, (time.perf_counter() - t0) * 1e3


def web_requests():
    """tests/test_web_demo.py's requests (page, state, an edit and a mark on
    the two editors, a sync, a bad op), then :data:`DEMOS` ``web_cycles``
    cycles of an insert by alice, a mark by bob and a sync, then the state."""
    def ops(editor, *steps):
        return {"editor": editor, "ops": [dict(step, path=["text"]) for step in steps]}

    seq = [("/", None), ("/state", None),
           ("/op", ops("alice", {"action": "insert", "index": 0, "values": list("Yo ")})),
           ("/op", ops("bob", {"action": "addMark", "startIndex": 0, "endIndex": 3,
                               "markType": "strong"})),
           ("/sync", {}), ("/op", {"editor": "alice", "ops": [{"bogus": 1}]})]
    marks = ("strong", "em", "link", "comment")
    for c in range(DEMOS["web_cycles"]):
        mark = marks[c % len(marks)]
        step = {"action": "addMark", "startIndex": c % 5, "endIndex": c % 5 + 6,
                "markType": mark}
        if mark == "link":
            step["attrs"] = {"url": f"https://example.org/{c}"}
        elif mark == "comment":
            step["attrs"] = {"id": f"c{c}"}
        seq += [("/op", ops("alice", {"action": "insert", "index": 2 * c % 7,
                                      "values": list(WORDS[c] + " ")})),
                ("/op", ops("bob", step)), ("/sync", {})]
    return seq + [("/state", None)]


def run_web_demos(device):
    """The two browser servers through HTTP on the card.  (a)
    ``torch_server.Handler`` over ``Session(backend="tpu")`` and, as the
    oracle, over a scalar session: :func:`web_requests` to both, every answer
    equal (the page the file on disk), each editor's view its CRDT render,
    K1 launches = block applies = the editors' committed rounds, each
    route's latency p50/p99.  (b) ``torch_essay_server`` with
    ``backend="tpu"`` plays the whole essay trace once through ``/step``:
    both editors converge, equal to a scalar essay session's, launches as
    (a); steps/s."""
    dev = None if device.type == "cuda" else str(device)  # None: the servers' default, cuda
    server_mod = _demo("web/torch_server")
    essay_mod = _demo("web/torch_essay_server")
    page = (ROOT / "demos" / "web" / "index.html").read_bytes()
    report = {}

    start = _phase_counts()
    t0 = time.perf_counter()
    session = server_mod.Session(backend="tpu", device=dev)
    oracle = server_mod.Session(backend="scalar")
    srv, url = _serve_demo(server_mod, session)
    try:
        answers, ms = [], {}
        for path, payload in web_requests():
            status, body, took = _http(url, path, payload)
            answers.append((status, body))
            ms.setdefault(path, []).append(took)
        server_mod.SESSION = oracle
        want = [_http(url, path, payload)[:2] for path, payload in web_requests()]
    finally:
        srv.shutdown()
        srv.server_close()
    delta = _phase_delta(start)
    if answers[0] != (200, page) or want[0] != (200, page):
        raise AssertionError("demo web: / did not serve demos/web/index.html")
    # the JSON answers compared as values: a span's marks may list in another
    # order on another replica (the reference's convergence check is dict
    # equality too)
    for i, (got, exp) in enumerate(zip(answers[1:], want[1:]), 1):
        if (got[0], json.loads(got[1])) != (exp[0], json.loads(exp[1])):
            raise AssertionError(f"demo web: answer {i} {web_requests()[i][0]} differs from the "
                                 f"scalar session's: {got!r} != {exp!r}")
    final = json.loads(answers[-1][1])
    if final["alice"]["spans"] != final["bob"]["spans"] or final["alice"]["pending"]:
        raise AssertionError("demo web: the two panes did not converge")
    editors = list(session.editors.values())
    _check_editors("demo web", editors)
    rounds = [ed.session.rounds for ed in editors]
    _check_padded_launches("demo web", delta)
    if sum(rounds) != delta["block_applies"]:
        raise AssertionError(f"demo web: rounds {rounds}, launches {delta}")
    report["web"] = dict(requests=len(answers), seconds=time.perf_counter() - t0,
                         latency_ms={p: _quantiles(v) for p, v in ms.items()}, rounds=rounds,
                         launches=delta, chars=len(editors[0].view))
    log("demo web", json.dumps(report["web"]))
    log(f"demo web: {len(answers)} requests to torch_server on the card equal a scalar "
        f"session's answers; both panes converged ({len(editors[0].view)} characters); "
        f"K1 launches {delta['rga_insert']} = block applies = the editors' rounds {rounds}; "
        + ", ".join(f"{p} p50 {q['p50']:.3f} ms p99 {q['p99']:.3f} ms"
                    for p, q in report["web"]["latency_ms"].items()))

    start = _phase_counts()
    essay = essay_mod.EssaySession(backend="tpu", device=dev)
    srv, url = _serve_demo(essay_mod, essay)
    try:
        state = json.loads(_http(url, "/restart", {})[1])
        total = state["progress"]["total"]
        t0 = time.perf_counter()
        step_ms = []
        while state["progress"]["event"] < total:
            n = min(DEMOS["essay_step"], total - state["progress"]["event"])
            status, body, took = _http(url, "/step", {"n": n})
            if status != 200:
                raise AssertionError(f"demo essay: /step answered {status}: {body[:200]!r}")
            state = json.loads(body)
            step_ms.append(took)
        seconds = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    delta = _phase_delta(start)
    scalar = essay_mod.EssaySession(backend="scalar")
    while scalar.pos < total:
        scalar.step(min(200, total - scalar.pos))  # a step takes at most 200 events
    texts = {n: "".join(s["text"] for s in e["spans"]) for n, e in state["editors"].items()}
    if not state["converged"] or texts["alice"] != texts["bob"] or \
            state["editors"] != scalar.state()["editors"]:
        raise AssertionError("demo essay: the editors did not converge to the scalar session's "
                             "essay")
    editors = list(essay.editors.values())
    _check_editors("demo essay", editors)
    rounds = [ed.session.rounds for ed in editors]
    _check_padded_launches("demo essay", delta)
    if sum(rounds) != delta["block_applies"]:
        raise AssertionError(f"demo essay: rounds {rounds}, launches {delta}")
    report["essay"] = dict(events=total, requests=len(step_ms), seconds=seconds,
                           steps_per_second=total / seconds, step_request_ms=_quantiles(step_ms),
                           chars=len(texts["alice"]), rounds=rounds, launches=delta)
    log("demo essay", json.dumps(report["essay"]))
    log(f"demo essay: the {total}-event essay through /step on the card in {seconds:.3f} s "
        f"({total / seconds:.1f} steps/s); both editors hold the scalar session's "
        f"{len(texts['alice'])} characters; K1 launches {delta['rga_insert']} = the editors' "
        f"rounds {rounds}")
    return report


def run_demos(device):
    """Phase 5n (:data:`DEMOS`): the port's demos on the card.  Returns the
    report, each kernel's launches by path and the captured kernel inputs
    (K1 of the padded scale arm's first block round, K3 of the ragged
    arm's)."""
    import contextlib
    import io

    import torch

    t_phase = time.perf_counter()
    cfg = DEMOS
    scale = _demo("torch_scale_demo")
    captures = {"padded": {}, "ragged": {}}
    reports = {}
    paths = {"rga_insert": {}, "ragged_insert": {}}

    # config 5b's session in the three layouts at two read blocks
    digests = {}
    for layout in ("padded", "paged", "ragged"):
        name = f"scale_{cfg['arm_docs']}_{layout}"
        r = reports[name] = run_scale_arm(scale, name, device, cfg["arm_docs"], layout,
                                          captures.get(layout))
        kernel = "ragged_insert" if layout == "ragged" else "rga_insert"
        paths[kernel][f"demo_{name}"] = r["launches"][kernel]
        digests[layout] = r["digest"]
    if len(set(digests.values())) != 1:
        raise AssertionError(f"demo scale arms: digests differ by layout {digests}")
    log(f"demo scale arms: padded, paged and ragged at {cfg['arm_docs']} docs share digest "
        f"{digests['padded']:#010x}")
    gc.collect()
    torch.cuda.empty_cache()

    web = run_web_demos(device)
    reports.update(web)
    paths["rga_insert"]["demo_web"] = web["web"]["launches"]["rga_insert"]
    paths["rga_insert"]["demo_essay_web"] = web["essay"]["launches"]["rga_insert"]

    start = _phase_counts()
    hosts = _demo("torch_multihost_demo").run(str(device))
    delta = _phase_delta(start)
    if len(set(hosts["digests"])) != 1:
        raise AssertionError(f"demo multihost: digests {hosts['digests']}")
    _check_padded_launches("demo multihost", delta)
    reports["multihost"] = dict(hosts, launches=delta)
    paths["rga_insert"]["demo_multihost"] = delta["rga_insert"]
    log(f"demo multihost: 3 hosts converged to {hosts['digests'][0]:#010x} in "
        f"{hosts['rounds']} gossip rounds, {hosts['seconds']:.3f} s; launches {json.dumps(delta)}")

    two = _demo("torch_two_editors")
    start = _phase_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as card_out:
        two.main(["--backend", "tpu", "--device", str(device)])
    seconds = time.perf_counter() - t0
    delta = _phase_delta(start)
    with contextlib.redirect_stdout(io.StringIO()) as cpu_out:
        two.main(["--backend", "tpu", "--device", "cpu"])
    if card_out.getvalue() != cpu_out.getvalue():
        raise AssertionError("demo two_editors: the card's output differs from the CPU's:\n"
                             f"{card_out.getvalue()}\n---\n{cpu_out.getvalue()}")
    _check_padded_launches("demo two_editors", delta)
    reports["two_editors"] = dict(seconds=seconds, lines=len(card_out.getvalue().splitlines()),
                                  launches=delta)
    paths["rga_insert"]["demo_two_editors"] = delta["rga_insert"]
    log(f"demo two_editors: --backend tpu on the card prints the CPU run's "
        f"{reports['two_editors']['lines']} lines; {seconds:.3f} s; launches {json.dumps(delta)}")

    seconds = time.perf_counter() - t_phase
    log(f"demos: phase 5n {seconds:.1f} s")
    return reports, paths, captures


def _hex_after(line, word):
    """The hex number printed after ``word`` in ``line``."""
    import re

    return int(re.search(word + r" (0x[0-9a-f]+)", line).group(1), 16)


def run_scripts(device):
    """Phase 5o (:data:`SCRIPTS`): each script's ``main`` on ``device``.
    Returns each script's K1 launches and the insert inputs of the engine
    profile's first replayed round."""
    import ast
    import contextlib
    import io
    import re

    t_phase = time.perf_counter()
    outputs, paths, record = {}, {}, {}
    for key, (name, argv) in SCRIPTS["runs"].items():
        mod = _load("scripts", name)
        undo = None
        if key == "engine_profile":
            # the live session commits one apply per arrival round (capture
            # arms whole-batch rounds); the next insert call is the first
            # replayed round's
            rounds = int(argv[argv.index("--rounds") + 1])
            record, undo = _record_insert_call(rounds)
        start = _phase_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                rc = mod.main([*argv, "--device", str(device)])
        finally:
            if undo is not None:
                undo()
        seconds = time.perf_counter() - t0
        delta = _phase_delta(start)
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"  | {key}: {line}")
        if rc != 0:
            raise AssertionError(f"scripts: {name} {' '.join(argv)} exited {rc}")
        if not lines or not lines[0].startswith("device: ") or "cpu" in lines[0]:
            raise AssertionError(f"scripts: {name} did not name the card first: {lines[:1]}")
        if delta["rga_insert"] == 0 or delta["ragged_insert"]:
            raise AssertionError(f"scripts: {name} launched {delta} (K1 only, at least once)")
        outputs[key] = lines
        paths[f"script_{key}"] = delta["rga_insert"]
        log(f"scripts: {key} exit 0 in {seconds:.2f} s; launches {json.dumps(delta)}")

    line = lambda key, prefix: next(x for x in outputs[key] if x.startswith(prefix))  # noqa: E731
    engine = line("engine_profile", "engine replay:")
    digests = {"engine_profile": _hex_after(engine, "digest"),
               "engine_profile_session": _hex_after(engine, "session"),
               "engine_ab": _hex_after(line("engine_ab", "digests:"), "session")}
    if len(set(digests.values())) != 1:
        raise AssertionError(f"scripts: engine digests differ {digests}")
    staged = ast.literal_eval(line("engine_profile", "{'docs'"))["staged_rounds"]
    if staged != rounds or "args" not in record:
        raise AssertionError(f"scripts: the engine profile's session staged {staged} rounds "
                             f"(want {rounds}), or no replayed round was recorded")
    summary = json.loads(outputs["weak_scaling"][-1])
    sizes = [json.loads(x)["mesh_devices"] for x in outputs["weak_scaling"]
             if x.startswith('{"mesh_devices"')]
    if not summary["digest_equal_across_mesh_sizes"] or sizes != [1, 2, 4]:
        raise AssertionError(f"scripts: weak scaling sizes {sizes}, summary {summary}")
    if not any(x.startswith("2/2 campaigns clean") for x in outputs["chaos_soak"]):
        raise AssertionError("scripts: the two chaos seeds were not clean")
    ingest = line("ingest_profile", "K1 launches")
    k1, applies = map(int, re.match(r"K1 launches (\d+), block applies (\d+)", ingest).groups())
    if not k1 == applies == paths["script_ingest_profile"]:
        raise AssertionError(f"scripts: ingest profile {ingest!r}, counted "
                             f"{paths['script_ingest_profile']} (K1 = block applies)")
    seconds = time.perf_counter() - t_phase
    log(f"scripts: engine digests {digests['engine_ab']:#010x} (profile replay = session = "
        f"engine A/B), weak-scaling probe digest {summary['probe_digest']:#010x} at 1, 2 and 4 "
        f"virtual shards; K1 launches {json.dumps(paths)}; phase 5o {seconds:.2f} s")
    if seconds > SCRIPTS["seconds"]:
        raise AssertionError(f"scripts: phase 5o took {seconds:.2f} s, over "
                             f"{SCRIPTS['seconds']} s")
    return paths, record


def run_smokes(device, root):
    """Phase 5p (:data:`SMOKES`): each smoke's and A/B's ``main`` on
    ``device``, a smoke's artifacts under ``root``.  Returns each script's
    launches of each kernel."""
    import contextlib
    import io

    t_phase = time.perf_counter()
    paths = {"rga_insert": {}, "ragged_insert": {}}
    for key, (name, argv, kernels) in SMOKES["runs"].items():
        mod = _load("scripts", name)
        argv = [*argv, "--device", str(device)]
        if name.endswith("_smoke"):
            argv += ["--out", str(root / key)]
        start = _phase_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = mod.main(argv)
        seconds = time.perf_counter() - t0
        delta = _phase_delta(start)
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"  | {key}: {line}")
        if rc != 0:
            raise AssertionError(f"smokes: {name} {' '.join(argv)} exited {rc}")
        if not lines or not lines[0].startswith("device: ") or "cpu" in lines[0]:
            raise AssertionError(f"smokes: {name} did not name the card first: {lines[:1]}")
        launched = {"rga": delta["rga_insert"], "ragged": delta["ragged_insert"]}
        if any((n > 0) != (k in kernels) for k, n in launched.items()):
            raise AssertionError(f"smokes: {name} launched {delta}, expected "
                                 f"{list(kernels) or 'no kernel'}")
        if key.startswith("append") and not any(x.startswith(("arms equal", "equivalent outputs"))
                                                for x in lines):
            raise AssertionError(f"smokes: {name} did not show its arms equal")
        paths["rga_insert"][f"smoke_{key}"] = delta["rga_insert"]
        paths["ragged_insert"][f"smoke_{key}"] = delta["ragged_insert"]
        log(f"smokes: {key} exit 0 in {seconds:.2f} s; launches {json.dumps(delta)}")
    seconds = time.perf_counter() - t_phase
    log(f"smokes: K1 launches {json.dumps(paths['rga_insert'])}; K3 launches "
        f"{json.dumps(paths['ragged_insert'])}; phase 5p {seconds:.2f} s")
    if seconds > SMOKES["seconds"]:
        raise AssertionError(f"smokes: phase 5p took {seconds:.2f} s, over {SMOKES['seconds']} s")
    return paths


def main_path_insert_args(batch, workloads):
    """The insert kernel's inputs exactly as the padded slice's merge gives them."""
    from peritext_tpu_torch.ops.kernel import encoded_arrays_of
    from peritext_tpu_torch.ops.packed import empty_docs

    encoded = batch.encode(workloads)
    arrays = encoded_arrays_of(encoded, batch.device)
    state = empty_docs(encoded.num_docs, batch.slot_capacity, batch.mark_capacity,
                       tomb_capacity=arrays[3].shape[1], map_capacity=batch.map_capacity,
                       device=batch.device)
    return [state.elem_id, state.char, state.num_slots, state.overflow, *arrays[:3]]


def main_path_paged_args(batch, workloads):
    """The insert kernel's inputs exactly as the paged merge gives them,
    one list per page-bucket group (api/batch.py ``_device_paged`` ->
    store/paged.apply_rows -> ops/kernel.apply_batch_paged): the group's
    pages and aux rows gathered to (B, G*P), with padding rows and
    null-page table entries, and the group's streams padded to B rows."""
    from peritext_tpu_torch.ops.ragged import stream_counts
    from peritext_tpu_torch.store.paged import PagedDocStore, group_stream_arrays
    from peritext_tpu_torch.utils.shapes import next_pow2

    encs = batch._encode_paged(workloads)
    store = PagedDocStore(
        len(workloads), slot_capacity=batch.slot_capacity, mark_capacity=batch.mark_capacity,
        tomb_capacity=max(enc.del_target.shape[1] for _, _, enc in encs),
        map_capacity=batch.map_capacity, page_size=batch.page_size, device=batch.device)
    groups = []
    for g, docs, enc in encs:
        store.ensure_rows(docs, stream_counts(enc)[0])
        b = next_pow2(len(docs))
        state = store.materialize_rows(docs, g, pad_rows_to=b)  # the gather apply_rows makes
        streams = group_stream_arrays(enc, None, b, batch.device)
        groups.append((f"paged_g{g}_b{b}", [state.elem_id, state.char, state.num_slots,
                                           state.overflow, *streams[:3]]))
        store.apply_rows(docs, g, streams, pad_rows_to=b)  # the next group sees this one's pool
    return groups


def main_path_ragged_args(batch, workloads):
    """The ragged insert kernel's inputs exactly as the ragged merge gives
    them (api/batch.py ``_device_ragged`` -> ops/ragged.apply_batch_ragged)."""
    import torch

    from peritext_tpu_torch.ops.ragged import plan_arrays, stream_counts
    from peritext_tpu_torch.store.paged import group_stream_arrays

    enc = batch._encode_ragged(workloads)
    store, plan = batch._ragged_store(enc)
    row_idx, *planes = plan_arrays(plan, batch.device)
    streams = group_stream_arrays(enc, None, enc.num_docs, batch.device)
    rows = row_idx.long()
    return [store.pool_elem, store.pool_char, *planes,
            store.aux_field("num_slots")[rows], store.aux_field("overflow")[rows],
            torch.from_numpy(stream_counts(enc)[0]).to(batch.device), *streams[:3]]


def main() -> int:
    if not (ROOT / "peritext_tpu_torch" / "csrc" / "insert.cu").is_file():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    # the long-tail essay (one doc of thousands of fuzz ops) with its oracle
    # replay, and the serve phase's 2048-session workload, take minutes on
    # one core each: they start now, in workers which end with main
    import multiprocessing
    import os

    import tempfile

    # each job's workers yield the host's cores to the jobs needed before
    # theirs (os.nice: the slice's 0, the pool's 1, A's 2, C's 5)
    pool = multiprocessing.get_context("spawn").Pool(3, initializer=os.nice, initargs=(1,))
    # so do the slices' workloads, first (the merges wait on them: 69.2 s
    # and 26.7 s on a slow host when made in phases 3 and 4), and the
    # streaming phase's (A's 2048 docs, C's other 8192): made while the
    # build and the merges keep one host core busy, they are ready when
    # phase 5 starts (43.1 s and a 37.1 s wait on a slow host when they were
    # made at its start)
    cfg = STREAM
    stream_jobs = (Generation(SLICE["seed"], SLICE["docs"], SLICE["ops"]),
                   Generation(cfg["seed"], cfg["docs"], cfg["ops"], nice=2),
                   Generation(cfg["seed"] + cfg["docs"], cfg["c_docs"] - cfg["docs"], cfg["ops"],
                              workers=6, nice=5))
    try:
        jobs = dict(
            tail=pool.apply_async(workload, (POOLED["tail_seed"], POOLED["tail_docs"],
                                              POOLED["tail_ops"])),
            essay=pool.apply_async(_essay, (LONGTAIL["essay_seed"], LONGTAIL["essay_ops"])),
            longtail=pool.apply_async(workload, (LONGTAIL["seed"], LONGTAIL["docs"],
                                                 LONGTAIL["ops"])),
            serve_wide=pool.apply_async(workload, (SERVE["seed"], SERVE["wide"]["docs"],
                                                    SERVE["wide"]["ops"])),
            slice=stream_jobs[0], stream=stream_jobs[1], stream_more=stream_jobs[2])
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            return run_all(device, jobs, Path(tmp))
    finally:
        for job in stream_jobs:
            job.close()
        pool.terminate()
        pool.join()


def run_all(device, jobs, ckpt_root) -> int:
    """Every phase after the device check (module doc)."""
    import torch

    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from peritext_tpu_torch.obs import RecompileSentinel
    from peritext_tpu_torch.utils.nvcc import build_libraries

    from peritext_tpu_torch import native

    # the whole run's build sentinel: every library built at most once and
    # loaded exactly once, whatever the doc mix
    whole = RecompileSentinel().start()
    t0 = time.perf_counter()
    # g++ builds the native host library while nvcc builds the kernels
    host_lib = {}
    g_build = threading.Thread(target=lambda: host_lib.update(
        ok=native.available(), seconds=time.perf_counter() - t0))
    g_build.start()
    try:
        libs = build_libraries(["insert", "ragged_insert"])
    finally:
        g_build.join()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    if not host_lib.get("ok"):
        raise AssertionError("build: the native host library (g++) did not build or load")
    log(f"build: native host library {native.library_path().name} in "
        f"{host_lib['seconds']:.2f} s, beside the kernels")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("  ptxas:", line.strip())

    torch.manual_seed(0)
    batch, workloads, cursors, launches, slice_report = run_slice(device, jobs["slice"])
    pooled, pooled_workloads, pooled_launches = run_pooled(device, workloads, cursors,
                                                           jobs["tail"])
    log(f"merges done at {time.perf_counter() - t_start:.1f} s")
    ckpts = {"root": ckpt_root}
    capture, capture_frames, stream_reports, ctx = run_streaming(device, ckpts, jobs)
    log(f"streaming done at {time.perf_counter() - t_start:.1f} s")
    capture_paged, capture_ragged, layout_reports = run_stream_layouts(device, ctx,
                                                                       (jobs["essay"], jobs["longtail"]),
                                                                       ckpts)
    stream_reports += layout_reports
    log(f"streaming layouts done at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    _, planes_launches, planes_snap, planes_record = run_device_planes(device, ctx, whole)
    log(f"device planes done at {time.perf_counter() - t_start:.1f} s "
        f"(phase 5h {time.perf_counter() - t0:.1f} s)")
    _, plan_launches, captures_plan = run_planner(device, ctx, planes_snap, planes_record,
                                                  ckpt_root / "planner")
    del planes_snap
    log(f"planner done at {time.perf_counter() - t_start:.1f} s")
    from peritext_tpu_torch.testing.capture_audit import CaptureAudit, captured_set

    t0 = time.perf_counter()
    audit = CaptureAudit(captured_set())
    log(f"capture audit: {len(audit.captured)} functions in the captured set, computed from "
        f"the sources in {time.perf_counter() - t0:.2f} s")
    with audit:
        mesh_paths, mesh_ragged_paths, captures_mesh = run_mesh(
            device, ctx, (workloads, cursors, slice_report))
        log(f"mesh done at {time.perf_counter() - t_start:.1f} s")
        engine_paths, capture_engine = run_baseline_engine(device, ctx)
        log(f"baseline and engine done at {time.perf_counter() - t_start:.1f} s")
        fused_paths, fused_ragged_paths, capture_fused_replay = run_fused_pipeline(device, ctx)
        log(f"fused pipeline done at {time.perf_counter() - t_start:.1f} s")
        audit_paths, audit_ragged_paths = run_capture_audit(device, ctx, audit)
    log(f"capture audit done at {time.perf_counter() - t_start:.1f} s")
    sup = dict(workloads=ctx["workloads"], wire=ctx["wire"], digest=ctx["a"]["digest"],
               spans=ctx["a"]["spans"])
    del ctx
    gc.collect()
    torch.cuda.empty_cache()

    capture_bridge = {}
    bridge_paths = {"bridge_pm_fixtures": run_pm_fixtures()["rga_insert"]}
    bridge_fuzz = run_bridge_fuzz(capture_bridge)
    bridge_paths["bridge_fuzz"] = bridge_fuzz["launches"]["rga_insert"]
    bridge_paths["bridge_timer"] = run_bridge_timer()["rga_insert"]
    log(f"bridge done at {time.perf_counter() - t_start:.1f} s")
    capture_restore = {}
    restores = run_restores(ckpts, capture_restore)
    crash = run_crash_campaigns()
    guarded_launches = run_guarded(workloads, cursors, slice_report)
    del slice_report
    log(f"durability done at {time.perf_counter() - t_start:.1f} s")

    serve_paths = {}
    _, serve_paths["serve_row"] = run_serve_row(device)
    serve_paths["serve_quota"] = run_serve_quota(device)
    capture_serve = {}
    _, serve_paths["serve_2048"] = run_serve_wide(device, jobs["serve_wide"], capture_serve)
    _, serve_paths["supervisor"] = run_supervisor(device, sup, ckpt_root)
    del sup
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve done at {time.perf_counter() - t_start:.1f} s")

    t0 = time.perf_counter()
    captures_fused = {"padded": {}, "paged": {}, "ragged": {}}
    capture_fleet = {}
    _, serve_paths["fused_row"] = run_fused_row(device)
    wide_workloads = jobs["serve_wide"].get(timeout=900)
    _, serve_paths["fused_2048"], fused_ragged = run_fused_wide(device, wide_workloads,
                                                                captures_fused)
    _, serve_paths["fleet_2048"] = run_fleet(device, wide_workloads, capture_fleet,
                                             ckpt_root / "fleet_flight")
    del wide_workloads
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fused and fleet done at {time.perf_counter() - t_start:.1f} s "
        f"(phase 5f {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    _, chaos_paths, captures_chaos = run_chaos_phase(device, ckpt_root / "traces")
    log(f"chaos done at {time.perf_counter() - t_start:.1f} s "
        f"(phase 5g {time.perf_counter() - t0:.1f} s)")
    gc.collect()
    torch.cuda.empty_cache()
    _, demo_paths, captures_demo = run_demos(device)
    log(f"demos done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    script_paths, capture_script = run_scripts(device)
    log(f"scripts done at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    smoke_paths = run_smokes(device, ckpt_root / "smokes")
    log(f"smokes done at {time.perf_counter() - t_start:.1f} s")

    rows = [check_insert("main_path", main_path_insert_args(batch, workloads))]
    rows.append(check_insert("pooled_padded", main_path_insert_args(pooled["padded"], pooled_workloads)))
    for name, args in main_path_paged_args(pooled["paged"], pooled_workloads):
        rows.append(check_insert(name, args))
    if "args" not in capture:
        raise AssertionError("streaming: no insert call was captured in the third drain")
    rows.append(check_insert("streaming_round", capture["args"], loop_slots=capture["loop_slots"]))
    if "args" not in capture_frames:
        raise AssertionError("streaming: no insert call was captured in A_frames' third drain")
    rows.append(check_insert("streaming_frame_round", capture_frames["args"],
                             loop_slots=capture_frames["loop_slots"]))
    if not capture_paged.get("groups"):
        raise AssertionError("streaming: no paged group chain was captured in A_paged's third drain")
    for i, args in enumerate(capture_paged["groups"]):
        rows.append(check_insert(f"streaming_paged_round_g{i}", args))
    rows.append(check_insert("bridge_round", capture_bridge["args"],
                             loop_slots=capture_bridge["loop_slots"]))
    rows.append(check_insert("serve_round", capture_serve["args"],
                             loop_slots=capture_serve["loop_slots"]))
    rows.append(check_insert("fused_padded_sparse_round", captures_fused["padded"]["args"],
                             loop_slots=captures_fused["padded"]["loop_slots"]))
    for i, args in enumerate(captures_fused["paged"]["groups"]):
        rows.append(check_insert(f"fused_paged_round_g{i}", args))
    rows.append(check_insert("fleet_failover_round", capture_fleet["args"],
                             loop_slots=capture_fleet["loop_slots"]))
    rows.append(check_insert("chaos_round", captures_chaos["padded"]["args"],
                             loop_slots=captures_chaos["padded"]["loop_slots"]))
    if "args" not in captures_plan["padded"] or "args" not in captures_plan["ragged"]:
        raise AssertionError("planner: no round of a replay was captured")
    rows.append(check_insert("plan_replay_round", captures_plan["padded"].pop("args"),
                             loop_slots=captures_plan["padded"]["loop_slots"]))
    mesh_args = captures_mesh["padded"].pop("args")
    with torch.cuda.device(mesh_args[0].device):  # the shard's card
        rows.append(check_insert("mesh_round", mesh_args,
                                 loop_slots=captures_mesh["padded"]["loop_slots"]))
    del mesh_args
    rows.append(check_insert("engine_replay_round", capture_engine.pop("args"),
                             loop_slots=capture_engine["loop_slots"]))
    rows.append(check_insert("demo_scale_padded_block_round", captures_demo["padded"].pop("args"),
                             loop_slots=captures_demo["padded"]["loop_slots"]))
    rows.append(check_insert("script_engine_replay_round", capture_script.pop("args"),
                             loop_slots=capture_script["loop_slots"]))
    del capture, capture_frames, capture_paged, capture_bridge, capture_serve, capture_fleet
    args = synth_args(device, **BATCH_8K, seed=1)
    rows.append(check_insert("batch_8k", args))
    rows.append(check_insert("batch_8k_loop_slots", args, loop_slots=BATCH_8K["inserts"]))
    rows.append(check_insert("batch_8k_global_memory", args, smem_budget=0, reps=5))
    del args
    rows.append(check_insert("long_doc", synth_args(device, **LONG_DOC, seed=2),
                             reps=2, plain_reps=1))
    log(f"insert kernel shapes done at {time.perf_counter() - t_start:.1f} s")

    from peritext_tpu_torch.testing.synth import synth_streams

    ragged_rows = check_ragged("main_path", main_path_ragged_args(pooled["ragged"], pooled_workloads))
    if "args" not in capture_ragged:
        raise AssertionError("streaming: no ragged insert call was captured in C_frames_ragged")
    ragged_rows += check_ragged("streaming_ragged_round", capture_ragged.pop("args"))
    ragged_rows += check_ragged("restore_ragged_round", capture_restore.pop("args"))
    ragged_rows += check_ragged("fused_ragged_round", captures_fused["ragged"].pop("args"))
    ragged_rows += check_ragged("differential_ragged_round", captures_chaos["ragged"].pop("args"))
    ragged_rows += check_ragged("plan_replay_ragged_round", captures_plan["ragged"].pop("args"))
    mesh_args = captures_mesh["ragged"].pop("args")
    with torch.cuda.device(mesh_args[0].device):  # the shard's card
        ragged_rows += check_ragged("mesh_ragged_round", mesh_args)
    del mesh_args
    ragged_rows += check_ragged("fused_replayed_ragged_round", capture_fused_replay.pop("args"))
    ragged_rows += check_ragged("demo_scale_ragged_round", captures_demo["ragged"].pop("args"))
    del captures_fused, captures_chaos, captures_plan
    ragged_rows += check_ragged("batch_8k_ragged", ragged_args(
        device, BATCH_8K["slots"],
        synth_streams(BATCH_8K["docs"], inserts_per_doc=BATCH_8K["inserts"], seed=1)[:3]))
    ragged_rows += check_ragged("mixed_10k", ragged_args(device, MIXED_10K["slots"], mixed_streams()),
                                budgets=(None, 0))
    cfg = LONG_DOC_RAGGED
    ragged_rows += check_ragged("long_doc_ragged", ragged_args(
        device, cfg["slots"],
        synth_streams(cfg["docs"], inserts_per_doc=cfg["inserts"], seed=cfg["seed"])[:3]))
    log(f"ragged kernel shapes done at {time.perf_counter() - t_start:.1f} s")

    def record(name, source, replaces, launched, kernel_rows):
        main = kernel_rows[0]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
        }

    # ``launches`` is the count of the path whose inputs give ``ms`` (the
    # first row); ``launches_by_path`` lists every path's own count, each
    # counted from 0 over its own run
    rga_paths = {"slice": launches["rga_insert"],
                 "pooled_padded": pooled_launches["padded"]["rga_insert"],
                 "pooled_paged": pooled_launches["paged"]["rga_insert"]}
    rga_paths.update({f"streaming_{r['session']}": r["rga_insert_launches"] for r in stream_reports
                      if r["layout"] != "ragged"})
    rga_paths.update(bridge_paths)
    rga_paths.update({f"restore_{r['session']}": r["launches"]["rga_insert"] for r in restores
                      if r["layout"] != "ragged"})
    rga_paths.update({f"restore_crash_seed{seed}": d["rga_insert"] for seed, d in crash.items()})
    rga_paths["guarded_merge"] = guarded_launches
    rga_paths.update(serve_paths)
    rga_paths.update(chaos_paths["rga_insert"])
    rga_paths.update({f"planes_{n}": k for n, k in planes_launches.items() if n != "C_frames_ragged"})
    rga_paths["plan_replay"] = plan_launches["padded"]
    rga_paths.update(mesh_paths)
    rga_paths.update(engine_paths)
    rga_paths.update(fused_paths)
    rga_paths.update(audit_paths)
    rga_paths.update(demo_paths["rga_insert"])
    rga_paths.update(script_paths)
    rga_paths.update(smoke_paths["rga_insert"])
    ragged_paths = {"pooled_ragged": pooled_launches["ragged"]["ragged_insert"]}
    ragged_paths.update({f"streaming_{r['session']}": r["ragged_insert_launches"]
                         for r in stream_reports if r["layout"] == "ragged"})
    ragged_paths.update({f"restore_{r['session']}": r["launches"]["ragged_insert"]
                         for r in restores if r["layout"] == "ragged"})
    ragged_paths["fused_2048"] = fused_ragged
    ragged_paths.update(chaos_paths["ragged_insert"])
    ragged_paths["planes_C_frames_ragged"] = planes_launches["C_frames_ragged"]
    ragged_paths["plan_replay"] = plan_launches["ragged"]
    ragged_paths.update(mesh_ragged_paths)
    ragged_paths.update(fused_ragged_paths)
    ragged_paths.update(audit_ragged_paths)
    ragged_paths.update(demo_paths["ragged_insert"])
    ragged_paths.update({k: n for k, n in smoke_paths["ragged_insert"].items() if n})
    kernels = [
        dict(record("rga_insert", "peritext_tpu_torch/csrc/insert.cu",
                    "peritext_tpu/ops/pallas_insert.py:94", rga_paths["slice"], rows),
             launches_by_path=rga_paths),
        dict(record("ragged_insert", "peritext_tpu_torch/csrc/ragged_insert.cu",
                    "peritext_tpu/ops/ragged_pallas.py:65",
                    pooled_launches["ragged"]["ragged_insert"], ragged_rows),
             launches_by_path=ragged_paths),
    ]
    whole.stop()
    log(f"build sentinel, whole run: builds {json.dumps(whole.builds)}, loads "
        f"{json.dumps(whole.loads)}")
    libraries = {"insert", "ragged_insert", "native"}
    if whole.loads != dict.fromkeys(libraries, 1) or set(whole.builds) - libraries or \
            any(n != 1 for n in whole.builds.values()):
        raise AssertionError(f"build sentinel: builds {whole.builds}, loads {whole.loads}: each "
                             "library must load once and build at most once")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
