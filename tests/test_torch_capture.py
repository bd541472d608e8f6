"""The engine-capture hook of the port's ``StreamingMerge``
(``_capture_rounds``, parallel/streaming.py) and its replay
(testing/engine.py) against the reference package's hook and the reference
bench's replay, on the CPU, exactly (integer state, tolerance 0).

The same v2 frames (32 docs x 48 ops in 3 arrival rounds) feed a capture
session of each package: the captured rounds, their inputs, widths and slot
windows, the counters and the digests are equal, and the port's replay of
its rounds reproduces the session digest, which is also the reference's
replay digest.  A session of two read blocks applies the whole batch per
round while it captures.  Capture turns the fused drain off in both
packages (no ``streaming.fused_dispatches``, occupancy rows labelled
``streaming.round``).  The page-pool layouts ignore the hook; a padded mesh
session refuses it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from peritext_tpu.obs import GLOBAL_COUNTERS as JAX_COUNTERS
from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
from peritext_tpu.ops.kernel import apply_batch_compact_jit
from peritext_tpu.ops.packed import empty_docs as jax_empty_docs
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.parallel.streaming import _resolve_block_digest_jit
from peritext_tpu_torch.obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.testing.engine import replay_digest, replay_rounds
from peritext_tpu_torch.testing.fuzz import generate_workload

ACTORS = ("doc1", "doc2", "doc3")
DOCS, OPS, ROUNDS, SEED = 32, 48, 3, 3
CAPS = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=128, round_insert_capacity=64,
            round_delete_capacity=32, round_mark_capacity=32)
COUNTERS = ("streaming.rounds", "streaming.fused_dispatches")


@pytest.fixture(scope="module")
def frames():
    workloads = generate_workload(SEED, DOCS, OPS)
    return build_arrival(workloads, ROUNDS, SEED, as_frames=True)[0]


def _run(cls, frames, capture, **kw):
    """A session fed ``frames``, one ``ingest_frames`` and ``drain()`` per
    arrival round, with ``capture`` assigned to its hook."""
    s = cls(num_docs=DOCS, actors=ACTORS, **CAPS, **kw)
    s._capture_rounds = capture
    for r in range(ROUNDS):
        s.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
        s.drain()
    return s


def _profiled(cls, frames, capture, profiler, counters, **kw):
    """:func:`_run` with ``profiler`` armed: the session, the deltas of
    :data:`COUNTERS` and the profiler's occupancy snapshot."""
    before = {c: counters.get(c) for c in COUNTERS}
    profiler.reset()
    profiler.enable(capture_costs=False)
    try:
        s = _run(cls, frames, capture, **kw)
        snap = profiler.snapshot()
    finally:
        profiler.disable()
        profiler.reset()
    delta = {c: counters.get(c) - n for c, n in before.items()}
    return s, delta, {k: snap[k] for k in ("occupancy", "occupancy_totals")}


@pytest.fixture(scope="module")
def captured(frames):
    """Per package: (session, captured rounds, counter deltas, occupancy),
    each capture session run with its package's profiler armed."""
    ref, port = [], []
    jax = _profiled(JaxStreamingMerge, frames, ref, JAX_DEVPROF, JAX_COUNTERS)
    blocks = GLOBAL_COUNTERS.get("streaming.block_applies")
    ours = _profiled(StreamingMerge, frames, port, GLOBAL_DEVPROF, GLOBAL_COUNTERS,
                     device="cpu")
    ours[1]["streaming.block_applies"] = GLOBAL_COUNTERS.get("streaming.block_applies") - blocks
    return dict(jax=(jax[0], ref, *jax[1:]), port=(ours[0], port, *ours[1:]))


def _assert_same_rounds(port_rounds, ref_rounds, device="cpu"):
    """Equal round count, and per round equal widths, slot windows and
    inputs (counts, the three insert streams, deletes, marks and maps by
    column), each port tensor on ``device``."""
    assert len(port_rounds) == len(ref_rounds) > 0
    for (inputs, widths, loop_slots), (ref_inputs, ref_widths, ref_loop) in zip(
            port_rounds, ref_rounds):
        assert tuple(widths) == tuple(ref_widths)
        assert loop_slots == ref_loop
        counts, ins, dels, marks, maps = inputs
        r_counts, r_ins, r_dels, r_marks, r_maps = ref_inputs
        assert len(counts) == len(r_counts) == 4 and len(ins) == len(r_ins) == 3
        pairs = list(zip(counts, r_counts)) + list(zip(ins, r_ins)) + [(dels, r_dels)]
        assert marks.keys() == r_marks.keys() and maps.keys() == r_maps.keys()
        pairs += [(marks[c], r_marks[c]) for c in marks] + [(maps[c], r_maps[c]) for c in maps]
        for got, want in pairs:
            assert got.device.type == device
            assert np.array_equal(got.cpu().numpy(), np.asarray(want))


def test_captured_rounds_equal_reference(captured):
    s, rounds, delta, _ = captured["port"]
    js, ref_rounds, ref_delta, _ = captured["jax"]
    _assert_same_rounds(rounds, ref_rounds)
    assert len(rounds) == s.rounds == js.rounds
    assert delta["streaming.rounds"] == ref_delta["streaming.rounds"] == len(rounds)
    assert delta["streaming.block_applies"] == len(rounds)  # one whole-batch apply a round
    assert s.digest() == js.digest()
    assert s.digest(full=False) == js.digest(full=False)
    assert s.read_all() == js.read_all()
    # every round's counts cover the whole batch; ins streams share a bucket
    for (counts, ins, _, _, _), _, _ in rounds:
        assert all(c.shape == (s._padded_docs,) for c in counts)
        assert len({t.shape[0] for t in ins}) == 1


def test_replay_reproduces_session_and_reference_digest(captured):
    s, rounds, _, _ = captured["port"]
    js, ref_rounds, _, _ = captured["jax"]
    assert not any(d.fallback for d in s.docs) and s.overflow_count() == 0
    per_doc = replay_rounds(rounds, s._padded_docs, s.config, s.device,
                            s._digest_tables(0, s._padded_docs))
    assert per_doc.shape == (s._padded_docs,)
    digest = replay_digest(per_doc)
    assert digest == s.digest()
    # the reference bench's replay (bench.py run_engine), one round a call
    state = jax_empty_docs(js._padded_docs, CAPS["slot_capacity"], CAPS["mark_capacity"],
                           tomb_capacity=CAPS["tomb_capacity"])
    for inputs, widths, loop_slots in ref_rounds:
        state = apply_batch_compact_jit(state, *inputs, widths=widths,
                                        insert_loop_slots=loop_slots)
    _, ref_per_doc = _resolve_block_digest_jit(state, js.comment_capacity,
                                               jnp.ones(js._padded_docs, bool),
                                               *js._digest_tables(0, js._padded_docs))
    assert np.asarray(ref_per_doc).astype(np.int64).tolist() == per_doc.numpy().tolist()
    assert int(np.asarray(ref_per_doc).sum(dtype=np.uint32)) == digest
    # a second replay from the same rounds gives the same vector
    again = replay_rounds(rounds, s._padded_docs, s.config, s.device,
                          s._digest_tables(0, s._padded_docs))
    assert replay_digest(again) == digest


def test_two_blocks_apply_whole_batch(frames, captured):
    port, ref = [], []
    before = GLOBAL_COUNTERS.get("streaming.block_applies")
    s = _run(StreamingMerge, frames, port, read_chunk=16, device="cpu")
    applies = GLOBAL_COUNTERS.get("streaming.block_applies") - before
    assert s._n_blocks() == 2 and not s._fused_eligible()
    assert applies == len(port) == s.rounds  # one apply a round, not one a touched block
    js = _run(JaxStreamingMerge, frames, ref, read_chunk=16)
    _assert_same_rounds(port, ref)
    twin = _run(StreamingMerge, frames, None, read_chunk=16, device="cpu")
    patches = s.read_patches_all()  # a patch read drains: one read per session
    for other in (twin, js):
        assert other.read_patches_all() == patches
    for other in (twin, js, captured["port"][0]):
        assert s.digest() == other.digest()
        assert s.read_all() == other.read_all()
    assert replay_digest(replay_rounds(port, s._padded_docs, s.config, s.device,
                                       s._digest_tables(0, s._padded_docs))) == s.digest()


def test_capture_turns_fused_drain_off(frames, captured):
    s, _, delta, occupancy = captured["port"]
    js, _, ref_delta, ref_occupancy = captured["jax"]
    assert s._fused_eligible() is False and js._fused_eligible() is False
    assert delta["streaming.fused_dispatches"] == ref_delta["streaming.fused_dispatches"] == 0
    assert occupancy == ref_occupancy
    assert {row["origin"] for row in occupancy["occupancy"].values()} == {"streaming.round"}
    # disarmed, the same sessions are fused-eligible again, as the twin is
    s._capture_rounds = None
    js._capture_rounds = None
    assert s._fused_eligible() is True and js._fused_eligible() is True
    twin, twin_delta, twin_occupancy = _profiled(StreamingMerge, frames, None, GLOBAL_DEVPROF,
                                                 GLOBAL_COUNTERS, device="cpu")
    assert twin_delta["streaming.fused_dispatches"] == ROUNDS
    assert {row["origin"] for row in twin_occupancy["occupancy"].values()} == \
        {"streaming.fused"}
    assert twin.digest() == s.digest()


@pytest.mark.parametrize("layout", ["paged", "ragged"])
def test_page_pool_layouts_ignore_the_hook(frames, captured, layout):
    port, ref = [], []
    s = _run(StreamingMerge, frames, port, layout=layout, device="cpu")
    js = _run(JaxStreamingMerge, frames, ref, layout=layout)
    assert port == [] and ref == []
    padded = captured["port"][0]
    assert s.digest() == js.digest() == padded.digest()
    assert s.read_all() == js.read_all() == padded.read_all()


def test_mesh_session_refuses_capture(frames, captured):
    mesh = make_mesh(2, device="cpu")
    s = StreamingMerge(num_docs=DOCS, actors=ACTORS, **CAPS, mesh=mesh)
    with pytest.raises(ValueError, match="mesh session cannot capture"):
        s._capture_rounds = []
    assert s._capture_rounds is None
    s._capture_rounds = None  # disarming is always allowed
    for r in range(ROUNDS):
        s.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
        s.drain()
    assert s.digest() == captured["port"][0].digest()
    # a page-pool mesh session ignores the hook, as every page-pool session
    paged = StreamingMerge(num_docs=DOCS, actors=ACTORS, **CAPS, mesh=mesh, layout="paged")
    paged._capture_rounds = []
    assert paged._capture_rounds == []
