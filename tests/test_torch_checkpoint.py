"""The port's checkpoints (``peritext_tpu_torch.checkpoint``), failed traces
and guarded merge, against the JAX package's, on the CPU.

Every file the port writes is byte-equal to the reference's for the same
input (the ``.npz`` member by member: its zip headers carry the write
time), and each package restores the other's: a streaming session in each
layout, saved by either package, restores in both with equal digests,
reads and frontier.  ``DocBatch(guard=True)`` with an injected device-stage
failure in each layout must give the reference's guarded report.
"""

import json
import os
import time
import zipfile

import numpy as np
import pytest
import torch

import peritext_tpu.checkpoint as ref_ckpt
from peritext_tpu.api.batch import DocBatch as RefDocBatch
from peritext_tpu.parallel.codec import encode_frame as ref_encode_frame
from peritext_tpu.parallel.streaming import StreamingMerge as RefStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload as ref_generate_workload
from peritext_tpu.testing.fuzz import run_fuzz as ref_run_fuzz
from peritext_tpu_torch import checkpoint as ckpt
from peritext_tpu_torch.api import batch as batch_mod
from peritext_tpu_torch.api.batch import DocBatch, _oracle_doc
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.packed import to_numpy
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.fuzz import generate_workload, run_crash_restore, run_fuzz
from peritext_tpu_torch.testing.traces import load_trace_queues, replay_queues

ACTORS = ("doc1", "doc2", "doc3")
LAYOUTS = ["padded", "paged", "ragged"]
SESSION = dict(slot_capacity=512, mark_capacity=128, round_insert_capacity=128,
               round_delete_capacity=64, round_mark_capacity=64)


def _to_port(changes):
    return [Change.from_json(c.to_json()) for c in changes]


# ---------------------------------------------------------------------------
# change logs, packed snapshots, frame blobs, failed traces
# ---------------------------------------------------------------------------


def test_change_log_byte_equal_and_restores(tmp_path):
    state, ref_state = run_fuzz(seed=11, iterations=40), ref_run_fuzz(seed=11, iterations=40)
    n = ckpt.save_change_log(state.store, tmp_path / "port.jsonl")
    assert n == ref_ckpt.save_change_log(ref_state.store, tmp_path / "ref.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "ref.jsonl").read_bytes()
    for line in (tmp_path / "port.jsonl").read_text().splitlines():
        assert {"actor", "seq", "deps", "startOp", "ops"} <= set(json.loads(line))
    store = ckpt.load_change_log(tmp_path / "ref.jsonl")
    assert store.clock() == ref_state.store.clock()
    doc = ckpt.doc_from_store(store)
    ref_doc = ref_ckpt.doc_from_store(ref_ckpt.load_change_log(tmp_path / "port.jsonl"))
    assert doc.get_text_with_formatting(["text"]) == ref_doc.get_text_with_formatting(["text"])
    assert doc.get_text_with_formatting(["text"]) == \
        ckpt.doc_from_store(state.store).get_text_with_formatting(["text"])


def test_failed_trace_byte_equal_and_replayable(tmp_path):
    state, ref_state = run_fuzz(seed=4, iterations=30), ref_run_fuzz(seed=4, iterations=30)
    evidence = {"leftText": "x", "rightText": "y"}
    ckpt.save_failed_trace(tmp_path / "port.json", state.store, evidence=evidence)
    ref_ckpt.save_failed_trace(tmp_path / "ref.json", ref_state.store, evidence=evidence)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    doc = replay_queues(load_trace_queues(str(tmp_path / "ref.json")))
    assert doc.get_text_with_formatting(["text"]) == \
        ckpt.doc_from_store(state.store).get_text_with_formatting(["text"])


def _packed_state():
    workloads = generate_workload(seed=2, num_docs=4, ops_per_doc=30)
    batch = DocBatch(device="cpu", slot_capacity=128, mark_capacity=64)
    return to_numpy(batch.apply_encoded(batch.encode(workloads)))


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def test_packed_npz_equal_both_ways(tmp_path):
    state = _packed_state()
    ckpt.save_packed(state, tmp_path / "port.npz")
    ref_ckpt.save_packed(state, tmp_path / "ref.npz")
    assert _members(tmp_path / "port.npz") == _members(tmp_path / "ref.npz")
    ours = ckpt.load_packed(tmp_path / "ref.npz", device="cpu")
    theirs = ref_ckpt.load_packed(tmp_path / "port.npz")
    for name, a, b, c in zip(ours._fields, ours, theirs, state):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        np.testing.assert_array_equal(a.numpy(), c, err_msg=name)
    # tensors (any device) save as their values
    ckpt.save_packed(ours, tmp_path / "tensors.npz")
    assert _members(tmp_path / "tensors.npz") == _members(tmp_path / "ref.npz")


def test_packed_absent_fields_default_like_reference(tmp_path):
    state = _packed_state()
    np.savez_compressed(tmp_path / "old.npz", elem_id=state.elem_id, char=state.char)
    ours = ckpt.load_packed(tmp_path / "old.npz", device="cpu")
    theirs = ref_ckpt.load_packed(tmp_path / "old.npz")
    for name, a, b in zip(ours._fields, ours, theirs):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    ckpt.save_packed(_packed_state(), tmp_path / "p.npz")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.load_packed(tmp_path / "p.npz")
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "session.json").write_text(json.dumps(
        {"actors": ["a"], "config": {"num_docs": 1}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore_session(tmp_path / "s")
    # a mesh names its own devices: a CPU mesh restores without a card
    restored = ckpt.restore_session(tmp_path / "s", mesh=make_mesh(2, device="cpu"))
    assert restored.mesh.size == 2 and restored.device == torch.device("cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ckpt.restore_session(tmp_path / "s", mesh=object(), device="cpu")


def test_frame_blobs_byte_equal():
    frames = [b"", b"abc", bytes(range(256)) * 3]
    blob = ckpt.pack_doc_frames(frames)
    assert blob == ref_ckpt.pack_doc_frames(frames)
    assert ckpt.unpack_doc_frames(blob) == ref_ckpt.unpack_doc_frames(blob) == frames
    for cut in (1, 5, len(blob) - 1):
        with pytest.raises(ValueError):
            ckpt.unpack_doc_frames(blob[:cut])


# ---------------------------------------------------------------------------
# streaming-session checkpoints, across the two packages, every layout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workloads():
    return ref_generate_workload(seed=61, num_docs=4, ops_per_doc=60)


def _fill(sess, workloads, encode):
    """Docs alternate frame and object ingest, as the reference's own
    checkpoint test mixes them; a frame doc gets its changes, shuffled, in
    three frames (so a restore re-ingests several frames a doc, out of
    causal order); the last doc's changes stay pending behind its missing
    first change (a mid-stream checkpoint)."""
    import random

    rng = random.Random(8)
    for d, w in enumerate(workloads):
        changes = [ch for log in w.values() for ch in log]
        if d == len(workloads) - 1:
            changes = changes[1:]
        if d % 2:
            sess.ingest(d, changes)
        else:
            order = list(range(len(changes)))
            rng.shuffle(order)
            third = -(-len(order) // 3)
            for lo in range(0, len(order), third):
                sess.ingest_frame(d, encode([changes[i] for i in order[lo:lo + third]]))
    sess.drain()
    return sess


@pytest.fixture(scope="module", params=LAYOUTS)
def sessions(request, workloads, tmp_path_factory):
    layout = request.param
    port_wl = [{a: _to_port(log) for a, log in w.items()} for w in workloads]
    ours = _fill(StreamingMerge(num_docs=len(workloads), actors=ACTORS, layout=layout,
                                device="cpu", **SESSION), port_wl, encode_frame)
    theirs = _fill(RefStreamingMerge(num_docs=len(workloads), actors=ACTORS, layout=layout,
                                     **SESSION), workloads, ref_encode_frame)
    ours.first_patches = ours.read_patches_all()  # from empty: every doc whole
    root = tmp_path_factory.mktemp(f"ckpt_{layout}")
    meta = ckpt.save_session(ours, root / "port")
    ref_meta = ref_ckpt.save_session(theirs, root / "ref")
    return layout, ours, theirs, root, meta, ref_meta


def _same(a, b):
    assert a.digest() == b.digest()
    assert a.digest(full=False) == b.digest(full=False)
    assert a.read_all() == b.read_all()
    assert a.frontier() == b.frontier()
    assert a.pending_count() == b.pending_count()
    assert a.layout == b.layout


def test_session_files_equal_reference(sessions):
    layout, ours, theirs, root, meta, ref_meta = sessions
    assert meta == ref_meta and meta["layout"] == layout and meta["frames"] > 0
    assert "device" not in json.dumps(meta)
    names = sorted(p.name for p in (root / "port").iterdir())
    assert names == sorted(p.name for p in (root / "ref").iterdir())
    for name in names:
        assert (root / "port" / name).read_bytes() == (root / "ref" / name).read_bytes(), name


@pytest.mark.parametrize("source", ["port", "ref"])
def test_port_restores_either_checkpoint(sessions, source):
    layout, ours, theirs, root, _, _ = sessions
    restored = ckpt.restore_session(root / source, device="cpu")
    assert type(restored) is type(ours) and restored.device.type == "cpu"
    _same(restored, ours)
    _same(restored, theirs)
    assert restored.read_patches_all() == ours.first_patches
    assert sorted(d for d, s in enumerate(restored.docs) if s.fallback) == \
        sorted(d for d, s in enumerate(ours.docs) if s.fallback)


def test_reference_restores_port_checkpoint(sessions):
    layout, ours, theirs, root, _, _ = sessions
    restored = ref_ckpt.restore_session(root / "port")
    _same(restored, theirs)
    assert restored.digest() == ours.digest() and restored.read_all() == ours.read_all()


def test_restore_undrained_then_continue(sessions, workloads):
    layout, ours, _, root, _, _ = sessions
    restored = ckpt.restore_session(root / "port", drain=False, device="cpu")
    assert restored.pending_count() > 0 and restored.rounds == 0
    last = len(workloads) - 1
    first = min((ch for log in workloads[last].values() for ch in log),
                key=lambda c: (c.seq, c.actor))
    restored.ingest(last, _to_port([first]))
    while restored.drain():
        pass
    assert restored.pending_count() == 0
    for d, w in enumerate(workloads):
        expected = _oracle_doc({a: _to_port(log) for a, log in w.items()})
        assert restored.read(d) == expected.get_text_with_formatting(["text"])


def test_corrupt_frame_raises_in_both_packages(sessions, tmp_path):
    """Both packages refuse a checkpoint holding a frame that does not
    decode.  The port ingests all frames in one bulk call where the
    reference ingests one frame at a time, so the port raises only after
    queueing the other docs' frames; both raise the codec's DecodeError."""
    import shutil

    from peritext_tpu.core.errors import DecodeError as RefDecodeError
    from peritext_tpu_torch.core.errors import DecodeError

    layout, _, _, root, _, _ = sessions
    bad = tmp_path / "bad"
    shutil.copytree(root / "port", bad)
    path = bad / "doc_000000.frames"
    frames = ckpt.unpack_doc_frames(path.read_bytes())
    assert len(frames) > 1
    frames[1] = b"\xff" * 16
    path.write_bytes(ckpt.pack_doc_frames(frames))
    with pytest.raises(DecodeError):
        ckpt.restore_session(bad, device="cpu")
    with pytest.raises(RefDecodeError):
        ref_ckpt.restore_session(bad)


# ---------------------------------------------------------------------------
# the manager, the crash campaign
# ---------------------------------------------------------------------------


def test_manager_retention_atomicity_and_sweep(tmp_path, workloads):
    root = tmp_path / "ckpt"
    root.mkdir()
    stale, fresh = root / ".staging_stale", root / ".staging_live"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 2 * 3600
    os.utime(stale, (old, old))
    mgr = ckpt.CheckpointManager(root, keep=2, device="cpu")
    assert not stale.exists() and fresh.exists()  # only stale staging is swept
    with pytest.raises(ValueError):
        mgr.save(1)
    state = run_fuzz(seed=3, iterations=20)
    sess = _fill(StreamingMerge(num_docs=2, actors=ACTORS, device="cpu", **SESSION),
                 [{a: _to_port(log) for a, log in w.items()} for w in workloads[:2]],
                 encode_frame)
    for step in (1, 2, 3):
        mgr.save(step, store=state.store, packed=_packed_state(), session=sess,
                 meta={"phase": step})
    assert mgr.steps() == [2, 3]
    assert sorted(p.name for p in root.iterdir() if p.name.startswith(".staging")) == \
        [".staging_live"]

    def boom(*a, **k):
        raise RuntimeError("disk full")

    real = ckpt.save_session
    ckpt.save_session = boom
    try:
        with pytest.raises(RuntimeError):
            mgr.save(4, store=state.store, session=sess)
    finally:
        ckpt.save_session = real
    assert mgr.steps() == [2, 3]  # nothing published, staging removed
    assert sorted(p.name for p in root.iterdir() if p.name.startswith(".staging")) == \
        [".staging_live"]
    (root / "step_000000000009").mkdir()  # damaged: no meta.json
    latest = mgr.latest()
    assert latest.step == 3 and latest.meta["phase"] == 3
    assert latest.store.clock() == state.store.clock()
    assert latest.packed.elem_id.device.type == "cpu"
    restored = latest.session()
    assert restored.device.type == "cpu" and restored.digest() == sess.digest()
    # the reference's manager reads the port's checkpoint
    ref_latest = ref_ckpt.CheckpointManager(root, keep=2).latest()
    assert ref_latest.session().digest() == sess.digest()


def test_crash_restore_campaign():
    assert run_crash_restore(seed=11, num_docs=6, ops_per_doc=60, device="cpu") > 0


# ---------------------------------------------------------------------------
# the guarded merge
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def merge_inputs():
    import random

    workloads = ref_generate_workload(seed=41, num_docs=5, ops_per_doc=24)
    rng = random.Random(2)
    cursors = []
    for w in workloads:
        from peritext_tpu.api.batch import _oracle_doc as ref_oracle

        doc = ref_oracle(w)
        n = len(doc.root.get("text", []))
        cursors.append([doc.get_cursor(["text"], rng.randrange(n)) for _ in range(3)] if n else [])
    return workloads, cursors


def _boom(*args, **kwargs):
    raise RuntimeError("injected device failure")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_guarded_merge_equals_reference(layout, merge_inputs, monkeypatch):
    workloads, cursors = merge_inputs
    port_wl = [{a: _to_port(log) for a, log in w.items()} for w in workloads]
    kw = dict(slot_capacity=256, mark_capacity=64, layout=layout)
    clean = DocBatch(device="cpu", **kw).merge(port_wl, cursors)
    guarded = DocBatch(device="cpu", guard=True, **kw).merge(port_wl, cursors)
    assert "guarded_fallback" not in guarded.stats.extras
    for field in ("spans", "roots", "cursor_positions", "fallback_docs", "device_ops"):
        assert getattr(guarded, field) == getattr(clean, field), field

    ref = RefDocBatch(guard=True, **kw)
    monkeypatch.setattr(ref, "_resolve", _boom)  # inside the reference's guarded stages
    ref_report = ref.merge(workloads, cursors)
    monkeypatch.setattr(batch_mod, "resolve", _boom)
    before = GLOBAL_COUNTERS.get("merge.guarded_fallbacks")
    report = DocBatch(device="cpu", guard=True, **kw).merge(port_wl, cursors)
    assert GLOBAL_COUNTERS.get("merge.guarded_fallbacks") == before + 1
    assert report.fallback_docs == ref_report.fallback_docs == list(range(len(workloads)))
    for field in ("spans", "roots", "cursor_positions", "device_ops"):
        assert getattr(report, field) == getattr(ref_report, field), field
        assert getattr(report, field) == getattr(clean, field) or field == "device_ops"
    assert report.stats.extras["guarded_fallback"] == 1.0
    assert "injected device failure" in report.stats.extras["guarded_error"]
    assert (report.stats.fallback_docs, report.stats.device_docs, report.stats.fallback_ops) == \
        (ref_report.stats.fallback_docs, ref_report.stats.device_docs,
         ref_report.stats.fallback_ops)
    with pytest.raises(RuntimeError, match="injected"):
        DocBatch(device="cpu", **kw).merge(port_wl, cursors)


def test_guarded_merge_catches_the_apply_stage(merge_inputs, monkeypatch):
    workloads, _ = merge_inputs
    port_wl = [{a: _to_port(log) for a, log in w.items()} for w in workloads]
    monkeypatch.setattr(batch_mod, "apply_batch", _boom)
    report = DocBatch(device="cpu", guard=True).merge(port_wl)
    assert report.fallback_docs == list(range(len(workloads)))
    assert report.spans == [_oracle_doc(w).get_text_with_formatting(["text"]) for w in port_wl]
    with pytest.raises(RuntimeError):
        DocBatch(device="cpu").merge(port_wl)


def test_guarded_merge_raises_off_the_cpu(merge_inputs, monkeypatch):
    """The guard degrades only a CPU batch: off the CPU a failure of the
    device stages raises, guarded or not."""
    workloads, _ = merge_inputs
    port_wl = [{a: _to_port(log) for a, log in w.items()} for w in workloads]
    monkeypatch.setattr(batch_mod, "apply_batch", _boom)
    before = GLOBAL_COUNTERS.get("merge.guarded_fallbacks")
    with pytest.raises(RuntimeError, match="injected device failure"):
        DocBatch(device="meta", guard=True).merge(port_wl)
    assert GLOBAL_COUNTERS.get("merge.guarded_fallbacks") == before
