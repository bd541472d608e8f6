"""The port's mesh sessions (``StreamingMerge(mesh=...)``, on the CPU over
virtual shards) against the reference package's mesh sessions on the
virtual CPU devices conftest.py forces, and against the port's own
meshless twin; then the entry points that carry a mesh through: restore,
the supervisor, the fuzz campaigns and a two-host cluster.

For 1, 2, 4 and 8 shards, a session's ``digest(full=True|False)``,
``read_all``, ``read_patches_all``, ``health()`` (the keys both packages
report), ``_mesh_stats()`` and ``reshard()`` result equal the reference
mesh session's exactly, and the reads and digests equal the meshless
twin's; every shard tensor lies on its shard's device; and each commit
counter equals the insert-kernel calls it counts (on the CPU the plain
versions run where a card launches the kernels: one call per launch, and
for the ragged kernel one launch per non-empty doc class of each call).
This file holds the ragged layout; tests/test_torch_mesh.py holds the
padded one and tests/test_torch_mesh_store.py the paged one (the JAX
reference's compiles of each layout's mesh programs, shared out so no
file runs long).
"""

import functools
import random
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch import checkpoint as ckpt
from peritext_tpu_torch.api.batch import _oracle_doc
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops import kernel as kernel_mod
from peritext_tpu_torch.ops import ragged as ragged_mod
from peritext_tpu_torch.ops.insert import SMEM_BUDGET
from peritext_tpu_torch.ops.ragged_insert import ragged_teams
from peritext_tpu_torch.parallel import ChangeStore, ReplicaServer
from peritext_tpu_torch.parallel.codec import encode_frame
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.parallel.supervisor import GuardedSession
from peritext_tpu_torch.testing import fuzz
from peritext_tpu_torch.testing.accumulate import accumulate_patches

ACTORS = ("doc1", "doc2", "doc3")
DOCS, OPS, SEED, ROUNDS = 14, 40, 21, 2
CAPS = dict(slot_capacity=256, mark_capacity=128, tomb_capacity=128)
SHARDS = (1, 2, 4, 8)
APPLY_COUNTER = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
                 "ragged": "streaming.ragged_applies"}


def _port(changes):
    return [Change.from_json(c.to_json()) for c in changes]


@functools.lru_cache(maxsize=None)
def arrival():
    """Per-doc round batches: the reference's changes, and the same batches
    crossed to the port through the wire format.  14 docs, so 4 and 8
    shards pad the doc axis."""
    rng = random.Random(SEED)
    ref = []
    for w in generate_workload(SEED, num_docs=DOCS, ops_per_doc=OPS):
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        size = -(-len(chs) // ROUNDS)
        ref.append([chs[i:i + size] for i in range(0, len(chs), size)])
    return ref, [[_port(b) for b in doc] for doc in ref]


def jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("docs",))


def feed(s, batches):
    for r in range(ROUNDS):
        for d, b in enumerate(batches):
            if r < len(b):
                s.ingest(d, b[r])
        s.drain()
    return s


def snapshot(s, text_digest=True):
    """Every read a mesh must not change (read_patches_all consumes the
    patch stream, so each session is read once)."""
    return (s.digest(), s.digest(full=False) if text_digest else None, s.read_all(),
            s.read_patches_all())


@functools.lru_cache(maxsize=None)
def twin(layout):
    """The port's meshless session of ``layout`` and its snapshot."""
    s = feed(StreamingMerge(num_docs=DOCS, actors=ACTORS, layout=layout, device="cpu", **CAPS),
             arrival()[1])
    return s, snapshot(s)


class LaunchCount:
    """Counts, on the CPU, the kernel launches a card would make: one per
    insert_batch call, and one per non-empty doc class of each
    ragged_insert call."""

    def __init__(self, monkeypatch):
        self.insert = self.ragged = 0
        insert, ragged = kernel_mod.insert_batch, ragged_mod.ragged_insert

        def insert_rec(*args, **kw):
            self.insert += 1
            return insert(*args, **kw)

        def ragged_rec(pool_elem, *args, page_count_host=None, **kw):
            page_table = args[5]
            self.ragged += len(ragged_teams(page_count_host, pool_elem.shape[1],
                                            page_table.shape[1], SMEM_BUDGET, 1))
            return ragged(pool_elem, *args, page_count_host=page_count_host, **kw)

        monkeypatch.setattr(kernel_mod, "insert_batch", insert_rec)
        monkeypatch.setattr(ragged_mod, "ragged_insert", ragged_rec)


def shard_tensors(s):
    """Every per-shard tensor of a mesh session, by shard."""
    if s.layout == "padded":
        return [list(st) for st in s._shard_state]
    store = s.store
    return [[store.pools_elem[k], store.pools_char[k], *store.shard_aux[k]]
            for k in range(store.n_shards)]


def check_layout_on_mesh(layout, n, monkeypatch):
    """One port mesh session against the reference's and the meshless twin
    (module doc)."""
    ref_batches, port_batches = arrival()
    mesh = make_mesh(n, device="cpu")
    counters = {c: GLOBAL_COUNTERS.get(c) for c in APPLY_COUNTER.values()}
    launches = LaunchCount(monkeypatch)
    t = feed(StreamingMerge(num_docs=DOCS, actors=ACTORS, layout=layout, mesh=mesh,
                            device="cpu", **CAPS), port_batches)
    delta = {c: int(GLOBAL_COUNTERS.get(c) - v) for c, v in counters.items()}
    kernel = "ragged" if layout == "ragged" else "insert"
    assert getattr(launches, kernel) == delta[APPLY_COUNTER[layout]] > 0
    assert sum(delta.values()) == delta[APPLY_COUNTER[layout]]
    if layout == "padded":
        # one launch per touched shard of each committed round
        assert delta[APPLY_COUNTER[layout]] >= t.rounds
    j = feed(JaxStreamingMerge(num_docs=DOCS, actors=ACTORS, layout=layout, mesh=jax_mesh(n),
                               **CAPS), ref_batches)
    assert t._padded_docs == j._padded_docs == -(-DOCS // n) * n
    snap = snapshot(t)
    assert snap == twin(layout)[1]
    # the reference's text digest compiles programs of its own; the port's
    # equals the twin's, and the twin's the reference's (tests/test_torch_digest.py)
    assert snapshot(j, text_digest=False) == (snap[0], None) + snap[2:]
    assert t.rounds == j.rounds
    assert t.digest(refresh=True) == snap[0]
    assert t.digest_async().wait() == snap[0]
    assert [t.doc_digest(d) for d in range(DOCS)] == [j.doc_digest(d) for d in range(DOCS)]
    h_t, h_j = t.health(), j.health()
    assert {k: h_t[k] for k in h_j if k in h_t} == {k: h_j[k] for k in h_j if k in h_t}
    assert t._mesh_stats() == j._mesh_stats()
    for k, tensors in enumerate(shard_tensors(t)):
        assert all(x.device == mesh.devices[k] for x in tensors)
    storages = {x.untyped_storage().data_ptr() for ts in shard_tensors(t) for x in ts
                if x.numel()}
    assert len(storages) == sum(1 for ts in shard_tensors(t) for x in ts if x.numel())
    out_t, out_j = t.reshard(), j.reshard()
    assert out_t == out_j
    assert t._mesh_stats() == j._mesh_stats()
    assert (t.digest(), t.read_all()) == (j.digest(), j.read_all()) == (snap[0], snap[2])
    assert t.digest(full=False) == snap[1]
    return t


@pytest.mark.parametrize("n", SHARDS)
def test_ragged_mesh_equals_reference_and_twin(n, monkeypatch):
    t = check_layout_on_mesh("ragged", n, monkeypatch)
    # the per-shard plans: local rows, local pages, each shard's own null page
    plans = t._shard_planes()
    assert len(plans) == n
    for k, (plan, planes) in enumerate(plans):
        assert plan.num_rows == t.store.rows_per_shard
        assert all(p.device == t.mesh.devices[k] for p in planes)
        assert int(plan.owner[0]) == plan.num_rows  # the null page has no owner


def test_mesh_drain_counts_one_fused_dispatch_per_batch():
    """As the reference's mesh drain, every layout counts one fused
    dispatch per scheduled batch."""
    _, port_batches = arrival()
    for layout in APPLY_COUNTER:
        s = StreamingMerge(num_docs=DOCS, actors=ACTORS, layout=layout,
                           mesh=make_mesh(4, device="cpu"), device="cpu", **CAPS)
        for d, b in enumerate(port_batches):
            s.ingest(d, [ch for batch in b for ch in batch])
        before = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
        s.drain()
        assert GLOBAL_COUNTERS.get("streaming.fused_dispatches") - before == 1, layout


def test_mesh_session_rules():
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        StreamingMerge(num_docs=2, actors=ACTORS, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="device type"):
        StreamingMerge(num_docs=2, actors=ACTORS, mesh=mesh, device="cuda")
    s = StreamingMerge(num_docs=3, actors=ACTORS, mesh=mesh)
    assert s.device == torch.device("cpu") and s.mesh is mesh and s._padded_docs == 4
    assert s.config["read_chunk"] == 8192 and s.state is None
    assert s.digest() == StreamingMerge(num_docs=3, actors=ACTORS, device="cpu").digest()


# -- restore -------------------------------------------------------------------


def test_restore_across_meshes(tmp_path):
    """A mesh session restores meshless and onto another mesh, and a
    meshless one onto a mesh, each with the source's digest and reads (the
    meshless source's digest is the reference's, tests/test_torch_checkpoint.py
    restores checkpoints across the packages)."""
    src, snap = twin("ragged")
    ckpt.save_session(src, tmp_path / "meshless")
    on_mesh = ckpt.restore_session(tmp_path / "meshless", mesh=make_mesh(4, device="cpu"))
    assert on_mesh.mesh.size == 4
    assert (on_mesh.digest(), on_mesh.read_all()) == (snap[0], snap[2])
    ckpt.save_session(on_mesh, tmp_path / "mesh4")
    for mesh in (None, make_mesh(2, device="cpu")):
        back = ckpt.restore_session(tmp_path / "mesh4", mesh=mesh, device="cpu")
        assert (back.digest(), back.digest(full=False), back.read_all()) == snap[:3]
    manager = ckpt.CheckpointManager(tmp_path / "managed", device="cpu")
    manager.save(step=1, session=on_mesh)
    assert manager.latest().session(mesh=make_mesh(8, device="cpu")).digest() == snap[0]


def test_crash_restore_campaign_on_a_mesh():
    """The reference's mesh variant of the crash campaign (its
    tests/test_checkpoint.py, which runs the reference's on a 4-device
    mesh): the mesh session restores meshless and reaches the clean
    session's digest, spans and roots (the campaign's own oracles); the
    redelivery schedule does not depend on the mesh."""
    mine = fuzz.run_crash_restore(seed=12, num_docs=6, ops_per_doc=60,
                                  mesh=make_mesh(4, device="cpu"), device="cpu")
    assert mine > 0
    assert mine == fuzz.run_crash_restore(seed=12, num_docs=6, ops_per_doc=60, device="cpu")


# -- the supervisor, the fuzz campaigns ------------------------------------------


def test_guarded_session_rolls_back_onto_its_mesh(tmp_path):
    """An injected failure rolls the supervised mesh session back to its
    checkpoint, restored onto the same mesh; the result equals the
    meshless twin."""
    ref_batches, port_batches = arrival()
    mesh = make_mesh(4, device="cpu")
    g = GuardedSession(
        lambda: StreamingMerge(num_docs=DOCS, actors=ACTORS, mesh=mesh, device="cpu", **CAPS),
        tmp_path, mesh=mesh, deadline=60.0, checkpoint_every=1, autotune=False)
    before = set(threading.enumerate())
    try:
        for r in range(ROUNDS):
            g.ingest_frames((d, encode_frame(b[r])) for d, b in enumerate(port_batches)
                            if r < len(b))
            if r == 1:
                g.inject_failure(RuntimeError("injected device fault"))
            g.drain()
        assert g.rollbacks == 1
        assert g.session.mesh == mesh and g.session._shard_state is not None
        snap = twin("padded")[1]
        assert (g.digest(), g.read_all()) == (snap[0], snap[2])
        assert g.join_abandoned(timeout=30)
    finally:
        g.close()
        for thread in set(threading.enumerate()) - before:
            thread.join(timeout=30)


@pytest.mark.parametrize("campaign", ["differential", "differential_frames"])
def test_fuzz_campaigns_on_a_mesh(campaign):
    mesh = make_mesh(3, device="cpu")
    if campaign == "differential":
        assert fuzz.run_differential(4, num_docs=5, ops_per_doc=40, mesh=mesh, device="cpu") == 5
    else:
        assert fuzz.run_differential_frames(4, num_docs=5, ops_per_doc=40, mesh=mesh,
                                            device="cpu") >= 0


# -- two hosts, each on a 4-shard mesh (the reference's tests/test_cluster.py) ---


class HostSim:
    """One host: a durable change log, a TCP replica endpoint and a mesh
    session fed by frames; pushes land on the server's handler thread."""

    def __init__(self, mesh, actors, doc_of_actor):
        self.store = ChangeStore()
        self.session = StreamingMerge(
            num_docs=4, actors=actors, slot_capacity=512, mark_capacity=128,
            round_insert_capacity=128, round_delete_capacity=64, round_mark_capacity=64,
            mesh=mesh, device="cpu")
        self.doc_of_actor = doc_of_actor
        self._lock = threading.Lock()
        self._delivered = 0
        self.server = ReplicaServer(self.store, on_changes=self._on_changes)
        self.address = self.server.start()

    def _on_changes(self, fresh):
        with self._lock:
            by_doc = {}
            for ch in fresh:
                by_doc.setdefault(self.doc_of_actor[ch.actor], []).append(ch)
            for d, changes in by_doc.items():
                self.session.ingest_frame(d, encode_frame(changes))
            self.session.drain()
            self._delivered += len(fresh)

    def author(self, changes):
        for ch in changes:
            self.store.append(ch)
        self._on_changes(changes)

    def settled(self):
        in_store = sum(len(self.store.log(a)) for a in self.store.actors())
        with self._lock:
            return self._delivered == in_store


def _namespaced(seed=130, docs=4, ops=48):
    """Per-doc workloads with actors renamed per doc (``d{doc}.{replica}``),
    so one change store holds every doc's logs (reference and port
    copies)."""
    out = []
    for d, w in enumerate(generate_workload(seed=seed, num_docs=docs, ops_per_doc=ops)):
        mapping = {a: f"d{d}.{a}" for a in ACTORS}

        def rename_id(v):
            if isinstance(v, str) and "@" in v:
                ctr, a = v.split("@")
                return f"{ctr}@{mapping.get(a, a)}"
            return v

        renamed = {}
        for actor, log in w.items():
            new_log = []
            for ch in log:
                j = ch.to_json()
                j["actor"] = mapping[j["actor"]]
                j["deps"] = {mapping.get(a, a): s for a, s in j["deps"].items()}
                for op in j["ops"]:
                    for key in ("opId", "obj", "elemId"):
                        if key in op:
                            op[key] = rename_id(op[key])
                    for bkey in ("start", "end"):
                        b = op.get(bkey)
                        if isinstance(b, dict) and "elemId" in b:
                            b["elemId"] = rename_id(b["elemId"])
                new_log.append(j)
            renamed[mapping[actor]] = new_log
        out.append(renamed)
    return out


def test_cluster_of_two_mesh_hosts(tmp_path):
    """Two hosts on 4-shard meshes replicate over TCP; one checkpoints,
    crashes, restores onto its mesh and catches up: its digest equals the
    other host's and a meshless session's fed the same changes, and every
    doc's spans and the survivor's patch streams equal the oracles of both
    packages."""
    import time

    from peritext_tpu.core.types import Change as JaxChange

    raw = _namespaced()
    workloads = [{a: [Change.from_json(j) for j in log] for a, log in w.items()} for w in raw]
    all_actors = sorted({a for w in workloads for a in w})
    doc_of_actor = {a: d for d, w in enumerate(workloads) for a in w}
    mesh = make_mesh(4, device="cpu")
    h0, h1 = HostSim(mesh, all_actors, doc_of_actor), HostSim(mesh, all_actors, doc_of_actor)
    try:
        for w in workloads:
            for actor, log in w.items():
                if log:
                    (h1 if actor.endswith(".doc3") else h0).author(log)
        h0.server.sync_with(*h1.address)
        deadline = time.monotonic() + 30
        while not (h0.settled() and h1.settled()):
            assert time.monotonic() < deadline, "hosts did not settle"
            time.sleep(0.01)
        assert h0.store.clock() == h1.store.clock()
        ckpt.save_session(h0.session, tmp_path / "h0")
        h0.server.stop()
        restored = ckpt.restore_session(tmp_path / "h0", mesh=mesh)
        for d in range(len(workloads)):
            changes = [ch for a in h0.store.actors() if doc_of_actor[a] == d
                       for ch in h0.store.log(a)]
            if changes:
                restored.ingest_frame(d, encode_frame(changes))
        restored.drain()
        plain = StreamingMerge(num_docs=4, actors=all_actors, slot_capacity=512,
                               mark_capacity=128, round_insert_capacity=128,
                               round_delete_capacity=64, round_mark_capacity=64, device="cpu")
        for d, w in enumerate(workloads):
            plain.ingest(d, [ch for log in w.values() for ch in log])
        plain.drain()
        assert restored.digest() == h1.session.digest() == plain.digest()
        for d, (w, w_raw) in enumerate(zip(workloads, raw)):
            expected = _oracle_doc(w).get_text_with_formatting(["text"])
            assert expected == jax_oracle_doc({a: [JaxChange.from_json(j) for j in log]
                                               for a, log in w_raw.items()}
                                              ).get_text_with_formatting(["text"])
            assert restored.read(d) == h1.session.read(d) == expected, d
            assert accumulate_patches(h1.session.read_patches(d)) == expected, d
    finally:
        h1.server.stop()


def test_devprof_mesh_section_and_gauges_equal_the_reference():
    """A profiled mesh session feeds the device profiler's mesh section at
    each commit, as the reference's does: the section and the
    ``peritext_mesh_*`` gauges equal the reference's for twin sessions."""
    from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
    from peritext_tpu.obs.exporters import prometheus_text as jax_prometheus_text
    from peritext_tpu_torch.obs import GLOBAL_DEVPROF
    from peritext_tpu_torch.obs.exporters import prometheus_text

    ref_batches, port_batches = arrival()
    sections = []
    for prof, build, batches, text in (
            (GLOBAL_DEVPROF, lambda: StreamingMerge(
                num_docs=DOCS, actors=ACTORS, layout="ragged", mesh=make_mesh(4, device="cpu"),
                device="cpu", **CAPS), port_batches, prometheus_text),
            (JAX_DEVPROF, lambda: JaxStreamingMerge(
                num_docs=DOCS, actors=ACTORS, layout="ragged", mesh=jax_mesh(4), **CAPS),
             ref_batches, jax_prometheus_text)):
        prof.reset()
        prof.enable()
        try:
            feed(build(), batches)
            mesh = prof.snapshot()["mesh"]
            gauges = [line for line in text(devprof=prof).splitlines()
                      if line.startswith("peritext_mesh_")]
        finally:
            prof.disable()
            prof.reset()
        sections.append((mesh, gauges))
    assert sections[0] == sections[1]
    assert sections[0][0]["shards"] == 4 and sections[0][1]


def test_session_mux_reads_a_mesh_session():
    """A serving mux over a 2-shard mesh session answers as over its
    meshless twin, and its latency plane records the session's shards."""
    from peritext_tpu_torch.obs import LatencyPlane
    from peritext_tpu_torch.serve import SessionMux

    _, port_batches = arrival()
    outs = []
    for mesh in (None, make_mesh(2, device="cpu")):
        s = StreamingMerge(num_docs=DOCS, actors=ACTORS, static_rounds=True, mesh=mesh,
                           device="cpu", **CAPS)
        mux = SessionMux(s)
        mux.latency_plane = LatencyPlane().enable()
        sids = [mux.open_session(f"c{d}")[0] for d in range(DOCS)]
        patches = {sid: [] for sid in sids}
        for r in range(ROUNDS):
            for d, b in enumerate(port_batches):
                if r < len(b):
                    mux.submit(sids[d], encode_frame(b[r]))
            mux.flush()
            for sid in sids:
                patches[sid].extend(mux.patches(sid))
        outs.append((patches, [mux.read(sid) for sid in sids], s.digest(),
                     mux.latency_plane.max_shards))
    assert outs[0][:3] == outs[1][:3]
    assert (outs[0][3], outs[1][3]) == (1, 2)
