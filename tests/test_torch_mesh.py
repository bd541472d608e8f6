"""The port's device mesh (``peritext_tpu_torch/parallel/mesh.py``,
``parallel/mesh_fused.py``, ``utils/platform.py``) and the padded layout
over it, on the CPU, against the reference package's mesh on the virtual
CPU devices conftest.py forces: the cases of the reference's
tests/test_sharding.py (a sharded ``DocBatch`` merge, sharded state, the
digest's cross-shard sum, ``pad_doc_axis``, digests invariant across 1, 2,
4 and 8 shards) and the padded ``StreamingMerge`` over 1, 2, 4 and 8
shards (tests/test_torch_mesh_paths.py's check, which the paged and ragged
layouts run in their files).  Then the mesh's own rules: which devices a
mesh takes, what it refuses, and that shards never share storage.
"""

import numpy as np
import pytest
import torch

from peritext_tpu.api import DocBatch as JaxDocBatch
from peritext_tpu.ops.resolve import resolve_jit as jax_resolve_jit
from peritext_tpu.parallel import mesh as jax_mesh_mod
from peritext_tpu.parallel.mesh_fused import mesh_fingerprint as jax_fingerprint
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.api.batch import DocBatch, oracle_merge
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.ops import kernel as kernel_mod
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.packed import empty_docs
from peritext_tpu_torch.ops.resolve import resolve
from peritext_tpu_torch.parallel.mesh import (
    DOC_AXIS,
    Mesh,
    convergence_digest,
    doc_sharding,
    make_mesh,
    pad_doc_axis,
    shard_docs,
)
from peritext_tpu_torch.parallel.mesh_fused import mesh_fingerprint, shard_leading
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.fuzz import sample_cursors
from peritext_tpu_torch.utils.platform import mesh_devices
from test_torch_mesh_paths import SHARDS, check_layout_on_mesh, jax_mesh

BATCH = dict(slot_capacity=128, mark_capacity=64, comment_capacity=16, op_capacity=128)


def _port_workloads(ws):
    return [{a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}
            for w in ws]


@pytest.mark.parametrize("n", SHARDS)
def test_padded_mesh_equals_reference_and_twin(n, monkeypatch):
    t = check_layout_on_mesh("padded", n, monkeypatch)
    assert [st.elem_id.shape[0] for st in t._shard_state] == [t._padded_docs // n] * n


# -- DocBatch over a mesh (the reference's tests/test_sharding.py) ---------------


@pytest.fixture(scope="module")
def sharded_batch():
    """12 docs (padded to 16 on 8 shards): the reference's merge on its
    8-device mesh, the workloads crossed to the port, and cursors."""
    workloads = generate_workload(seed=5, num_docs=12, ops_per_doc=40)
    cursors = sample_cursors(_port_workloads(workloads), 3, 5)
    ref = JaxDocBatch(**BATCH, mesh=jax_mesh_mod.make_mesh()).merge(
        workloads, [[dict(c) for c in cs] for cs in cursors])
    return workloads, _port_workloads(workloads), cursors, ref


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_merge_matches_reference_and_oracle(sharded_batch, n, monkeypatch):
    _, port, cursors, ref = sharded_batch
    rows = []

    def rec(*args, **kw):
        rows.append(args[0].shape[0])
        return insert_batch(*args, **kw)

    monkeypatch.setattr(kernel_mod, "insert_batch", rec)
    report = DocBatch(**BATCH, mesh=make_mesh(n, device="cpu")).merge(port, cursors)
    # one insert launch per shard, each over its shard's rows
    assert rows == [-(-12 // n)] * n
    assert report.fallback_docs == ref.fallback_docs == []
    assert report.spans == ref.spans == oracle_merge(port)
    assert report.roots == ref.roots
    assert report.cursor_positions == ref.cursor_positions


def test_state_is_actually_sharded():
    workloads = _port_workloads(generate_workload(seed=5, num_docs=16, ops_per_doc=30))
    mesh = make_mesh(8, device="cpu")
    batch = DocBatch(**BATCH, mesh=mesh)
    states = batch.apply_encoded(batch.encode(workloads))
    # each of the 8 shards holds a (2, ...) block of the 16-doc batch, as
    # the reference's 8 devices each hold a (2, ...) shard
    assert len(states) == 8
    assert all(s.elem_id.shape[0] == 2 for s in states)
    assert all(x.device == d for s, d in zip(states, mesh.devices) for x in s)


def test_convergence_digest_sums_over_shards(sharded_batch):
    """The digest of a sharded batch is the host sum of the shards' partial
    sums (the reference's all-reduce), masked to uint32: equal to the
    reference's sharded digest (the fixture's batch, whose programs the
    reference has compiled), to a replica with another log order, and not
    to another batch."""
    def digest(batch, workloads):
        parts = [convergence_digest(r.char, r.visible) for r in
                 (resolve(s, 16) for s in batch.apply_encoded(batch.encode(workloads)))]
        return sum(int(p) for p in parts) & 0xFFFFFFFF

    workloads, port, _, _ = sharded_batch
    batch = DocBatch(**BATCH, mesh=make_mesh(8, device="cpu"))
    d1 = digest(batch, port)
    ref_batch = JaxDocBatch(**BATCH, mesh=jax_mesh_mod.make_mesh())
    ref_resolved = jax_resolve_jit(ref_batch.apply_encoded(ref_batch.encode(workloads)), 16)
    assert d1 == int(jax_mesh_mod.convergence_digest(ref_resolved.char, ref_resolved.visible))
    reordered = [{a: log for a, log in reversed(list(w.items()))} for w in port]
    assert digest(batch, reordered) == d1
    other = _port_workloads(generate_workload(seed=12, num_docs=12, ops_per_doc=40))
    assert digest(batch, other) != d1


def test_pooled_layouts_refuse_a_mesh_as_the_reference():
    mesh, ref_mesh = make_mesh(2, device="cpu"), jax_mesh(2)
    for layout in ("paged", "ragged"):
        with pytest.raises(ValueError, match="does not support a mesh") as mine:
            DocBatch(layout=layout, mesh=mesh)
        with pytest.raises(ValueError, match="does not support a mesh") as theirs:
            JaxDocBatch(layout=layout, mesh=ref_mesh)
        assert str(mine.value) == str(theirs.value)


# -- the mesh itself --------------------------------------------------------------


def test_pad_doc_axis_equals_reference():
    x = np.arange(15, dtype=np.int32).reshape(5, 3)
    for multiple in (1, 5, 8):
        ours = pad_doc_axis(x, multiple)
        np.testing.assert_array_equal(ours, jax_mesh_mod.pad_doc_axis(x, multiple))
        np.testing.assert_array_equal(pad_doc_axis(torch.from_numpy(x), multiple).numpy(), ours)
    assert pad_doc_axis(x, 8)[5:].sum() == 0
    assert pad_doc_axis(x, 5) is x


def test_doc_sharding_and_shard_docs():
    mesh = make_mesh(4, device="cpu")
    assert doc_sharding(mesh, 8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    state = empty_docs(8, 16, 4, tomb_capacity=4, device="cpu")
    state = state._replace(elem_id=torch.arange(128, dtype=torch.int32).reshape(8, 16))
    shards = shard_docs(state, mesh)
    assert len(shards) == 4 and all(type(s) is type(state) for s in shards)
    for k, s in enumerate(shards):
        assert torch.equal(s.elem_id, state.elem_id[2 * k:2 * k + 2])
    # shards on one device are still separate tensors, never views
    ptrs = {s.elem_id.untyped_storage().data_ptr() for s in shards}
    assert len(ptrs) == 4 and state.elem_id.untyped_storage().data_ptr() not in ptrs
    trees = shard_docs({"a": np.ones((8, 2), np.int32), "b": (np.zeros(8, np.int32),)}, mesh)
    assert [t["a"].shape for t in trees] == [(2, 2)] * 4 and trees[3]["b"][0].shape == (2,)
    stacked = shard_leading((np.arange(8).reshape(4, 2),), mesh)
    assert [t[0].tolist() for t in stacked] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_mesh_identity():
    a, b = make_mesh(4, device="cpu"), make_mesh(devices=["cpu"] * 4)
    assert a == b and hash(a) == hash(b) and a.size == 4
    assert a.axis_names == (DOC_AXIS,) == tuple(jax_mesh(4).axis_names)
    assert mesh_fingerprint(a) == mesh_fingerprint(b) != mesh_fingerprint(make_mesh(2, device="cpu"))
    assert mesh_fingerprint(None) == jax_fingerprint(None)
    assert len(mesh_fingerprint(a)) == len(jax_fingerprint(jax_mesh(4)))
    assert a.devices == (torch.device("cpu"),) * 4 and a.device_type == "cpu"


def _cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("case", [
    "too_few_cards", "no_card", "mixed_devices", "zero_shards", "count_mismatch",
    "other_device_type", "cpu_needs_a_count", "card_index_out_of_range", "pad_multiple",
])
def test_mesh_errors(case, monkeypatch):
    if case == "too_few_cards":
        _cards(monkeypatch, 1)
        with pytest.raises(RuntimeError, match="need 2 CUDA devices .* have 1"):
            make_mesh(2)
        with pytest.raises(RuntimeError, match="need 4 CUDA devices"):
            mesh_devices(4, "cuda")
    elif case == "no_card":
        _cards(monkeypatch, 0)
        with pytest.raises(RuntimeError, match="have 0"):
            make_mesh()
    elif case == "mixed_devices":
        with pytest.raises(ValueError, match="mix device types"):
            Mesh(["cpu", "cuda:0"])
        with pytest.raises(ValueError, match="mix device types"):
            make_mesh(devices=[torch.device("cuda", 0), "cpu"])
    elif case == "zero_shards":
        with pytest.raises(ValueError, match="at least one"):
            make_mesh(0, device="cpu")
        with pytest.raises(ValueError, match="at least one"):
            Mesh([])
    elif case == "count_mismatch":
        with pytest.raises(ValueError, match="devices given"):
            make_mesh(3, devices=["cpu"] * 2)
    elif case == "other_device_type":
        with pytest.raises(ValueError, match="cuda or cpu"):
            make_mesh(2, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            Mesh(["meta"])
    elif case == "cpu_needs_a_count":
        with pytest.raises(ValueError, match="needs num_devices"):
            make_mesh(device="cpu")
    elif case == "card_index_out_of_range":
        _cards(monkeypatch, 1)
        with pytest.raises(RuntimeError, match="no CUDA device cuda:3"):
            make_mesh(2, device="cuda:3")
    else:
        with pytest.raises(ValueError, match="at least 1"):
            pad_doc_axis(np.zeros((3, 2)), 0)


def test_mesh_devices_pick_cards_or_virtual_shards(monkeypatch):
    _cards(monkeypatch, 4)
    assert mesh_devices(4) == [torch.device("cuda", i) for i in range(4)]
    assert mesh_devices(2, "cuda") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh_devices(3, "cuda:1") == [torch.device("cuda", 1)] * 3
    assert mesh_devices(2, "cpu") == [torch.device("cpu")] * 2
    assert make_mesh().size == 4
    assert make_mesh(devices=["cuda"] * 2).devices == (torch.device("cuda", 0),) * 2


def test_a_cuda_mesh_never_falls_back_to_the_cpu(monkeypatch):
    """Without cards, a CUDA mesh raises at the entry point; the CPU is
    taken only when asked for."""
    _cards(monkeypatch, 0)
    mesh = Mesh(["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMerge(num_docs=2, actors=("doc1",), mesh=mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DocBatch(mesh=mesh)
    with pytest.raises(ValueError, match="device type"):
        DocBatch(mesh=make_mesh(2, device="cpu"), device="cuda")
    assert DocBatch(mesh=make_mesh(2, device="cpu")).device == torch.device("cpu")


@pytest.mark.parametrize("entry", ["insert_batch", "ragged_insert", "apply_batch"])
def test_ops_entry_points_refuse_tensors_on_two_devices(entry):
    """One call's tensors must share one device: a shard's launch never
    reads another shard's memory.  (On the CPU, the meta device stands in
    for a second device.)"""
    from peritext_tpu_torch.ops.kernel import apply_batch
    from peritext_tpu_torch.ops.ragged_insert import ragged_insert

    i32 = lambda *shape, device="cpu": torch.zeros(shape, dtype=torch.int32, device=device)  # noqa: E731
    if entry == "insert_batch":
        with pytest.raises(ValueError, match="is on meta"):
            insert_batch(i32(2, 8), i32(2, 8), i32(2), torch.zeros(2, dtype=torch.bool),
                         i32(2, 4), i32(2, 4, device="meta"), i32(2, 4))
    elif entry == "ragged_insert":
        with pytest.raises(ValueError, match="is on meta"):
            ragged_insert(i32(4, 8), i32(4, 8), i32(4), i32(4), i32(4), i32(2), i32(2, 2),
                          i32(2), torch.zeros(2, dtype=torch.bool), i32(2), i32(2, 4),
                          i32(2, 4, device="meta"), i32(2, 4))
    else:
        state = empty_docs(2, 8, 4, tomb_capacity=4, device="cpu")
        streams = (i32(2, 4), i32(2, 4, device="meta"), i32(2, 4), i32(2, 4), {}, i32(2))
        with pytest.raises(ValueError, match="is on meta"):
            apply_batch(state, streams)
