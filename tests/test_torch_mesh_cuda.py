"""The device mesh on the card against the plain path on the CPU: a
4-shard virtual mesh on ``cuda:0`` in each layout (padded, paged, ragged),
and a ``DocBatch`` over it, give the reads and digests of the same session
on the CPU; every shard's tensors lie on its shard's device; each commit
counter equals the kernel launches it counts (K1 once per touched shard of
a padded round and once per (round, shard, page group) of a paged one, K3
once per (round, touched shard, non-empty doc class) of a ragged one);
and a reshard moves rows and pages between shards without changing a read.
Where the machine has at least two cards, the same runs on a real 2-card
mesh (``cuda:0``, ``cuda:1``), whose shards must land on their own cards.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py -q
"""

import pytest
import torch

from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.arrival import build_arrival
from peritext_tpu_torch.testing.fuzz import generate_workload, sample_cursors

pytestmark = pytest.mark.cuda

ACTORS = ("doc1", "doc2", "doc3")
COUNTER = {"padded": "streaming.block_applies", "paged": "streaming.group_applies",
           "ragged": "streaming.ragged_applies"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards for a real 2-card mesh")
    return make_mesh(2)


def _session(workloads, layout, **kw):
    s = StreamingMerge(num_docs=len(workloads), actors=ACTORS, slot_capacity=192,
                       mark_capacity=64, tomb_capacity=192, round_insert_capacity=32,
                       round_delete_capacity=16, round_mark_capacity=16,
                       round_map_capacity=8, layout=layout, **kw)
    arrival = build_arrival(workloads, 3, 0)
    for r in range(3):
        for d, batches in enumerate(arrival):
            if r < len(batches):
                s.ingest(d, batches[r])
        s.drain()
    return s


def _reads(s):
    return (s.digest(), s.digest(full=False), s.read_all(), s.read_patches_all(),
            [s.read_root(d) for d in range(s.num_docs)])


def _shard_tensors(s):
    if s.layout == "padded":
        return [list(st) for st in s._shard_state]
    store = s.store
    return [[store.pools_elem[k], store.pools_char[k], *store.shard_aux[k]]
            for k in range(store.n_shards)]


def _check_mesh_session(mesh, layout):
    workloads = generate_workload(seed=3, num_docs=30, ops_per_doc=48)
    plain = _session(workloads, layout, device="cpu")
    want = _reads(plain)
    counters = {c: GLOBAL_COUNTERS.get(c) for c in COUNTER.values()}
    insert_batch.launches = ragged_insert.launches = 0
    s = _session(workloads, layout, mesh=mesh)
    torch.cuda.synchronize()
    launches = {"padded": insert_batch.launches, "paged": insert_batch.launches,
                "ragged": ragged_insert.launches}[layout]
    other = ragged_insert.launches if layout != "ragged" else insert_batch.launches
    applied = int(GLOBAL_COUNTERS.get(COUNTER[layout]) - counters[COUNTER[layout]])
    assert launches == applied > 0 and other == 0
    for k, tensors in enumerate(_shard_tensors(s)):
        assert all(x.device == mesh.devices[k] for x in tensors), k
    assert _reads(s) == want
    assert s.digest(refresh=True) == want[0]
    assert s.digest_async().wait() == want[0]
    out = s.reshard()
    assert out["moved"] > 0
    assert (s.digest(), s.read_all()) == (want[0], want[2])
    for k, tensors in enumerate(_shard_tensors(s)):
        assert all(x.device == mesh.devices[k] for x in tensors), k
    if layout != "padded":
        assert s._mesh_stats()["ici_page_moves"] > 0


@pytest.mark.parametrize("layout", list(COUNTER))
def test_virtual_mesh_on_one_card_equals_the_cpu(cuda, layout):
    _check_mesh_session(make_mesh(devices=[cuda] * 4), layout)


def test_docbatch_on_a_virtual_mesh(cuda):
    workloads = generate_workload(seed=5, num_docs=30, ops_per_doc=40)
    cursors = sample_cursors(workloads, 3, 5)
    kw = dict(slot_capacity=256, mark_capacity=64, comment_capacity=16)
    want = DocBatch(device="cpu", **kw).merge(workloads, cursors)
    insert_batch.launches = 0
    mesh = make_mesh(devices=[cuda] * 4)
    got = DocBatch(mesh=mesh, **kw).merge(workloads, cursors)
    assert insert_batch.launches == 4
    assert (got.spans, got.roots, got.cursor_positions, got.fallback_docs) == \
        (want.spans, want.roots, want.cursor_positions, want.fallback_docs)
    states = DocBatch(mesh=mesh, **kw).apply_encoded(DocBatch(device="cpu", **kw).encode(workloads))
    assert all(x.device == cuda for st in states for x in st)


@pytest.mark.parametrize("layout", list(COUNTER))
def test_real_two_card_mesh_equals_the_cpu(two_cards, layout):
    _check_mesh_session(two_cards, layout)


def test_a_mesh_asks_for_cards_that_exist(cuda):
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"need {have + 1} CUDA devices"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="mix device types"):
        make_mesh(devices=[cuda, "cpu"])
