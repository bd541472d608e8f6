"""The port's sharded page pool (``peritext_tpu_torch/store/sharded.py``,
``parallel/mesh_fused.py``'s page mover) and the paged layout over a mesh,
on the CPU, against the reference package's on the virtual CPU devices
conftest.py forces.

The allocator facade and the store take the same call sequences as the
reference's (allocation with uniform growth, the cross-shard row
permutation, compaction, evacuation) and must hold the same page tables,
pool statistics, per-shard statistics and pages; the page mover must move
the same pages as the reference's ``page_mover_fn``; and the paged
``StreamingMerge`` over 1, 2, 4 and 8 shards must equal the reference's
mesh session and the port's meshless twin (tests/test_torch_mesh_paths.py's
check), its reshard preserving every byte and counting the pages moved
(the reference's tests/test_mesh_fused.py).
"""

import numpy as np
import pytest
import torch

from peritext_tpu.obs import GLOBAL_COUNTERS as JAX_COUNTERS
from peritext_tpu.parallel.mesh_fused import mesh_fn, page_mover_fn, shard_leading as jax_leading
from peritext_tpu.store import alloc as jax_alloc
from peritext_tpu.store import sharded as jax_sharded
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.kernel import PAGED_AUX_FIELDS
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.mesh_fused import move_pages, permute_shard_rows
from peritext_tpu_torch.store import PoolExhausted
from peritext_tpu_torch.store.sharded import ShardedAllocator, ShardedPagedDocStore
from test_torch_mesh_paths import SHARDS, check_layout_on_mesh, jax_mesh

STORE = dict(slot_capacity=256, mark_capacity=16, tomb_capacity=16, page_size=64)


@pytest.mark.parametrize("n", SHARDS)
def test_paged_mesh_equals_reference_and_twin(n, monkeypatch):
    t = check_layout_on_mesh("paged", n, monkeypatch)
    assert isinstance(t.store, ShardedPagedDocStore) and t.store.n_shards == n


# -- the allocator facade ----------------------------------------------------------


def test_sharded_allocator_equals_reference():
    ours, theirs = ShardedAllocator(4, 8, 4), jax_sharded.ShardedAllocator(4, 8, 4)
    for doc, pages in [(0, 2), (5, 3), (15, 1), (1, 4), (5, 4), (9, 7)]:
        assert ours.ensure(doc, pages) == theirs.ensure(doc, pages)
    for doc in range(16):
        assert ours.pages_of(doc) == theirs.pages_of(doc)
        assert ours.num_pages(doc) == theirs.num_pages(doc)
    assert ours.docs() == theirs.docs()
    assert (ours.total_pages, ours.reserved, ours.free_pages, ours.pages_in_use) == \
        (theirs.total_pages, theirs.reserved, theirs.free_pages, theirs.pages_in_use)
    assert ours.free_doc(1) == theirs.free_doc(1)
    plan = ours.compact_plan()
    assert plan == theirs.compact_plan()
    ours.apply_compact(plan)
    theirs.apply_compact(plan)
    ours.reseat({4: ours.pages_of(5), 12: ours.pages_of(15)})
    theirs.reseat({4: theirs.pages_of(5), 12: theirs.pages_of(15)})
    assert [ours.pages_of(d) for d in range(16)] == [theirs.pages_of(d) for d in range(16)]
    with pytest.raises(PoolExhausted) as mine:
        ours.ensure(2, 99)
    with pytest.raises(jax_alloc.PoolExhausted) as ref:
        theirs.ensure(2, 99)
    assert str(mine.value) == str(ref.value)
    with pytest.raises(NotImplementedError):
        ours.grow(64)
    with pytest.raises(ValueError, match="outside shard"):
        ours.reseat({0: [9]})
    with pytest.raises(ValueError, match="cross shards"):
        ours.apply_compact({1: 9})


# -- the store -----------------------------------------------------------------------


def _stores(n, docs=16, **kw):
    ours = ShardedPagedDocStore(docs, make_mesh(n, device="cpu"), **dict(STORE, **kw))
    theirs = jax_sharded.ShardedPagedDocStore(docs, jax_mesh(n), **dict(STORE, **kw))
    return ours, theirs


def _pool(store):
    """The whole pool as (n * Ps, P) numpy planes, shard after shard."""
    return (torch.cat(store.pools_elem).numpy(), torch.cat(store.pools_char).numpy())


def _assert_stores_equal(ours, theirs, free_pages_too=True):
    assert ours.alloc.total_pages == theirs.alloc.total_pages
    assert ours.pages_per_shard == theirs.pages_per_shard
    for row in range(ours.num_docs):
        assert ours.alloc.pages_of(row) == theirs.alloc.pages_of(row), row
    np.testing.assert_array_equal(ours._num_pages, theirs._num_pages)
    assert ours.growths == theirs.growths and ours.alloc_epoch == theirs.alloc_epoch
    assert ours.pool_stats() == theirs.pool_stats()
    assert ours.shard_stats() == theirs.shard_stats()
    elem, char = _pool(ours)
    ref_elem, ref_char = np.asarray(theirs.pool_elem), np.asarray(theirs.pool_char)
    held = [p for d in ours.alloc.docs() for p in ours.alloc.pages_of(d)]
    if free_pages_too:
        held = list(range(elem.shape[0]))
    np.testing.assert_array_equal(elem[held], ref_elem[held])
    np.testing.assert_array_equal(char[held], ref_char[held])
    for f in PAGED_AUX_FIELDS:
        np.testing.assert_array_equal(ours.aux_field(f).numpy(),
                                      np.asarray(theirs.aux_field(f)), err_msg=f)


def _fill(ours, theirs, seed):
    """Random contents in every held page and aux row of both stores."""
    rng = np.random.default_rng(seed)
    elem, char = (a.copy() for a in _pool(ours))
    for d in ours.alloc.docs():
        for p in ours.alloc.pages_of(d):
            elem[p] = rng.integers(1, 1 << 20, elem.shape[1])
            char[p] = rng.integers(1, 1 << 16, char.shape[1])
    ps = ours.pages_per_shard
    for s in range(ours.n_shards):
        ours.pools_elem[s] = torch.from_numpy(elem[s * ps:(s + 1) * ps].copy())
        ours.pools_char[s] = torch.from_numpy(char[s * ps:(s + 1) * ps].copy())
    theirs.pool_elem = theirs._put_pages(elem)
    theirs.pool_char = theirs._put_pages(char)
    slots = rng.integers(0, 200, ours.num_docs).astype(np.int32)
    r = ours.rows_per_shard
    i = PAGED_AUX_FIELDS.index("num_slots")
    for s in range(ours.n_shards):
        ours.shard_aux[s][i][:] = torch.from_numpy(slots[s * r:(s + 1) * r])
    aux = list(theirs.aux)
    aux[i] = jax_leading(slots.reshape(ours.n_shards, r), theirs.mesh).reshape(-1)
    theirs.aux = tuple(aux)


@pytest.mark.parametrize("n", (2, 4))
def test_store_lifecycle_equals_reference(n):
    ours, theirs = _stores(n)
    _assert_stores_equal(ours, theirs)
    rows = np.array([0, 3, 5, 9, 12, 15])
    used = np.array([100, 250, 64, 1, 256, 130])
    for store in (ours, theirs):
        store.ensure_rows(rows, used)
        store.ensure_rows(rows[:2], used[:2] + 5)
    _assert_stores_equal(ours, theirs)
    # a dry shard grows every shard to the same size
    for store in (ours, theirs):
        store.ensure_rows(np.arange(4), np.full(4, 256))
    assert ours.growths == theirs.growths >= 1
    _assert_stores_equal(ours, theirs)
    _fill(ours, theirs, 1)
    _assert_stores_equal(ours, theirs)
    # the row permutation: rows move within and across shards, their pages
    # over the mover; destinations allocated first, vacated pages zeroed
    src = np.random.default_rng(n).permutation(16)
    moves = GLOBAL_COUNTERS.get("store.ici_page_moves")
    ref_moves = JAX_COUNTERS.get("store.ici_page_moves")
    ours.permute_rows(src)
    theirs.permute_rows(src)
    _assert_stores_equal(ours, theirs)
    assert ours.ici_page_moves == theirs.ici_page_moves > 0
    assert GLOBAL_COUNTERS.get("store.ici_page_moves") - moves == \
        JAX_COUNTERS.get("store.ici_page_moves") - ref_moves == ours.ici_page_moves
    for store in (ours, theirs):
        assert store.evacuate_row(int(src[0])) >= 0
    # the reference's compaction keeps a freed page's old content (its
    # gather defaults to identity); the port's per-shard gather defaults to
    # the shard's null page, so freed pages come back zero: held pages equal
    assert ours.compact() == theirs.compact()
    _assert_stores_equal(ours, theirs, free_pages_too=False)
    elem, _ = _pool(ours)
    held = {p for d in ours.alloc.docs() for p in ours.alloc.pages_of(d)}
    assert not elem[[p for p in range(elem.shape[0]) if p not in held]].any()
    # each shard's null page stayed zero; every shard tensor is on its device
    ps = ours.pages_per_shard
    assert not elem[::ps].any()
    assert all(t.device == torch.device("cpu") for t in ours.pools_elem)


def test_store_reads_one_shard_at_a_time():
    ours, theirs = _stores(4)
    for store in (ours, theirs):
        store.ensure_rows(np.arange(16), np.full(16, 70))
    _fill(ours, theirs, 2)
    rows = np.array([4, 6, 7])
    state = ours.materialize_rows(rows, pad_rows_to=4)
    ref = theirs.materialize_rows(rows, pad_rows_to=4)
    np.testing.assert_array_equal(state.elem_id.numpy()[:3], np.asarray(ref.elem_id)[:3])
    np.testing.assert_array_equal(state.num_slots.numpy()[:3], np.asarray(ref.num_slots)[:3])
    row_idx, table = ours.group_plan(rows, 2, pad_rows_to=4)
    assert row_idx.tolist() == [0, 2, 3, 4]  # local rows, padding = rows per shard
    assert (table[3] == 0).all() and (table[:3] < ours.pages_per_shard).all()
    with pytest.raises(ValueError, match="span shards"):
        ours.materialize_rows([3, 4])
    with pytest.raises(PoolExhausted):
        ShardedPagedDocStore(8, make_mesh(2, device="cpu"), max_pool_pages=8,
                             **STORE).ensure_rows(np.arange(4), np.full(4, 256))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        ShardedPagedDocStore(6, make_mesh(4, device="cpu"), **STORE)


# -- the page mover and the row permutation ------------------------------------


@pytest.mark.parametrize("n", (2, 4, 8))
def test_move_pages_equals_page_mover_fn(n):
    """Random disjoint sends and destinations per ordered shard pair, pads
    as the reference lays them out: every pool equals the reference
    program's."""
    rng = np.random.default_rng(n)
    p, m = 4, 3
    ps = 2 * m * (n - 1) + 4  # room for every send and every destination
    pools = rng.integers(1, 1000, (n * ps, p)).astype(np.int32)
    pools[::ps] = 0  # each shard's null page
    send = np.zeros((n, n - 1, m), np.int32)
    recv = np.full((n, n - 1, m), ps, np.int32)
    leaving = [set() for _ in range(n)]
    pages = [list(rng.permutation(np.arange(1, ps))) for _ in range(n)]
    for s in range(n):
        for d in range(1, n):
            k = int(rng.integers(0, m + 1))
            out = [pages[s].pop() for _ in range(k)]
            send[s, d - 1, :k] = out
            leaving[s].update(out)
    for s in range(n):
        for d in range(1, n):
            src = (s - d) % n
            k = int((send[src, d - 1] > 0).sum())
            recv[s, d - 1, :k] = [pages[s].pop() for _ in range(k)]
    zero = np.full((n, max(max(len(v) for v in leaving), 1)), ps, np.int32)
    for s in range(n):
        zero[s, :len(leaving[s])] = sorted(leaving[s])
    mesh = jax_mesh(n)
    fn = mesh_fn(mesh, ("page_mover", m, zero.shape[1]),
                 lambda: page_mover_fn(mesh, m, zero.shape[1]))
    ref_e, ref_c = fn(jax_leading(pools.reshape(n, ps, p), mesh).reshape(n * ps, p),
                      jax_leading((pools * 2).reshape(n, ps, p), mesh).reshape(n * ps, p),
                      *jax_leading((send, recv, zero), mesh))
    pe = [torch.from_numpy(pools[s * ps:(s + 1) * ps].copy()) for s in range(n)]
    pc = [torch.from_numpy(pools[s * ps:(s + 1) * ps].copy() * 2) for s in range(n)]
    move_pages(pe, pc, send, recv, zero)
    np.testing.assert_array_equal(torch.cat(pe).numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(torch.cat(pc).numpy(), np.asarray(ref_c))


def test_permute_shard_rows_equals_a_gather():
    mesh = make_mesh(4, device="cpu")
    rows = torch.arange(16 * 3, dtype=torch.int32).reshape(16, 3)
    shards = [(rows[s * 4:(s + 1) * 4].clone(), rows[s * 4:(s + 1) * 4, 0].clone())
              for s in range(4)]
    src = np.random.default_rng(3).permutation(16)
    out = permute_shard_rows(shards, src, mesh)
    assert torch.equal(torch.cat([o[0] for o in out]), rows[torch.from_numpy(src)])
    assert torch.equal(torch.cat([o[1] for o in out]), rows[torch.from_numpy(src), 0])
