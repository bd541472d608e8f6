"""The port's paged ``StreamingMerge`` (peritext_tpu_torch/store/session.py,
on the CPU) against the reference package's paged session and the port's
own padded session, on the same arrivals, in the patterns of the
reference's tests/test_store.py; and the page store's lifecycle methods
against the reference's on the same call sequences.

Every comparison is exact: ``read_all``, ``read_patches_all``, ``read`` and
``read_root`` of every doc, ``digest(full=True|False)`` bit for bit (the
paged digest programs add the pad term the padded width would hash),
``doc_digest``, ``frontier``, the fallback set and ``health()`` with its
``page_pool`` section.  Sessions that several tests read are built once per
module.
"""

import random

import numpy as np
import pytest
import torch

from peritext_tpu.api.batch import _oracle_doc as jax_oracle_doc
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.store import alloc as jax_alloc
from peritext_tpu.store import paged as jax_paged
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.kernel import PAGED_AUX_FIELDS, apply_batch_paged_groups
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.store import (
    PageAllocator,
    PagedDocStore,
    PagedStreamingMerge,
    PoolExhausted,
)
from peritext_tpu_torch.store.paged import group_stream_arrays, plan_page_groups
from peritext_tpu_torch.testing.arrival import build_arrival
from test_torch_paged import _assert_state_equal, _assert_store_equal, _encoded, _stores

ACTORS = ("doc1", "doc2", "doc3")
CAPS = dict(slot_capacity=256, mark_capacity=64, tomb_capacity=64)
SEEDS = (5, 23, 41)


def _port(changes):
    return [Change.from_json(c.to_json()) for c in changes]


def _port_workload(w):
    return {a: _port(log) for a, log in w.items()}


def object_arrival(workloads, rounds, seed):
    """Per-doc round batches for both packages: the reference's changes and
    the same batches crossed to the port through the wire format."""
    rng = random.Random(seed)
    ref = []
    for w in workloads:
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        size = -(-len(chs) // rounds)
        ref.append([chs[i:i + size] for i in range(0, len(chs), size)])
    return ref, [[_port(b) for b in doc] for doc in ref]


def frame_arrival(workloads, rounds, seed):
    """Per-doc round frames (v2 bytes), fed as they are to both packages."""
    frames, _ = build_arrival([_port_workload(w) for w in workloads], rounds, seed,
                              as_frames=True)
    return frames


def feed(s, arrival, frames):
    """Per arrival round: ingest every doc's batch (one ``ingest_frames``
    call for frames), then drain."""
    for r in range(max(len(b) for b in arrival)):
        if frames:
            s.ingest_frames((d, b[r]) for d, b in enumerate(arrival) if r < len(b))
        else:
            for d, b in enumerate(arrival):
                if r < len(b):
                    s.ingest(d, b[r])
        s.drain()
    return s


def sessions_of(workloads, layout, frames, rounds=3, seed=1, **kw):
    """(reference session, port session, port padded session) of one
    arrival; the reference's in ``layout``, the port's in ``layout``."""
    kwargs = dict(num_docs=len(workloads), actors=ACTORS, **dict(CAPS, **kw))
    if frames:
        arr = frame_arrival(workloads, rounds, seed)
        ref_arr = port_arr = arr
    else:
        ref_arr, port_arr = object_arrival(workloads, rounds, seed)
    j = feed(JaxStreamingMerge(layout=layout, **kwargs), ref_arr, frames)
    t = feed(StreamingMerge(layout=layout, device="cpu", **kwargs), port_arr, frames)
    p = feed(StreamingMerge(device="cpu", **kwargs), port_arr, frames)
    return j, t, p


def assert_same(t, *others, roots=True, patches=True):
    """Every public read of ``t`` equals each other session's (the
    reference's session, or the port's padded one).  Patches are diffed
    against each session's previous read, so they are read once each.
    ``roots=False`` leaves ``read_root`` out (the reference's reads a doc's
    pre-reshard row); ``patches=False`` leaves the patches to the caller."""
    mine = t.read_patches_all() if patches else None
    for j in others:
        assert t.rounds == j.rounds
        assert t.read_all() == j.read_all()
        if patches:
            assert mine == j.read_patches_all()
        for d in range(t.num_docs):
            assert t.read(d) == j.read(d), d
            if roots:
                assert t.read_root(d) == j.read_root(d), d
        assert t.digest() == j.digest()
        assert t.digest(full=False) == j.digest(full=False)
        assert t.digest(refresh=True) == j.digest(refresh=True)
        assert [t.doc_digest(d) for d in range(t.num_docs)] == \
            [j.doc_digest(d) for d in range(j.num_docs)]
        assert t.frontier() == j.frontier()
        assert [s.fallback for s in t.docs] == [s.fallback for s in j.docs]
        assert t.overflow_count() == j.overflow_count()
        assert t.pending_count() == j.pending_count()


@pytest.fixture(scope="module", params=[(seed, mode) for seed in SEEDS
                                        for mode in ("objects", "frames")],
                ids=lambda p: f"seed{p[0]}-{p[1]}")
def paged_sessions(request):
    seed, mode = request.param
    workloads = generate_workload(seed=seed, num_docs=16, ops_per_doc=48)
    return sessions_of(workloads, "paged", mode == "frames")


def test_paged_session_equals_reference_and_padded(paged_sessions):
    j, t, p = paged_sessions
    assert isinstance(t, PagedStreamingMerge) and t.layout == "paged"
    assert_same(t, j, p)


def test_paged_session_health_and_store_equal_reference(paged_sessions):
    j, t, p = paged_sessions
    assert t.health() == j.health()
    assert t.health()["page_pool"]["frag_by_decile"]
    assert t.config == j.config
    for f in ("docs", "device_ops", "padding_efficiency", "extras"):
        assert getattr(t.last_round_stats, f) == getattr(j.last_round_stats, f), f
    # the layouts hold the same docs; only the paged one pays per group
    th, ph = t.health(), p.health()
    assert {k: th[k] for k in ph if "padding" not in k} == \
        {k: ph[k] for k in ph if "padding" not in k}
    assert th["padding_efficiency_cum"] > ph["padding_efficiency_cum"]
    _assert_store_equal(j.store, t.store)


def test_paged_factory_and_validation():
    s = StreamingMerge(num_docs=2, actors=ACTORS, layout="paged", device="cpu")
    assert type(s) is PagedStreamingMerge and s.layout == "paged"
    assert s.config["page_size"] == 64 and s.config["layout"] == "paged"
    assert s.state is None
    assert StreamingMerge(num_docs=2, actors=ACTORS, device="cpu").layout == "padded"
    with pytest.raises(ValueError, match="static_rounds"):
        StreamingMerge(num_docs=2, actors=ACTORS, layout="paged", static_rounds=True,
                       device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        StreamingMerge(num_docs=2, actors=ACTORS, layout="paged", slot_capacity=100,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        StreamingMerge(num_docs=2, actors=ACTORS, layout="paged", mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        PagedStreamingMerge(num_docs=2, actors=ACTORS, layout="ragged", device="cpu")


def test_pooled_entry_points_resolve_the_device(monkeypatch):
    """Without a card, asking for ``cuda`` (or defaulting to it) raises at
    the page store and at both page-pool sessions; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedDocStore(2, 256, 8, device="cuda")
    for layout in ("paged", "ragged"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingMerge(num_docs=2, actors=ACTORS, layout=layout)


def test_paged_block_chunked_reads_match():
    """read_chunk below the batch: blocks materialize from the pool at
    page-bucketed widths; reads and digests stay bit-equal."""
    workloads = generate_workload(seed=9, num_docs=10, ops_per_doc=50)
    j, t, p = sessions_of(workloads, "paged", True, rounds=2, read_chunk=4)
    assert t._n_blocks() == 3
    assert_same(t, j, p)


def test_paged_group_applies_counted_per_round_group(monkeypatch):
    """One apply_batch_paged per (round, page group): the counter and the
    recorded calls agree, with each group's rows at their own width."""
    from peritext_tpu_torch.ops import kernel

    calls = []
    original = kernel.apply_batch_paged

    def recording(pool_elem, pool_char, aux, row_idx, page_rows, arrays):
        calls.append(tuple(page_rows.shape))
        return original(pool_elem, pool_char, aux, row_idx, page_rows, arrays)

    monkeypatch.setattr(kernel, "apply_batch_paged", recording)
    workloads = generate_workload(seed=3, num_docs=6, ops_per_doc=20)
    workloads += generate_workload(seed=301, num_docs=2, ops_per_doc=240)
    before = GLOBAL_COUNTERS.get("streaming.group_applies")
    _, t, p = sessions_of(workloads, "paged", False, rounds=2)
    assert GLOBAL_COUNTERS.get("streaming.group_applies") - before == len(calls)
    assert len({g for _, g in calls}) > 1  # the long docs ride a wider group
    assert t.read_all() == p.read_all() and t.digest() == p.digest()


def test_paged_overflow_routes_to_replay_like_padded():
    workloads = generate_workload(seed=17, num_docs=3, ops_per_doc=80)
    j, t, p = sessions_of(workloads, "paged", True, rounds=1, slot_capacity=64,
                          mark_capacity=16, tomb_capacity=16)
    assert t.overflow_count() == j.overflow_count() == p.overflow_count() > 0
    assert_same(t, j, p)


def test_paged_pool_exhaustion_is_typed():
    workloads = generate_workload(seed=19, num_docs=4, ops_per_doc=60)
    frames = frame_arrival(workloads, 1, 1)
    s = StreamingMerge(num_docs=4, actors=ACTORS, slot_capacity=256, mark_capacity=64,
                       layout="paged", pool_pages=2, max_pool_pages=3, device="cpu")
    assert s.store.max_pool_pages == 3
    s.ingest_frames((d, frames[d][0]) for d in range(4))
    with pytest.raises(PoolExhausted) as exc:
        s.drain()
    assert exc.value.total <= 3


def test_paged_reshard_pages_and_digest_invariance():
    workloads = generate_workload(seed=21, num_docs=9, ops_per_doc=40)
    j, t, p = sessions_of(workloads, "paged", True, rounds=1, read_chunk=3)
    before, spans = t.digest(), t.read_all()
    assert before == j.digest() == p.digest()
    out, ref = t.reshard(), j.reshard()
    assert out == ref
    assert out["moved"] > 0 and sum(out["page_load"]) == int(t.store.page_loads().sum())
    assert p.reshard()["moved"] > 0  # the padded twin balances slots instead
    _assert_store_equal(j.store, t.store)
    assert t.digest() == before == t.digest(refresh=True)
    assert t.read_all() == spans
    # the reference's read_root decodes the doc's pre-reshard row after a
    # reshard; the port's follows the doc, as the scalar oracle shows
    assert t.read_patches_all() == j.read_patches_all() == p.read_patches_all()
    assert_same(t, j, roots=False, patches=False)
    assert_same(t, p, patches=False)
    assert [t.read_root(d) for d in range(9)] == [jax_oracle_doc(w).root for w in workloads]
    # ingest goes on after the permutation (duplicate frames are idempotent)
    frames = frame_arrival(workloads, 1, 1)
    for s in (t, j):
        s.ingest_frames([(0, frames[0][0])])
        s.drain()
    assert t.digest() == before == j.digest()


def test_paged_digest_async_and_fallback_parity():
    workloads = generate_workload(seed=13, num_docs=6, ops_per_doc=50)
    frames = frame_arrival(workloads, 2, 1)
    j, t, p = sessions_of(workloads, "paged", True, rounds=2)
    assert t.digest_async().wait() == j.digest_async().wait() == p.digest_async().wait()
    # corrupt-frame quarantine and a forced demotion behave alike
    bad = frames[2][0][:12] + b"\xffgarbage"
    for s in (j, t, p):
        s.ingest_frame(2, bad, on_corrupt="quarantine")
        s.force_fallback(4)
    assert sorted(t.quarantined()) == sorted(j.quarantined()) == [2, 4]
    pending = t.digest_async()
    assert pending.wait() == t.digest() == j.digest() == p.digest()
    assert pending.wait() == pending.wait()  # the value is kept
    assert t.read(4) == j.read(4)
    assert t.health() == j.health()


# -- allocator and store lifecycle ---------------------------------------------


def test_allocator_lifecycle_equals_reference():
    """free_doc, evacuate, compact_plan/apply_compact and reseat on one call
    sequence: every page table and the free list match."""
    ours, theirs = PageAllocator(12), jax_alloc.PageAllocator(12)

    def same():
        assert ours.docs() == theirs.docs()
        for d in range(8):
            assert ours.pages_of(d) == theirs.pages_of(d), d
        assert sorted(ours._free) == sorted(theirs._free)

    for a in (ours, theirs):
        a.ensure(3, 2)
        a.ensure(1, 2)
    assert ours.free_doc(3) == theirs.free_doc(3)
    for a in (ours, theirs):
        a.ensure(5, 1)
        a.ensure(0, 2)
    same()
    assert ours.evacuate(0) == theirs.evacuate(0)
    plan = ours.compact_plan()
    assert plan == theirs.compact_plan()
    ours.apply_compact(plan)
    theirs.apply_compact(plan)
    same()
    assert ours.pages_of(1) == [1, 2] and ours.pages_of(5) == [3]
    table = {6: ours.pages_of(1), 2: ours.pages_of(5)}
    ours.reseat(table)
    theirs.reseat(table)
    same()
    with pytest.raises(ValueError, match="disjoint"):
        ours.reseat({0: [1], 1: [1]})


def test_store_lifecycle_equals_reference():
    """evacuate_row, compact, permute_rows, group_plan, page_loads,
    width_for_rows and aux_capacities on one call sequence: pool planes, aux
    rows, page tables, alloc_epoch and pool_stats match, and every live row
    keeps its content."""
    js, ps = _stores(6, 256, 16, page_size=64, initial_pages=16)
    rows = [0, 1, 2, 4]
    used = [100, 30, 64, 200]
    js.ensure_rows(rows, used)
    ps.ensure_rows(rows, used)
    # mark each doc's pages so moves are visible
    for r in rows:
        for k, pg in enumerate(js.alloc.pages_of(r)):
            js.pool_elem = js.pool_elem.at[pg, 0].set(100 * (r + 1) + k)
            ps.pool_elem[pg, 0] = 100 * (r + 1) + k
    _assert_store_equal(js, ps)
    assert ps.aux_capacities == js.aux_capacities
    assert ps.width_for_rows(rows) == js.width_for_rows(rows) == 4
    for g_rows, g in ((rows, 4), ([1], 1), ([], 1)):
        for mine, ref in zip(ps.group_plan(g_rows, g, pad_rows_to=8),
                             js.group_plan(g_rows, g, pad_rows_to=8)):
            np.testing.assert_array_equal(mine, ref)
    before = ps.materialize_rows([1, 4]).elem_id.clone()
    assert ps.evacuate_row(0) == js.evacuate_row(0) == 2
    _assert_store_equal(js, ps)
    assert ps.compact() == js.compact() > 0
    _assert_store_equal(js, ps)
    torch.testing.assert_close(ps.materialize_rows([1, 4]).elem_id, before, rtol=0, atol=0)
    free_page = ps.alloc._free[0]
    assert int(ps.pool_elem[free_page].abs().sum()) == 0 == int(ps.pool_elem[0].abs().sum())
    src = np.asarray([4, 2, 1, 5, 0, 3])
    ps.permute_rows(src)
    js.permute_rows(src)
    _assert_store_equal(js, ps)
    np.testing.assert_array_equal(ps.page_loads(), js.page_loads())
    torch.testing.assert_close(ps.materialize_rows([2, 0]).elem_id, before, rtol=0, atol=0)
    _assert_state_equal(js.materialize_rows([0, 1, 2, 3], pad_rows_to=8),
                        ps.materialize_rows([0, 1, 2, 3], pad_rows_to=8))


def test_apply_batch_paged_groups_equals_one_group_at_a_time():
    """The group chain writes the pool in place, group after group, as the
    reference's chained program does: equal to the reference store after
    the same per-group applies."""
    from peritext_tpu.ops.kernel import apply_batch_paged_groups as jax_groups

    workloads = generate_workload(seed=4, num_docs=6, ops_per_doc=40)
    workloads += generate_workload(seed=44, num_docs=2, ops_per_doc=300)
    enc = _encoded(workloads)
    js, ps = _stores(len(workloads), 512, 64, page_size=64,
                     tomb_capacity=enc.del_target.shape[1])
    rows = np.arange(len(workloads))
    counts = np.count_nonzero(enc.ins_op, axis=1)
    js.ensure_rows(rows, counts)
    ps.ensure_rows(rows, counts)
    groups = plan_page_groups(rows, ps.num_pages, ps.max_doc_pages)
    assert len(groups) > 1
    ours, theirs = [], []
    for g, g_rows in groups:
        b = 1 << (len(g_rows) - 1).bit_length()
        row_idx, table = ps.group_plan(g_rows, g, pad_rows_to=b)
        ours.append((torch.from_numpy(row_idx), torch.from_numpy(table),
                     group_stream_arrays(enc, g_rows, b, "cpu")))
        j_idx, j_table = js.group_plan(g_rows, g, pad_rows_to=b)
        theirs.append((j_idx, j_table, jax_paged.group_stream_arrays(enc, g_rows, b)))
    apply_batch_paged_groups(ps.pool_elem, ps.pool_char, ps.aux, ours)
    js.pool_elem, js.pool_char, js.aux = jax_groups(
        js.pool_elem, js.pool_char, js.aux, tuple(theirs), loop_slots_seq=(None,) * len(theirs))
    _assert_store_equal(js, ps)
    for f, a in zip(PAGED_AUX_FIELDS, ps.aux):
        np.testing.assert_array_equal(a.numpy(), np.asarray(js.aux_field(f)), err_msg=f)
    assert int(ps.pool_elem[0].abs().sum()) == 0


def test_pool_growth_keys_alloc_epoch_and_max_pool_pages():
    js, ps = _stores(2, 512, 8, page_size=64, initial_pages=4, max_pool_pages=8)
    assert ps.max_pool_pages == js.max_pool_pages == 8
    epochs = [ps.alloc_epoch]
    for s in (js, ps):
        s.ensure_rows([0], [300])  # 5 pages: one doubling
    epochs.append(ps.alloc_epoch)
    assert ps.growths == js.growths == 1 and ps.pool_elem.shape[0] == 8
    _assert_store_equal(js, ps)
    for s in (js, ps):
        s.ensure_rows([0], [300])  # nothing new: the epoch stays
    assert ps.alloc_epoch == epochs[-1]
    with pytest.raises(PoolExhausted):
        ps.ensure_rows([1], [512])
    with pytest.raises(jax_alloc.PoolExhausted):
        js.ensure_rows([1], [512])
    assert ps.pool_stats() == js.pool_stats()
    assert ps.pool_stats()["frag_by_decile"] == js.pool_stats()["frag_by_decile"]
    assert PagedDocStore(2, 256, 8, device="cpu").aux_capacities["tomb_capacity"] == 256
