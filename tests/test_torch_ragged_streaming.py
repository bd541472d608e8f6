"""The port's ragged ``StreamingMerge`` (peritext_tpu_torch/store/session.py,
on the CPU) against the reference package's ragged session (its lax pool
walk) and the port's padded session, in the patterns of the reference's
tests/test_ragged.py; the plan cache; and the ``streaming.ragged_applies``
counter against each round's launch plan.

Comparisons are exact, as in test_torch_paged_streaming.py.
"""

import numpy as np
import pytest

from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.core.doc import Doc
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.ops.insert import SMEM_BUDGET
from peritext_tpu_torch.ops.ragged_insert import ragged_teams
from peritext_tpu_torch.parallel.mesh import make_mesh
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.store import PagedDocStore, PlanCache, RaggedStreamingMerge, ragged_plan
from peritext_tpu_torch.testing.arrival import build_arrival
from test_torch_paged import _assert_store_equal
from test_torch_paged_streaming import ACTORS, _port_workload, assert_same, sessions_of


def typed_doc(chars, per_change):
    """A doc one actor types ``chars`` characters into, ``per_change`` a
    change: a long doc without the fuzz generator's cost."""
    doc = Doc("doc1")
    changes = [doc.change([{"path": [], "action": "makeList", "key": "text"}])[0]]
    for i in range(0, chars, per_change):
        values = [chr(ord("a") + (i + k) % 26) for k in range(min(per_change, chars - i))]
        changes.append(doc.change([{"path": ["text"], "action": "insert", "index": i,
                                    "values": values}])[0])
    return {"doc1": changes}


@pytest.fixture(scope="module", params=["objects", "frames"])
def ragged_sessions(request):
    workloads = generate_workload(seed=5, num_docs=16, ops_per_doc=48)
    return sessions_of(workloads, "ragged", request.param == "frames")


def test_ragged_session_equals_reference_and_padded(ragged_sessions):
    j, t, p = ragged_sessions
    assert isinstance(t, RaggedStreamingMerge) and t.layout == "ragged"
    assert_same(t, j, p)


def test_ragged_session_health_and_store_equal_reference(ragged_sessions):
    j, t, p = ragged_sessions
    h = t.health()
    assert h == j.health()
    assert h["layout"] == "ragged" and h["padding_efficiency_cum"] == 1.0
    assert h["round_padding_efficiency"] == 1.0
    assert t.last_round_stats.extras == j.last_round_stats.extras
    _assert_store_equal(j.store, t.store)


def test_ragged_factory_and_validation():
    s = StreamingMerge(num_docs=2, actors=ACTORS, slot_capacity=256, mark_capacity=16,
                       tomb_capacity=16, layout="ragged", device="cpu")
    assert type(s) is RaggedStreamingMerge and s.layout == "ragged"
    assert s.health()["layout"] == "ragged" and s.config["layout"] == "ragged"
    with pytest.raises(ValueError, match="multiple"):
        StreamingMerge(num_docs=2, actors=ACTORS, slot_capacity=100, mark_capacity=16,
                       tomb_capacity=16, layout="ragged", device="cpu")
    with pytest.raises(ValueError, match="static_rounds"):
        StreamingMerge(num_docs=2, actors=ACTORS, layout="ragged", static_rounds=True,
                       device="cpu")
    with pytest.raises(ValueError):
        RaggedStreamingMerge(num_docs=2, actors=ACTORS, layout="paged", device="cpu")
    meshed = StreamingMerge(num_docs=2, actors=ACTORS, layout="ragged",
                            mesh=make_mesh(2, device="cpu"))
    assert type(meshed) is RaggedStreamingMerge and meshed.store.n_shards == 2
    with pytest.raises(TypeError, match="Mesh"):
        StreamingMerge(num_docs=2, actors=ACTORS, layout="ragged", mesh=object(), device="cpu")


def test_ragged_mixed_sizes_match():
    """Short docs and two long ones over uneven rounds: the mix the page
    buckets split into groups is one apply here."""
    workloads = generate_workload(seed=9, num_docs=6, ops_per_doc=12)
    workloads += generate_workload(seed=11, num_docs=2, ops_per_doc=96)
    j, t, p = sessions_of(workloads, "ragged", True, rounds=4, seed=2)
    assert_same(t, j, p)


def test_ragged_overflow_parity():
    workloads = generate_workload(seed=17, num_docs=3, ops_per_doc=80)
    j, t, p = sessions_of(workloads, "ragged", True, rounds=1, slot_capacity=64,
                          mark_capacity=16, tomb_capacity=16)
    assert t.overflow_count() == j.overflow_count() == p.overflow_count() > 0
    assert_same(t, j, p)


def test_ragged_round_widths_stay_at_the_caps(monkeypatch):
    """Every committed round of the ragged session streams at the session
    caps, as the reference's does (the padded session shrinks them)."""
    from peritext_tpu_torch.store import session as session_mod

    seen = []
    original = session_mod.RaggedStreamingMerge._commit_round_ragged

    def recording(self, enc, widths):
        seen.append(tuple(widths))
        return original(self, enc, widths)

    monkeypatch.setattr(session_mod.RaggedStreamingMerge, "_commit_round_ragged", recording)
    workloads = generate_workload(seed=3, num_docs=4, ops_per_doc=20)
    _, t, p = sessions_of(workloads, "ragged", True, rounds=2)
    assert seen and set(seen) == {t.round_caps}
    assert t.read_all() == p.read_all()


def test_plan_cache_rebuilds_exactly_when_allocation_changes():
    """The plan is rebuilt when alloc_epoch or the pool size moves, and
    only then; a rebuilt plan equals a fresh ragged_plan."""
    store = PagedDocStore(4, 256, 8, page_size=64, initial_pages=4, device="cpu")
    cache = PlanCache()

    def check(expect_builds):
        plan, planes = cache.get(store)
        assert cache.builds == expect_builds
        fresh = ragged_plan(store)
        for f in ("owner", "pos_base", "prev_page", "page_count", "page_table"):
            np.testing.assert_array_equal(getattr(plan, f), getattr(fresh, f), err_msg=f)
        assert planes[1].shape[0] == store.pool_elem.shape[0]

    check(1)
    check(1)  # nothing changed
    store.ensure_rows([0, 1], [10, 70])
    check(2)
    store.ensure_rows([0, 1], [10, 70])  # already covered: no new pages
    check(2)
    store.ensure_rows([2], [200])  # past the free list: the pool doubles
    assert store.growths == 1
    check(3)
    store.permute_rows(np.asarray([1, 0, 2, 3]))
    check(4)
    store.evacuate_row(3)  # holds no pages: nothing changes
    check(4)
    store.evacuate_row(0)
    check(5)
    store.compact()
    check(6)
    # a pool growth alone (same epoch) still rebuilds: the key holds the size
    key = cache.key
    store.alloc_epoch = key[0]
    store._grow_pool(store.alloc.total_pages + 1)
    store.alloc_epoch = key[0]
    check(7)


def test_ragged_applies_equal_each_rounds_class_count(monkeypatch):
    """``streaming.ragged_applies`` adds, per committed round, the number of
    non-empty doc classes of that round's plan (the kernel's launches on
    the card); a long doc past the warp window (1024 slots) makes a second
    class."""
    from peritext_tpu_torch.store import session as session_mod

    classes = []
    original = session_mod.apply_batch_ragged

    def recording(*args, page_count_host, **kw):
        windows = page_count_host.shape[0]
        assert windows == args[9][0].shape[0]  # every row rides the round
        classes.append(len(ragged_teams(page_count_host, 64, args[8].shape[1], SMEM_BUDGET, 4)))
        return original(*args, page_count_host=page_count_host, **kw)

    monkeypatch.setattr(session_mod, "apply_batch_ragged", recording)
    workloads = [_port_workload(w) for w in generate_workload(seed=6, num_docs=5, ops_per_doc=20)]
    workloads.append(typed_doc(1200, 100))
    before = GLOBAL_COUNTERS.get("streaming.ragged_applies")
    t = StreamingMerge(num_docs=len(workloads), actors=ACTORS, slot_capacity=2048,
                       mark_capacity=512, tomb_capacity=512, round_insert_capacity=512,
                       round_delete_capacity=256, round_mark_capacity=256,
                       layout="ragged", device="cpu")
    frames, _ = build_arrival(workloads, 2, 1, as_frames=True)
    for r in range(2):
        t.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
        t.drain()
    assert len(classes) == t.rounds
    assert GLOBAL_COUNTERS.get("streaming.ragged_applies") - before == sum(classes)
    assert max(classes) == 2 and min(classes) >= 1
    p = StreamingMerge(num_docs=len(workloads), actors=ACTORS, slot_capacity=2048,
                       mark_capacity=512, tomb_capacity=512, round_insert_capacity=512,
                       round_delete_capacity=256, round_mark_capacity=256, device="cpu")
    for r in range(2):
        p.ingest_frames((d, b[r]) for d, b in enumerate(frames) if r < len(b))
        p.drain()
    assert t.read_all() == p.read_all() and t.digest() == p.digest()
