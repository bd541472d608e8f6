"""The port's page store and paged layout against the reference package's,
on the CPU, exactly.

* ``PageAllocator``, ``PagedDocStore`` (page tables, growth, pool stats),
  ``plan_page_groups`` and ``group_stream_arrays`` on the same request
  sequences;
* ``apply_batch_paged`` against ``apply_batch_paged_jit``, every
  ``PackedDocs`` field after ``materialize_rows``, including groups padded
  to a power of two whose padding rows read the last doc's aux row;
* ``DocBatch(layout="paged")`` against the reference ``DocBatch`` of the
  same layout: spans, roots, cursors, fallback docs, device ops, padding
  efficiency and the pool stats in ``stats.extras``.

Streams come from the reference encoder and pass to both sides as the same
numpy arrays; workloads cross to the port through the wire format.
"""

import numpy as np
import pytest
import torch

from peritext_tpu.api.batch import DocBatch as JaxDocBatch
from peritext_tpu.ops.encode import encode_doc_streams, pad_doc_streams
from peritext_tpu.store import alloc as jax_alloc
from peritext_tpu.store import paged as jax_paged
from peritext_tpu.testing.fuzz import generate_markheavy_workload, generate_workload
from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.ops.kernel import PAGED_AUX_FIELDS
from peritext_tpu_torch.store import DEFAULT_PAGE_SIZE, PageAllocator, PagedDocStore, PoolExhausted
from peritext_tpu_torch.store.paged import group_stream_arrays, plan_page_groups
from test_torch_batch import FAMILIES, _cursors, _to_port


def _encoded(workloads):
    per_doc, fallback, actors, attrs, maps = encode_doc_streams(workloads)
    return pad_doc_streams(per_doc, fallback, actors, attrs, maps)


def _stores(d, slot_capacity=256, mark_capacity=64, **kw):
    return (jax_paged.PagedDocStore(d, slot_capacity, mark_capacity, **kw),
            PagedDocStore(d, slot_capacity, mark_capacity, device="cpu", **kw))


def _assert_state_equal(theirs, ours):
    for f in theirs._fields:
        np.testing.assert_array_equal(np.asarray(getattr(theirs, f)),
                                      getattr(ours, f).numpy(), err_msg=f)


def _assert_store_equal(js, ps):
    assert ps.alloc.total_pages == js.alloc.total_pages
    for row in range(js.num_docs):
        assert ps.alloc.pages_of(row) == js.alloc.pages_of(row)
    np.testing.assert_array_equal(ps._num_pages, js._num_pages)
    assert ps.growths == js.growths
    assert ps.pool_stats() == js.pool_stats()
    assert ps.alloc_epoch == js.alloc_epoch
    np.testing.assert_array_equal(ps.pool_elem.numpy(), np.asarray(js.pool_elem))
    np.testing.assert_array_equal(ps.pool_char.numpy(), np.asarray(js.pool_char))
    for f, a in zip(PAGED_AUX_FIELDS, ps.aux):
        np.testing.assert_array_equal(a.numpy(), np.asarray(js.aux_field(f)), err_msg=f)


# -- allocator and store -------------------------------------------------------


def test_allocator_equals_reference():
    ours, theirs = PageAllocator(16), jax_alloc.PageAllocator(16)
    for doc, pages in [(3, 2), (0, 4), (3, 5), (0, 2), (7, 1)]:
        assert ours.ensure(doc, pages) == theirs.ensure(doc, pages)
    assert ours.grow(32) == theirs.grow(32) == 16
    assert ours.ensure(1, 12) == theirs.ensure(1, 12)
    for doc in (0, 1, 3, 7, 9):
        assert ours.pages_of(doc) == theirs.pages_of(doc)
        assert ours.num_pages(doc) == theirs.num_pages(doc)
    assert (ours.free_pages, ours.pages_in_use) == (theirs.free_pages, theirs.pages_in_use)
    with pytest.raises(PoolExhausted) as mine:
        ours.ensure(2, 99)
    with pytest.raises(jax_alloc.PoolExhausted) as ref:
        theirs.ensure(2, 99)
    assert (mine.value.requested, mine.value.free, mine.value.total) == (
        ref.value.requested, ref.value.free, ref.value.total)
    assert ours.pages_of(2) == []  # a failed ensure assigns nothing
    with pytest.raises(ValueError):
        PageAllocator(1)


@pytest.mark.parametrize("page_size,initial_pages", [(16, None), (16, 3), (64, 2), (32, 40)])
def test_store_ensure_rows_equals_reference(page_size, initial_pages):
    """Two ensure_rows calls with a pool growth between them: the second
    call's pages interleave with the first's, so a doc's pages are not
    contiguous; every table, count, stat and plane must still match."""
    js, ps = _stores(6, 256, 16, page_size=page_size, initial_pages=initial_pages)
    for rows, used in [([4, 0, 2], [40, 3, 17]), ([1, 2, 5, 0], [90, 200, 1, 130]),
                       ([3], [0])]:
        js.ensure_rows(rows, used)
        ps.ensure_rows(rows, used)
        _assert_store_equal(js, ps)
    if page_size == 16:
        assert ps.growths >= 1
        assert any(np.any(np.diff(ps.alloc.pages_of(r)) != 1) for r in range(6))
    for rows in ([0], [1, 2], [3, 4, 5], range(6)):
        for g in (js.width_for_rows(list(rows)), 16):
            np.testing.assert_array_equal(ps.page_rows(list(rows), g, pad_rows_to=8),
                                          js.page_rows(list(rows), g, pad_rows_to=8))
    for used in (0, 1, 16, 17, 255, 256, 1000):
        assert ps.pages_needed(used) == js.pages_needed(used)
    _assert_state_equal(js.materialize_rows([5, 0, 2], 16, pad_rows_to=4),
                        ps.materialize_rows([5, 0, 2], 16, pad_rows_to=4))


def test_store_pool_exhausted_and_validation():
    """The pool grows up to every doc fully grown plus the null page, and
    no further."""
    js, ps = _stores(4, 128, 8, page_size=16)
    assert ps.max_pool_pages == js.max_pool_pages == 1 + 4 * 8
    js.ensure_rows([0, 1, 2, 3], [128] * 4)
    ps.ensure_rows([0, 1, 2, 3], [128] * 4)
    _assert_store_equal(js, ps)
    assert ps.alloc.free_pages == 0
    with pytest.raises(jax_alloc.PoolExhausted) as ref:
        js._grow_pool(js.max_pool_pages + 1)
    with pytest.raises(PoolExhausted) as mine:
        ps._grow_pool(ps.max_pool_pages + 1)
    assert (mine.value.requested, mine.value.free, mine.value.total) == (
        ref.value.requested, ref.value.free, ref.value.total)
    with pytest.raises(ValueError):
        PagedDocStore(2, 100, 8, page_size=64, device="cpu")
    assert DEFAULT_PAGE_SIZE == jax_paged.DEFAULT_PAGE_SIZE


def test_plan_page_groups_and_stream_arrays_equal_reference():
    pages = {0: 3, 1: 1, 2: 9, 3: 0, 4: 4, 5: 17}
    ours = plan_page_groups(list(pages), pages.get, 16)
    theirs = jax_paged.plan_page_groups(list(pages), pages.get, 16)
    assert [g for g, _ in ours] == [g for g, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    enc = _encoded(generate_workload(4, 5, 30))
    for rows, b in [(None, 8), ([4, 1], 4)]:
        mine = group_stream_arrays(enc, rows, b, "cpu")
        ref = jax_paged.group_stream_arrays(enc, rows, b)
        for x, y in zip(_leaves(mine), _leaves(ref)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _leaves(arrays):
    out = []
    for a in arrays:
        if isinstance(a, dict):
            out.extend(a[k] for k in sorted(a))
        else:
            out.append(a)
    return out


# -- apply_batch_paged -------------------------------------------------------------


@pytest.mark.parametrize("name,groups", [
    # one group of 3 docs padded to 4 rows: the padding row reads doc 2,
    # the last doc, whose new aux row a clamped scatter would overwrite
    ("fuzz3", [[0, 1, 2]]),
    ("fuzz6", [[5, 1, 3], [0, 2, 4]]),
    ("markheavy5", [[4, 0, 2, 1, 3]]),
])
def test_apply_batch_paged_equals_reference(name, groups):
    workloads = {
        "fuzz3": lambda: generate_workload(31, 3, 40),
        "fuzz6": lambda: generate_workload(8, 6, 50),
        "markheavy5": lambda: generate_markheavy_workload(3, 5, 40),
    }[name]()
    enc = _encoded(workloads)
    d = len(workloads)
    js, ps = _stores(d, 256, 64, page_size=32, tomb_capacity=enc.del_target.shape[1])
    ins = np.count_nonzero(enc.ins_op, axis=1)
    for rows in groups:
        b = jax_paged._pow2(len(rows))
        js.ensure_rows(rows, ins[rows])
        ps.ensure_rows(rows, ins[rows])
        g = js.width_for_rows(rows)  # the reference's bucket for the group
        js.apply_rows(rows, g, jax_paged.group_stream_arrays(enc, rows, b), pad_rows_to=b)
        ps.apply_rows(rows, g, group_stream_arrays(enc, rows, b, "cpu"), pad_rows_to=b)
    _assert_store_equal(js, ps)
    every = list(range(d))
    theirs = js.materialize_rows(every, js.max_doc_pages)
    ours = ps.materialize_rows(every, ps.max_doc_pages)
    _assert_state_equal(theirs, ours)
    assert int(ours.num_slots[d - 1]) > 0  # the last doc did receive its inserts
    assert not ps.pool_elem[0].any() and not ps.pool_char[0].any()


# -- DocBatch(layout="paged") ------------------------------------------------------


def _merge_both(layout, name):
    if name == "longdoc":
        workloads = generate_workload(11, 5, 12) + generate_workload(12, 1, 300)
        caps = dict(slot_capacity=512, mark_capacity=128)
    else:
        make, caps = FAMILIES[name]
        workloads = make()
    # the fallback family's 28 slots take 4-slot pages; the others span pages
    caps = dict(caps, page_size=4 if caps["slot_capacity"] == 28 else 32)
    cursors = _cursors(workloads, seed=len(name))
    theirs = JaxDocBatch(layout=layout, **caps).merge(workloads, cursors=cursors)
    batch = DocBatch(layout=layout, device="cpu", **caps)
    ours = batch.merge(_to_port(workloads), cursors=cursors)
    assert ours.fallback_docs == theirs.fallback_docs
    assert ours.spans == theirs.spans
    assert ours.roots == theirs.roots
    assert ours.cursor_positions == theirs.cursor_positions
    assert ours.device_ops == theirs.device_ops
    assert ours.stats.padding_efficiency == pytest.approx(theirs.stats.padding_efficiency)
    assert ours.stats.extras == theirs.stats.extras
    assert batch.last_store is not None
    return ours


@pytest.mark.parametrize("name", sorted(FAMILIES) + ["longdoc"])
def test_docbatch_paged_equals_reference(name):
    ours = _merge_both("paged", name)
    assert ours.stats.extras["layout_paged"] == 1.0
    if name == "fallback":
        assert ours.fallback_docs == [0, 1, 3, 4]


@pytest.mark.parametrize("layout", ["paged", "ragged"])
def test_pooled_layout_validation(layout, monkeypatch):
    with pytest.raises(ValueError, match="unknown layout"):
        DocBatch(layout="bogus", device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        DocBatch(layout=layout, slot_capacity=100, device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        DocBatch(layout=layout, slot_capacity=128, page_size=48, device="cpu")
    DocBatch(layout="padded", slot_capacity=100, device="cpu")  # padded takes any width
    with pytest.raises(NotImplementedError, match="Multi-GPU mesh"):
        DocBatch(layout=layout, mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DocBatch(layout=layout)
