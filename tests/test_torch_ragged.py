"""The port's ragged layout against the reference package's, on the CPU,
exactly.

* ``ragged_insert_reference`` (the plain version of the ragged insert
  kernel, ops/ragged_insert.py) against the reference's TPU kernel
  ``ragged_insert_pallas(..., interpret=True)`` and its lax pool walk
  ``_ragged_insert_lax``, on the same pool and plan: pool planes (null page
  and unowned pages included), n and overflow;
* ``apply_batch_ragged`` against ``apply_batch_ragged_jit(ragged_impl=
  "lax")``, every ``PackedDocs`` field after ``materialize_rows``;
* ``ragged_plan`` planes, ``plan_arrays`` and ``stream_counts``;
* ``DocBatch(layout="ragged")`` against the reference ``DocBatch``;
* the kernel build key covering the shared CUDA header.

The CUDA kernel itself is held against ``ragged_insert_reference`` in
test_torch_ragged_cuda.py and chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.ops import ragged as jax_ragged
from peritext_tpu.ops.ragged_pallas import ragged_insert_pallas
from peritext_tpu.store import paged as jax_paged
from peritext_tpu.store.ragged import ragged_plan as jax_ragged_plan
from peritext_tpu.testing.fuzz import generate_markheavy_workload, generate_workload
from peritext_tpu.testing.synth import synth_streams
from peritext_tpu_torch.ops.ragged import apply_batch_ragged, plan_arrays, stream_counts
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.store.paged import PagedDocStore, group_stream_arrays
from peritext_tpu_torch.store.ragged import ragged_plan
from peritext_tpu_torch.utils import nvcc
from test_torch_batch import FAMILIES
from test_torch_paged import _assert_state_equal, _encoded, _merge_both

PLAN_FIELDS = ("row_idx", "owner", "pos_base", "prev_page", "page_count", "page_table")


def _stores(d, slot_capacity, page_size, **kw):
    return (jax_paged.PagedDocStore(d, slot_capacity, 8, page_size=page_size, **kw),
            PagedDocStore(d, slot_capacity, 8, page_size=page_size, device="cpu", **kw))


def _ensure(js, ps, rows, used):
    js.ensure_rows(rows, used)
    ps.ensure_rows(rows, used)


def _plans(js, ps, rows=None):
    theirs, ours = jax_ragged_plan(js, rows), ragged_plan(ps, rows)
    for f in PLAN_FIELDS + ("pool_pages", "docs_walked", "pages_walked"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    return theirs, ours


def _insert_three_ways(js, ps, streams, counts, n0=None, ov0=None, rows=None):
    """One ragged insert round through the reference lax walk, the
    reference Pallas kernel (interpret mode) and the port's plain version,
    each on its own copy of the same pool; asserts every output equal and
    leaves each store holding its result.  Returns (n, ov) as numpy."""
    jp, pp = _plans(js, ps, rows)
    b = jp.num_rows
    n0 = np.zeros(b, np.int32) if n0 is None else n0
    ov0 = np.zeros(b, bool) if ov0 is None else ov0
    counts = np.asarray(counts, np.int32)
    _, owner, pos_base, prev_page, page_count, page_table = jax_ragged.plan_arrays(jp)
    cap = page_count * js.page_size
    refs, ops, chars = (jnp.asarray(a) for a in streams)
    pad = jax_ragged._pad_row
    lax_e, lax_c, n_lax, ov_lax = jax_ragged._ragged_insert_lax(
        js.pool_elem, js.pool_char, owner, pos_base, prev_page,
        pad(jnp.asarray(n0)), pad(jnp.asarray(ov0)), pad(cap),
        pad(refs), pad(ops), pad(chars), int(counts.max(initial=0)),
    )
    pal_e, pal_c, n_pal, ov_pal = ragged_insert_pallas(
        js.pool_elem, js.pool_char, page_table, page_count, jnp.asarray(counts),
        jnp.asarray(n0), jnp.asarray(ov0), cap, refs, ops, chars, interpret=True,
    )
    t = plan_arrays(pp, "cpu")
    n, ov = ragged_insert(ps.pool_elem, ps.pool_char, *t[1:], torch.from_numpy(n0),
                          torch.from_numpy(ov0), torch.from_numpy(counts),
                          *(torch.from_numpy(np.asarray(a)) for a in streams))
    for name, ours, lax_v, pal_v in (
        ("pool_elem", ps.pool_elem, lax_e, pal_e), ("pool_char", ps.pool_char, lax_c, pal_c),
        ("n", n, n_lax[:-1], n_pal), ("ov", ov, ov_lax[:-1], ov_pal),
    ):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(lax_v), err_msg=f"{name} vs lax")
        np.testing.assert_array_equal(ours.numpy(), np.asarray(pal_v), err_msg=f"{name} vs pallas")
    js.pool_elem, js.pool_char = lax_e, lax_c
    assert not ps.pool_elem[0].any() and not ps.pool_char[0].any()
    return n.numpy(), ov.numpy()


def _workload_streams(workloads):
    enc = _encoded(workloads)
    counts, _ = stream_counts(enc)
    return [enc.ins_ref, enc.ins_op, enc.ins_char], counts


def _synth(counts, width, seed, ctr_offset=0):
    """Left-packed synthetic insert streams: doc i has counts[i] live ops."""
    refs, ops, chars = synth_streams(len(counts), inserts_per_doc=width, seed=seed,
                                     ctr_offset=ctr_offset)[:3]
    live = np.arange(width)[None, :] < np.asarray(counts)[:, None]
    return [np.where(live, a, 0).astype(np.int32) for a in (refs, ops, chars)]


WORKLOAD_CASES = {
    # name: (workloads, slot_capacity, page_size)
    "uniform": (lambda: generate_workload(3, 6, 40), 512, 64),
    "longdoc_mix": (lambda: generate_workload(11, 5, 12) + generate_workload(12, 1, 300),
                    512, 64),
    # more inserts than slots: overflow must trip at the same op as the
    # padded path (cap = page_count * P == S)
    "cap_overflow": (lambda: generate_workload(7, 3, 200), 64, 32),
}


@pytest.mark.parametrize("name", sorted(WORKLOAD_CASES))
def test_plain_ragged_insert_equals_reference(name):
    make, slot_capacity, page_size = WORKLOAD_CASES[name]
    streams, counts = _workload_streams(make())
    js, ps = _stores(len(counts), slot_capacity, page_size)
    _ensure(js, ps, np.arange(len(counts)), counts)
    _, ov = _insert_three_ways(js, ps, streams, counts)
    assert ov.any() == (name == "cap_overflow")


def test_plain_ragged_insert_missing_reference():
    counts = [20, 20, 20, 20]
    streams = _synth(counts, 20, seed=4)
    streams[0][2, 6] = 4242 << 10  # an element id no doc holds
    js, ps = _stores(4, 128, 16)
    _ensure(js, ps, np.arange(4), counts)
    _, ov = _insert_three_ways(js, ps, streams, counts)
    assert ov.tolist() == [False, False, True, False]


def test_plain_ragged_insert_stream_wider_than_every_count():
    """The trip count is each doc's own count: padding columns past it
    (op id 0) are no-ops, and a doc with count 0 stays empty."""
    counts = [3, 0, 17, 9]
    js, ps = _stores(4, 128, 16)
    _ensure(js, ps, np.arange(4), counts)
    n, ov = _insert_three_ways(js, ps, _synth(counts, 64, seed=5), counts)
    assert n.tolist() == counts and not ov.any()


def test_plain_ragged_insert_interleaved_pages_after_growth():
    """Rows allocated in two ensure_rows calls with a pool growth between:
    each doc's page table jumps across the pool."""
    counts = [40, 70, 25]
    js, ps = _stores(3, 256, 16, initial_pages=4)
    _ensure(js, ps, [0, 1, 2], [16, 16, 16])
    _ensure(js, ps, [2, 0, 1], [25, 40, 70])
    assert ps.growths >= 1
    assert all(np.any(np.diff(ps.alloc.pages_of(r)) != 1) for r in (0, 1))
    _insert_three_ways(js, ps, _synth(counts, 70, seed=6), counts)


def test_plain_ragged_insert_carried_state_and_unowned_pages():
    """A second round on carried state (ctr_offset keeps ids unique) after a
    growth, for two of four docs: the other docs' pages, which hold the
    first round's elements, and the free pages come back untouched."""
    first, second = [30, 12, 45, 20], [25, 60]
    js, ps = _stores(4, 256, 16, initial_pages=6)
    _ensure(js, ps, np.arange(4), first)
    n1, ov1 = _insert_three_ways(js, ps, _synth(first, 45, seed=7), first)
    _ensure(js, ps, [1, 3], [first[1] + second[0], first[3] + second[1]])
    assert ps.growths >= 1
    before = ps.pool_elem.clone()
    _insert_three_ways(js, ps, _synth(second, 60, seed=8, ctr_offset=45), second,
                       n0=n1[[1, 3]], ov0=ov1[[1, 3]], rows=[1, 3])
    for row in (0, 2):
        for pg in ps.alloc.pages_of(row):
            assert torch.equal(ps.pool_elem[pg], before[pg])
    free = sorted(set(range(1, ps.alloc.total_pages))
                  - {pg for r in range(4) for pg in ps.alloc.pages_of(r)})
    assert free and not ps.pool_elem[free].any()


def test_ragged_insert_rejects_bad_inputs():
    js, ps = _stores(2, 64, 16)
    _ensure(js, ps, [0, 1], [5, 5])
    t = plan_arrays(ragged_plan(ps), "cpu")
    streams = [torch.from_numpy(a) for a in _synth([5, 5], 5, seed=1)]
    args = [ps.pool_elem, ps.pool_char, *t[1:], torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool), torch.tensor([5, 5], dtype=torch.int32), *streams]
    with pytest.raises(TypeError):
        ragged_insert(*args[:7], args[7].to(torch.int64), *args[8:])
    with pytest.raises(ValueError):
        ragged_insert(*args[:10], args[10][:, :3], *args[11:])
    with pytest.raises(ValueError):
        ragged_insert(*args[:6], args[6].t().contiguous().t(), *args[7:])


# -- apply_batch_ragged ------------------------------------------------------------


APPLY_CASES = {
    "uniform": (lambda: generate_workload(3, 6, 40), 512, 64),
    "markheavy": (lambda: generate_markheavy_workload(5, 4, 50), 512, 64),
    "maps": (FAMILIES["maps"][0], 128, 32),
    "longdoc_mix": WORKLOAD_CASES["longdoc_mix"],
    "cap_overflow": WORKLOAD_CASES["cap_overflow"],
}


@pytest.mark.parametrize("name", sorted(APPLY_CASES))
def test_apply_batch_ragged_equals_reference(name):
    make, slot_capacity, page_size = APPLY_CASES[name]
    enc = _encoded(make())
    d = enc.ins_op.shape[0]
    ins, dels = stream_counts(enc)
    np.testing.assert_array_equal(np.stack([ins, dels]),
                                  np.stack(jax_ragged.stream_counts(enc)))
    js = jax_paged.PagedDocStore(d, slot_capacity, 128, page_size=page_size)
    ps = PagedDocStore(d, slot_capacity, 128, page_size=page_size, device="cpu")
    _ensure(js, ps, np.arange(d), ins)
    jp, pp = _plans(js, ps)
    js.pool_elem, js.pool_char, js.aux = jax_ragged.apply_batch_ragged_jit(
        js.pool_elem, js.pool_char, js.aux, *jax_ragged.plan_arrays(jp),
        jax_paged.group_stream_arrays(enc, None, d), jnp.asarray(ins), jnp.asarray(dels),
        ragged_impl="lax",
    )
    apply_batch_ragged(ps.pool_elem, ps.pool_char, ps.aux, *plan_arrays(pp, "cpu"),
                       group_stream_arrays(enc, None, d, "cpu"), torch.from_numpy(ins))
    rows = list(range(d))
    theirs = js.materialize_rows(rows, js.max_doc_pages)
    ours = ps.materialize_rows(rows, ps.max_doc_pages)
    _assert_state_equal(theirs, ours)
    np.testing.assert_array_equal(ps.pool_elem.numpy(), np.asarray(js.pool_elem))
    assert not ps.pool_elem[0].any()
    assert bool(ours.overflow.any()) == (name == "cap_overflow")


def test_ragged_exists_chunks_equal_dense_scan(monkeypatch):
    """The exists scan, whole and in one-column chunks, equals a plain
    any-match of each live target over its doc's dense slots."""
    from peritext_tpu_torch.ops import ragged

    enc = _encoded(generate_workload(9, 5, 60))
    ins, _ = stream_counts(enc)
    ps = PagedDocStore(5, 256, 64, page_size=16, device="cpu")
    ps.ensure_rows(np.arange(5), ins)
    plan = plan_arrays(ragged_plan(ps), "cpu")
    streams = [torch.from_numpy(a) for a in (enc.ins_ref, enc.ins_op, enc.ins_char)]
    ragged_insert(ps.pool_elem, ps.pool_char, *plan[1:], torch.zeros(5, dtype=torch.int32),
                  torch.zeros(5, dtype=torch.bool), torch.from_numpy(ins), *streams)
    targets = torch.from_numpy(enc.del_target)
    dense = ps.materialize_rows(list(range(5)), ps.max_doc_pages).elem_id
    want = (dense[:, :, None] == targets[:, None, :]).any(dim=1)
    live = targets != 0
    assert live.any()
    whole = ragged._ragged_exists(ps.pool_elem, plan[1], targets)
    monkeypatch.setattr(ragged, "_EXISTS_CHUNK", 1)
    chunked = ragged._ragged_exists(ps.pool_elem, plan[1], targets)
    assert torch.equal(whole & live, want & live)
    assert torch.equal(chunked, whole)


# -- DocBatch(layout="ragged") -----------------------------------------------------


@pytest.mark.parametrize("name", sorted(FAMILIES) + ["longdoc"])
def test_docbatch_ragged_equals_reference(name):
    ours = _merge_both("ragged", name)
    assert ours.stats.extras["layout_ragged"] == 1.0
    assert ours.stats.padding_efficiency == 1.0
    if name == "fallback":
        assert ours.fallback_docs == [0, 1, 3, 4]


def test_docbatch_ragged_runs_one_insert_phase(monkeypatch):
    """The ragged merge runs the ragged insert phase once and the padded
    insert phase not at all; the paged merge runs the padded one once per
    group."""
    from peritext_tpu_torch.api import batch as batch_mod
    from peritext_tpu_torch.ops import kernel, ragged
    from peritext_tpu_torch.testing import fuzz

    calls = {"ragged": 0, "padded": 0}

    def counting(name, fn):
        def wrapper(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(ragged, "ragged_insert", counting("ragged", ragged.ragged_insert))
    monkeypatch.setattr(kernel, "insert_batch", counting("padded", kernel.insert_batch))
    workloads = fuzz.generate_workload(2, 5, 20) + fuzz.generate_workload(3, 2, 150)
    batch_mod.DocBatch(layout="ragged", device="cpu", slot_capacity=256).merge(workloads)
    assert calls == {"ragged": 1, "padded": 0}
    calls.update(ragged=0, padded=0)
    paged = batch_mod.DocBatch(layout="paged", device="cpu", slot_capacity=256)
    paged.merge(workloads)
    groups = len(paged._encode_paged(workloads))
    assert groups > 1 and calls == {"ragged": 0, "padded": groups}


# -- build key -----------------------------------------------------------------------


def test_library_path_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header must give a new library path, or a stale library
    would load."""
    monkeypatch.setattr(nvcc, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "steps.cuh"\n')
    (tmp_path / "steps.cuh").write_text("// v1\n")
    first = nvcc.library_path("k")
    assert nvcc.library_path("k") == first
    (tmp_path / "steps.cuh").write_text("// v2\n")
    assert nvcc.library_path("k") != first
    (tmp_path / "k.cu").write_text('#include "steps.cuh"\n// edited\n')
    assert nvcc.library_path("k").name.startswith("k-")
