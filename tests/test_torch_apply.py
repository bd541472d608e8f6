"""The port's host encode, batched apply and resolve against the reference
package's, leaf for leaf, on the CPU.

Workloads come from the reference's ``testing.fuzz`` and cross to the port
through the wire format (``Change.to_json`` -> the port's
``Change.from_json``); encoded streams and state cross as numpy arrays.
The reference applies with ``insert_impl="lax"``.  Integer and boolean
state throughout, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.core.comment import Comment, put_comment
from peritext_tpu.core.doc import Doc as JaxDoc
from peritext_tpu.ops.encode import encode_workloads as jax_encode
from peritext_tpu.ops.kernel import apply_batch as jax_apply
from peritext_tpu.ops.kernel import encoded_arrays_of as jax_arrays_of
from peritext_tpu.ops.packed import empty_docs as jax_empty_docs
from peritext_tpu.ops.resolve import pack_cursor_rows as jax_pack_cursor_rows
from peritext_tpu.ops.resolve import resolve as jax_resolve
from peritext_tpu.ops.resolve import resolve_cursors as jax_resolve_cursors
from peritext_tpu.testing.fuzz import generate_markheavy_workload, generate_workload
from peritext_tpu.testing.synth import synth_streams
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.ops.encode import encode_workloads
from peritext_tpu_torch.ops.kernel import apply_batch, encoded_arrays_of
from peritext_tpu_torch.ops.packed import PackedDocs, empty_docs, packed_from_numpy, to_numpy
from peritext_tpu_torch.ops.resolve import pack_cursor_rows, resolve, resolve_cursors

CPU = torch.device("cpu")
SLOTS, MARKS = 192, 96


def _to_port(workloads):
    return [{a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}
            for w in workloads]


def _with_comment_bodies(workloads, every=2):
    """Give every ``every``-th doc a comment body from a fresh actor: map
    ops (makeMap / set) that the device applies as LWW registers."""
    for d, w in enumerate(workloads):
        if d % every == 0:
            commenter = JaxDoc("commenter")
            change, _ = put_comment(
                commenter, Comment(id=f"cb-{d}", actor="commenter", content="body")
            )
            w["commenter"] = [change]
    return workloads


FAMILIES = {
    "fuzz": lambda: generate_workload(11, 5, 40),
    "markheavy": lambda: generate_markheavy_workload(3, 4, 50),
    "maps": lambda: _with_comment_bodies(generate_workload(29, 4, 30)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    workloads = FAMILIES[request.param]()
    port_workloads = _to_port(workloads)
    return workloads, port_workloads, jax_encode(workloads), encode_workloads(port_workloads)


def _jax_state(enc, arrays=None, state=None):
    if state is None:
        state = jax_empty_docs(enc.num_docs, SLOTS, MARKS,
                               tomb_capacity=enc.del_target.shape[1])
    return jax_apply(state, arrays or jax_arrays_of(enc), insert_impl="lax")


def _port_state(enc, arrays=None, state=None):
    if state is None:
        state = empty_docs(enc.num_docs, SLOTS, MARKS,
                           tomb_capacity=enc.del_target.shape[1], device=CPU)
    return apply_batch(state, arrays or encoded_arrays_of(enc, CPU))


def _assert_state_equal(port_state, jax_state):
    ours = to_numpy(port_state)
    for name, a, b in zip(PackedDocs._fields, ours, jax_state):
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_encode_equal(family):
    _, _, je, pe = family
    for name in ("ins_ref", "ins_op", "ins_char", "del_target", "mark_count",
                 "map_count", "num_ops"):
        np.testing.assert_array_equal(getattr(pe, name), getattr(je, name), err_msg=name)
    for attr in ("marks", "map_ops"):
        ours, theirs = getattr(pe, attr), getattr(je, attr)
        assert ours.keys() == theirs.keys()
        for col in ours:
            np.testing.assert_array_equal(ours[col], theirs[col], err_msg=col)
    assert pe.fallback_docs == je.fallback_docs
    for tables in ("actor_tables", "attr_tables", "map_tables"):
        for ours, theirs in zip(getattr(pe, tables), getattr(je, tables)):
            assert [ours.lookup(i) for i in range(len(ours))] == [
                theirs.lookup(i) for i in range(len(theirs))
            ]


def test_apply_batch_every_leaf_equal(family):
    _, _, je, pe = family
    _assert_state_equal(_port_state(pe), _jax_state(je))


def test_resolve_every_field_equal(family):
    _, _, je, pe = family
    ours = resolve(_port_state(pe), 32)
    theirs = jax_resolve(_jax_state(je), 32)
    for name, a, b in zip(ours._fields, ours, theirs):
        b = np.asarray(b)
        a = a.numpy()
        if name == "comment_bits":  # int64 holding the uint32 words
            assert a.dtype == np.int64 and b.dtype == np.uint32
            b = b.astype(np.int64)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_resolve_without_comments_equal(family):
    _, _, je, pe = family
    ours = resolve(_port_state(pe), 32, with_comments=False)
    theirs = jax_resolve(_jax_state(je), 32, with_comments=False)
    assert ours.comment_bits.shape == np.asarray(theirs.comment_bits).shape
    np.testing.assert_array_equal(ours.overflow.numpy(), np.asarray(theirs.overflow))
    np.testing.assert_array_equal(ours.visible.numpy(), np.asarray(theirs.visible))


def test_resolve_cursors_equal(family):
    workloads, port_workloads, je, pe = family
    rng = np.random.default_rng(5)
    cursor_map = {}
    for d, w in enumerate(port_workloads):
        elems = sorted({op.opid for log in w.values() for ch in log for op in ch.ops
                        if op.action == "set" and op.insert})
        picks = [elems[i] for i in rng.integers(0, len(elems), 5)] if elems else []
        # one cursor on an element no doc has: resolves to -1
        cursor_map[d] = [{"elemId": e} for e in picks] + [{"elemId": (999, "nobody")}]
    rows = pack_cursor_rows(cursor_map, pe.num_docs, lambda d: pe.actor_tables[d])
    np.testing.assert_array_equal(
        rows, jax_pack_cursor_rows(cursor_map, je.num_docs, lambda d: je.actor_tables[d])
    )
    port_state, jax_state = _port_state(pe), _jax_state(je)
    ours = resolve_cursors(port_state, resolve(port_state).visible, torch.as_tensor(rows))
    theirs = jax_resolve_cursors(jax_state, jax_resolve(jax_state).visible, jnp.asarray(rows))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert (ours.numpy() == -1).any()


def test_overflow_fallback_state_equal():
    # tiny capacities: inserts, tombstones and marks all run out for some docs
    workloads = generate_workload(41, 5, 40)
    je, pe = jax_encode(workloads), encode_workloads(_to_port(workloads))
    js = jax_apply(jax_empty_docs(5, 24, 4, tomb_capacity=4, map_capacity=1),
                   jax_arrays_of(je), insert_impl="lax")
    ps = apply_batch(empty_docs(5, 24, 4, tomb_capacity=4, map_capacity=1, device=CPU),
                     encoded_arrays_of(pe, CPU))
    _assert_state_equal(ps, js)
    assert ps.overflow.any()


def test_state_carried_from_reference():
    """Half a log applied by the reference, carried across with
    packed_from_numpy, the rest applied by the port: the reference's
    full-log state."""
    workloads = generate_markheavy_workload(8, 4, 60)
    je = jax_encode(workloads)
    full = _jax_state(je)
    arrays = [np.asarray(a) if not isinstance(a, dict) else {k: np.asarray(v) for k, v in a.items()}
              for a in jax_arrays_of(je)]
    ins_ref, ins_op, ins_char, dels, marks, mark_count, maps, map_count = arrays
    h = ins_op.shape[1] // 2
    zeros = lambda a: np.zeros_like(a)  # noqa: E731
    first = (ins_ref[:, :h], ins_op[:, :h], ins_char[:, :h], zeros(dels),
             {k: zeros(v) for k, v in marks.items()}, zeros(mark_count),
             {k: zeros(v) for k, v in maps.items()}, zeros(map_count))
    half = _jax_state(je, arrays=tuple(
        jnp.asarray(a) if not isinstance(a, dict) else {k: jnp.asarray(v) for k, v in a.items()}
        for a in first))
    carried = packed_from_numpy([np.asarray(x) for x in half], CPU)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    rest = (t(ins_ref[:, h:]), t(ins_op[:, h:]), t(ins_char[:, h:]), t(dels),
            {k: t(v) for k, v in marks.items()}, t(mark_count),
            {k: t(v) for k, v in maps.items()}, t(map_count))
    _assert_state_equal(apply_batch(carried, rest), full)


def test_state_carried_synth_rounds():
    state = jax_empty_docs(6, 96, 32, tomb_capacity=16)
    r1 = synth_streams(6, inserts_per_doc=24, deletes_per_doc=6, marks_per_doc=8, seed=1)
    r2 = synth_streams(6, inserts_per_doc=20, deletes_per_doc=6, marks_per_doc=8, seed=2,
                       ctr_offset=32)
    mid = jax_apply(state, r1, insert_impl="lax")
    want = jax_apply(mid, r2, insert_impl="lax")
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    r2_port = tuple({k: t(v) for k, v in a.items()} if isinstance(a, dict) else t(a)
                    for a in r2)
    got = apply_batch(packed_from_numpy([np.asarray(x) for x in mid], CPU), r2_port)
    _assert_state_equal(got, want)


def test_packed_round_trip():
    state = jax_empty_docs(3, 16, 8)
    ours = packed_from_numpy([np.asarray(x) for x in state], CPU)
    assert ours.overflow.dtype == torch.bool and ours.elem_id.dtype == torch.int32
    _assert_state_equal(ours, state)
    with pytest.raises(ValueError):
        packed_from_numpy([np.asarray(x) for x in state][:-1], CPU)
