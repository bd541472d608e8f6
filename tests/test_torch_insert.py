"""The port's plain insert phase (peritext_tpu_torch/ops/insert.py) against the
reference package's: ``jax.vmap(kernel._insert_loop)`` and the Pallas
kernel in interpret mode.  Integer state, so every comparison is exact.

Inputs come from the reference's ``synth_streams`` (numpy) and pass to both
sides as the same arrays.  On CPU tensors ``insert_batch`` runs the plain
version; the kernel itself is held against it in test_torch_insert_cuda.py
and chip_smoke.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peritext_tpu.ops.kernel import _insert_loop
from peritext_tpu.ops.packed import empty_docs as jax_empty_docs
from peritext_tpu.ops.pallas_insert import effective_loop_slots as jax_loop_slots
from peritext_tpu.ops.pallas_insert import insert_batch_pallas
from peritext_tpu.testing.synth import synth_streams
from peritext_tpu_torch.ops.insert import effective_loop_slots, insert_batch
from peritext_tpu_torch.testing.synth import synth_streams as port_synth_streams


def _numpy_args(docs, slots, inserts, seed, ctr_offset=0):
    state = jax_empty_docs(docs, slots, 8, tomb_capacity=8)
    streams = synth_streams(docs, inserts_per_doc=inserts, seed=seed, ctr_offset=ctr_offset)
    return [np.asarray(a) for a in (state.elem_id, state.char, state.num_slots,
                                    state.overflow, *streams[:3])]


def _port(args, **kw):
    out = insert_batch(*(torch.from_numpy(np.array(a)) for a in args), **kw)
    return [x.numpy() for x in out]


def _jax_lax(args):
    return [np.asarray(x) for x in jax.vmap(_insert_loop)(*(jnp.asarray(a) for a in args))]


def _jax_pallas(args, loop_slots=None):
    out = insert_batch_pallas(*(jnp.asarray(a) for a in args), interpret=True,
                              loop_slots=loop_slots)
    return [np.asarray(x) for x in out]


def _assert_same(got, want):
    for a, b, name in zip(got, want, ("elem", "char", "n", "ov")):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("docs,slots,inserts", [(4, 32, 12), (8, 64, 40), (5, 128, 100)])
def test_plain_insert_matches_lax_and_pallas(docs, slots, inserts):
    args = _numpy_args(docs, slots, inserts, seed=3)
    got = _port(args)
    _assert_same(got, _jax_lax(args))
    _assert_same(got, _jax_pallas(args))


@pytest.mark.parametrize("loop_slots", [24, 30, 96])
def test_plain_insert_loop_slots_window(loop_slots):
    # the window is the capacity inside the phase; slots past it are untouched
    args = _numpy_args(8, 96, 24, seed=5)
    _assert_same(_port(args, loop_slots=loop_slots), _jax_pallas(args, loop_slots=loop_slots))


def test_plain_insert_loop_slots_too_small_flags_overflow():
    args = _numpy_args(6, 64, 40, seed=8)
    got = _port(args, loop_slots=16)
    _assert_same(got, _jax_pallas(args, loop_slots=16))
    assert got[3].all()


def test_effective_loop_slots_matches_reference():
    for s_cap, loop in [(96, None), (96, 24), (96, 30), (96, 1), (96, 200), (384, 179)]:
        assert effective_loop_slots(s_cap, loop) == jax_loop_slots(s_cap, loop)


# 8: a window smaller than the carried docs, which must all overflow
@pytest.mark.parametrize("loop_slots", [None, 40, 8])
def test_plain_insert_carried_state(loop_slots):
    first = _jax_lax(_numpy_args(8, 96, 20, seed=7))
    second = _numpy_args(8, 96, 16, seed=11, ctr_offset=20)[4:]
    args = [*first, *second]
    got = _port(args, loop_slots=loop_slots)
    _assert_same(got, _jax_pallas(args, loop_slots=loop_slots))
    if loop_slots is None:
        _assert_same(got, _jax_lax(args))


def test_plain_insert_full_doc_overflow():
    args = _numpy_args(4, 8, 16, seed=9)
    got = _port(args)
    _assert_same(got, _jax_lax(args))
    _assert_same(got, _jax_pallas(args))
    assert got[3].all()


def test_plain_insert_missing_reference_overflow():
    args = _numpy_args(6, 64, 20, seed=4)
    args[4] = args[4].copy()
    args[4][2, 5] = 4242 << 10  # an element id no doc ever holds
    got = _port(args)
    _assert_same(got, _jax_lax(args))
    _assert_same(got, _jax_pallas(args))
    assert got[3][2] and not got[3][[0, 1, 3, 4, 5]].any()


def test_plain_insert_zero_width_stream_is_noop():
    args = _numpy_args(4, 32, 0, seed=2)
    _assert_same(_port(args), args[:4])


def test_port_synth_streams_equal_reference():
    for kw in (dict(inserts_per_doc=30), dict(inserts_per_doc=12, deletes_per_doc=5,
                                              marks_per_doc=6, ctr_offset=9)):
        ours = port_synth_streams(5, seed=13, **kw)
        theirs = synth_streams(5, seed=13, **kw)
        for a, b in zip(ours[:4] + ours[5:], theirs[:4] + theirs[5:]):
            np.testing.assert_array_equal(a, b)
        assert ours[4].keys() == theirs[4].keys()
        for col in ours[4]:
            np.testing.assert_array_equal(ours[4][col], theirs[4][col])


def test_insert_batch_rejects_bad_inputs():
    args = [torch.from_numpy(np.array(a)) for a in _numpy_args(4, 32, 8, seed=1)]
    with pytest.raises(TypeError):
        insert_batch(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        insert_batch(*args[:4], args[4][:, :4], *args[5:])
    with pytest.raises(ValueError):
        insert_batch(args[0].t().contiguous().t(), *args[1:])
