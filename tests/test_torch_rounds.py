"""The port's round apply (peritext_tpu_torch/ops/kernel.py
``apply_batch_compact``, one call per round, as the streaming session
commits) against the reference package's round applies on the lax path,
on the CPU: ``apply_batch_compact`` round by round, and the chained
``apply_batch_staged_rounds`` and ``apply_batch_stacked_rounds`` forms.  The same fuzz streams, split into
causally ordered rounds, give equal states field by field.  Covers empty
streams and flat streams with power-of-two padding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from peritext_tpu.ops import kernel as ref_kernel
from peritext_tpu.ops.packed import empty_docs as ref_empty_docs
from peritext_tpu_torch.ops import kernel
from peritext_tpu_torch.ops.encode import MAP_STREAM_COLS, MARK_COLS, encode_workloads
from peritext_tpu_torch.ops.packed import PackedDocs, empty_docs
from peritext_tpu_torch.testing.fuzz import generate_markheavy_workload, generate_workload

CAPS = dict(slot_capacity=128, mark_capacity=64, tomb_capacity=64, map_capacity=16)


def _pow2(n):
    w = 8
    while w < n:
        w *= 2
    return w


def _rounds(enc, split: bool):
    """Per-round padded (D, K) streams + counts: with ``split``, round 0
    carries each doc's first half of inserts and round 1 the rest with the
    deletes, marks and map ops (causal: inserts come in encode order)."""
    ins_n = np.count_nonzero(enc.ins_op, axis=1).astype(np.int32)
    del_n = np.count_nonzero(enc.del_target, axis=1).astype(np.int32)
    full = dict(ins=(enc.ins_ref, enc.ins_op, enc.ins_char), ins_n=ins_n,
                dels=enc.del_target, del_n=del_n, marks=enc.marks, mark_n=enc.mark_count,
                maps=enc.map_ops, map_n=enc.map_count)
    if not split:
        return [full]
    first = ins_n // 2
    cols = np.arange(enc.ins_op.shape[1])[None, :]
    r0_ins = tuple(np.where(cols < first[:, None], a, 0) for a in full["ins"])
    # round 1's inserts, left-packed
    r1_ins = []
    for a in full["ins"]:
        out = np.zeros_like(a)
        for d in range(a.shape[0]):
            rest = a[d, first[d]:ins_n[d]]
            out[d, : len(rest)] = rest
        r1_ins.append(out)
    zeros = lambda a: np.zeros_like(a)  # noqa: E731
    r0 = dict(ins=r0_ins, ins_n=first, dels=zeros(enc.del_target), del_n=zeros(del_n),
              marks={c: zeros(a) for c, a in enc.marks.items()}, mark_n=zeros(enc.mark_count),
              maps={c: zeros(a) for c, a in enc.map_ops.items()}, map_n=zeros(enc.map_count))
    r1 = dict(full, ins=tuple(r1_ins), ins_n=ins_n - first)
    return [r0, r1]


def _flat(padded, counts, pad_to=None):
    mask = np.arange(padded.shape[1])[None, :] < counts[:, None]
    v = padded[mask].astype(np.int32)
    if pad_to is not None:
        v = np.concatenate([v, np.zeros(pad_to - len(v), np.int32)])
    return v


def _compact_inputs(r, pad: bool):
    """(counts, ins_flat, del_flat, mark_flat, map_flat) as numpy, each flat
    padded to its power-of-two bucket with ``pad`` (else exact: a kind with
    no ops is an empty stream)."""
    def f(a, n):
        return _flat(a, n, _pow2(int(n.sum())) if pad else None)
    counts = (r["ins_n"], r["del_n"], r["mark_n"], r["map_n"])
    return (counts, tuple(f(a, r["ins_n"]) for a in r["ins"]), f(r["dels"], r["del_n"]),
            {c: f(r["marks"][c], r["mark_n"]) for c in MARK_COLS},
            {c: f(r["maps"][c], r["map_n"]) for c in MAP_STREAM_COLS})


def _loop_seq(rounds):
    """Per-round slot windows as the session bounds them: the power-of-two
    bucket of the most inserts any doc has taken so far (None once it
    reaches the capacity).  The reference's lax path has no window."""
    cum, out = 0, []
    for r in rounds:
        cum = cum + r["ins_n"]
        bound = _pow2(int(cum.max()))
        out.append(bound if bound < CAPS["slot_capacity"] else None)
    return tuple(out)


def _widths(r):
    return (r["ins"][0].shape[1], r["dels"].shape[1],
            r["marks"][MARK_COLS[0]].shape[1], r["maps"][MAP_STREAM_COLS[0]].shape[1])


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(v, fn) for v in x)
    return fn(x)


def _j(x):
    return _tree(x, jnp.asarray)


def _p(x):
    return _tree(x, lambda a: torch.from_numpy(np.ascontiguousarray(a)))


def _states(d):
    return (ref_empty_docs(d, CAPS["slot_capacity"], CAPS["mark_capacity"],
                           CAPS["tomb_capacity"], map_capacity=CAPS["map_capacity"]),
            empty_docs(d, CAPS["slot_capacity"], CAPS["mark_capacity"], CAPS["tomb_capacity"],
                       map_capacity=CAPS["map_capacity"], device="cpu"))


def _assert_equal(ref_state, state: PackedDocs):
    for name, a, b in zip(PackedDocs._fields, ref_state, state):
        assert np.array_equal(np.asarray(a), b.numpy()), name


def _port_chain(state, rounds, pad: bool = True):
    """The port's commit of ``rounds``: one apply_batch_compact per round at
    its own widths and slot window."""
    for r, loop_slots in zip(rounds, _loop_seq(rounds)):
        state = kernel.apply_batch_compact(state, *_p(_compact_inputs(r, pad)),
                                           widths=_widths(r), insert_loop_slots=loop_slots)
    return state


def _workloads(family, seed):
    gen = generate_markheavy_workload if family == "markheavy" else generate_workload
    return gen(seed=seed, num_docs=6, ops_per_doc=40)


@pytest.mark.parametrize("family,seed", [("fuzz", 3), ("fuzz", 17), ("markheavy", 5)])
@pytest.mark.parametrize("pad", [False, True])
def test_compact_rounds_equal_reference(family, seed, pad):
    enc = encode_workloads(_workloads(family, seed))
    rounds = _rounds(enc, split=True)
    ref_state, state = _states(enc.num_docs)
    for r, loop_slots in zip(rounds, _loop_seq(rounds)):
        counts, ins, dels, marks, maps = _compact_inputs(r, pad)
        widths = _widths(r)
        ref_state = ref_kernel.apply_batch_compact_jit(
            ref_state, *_j((counts, ins, dels, marks, maps)), widths=widths, insert_impl="lax")
        state = kernel.apply_batch_compact(state, *_p((counts, ins, dels, marks, maps)),
                                           widths=widths, insert_loop_slots=loop_slots)
    _assert_equal(ref_state, state)


def test_empty_round_is_a_no_op():
    enc = encode_workloads(_workloads("fuzz", 9))
    (r,) = _rounds(enc, split=False)
    ref_state, state = _states(enc.num_docs)
    counts, ins, dels, marks, maps = _compact_inputs(r, pad=False)
    ref_state = ref_kernel.apply_batch_compact_jit(
        ref_state, *_j((counts, ins, dels, marks, maps)), widths=_widths(r), insert_impl="lax")
    state = kernel.apply_batch_compact(state, *_p((counts, ins, dels, marks, maps)),
                                       widths=_widths(r))
    zero = tuple(np.zeros_like(c) for c in counts)
    empty = np.zeros(0, np.int32)
    nothing = (zero, (empty,) * 3, empty, {c: empty for c in MARK_COLS},
               {c: empty for c in MAP_STREAM_COLS})
    after = kernel.apply_batch_compact(state, *_p(nothing), widths=(8, 8, 8, 8))
    ref_after = ref_kernel.apply_batch_compact_jit(ref_state, *_j(nothing), widths=(8, 8, 8, 8),
                                                   insert_impl="lax")
    _assert_equal(ref_after, after)
    _assert_equal(ref_state, after)


def test_pad_from_flat_clamps_and_zeros():
    flat = torch.tensor([5, 6, 7], dtype=torch.int32)
    counts = torch.tensor([2, 0, 1, 0], dtype=torch.int32)
    got = kernel._pad_from_flat(flat, counts, 3)
    assert got.tolist() == [[5, 6, 0], [0, 0, 0], [7, 0, 0], [0, 0, 0]]
    assert kernel._pad_from_flat(flat[:0], counts * 0, 2).tolist() == [[0, 0]] * 4
    want = ref_kernel._pad_from_flat(jnp.asarray(flat.numpy()), jnp.asarray(counts.numpy()), 3)
    assert np.asarray(want).tolist() == got.tolist()


@pytest.mark.parametrize("family,seed", [("fuzz", 21), ("markheavy", 8)])
def test_staged_rounds_equal_reference(family, seed):
    enc = encode_workloads(_workloads(family, seed))
    rounds = _rounds(enc, split=True)
    d = enc.num_docs
    lens = {k: [] for k in ("ins", "del", "mark", "map")}
    parts = [_compact_inputs(r, pad=True) for r in rounds]
    counts_all = np.stack([np.stack(p[0]) for p in parts]).astype(np.int32)
    ins_all = tuple(np.concatenate([p[1][j] for p in parts]) for j in range(3))
    del_all = np.concatenate([p[2] for p in parts])
    mark_all = {c: np.concatenate([p[3][c] for p in parts]) for c in MARK_COLS}
    map_all = {c: np.concatenate([p[4][c] for p in parts]) for c in MAP_STREAM_COLS}
    for p in parts:
        lens["ins"].append(len(p[1][0]))
        lens["del"].append(len(p[2]))
        lens["mark"].append(len(p[3][MARK_COLS[0]]))
        lens["map"].append(len(p[4][MAP_STREAM_COLS[0]]))
    statics = dict(widths_seq=tuple(_widths(r) for r in rounds), loop_slots_seq=_loop_seq(rounds),
                   ins_lens=tuple(lens["ins"]), del_lens=tuple(lens["del"]),
                   mark_lens=tuple(lens["mark"]), map_lens=tuple(lens["map"]))
    ref_state, state = _states(d)
    tensors = (counts_all, ins_all, del_all, mark_all, map_all)
    ref_state = ref_kernel.apply_batch_staged_rounds_jit(ref_state, *_j(tensors),
                                                         insert_impl="lax", **statics)
    _assert_equal(ref_state, _port_chain(state, rounds))


@pytest.mark.parametrize("family,seed", [("fuzz", 4), ("markheavy", 12)])
def test_stacked_rounds_equal_reference(family, seed):
    enc = encode_workloads(_workloads(family, seed))
    rounds = _rounds(enc, split=True)
    stacked = (
        np.stack([r["ins"][0] for r in rounds]), np.stack([r["ins"][1] for r in rounds]),
        np.stack([r["ins"][2] for r in rounds]), np.stack([r["dels"] for r in rounds]),
        {c: np.stack([r["marks"][c] for r in rounds]) for c in MARK_COLS},
        np.stack([r["mark_n"] for r in rounds]),
        {c: np.stack([r["maps"][c] for r in rounds]) for c in MAP_STREAM_COLS},
        np.stack([r["map_n"] for r in rounds]),
    )
    ref_state, state = _states(enc.num_docs)
    loop_seq = _loop_seq(rounds)
    ref_state = ref_kernel.apply_batch_stacked_rounds_jit(
        ref_state, _j(stacked), loop_slots_seq=loop_seq, insert_impl="lax")
    _assert_equal(ref_state, _port_chain(state, rounds))
