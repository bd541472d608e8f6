"""The CUDA insert kernel (peritext_tpu_torch/csrc/insert.cu) against its plain
torch version, on the card, bit for bit.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_insert_cuda.py -q
"""

import numpy as np
import pytest
import torch

from peritext_tpu_torch.ops import insert as insert_mod
from peritext_tpu_torch.ops.insert import (
    WARP_TEAM_MAX_SLOTS,
    insert_batch,
    insert_batch_reference,
)
from peritext_tpu_torch.ops.packed import empty_docs
from peritext_tpu_torch.testing.synth import synth_streams

pytestmark = pytest.mark.cuda

#: team variants: (threshold, block-team threads) patched in, None keeping the
#: default; "wide_block" gives small windows multi-warp blocks (a thread per slot)
TEAMS = {
    "default": (None, None),
    "warp": (1 << 30, None),
    "block": (0, None),
    "wide_block": (0, lambda window: min(1024, -(-window // 32) * 32)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, docs, slots, inserts, seed, ctr_offset=0):
    state = empty_docs(docs, slots, 8, tomb_capacity=8, device=device)
    ins_ref, ins_op, ins_char = synth_streams(
        docs, inserts_per_doc=inserts, seed=seed, ctr_offset=ctr_offset
    )[:3]
    streams = [torch.as_tensor(a).to(device) for a in (ins_ref, ins_op, ins_char)]
    return [state.elem_id, state.char, state.num_slots, state.overflow, *streams]


def _assert_same(got, want):
    for a, b, name in zip(got, want, ("elem", "char", "n", "ov")):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy(), err_msg=name)


@pytest.mark.parametrize(
    "docs,slots,inserts,loop_slots",
    [(4, 32, 12, None), (8, 64, 40, None), (8, 96, 24, 24), (33, 384, 179, 179),
     (3, 2048, 1500, None)],
)
def test_kernel_matches_plain(cuda, docs, slots, inserts, loop_slots):
    args = _inputs(cuda, docs, slots, inserts, seed=3)
    _assert_same(
        insert_batch(*args, loop_slots=loop_slots),
        insert_batch_reference(*args, loop_slots=loop_slots),
    )


# 8: a window smaller than the carried docs, which must all overflow
@pytest.mark.parametrize("loop_slots", [None, 40, 8])
def test_kernel_carried_state(cuda, loop_slots):
    first = insert_batch_reference(*_inputs(cuda, 8, 96, 20, seed=7))
    second = _inputs(cuda, 8, 96, 16, seed=11, ctr_offset=20)[4:]
    args = [*first, *second]
    _assert_same(
        insert_batch(*args, loop_slots=loop_slots),
        insert_batch_reference(*args, loop_slots=loop_slots),
    )


def test_kernel_overflow_full_and_missing_reference(cuda):
    args = _inputs(cuda, 6, 8, 16, seed=9)  # 16 inserts into 8 slots: full
    args[4][1, 3] = 12345 << 10  # doc 1 references an element that never exists
    out = insert_batch(*args)
    _assert_same(out, insert_batch_reference(*args))
    assert out[3].all()


def test_kernel_global_memory_variant(cuda):
    """smem_budget=0 forces the state into device memory: same body, same bits."""
    for loop_slots in (None, 64):
        args = _inputs(cuda, 16, 256, 120, seed=5)
        _assert_same(
            insert_batch(*args, loop_slots=loop_slots, smem_budget=0),
            insert_batch_reference(*args, loop_slots=loop_slots),
        )


def test_refused_launch_raises(cuda):
    """A window larger than the card's shared memory, with a budget that
    claims it fits, is refused at launch by CUDA: the wrapper must raise, not
    return unchanged buffers."""
    args = _inputs(cuda, 2, 32768, 8, seed=1)
    with pytest.raises(RuntimeError, match="refused"):
        insert_batch(*args, smem_budget=1 << 20)


def test_launch_counter_and_empty_stream(cuda):
    args = _inputs(cuda, 4, 32, 0, seed=2)
    before = insert_batch.launches
    out = insert_batch(*args)
    assert insert_batch.launches == before + 1
    _assert_same(out, args[:4])


@pytest.fixture(params=sorted(TEAMS))
def team(request, monkeypatch):
    """Run the test with the default team split, with every window on the
    warp team, and on the block team at its own and at wide block sizes."""
    limit, threads = TEAMS[request.param]
    if limit is not None:
        monkeypatch.setattr(insert_mod, "WARP_TEAM_MAX_SLOTS", limit)
    if threads is not None:
        monkeypatch.setattr(insert_mod, "block_team_threads", threads)
    return request.param


# a warp's width -1/exact/+1, and the team threshold -1/exact/+1; every
# window fills and its last two inserts overflow
@pytest.mark.parametrize("slots", [31, 32, 33, WARP_TEAM_MAX_SLOTS - 1, WARP_TEAM_MAX_SLOTS,
                                   WARP_TEAM_MAX_SLOTS + 1])
def test_kernel_team_edges(cuda, team, slots):
    args = _inputs(cuda, 3, slots, slots + 2, seed=12)
    out = insert_batch(*args)
    _assert_same(out, insert_batch_reference(*args))
    assert out[3].all() and (out[2] == slots).all()


# live ops around the 32-op register chunk of the stream
@pytest.mark.parametrize("inserts", [31, 32, 33, 63, 64, 65])
def test_kernel_stream_chunk_edges(cuda, team, inserts):
    args = _inputs(cuda, 5, 128, inserts, seed=13)
    _assert_same(insert_batch(*args), insert_batch_reference(*args))


def _last_chunk_inputs(device, docs, slots):
    """Docs holding n = slots - 3 - d live elements with descending ids,
    and three ops each: a HEAD insert whose skip slot is the last live slot
    (n - 1), an insert after the last live element (the reference scan's
    hit in the last chunk), and a HEAD insert of the newest id, which
    shifts the whole window (doc 0 ends full)."""
    elem = np.zeros((docs, slots), np.int32)
    chars = np.zeros((docs, slots), np.int32)
    n = np.array([slots - 3 - d for d in range(docs)], np.int32)
    refs = np.zeros((docs, 3), np.int32)
    ops = np.zeros((docs, 3), np.int32)
    chs = np.full((docs, 3), ord("x"), np.int32)
    for d, nd in enumerate(n):
        j = np.arange(nd)
        elem[d, :nd] = ((nd - j + 10) << 10) | 1  # descending; slot nd - 1 holds (11 << 10) | 1
        chars[d, :nd] = ord("a") + j % 26
        ops[d] = [12 << 10, (nd + 20) << 10 | 3, (nd + 21) << 10 | 3]
        refs[d] = [0, (11 << 10) | 1, 0]
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return [t(elem), t(chars), t(n), torch.zeros(docs, dtype=torch.bool, device=device),
            t(refs), t(ops), t(chs)]


@pytest.mark.parametrize("slots", [64, 96, 200])
def test_kernel_first_match_in_last_chunk(cuda, team, slots):
    args = _last_chunk_inputs(cuda, 4, slots)
    out = insert_batch(*args)
    want = insert_batch_reference(*args)
    _assert_same(out, want)
    n0 = args[2].cpu().numpy()
    got = out[0].cpu().numpy()
    for d in range(4):
        # the skip slot was the last live one; the last op moved it up one
        assert got[d, n0[d]] == 12 << 10
    assert not out[3].any()
