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

from peritext_tpu_torch.ops.insert import insert_batch, insert_batch_reference
from peritext_tpu_torch.ops.packed import empty_docs
from peritext_tpu_torch.testing.synth import synth_streams

pytestmark = pytest.mark.cuda


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
