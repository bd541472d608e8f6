"""The CUDA ragged insert kernel (peritext_tpu_torch/csrc/ragged_insert.cu)
against its plain torch version, on the card, bit for bit: the pool planes
(every page, the null page and unowned pages included), n and overflow.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ragged_cuda.py -q
"""

import numpy as np
import pytest
import torch

from peritext_tpu_torch.ops import insert as insert_mod
from peritext_tpu_torch.ops import ragged_insert as ragged_mod
from peritext_tpu_torch.ops.insert import WARP_TEAM_MAX_SLOTS
from peritext_tpu_torch.ops.ragged import plan_arrays
from peritext_tpu_torch.ops.ragged_insert import ragged_insert, ragged_insert_reference
from peritext_tpu_torch.store.paged import PagedDocStore
from peritext_tpu_torch.store.ragged import ragged_plan
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
        pytest.skip("needs an NVIDIA card: the ragged insert kernel has no CPU mode")
    return torch.device("cuda")


def _streams(counts, width, seed, ctr_offset=0):
    """Left-packed insert streams: doc i has ``counts[i]`` live ops, then
    zero padding up to ``width``."""
    refs, ops, chars = synth_streams(len(counts), inserts_per_doc=width, seed=seed,
                                     ctr_offset=ctr_offset)[:3]
    live = np.arange(width)[None, :] < np.asarray(counts)[:, None]
    return [np.where(live, a, 0).astype(np.int32) for a in (refs, ops, chars)]


def _args(store, device, counts, streams, n0=None, ov0=None):
    d = len(counts)
    planes = plan_arrays(ragged_plan(store), device)
    n0 = torch.zeros(d, dtype=torch.int32, device=device) if n0 is None else n0
    ov0 = torch.zeros(d, dtype=torch.bool, device=device) if ov0 is None else ov0
    return [store.pool_elem, store.pool_char, *planes[1:], n0, ov0,
            torch.as_tensor(np.asarray(counts, np.int32)).to(device),
            *(torch.as_tensor(a).to(device) for a in streams)]


def _run_both(args, **kw):
    """Kernel and plain version on separate copies of the pool; asserts all
    outputs equal and returns the kernel's (pool_elem, pool_char, n, ov)."""
    mine = [a.clone() for a in args]
    plain = [a.clone() for a in args]
    n, ov = ragged_insert(*mine, **kw)
    n_ref, ov_ref = ragged_insert_reference(*plain)
    torch.cuda.synchronize()
    for got, want, name in ((mine[0], plain[0], "pool_elem"), (mine[1], plain[1], "pool_char"),
                            (n, n_ref, "n"), (ov, ov_ref, "ov")):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(), err_msg=name)
    return mine[0], mine[1], n, ov


def _store(device, counts, page_size=16, slot_capacity=256, initial_pages=None):
    store = PagedDocStore(len(counts), slot_capacity, 8, page_size=page_size,
                          initial_pages=initial_pages, device=device)
    store.ensure_rows(np.arange(len(counts)), counts)
    return store


@pytest.mark.parametrize("counts,width,page_size,slot_capacity", [
    ([12, 12, 12, 12], 12, 16, 256),               # uniform
    ([5, 40, 0, 200, 17, 3], 256, 16, 256),        # long-doc mix, stream wider than every count
    ([90, 30, 70], 90, 32, 64),                    # cap overflow: 90, 70 inserts into 64 slots
    ([179] * 33, 179, 64, 384),                    # batch row shape, small
])
def test_kernel_matches_plain(cuda, counts, width, page_size, slot_capacity):
    store = _store(cuda, counts, page_size, slot_capacity)
    pool_elem, _, _, ov = _run_both(_args(store, cuda, counts, _streams(counts, width, seed=3)))
    assert not pool_elem[0].any()  # the null page stays zero
    if slot_capacity == 64:
        assert ov.cpu().tolist() == [True, False, True]


def test_kernel_missing_reference(cuda):
    counts = [20, 20, 20]
    streams = _streams(counts, 20, seed=4)
    streams[0][1, 5] = 4242 << 10  # an element id no doc holds
    _, _, _, ov = _run_both(_args(_store(cuda, counts), cuda, counts, streams))
    assert ov.cpu().tolist() == [False, True, False]


def test_kernel_carried_state_after_pool_growth(cuda):
    """A second round on carried state, after a growth that interleaves the
    docs' pages: each doc's pages are no longer contiguous in the pool."""
    first, second = [30, 5, 18], [40, 60, 2]
    store = _store(cuda, first, initial_pages=5)
    args = _args(store, cuda, first, _streams(first, 30, seed=7))
    n1, ov1 = ragged_insert_reference(*args)
    store.ensure_rows(np.arange(3), np.add(first, second))
    assert store.growths >= 1
    pages = [store.alloc.pages_of(r) for r in range(3)]
    assert any(np.any(np.diff(p) != 1) for p in pages)
    streams = _streams(second, 64, seed=11, ctr_offset=30)
    _run_both(_args(store, cuda, second, streams, n0=n1, ov0=ov1))


def test_kernel_unowned_pages_untouched(cuda):
    """Pages of docs outside the batch, and free pages, keep their bits
    (here: nonzero data, which no plan may gather or scatter)."""
    store = _store(cuda, [25, 25, 25, 25])
    batch_pages = store.alloc.pages_of(1) + store.alloc.pages_of(3)
    other = torch.ones(store.pool_elem.shape[0], dtype=torch.bool, device=cuda)
    other[[0] + batch_pages] = False
    store.pool_elem[other] = torch.randint(1, 1000, store.pool_elem[other].shape,
                                           dtype=torch.int32, device=cuda)
    store.pool_char[other] = 7
    before = store.pool_elem.clone(), store.pool_char.clone()
    planes = plan_arrays(ragged_plan(store, rows=[1, 3]), cuda)
    streams = _streams([25, 25], 25, seed=5)
    args = [store.pool_elem, store.pool_char, *planes[1:],
            torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.zeros(2, dtype=torch.bool, device=cuda),
            torch.full((2,), 25, dtype=torch.int32, device=cuda),
            *(torch.as_tensor(a).to(cuda) for a in streams)]
    pool_elem, pool_char, _, _ = _run_both(args)
    assert torch.equal(pool_elem[other], before[0][other])
    assert torch.equal(pool_char[other], before[1][other])
    assert not pool_elem[0].any() and not pool_char[0].any()


@pytest.mark.parametrize("counts,width", [([5, 40, 0, 120, 17], 128), ([90, 30, 64], 90)])
def test_kernel_global_memory_variant(cuda, counts, width):
    """smem_budget=0 puts each doc's window in device-memory scratch: same
    body, same bits."""
    store = _store(cuda, counts)
    _run_both(_args(store, cuda, counts, _streams(counts, width, seed=6)), smem_budget=0)


def test_refused_launch_raises(cuda):
    """A window larger than the card's shared memory, with a budget that
    claims it fits, is refused at launch: the wrapper raises and does not
    count a launch.  Launches are sized by the docs' true windows, so both
    docs hold 469 pages (30,016 slots, 240 KB)."""
    counts = [8, 8]
    store = _store(cuda, [30000, 30000], page_size=64, slot_capacity=32768)
    args = _args(store, cuda, counts, _streams(counts, 8, seed=1))
    before = ragged_insert.launches
    with pytest.raises(RuntimeError, match="refused"):
        ragged_insert(*args, smem_budget=1 << 20)
    assert ragged_insert.launches == before


def test_launch_counter_and_empty_stream(cuda):
    counts = [0, 0, 0]
    store = _store(cuda, counts)
    args = _args(store, cuda, counts, _streams(counts, 0, seed=2))
    before = ragged_insert.launches
    n, ov = ragged_insert(*args)
    assert ragged_insert.launches == before + 1
    assert not n.any() and not ov.any() and not store.pool_elem.any()


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


def test_kernel_team_edges(cuda, team):
    """Windows of a warp's width -1/exact/+1 and the team threshold
    -1/exact/+1 in one call (pages of one slot, so a window is its insert
    count); each doc fills its window and overflows on its last two
    inserts."""
    windows = [31, 32, 33, WARP_TEAM_MAX_SLOTS - 1, WARP_TEAM_MAX_SLOTS, WARP_TEAM_MAX_SLOTS + 1]
    store = _store(cuda, windows, page_size=1, slot_capacity=WARP_TEAM_MAX_SLOTS + 8)
    counts = [w + 2 for w in windows]
    _, _, n, ov = _run_both(_args(store, cuda, counts, _streams(counts, max(counts), seed=12)))
    assert n.cpu().tolist() == windows and ov.all()


def test_kernel_stream_chunk_edges(cuda, team):
    """Live ops around the 32-op register chunk of the stream."""
    counts = [31, 32, 33, 63, 64, 65]
    store = _store(cuda, counts, page_size=16, slot_capacity=128)
    _run_both(_args(store, cuda, counts, _streams(counts, 80, seed=13)))


def test_kernel_mixed_classes_shuffled(cuda, monkeypatch):
    """One call mixing both classes at the default threshold: 4 docs one
    page past it (block team) among 60 short ones of up to 3 pages, a third
    with zero inserts, in a seeded shuffle.  With one SM claimed, warp-team
    blocks hold 8 docs each, so zero-insert docs share blocks with busy
    ones."""
    monkeypatch.setattr(ragged_mod, "num_sms", lambda device: 1)
    rng = np.random.default_rng(14)
    short = rng.integers(1, 150, size=60)
    short[rng.random(60) < 1 / 3] = 0
    long = WARP_TEAM_MAX_SLOTS + 52
    counts = rng.permutation(np.concatenate([short, [long] * 4])).tolist()
    store = _store(cuda, counts, page_size=64, slot_capacity=2 * WARP_TEAM_MAX_SLOTS)
    plan = ragged_plan(store)
    teams = ragged_mod.ragged_teams(plan.page_count, 64, plan.page_table.shape[1],
                                    ragged_mod.SMEM_BUDGET, 1)
    assert [(t.team, t.num_docs, t.docs_per_block) for t in teams] == [
        ("warp", 60, 8), ("block", 4, 1)]
    before = ragged_insert.launches
    _run_both(_args(store, cuda, counts, _streams(counts, long, seed=15)))
    assert ragged_insert.launches == before + 2


def test_kernel_carried_state_after_pool_growth_both_classes(cuda, monkeypatch):
    """The carried-state round after a pool growth, with the threshold at
    48 slots: the two docs that grow to 5 pages (80 slots) run the block
    team, the one of 2 pages the warp team, in the same call."""
    monkeypatch.setattr(insert_mod, "WARP_TEAM_MAX_SLOTS", 48)
    first, second = [30, 5, 18], [40, 60, 2]
    store = _store(cuda, first, initial_pages=5)
    args = _args(store, cuda, first, _streams(first, 30, seed=7))
    n1, ov1 = ragged_insert_reference(*args)
    store.ensure_rows(np.arange(3), np.add(first, second))
    assert store.growths >= 1
    assert [len(store.alloc.pages_of(r)) for r in range(3)] == [5, 5, 2]
    streams = _streams(second, 64, seed=11, ctr_offset=30)
    before = ragged_insert.launches
    _run_both(_args(store, cuda, second, streams, n0=n1, ov0=ov1))
    assert ragged_insert.launches == before + 2
