"""The host side of the insert kernels' team design, on the CPU: how a
batch's docs split into the warp class and the block class, and how each
class's launch is sized (peritext_tpu_torch/ops/insert.py ``plan_teams``,
ops/ragged_insert.py ``ragged_teams``), and that the ragged merge hands the
kernel wrapper the plan's host page counts.  The kernels themselves are
held against their plain versions on the card (test_torch_insert_cuda.py,
test_torch_ragged_cuda.py)."""

import numpy as np
import pytest
import torch

from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.ops import ragged as ragged_ops
from peritext_tpu_torch.ops.insert import (
    BLOCK_TEAM_MAX_THREADS,
    SMEM_BUDGET,
    WARP_TEAM_DOCS,
    WARP_TEAM_MAX_SLOTS,
    block_team_threads,
    insert_teams,
    plan_teams,
)
from peritext_tpu_torch.ops.ragged_insert import ragged_teams, ragged_windows
from peritext_tpu_torch.store import ragged_plan
from peritext_tpu_torch.testing import generate_workload

SMS = 132  # an H100 SXM's


def _page_counts(seed, docs, gmax):
    """Host page counts of a mixed drain: most docs of a few pages, a tail
    past the threshold, some with none."""
    rng = np.random.default_rng(seed)
    pc = rng.integers(0, 4, size=docs)
    long = rng.random(docs) < 0.1
    pc[long] = rng.integers(WARP_TEAM_MAX_SLOTS // 64 + 1, gmax + 1, size=int(long.sum()))
    return pc.astype(np.int32)


@pytest.mark.parametrize("seed,docs", [(0, 1), (1, 40), (2, 1000), (3, 10240)])
def test_every_doc_in_exactly_one_class(seed, docs):
    pc = _page_counts(seed, docs, 64)
    launches = ragged_teams(pc, 64, 64, SMEM_BUDGET, SMS)
    rows = [np.arange(docs) if t.rows is None else t.rows for t in launches]
    assert [len(r) for r in rows] == [t.num_docs for t in launches]
    every = np.concatenate(rows)
    assert np.array_equal(np.sort(every), np.arange(docs))  # each row once
    windows = ragged_windows(pc, 64, 64)
    for t, r in zip(launches, rows):
        assert np.all(np.diff(r) > 0)  # batch order
        if t.team == "warp":
            assert np.all(windows[r] <= WARP_TEAM_MAX_SLOTS)
        else:
            assert np.all(windows[r] > WARP_TEAM_MAX_SLOTS)


@pytest.mark.parametrize("gmax", [16, 64, 512])
def test_class_sized_by_its_own_widest_window(gmax):
    """Neither class is sized by the table width: the warp class by its
    widest short doc, the block class's threads by its widest long doc."""
    pc = np.array([3, 1, 0, 2, 33, 40, 3], np.int32)  # widest long doc: 40 pages < gmax
    if gmax < 40:
        pc = np.minimum(pc, 6)  # a table of 16 pages: only short docs, the widest of 6
    warp, *block = ragged_teams(pc, 64, gmax, SMEM_BUDGET, SMS)
    widest_short = 64 * int(pc[pc * 64 <= WARP_TEAM_MAX_SLOTS].max())
    assert (warp.team, warp.window, warp.threads_per_doc) == ("warp", widest_short, 32)
    assert bool(block) == (gmax >= 40)
    assert warp.window < gmax * 64
    if block:
        (block,) = block
        assert (block.team, block.window, block.num_docs) == ("block", 40 * 64, 2)
        assert block.threads == block_team_threads(40 * 64) == block.threads_per_doc == 320
        assert block.docs_per_block == 1
        assert block.window < gmax * 64


def test_empty_classes_launch_nothing():
    short = np.array([1, 2, 3, 0], np.int32)
    (only,) = ragged_teams(short, 64, 64, SMEM_BUDGET, SMS)
    assert only.team == "warp" and only.rows is None and only.num_docs == 4
    long = np.array([40, 33], np.int32)
    (only,) = ragged_teams(long, 64, 64, SMEM_BUDGET, SMS)
    assert only.team == "block" and only.rows is None and only.num_docs == 2
    assert ragged_teams(np.zeros(0, np.int32), 64, 64, SMEM_BUDGET, SMS) == []
    assert insert_teams(0, 512, SMEM_BUDGET, SMS) == []


def test_split_reads_only_host_numpy():
    """A device tensor (here a CPU one standing in for it) is refused: the
    split never reads the card."""
    pc = np.array([1, 40], np.int32)
    for bad in (torch.from_numpy(pc), pc.tolist()):
        with pytest.raises(TypeError, match="host numpy"):
            ragged_teams(bad, 64, 64, SMEM_BUDGET, SMS)
        with pytest.raises(TypeError, match="host numpy"):
            plan_teams(bad, SMEM_BUDGET, SMS)


@pytest.mark.parametrize("docs", [1, 8, 131, 133, 1024, 8192])
def test_warp_blocks(docs):
    """Up to WARP_TEAM_DOCS docs a block, fewer when the class has fewer
    docs per SM; a block's windows fit the card's shared memory."""
    (t,) = insert_teams(docs, 384, SMEM_BUDGET, SMS)
    assert t.team == "warp" and t.shared
    assert t.docs_per_block == min(WARP_TEAM_DOCS, -(-docs // SMS))
    assert t.threads == 32 * t.docs_per_block
    assert 2 * 4 * t.window * t.docs_per_block <= SMEM_BUDGET


@pytest.mark.parametrize("s_loop", [8, 32, WARP_TEAM_MAX_SLOTS, WARP_TEAM_MAX_SLOTS + 8, 32768])
def test_insert_teams_one_launch_follows_s_loop(s_loop):
    (t,) = insert_teams(1024, s_loop, SMEM_BUDGET, SMS)
    assert t.rows is None and t.num_docs == 1024 and t.window == s_loop
    assert t.team == ("warp" if s_loop <= WARP_TEAM_MAX_SLOTS else "block")
    assert t.shared == (2 * 4 * s_loop <= SMEM_BUDGET)


def test_global_variant_per_class():
    """The budget decides per class, by the class's widest window."""
    pc = np.array([2, 3, 40], np.int32)
    launches = ragged_teams(pc, 64, 64, 0, SMS)
    assert [(t.team, t.shared) for t in launches] == [("warp", False), ("block", False)]
    budget = 2 * 4 * 3 * 64  # the short docs' windows fit, the long one's does not
    launches = ragged_teams(pc, 64, 64, budget, SMS)
    assert [(t.team, t.shared) for t in launches] == [("warp", True), ("block", False)]


def test_ragged_merge_passes_host_page_counts(monkeypatch):
    """The ragged merge hands the insert wrapper the plan's page counts as
    host numpy, so sizing the launches needs no read from the card."""
    seen = []
    real = ragged_ops.ragged_insert

    def spy(*args, **kw):
        seen.append(kw.get("page_count_host"))
        return real(*args, **kw)

    monkeypatch.setattr(ragged_ops, "ragged_insert", spy)
    batch = DocBatch(slot_capacity=256, mark_capacity=64, page_size=32, layout="ragged",
                     device="cpu")
    batch.merge(generate_workload(3, 5, 60))
    (pc,) = seen
    assert isinstance(pc, np.ndarray)
    np.testing.assert_array_equal(pc, ragged_plan(batch.last_store).page_count)


@pytest.mark.parametrize("window,threads", [(1, 32), (256, 32), (264, 64), (2048, 256),
                                            (4096, 512), (32768, 512)])
def test_block_team_threads(window, threads):
    """One thread per 8 window slots, in whole warps, 32 to 512."""
    assert block_team_threads(window) == threads <= BLOCK_TEAM_MAX_THREADS
