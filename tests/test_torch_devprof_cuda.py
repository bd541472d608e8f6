"""The device planes on the card, at small size: what chip_smoke.py's
phase 5h checks at full width.

* One bucket per (site, shape, launch plan): a second session fed the
  same arrival lands every call in the first session's buckets; each
  bucket's ``kernel_launches`` is its plan's length, and the sites'
  launches (dispatches x ``kernel_launches``) equal the kernel wrappers'
  launch counts (K1 on the padded and paged sessions, K3 on the ragged).
* Every costed bucket has ``device_ms`` above 0 and ``kernel_bytes`` above
  0.
* The memory watermarks are the CUDA allocator's: the snapshot's peak is
  ``torch.cuda.memory_stats``' peak at the last sample.
* The build sentinel sees no build or load after the first round.

Every test here needs an NVIDIA card (``cuda`` marker) and skips without
one.  The file imports nothing of JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_devprof_cuda.py -q
"""

import random

import pytest
import torch

from peritext_tpu_torch.obs import GLOBAL_COUNTERS, GLOBAL_DEVPROF, RecompileSentinel
from peritext_tpu_torch.ops.insert import insert_batch
from peritext_tpu_torch.ops.ragged_insert import ragged_insert
from peritext_tpu_torch.parallel.streaming import StreamingMerge
from peritext_tpu_torch.testing.fuzz import generate_workload

pytestmark = pytest.mark.cuda

ACTORS = ("doc1", "doc2", "doc3")
KW = dict(slot_capacity=256, mark_capacity=64, tomb_capacity=64, round_insert_capacity=32,
          round_delete_capacity=16, round_mark_capacity=16, round_map_capacity=8)
SITE = {"padded": "apply_batch_staged_rounds", "paged": "apply_batch_paged_groups",
        "ragged": "apply_batch_ragged"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the insert kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def armed():
    GLOBAL_DEVPROF.reset()
    GLOBAL_DEVPROF.enable(capture_costs=True)
    try:
        yield GLOBAL_DEVPROF
    finally:
        GLOBAL_DEVPROF.disable()
        GLOBAL_DEVPROF.reset()


def _arrival(seed=3, docs=10, ops=48, rounds=3):
    workloads = generate_workload(seed, num_docs=docs, ops_per_doc=ops)
    workloads += generate_workload(seed + 100, num_docs=1, ops_per_doc=180)
    rng = random.Random(seed)
    out = []
    for w in workloads:
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        size = -(-len(chs) // rounds)
        out.append([chs[i:i + size] for i in range(0, len(chs), size)])
    return out


def _run(device, layout, arrival, sentinel=None):
    s = StreamingMerge(num_docs=len(arrival), actors=ACTORS, layout=layout, device=device, **KW)
    for r in range(max(len(b) for b in arrival)):
        for d, batches in enumerate(arrival):
            if r < len(batches):
                s.ingest(d, batches[r])
        s.drain()
        if r == 0 and sentinel is not None:
            sentinel.mark()
    return s


def _site_launches(site):
    return sum(b["dispatches"] * b["cost"]["kernel_launches"] for b in site["buckets"].values())


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_buckets_launches_and_costs(cuda, armed, layout):
    arrival = _arrival()
    insert_batch.launches = ragged_insert.launches = 0
    with RecompileSentinel() as sentinel:
        first = _run(cuda, layout, arrival, sentinel)
        # no library built or loaded after the first round (a fused form's
        # graph capture, counted as graph.<form>, is no build)
        assert {k: n for k, n in sentinel.since_mark().items()
                if not k.startswith("graph.")} == {}
    snap = armed.snapshot()
    site = snap["sites"][SITE[layout]]
    assert set(snap["sites"]) == {SITE[layout]}
    buckets = site["distinct_shapes"]
    launched = ragged_insert.launches if layout == "ragged" else insert_batch.launches
    assert _site_launches(site) == launched > 0
    assert (ragged_insert.launches if layout != "ragged" else insert_batch.launches) == 0
    for bucket in site["buckets"].values():
        cost = bucket["cost"]
        assert cost["device_ms"] > 0 and cost["kernel_bytes"] > 0
        assert cost["kernel_launches"] == bucket["sig"].count("('warp'") + bucket["sig"].count(
            "('block'")
        assert bucket["memory"]["peak_bytes"] > 0
    # the same arrival through a fresh session: the same buckets
    before = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
    second = _run(cuda, layout, arrival)
    again = armed.snapshot()["sites"][SITE[layout]]
    assert again["distinct_shapes"] == buckets
    assert again["dispatches"] == 2 * site["dispatches"]
    if layout == "padded":
        # one call of the fused form per committed batch
        assert site["dispatches"] == GLOBAL_COUNTERS.get("streaming.fused_dispatches") - before
    assert first.digest() == second.digest()


def test_memory_watermarks_are_the_allocator_counters(cuda, armed):
    s = StreamingMerge(num_docs=11, actors=ACTORS, device=cuda, **KW)
    for d, batches in enumerate(_arrival()):
        s.ingest(d, batches[0])
    s.drain()
    mem = armed.snapshot()["memory"]
    stats = torch.cuda.memory_stats(cuda)
    assert mem["available"] is True and mem["samples"] >= 1
    assert mem["peak_bytes_in_use"] == stats["allocated_bytes.all.peak"] > 0
    assert mem["bytes_in_use"] == stats["allocated_bytes.all.current"]


def test_cpu_answer_never_given_for_a_card(cuda, armed):
    armed.sample_memory(cuda)
    assert armed.snapshot()["memory"]["available"] is True
