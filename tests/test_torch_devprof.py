"""The port's device profiler (``peritext_tpu_torch/obs/devprof.py``)
against the reference package's, on the CPU.

* The reference's ``TestDeviceProfiler`` cases, held against the port:
  shape-bucket keys, the occupancy table, cost and memory capture of a
  site call (device ms is None on the CPU), the CPU memory watermark
  (``available: false``), disabled hooks; plus what the port adds: a site
  called inside another site's call belongs to the outer one, a failed
  call propagates and leaves the bucket uncosted, and a card whose
  allocator counters cannot be read raises.
* The snapshot's key sets at every level equal the reference's golden
  sets, and ``health_snapshot(devprof=)`` composes the same.
* The six seeded paths: a padded, paged and ragged ``DocBatch.merge`` of
  16 docs x 48 ops and a padded, paged and ragged ``StreamingMerge`` of 3
  arrival rounds, each run with both packages' ``GLOBAL_DEVPROF`` armed:
  ``occupancy``, ``occupancy_totals``, ``page_pool`` and ``ragged`` equal
  exactly.  The port's site table on each path: a merge's one site, its
  dispatches equal to the commit counters (one per page group of a paged
  merge); a padded or paged session's fused forms, one call per committed
  batch, named and counted as the reference's dispatches; a ragged
  session's one call per round; no launch recorded on the CPU.

The reference records sites of its own (jit executables); the port's are
its ops-level entry points, so only the streaming sessions' fused forms
share site tables across the packages (ROADMAP.md section 3).
"""

import random

import numpy as np
import pytest
import torch

from peritext_tpu.api.batch import DocBatch as JaxDocBatch
from peritext_tpu.obs import GLOBAL_DEVPROF as JAX_DEVPROF
from peritext_tpu.obs import DeviceProfiler as JaxProfiler
from peritext_tpu.obs import health_snapshot as jax_health_snapshot
from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.api.batch import DocBatch
from peritext_tpu_torch.core.types import Change
from peritext_tpu_torch.obs import (
    GLOBAL_COUNTERS,
    GLOBAL_DEVPROF,
    DeviceProfiler,
    health_snapshot,
    note_launch,
    occupancy_key,
)
from peritext_tpu_torch.obs import devprof as devprof_mod
from peritext_tpu_torch.ops.insert import insert_batch_bytes
from peritext_tpu_torch.parallel.streaming import StreamingMerge

ACTORS = ("doc1", "doc2", "doc3")
#: the six seeded paths' sizes
MERGE = dict(docs=16, ops=48, seed=12)
STREAM = dict(docs=12, ops=48, seed=14, rounds=3)
CAPS = dict(slot_capacity=256, mark_capacity=64)
STREAM_CAPS = dict(slot_capacity=256, mark_capacity=64, tomb_capacity=64,
                   round_insert_capacity=32, round_delete_capacity=16,
                   round_mark_capacity=16, round_map_capacity=8)
COMPARED = ("occupancy", "occupancy_totals", "page_pool", "ragged")


@pytest.fixture
def armed():
    """Both packages' process profilers armed for one test, reset and
    disarmed after (they are off by default for every other test)."""
    for p in (GLOBAL_DEVPROF, JAX_DEVPROF):
        p.reset()
        p.enable(capture_costs=False)
    try:
        yield GLOBAL_DEVPROF, JAX_DEVPROF
    finally:
        for p in (GLOBAL_DEVPROF, JAX_DEVPROF):
            p.disable()
            p.reset()


def _cross(workloads):
    return [{a: [Change.from_json(c.to_json()) for c in log] for a, log in w.items()}
            for w in workloads]


# ---------------------------------------------------------------------------
# DeviceProfiler unit behaviour (the reference's TestDeviceProfiler)
# ---------------------------------------------------------------------------


class TestDeviceProfiler:
    def test_off_by_default(self):
        assert DeviceProfiler().enabled is False
        assert GLOBAL_DEVPROF.enabled is False

    def test_shape_signature_matches_launch_granularity(self):
        p = DeviceProfiler()
        a32 = torch.zeros((4, 8), dtype=torch.int32)
        b32 = torch.zeros((4, 8), dtype=torch.int32)
        key_a, sig = p.shape_signature((a32,), static=(("w", 16),))
        key_b, _ = p.shape_signature((b32,), static=(("w", 16),))
        assert key_a == key_b  # same shapes + statics: one bucket
        assert "int32(4, 8)" in sig
        others = [
            ((torch.zeros((4, 16), dtype=torch.int32),), (("w", 16),)),
            ((torch.zeros((4, 8), dtype=torch.int64),), (("w", 16),)),
            ((a32,), (("w", 32),)),
            ((a32, None), (("w", 16),)),
            (({"m": a32},), (("w", 16),)),
            ((a32,), (("w", 16), ("plan", (("warp", 4, 64, True, 32, 1),)))),
        ]
        keys = {key_a} | {p.shape_signature(t, static=s)[0] for t, s in others}
        assert len(keys) == 1 + len(others)
        # the reference spells numpy descriptors the same way
        assert (JaxProfiler.shape_signature((np.zeros((4, 8), np.int32),), (("w", 16),))
                == p.shape_signature((np.zeros((4, 8), np.int32),), (("w", 16),)))

    def test_occupancy_table_generalizes_padding_efficiency(self):
        snaps = []
        for p in (DeviceProfiler().enable(), JaxProfiler().enable()):
            p.observe_round("D8.ki16.kd8.km8.kp8", real_ops=60, padded_capacity=320)
            p.observe_round("D8.ki16.kd8.km8.kp8", real_ops=20, padded_capacity=320)
            p.observe_round("D8.ki8.kd8.km8.kp8", real_ops=64, padded_capacity=256,
                            origin="batch.merge")
            snaps.append(p.snapshot())
        ours, ref = snaps
        bucket = ours["occupancy"]["D8.ki16.kd8.km8.kp8"]
        assert (bucket["rounds"], bucket["real_ops"], bucket["padded_capacity"]) == (2, 80, 640)
        assert bucket["padding_waste"] == pytest.approx(1 - 80 / 640)
        assert ours["occupancy_totals"]["rounds"] == 3
        for key in ("occupancy", "occupancy_totals"):
            assert ours[key] == ref[key]

    def test_cost_and_memory_capture_on_a_site_call(self):
        p = DeviceProfiler(capture_costs=True).enable()
        x = torch.ones((16, 16), dtype=torch.int32)

        def call():
            return note_launch("probe", (x,), (("w", 16),), lambda: x * 2 + 1,
                               device=x.device, kernel_launches=1,
                               kernel_bytes=insert_batch_bytes(16, 16, 1), profiler=p)

        assert torch.equal(call(), x * 2 + 1)
        call()
        site = p.snapshot()["sites"]["probe"]
        assert (site["distinct_shapes"], site["dispatches"]) == (1, 2)
        (bucket,) = site["buckets"].values()
        assert bucket["cost"] == {"device_ms": None, "kernel_bytes": insert_batch_bytes(16, 16, 1),
                                  "kernel_launches": 1}
        mem = bucket["memory"]
        assert mem["argument_size_in_bytes"] == mem["output_size_in_bytes"] == 16 * 16 * 4
        assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        assert "flops" not in bucket["cost"]

    def test_capture_off_records_dispatches_only(self):
        p = DeviceProfiler().enable()
        x = torch.ones(4)
        note_launch("probe", (x,), (), lambda: x, device=x.device, profiler=p)
        (bucket,) = p.snapshot()["sites"]["probe"]["buckets"].values()
        assert bucket["dispatches"] == 1 and bucket["cost"] is None and bucket["memory"] is None

    def test_memory_watermark_degrades_gracefully_without_stats(self):
        p = DeviceProfiler().enable()
        assert p.sample_memory("cpu") is None
        p.sample_memory()
        mem = p.snapshot()["memory"]
        assert mem == {"available": False, "samples": 2, "bytes_in_use": None,
                       "peak_bytes_in_use": None}
        ref = JaxProfiler().enable()
        ref.sample_memory()
        ref.sample_memory()
        assert ref.snapshot()["memory"] == mem

    def test_card_without_allocator_counters_raises(self, monkeypatch):
        """No fallback: a card's sample never reports ``available: false``."""
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: {})
        p = DeviceProfiler().enable()
        with pytest.raises(RuntimeError, match="allocator counter"):
            p.sample_memory("cuda")
        assert p.snapshot()["memory"]["available"] is False

    def test_card_allocator_counters_are_the_watermarks(self, monkeypatch):
        stats = iter([{"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 300},
                      {"allocated_bytes.all.current": 50, "allocated_bytes.all.peak": 400}])
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: next(stats))
        p = DeviceProfiler().enable()
        assert p.sample_memory("cuda:0") == 100
        assert p.sample_memory(torch.device("cuda", 0)) == 50
        assert p.snapshot()["memory"] == {"available": True, "samples": 2, "bytes_in_use": 50,
                                          "peak_bytes_in_use": 400}

    def test_disabled_hooks_record_nothing(self):
        p = DeviceProfiler()  # never enabled
        x = torch.ones(2)
        assert note_launch("x", (x,), (), lambda: 7, device=x.device, profiler=p) == 7
        assert p.snapshot()["sites"] == {}

    def test_nested_site_belongs_to_the_outer_call(self):
        p = DeviceProfiler(capture_costs=True).enable()
        x = torch.ones(3)

        def inner():
            return note_launch("inner", (x,), (), lambda: x + 1, device=x.device,
                               kernel_launches=1, profiler=p)

        out = note_launch("outer", (x,), (), lambda: inner() + inner(), device=x.device,
                          kernel_launches=2, profiler=p)
        assert torch.equal(out, 2 * x + 2)
        sites = p.snapshot()["sites"]
        assert set(sites) == {"outer"} and sites["outer"]["dispatches"] == 1
        # the thread is outside every site again
        note_launch("inner", (x,), (), lambda: x, device=x.device, profiler=p)
        assert p.distinct_shapes() == {"inner": 1, "outer": 1}

    def test_failed_call_propagates_and_stays_uncosted(self):
        p = DeviceProfiler(capture_costs=True).enable()
        x = torch.ones(3)

        def boom():
            raise RuntimeError("launch refused")

        with pytest.raises(RuntimeError, match="launch refused"):
            note_launch("probe", (x,), (), boom, device=x.device, profiler=p)
        (bucket,) = p.snapshot()["sites"]["probe"]["buckets"].values()
        assert bucket["dispatches"] == 1 and bucket["cost"] is None
        assert devprof_mod._active.site is None

    def test_page_pool_ragged_and_mesh_sections(self):
        snaps = []
        for p in (DeviceProfiler().enable(), JaxProfiler().enable()):
            p.observe_page_pool({"pool_pages": 8, "pool_utilization": 0.75})
            p.observe_page_pool({"pool_pages": 16, "pool_utilization": 0.5})
            p.observe_ragged(docs_walked=4, pages_walked=9, real_ops=40)
            p.observe_ragged(docs_walked=2, pages_walked=3, real_ops=10, dispatches=2)
            p.observe_mesh({"shards": 2, "imbalance_ratio": 1.5})
            p.observe_mesh({"shards": 2, "imbalance_ratio": 1.1})
            snaps.append(p.snapshot())
        ours, ref = snaps
        assert ours["page_pool"]["peak_utilization"] == 0.75
        assert ours["ragged"]["dispatches"] == 3
        for key in ("page_pool", "ragged", "mesh"):
            assert ours[key] == ref[key]


# ---------------------------------------------------------------------------
# the golden key sets
# ---------------------------------------------------------------------------


def _probe(p):
    x = torch.ones((8, 8))
    p.launch("_golden_probe", (x,), (), lambda: x + 1, device=x.device, kernel_launches=0)
    p.observe_round("D8.ki8.kd8.km8.kp8", real_ops=10, padded_capacity=256)
    p.sample_memory()
    return p


def _jax_probe(p):
    import jax
    import jax.numpy as jnp

    from peritext_tpu.obs.devprof import note_jit_dispatch

    @jax.jit
    def _golden_probe(x):
        return x + 1

    x = jnp.ones((8, 8))
    _golden_probe(x)
    note_jit_dispatch("_golden_probe", _golden_probe, (x,), profiler=p)
    p.observe_round("D8.ki8.kd8.km8.kp8", real_ops=10, padded_capacity=256)
    p.sample_memory()
    return p


def _key_sets(snap):
    """The key set at every level of a snapshot."""
    out = {"snapshot": set(snap), "totals": set(snap["occupancy_totals"]),
           "memory": set(snap["memory"])}
    for site in snap["sites"].values():
        out["site"] = set(site)
        for bucket in site["buckets"].values():
            out["bucket"] = set(bucket)
            out["memory_capture"] = set(bucket["memory"] or ())
    for occ in snap["occupancy"].values():
        out["occupancy"] = set(occ)
    return out


@pytest.mark.parametrize("capture", [False, True])
def test_snapshot_key_sets_equal_the_reference(capture):
    ours = _key_sets(_probe(DeviceProfiler(capture_costs=capture).enable()).snapshot())
    ref = _key_sets(_jax_probe(JaxProfiler(capture_costs=capture).enable()).snapshot())
    memory_capture = (ours.pop("memory_capture", None), ref.pop("memory_capture", None))
    assert ours == ref
    if capture:  # the port keeps the reference's argument/output/peak names
        assert memory_capture[0] <= memory_capture[1]
        assert "peak_bytes" in memory_capture[0]


def test_health_snapshot_composition():
    ours = health_snapshot(devprof=_probe(DeviceProfiler().enable()))
    ref = jax_health_snapshot(devprof=_jax_probe(JaxProfiler().enable()))
    assert set(ours) == set(ref) == {"counters", "histograms", "devprof"}
    assert set(ours["devprof"]) == set(ref["devprof"])
    assert ours["devprof"]["occupancy"] == ref["devprof"]["occupancy"]


def test_occupancy_key_spelling():
    from peritext_tpu.obs import occupancy_key as jax_occupancy_key

    assert occupancy_key(8, 16, 8, 8, 4) == jax_occupancy_key(8, 16, 8, 8, 4) == "D8.ki16.kd8.km8.kp4"


# ---------------------------------------------------------------------------
# the six seeded paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def merge_workloads():
    ref = generate_workload(MERGE["seed"], num_docs=MERGE["docs"], ops_per_doc=MERGE["ops"])
    # a long doc, so the pooled layouts hold more than one page bucket
    ref += generate_workload(MERGE["seed"] + 100, num_docs=1, ops_per_doc=160)
    return ref, _cross(ref)


@pytest.fixture(scope="module")
def stream_arrival():
    ref_w = generate_workload(STREAM["seed"], num_docs=STREAM["docs"], ops_per_doc=STREAM["ops"])
    ref_w += generate_workload(STREAM["seed"] + 100, num_docs=1, ops_per_doc=160)
    rng = random.Random(STREAM["seed"])
    ref = []
    for w in ref_w:
        chs = [ch for log in w.values() for ch in log]
        rng.shuffle(chs)
        size = -(-len(chs) // STREAM["rounds"])
        ref.append([chs[i:i + size] for i in range(0, len(chs), size)])
    port = [[[Change.from_json(c.to_json()) for c in b] for b in doc] for doc in ref]
    return ref, port


def _feed(s, arrival):
    for r in range(STREAM["rounds"]):
        for d, batches in enumerate(arrival):
            if r < len(batches):
                s.ingest(d, batches[r])
        s.drain()
    return s


def _compared(snap):
    return {k: snap[k] for k in COMPARED}


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_merge_sections_equal_the_reference(armed, merge_workloads, layout):
    ours_p, ref_p = armed
    ref_w, port_w = merge_workloads
    before = GLOBAL_COUNTERS.snapshot()
    report = DocBatch(device="cpu", layout=layout, **CAPS).merge(port_w)
    ref_report = JaxDocBatch(layout=layout, **CAPS).merge(ref_w)
    assert report.spans == ref_report.spans
    ours, ref = ours_p.snapshot(), ref_p.snapshot()
    assert _compared(ours) == _compared(ref)
    assert ours["occupancy_totals"]["real_ops"] > 0
    assert (ours["page_pool"] is None) == (layout == "padded")
    assert (ours["ragged"] is None) == (layout != "ragged")
    assert ours["memory"] == {"available": False, "samples": 1, "bytes_in_use": None,
                              "peak_bytes_in_use": None}
    site = {"padded": "apply_batch", "paged": "apply_batch_paged",
            "ragged": "apply_batch_ragged"}[layout]
    assert set(ours["sites"]) == {site}
    dispatches = ours["sites"][site]["dispatches"]
    # one call per merge, or per page group of the paged merge
    groups = sum(o["rounds"] for o in ours["occupancy"].values())
    assert dispatches == (groups if layout == "paged" else 1)
    assert groups > (1 if layout == "paged" else 0)
    assert GLOBAL_COUNTERS.get("merge.guarded_fallbacks") == before.get(
        "merge.guarded_fallbacks", 0.0)


@pytest.mark.parametrize("layout", ["padded", "paged", "ragged"])
def test_streaming_sections_equal_the_reference(armed, stream_arrival, layout):
    ours_p, ref_p = armed
    ref_arr, port_arr = stream_arrival
    kw = dict(num_docs=len(ref_arr), actors=ACTORS, layout=layout, **STREAM_CAPS)
    counters = ("streaming.block_applies", "streaming.group_applies", "streaming.ragged_applies")
    before = {c: GLOBAL_COUNTERS.get(c) for c in counters}
    s = StreamingMerge(device="cpu", **kw)
    batches, prep = [], s._prep_fused_batch
    s._prep_fused_batch = lambda batch: batches.append(len(batch)) or prep(batch)
    s = _feed(s, port_arr)
    applies = {c: GLOBAL_COUNTERS.get(c) - before[c] for c in counters}
    j = _feed(JaxStreamingMerge(**kw), ref_arr)
    assert s.read_all() == j.read_all() and s.rounds == j.rounds
    ours, ref = ours_p.snapshot(), ref_p.snapshot()
    assert _compared(ours) == _compared(ref)
    assert ours["occupancy_totals"]["real_ops"] == sum(
        len(ch.ops) for doc in port_arr for b in doc for ch in b)
    sites = ours["sites"]
    if layout in ("padded", "paged"):
        # the fused forms: one site call per committed batch under the
        # reference's site name (a lone round, or a lone page group, in its
        # undonated single form on the CPU), as many as the reference's
        # dispatches of each
        calls = {name: site["dispatches"] for name, site in sites.items()}
        assert calls == {name: site["dispatches"] for name, site in ref["sites"].items()
                         if name in COMMIT_SITES}
    if layout == "padded":
        assert set(sites) == {"apply_batch_compact", "apply_batch_staged_rounds"}
        assert applies["streaming.block_applies"] == s.rounds
    elif layout == "paged":
        # the nested apply_batch_paged calls of a group chain belong to its
        # apply_batch_paged_groups call; each group is one occupancy row
        assert set(sites) <= {"apply_batch_paged", "apply_batch_paged_groups"}
        assert ours["occupancy_totals"]["rounds"] == applies["streaming.group_applies"] >= s.rounds
    else:
        # the fused ragged form: one site call per committed batch, whose
        # rounds apply inside it
        assert set(sites) == {"apply_batch_ragged"}
        assert sites["apply_batch_ragged"]["dispatches"] == len(batches)
        assert sum(batches) == s.rounds
    assert ours["memory"]["samples"] > 0 and ours["memory"]["available"] is False


#: the reference's commit sites the port's streaming forms are named after
#: (its other sites are read paths and jit helpers the port has no site for)
COMMIT_SITES = ("apply_batch", "apply_batch_compact", "apply_batch_staged_rounds",
                "apply_batch_stacked_rounds", "apply_batch_stacked_rounds_multi",
                "_fused_rounds_digest", "_stacked_rounds_digest", "apply_batch_paged",
                "apply_batch_paged_groups")


def test_capture_costs_on_a_cpu_session(armed, stream_arrival):
    """Armed with costs on the CPU: every bucket has its bytes (the insert
    phase's, by the kernel bound's formula), no launches and no device
    time."""
    ours_p, _ = armed
    ours_p.enable(capture_costs=True)
    _, port_arr = stream_arrival
    _feed(StreamingMerge(num_docs=len(port_arr), actors=ACTORS, device="cpu", **STREAM_CAPS),
          port_arr)
    sites = ours_p.snapshot()["sites"]
    # the drains commit one-round batches (apply_batch_compact) and
    # multi-round ones (apply_batch_staged_rounds)
    assert set(sites) == {"apply_batch_compact", "apply_batch_staged_rounds"}
    for bucket in (b for site in sites.values() for b in site["buckets"].values()):
        cost = bucket["cost"]
        assert cost["device_ms"] is None and cost["kernel_launches"] == 0
        assert cost["kernel_bytes"] > 0
        assert "plan', ()" in bucket["sig"]
        assert bucket["memory"]["peak_bytes"] > 0
