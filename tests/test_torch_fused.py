"""The port's fused multi-tenant serving (``plan/fusion.py``,
``serve/fused.py``) against the reference package's, on the CPU.

* ``FusionGroup``: lanes, slots, ``window_rows``, ``window_occupancy`` and
  ``to_json`` equal to the reference's on seeded tenant mixes, with and
  without ``shard_rows``; the same errors on the same bad specs.
* ``FusedMuxGroup`` over CPU lanes (padded ``static_rounds``, paged,
  ragged, and a mixed group of all three) against the reference's group
  over JAX's CPU, on the reference bench's ``serve_multitenant`` window
  plan (every tenant in even windows, every 4th in odd ones, then a tail
  window): every tenant's patch stream and reads, the verdicts, the group
  ``snapshot()`` (every member mux's included), each lane's digests, the
  history plane's occupancy rows and ``fusion_snapshot()``.
* A sparse window of a padded lane: the reference commits it through its
  ``stacked_multi`` offset-plane program, the port through its one compact
  commit; the two lanes' states are equal plane for plane.

Both packages get the same wire frames (the port's encoder is byte-equal to
the reference's) and a clock that never moves, so every wall is 0 and the
window tuners' snapshots compare exactly.
"""

import random

import numpy as np
import pytest

from peritext_tpu.obs.timeseries import TimeSeriesPlane as JaxHistory
from peritext_tpu.parallel.codec import encode_frame as jax_encode_frame
from peritext_tpu.plan.fusion import FusionGroup as JaxFusionGroup
from peritext_tpu.plan.fusion import TenantSpec as JaxTenantSpec
from peritext_tpu.serve import FusedMuxGroup as JaxFusedMuxGroup
from peritext_tpu.serve import default_lane_factory as jax_lane_factory
from peritext_tpu.testing.fuzz import generate_workload
from peritext_tpu_torch.obs import GLOBAL_COUNTERS
from peritext_tpu_torch.obs.timeseries import TimeSeriesPlane
from peritext_tpu_torch.plan import FusionGroup, TenantSpec
from peritext_tpu_torch.serve import FusedMuxGroup, default_lane_factory

ACTORS = ("doc1", "doc2", "doc3")
WINDOWS = 6
LAYOUTS = ("padded", "paged", "ragged")

# ---------------------------------------------------------------------------
# FusionGroup
# ---------------------------------------------------------------------------


def _tenant_mix(seed):
    rng = random.Random(seed)
    names = rng.sample([f"t{i:03d}" for i in range(400)], rng.randrange(1, 40))
    return [(n, rng.choice((1, 1, 2, 3, 8, 16, 40)), rng.choice(LAYOUTS)) for n in names]


def _slot_tuple(s):
    return (s.tenant, s.lane, s.layout, s.doc_base, s.docs)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("lane_capacity,shard_rows", [(64, None), (64, 16), (48, 8), (4096, None)])
def test_fusion_group_equal(seed, lane_capacity, shard_rows):
    mix = _tenant_mix(seed)
    ref = JaxFusionGroup([JaxTenantSpec(*t) for t in mix], lane_capacity=lane_capacity,
                         shard_rows=shard_rows)
    port = FusionGroup([TenantSpec(*t) for t in mix], lane_capacity=lane_capacity,
                       shard_rows=shard_rows)
    assert port.to_json() == ref.to_json()
    assert [(p.lane, p.layout, p.docs, [_slot_tuple(s) for s in p.slots]) for p in port.lanes] == \
        [(p.lane, p.layout, p.docs, [_slot_tuple(s) for s in p.slots]) for p in ref.lanes]
    assert {k: _slot_tuple(v) for k, v in port.slots.items()} == \
        {k: _slot_tuple(v) for k, v in ref.slots.items()}
    rng = random.Random(seed + 100)
    for plan in port.lanes:
        names = [s.tenant for s in plan.slots]
        for _ in range(6):
            active = rng.sample(names, rng.randrange(0, len(names) + 1))
            assert port.window_rows(plan.lane, active) == ref.window_rows(plan.lane, active)
            assert port.window_occupancy(plan.lane, active) == \
                ref.window_occupancy(plan.lane, active)
        assert port.window_rows(plan.lane, names) == ref.window_rows(plan.lane, names)
        other = [s.tenant for s in port.slots.values() if s.lane != plan.lane]
        if other:
            with pytest.raises(ValueError) as want:
                ref.window_rows(plan.lane, names[:1] + other[:1])
            with pytest.raises(ValueError) as got:
                port.window_rows(plan.lane, names[:1] + other[:1])
            assert str(got.value) == str(want.value)
    with pytest.raises(KeyError):
        port.slot_of("nobody")
    assert _slot_tuple(port.slot_of(mix[0][0])) == _slot_tuple(ref.slot_of(mix[0][0]))
    assert port.lane_of(mix[0][0]).to_json() == ref.lane_of(mix[0][0]).to_json()


BAD_GROUPS = [
    (dict(tenants=[("a", 1, "padded"), ("a", 2, "paged")]), {}),
    (dict(tenants=[("a", 65, "padded")]), {"lane_capacity": 64}),
    (dict(tenants=[("a", 1, "padded")]), {"lane_capacity": 0}),
    (dict(tenants=[("a", 1, "padded")]), {"lane_capacity": 64, "shard_rows": 0}),
    (dict(tenants=[("a", 1, "padded")]), {"lane_capacity": 64, "shard_rows": 24}),
]
BAD_SPECS = [("", 1, "padded"), ("a", 0, "padded"), ("a", 1, "blocked")]


@pytest.mark.parametrize("case", range(len(BAD_GROUPS) + len(BAD_SPECS)))
def test_fusion_group_errors_equal(case):
    def build(spec_cls, group_cls):
        if case >= len(BAD_GROUPS):
            return spec_cls(*BAD_SPECS[case - len(BAD_GROUPS)])
        args, kw = BAD_GROUPS[case]
        return group_cls([spec_cls(*t) for t in args["tenants"]], **kw)

    with pytest.raises(ValueError) as want:
        build(JaxTenantSpec, JaxFusionGroup)
    with pytest.raises(ValueError) as got:
        build(TenantSpec, FusionGroup)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# FusedMuxGroup on the bench's window plan
# ---------------------------------------------------------------------------


def _window_plan(names, docs, ops, seed=13):
    """The reference bench's serve_multitenant plan (bench.py run_serve_fused):
    each doc's changes in ``WINDOWS`` strided frames; even windows carry every
    tenant, odd ones every 4th; leftovers drain in a tail window.  Returns
    [[(tenant, doc, frame), ...] per window]."""
    workloads = generate_workload(seed=seed, num_docs=len(names) * docs, ops_per_doc=ops)
    frames = {}
    for i, w in enumerate(workloads):
        changes = sorted((ch for log in w.values() for ch in log), key=lambda c: (c.actor, c.seq))
        frames[names[i // docs], i % docs] = [jax_encode_frame(changes[k::WINDOWS])
                                              for k in range(WINDOWS)]
    cursor = {n: 0 for n in names}
    plan = []
    for w in range(WINDOWS):
        active = list(names) if w % 2 == 0 else names[(w // 2) % 4::4]
        step = []
        for n in active:
            if cursor[n] < WINDOWS:
                step += [(n, d, frames[n, d][cursor[n]]) for d in range(docs)]
                cursor[n] += 1
        plan.append(step)
    tail = [(n, d, frames[n, d][c]) for n in names for c in range(cursor[n], WINDOWS)
            for d in range(docs)]
    if tail:
        plan.append(tail)
    return plan


def _session_kw(ops):
    return dict(slot_capacity=max(256, 4 * ops), mark_capacity=max(64, ops),
                tomb_capacity=max(128, ops), round_insert_capacity=128,
                round_delete_capacity=64, round_mark_capacity=64)


def _drive_group(group_cls, spec_cls, factory, history_cls, names, layouts, docs, plan, kw):
    """Build a group, open ``docs`` sessions per tenant, and walk the plan:
    one submit per frame, one flush per window.  Returns the group, the
    sessions and the verdict record."""
    group = group_cls([spec_cls(tenant=n, docs=docs, layout=layouts[i % len(layouts)])
                       for i, n in enumerate(names)],
                      factory(ACTORS, **kw), clock=lambda: 100.0, host="fused")
    group.history = history_cls(sample_every=1, min_frames=4).enable()
    record, sids = [], {}
    for n in names:
        for d in range(docs):
            sid, v = group.open_session(n, f"client{d}")
            record.append(("open", n, sid, v.to_json()))
            sids[n, d] = sid
    for step in plan:
        for n, d, frame in step:
            record.append((n, d, group.submit(n, sids[n, d], frame).to_json()))
        record.append(("flush", group.flush()))
    return group, sids, record


#: (lane layouts, tenants, docs per tenant, ops per doc)
GROUPS = {
    "padded": (("padded",), 8, 1, 24),
    "paged": (("paged",), 8, 1, 24),
    "ragged": (("ragged",), 8, 1, 24),
    "mixed_2docs": (LAYOUTS, 4, 2, 24),
}


@pytest.fixture(scope="module", params=sorted(GROUPS))
def fused(request):
    layouts, tenants, docs, ops = GROUPS[request.param]
    names = [f"tenant{i:03d}" for i in range(tenants)]
    plan = _window_plan(names, docs, ops)
    kw = _session_kw(ops)
    ref = _drive_group(JaxFusedMuxGroup, JaxTenantSpec, jax_lane_factory, JaxHistory, names,
                       layouts, docs, plan, kw)
    d0 = GLOBAL_COUNTERS.get("streaming.fused_dispatches")
    port = _drive_group(FusedMuxGroup, TenantSpec, default_lane_factory, TimeSeriesPlane,
                        names, layouts, docs, plan, dict(kw, device="cpu"))
    dispatched = GLOBAL_COUNTERS.get("streaming.fused_dispatches") - d0
    yield request.param, names, ref, port, dispatched
    for sess in ref[0]._lane_sessions:
        stager = getattr(sess, "_stager", None)
        if stager is not None:
            thread = stager._thread
            stager.close()
            if thread is not None:
                thread.join(timeout=30)


def test_fused_verdicts_patches_and_reads_equal(fused):
    _, names, (ref, ref_sids, ref_rec), (port, sids, rec), _ = fused
    assert rec == ref_rec
    assert sids == ref_sids
    assert all(v["kind"] == "admit" for entry in rec if len(entry) == 3
               for v in [entry[2]] if isinstance(v, dict))
    for (n, _), sid in sorted(sids.items()):
        assert port.patches(n, sid) == ref.patches(n, ref_sids[n, _])
        assert port.read(n, sid) == ref.read(n, ref_sids[n, _])
        assert port.patches(n, sid) == ref.patches(n, ref_sids[n, _]) == []


def test_fused_snapshot_lanes_and_occupancy_equal(fused):
    name, names, (ref, _, _), (port, _, _), dispatched = fused
    assert port.fusion_snapshot() == ref.fusion_snapshot()
    assert port.snapshot() == ref.snapshot()
    assert port.dispatches == dispatched
    fusion = port.fusion_snapshot()
    assert fusion["windows"] == len(_window_plan(names, *GROUPS[name][2:]))
    # the reference counts fused dispatches on one-block padded lanes only
    assert (fusion["dispatches"] > 0) == ("padded" in GROUPS[name][0])
    assert port.history.occupancy_rows() == ref.history.occupancy_rows()
    assert port.history.occupancy_rows()
    assert port.history.snapshot()["occupancy"] == ref.history.snapshot()["occupancy"]
    for mine, theirs in zip(port._lane_sessions, ref._lane_sessions):
        assert mine.layout == theirs.layout
        assert mine.digest() == theirs.digest()
        assert mine.digest(full=False) == theirs.digest(full=False)
        assert mine.read_all() == theirs.read_all()
        assert mine.fusion_rows is None
    for n in names:
        assert port.mux(n).snapshot()["fusion"] == fusion


def test_fused_group_refuses_what_the_reference_refuses():
    kw = dict(_session_kw(24), device="cpu")
    spec = [TenantSpec("a", 1)]
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    with pytest.raises(ValueError, match="static_rounds"):
        FusedMuxGroup(spec, lambda p: StreamingMerge(num_docs=1, actors=ACTORS, **kw))
    with pytest.raises(ValueError, match="docs"):
        FusedMuxGroup([TenantSpec("a", 2)], lambda p: StreamingMerge(
            num_docs=1, actors=ACTORS, static_rounds=True, **kw))
    group = FusedMuxGroup(spec, default_lane_factory(ACTORS, **kw))
    with pytest.raises(KeyError):
        group.mux("b")
    assert group.pump() == 0 and group.flush() == 0


def test_sparse_padded_window_equal_state(monkeypatch):
    """A window that touches 2 of 8 tenants of a padded lane: both packages
    route it through ``stacked_multi`` (only the active tenants' blocks
    staged, the full planes rebuilt on the device), every commit takes the
    same form with the same statics, and every state plane of the two lanes
    is equal afterwards."""
    names = [f"tenant{i:03d}" for i in range(8)]
    plan = _window_plan(names, 1, 24, seed=5)
    sparse = plan[1]
    assert 0 < len({n for n, _, _ in sparse}) < len(names)
    kw = _session_kw(24)
    routes = {"ref": [], "port": []}
    from peritext_tpu.parallel.streaming import StreamingMerge as JaxStreamingMerge
    from peritext_tpu_torch.parallel.streaming import StreamingMerge

    def spy(cls, side):
        prep = cls._prep_fused_batch

        def spied(self, batch):
            statics = prep(self, batch)
            routes[side].append((statics[0], self.fusion_rows) + tuple(statics[1:]))
            return statics
        monkeypatch.setattr(cls, "_prep_fused_batch", spied)

    spy(JaxStreamingMerge, "ref")
    spy(StreamingMerge, "port")
    ref = _drive_group(JaxFusedMuxGroup, JaxTenantSpec, jax_lane_factory, JaxHistory, names,
                       ("padded",), 1, plan[:2], kw)[0]
    port = _drive_group(FusedMuxGroup, TenantSpec, default_lane_factory, TimeSeriesPlane,
                        names, ("padded",), 1, plan[:2], dict(kw, device="cpu"))[0]
    assert routes["port"] == routes["ref"]
    assert routes["ref"][0][0] in ("stacked", "static1") and routes["ref"][0][1] is None
    bases = tuple(sorted(ref.group.slots[n].doc_base for n, _, _ in sparse))
    assert routes["ref"][1:] and all(r[:2] == ("stacked_multi", (bases, 1))
                                     for r in routes["ref"][1:])
    (mine,), (theirs,) = port._lane_sessions, ref._lane_sessions
    for field in mine.state._fields:
        np.testing.assert_array_equal(
            getattr(mine.state, field).cpu().numpy(), np.asarray(getattr(theirs.state, field)),
            err_msg=field)
    assert mine.digest() == theirs.digest()
    mine._ensure_stager().close()
    stager = getattr(theirs, "_stager", None)
    if stager is not None:
        stager.close()
