"""Cross-tenant fusion planning: tenants -> device lanes -> doc rows.

A host serving N tenants as N standalone :class:`~..serve.mux.SessionMux`
sessions drains each one separately — N drains per batching window.  A
:class:`FusionGroup` assigns many tenants to shared device lanes (one
:class:`~..parallel.streaming.StreamingMerge` per storage layout), each
tenant owning a DISJOINT doc-row range, so one window commits one drain
per touched lane no matter how many tenants rode it.  Documents are
independent CRDTs and rows never alias, so per-tenant byte equality with
the unfused path holds by construction; cross-tenant isolation is a
row-range property, not a runtime check.

Everything here is a pure function of the tenant specs and the window's
active set: no wall clock, no RNG, so two hosts given the same specs
assemble the same groups and the same drain order.  All wall-clock
ownership (window opening/closing, drain timing) stays in the serve
tier's ``FusedMuxGroup``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

#: storage layouts a lane may be built over (mirrors StreamingMerge)
LANE_LAYOUTS = ("padded", "paged", "ragged")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's lane requirements: a stable name, its doc-slot
    budget, and the storage layout its sessions need."""

    tenant: str
    docs: int
    layout: str = "padded"

    def __post_init__(self):
        if not self.tenant:
            raise ValueError("tenant name must be non-empty")
        if self.docs <= 0:
            raise ValueError(f"tenant {self.tenant!r}: docs must be > 0")
        if self.layout not in LANE_LAYOUTS:
            raise ValueError(
                f"tenant {self.tenant!r}: unknown layout {self.layout!r}"
            )


@dataclass(frozen=True)
class LaneSlot:
    """A tenant's placement inside a lane: ``[doc_base, doc_base+docs)``
    of the lane session's doc axis belongs to exactly this tenant."""

    tenant: str
    lane: int
    layout: str
    doc_base: int
    docs: int


@dataclass(frozen=True)
class LanePlan:
    """One shared device lane: a session of ``docs`` total rows, tiled by
    the tenants in ``slots`` (base-ascending)."""

    lane: int
    layout: str
    docs: int
    slots: Tuple[LaneSlot, ...]

    def to_json(self) -> Dict:
        return {
            "lane": self.lane,
            "layout": self.layout,
            "docs": self.docs,
            "tenants": [s.tenant for s in self.slots],
        }


class FusionGroup:
    """Deterministic tenant -> (lane, doc_base) assignment plus the
    per-window doc-row extents the multi-tenant staged dispatch needs.

    Assignment is a pure function of the tenant specs: tenants sort by
    ``(layout, tenant)`` and first-fit pack into lanes of at most
    ``lane_capacity`` doc rows, one lane sequence per layout — two hosts
    given the same specs assemble byte-identical groups.  ``lane_capacity``
    bounds a lane's doc axis, not the tenant count.

    ``shard_rows`` aligns placement to a mesh-sharded lane session: a
    tenant's ``[doc_base, doc_base+docs)`` never straddles a multiple of
    ``shard_rows`` mid-shard (bases bump to the next shard boundary when
    the block would spill over), so one tenant's window drain touches
    whole shards or stays inside one (the placement a mesh-sharded lane
    needs: a lane session built with ``mesh=`` shards its rows in blocks
    of ``shard_rows``).
    """

    def __init__(self, tenants: Sequence[TenantSpec],
                 lane_capacity: int = 4096,
                 shard_rows: Optional[int] = None) -> None:
        if lane_capacity <= 0:
            raise ValueError(f"lane_capacity must be > 0, got {lane_capacity}")
        if shard_rows is not None:
            if shard_rows <= 0:
                raise ValueError(
                    f"shard_rows must be > 0, got {shard_rows}")
            if lane_capacity % shard_rows:
                raise ValueError(
                    f"lane_capacity {lane_capacity} must be a multiple of "
                    f"shard_rows {shard_rows}: a lane is a whole number of "
                    "mesh shards"
                )
        self.shard_rows = int(shard_rows) if shard_rows else None
        names = [t.tenant for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError("duplicate tenant names in fusion group")
        for t in tenants:
            if t.docs > lane_capacity:
                raise ValueError(
                    f"tenant {t.tenant!r} needs {t.docs} docs > "
                    f"lane_capacity {lane_capacity}"
                )
        self.lane_capacity = int(lane_capacity)
        lanes: list = []
        slots: Dict[str, LaneSlot] = {}
        # first-fit in sorted order: stable, and layout-grouped so a mixed
        # window touches one lane per layout present, not an interleaving
        open_lane: Dict[str, list] = {}
        for spec in sorted(tenants, key=lambda t: (t.layout, t.tenant)):
            cur = open_lane.get(spec.layout)
            base = self._aligned_base(cur[1], spec.docs) if cur else 0
            if cur is None or base + spec.docs > lane_capacity:
                cur = open_lane[spec.layout] = [len(lanes), 0, spec.layout, []]
                lanes.append(cur)
                base = 0
            slot = LaneSlot(
                tenant=spec.tenant, lane=cur[0], layout=spec.layout,
                doc_base=base, docs=spec.docs,
            )
            cur[1] = base + spec.docs
            cur[3].append(slot)
            slots[spec.tenant] = slot
        self.lanes: Tuple[LanePlan, ...] = tuple(
            LanePlan(lane=i, layout=layout, docs=docs, slots=tuple(ss))
            for i, docs, layout, ss in lanes
        )
        self.slots: Dict[str, LaneSlot] = slots

    def _aligned_base(self, used: int, docs: int) -> int:
        """The next doc base that keeps ``[base, base+docs)`` off a
        mid-shard boundary: within-shard when the block fits in the
        current shard's remainder, else bumped to the next multiple of
        ``shard_rows`` (multi-shard tenants always start on one)."""
        s = self.shard_rows
        if not s:
            return used
        off = used % s
        if off and off + docs > s:
            return used + (s - off)
        return used

    # -- lookups -----------------------------------------------------------

    def slot_of(self, tenant: str) -> LaneSlot:
        slot = self.slots.get(tenant)
        if slot is None:
            raise KeyError(f"unknown tenant {tenant!r}")
        return slot

    def lane_of(self, tenant: str) -> LanePlan:
        return self.lanes[self.slot_of(tenant).lane]

    # -- per-window assembly ----------------------------------------------

    def window_rows(
        self, lane: int, active: Sequence[str],
    ) -> Optional[Tuple[Tuple[int, ...], int]]:
        """The staged dispatch's doc-row extents for one window: the row
        bases of the ACTIVE tenants on ``lane`` (base-ascending — dispatch
        order is a function of placement, never of arrival) plus the
        uniform per-tenant block size.  Returns None when the active
        tenants' doc budgets differ (a ragged tenant mix is staged as the
        whole lane).  The session keeps the extents as ``fusion_rows``: a
        static-round commit then stages only those tenants' row blocks
        (the ``stacked_multi`` form)."""
        plan = self.lanes[lane]
        chosen = sorted(
            (self.slots[t] for t in set(active)),
            key=lambda s: s.doc_base,
        )
        for s in chosen:
            if s.lane != lane:
                raise ValueError(
                    f"tenant {s.tenant!r} is on lane {s.lane}, not {lane}"
                )
        if not chosen:
            return None
        block = chosen[0].docs
        if any(s.docs != block for s in chosen):
            return None
        if len(chosen) == len(plan.slots) and plan.docs == block * len(chosen):
            # every tenant active: the window is the whole lane
            return None
        return tuple(s.doc_base for s in chosen), block

    def window_occupancy(self, lane: int, active: Sequence[str]) -> float:
        """Active doc rows / lane doc rows for one window (the fusion
        analog of a padded stream's occupancy)."""
        plan = self.lanes[lane]
        if not plan.docs:
            return 0.0
        live = sum(self.slots[t].docs for t in set(active))
        return live / plan.docs

    def to_json(self) -> Dict:
        return {
            "lanes": [p.to_json() for p in self.lanes],
            "tenants": len(self.slots),
            "lane_capacity": self.lane_capacity,
            "shard_rows": self.shard_rows,
        }
