"""peritext_tpu_torch.plan — the planner tier.

* :mod:`.fusion` — deterministic cross-tenant fusion planning: which
  tenants share a device lane, at which doc-row bases, and which row
  extents a batching window touches (the serve tier's ``FusedMuxGroup``
  executes these plans).  No wall clock: the drain order is a pure
  function of the committed window.

The cost model and the tuner that propose statics from a device profile
are still to port (ROADMAP.md queue 1 item 12).
"""

from .fusion import FusionGroup, LanePlan, LaneSlot, TenantSpec

__all__ = ["FusionGroup", "LanePlan", "LaneSlot", "TenantSpec"]
