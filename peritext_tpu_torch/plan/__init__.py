"""peritext_tpu_torch.plan — the planner tier.

* :mod:`.fusion` — deterministic cross-tenant fusion planning: which
  tenants share a device lane, at which doc-row bases, and which row
  extents a batching window touches (the serve tier's ``FusedMuxGroup``
  executes these plans).  No wall clock: the drain order is a pure
  function of the committed window.
* :mod:`.model` + :mod:`.tuner` — the closed loop: a cost model over a
  devprof snapshot (bucket occupancy, the launch sites' buckets, the page
  pool, the allocator's peak) proposes a typed
  :class:`~.tuner.PlanProposal` — stream widths, slot capacity, page
  size, fused depth, admission window — minimizing modeled padded work,
  variants and dispatches under a footprint budget.  ``python -m
  peritext_tpu_torch.obs plan`` is the operator surface.
"""

from .fusion import FusionGroup, LanePlan, LaneSlot, TenantSpec
from .model import CostModel, load_devprof
from .tuner import PlanProposal, history_values, propose

__all__ = [
    "CostModel",
    "FusionGroup",
    "LanePlan",
    "LaneSlot",
    "PlanProposal",
    "TenantSpec",
    "history_values",
    "load_devprof",
    "propose",
]
