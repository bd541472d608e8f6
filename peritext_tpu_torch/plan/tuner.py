"""The closed-loop half: search candidate configurations over the model.

``propose(snapshot)`` is a PURE function of its inputs: candidates come
from a deterministic pow-2 grid anchored at the observed configuration
(widths may shrink only while the measured utilization keeps a 2x safety
headroom; slot capacity may shrink only to a pow-2 still twice the
observed per-doc insert estimate; page size walks one pow-2 step either
way of the observed; fused depth walks the {1, 2, 4, 8} ladder), every
candidate is scored by :class:`~.model.CostModel` and filtered by the
executable-bytes budget, and ties break on the candidate tuple itself —
same snapshot (and ledger, and history), same :class:`PlanProposal`,
always.  ``history=`` closes the occupancy feedback loop: pass the
occupancy rows the fused serving tier recorded into the history plane (a
live :class:`~..obs.timeseries.TimeSeriesPlane`, its snapshot dict, its
``occupancy_rows`` list, or plain floats) and the model's utilization
gate and dispatch term are weighted by the observed per-window occupancy
DISTRIBUTION instead of the devprof point estimate —
``modeled["history"]["weighted_terms"]`` names exactly which terms
moved, and ``obs plan`` prints them.  The proposal is ADVICE with a
paper trail, not an actuation: a proposal is replayed through the
sessions it would configure before anyone re-pins a static.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .model import CostModel, load_devprof

#: proposals within this fractional score band of the current config are
#: "your statics are fine" — the CLI exits 0 inside it, 1 beyond it
DEFAULT_TOLERANCE = 0.10

#: shrink a stream width only while candidate capacity keeps this factor
#: over the observed real-op share (a too-tight width demotes docs to the
#: scalar fallback — correctness headroom is not the tuner's to spend)
WIDTH_HEADROOM = 2.0

#: the fused-depth ladder candidates walk (streaming.FUSE_MAX_ROUNDS caps
#: the top rung)
FUSED_DEPTHS = (1, 2, 4, 8)

#: admission-window clamps (serve.mux.BatchWindowTuner floor/ceiling)
WINDOW_FLOOR = 0.002
WINDOW_CEILING = 0.25
WINDOW_MARGIN = 1.0


@dataclass(frozen=True)
class PlanProposal:
    """One typed planner verdict: the proposed statics, the observed
    baseline they would replace, and the modeled terms that justify the
    trade.  ``to_json()`` is the golden-schema surface the CLI prints and
    tests pin."""

    insert_width: int
    delete_width: int
    mark_width: int
    map_width: int
    slot_capacity: int
    page_size: int
    fused_depth: int
    window_seconds: float
    current: Dict[str, Any] = field(default_factory=dict)
    modeled: Dict[str, Any] = field(default_factory=dict)

    def beats_current(self, tolerance: float = DEFAULT_TOLERANCE) -> bool:
        """Whether the proposal's modeled score improves on the current
        configuration's by MORE than the tolerance band — the "your
        statics are stale" signal (CLI exit 1)."""
        cur = self.modeled.get("current_score")
        new = self.modeled.get("proposed_score")
        if not cur or new is None:
            return False
        return (cur - new) / cur > tolerance

    def to_json(self) -> Dict[str, Any]:
        return {
            "proposal": {
                "insert_width": self.insert_width,
                "delete_width": self.delete_width,
                "mark_width": self.mark_width,
                "map_width": self.map_width,
                "slot_capacity": self.slot_capacity,
                "page_size": self.page_size,
                "fused_depth": self.fused_depth,
                "window_seconds": self.window_seconds,
            },
            "current": dict(self.current),
            "modeled": dict(self.modeled),
        }


def _pow2_down(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _width_candidates(model: CostModel, observed: Tuple[int, int, int, int],
                      ) -> List[Tuple[int, int, int, int]]:
    """Uniform pow-2 shrink factors of the observed widths, largest
    shrink first capped where utilization x headroom still fits: the
    serving discipline wants ONE width set (a per-kind mix would mint
    variant products), so candidates scale all four together."""
    util = model.utilization()
    out = [tuple(observed)]
    scale = 2
    while scale <= 8:
        cand = tuple(max(4, w // scale) for w in observed)
        k_old, k_new = sum(observed), sum(cand)
        if k_old and k_new / k_old < min(1.0, util * WIDTH_HEADROOM):
            break
        out.append(cand)
        scale *= 2
    return out


def _window_from_ledger(ledger_records: Optional[Sequence[Dict]]) -> float:
    """The admission window the BatchWindowTuner would pick, replayed
    from the ledger's serve rows: margin x the most recent serve row's
    per-frame seconds estimate, clamped like the tuner clamps.  No serve
    evidence -> the floor (lowest latency is the safe direction)."""
    p99 = None
    for rec in ledger_records or []:
        for row in rec.get("rows", []):
            name = row.get("row") or ""
            if not name.startswith("serve"):
                continue
            value, unit = row.get("value"), row.get("unit")
            if unit in ("docs/s", "ops/s") and isinstance(
                    value, (int, float)) and value > 0:
                p99 = 1.0 / value
    if p99 is None:
        return WINDOW_FLOOR
    return float(min(WINDOW_CEILING, max(WINDOW_FLOOR, WINDOW_MARGIN * p99)))


def history_values(history: Any) -> List[float]:
    """Normalize a ``propose(history=...)`` input to a flat list of
    per-window occupancy values.  Accepts None, a live
    :class:`~..obs.timeseries.TimeSeriesPlane` (or anything with
    ``occupancy_values()``), a plane SNAPSHOT dict (``occupancy_rows``),
    a sequence of row dicts (``occupancy`` key), or plain floats."""
    if history is None:
        return []
    fn = getattr(history, "occupancy_values", None)
    if callable(fn):
        return [float(v) for v in fn()]
    if isinstance(history, dict):
        rows = history.get("occupancy_rows") or ()
        return [float(r["occupancy"]) for r in rows]
    out: List[float] = []
    for item in history:
        if isinstance(item, dict):
            out.append(float(item["occupancy"]))
        else:
            out.append(float(item))
    return out


def propose(
    snapshot: Any,
    ledger_records: Optional[Sequence[Dict]] = None,
    *,
    budget_bytes: Optional[int] = None,
    tolerance: float = DEFAULT_TOLERANCE,
    history: Any = None,
) -> PlanProposal:
    """The planner: one deterministic :class:`PlanProposal` from one
    devprof snapshot (+ optional perf-ledger records for the admission
    window term, + optional occupancy ``history`` for distribution-
    weighted cost terms — see the module doc)."""
    occupancy = history_values(history)
    model = CostModel(load_devprof(snapshot), occupancy_history=occupancy)
    observed = model.observed_config()
    budget = budget_bytes if budget_bytes is not None else model.memory_budget()

    widths_obs = (observed["insert_width"], observed["delete_width"],
                  observed["mark_width"], observed["map_width"])
    width_cands = _width_candidates(model, widths_obs)
    slot_obs = observed["slot_capacity"]
    slot_need = _pow2_down(max(64, int(model._inserts_per_doc() * 2) or 64))
    slot_cands = sorted({slot_obs, max(64, min(slot_obs, slot_need))})
    page_obs = observed["page_size"]
    page_cands = (
        sorted({page_obs // 2, page_obs, page_obs * 2})
        if model.snapshot.get("page_pool") else [page_obs]
    )
    page_cands = [p for p in page_cands if p >= 8]

    best = None
    for widths in sorted(width_cands):
        for slot in slot_cands:
            for page in page_cands:
                for depth in FUSED_DEPTHS:
                    cand = {
                        "insert_width": widths[0],
                        "delete_width": widths[1],
                        "mark_width": widths[2],
                        "map_width": widths[3],
                        "slot_capacity": slot,
                        "page_size": page,
                        "fused_depth": depth,
                    }
                    if budget is not None and (
                            model.executable_bytes(cand) > budget):
                        continue
                    key = (model.score(cand), tuple(sorted(cand.items())))
                    if best is None or key < best[0]:
                        best = (key, cand)
    if best is None:
        # budget excludes everything: the observed config stands
        best = ((model.score(observed), ()), dict(observed))
    cand = best[1]
    window = _window_from_ledger(ledger_records)
    current_score = model.score(observed)
    proposed_score = model.score(cand)
    modeled = {
        "current_score": round(current_score, 2),
        "proposed_score": round(proposed_score, 2),
        "savings_frac": (
            round((current_score - proposed_score) / current_score, 4)
            if current_score else 0.0
        ),
        "padded_flops_current": round(model.padded_flops(observed), 2),
        "padded_flops_proposed": round(model.padded_flops(cand), 2),
        "recompiles_current": model.recompiles(observed),
        "recompiles_proposed": model.recompiles(cand),
        "dispatches_current": model.dispatches(observed),
        "dispatches_proposed": model.dispatches(cand),
        "executable_bytes": model.executable_bytes(cand),
        "budget_bytes": budget,
        "utilization": round(model.utilization(), 4),
        "tolerance": tolerance,
    }
    if occupancy:
        modeled["history"] = {
            "rows": len(occupancy),
            "occupancy": model.occupancy_distribution(),
            "dispatch_weight_factor": round(
                model.dispatch_weight_factor(), 4
            ),
            "weighted_terms": ["dispatch_cost", "utilization"],
        }
    return PlanProposal(
        insert_width=cand["insert_width"],
        delete_width=cand["delete_width"],
        mark_width=cand["mark_width"],
        map_width=cand["map_width"],
        slot_capacity=cand["slot_capacity"],
        page_size=cand["page_size"],
        fused_depth=cand["fused_depth"],
        window_seconds=round(window, 6),
        current=observed,
        modeled=modeled,
    )
