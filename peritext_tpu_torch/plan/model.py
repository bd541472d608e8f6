"""Cost model over a devprof snapshot: what the statics actually cost.

Every shape constant in the serving stack is a static someone once
hand-picked: the round stream widths (``round_*_capacity``), the slot
capacity, the P=64 page size, the fused depth, the admission window
clamps.  :mod:`~..obs.devprof` measures what those choices cost — per
launch site a table of shape and launch-plan buckets, the
bucket-occupancy (padding waste) tables, page-pool fragmentation — so the
model here is READ, not guessed: it parses one devprof snapshot into the
observed configuration plus enough per-term structure to score a
candidate configuration's modeled padded work, variant count and
footprint.  :mod:`.tuner` searches candidates over it; ``python -m
peritext_tpu_torch.obs plan`` is the operator surface.

It reads the port's snapshots and the reference package's alike (the
snapshot is plain JSON), and gives the same numbers on the same file.
What each term models on the port:

* **padded work** (``padded_flops``): the occupancy rows' padded op
  capacity.  A port bucket's ``cost`` holds ``device_ms``,
  ``kernel_bytes`` and ``kernel_launches`` and no flop count, so a port
  snapshot is priced at :data:`DEFAULT_FLOPS_PER_OP` and the score comes
  out in padded-op units (the same path a snapshot without captured costs
  takes).
* **recompiles**: the launch-plan variants the session's shapes walk (the
  fused-depth and slot-window ladders).  The port compiles its kernels
  once, with ``nvcc`` at first use; no build happens after that, so a
  variant costs a new launch plan, not a compile.
* **executable bytes**: variants times the largest bucket's
  ``memory.peak_bytes``, which on the port is the call's argument plus
  output bytes (temporaries are not counted).
* **memory budget**: from the snapshot's ``memory.peak_bytes_in_use``,
  which on the port is the CUDA caching allocator's peak; a CPU session
  has none (``available: false``), and then no budget applies.

Wall-clock numbers appear only as data READ FROM the snapshot; nothing
here reads a clock or touches a device.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

#: the bucket-occupancy key spelling (obs/devprof.occupancy_key)
OCC_KEY_RE = re.compile(
    r"^D(?P<docs>\d+)\.ki(?P<ki>\d+)\.kd(?P<kd>\d+)"
    r"\.km(?P<km>\d+)\.kp(?P<kp>\d+)$"
)

#: modeled FLOPs charged per padded op slot when the snapshot carries no
#: flop counts (capture off, or any port snapshot): the model still ranks
#: candidates by padded capacity, just in op units instead of FLOPs
DEFAULT_FLOPS_PER_OP = 1.0

#: per variant: executable-bytes estimate used when the snapshot's memory
#: section can't price one (the biggest captured bucket's peak bytes stand
#: in otherwise)
DEFAULT_EXECUTABLE_BYTES = 1 << 20

#: fraction of device memory the variant cache may claim
DEFAULT_BUDGET_FRACTION = 0.10

#: the fused depth a drain batches up to (parallel/streaming.py
#: ``StreamingMerge.FUSE_MAX_ROUNDS``)
FUSED_DEPTH = 8


def load_devprof(source: Any) -> Dict[str, Any]:
    """A devprof snapshot dict from a path, JSON string, or dict.

    Accepts the raw :meth:`~..obs.devprof.DeviceProfiler.snapshot` body,
    a ``/devprof.json`` scrape, or a ``/health.json``-style wrapper
    carrying a ``devprof`` key (the ``obs`` CLI loaders' discipline)."""
    if isinstance(source, (str, Path)):
        text = Path(source).read_text()
        snap = json.loads(text)
    elif isinstance(source, dict):
        snap = source
    else:
        raise TypeError(f"cannot load devprof from {type(source).__name__}")
    if not isinstance(snap, dict):
        raise ValueError("devprof snapshot must be a JSON object")
    if "sites" not in snap and isinstance(snap.get("devprof"), dict):
        snap = snap["devprof"]
    if "sites" not in snap or "occupancy" not in snap:
        raise ValueError(
            "not a devprof snapshot: missing 'sites'/'occupancy' sections"
        )
    return snap


def _pow2_at_least(n: int, floor: int = 1) -> int:
    cap = max(int(floor), 1)
    while cap < n:
        cap *= 2
    return cap


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Ceil-rank percentile over an ascending list (the history plane's
    convention, restated here so the plan tier stays import-free of obs)."""
    if not sorted_vals:
        return 0.0
    idx = max(0, math.ceil(q * len(sorted_vals)) - 1)
    return float(sorted_vals[min(idx, len(sorted_vals) - 1)])


class CostModel:
    """Deterministic scoring of serving configurations against one
    devprof snapshot.

    A configuration is the dict the tuner proposes over: ``insert_width``
    / ``delete_width`` / ``mark_width`` / ``map_width`` (the round stream
    widths), ``slot_capacity``, ``page_size``, ``fused_depth``, plus the
    optional ``shards`` (device count on the doc axis).  The score is
    ``modeled padded work + RECOMPILE_WEIGHT * variants + DISPATCH_WEIGHT
    * dispatches``, with :meth:`executable_bytes` as the side constraint
    the tuner enforces.  Same snapshot -> same numbers, always: every term
    is arithmetic over the snapshot's own tables.
    """

    #: one variant's score weight, in modeled-FLOP units (the reference's
    #: calibration, kept so both packages score one snapshot alike)
    RECOMPILE_WEIGHT = 1e7
    #: one dispatch's score weight, in modeled-FLOP units: what makes
    #: fused depth a real trade instead of "fewest variants always wins"
    DISPATCH_WEIGHT = 1e6

    def __init__(self, snapshot: Dict[str, Any],
                 occupancy_history: Optional[Sequence[float]] = None) -> None:
        self.snapshot = load_devprof(snapshot)
        #: observed per-window occupancy rows from the history plane's
        #: closed loop (FusedMuxGroup -> TimeSeriesPlane.record_occupancy
        #: -> propose(history=...)); empty means "snapshot point estimate
        #: only" and every term behaves exactly as before
        self.occupancy_history = sorted(
            float(v) for v in (occupancy_history or ())
        )
        occ = self.snapshot.get("occupancy") or {}
        self.rows = []
        for key in sorted(occ):
            m = OCC_KEY_RE.match(key)
            if not m:
                continue
            entry = occ[key]
            self.rows.append({
                "docs": int(m.group("docs")),
                "widths": (int(m.group("ki")), int(m.group("kd")),
                           int(m.group("km")), int(m.group("kp"))),
                "rounds": int(entry.get("rounds", 0)),
                "real_ops": int(entry.get("real_ops", 0)),
                "padded_capacity": int(entry.get("padded_capacity", 0)),
            })
        self.total_real_ops = sum(r["real_ops"] for r in self.rows)
        self.total_padded = sum(r["padded_capacity"] for r in self.rows)
        self.total_rounds = sum(r["rounds"] for r in self.rows)
        self._flops_per_op = self._derive_flops_per_op()

    # -- observed terms ----------------------------------------------------

    def _derive_flops_per_op(self) -> float:
        """Modeled FLOPs per padded op slot, from the buckets' captured
        flop counts when present (a reference snapshot with costs: total
        flops across buckets / total padded capacity), else the unit
        default (every port snapshot)."""
        flops = 0.0
        for site in sorted(self.snapshot.get("sites") or {}):
            buckets = (self.snapshot["sites"][site] or {}).get("buckets") or {}
            for key in sorted(buckets):
                cost = (buckets[key] or {}).get("cost") or {}
                f = cost.get("flops")
                if isinstance(f, (int, float)) and f > 0:
                    flops += float(f) * int(buckets[key].get("dispatches", 1))
        if flops > 0 and self.total_padded:
            return flops / self.total_padded
        return DEFAULT_FLOPS_PER_OP

    def observed_config(self) -> Dict[str, Any]:
        """The configuration the snapshot was captured UNDER — recovered
        from the snapshot itself (occupancy keys carry the widths; the
        page-pool section carries the page size), so the proposal's
        baseline is what actually ran, not what someone remembers
        configuring."""
        widths = max(
            (r["widths"] for r in self.rows), default=(64, 32, 32, 16),
        )
        # fused depth: the deepest round-chained dispatch the staged
        # sites saw (distinct shapes on the stacked/staged sites form the
        # R-ladder; depth itself isn't in the bucket key, so the ladder
        # size is the observable)
        sites = self.snapshot.get("sites") or {}
        fused_sites = [
            s for s in sites
            if "staged_rounds" in s or "stacked_rounds" in s
        ]
        fused_depth = FUSED_DEPTH if fused_sites else 1
        pool = self.snapshot.get("page_pool") or {}
        cfg = {
            "insert_width": widths[0],
            "delete_width": widths[1],
            "mark_width": widths[2],
            "map_width": widths[3],
            "slot_capacity": self._observed_slot_capacity(),
            "page_size": int(pool.get("page_size", 64)),
            "fused_depth": fused_depth,
        }
        return cfg

    def _observed_slot_capacity(self) -> int:
        """Slot capacity from the page-pool section when pooled (allocated
        slots per resident doc, pow-2), else a conservative pow-2 over
        the per-doc admitted insert estimate."""
        pool = self.snapshot.get("page_pool") or {}
        docs = int(pool.get("docs_resident", 0))
        if docs and pool.get("allocated_slots"):
            return _pow2_at_least(
                -(-int(pool["allocated_slots"]) // docs), 64,
            )
        per_doc = self._inserts_per_doc()
        return _pow2_at_least(int(per_doc * 2) or 64, 64)

    def _inserts_per_doc(self) -> float:
        """Estimated admitted inserts per doc over the capture: real ops
        attributed to the insert stream by width share, / docs."""
        ops = 0.0
        docs = 0
        for r in self.rows:
            k = sum(r["widths"])
            if k:
                ops += r["real_ops"] * (r["widths"][0] / k)
            docs = max(docs, r["docs"])
        return ops / docs if docs else 0.0

    def utilization(self) -> float:
        """The utilization estimate the width-shrink gate spends headroom
        against.  With occupancy history: the p90 of the observed
        per-window distribution — a width must survive the BUSY tail of
        real windows, not the quiet mean a single snapshot happened to
        catch.  Without history: real ops / padded capacity over the
        capture."""
        if self.occupancy_history:
            return _percentile(self.occupancy_history, 0.90)
        if not self.total_padded:
            return 1.0
        return self.total_real_ops / self.total_padded

    def occupancy_distribution(self) -> Dict[str, Any]:
        """The observed occupancy distribution the history-weighted terms
        cite: count, mean, p10/p50/p90, and the sparse-window fraction
        (occupancy < 0.5 — windows that under-amortize the dispatch
        floor)."""
        vals = self.occupancy_history
        if not vals:
            return {"count": 0}
        sparse = sum(1 for v in vals if v < 0.5)
        return {
            "count": len(vals),
            "mean": round(sum(vals) / len(vals), 6),
            "p10": _percentile(vals, 0.10),
            "p50": _percentile(vals, 0.50),
            "p90": _percentile(vals, 0.90),
            "sparse_frac": round(sparse / len(vals), 6),
        }

    def dispatch_weight_factor(self) -> float:
        """History weighting of the dispatch term: sparse windows pay the
        same per-dispatch host cost for less useful work, so it counts
        ``1 + sparse_frac`` times when the observed distribution says most
        windows ran thin.  1.0 without history."""
        if not self.occupancy_history:
            return 1.0
        sparse = sum(1 for v in self.occupancy_history if v < 0.5)
        return 1.0 + sparse / len(self.occupancy_history)

    # -- candidate terms ---------------------------------------------------

    def padded_flops(self, config: Dict[str, Any]) -> float:
        """Modeled padded work of replaying the capture under ``config``:
        each occupancy row's padded capacity rescaled by the
        candidate/observed total-width ratio (the (D, K) staging planes
        and the apply's per-slot scan both scale linearly in K), priced
        at the snapshot's FLOPs-per-op (op units on the port)."""
        k_new = (config["insert_width"] + config["delete_width"]
                 + config["mark_width"] + config["map_width"])
        total = 0.0
        for r in self.rows:
            k_old = sum(r["widths"])
            scale = (k_new / k_old) if k_old else 1.0
            total += r["padded_capacity"] * scale
        # the shard term: a sharded host splits the doc axis over
        # ``shards`` devices, so per-device padded work divides while the
        # dispatch/variant floors stay whole
        shards = max(1, int(config.get("shards", 1)))
        return total * self._flops_per_op / shards

    def recompiles(self, config: Dict[str, Any]) -> int:
        """Modeled variant count under ``config``: one per fused depth on
        the log2 ladder up to ``fused_depth``, plus the log2 slot-window
        ladder up to the slot capacity.  On the port these are launch-plan
        variants of kernels built once; the name is the reference's, which
        the ``/plan.json`` body and the ``peritext_plan_*`` gauges read."""
        depth_ladder = int(math.log2(config["fused_depth"])) + 1
        slot_ladder = max(1, int(math.log2(max(config["slot_capacity"], 2))))
        return depth_ladder + slot_ladder

    def executable_bytes(self, config: Dict[str, Any]) -> int:
        """Modeled footprint of the variants: their count x the
        per-variant estimate (the largest bucket's ``memory.peak_bytes``
        when the snapshot has one: argument plus output bytes on the
        port)."""
        per = DEFAULT_EXECUTABLE_BYTES
        peaks = []
        for site in sorted(self.snapshot.get("sites") or {}):
            buckets = (self.snapshot["sites"][site] or {}).get("buckets") or {}
            for key in sorted(buckets):
                mem = (buckets[key] or {}).get("memory") or {}
                pb = mem.get("peak_bytes")
                if isinstance(pb, (int, float)) and pb > 0:
                    peaks.append(int(pb))
        if peaks:
            per = max(peaks)
        return self.recompiles(config) * per

    def memory_budget(self) -> Optional[int]:
        """The executable-bytes budget: a fraction of the device memory
        the snapshot observed in use at peak (on the port the CUDA caching
        allocator's peak; None when the snapshot has no memory stats, as
        on the CPU — the tuner then skips the constraint)."""
        mem = self.snapshot.get("memory") or {}
        peak = mem.get("peak_bytes_in_use")
        if isinstance(peak, (int, float)) and peak > 0:
            # peak observed use stands in for device capacity scale: the
            # variants may claim DEFAULT_BUDGET_FRACTION of 10x the peak
            return int(peak * 10 * DEFAULT_BUDGET_FRACTION)
        return None

    def dispatches(self, config: Dict[str, Any]) -> float:
        """Modeled dispatch count of replaying the capture's rounds at
        ``config``'s fused depth (a drain of R pending rounds is one
        commit)."""
        depth = max(1, int(config["fused_depth"]))
        return -(-self.total_rounds // depth) if self.total_rounds else 0

    def score(self, config: Dict[str, Any]) -> float:
        return (self.padded_flops(config)
                + self.RECOMPILE_WEIGHT * self.recompiles(config)
                + (self.DISPATCH_WEIGHT * self.dispatch_weight_factor()
                   * self.dispatches(config)))
