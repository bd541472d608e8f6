"""Device-cost observability: what the merge's kernel launches cost.

Every other plane of this package watches the HOST side of the pipeline.
This module is the device-facing counterpart: :class:`DeviceProfiler`
captures, per launch site and shape bucket:

* **Shape buckets** — :meth:`~DeviceProfiler.shape_signature` derives a
  stable key from the site call's actual tensor shapes and dtypes plus its
  statics: the widths, the insert phase's ``loop_slots`` and the launch
  plan of its insert kernel (``ops/insert.insert_teams`` /
  ``ops/ragged_insert.ragged_teams``), the port's launch granularity.  A
  site is one of the ops-level entry points (``apply_batch``,
  ``apply_batch_paged``, ``apply_batch_paged_groups``,
  ``apply_batch_compact``, ``apply_batch_ragged``) or a fused round
  pipeline form under the reference's site name
  (``apply_batch_staged_rounds``, ``apply_batch_stacked_rounds``,
  ``apply_batch_stacked_rounds_multi``, ``apply_batch_compact_rounds``,
  ``_fused_rounds_digest``, ``_stacked_rounds_digest``: one call per
  committed batch, whether it runs eagerly, is captured into a CUDA graph
  or replays one); a site called inside another site's call belongs to
  the outer one, so each kernel launch is counted by exactly one site
  call.
* **Launch costs** (``capture_costs``) — on a bucket's first dispatch:
  ``cost`` = ``device_ms`` (the whole site call, between a CUDA event pair
  recorded on the caller's current stream and read only in
  :meth:`~DeviceProfiler.snapshot`; None on the CPU), ``kernel_bytes``
  (what the site's insert launches must move, by the formula of the card
  smoke's bound: ``ops/insert.insert_batch_bytes``,
  ``ops/ragged_insert.ragged_insert_bytes``) and ``kernel_launches``;
  ``memory`` = argument and output tensor bytes and ``peak_bytes``, their
  sum (temporaries are not counted).  Capture launches nothing of its own
  and reads nothing back from the card.  A fused form's events are
  recorded around its whole call (an eager run or a graph replay), never
  inside a graph capture.
* **Bucket occupancy** — per padded-shape bucket (:func:`occupancy_key`):
  rounds, real ops vs padded op-stream capacity, and the padding waste.
* **Device-memory watermarks** — :meth:`~DeviceProfiler.sample_memory`
  reads the CUDA caching allocator's counters (``torch.cuda.memory_stats``:
  host-side, no sync) at round boundaries.  A CPU session has no such
  counters; the snapshot then reports ``available: false``.  A card whose
  counters cannot be read raises: that answer is never given for a card.
* **Page pool, ragged walk** — the pooled layouts' latest pool stats with
  a peak-utilization watermark, and the ragged applies' walked docs and
  pages.

Profiling is OFF by default (``GLOBAL_DEVPROF.enabled`` is False) and every
hook in the merge stack is behind that one attribute check, so the
disabled cost is a single branch per call.  The hooks hold the profiler's
lock only for dict updates, never across a launch, and read only host
arrays the caller already holds: they never synchronize the card.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch


def _describe(obj: Any, out: list) -> None:
    """Flatten a site call's arguments into a deterministic textual
    descriptor: tensors become ``dtype[shape]``, containers recurse in
    sorted key order, ``None`` is preserved (an absent optional stream is a
    different call)."""
    if obj is None:
        out.append("none")
    elif isinstance(obj, dict):
        out.append("{")
        for k in sorted(obj):
            out.append(f"{k}:")
            _describe(obj[k], out)
        out.append("}")
    elif isinstance(obj, (tuple, list)):
        out.append("(")
        for item in obj:
            _describe(item, out)
        out.append(")")
    elif hasattr(obj, "shape") and hasattr(obj, "dtype"):
        out.append(f"{obj.dtype}{tuple(obj.shape)}")
    else:
        out.append(repr(obj))


def _nbytes(obj: Any) -> int:
    """Bytes of every tensor or array in a nested argument tree (shape
    metadata only: nothing is read from the card)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_nbytes(v) for v in obj)
    return int(getattr(obj, "nbytes", 0) or 0)


class _ShapeBucket:
    """One (site, shape and plan) bucket: dispatch count plus the cost and
    memory captured on its first dispatch (``events``: the CUDA event pair
    of that call until :meth:`DeviceProfiler.snapshot` reads it)."""

    __slots__ = ("sig", "dispatches", "cost", "memory", "events")

    def __init__(self, sig: str) -> None:
        self.sig = sig
        self.dispatches = 0
        self.cost: Optional[Dict[str, Any]] = None
        self.memory: Optional[Dict[str, int]] = None
        self.events: Optional[Tuple[Any, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {
            "dispatches": self.dispatches,
            "sig": self.sig,
            "cost": dict(self.cost) if self.cost is not None else None,
            "memory": dict(self.memory) if self.memory is not None else None,
        }


class _Occupancy:
    """One padded-shape bucket's occupancy accounting."""

    __slots__ = ("origin", "rounds", "real_ops", "padded_capacity")

    def __init__(self, origin: str) -> None:
        self.origin = origin
        self.rounds = 0
        self.real_ops = 0
        self.padded_capacity = 0

    def to_json(self) -> Dict[str, Any]:
        waste = (
            1.0 - self.real_ops / self.padded_capacity
            if self.padded_capacity else 0.0
        )
        return {
            "origin": self.origin,
            "rounds": self.rounds,
            "real_ops": self.real_ops,
            "padded_capacity": self.padded_capacity,
            "padding_waste": round(waste, 4),
        }


#: the site call the current thread is inside, if any: a site called from
#: another site's call belongs to the outer one
_active = threading.local()


class DeviceProfiler:
    """Per-site / per-shape-bucket device-cost collector (module doc).

    Use :meth:`enable` / :meth:`disable` (or the context-manager form) to
    bound a profiled region; :meth:`snapshot` is the JSON-serializable
    export every surface (``/devprof.json``, ``health_snapshot(devprof=)``,
    the perf ledger, ``peritext_device_*`` gauges) shares.
    """

    def __init__(self, capture_costs: bool = False) -> None:
        self.enabled = False
        self.capture_costs = capture_costs
        self._lock = threading.Lock()
        self._sites: Dict[str, Dict[str, _ShapeBucket]] = {}
        self._occupancy: Dict[str, _Occupancy] = {}
        self._mem_samples = 0
        self._mem_last: Optional[int] = None
        self._mem_peak: Optional[int] = None
        self._mem_backend_peak: Optional[int] = None
        self._page_pool: Optional[Dict[str, Any]] = None
        self._page_pool_peak_util = 0.0
        self._ragged: Optional[Dict[str, int]] = None
        self._mesh: Optional[Dict[str, Any]] = None
        self._mesh_peak_imbalance = 0.0

    # -- lifecycle ----------------------------------------------------------

    def enable(self, capture_costs: Optional[bool] = None) -> "DeviceProfiler":
        if capture_costs is not None:
            self.capture_costs = capture_costs
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._sites = {}
            self._occupancy = {}
            self._mem_samples = 0
            self._mem_last = None
            self._mem_peak = None
            self._mem_backend_peak = None
            self._page_pool = None
            self._page_pool_peak_util = 0.0
            self._ragged = None
            self._mesh = None
            self._mesh_peak_imbalance = 0.0

    def __enter__(self) -> "DeviceProfiler":
        return self.enable()

    def __exit__(self, *exc_info) -> None:
        self.disable()

    # -- shape-bucket keys --------------------------------------------------

    @staticmethod
    def shape_signature(tree: Any, static: Tuple = ()) -> Tuple[str, str]:
        """``(key, sig)`` for one site call: ``sig`` is the readable
        descriptor (argument shapes/dtypes + statics), ``key`` its stable
        hash."""
        parts: list = []
        _describe(tree, parts)
        if static:
            parts.append(f"static={static!r}")
        sig = " ".join(parts)
        key = hashlib.sha1(sig.encode()).hexdigest()[:16]
        return key, sig

    # -- site calls + occupancy accounting ----------------------------------

    def note_dispatch(self, site: str, key: str, sig: str = "") -> Optional[_ShapeBucket]:
        """Record one call of ``site`` under shape bucket ``key``; returns
        the bucket when this call is its first and costs are captured (the
        caller fills its ``cost`` and ``memory``), else None."""
        with self._lock:
            buckets = self._sites.setdefault(site, {})
            bucket = buckets.get(key)
            capture = None
            if bucket is None:
                bucket = buckets[key] = _ShapeBucket(sig)
                if self.capture_costs:
                    capture = bucket
            bucket.dispatches += 1
        return capture

    def launch(
        self,
        site: str,
        tensors: Any,
        static: Tuple,
        run: Callable[[], Any],
        *,
        device: torch.device,
        kernel_launches: Optional[int] = 0,
        kernel_bytes: Optional[int] = None,
        written: Any = None,
    ) -> Any:
        """Run one site call, ``run()``, under the profiler and return its
        result.  ``tensors`` and ``static`` make the bucket key;
        ``kernel_launches`` and ``kernel_bytes`` are the call's planned
        insert launches and the bytes they must move; ``written`` names the
        tensors an in-place call updates (its output, when ``run`` returns
        None).  A call made inside another site's call, or while the
        profiler is off, just runs.  A failure of ``run`` propagates
        untouched (the bucket then keeps ``cost`` None)."""
        if not self.enabled or getattr(_active, "site", None) is not None:
            return run()
        key, sig = self.shape_signature(tensors, static)
        capture = self.note_dispatch(site, key, sig)
        events = stream = None
        if capture is not None and device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        _active.site = site
        try:
            out = run()
        finally:
            _active.site = None
        if capture is not None:
            if events is not None:
                events[1].record(stream)
            cost = memory = None
            try:
                cost = {"device_ms": None, "kernel_bytes": kernel_bytes,
                        "kernel_launches": kernel_launches}
                arg = _nbytes(tensors)
                res = _nbytes(out if out is not None else written)
                memory = {"argument_size_in_bytes": arg, "output_size_in_bytes": res,
                          "peak_bytes": arg + res}
            except Exception:  # graftlint: boundary(capture is best-effort telemetry over host metadata)
                cost = memory = None
            with self._lock:
                capture.cost, capture.memory = cost, memory
                capture.events = events if cost is not None else None
        return out

    def observe_round(
        self, bucket: str, real_ops: int, padded_capacity: int,
        rounds: int = 1, origin: str = "streaming.round",
    ) -> None:
        """Fold one committed round (or one batch merge) into the
        bucket-occupancy table."""
        with self._lock:
            occ = self._occupancy.get(bucket)
            if occ is None:
                occ = self._occupancy[bucket] = _Occupancy(origin)
            occ.rounds += rounds
            occ.real_ops += int(real_ops)
            occ.padded_capacity += int(padded_capacity)

    def observe_page_pool(self, stats: Dict[str, Any]) -> None:
        """Fold one page-pool snapshot (store/paged.PagedDocStore
        ``pool_stats()``) in: the latest snapshot is kept whole, plus a
        peak-utilization watermark across the profiled region."""
        with self._lock:
            self._page_pool = dict(stats)
            util = float(stats.get("pool_utilization") or 0.0)
            self._page_pool_peak_util = max(self._page_pool_peak_util, util)

    def observe_mesh(self, stats: Dict[str, Any]) -> None:
        """Fold one mesh-shard snapshot in (latest kept whole, plus a peak
        shard-imbalance watermark): a mesh session's ``_mesh_stats()``,
        observed at the end of each of its commits."""
        with self._lock:
            self._mesh = dict(stats)
            ratio = float(stats.get("imbalance_ratio") or 0.0)
            self._mesh_peak_imbalance = max(self._mesh_peak_imbalance, ratio)

    def observe_ragged(self, docs_walked: int, pages_walked: int,
                       real_ops: int, padded_slot_waste: int = 0,
                       dispatches: int = 1) -> None:
        """Fold one ragged apply's plan stats in: docs and pool pages the
        plan walked, the real ops applied, and any padded-slot waste (0 by
        construction: true counts are trip counts, not shapes)."""
        with self._lock:
            if self._ragged is None:
                self._ragged = {
                    "dispatches": 0, "docs_walked": 0, "pages_walked": 0,
                    "real_ops": 0, "padded_slot_waste": 0,
                }
            r = self._ragged
            r["dispatches"] += int(dispatches)
            r["docs_walked"] += int(docs_walked)
            r["pages_walked"] += int(pages_walked)
            r["real_ops"] += int(real_ops)
            r["padded_slot_waste"] += int(padded_slot_waste)

    # -- device-memory watermarks -------------------------------------------

    def sample_memory(self, device=None) -> Optional[int]:
        """Sample ``device``'s allocator counters; returns ``bytes_in_use``
        (``allocated_bytes.all.current``), or None for a CPU device (or
        none given), which has no such counters.  On a card the counters
        must be readable: a failure raises."""
        stats = None
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            raw = torch.cuda.memory_stats(dev)
            try:
                stats = (int(raw["allocated_bytes.all.current"]),
                         int(raw["allocated_bytes.all.peak"]))
            except KeyError as exc:
                raise RuntimeError(
                    f"device profiler: {dev} reports no allocator counter {exc}") from exc
        with self._lock:
            self._mem_samples += 1
            if stats is None:
                return None
            in_use, peak = stats
            self._mem_last = in_use
            self._mem_peak = max(self._mem_peak or 0, in_use)
            self._mem_backend_peak = peak
            return self._mem_last

    # -- export -------------------------------------------------------------

    def distinct_shapes(self) -> Dict[str, int]:
        """Per-site distinct bucket counts (shape and launch plan)."""
        with self._lock:
            return {site: len(b) for site, b in sorted(self._sites.items())}

    def _read_events(self) -> None:
        """Turn every captured event pair into its bucket's ``device_ms``:
        waits for the end event (the read point), outside the lock."""
        with self._lock:
            pending = [b for buckets in self._sites.values() for b in buckets.values()
                       if b.events is not None]
        for bucket in pending:
            start, end = bucket.events
            end.synchronize()
            ms = start.elapsed_time(end)
            with self._lock:
                if bucket.cost is not None:
                    bucket.cost["device_ms"] = ms
                bucket.events = None

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-serializable document: the shape-bucket table per site
        (with any captured cost/memory), the bucket-occupancy table, the
        device-memory watermarks and the page-pool and ragged sections
        (None until a pooled layout reports in).  The key sets at every
        level are the reference package's."""
        self._read_events()
        with self._lock:
            sites = {
                site: {
                    "distinct_shapes": len(buckets),
                    "dispatches": sum(b.dispatches for b in buckets.values()),
                    "buckets": {
                        key: b.to_json() for key, b in sorted(buckets.items())
                    },
                }
                for site, buckets in sorted(self._sites.items())
            }
            occupancy = {
                k: o.to_json() for k, o in sorted(self._occupancy.items())
            }
            real = sum(o.real_ops for o in self._occupancy.values())
            padded = sum(o.padded_capacity for o in self._occupancy.values())
            rounds = sum(o.rounds for o in self._occupancy.values())
            memory = {
                "available": self._mem_last is not None,
                "samples": self._mem_samples,
                "bytes_in_use": self._mem_last,
                "peak_bytes_in_use": (
                    self._mem_backend_peak
                    if self._mem_backend_peak is not None
                    else self._mem_peak
                ),
            }
            page_pool = (
                dict(self._page_pool,
                     peak_utilization=round(self._page_pool_peak_util, 4))
                if self._page_pool is not None
                else None
            )
            ragged = dict(self._ragged) if self._ragged is not None else None
            mesh = (
                dict(self._mesh,
                     peak_imbalance=round(self._mesh_peak_imbalance, 4))
                if self._mesh is not None
                else None
            )
        return {
            "enabled": self.enabled,
            "capture_costs": self.capture_costs,
            "sites": sites,
            "occupancy": occupancy,
            "occupancy_totals": {
                "rounds": rounds,
                "real_ops": real,
                "padded_capacity": padded,
                "padding_waste": round(1.0 - real / padded, 4) if padded else 0.0,
            },
            "memory": memory,
            "page_pool": page_pool,
            "ragged": ragged,
            "mesh": mesh,
        }


#: Default process-wide device profiler — OFF by default; every hook in the
#: merge stack checks ``GLOBAL_DEVPROF.enabled`` before doing any work.
GLOBAL_DEVPROF = DeviceProfiler()


def occupancy_key(docs: int, ki: int, kd: int, km: int, kp: int) -> str:
    """The ONE spelling of a padded-shape occupancy bucket — every producer
    (streaming rounds, batch merges) shares it."""
    return f"D{docs}.ki{ki}.kd{kd}.km{km}.kp{kp}"


def plan_static(teams) -> Tuple:
    """A launch plan (``ops/insert.TeamLaunch`` list) as a bucket-key
    static: per launch its team, docs, window, memory variant, threads and
    docs per block."""
    return tuple((t.team, t.num_docs, t.window, t.shared, t.threads, t.docs_per_block)
                 for t in teams)


def note_launch(
    site: str,
    tensors: Any,
    static: Tuple,
    run: Callable[[], Any],
    *,
    device: torch.device,
    kernel_launches: Optional[int] = 0,
    kernel_bytes: Optional[int] = None,
    written: Any = None,
    profiler: Optional[DeviceProfiler] = None,
) -> Any:
    """:meth:`DeviceProfiler.launch` on ``profiler`` (default
    :data:`GLOBAL_DEVPROF`): run one site call under the profiler and return
    its result.  Callers on hot paths guard on ``enabled`` first; this just
    runs ``run()`` when profiling is off."""
    p = profiler if profiler is not None else GLOBAL_DEVPROF
    if not p.enabled:
        return run()
    return p.launch(site, tensors, static, run, device=device,
                    kernel_launches=kernel_launches, kernel_bytes=kernel_bytes,
                    written=written)
