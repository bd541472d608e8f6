"""The traced run's readings: the program's host spans over the whole
window, and a device trace of a fixed slice of its steps.

Spans come from the program's tracer (``peritext_tpu_torch.obs``
``GLOBAL_TRACER``, a sink that keeps each finished span's name and
interval) and from the harness's own spans around each call.  The slice is
``trace_steps`` of the traffic file: ``[first, count]`` steps of the window
under ``torch.profiler``, whose stop is taken out of the window and whose
events are read after it.  The slice runs as the rest of the window does:
the card is synchronised only at its two ends.  A device operation is the
digest's where the host launched it inside the digest's call or its
``wait()`` (a ``bench.digest`` range of the profiler): the profiler links
each device operation to the host operation that launched it.  The
shares of spans read the whole window; the device readings the slice.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

from ..gen.busy import busy, gaps
from .drive import Step


class ProgramSpans:
    """A sink for the program's tracer: (name, start, end) of every span,
    on ``time.time()``."""

    def __init__(self, tracer) -> None:
        self.tracer = tracer
        self.spans: List[Tuple[str, float, float]] = []

    def __call__(self, sp) -> None:
        self.spans.append((sp.name, sp.ts, sp.ts + sp.duration))

    def __enter__(self) -> "ProgramSpans":
        self.tracer.add_sink(self)
        return self

    def __exit__(self, *exc) -> None:
        self.tracer.remove_sink(self)


class Slice(Step):
    """``torch.profiler`` over steps ``[first, first + count)`` of the
    window; after it, ``kernels`` holds (name, start, end) of each device
    operation on ``time.time()``, ``digest_s`` the device seconds of those
    the digest launched, and ``t0``/``t1`` the slice's bounds."""

    def __init__(self, first: int, count: int, cuda: bool) -> None:
        self.first, self.last = first, first + count - 1
        self.cuda = cuda
        self.prof = None
        #: (the stopped profiler, the interval its stop took in the window)
        self.stopped = None
        self.t0 = self.t1 = None
        self.kernels: Optional[List[Tuple[str, float, float]]] = None
        self.digest_s = 0.0
        self.note = ""

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def before(self, i: int) -> None:
        if i != self.first:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.time()
        with record_function("bench.anchor"):
            pass

    def digest(self):
        if self.prof is None:
            return nullcontext()
        from torch.profiler import record_function

        return record_function("bench.digest")

    def after(self, i: int) -> None:
        if i != self.last or self.prof is None:
            return
        self._sync()
        self.t1 = time.time()
        self.prof.__exit__(None, None, None)
        self.stopped = (self.prof, (self.t1, time.time()))
        self.prof = None

    def finish(self) -> None:
        """After the window: read the slice's device operations, or end a
        slice the window closed before it was over (no readings)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None
        if self.stopped is not None:
            self.kernels, self.digest_s, self.note = device_ops(self.stopped[0], self.t0)
            self.stopped = (None, self.stopped[1])


def device_ops(prof, t_anchor: float) -> Tuple[List[Tuple[str, float, float]], float, str]:
    """The profiler's device operations (kernels, copies, memsets), less
    the device-side copies of user annotations, as (name, start, end) on
    ``time.time()``: the profiler's clock is pinned to the wall clock at the
    ``bench.anchor`` range, opened right after ``t_anchor`` was read.  Also
    the device seconds of the operations launched by host operations that
    began inside a ``bench.digest`` range on that range's thread (the
    profiler lists under each host operation the device operations it
    launched), and a line on how they were found."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    anchor = next(e for e in events if e.name == "bench.anchor")
    base = t_anchor - anchor.time_range.start / 1e6
    ranges = [(e.thread, e.time_range.start, e.time_range.end) for e in events
              if e.name == "bench.digest" and e.device_type == cpu]
    # host operations that launch: not the launch calls, which carry a link
    # to the operation they serve
    inside = [e for e in events
              if e.device_type == cpu and not getattr(e, "linked_correlation_id", 0)
              and not e.name.startswith("cuda")
              and any(t == e.thread and a <= e.time_range.start <= b for t, a, b in ranges)]
    digest_us = sum(k.duration for e in inside for k in e.kernels)
    out = [(e.name, base + e.time_range.start / 1e6, base + e.time_range.end / 1e6)
           for e in events
           if e.device_type == cuda and not getattr(e, "is_user_annotation", False)
           and getattr(e, "activity_type", None) != "gpu_user_annotation"]
    note = (f"{len(ranges)} digest ranges, {len(inside)} host operations inside, "
            f"{sum(len(e.kernels) for e in inside)} device operations they launched")
    return out, digest_us / 1e6, note


class Context:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    def __init__(self, window: Tuple[float, float], program_spans, bench_spans,
                 slice_: Optional[Slice], graphs: Optional[Dict], fallback_docs: int,
                 slice_work: Optional[Dict]) -> None:
        self.t0, self.t1 = window
        # the profiler's stop is the harness's own work: out of the window
        stop = slice_.stopped[1] if slice_ is not None and slice_.stopped else (0.0, 0.0)
        self.window_s = self.t1 - self.t0 - (stop[1] - stop[0])
        self.program_spans = program_spans
        self.bench_spans = bench_spans
        self.slice = slice_ if slice_ is not None and slice_.kernels else None
        self.graphs = graphs
        self.fallback_docs = fallback_docs
        #: the slice's work from the reference: K1 ``inserts`` and
        #: ``insert_ops``, and ``digest_bytes``
        self.slice_work = slice_work

    def span_share(self, program: Sequence[str] = (), harness: Sequence[str] = ()
                   ) -> Optional[float]:
        """Percent of the window inside the union of the program's spans
        named in ``program`` and the harness's named in ``harness``."""
        iv = [(a, b) for n, a, b in self.program_spans if n in program]
        iv += [(a, b) for n, a, b in self.bench_spans if n in harness]
        if not iv or self.window_s <= 0:
            return None
        return 100.0 * busy(iv, self.t0, self.t1) / self.window_s

    def kernel_seconds(self, name_has: str = "", digest: bool = False) -> Optional[float]:
        """Summed device seconds of the slice's operations: those whose name
        holds ``name_has``, or with ``digest``, those the digest launched."""
        if self.slice is None:
            return None
        if digest:
            total = self.slice.digest_s
        else:
            total = sum(b - a for n, a, b in self.slice.kernels if name_has in n)
        return total if total > 0 else None

    def device_busy_s(self) -> Optional[float]:
        if self.slice is None:
            return None
        return busy([(a, b) for _, a, b in self.slice.kernels], self.slice.t0, self.slice.t1)


def breakdown(ctx: Context, top: int = 10) -> Optional[Dict]:
    """The slice's device operations that took most time, and its longest
    idle gaps, each labelled by the innermost host span that covers half of it or more
    (else by the span that covers most of it)."""
    if ctx.slice is None:
        return None
    by_name: Dict[str, float] = {}
    for name, a, b in ctx.slice.kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = ctx.program_spans + ctx.bench_spans
    idle = sorted(gaps([(a, b) for _, a, b in ctx.slice.kernels], ctx.slice.t0, ctx.slice.t1),
                  key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for a, b in idle:
        cover = [(min(b, e) - max(a, s), e - s, n) for n, s, e in spans if s < b and e > a]
        half = [(length, n) for part, length, n in cover if part >= (b - a) / 2]
        name = min(half)[1] if half else (max(cover)[2] if cover else "none")
        labelled.append([f"host:{name}", b - a])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}
