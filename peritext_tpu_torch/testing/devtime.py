"""Device timing and workload helpers shared by ``chip_smoke.py`` and the
measurement scripts (``scripts/torch_*.py``).

Timing, on a card only (each reads ``torch.cuda``):

* :func:`cuda_time_ms`: mean time per call by CUDA events from an idle
  card (device time, or the host's own time per call where that is
  longer);
* :func:`device_time_ms`: mean device time per call with the host kept
  ahead of the card by a spin kernel (calls of a few launches);
* :class:`DeviceBusy`: device busy ms per call from one ``torch.profiler``
  session (calls of hundreds of launches, or calls that wait for the
  card); :func:`device_events` and :func:`traced_device_ms` read a
  profiler run's device events.

Workloads: :func:`generate` is ``testing.fuzz.generate_workload`` built in
worker processes (:class:`Generation`) where that pays; :func:`workload`
is the job one worker runs.
"""

from __future__ import annotations

import time


def workload(seed: int, docs: int, ops: int):
    """``generate_workload(seed, docs, ops)``: a job to hand a worker
    process (a chunk of :class:`Generation`, or one started early and
    collected later)."""
    from .fuzz import generate_workload

    return generate_workload(seed, docs, ops)


class Generation:
    """``generate_workload(seed, docs, ops)`` started in up to ``workers``
    worker processes (doc d is drawn from seed + d alone, so chunks of docs
    are independent; the result is the same list).  ``result()`` waits for
    it and ends the pool; ``close()`` ends the pool, cancelling the chunks
    not started.  ``nice`` lowers the workers' scheduling priority by that
    much (``os.nice``), so work needed later yields the host's cores to
    work needed sooner."""

    def __init__(self, seed: int, docs: int, ops: int, workers: int = 8, nice: int = 0) -> None:
        import multiprocessing
        import os
        from concurrent.futures import ProcessPoolExecutor

        workers = max(1, min(workers, os.cpu_count() or 1, docs // 64))
        step = -(-docs // (4 * workers))
        self._pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                         initializer=os.nice, initargs=(nice,))
        self._futures = [self._pool.submit(workload, seed + lo, min(step, docs - lo), ops)
                         for lo in range(0, docs, step)]

    def result(self):
        try:
            return [w for f in self._futures for w in f.result()]
        finally:
            self.close()

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


def generate(seed: int, docs: int, ops: int):
    """``generate_workload(seed, docs, ops)``, built in worker processes
    (:class:`Generation`; the pool ends with the call), or in this process
    below 512 docs, where starting the workers costs more than they save."""
    if docs < 512:
        return workload(seed, docs, ops)
    return Generation(seed, docs, ops).result()


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time per call of ``fn()`` over ``reps`` back-to-back calls from
    an idle card, by CUDA events: device time, or the host's own time per
    call where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls, with
    the host kept ahead of the card: a spin kernel holds the stream while
    the host enqueues the calls, so the events bracket the card's work and
    not the wrappers' host time.  The spin must outlast the enqueue, else it
    is retried longer; a call that waits for the card (a device-to-host
    read) can never get ahead, and fails."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin = 2e6  # cycles
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(int(spin))
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        spin_ms = marks[0].elapsed_time(marks[1])
        if spin_ms > host_ms:
            return marks[1].elapsed_time(marks[2]) / reps
        spin *= 2 * host_ms / max(spin_ms, 1e-3)
    raise AssertionError(f"the host never got ahead of the card ({host_ms:.3f} ms to enqueue)")


def device_events(prof):
    """The device events (kernels, copies) of a ``torch.profiler`` run,
    less the device-side copies of user annotations (a
    ``record_function`` range is projected onto the stream it covers)."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and getattr(e, "activity_type", None) != "gpu_user_annotation"]


def traced_device_ms(prof) -> float:
    """The summed duration of a ``torch.profiler`` run's device events, in
    ms: the card's busy time."""
    return sum(e.time_range.elapsed_us() for e in device_events(prof)) / 1e3


class DeviceBusy:
    """Device busy ms per call of several calls, from ONE ``torch.profiler``
    session (a session's start and its parse cost seconds): inside the
    ``with`` block, :meth:`measure` launches a marker (a one-cycle spin
    kernel) and then runs a call ``reps`` times between two CUDA events,
    ending in a synchronize; after the block, ``ms[name]`` is the summed
    duration of the device events between that measurement's marker and
    the next on the device's own clock, over ``reps``.  For calls of many
    kernels, whose launches overrun the launch queue a spin kernel can hold
    the host ahead of (:func:`device_time_ms` would wait for the card).
    Where the session traced fewer markers than measurements (seen late in
    a long process, after many earlier profiler sessions; not in a fresh
    process), ``ms[name]`` is the span between the CUDA events over
    ``reps`` instead, and ``source`` says so."""

    MARKER = "spin_kernel"

    def __init__(self) -> None:
        self.ms = {}
        self.source = "device busy, torch.profiler"
        self._order = []
        self._prof = None

    def __enter__(self) -> "DeviceBusy":
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def measure(self, name: str, fn, reps: int) -> None:
        import torch

        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(1)
        events[0].record()
        for _ in range(reps):
            fn()
        events[1].record()
        torch.cuda.synchronize()
        self._order.append((name, reps, events))

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        events = sorted(device_events(self._prof), key=lambda e: e.time_range.start)
        at = [i for i, e in enumerate(events) if self.MARKER in e.name]
        if len(at) != len(self._order):
            self.source = (f"device span, CUDA events: torch.profiler traced {len(events)} "
                           f"device events, {len(at)} of {len(self._order)} markers")
            self.ms = {name: ev[0].elapsed_time(ev[1]) / reps for name, reps, ev in self._order}
            return
        for k, (name, reps, _) in enumerate(self._order):
            end = at[k + 1] if k + 1 < len(at) else len(events)
            ms = sum(e.time_range.elapsed_us() for e in events[at[k] + 1:end]) / 1e3
            if ms <= 0:
                raise AssertionError(f"torch.profiler recorded no device time in {name}")
            self.ms[name] = ms / reps
