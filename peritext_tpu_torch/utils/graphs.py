"""CUDA-graph replay of the fused round pipeline's commit forms.

The reference package dispatches a fused batch of rounds as ONE compiled
program, cached by its static signature.  A round of the port is a few
hundred small kernels enqueued from the host (the insert kernel among
them), so the port's form of "one dispatch of a compiled program" on the
card is a captured ``torch.cuda.CUDAGraph``, keyed by the same statics.

:class:`GraphCache` (one per session) runs a commit form's ``body``:

* **Key.** The caller's key (the form's statics tuple) under the cache's
  ``epoch``.  The epoch is bumped whenever the resident buffers the graphs
  read and write by address (``binds``: the session's state, or its page
  pool and aux rows) are not the ones the cache last saw: a reshard, a
  restore into them, pool growth, or a rebinding of the state.  A bump
  drops every graph.
* **When to capture.** A signature's first occurrence runs eagerly (which
  also completes lazy initialisation: library loads, allocator pools); its
  second occurrence captures, then replays, so a one-off signature never
  pays for a capture.  Later occurrences replay (cache hits).  A capture
  costs its caller about two eager runs, so a driver that waits between
  batches (the serving tier's open loop, until its next arrival) offers
  that wait instead: once :meth:`GraphCache.idle` has been called, a
  repeated signature runs eagerly and waits for its capture, which
  :meth:`GraphCache.idle` makes only where its estimate (the signature's
  mean eager seconds times the largest capture-to-eager ratio seen,
  :data:`CAPTURE_COST_RATIO` before one is timed) fits the time offered.
  A capture then lands on no commit's latency, and a signature too costly
  for the waits stays eager.
* **Inputs.** ``inputs`` are copied, device to device, into the graph's
  own input buffers before each replay; a fused batch's staged streams are
  one contiguous int32 buffer, sliced at static offsets inside the body.
* **Outputs.** The body updates the resident buffers in place; what it
  returns (the digest chain's resolution) is cloned right after each
  replay, so no result aliases memory a later replay reuses.
* **Capture.** On a side stream of the device, with
  ``capture_error_mode="thread_local"`` (the staging worker may allocate
  pinned memory and copy on its own stream while this thread captures),
  into one memory pool shared by the session's graphs.  A host sync inside
  the body raises, and the capture is abandoned; nothing falls back.
* **Launch counts.** A captured kernel launch does not run, so it counts
  for the graph (``utils/nvcc.launch_tally``); every replay adds the
  graph's launches to each wrapper's count.
* **Telemetry.** Each capture logs ``Capturing graph.<form>`` on the
  kernel logger (``obs.RecompileSentinel`` counts it, the port's
  counterpart of a compile); :meth:`GraphCache.stats` counts eager runs,
  captures, replays and hits per form.

On the CPU nothing is captured: :meth:`GraphCache.run` runs ``body``.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from .nvcc import add_launches, launch_tally

#: graphs one session keeps, least recently used out first.  A signature is
#: the fused depth (<= FUSE_MAX_ROUNDS) times the power-of-two ladders of
#: stream buckets and slot windows, so a long-lived session meets more of
#: them than it reuses; each graph pins its own intermediates in the
#: session's pool (about one batch's working set), so the bound caps the
#: device memory that graphs of signatures gone quiet can hold
GRAPH_CACHE_BOUND = 32

#: what a capture is taken to cost, in eager runs of its body, until the
#: cache has timed one: an engine pass's capture against its eager pass
#: read 1.8-2.4x on the H100 (chip_smoke.py phase 5k); the larger, so an
#: idle capture is not started where it would overrun its wait
CAPTURE_COST_RATIO = 2.4

_log = logging.getLogger("peritext_tpu_torch.kernels")

_STAT_KEYS = ("eager", "captures", "replays", "hits")


def _binds_signature(binds: Sequence[torch.Tensor]) -> Tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in binds)


def _clone_tree(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, tuple):
        items = [_clone_tree(x) for x in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


class GraphCache:
    """A session's captured commit graphs on ``device`` (module doc)."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.epoch = 0
        self._binds: Tuple = ()
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        #: per signature not captured: [eager runs, their host seconds]
        self._seen: "collections.OrderedDict" = collections.OrderedDict()
        #: signatures waiting for an idle capture: (form, body, inputs,
        #: mean eager seconds), and the least of those means
        self._pending: "collections.OrderedDict" = collections.OrderedDict()
        self._least_eager = float("inf")
        self._deferring = False
        self._capture_ratio = CAPTURE_COST_RATIO
        self._pool = None
        self._stream = None
        self._stats: Dict[str, Dict[str, int]] = {}

    # -- accounting ----------------------------------------------------------

    def _count(self, form: str, what: str) -> None:
        row = self._stats.setdefault(form, dict.fromkeys(_STAT_KEYS, 0))
        row[what] += 1

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per form: eager runs, captures, replays (a capture's own first
        replay included) and hits (replays of a graph already held)."""
        return {form: dict(row) for form, row in sorted(self._stats.items())}

    def __len__(self) -> int:
        return len(self._graphs)

    def bump_epoch(self) -> None:
        """Drop every graph and every signature's occurrence count.  The
        pool goes with them (the allocator frees a private pool once no
        graph holds it), and the next capture starts a new one."""
        self.epoch += 1
        self._graphs.clear()
        self._seen.clear()
        self._pending.clear()
        self._least_eager = float("inf")
        self._pool = None

    # -- running a form ------------------------------------------------------

    def run(self, key: Tuple, form: str, body: Callable, inputs: Sequence[torch.Tensor],
            binds: Sequence[torch.Tensor] = ()):
        """``body(*inputs)``: eagerly, or through the graph of ``key``
        (module doc): captured here on its second occurrence, or, once the
        caller has offered idle time, left to :meth:`idle`.  ``binds`` are
        the resident tensors ``body`` reads or writes in place."""
        if self.device.type != "cuda":
            self._count(form, "eager")
            return body(*inputs)
        sig = _binds_signature(binds)
        if sig != self._binds:
            if self._binds:
                self.bump_epoch()
            self._binds = sig
        key = (self.epoch, form, key,
               tuple((tuple(x.shape), x.dtype) for x in inputs))
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            self._count(form, "hits")
            return self._replay(entry, form, inputs)
        seen = self._seen.pop(key, None) or [0, 0.0]
        self._seen[key] = seen
        while len(self._seen) > 4 * GRAPH_CACHE_BOUND:
            self._seen.popitem(last=False)
        if not seen[0] or self._deferring:
            self._count(form, "eager")
            t0 = time.perf_counter()
            out = body(*inputs)
            seen[0] += 1
            seen[1] += time.perf_counter() - t0
            if seen[0] > 1:
                mean = seen[1] / seen[0]
                self._pending.pop(key, None)
                self._pending[key] = (form, body, tuple(inputs), mean)
                while len(self._pending) > GRAPH_CACHE_BOUND:
                    self._pending.popitem(last=False)
                self._least_eager = min(self._least_eager, mean)
            return out
        entry = self._timed_capture(key, form, body, inputs)
        return self._replay(entry, form, inputs)

    def idle(self, budget_s: float) -> int:
        """The caller waits ``budget_s`` seconds before its next batch:
        capture the pending signatures, newest first, whose estimated
        capture fits what is left of the wait.  From the first call on,
        repeated signatures wait here for their captures (module doc).
        Returns the graphs captured."""
        self._deferring = True
        if budget_s < self._capture_ratio * self._least_eager:  # nothing pending fits
            return 0
        deadline = time.perf_counter() + budget_s
        captured = 0
        for key in reversed(list(self._pending)):
            form, body, inputs, mean = self._pending[key]
            if key[0] != self.epoch:
                del self._pending[key]
            elif time.perf_counter() + self._capture_ratio * mean <= deadline:
                del self._pending[key]
                self._timed_capture(key, form, body, inputs)
                captured += 1
        self._least_eager = min((p[3] for p in self._pending.values()), default=float("inf"))
        return captured

    def _timed_capture(self, key, form: str, body: Callable,
                       inputs: Sequence[torch.Tensor]) -> _Graph:
        """Capture ``key``'s graph and hold it (least recently used out
        past the bound); the capture's host seconds against the
        signature's mean eager run update the cost ratio the idle
        estimates use (the largest seen)."""
        t0 = time.perf_counter()
        entry = self._capture(form, body, inputs)
        seconds = time.perf_counter() - t0
        runs, eager = self._seen.pop(key, (0, 0.0))
        if runs and eager > 0:
            self._capture_ratio = max(self._capture_ratio, seconds * runs / eager)
        self._graphs[key] = entry
        while len(self._graphs) > GRAPH_CACHE_BOUND:
            self._graphs.popitem(last=False)
        return entry

    def _capture(self, form: str, body: Callable, inputs: Sequence[torch.Tensor]) -> _Graph:
        device = self.device
        current = torch.cuda.current_stream(device)
        # the graph's own input buffers, outside the pool: they live as long
        # as the graph, and each replay copies the batch's inputs into them
        static = tuple(torch.empty_like(x) for x in inputs)
        for s, x in zip(static, inputs):
            s.copy_(x)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self._stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.stream(self._stream), \
                launch_tally() as tally:
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                outputs = body(*static)
            except BaseException:  # graftlint: boundary(a failed capture is ended, then the body's own failure propagates unchanged)
                self._abandon(graph)
                raise
            graph.capture_end()
        current.wait_stream(self._stream)
        launches = {w: n for w, n in tally.items() if n}
        _log.info("Capturing graph.%s (%d kernel launches)", form, sum(launches.values()))
        self._count(form, "captures")
        return _Graph(graph, static, outputs, launches)

    def _abandon(self, graph) -> None:
        """End a capture the body broke: the stream leaves capture mode,
        the allocator stops routing the stream's allocations to the pool
        (ending the capture of an invalidated graph raises before it does
        that itself), and the next capture takes a new pool."""
        pool, self._pool = self._pool, None
        try:
            graph.capture_end()
        except RuntimeError:  # graftlint: boundary(the capture is already invalid; the body's own failure is what propagates)
            end = getattr(torch._C, "_cuda_endAllocateToPool", None)
            if end is not None:
                try:
                    end(self.device.index if self.device.index is not None
                        else torch.cuda.current_device(), pool)
                except RuntimeError:  # graftlint: boundary(the allocator had already stopped routing to the pool)
                    pass

    def _replay(self, entry: _Graph, form: str, inputs: Sequence[torch.Tensor]):
        for s, x in zip(entry.inputs, inputs):
            s.copy_(x)
        entry.graph.replay()
        for wrapper, n in entry.launches.items():
            add_launches(wrapper, n)
        self._count(form, "replays")
        return _clone_tree(entry.outputs)
