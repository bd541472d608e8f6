"""Runtime build sentinel: counts kernel-library builds and loads, and
CUDA-graph captures.

The port compiles nothing per shape: each CUDA source builds once into a
shared library (``utils/nvcc.py``) and the native host library once with
g++ (``native/``), and each is loaded once per process.  Those builders log
one record per build and one per load on the :data:`KERNEL_LOGGER`
logger.  The fused commit forms capture a CUDA graph per new signature
(``utils/graphs.py``, the port's counterpart of a JAX compile) and log one
record per capture there too.  This handler counts them per library or
graph form, so a steady-state loop can assert that it built, loaded and
captured nothing.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional

from .metrics import Counters, GLOBAL_COUNTERS

#: the logger the kernel builders write their build and load records to
KERNEL_LOGGER = "peritext_tpu_torch.kernels"

#: a builder's record: "Building <library> ..." (one per compiler run),
#: "Loading <library> ..." (one per library load) or "Capturing
#: graph.<form> ..." (one per CUDA-graph capture).  Matched with
#: ``search``, anywhere in the record: a handler downstream of a formatter
#: may receive the message prefixed.
_BUILD_MSG_RE = re.compile(r"\b(Building|Loading|Capturing) (\S+)")

_KINDS = {"Building": "builds", "Loading": "loads", "Capturing": "captures"}


class RecompileSentinel(logging.Handler):
    """Runtime guard for the build-once discipline: counts kernel-library
    builds and loads **per library** (``insert``, ``ragged_insert``,
    ``native``) and graph captures per form (``graph.<form>``).  Counts
    land three ways:

    * :attr:`counts` — ``{library or graph form: builds + loads +
      captures}``, with the kinds apart in :attr:`builds`, :attr:`loads`
      and :attr:`captures`;
    * ``kernel.builds.<library>`` / ``kernel.loads.<library>`` /
      ``kernel.captures.graph.<form>`` on the target :class:`Counters`
      (default :data:`GLOBAL_COUNTERS`);
    * ``health_snapshot(sentinel=s)`` embeds :attr:`counts` and
      :attr:`total`.

    Use as a context manager; :meth:`mark` + :meth:`assert_steady_state`
    express the invariant::

        with RecompileSentinel() as s:
            warmup_rounds(session)
            s.mark()
            steady_rounds(session)
            s.assert_steady_state("steady-state streaming rounds")
    """

    def __init__(self, counters: Optional[Counters] = None, logger: str = KERNEL_LOGGER):
        super().__init__(level=logging.DEBUG)
        self.counts: Dict[str, int] = {}
        self.builds: Dict[str, int] = {}
        self.loads: Dict[str, int] = {}
        self.captures: Dict[str, int] = {}
        self._marked: Dict[str, int] = {}
        self._counters = counters if counters is not None else GLOBAL_COUNTERS
        self._logger = logging.getLogger(logger)
        self._prev_level: Optional[int] = None
        self._active = False

    # -- logging.Handler ------------------------------------------------------

    def emit(self, record: logging.LogRecord) -> None:
        try:
            message = record.getMessage()
        except Exception:  # graftlint: boundary(malformed foreign records are ignored, never raised into the workload)
            return
        m = _BUILD_MSG_RE.search(message)
        if m is None:
            return
        kind, site = _KINDS[m.group(1)], m.group(2)
        table = getattr(self, kind)
        table[site] = table.get(site, 0) + 1
        self.counts[site] = self.counts.get(site, 0) + 1
        self._counters.add(f"kernel.{kind}.{site}")

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "RecompileSentinel":
        if self._active:
            return self
        # the builders log at INFO: the logger must pass it through
        self._prev_level = self._logger.level
        if self._logger.getEffectiveLevel() > logging.INFO:
            self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        self._active = True
        return self

    def stop(self) -> None:
        if not self._active:
            return
        self._logger.removeHandler(self)
        self._logger.setLevel(self._prev_level)
        self._active = False

    def __enter__(self) -> "RecompileSentinel":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    # -- assertions -----------------------------------------------------------

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def mark(self) -> None:
        """Snapshot the current counts; :meth:`since_mark` and
        :meth:`assert_steady_state` measure growth from here."""
        self._marked = dict(self.counts)

    def since_mark(self) -> Dict[str, int]:
        """Per-library (and graph form) builds, loads and captures since
        :meth:`mark` (empty dict = steady state)."""
        return {
            site: n - self._marked.get(site, 0)
            for site, n in sorted(self.counts.items())
            if n > self._marked.get(site, 0)
        }

    def assert_steady_state(self, what: str = "steady-state rounds") -> None:
        fresh = self.since_mark()
        if fresh:
            raise AssertionError(
                f"{what} built or loaded {sum(fresh.values())} kernel "
                f"{'library or graph' if sum(fresh.values()) == 1 else 'libraries or graphs'}"
                f": {fresh}"
            )

    def assert_fresh_sessions_steady(self, what: str, graphs_held: int) -> None:
        """The steady state of sessions made since :meth:`mark` (a graph
        cache lives and dies with its session, so a fresh session captures
        each signature it repeats once): no library built or loaded, and no
        more graph captures than the ``graphs_held`` those sessions' caches
        still hold (a signature captured twice would exceed them)."""
        fresh = self.since_mark()
        built = {k: n for k, n in fresh.items() if not k.startswith("graph.")}
        captured = sum(n for k, n in fresh.items() if k.startswith("graph."))
        if built or captured > graphs_held:
            raise AssertionError(
                f"{what} built or loaded {built}, and captured {captured} graphs for "
                f"{graphs_held} held")
