"""The capture-root marker: the port's counterpart of ``@jax.jit`` as a
root of the traced-code rules (analysis/rules PTL002-PTL004).

A body that a graph cache runs (utils/graphs.GraphCache.run) executes
inside a CUDA-graph capture, and so does every function it calls.  The
rules find a body and what it reaches within its own file; a function that
a body reaches in ANOTHER module is marked :func:`captured` so that the
rules scan it too.  The marker changes nothing at run time: it records the
function's ``(module, qualname)`` in :data:`CAPTURE_ROOTS` and returns it.
``static=`` names the parameters that are host values fixed per graph (a
window, a width, a layout), which the rules read as static, not captured.

The capture audit (testing/capture_audit.py) checks on a real capture that
every package function run inside it is a body, a marked root or reachable
from one: a function outside that set is a missing marker.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Set, Tuple

#: ``(module, qualname)`` of every function marked :func:`captured`
CAPTURE_ROOTS: Set[Tuple[str, str]] = set()


def captured(fn: Optional[Callable] = None, *, static: Iterable[str] = ()):
    """Mark ``fn`` as a capture root (module doc); ``@captured`` or
    ``@captured(static=("widths", ...))``.  Returns ``fn`` unchanged."""
    del static  # read from the source by the rules, never at run time

    def mark(f: Callable) -> Callable:
        CAPTURE_ROOTS.add((f.__module__, f.__qualname__))
        return f

    return mark if fn is None else mark(fn)
