"""The capture audit: which package functions run inside a CUDA-graph
capture, held against the set the traced-code rules scan.

The rules PTL002-PTL004 (analysis/) scan the *captured set*: every body a
graph cache runs, every def marked with the capture-root marker
(utils/capture.captured), every def reachable from one of them through the
file-local call graph, and the lambdas, generator expressions and nested
defs inside those (analysis/astutil.py).  The set is computed from the
package's source files, never by loading them.  Reachability stays within
a file, so a function that a body reaches in another module is in the set
only if it is marked; :func:`audit_call` shows on a real run which
functions ran, and which of them are outside the set: each one is a missing
marker (add it; never a baseline entry).

:func:`audit_call` runs a callable under :func:`sys.setprofile`, on the
calling thread and for that call only, and records the ``(module,
qualname)`` of every function of the package that starts.
:class:`CaptureAudit` is the graph caches' hook (utils/graphs.GraphCache
``audit``): as a context manager it is armed for every cache, and the
first run of each ``(form, site)`` (a capture on the card, an eager run on
the CPU) goes through :func:`audit_call`; later ones run as they would.
Only tests and the card smoke arm it.
"""

from __future__ import annotations

import ast
import functools
import os
import sys
from pathlib import Path
from typing import Callable, Dict, FrozenSet, List, Tuple

from ..analysis import astutil
from ..utils.graphs import GraphCache

PACKAGE_DIR = Path(__file__).resolve().parent.parent

Function = Tuple[str, str]  # (module, qualname)


def _module_name(path: Path) -> str:
    parts = path.relative_to(PACKAGE_DIR.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


@functools.lru_cache(maxsize=1)
def captured_set() -> FrozenSet[Function]:
    """``(module, qualname)`` of every function the traced-code rules scan
    in the package's sources (module doc)."""
    out = set()
    for path in sorted(PACKAGE_DIR.rglob("*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
        captured = astutil.captured_functions(tree)
        if not captured:
            continue
        names = astutil.qualnames(tree)
        module = _module_name(path)
        for node, _ in captured.values():
            out.update((module, names[id(n)]) for n in ast.walk(node) if id(n) in names)
    return frozenset(out)


def audit_call(fn: Callable, *args, captured: FrozenSet[Function] = None):
    """``(result, seen, outside)``: ``fn(*args)``, the package functions
    that ran in it (in the order they first started) and those of them
    outside ``captured`` (default: :func:`captured_set`)."""
    if captured is None:
        captured = captured_set()
    prefix = str(PACKAGE_DIR) + os.sep
    modules: Dict[str, str] = {}
    seen: Dict[Function, None] = {}

    def profile(frame, event, arg) -> None:
        if event != "call":
            return
        code = frame.f_code
        filename = code.co_filename
        if not filename.startswith(prefix):
            return
        module = modules.get(filename)
        if module is None:
            module = modules[filename] = _module_name(Path(filename))
        seen.setdefault((module, code.co_qualname), None)

    previous = sys.getprofile()
    sys.setprofile(profile)
    try:
        result = fn(*args)
    finally:
        sys.setprofile(previous)
    functions = list(seen)
    return result, functions, [f for f in functions if f not in captured]


class CaptureAudit:
    """The graph caches' audit hook (module doc): ``with CaptureAudit() as
    audit:`` arms it for every :class:`~..utils.graphs.GraphCache`, and
    :attr:`reports` maps each audited ``(form, site)`` to ``(seen,
    outside)``.  ``form`` is the first element of the caller's key (the
    padded forms' ``flat``/``stacked``/``mesh_stacked``/``multi``,
    ``paged``, ``ragged``, ``engine``), ``site`` the cache's form name."""

    def __init__(self, captured: FrozenSet[Function] = None) -> None:
        self.captured = captured_set() if captured is None else captured
        self.reports: Dict[Tuple[str, str], Tuple[List[Function], List[Function]]] = {}
        self._previous = None

    def __call__(self, key, site: str, body: Callable, inputs):
        form = key[0] if isinstance(key, tuple) and key else key
        label = (str(form), site)
        if label in self.reports:
            return body(*inputs)
        result, seen, outside = audit_call(body, *inputs, captured=self.captured)
        self.reports[label] = (seen, outside)
        return result

    def __enter__(self) -> "CaptureAudit":
        self._previous = GraphCache.audit
        GraphCache.audit = self
        return self

    def __exit__(self, *exc_info) -> None:
        GraphCache.audit = self._previous

    def outside(self) -> List[Function]:
        """Every audited function outside the captured set, once each."""
        return sorted({f for _, out in self.reports.values() for f in out})

    def summary(self) -> Dict[str, Dict[str, object]]:
        """Per ``form/site``: the functions seen and those outside the set
        (the card smoke's ``capture audit`` line)."""
        return {f"{form}/{site}": {"seen": len(seen),
                                   "outside": [f"{m}:{q}" for m, q in out]}
                for (form, site), (seen, out) in sorted(self.reports.items())}
