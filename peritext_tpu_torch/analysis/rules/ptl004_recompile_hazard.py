"""PTL004 — capture hazards at graph-cache callsites and shape construction.

The reference's recompile-hazard rule, with a CUDA-graph capture for a
compiled executable (analysis/astutil.py).  A graph cache holds one graph
per key (utils/graphs.GraphCache: the caller's key, every input's shape
and dtype, the resident buffers), so three patterns turn "capture once,
replay forever" into "capture per call":

* an element of a ``run`` call's ``key`` fed a per-call shape-derived
  scalar (``len(...)``, ``x.shape[i]``, ``x.size(i)``) that no width bucket
  rounds: every distinct value is a new capture;
* a device-tensor constructor whose shape embeds a raw ``len(...)``
  instead of routing through the padded-shape tables (``_width_bucket``),
  in a merge-scope module (the tensors that become graph inputs) or in a
  captured function: every new doc population is a new input shape, or,
  inside a capture, a shape frozen into the graph.  An ``x.shape`` read
  stays allowed there, as in the reference: an input's shape is part of
  the graph's key;
* a variable-length list or tuple built inline as a ``run`` call's
  ``inputs``: every length is a new key.

The messages are the reference's with :data:`WORD_REPLACEMENTS` applied
(reference words -> port words): "static arg" -> "key element", "jit
callsite" -> "graph-cache callsite", "recompiles" -> "captures anew",
"pytree signature" -> "graph key", "a padded array" -> "a padded tensor".
A callsite is named by its body.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from .. import astutil
from ..engine import FileContext, Finding, Rule

#: device-tensor constructors only — host-side np buffers get their shapes
#: managed at the graph-cache boundary (padding/bucketing) and are not
#: themselves graph inputs
_CONSTRUCTORS = {"torch.zeros", "torch.ones", "torch.empty", "torch.full"}

#: (reference words, port words), applied in order to a reference message
WORD_REPLACEMENTS = (
    ("static arg", "key element"),
    ("jit callsite", "graph-cache callsite"),
    ("recompiles", "captures anew"),
    ("pytree signature", "graph key"),
    ("a padded array", "a padded tensor"),
)


class RecompileHazardRule(Rule):
    rule_id = "PTL004"
    scope = "all"
    summary = "graph-cache callsite / tensor shape that captures per distinct value"
    rationale = (
        "one captured graph per signature is the replay contract; per-doc "
        "scalars and unbucketed shapes mint a capture per doc"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for call in astutil.graph_run_calls(ctx.tree):
            yield from self._check_run_callsite(ctx, call)
        captured = {id(n) for n, _ in astutil.captured_functions(ctx.tree).values()}
        for node in astutil.tree_nodes(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            if name is None or ctx.resolve(name) not in _CONSTRUCTORS:
                continue
            if ctx.in_merge_scope or any(id(a) in captured for a in ctx.ancestors(node)):
                yield from self._check_constructor(ctx, node, ctx.resolve(name))

    # -- graph-cache callsites ------------------------------------------------

    def _check_run_callsite(self, ctx: FileContext, call: ast.Call) -> Iterator[Finding]:
        body = astutil.run_argument(call, 2, "body")
        if isinstance(body, ast.Lambda):
            name = "<lambda>"
        else:
            name = (astutil.dotted_name(body) if body is not None else None) or "<body>"
        key = astutil.run_argument(call, 0, "key")
        for i, element in _key_elements(key):
            culprit = self._shape_derived(ctx, element, shapes=True)
            if culprit:
                yield ctx.finding(
                    self.rule_id,
                    element,
                    f"key element {i} of graph-cache callsite '{name}' is "
                    f"shape-derived ({culprit}) — every distinct value "
                    "captures anew; route it through the padded-shape tables",
                )
        inputs = astutil.run_argument(call, 3, "inputs")
        if inputs is not None and self._varlen_sequence(inputs):
            yield ctx.finding(
                self.rule_id,
                inputs,
                f"variable-length sequence built inline at graph-cache callsite "
                f"'{name}' — each length is a new graph key; pass "
                "a padded tensor",
            )

    # -- tensor constructors --------------------------------------------------

    def _check_constructor(
        self, ctx: FileContext, call: ast.Call, resolved: str
    ) -> Iterator[Finding]:
        shape_args = list(call.args[:1]) + [
            kw.value for kw in call.keywords if kw.arg == "size"
        ]
        for shape in shape_args:
            culprit = self._shape_derived(ctx, shape, stop_at=call)
            if culprit:
                yield ctx.finding(
                    self.rule_id,
                    shape,
                    f"'{resolved}' shape embeds raw {culprit} — per-doc "
                    "sizes must route through a width bucket "
                    f"({'/'.join(sorted(ctx.config.bucket_fns))}) so shapes "
                    "stay stable across rounds",
                )

    # -- helpers --------------------------------------------------------------

    def _varlen_sequence(self, arg: ast.AST) -> bool:
        if isinstance(arg, (ast.ListComp, ast.GeneratorExp)):
            return True
        return isinstance(arg, ast.Call) and astutil.call_name(arg) in ("list", "tuple")

    def _shape_derived(
        self, ctx: FileContext, expr: ast.AST, stop_at: Optional[ast.AST] = None,
        shapes: bool = False,
    ) -> Optional[str]:
        """Raw ``len(...)`` read inside ``expr`` (with ``shapes``, also an
        ``x.shape[i]`` or ``x.size(i)`` read) that is not wrapped by a
        bucket function; returns a description or None."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and astutil.call_name(node) == "len":
                culprit = "len(...)"
            elif shapes and _shape_read(node):
                culprit = ".shape[...]"
            else:
                continue
            if self._bucketed(ctx, node, stop_at):
                continue
            return culprit
        return None

    def _bucketed(
        self, ctx: FileContext, node: ast.AST, stop_at: Optional[ast.AST]
    ) -> bool:
        for anc in ctx.ancestors(node):
            if anc is stop_at:
                return False
            if isinstance(anc, ast.Call):
                name = astutil.call_name(anc)
                if name and name.rpartition(".")[2] in ctx.config.bucket_fns:
                    return True
        return False


def _shape_read(node: ast.AST) -> bool:
    """``x.shape[i]`` or ``x.size(i)``."""
    if isinstance(node, ast.Subscript):
        return isinstance(node.value, ast.Attribute) and node.value.attr == "shape"
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "size" and bool(node.args))


def _key_elements(key: Optional[ast.AST]) -> List[Tuple[int, ast.AST]]:
    """``(index, element)`` of a key tuple, through ``+`` of tuples (a part
    that is not a tuple literal counts as one element)."""
    if key is None:
        return []
    parts: List[ast.AST] = []

    def flatten(node: ast.AST) -> None:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            flatten(node.left)
            flatten(node.right)
        elif isinstance(node, ast.Tuple):
            parts.extend(node.elts)
        else:
            parts.append(node)

    flatten(key)
    return list(enumerate(parts))
