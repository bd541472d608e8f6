"""PTL003 — host synchronization or transfer reachable from a graph capture.

The reference's rule over jit-traced code, with CUDA-graph capture as the
trace (analysis/astutil.py).  Inside a capture on the card a host sync
raises and the capture is abandoned (utils/graphs.py), while on the CPU the
same body runs eagerly and passes: only this rule sees such a sync before a
rare signature meets it on the card.  Flagged, in a captured function or
anything it reaches within its file (a helper called by bare name or
``self.method``):

* syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize``, an event's or stream's ``.synchronize()``,
  ``numpy.asarray``/``numpy.array`` of a tensor, and ``float``/``int``/
  ``bool``/``complex`` of a captured value;
* ops whose output size depends on the data, which read a count back:
  ``nonzero``, ``masked_select``, ``unique``, ``unique_consecutive``,
  ``argwhere`` (function or method), ``repeat_interleave`` without
  ``output_size``, and indexing by a boolean mask;
* host-to-device constructions: ``torch.tensor``, ``torch.as_tensor``,
  ``torch.from_numpy`` (whose ``.to(<device>)`` is the copy) and
  ``.cuda()``/``.pin_memory()``: a graph keeps the source's address, and
  a replay reads whatever the host has put there since.

The messages are the reference's with :data:`WORD_REPLACEMENTS` applied
(reference words -> port words): "reachable from @jax.jit" -> "reachable
from a graph capture", "inside @jax.jit" -> "inside a graph capture",
"the jit boundary" -> "the capture", "traced code" -> "captured code",
"traced value" -> "captured value", "keep it as an array" -> "keep it as a
tensor".  The transfer and boolean-mask messages are the port's own.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from .. import astutil
from ..engine import FileContext, Finding, Rule

#: fully-resolved call names that force a host sync
_SYNC_CALLS = {
    "torch.cuda.synchronize",
    "numpy.asarray",
    "numpy.array",
}
#: method attributes that force a host sync on a tensor receiver
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: ops (torch functions or tensor methods) whose output size is data
_DATA_SIZED = {"nonzero", "masked_select", "unique", "unique_consecutive", "argwhere"}
#: host-to-device constructions: the graph keeps the host source's address
_H2D_CALLS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}
_H2D_METHODS = {"cuda", "pin_memory"}
_CASTS = {"float", "int", "bool", "complex"}

#: (reference words, port words), applied in order to a reference message
WORD_REPLACEMENTS = (
    ("reachable from @jax.jit", "reachable from a graph capture"),
    ("inside @jax.jit", "inside a graph capture"),
    ("the jit boundary", "the capture"),
    ("traced code", "captured code"),
    ("traced value", "captured value"),
    ("keep it as an array", "keep it as a tensor"),
)


class HostSyncRule(Rule):
    rule_id = "PTL003"
    scope = "all"
    summary = "host sync or transfer reachable from a graph capture"
    rationale = (
        "a host sync raises inside a CUDA-graph capture and a host-to-device "
        "copy is frozen by address; keep captured programs on the device"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        reachable = astutil.captured_functions(ctx.tree)
        if not reachable:
            return
        roots = astutil.capture_roots(ctx.tree)
        for node, chain in sorted(reachable.values(),
                                  key=lambda item: (item[0].lineno, item[0].col_offset)):
            spec = roots.get(id(node))
            tainted = astutil.traced_params(node, spec) if spec else set()
            yield from self._scan_fn(ctx, node, chain, tainted)

    def _scan_fn(
        self, ctx: FileContext, fn: ast.AST, chain: str, tainted: Set[str]
    ) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if isinstance(node, ast.Subscript):
                if isinstance(node.ctx, ast.Load) and _boolean_mask(node.slice):
                    yield ctx.finding(
                        self.rule_id,
                        node,
                        f"boolean-mask index reachable from a graph capture (via "
                        f"{chain}) — its size is data, a host sync; use torch.where",
                    )
                continue
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_name(node)
            resolved = ctx.resolve(name) if name else None
            head = name.partition(".")[0] if name else None
            # a function of an imported module, or a method of a value
            module_call = head in ctx.module_aliases or head in ctx.from_imports
            method = (node.func.attr if isinstance(node.func, ast.Attribute)
                      and not module_call else None)
            if resolved in _SYNC_CALLS or (
                module_call and resolved.startswith("torch.")
                and _data_sized(node, resolved.rpartition(".")[2])
            ):
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"host sync '{resolved}' reachable from a graph capture "
                    f"(via {chain}) — keep the device program pure or move "
                    "the sync outside the capture",
                )
                continue
            if method is not None and (
                (method in _SYNC_METHODS and not node.args) or _data_sized(node, method)
            ):
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"host sync '.{method}()' reachable from a graph capture "
                    f"(via {chain}) — device values must stay on device "
                    "inside captured code",
                )
                continue
            if resolved in _H2D_CALLS or (method in _H2D_METHODS and not node.args):
                what = resolved if resolved in _H2D_CALLS else f".{method}()"
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"host-to-device copy '{what}' inside a graph capture (via "
                    f"{chain}) — the graph keeps its source's address; make it "
                    "before the capture and pass it in",
                )
                continue
            if (
                name in _CASTS
                and len(node.args) == 1
                and isinstance(node.args[0], ast.Name)
                and node.args[0].id in tainted
            ):
                yield ctx.finding(
                    self.rule_id,
                    node,
                    f"'{name}()' concretizes captured value "
                    f"'{node.args[0].id}' inside a graph capture (via {chain}) — "
                    "this is a host sync; keep it as a tensor",
                )


def _data_sized(call: ast.Call, op: str) -> bool:
    """``op`` (a torch function's or a tensor method's name) has an output
    whose size is data."""
    if op == "repeat_interleave":
        return not any(kw.arg == "output_size" for kw in call.keywords)
    return op in _DATA_SIZED


def _boolean_mask(index: ast.AST) -> bool:
    """An index that is plainly a boolean mask: a comparison, a negation
    or a ``&``/``|`` of comparisons."""
    if isinstance(index, ast.Compare):
        return not any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                       for op in index.ops)
    if isinstance(index, ast.UnaryOp) and isinstance(index.op, ast.Invert):
        return _boolean_mask(index.operand) or isinstance(index.operand, ast.Name)
    if isinstance(index, ast.BinOp) and isinstance(index.op, (ast.BitAnd, ast.BitOr)):
        return _boolean_mask(index.left) or _boolean_mask(index.right)
    return False
