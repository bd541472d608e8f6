"""PTL002 — Python control flow on graph-captured values.

The reference's rule over jit-traced code, with CUDA-graph capture as the
trace (analysis/astutil.py: a body a graph cache runs, or a def the
capture-root marker marks).  An ``if``/``while``/``assert``, a ternary or
an ``and``/``or`` operand on a captured tensor asks the host for its value
at capture (a sync, which raises inside a capture on the card), and even
where it passes, the branch taken then is frozen into the graph: every
replay repeats it, whatever its inputs hold.  Structural reads
(``x.shape``, ``x.ndim``, ``x.dtype``, ``x.device``, ``len(x)``,
``isinstance``, ``is None``) are fixed per graph, since every input's shape
and dtype is part of its key, and stay allowed; value branches go through
``torch.where`` or into the graph key.

The messages are the reference's with :data:`WORD_REPLACEMENTS` applied
(reference words -> port words): "traced value" -> "captured value",
"@jax.jit" -> "graph-captured", "jnp.where/lax.cond or mark it static" ->
"torch.where or put it in the graph key", "checkify or a host-side
precondition" -> "a host-side precondition before the capture",
"lax.fori_loop/lax.scan" -> "a bound from the graph key", "jnp.where" ->
"torch.where".  The ``and``/``or`` message is the port's own.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .. import astutil
from ..engine import FileContext, Finding, Rule

_STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr"}

#: (reference words, port words), applied in order to a reference message
WORD_REPLACEMENTS = (
    ("traced value", "captured value"),
    ("@jax.jit", "graph-captured"),
    ("jnp.where/lax.cond or mark it static", "torch.where or put it in the graph key"),
    ("checkify or a host-side precondition", "a host-side precondition before the capture"),
    ("lax.fori_loop/lax.scan", "a bound from the graph key"),
    ("jnp.where", "torch.where"),
)


class TracerControlFlowRule(Rule):
    rule_id = "PTL002"
    scope = "all"
    summary = "Python control flow branching on a graph-captured value"
    rationale = (
        "a branch taken at capture is frozen into the graph and every replay "
        "repeats it; branch device-side (torch.where) or put the value in the "
        "graph key"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        root_defs = astutil.capture_roots(ctx.tree)
        for node in astutil.tree_nodes(ctx.tree):
            spec = root_defs.get(id(node))
            if spec is None:
                continue
            tainted = astutil.traced_params(node, spec)
            if isinstance(node, ast.Lambda):
                yield from self._check_ifexp(ctx, node, node.body, set(tainted))
            else:
                yield from self._check_body(ctx, node, node.body, set(tainted))

    def _check_body(
        self, ctx: FileContext, fn: ast.AST, body: List[ast.stmt], tainted: Set[str]
    ) -> Iterator[Finding]:
        for stmt in body:
            yield from self._check_stmt(ctx, fn, stmt, tainted)

    def _check_stmt(
        self, ctx: FileContext, fn: ast.AST, stmt: ast.stmt, tainted: Set[str]
    ) -> Iterator[Finding]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested defs capture the closure; params shadow outer taint
            inner = tainted - {
                a.arg
                for a in stmt.args.posonlyargs + stmt.args.args + stmt.args.kwonlyargs
            }
            yield from self._check_body(ctx, fn, stmt.body, inner)
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            value = stmt.value
            if value is not None:
                yield from self._check_ifexp(ctx, fn, value, tainted)
            if value is not None and self._traced_ref(ctx, value, tainted):
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                )
                for target in targets:
                    for name in ast.walk(target):
                        if isinstance(name, ast.Name):
                            tainted.add(name.id)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            name = self._traced_ref(ctx, stmt.test, tainted)
            if name:
                kind = "if" if isinstance(stmt, ast.If) else "while"
                yield ctx.finding(
                    self.rule_id,
                    stmt,
                    f"'{kind}' condition reads captured value '{name}' inside "
                    f"graph-captured '{_fn_name(fn)}' — use "
                    "torch.where or put it in the graph key",
                )
            yield from self._check_body(ctx, fn, stmt.body, tainted)
            yield from self._check_body(ctx, fn, stmt.orelse, tainted)
            return
        if isinstance(stmt, ast.Assert):
            name = self._traced_ref(ctx, stmt.test, tainted)
            if name:
                yield ctx.finding(
                    self.rule_id,
                    stmt,
                    f"assert on captured value '{name}' inside graph-captured "
                    f"'{_fn_name(fn)}' — use "
                    "a host-side precondition before the capture",
                )
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = stmt.iter
            if isinstance(it, ast.Call) and astutil.call_name(it) == "range":
                name = self._traced_ref(ctx, it, tainted)
                if name:
                    yield ctx.finding(
                        self.rule_id,
                        stmt,
                        f"loop bound reads captured value '{name}' inside "
                        f"graph-captured '{_fn_name(fn)}' — use "
                        "a bound from the graph key",
                    )
            yield from self._check_body(ctx, fn, stmt.body, tainted)
            yield from self._check_body(ctx, fn, stmt.orelse, tainted)
            return
        # descend into remaining compound statements (with/try) and pick up
        # IfExp value-branches anywhere in expressions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                yield from self._check_stmt(ctx, fn, child, tainted)
            elif isinstance(child, ast.ExceptHandler):
                yield from self._check_body(ctx, fn, child.body, tainted)
            elif isinstance(child, ast.expr):
                yield from self._check_ifexp(ctx, fn, child, tainted)

    def _check_ifexp(
        self, ctx: FileContext, fn: ast.AST, expr: ast.expr, tainted: Set[str]
    ) -> Iterator[Finding]:
        for node in ast.walk(expr):
            if isinstance(node, ast.IfExp):
                name = self._traced_ref(ctx, node.test, tainted)
                if name:
                    yield ctx.finding(
                        self.rule_id,
                        node,
                        f"ternary condition reads captured value '{name}' inside "
                        f"graph-captured '{_fn_name(fn)}' — use torch.where",
                    )
            elif isinstance(node, ast.BoolOp):
                # every operand but the last is asked for its truth value
                for operand in node.values[:-1]:
                    name = self._traced_ref(ctx, operand, tainted)
                    if name:
                        op = "and" if isinstance(node.op, ast.And) else "or"
                        yield ctx.finding(
                            self.rule_id,
                            operand,
                            f"'{op}' operand reads captured value '{name}' inside "
                            f"graph-captured '{_fn_name(fn)}' — use torch.where "
                            "or a logical op on tensors",
                        )
                        break

    def _traced_ref(
        self, ctx: FileContext, expr: ast.expr, tainted: Set[str]
    ) -> Optional[str]:
        """Name of a tainted reference in ``expr`` that is NOT behind a
        static read (.shape/.ndim/.dtype/.device/len/isinstance), else
        None."""
        for node in ast.walk(expr):
            if not (isinstance(node, ast.Name) and node.id in tainted):
                continue
            if self._static_read(ctx, node):
                continue
            return node.id
        return None

    def _static_read(self, ctx: FileContext, node: ast.Name) -> bool:
        """True when the tainted name only feeds a capture-time-static read:
        an attribute chain ending in .shape/.ndim/.dtype/.device (or
        ``.size()``/``.dim()``/``.numel()``), ``len(x)``,
        ``isinstance(x, ...)``, or an ``is (not) None`` structure check."""
        cur: ast.AST = node
        parent = ctx.parent(cur)
        while isinstance(parent, ast.Attribute):
            if parent.attr in astutil.STATIC_TENSOR_ATTRS:
                return True
            cur = parent
            parent = ctx.parent(cur)
        if (
            isinstance(parent, ast.Call)
            and astutil.call_name(parent) in _STATIC_CALLS
            and cur in parent.args
        ):
            return True
        if isinstance(parent, ast.Compare):
            operands = [parent.left, *parent.comparators]
            if (
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops)
                and any(
                    isinstance(o, ast.Constant) and o.value is None
                    for o in operands
                )
            ):
                return True
        return False


def _fn_name(fn: ast.AST) -> str:
    return getattr(fn, "name", "<lambda>")
