"""PTL001 — unordered set/dict iteration in merge/convergence modules.

Python dicts iterate in *insertion* order — for long-lived instance state
(subscriber tables, quarantine registries, per-doc side tables) insertion
order is arrival order, which diverges across replicas and sessions.  Sets
hash-order their elements outright.  Anything in ``core/``/``ops/``/
``parallel/`` that fans out deliveries, builds digests, or walks registries
must iterate in an order derived from the *keys* (``sorted(...)``), not
from history.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from .. import astutil
from ..engine import FileContext, Finding, Rule

#: wrappers that preserve the inner iterable's (dis)order
_ORDER_NEUTRAL = {"list", "tuple", "enumerate", "reversed", "iter"}
#: wrappers that impose a deterministic order
_ORDERING = {"sorted"}
_DICT_VIEWS = {"keys", "values", "items"}
#: consumers whose result does not depend on generation order — a
#: comprehension feeding one of these directly is order-clean
_ORDER_INSENSITIVE = {"sorted", "set", "frozenset", "sum", "max", "min", "any", "all", "len"}


def _set_bound_names(tree: ast.Module) -> Set[str]:
    """Names assigned from an obvious set expression anywhere in the file."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and _is_set_expr(node.value):
            out.add(target.id)
    return out


def _typed_attr_names(tree: ast.Module) -> tuple[Set[str], Set[str]]:
    """``(set_attrs, dict_attrs)``: attribute names assigned an obvious
    set / dict expression anywhere in the file (``self._pending = set()``,
    ``self._subscribers = {}``) — bare iteration over these is the most
    common spelling of the arrival-order hazard."""
    set_attrs: Set[str] = set()
    dict_attrs: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        target = node.targets[0]
        if not isinstance(target, ast.Attribute):
            continue
        if _is_set_expr(node.value):
            set_attrs.add(target.attr)
        elif _is_dict_expr(node.value):
            dict_attrs.add(target.attr)
    return set_attrs, dict_attrs


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and astutil.call_name(node) in ("set", "frozenset"):
        return True
    return False


def _is_dict_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.DictComp)):
        return True
    if isinstance(node, ast.Call) and astutil.call_name(node) in (
        "dict", "defaultdict", "collections.defaultdict", "OrderedDict",
        "collections.OrderedDict", "Counter", "collections.Counter",
    ):
        return True
    return False


def _unwrap(expr: ast.AST) -> Optional[ast.AST]:
    """Peel order-neutral wrappers; None means an ordering wrapper was hit."""
    while isinstance(expr, ast.Call):
        name = astutil.call_name(expr)
        if name in _ORDERING:
            return None
        if name in _ORDER_NEUTRAL and expr.args:
            expr = expr.args[0]
            continue
        break
    return expr


class UnorderedIterationRule(Rule):
    rule_id = "PTL001"
    scope = "merge"
    summary = "unordered set/dict iteration in a merge/convergence module"
    rationale = (
        "insertion/hash order is replica-local history; digests and delivery "
        "fan-out must iterate in sorted key order to converge byte-equal"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        set_names = _set_bound_names(ctx.tree)
        set_attrs, dict_attrs = _typed_attr_names(ctx.tree)
        for iter_expr, anchor in astutil.iteration_sites(ctx.tree):
            reason = self._unordered_reason(iter_expr, set_names, set_attrs, dict_attrs)
            if reason is not None and not self._order_insensitive(ctx, anchor):
                yield ctx.finding(
                    self.rule_id,
                    anchor,
                    f"iteration over {reason} — wrap in sorted(...) or "
                    "attribute the site in the graftlint baseline",
                )

    def _order_insensitive(self, ctx: FileContext, anchor: ast.AST) -> bool:
        """A comprehension fed directly to sorted()/set()/sum()/... cannot
        leak generation order into its result."""
        if isinstance(anchor, ast.SetComp):
            return True  # result is itself unordered; any leak is flagged at ITS use
        if not isinstance(anchor, (ast.ListComp, ast.GeneratorExp)):
            return False
        parent = ctx.parent(anchor)
        return (
            isinstance(parent, ast.Call)
            and astutil.call_name(parent) in _ORDER_INSENSITIVE
            and anchor in parent.args
        )

    def _unordered_reason(
        self,
        expr: ast.AST,
        set_names: Set[str],
        set_attrs: Set[str],
        dict_attrs: Set[str],
    ) -> Optional[str]:
        expr = _unwrap(expr)
        if expr is None:
            return None
        if isinstance(expr, (ast.Set, ast.SetComp)):
            return "a set literal/comprehension"
        if isinstance(expr, ast.Call):
            name = astutil.call_name(expr)
            if name in ("set", "frozenset"):
                return f"{name}(...)"
            if (
                isinstance(expr.func, ast.Attribute)
                and expr.func.attr in _DICT_VIEWS
                and isinstance(expr.func.value, ast.Attribute)
            ):
                recv = astutil.dotted_name(expr.func.value) or "<attr>"
                return (
                    f"dict view '{recv}.{expr.func.attr}()' of long-lived "
                    "instance state (insertion order = arrival order)"
                )
            return None
        if isinstance(expr, ast.Name) and expr.id in set_names:
            return f"set-typed name '{expr.id}'"
        if isinstance(expr, ast.Attribute):
            name = astutil.dotted_name(expr) or expr.attr
            if expr.attr in set_attrs:
                return f"set-typed instance state '{name}'"
            if expr.attr in dict_attrs:
                return (
                    f"dict-typed instance state '{name}' "
                    "(insertion order = arrival order)"
                )
        return None
