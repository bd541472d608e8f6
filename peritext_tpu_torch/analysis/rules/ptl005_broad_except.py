"""PTL005 — broad ``except`` outside a declared fault boundary.

The fault-domain architecture (DESIGN.md degradation ladder) works because
failures carry *types*: ``DecodeError`` quarantines a doc,
``TransportError`` marks a peer behind, ``DeviceRoundError`` rolls back a
round.  A broad ``except Exception`` erases that information — unless the
site *is* one of the few declared boundaries where "any failure degrades
identically" is the contract.  Boundaries must say so on the line:
``# graftlint: boundary(reason)`` (``# noqa: BLE001`` is honored too);
everything else catches typed errors from ``core/errors.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .. import astutil
from ..engine import FileContext, Finding, Rule

_BROAD = {"Exception", "BaseException"}


def _broad_name(type_node: ast.AST) -> str | None:
    if type_node is None:
        return "bare except"
    name = astutil.dotted_name(type_node)
    if name in _BROAD or (name and name.split(".")[-1] in _BROAD):
        return f"except {name}"
    if isinstance(type_node, ast.Tuple):
        for elt in type_node.elts:
            hit = _broad_name(elt)
            if hit:
                return hit
    return None


class BroadExceptRule(Rule):
    rule_id = "PTL005"
    scope = "all"
    summary = "broad except outside a declared fault boundary"
    rationale = (
        "typed errors drive the degradation ladder (quarantine / behind / "
        "rollback); broad catches erase the fault type and mask real bugs"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            hit = _broad_name(node.type)
            if hit is None:
                continue
            # boundary/noqa annotations are applied by the engine's
            # suppression pass; reaching here means the line is bare
            yield ctx.finding(
                self.rule_id,
                node,
                f"{hit} is not a declared fault boundary — catch typed "
                "errors from core/errors.py or annotate the line with "
                "'# graftlint: boundary(reason)'",
            )
