"""Shared AST helpers for graftlint rules (pure stdlib: the scanned code is
parsed, never loaded).

The reference package's helpers for its traced-program rules (jit roots,
static arguments, the file-local call graph) have no counterpart here: the
rules that used them are not carried (see the package docstring)."""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Tuple


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def import_maps(tree: ast.Module) -> Tuple[Dict[str, str], Dict[str, str]]:
    """``(module_aliases, from_imports)``: ``np -> numpy`` and
    ``perf_counter -> time.perf_counter`` style maps for name resolution."""
    aliases: Dict[str, str] = {}
    from_imports: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                aliases[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                from_imports[alias.asname or alias.name] = (
                    f"{node.module}.{alias.name}"
                )
    return aliases, from_imports


def resolve_name(name: str, aliases: Dict[str, str], from_imports: Dict[str, str]) -> str:
    """Expand the leading segment of a dotted name through the file's
    imports: ``np.asarray -> numpy.asarray``, ``Random -> random.Random``."""
    head, _, rest = name.partition(".")
    if head in from_imports:
        full = from_imports[head]
        return f"{full}.{rest}" if rest else full
    if head in aliases:
        return f"{aliases[head]}.{rest}" if rest else aliases[head]
    return name


def iteration_sites(tree: ast.Module) -> Iterator[Tuple[ast.AST, ast.AST]]:
    """Yield ``(iter_expr, anchor_node)`` for every for-loop and
    comprehension generator in the file."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield node.iter, node
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            for gen in node.generators:
                yield gen.iter, node
