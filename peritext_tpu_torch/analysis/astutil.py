"""Shared AST helpers for graftlint rules (pure stdlib: the scanned code is
parsed, never loaded).

The traced-program half (the reference's jit roots, static arguments and
file-local call graph) is carried with CUDA-graph capture as the trace.  A
*captured function* is a body that runs inside a capture:

* a def, lambda or ``self.<method>`` passed as the ``body`` argument (third
  positional, or ``body=``) of a ``.run(`` call on a graph cache
  (utils/graphs.GraphCache); a name is resolved first among the defs nested
  in the functions around the call, then in the file;
* a def marked with the capture-root marker (utils/graphs.captured), the
  port's counterpart of ``@jax.jit`` as a root: a function that a body
  reaches in another module, since reachability stays file-local;
* every def reachable from one of those through the file-local call graph
  (bare and ``self.x(...)`` callee names), as in the reference.

A root's *traced* names are its parameters (they arrive as tensors; the
marker's ``static=`` names and ``self``/``cls`` excepted) and, for a body
nested in the function that calls ``run``, the closure names it reads that
are not *static*: the names in the call's ``key`` argument and those
assigned only from them and constants.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, Iterator, List, NamedTuple, Optional, Set, Tuple

#: the capture-root marker's name (utils/graphs.captured), matched on the
#: last segment of a decorator's dotted name
CAPTURE_MARKER = "captured"
#: attribute reads (and methods) on a captured tensor that are static at
#: capture time: every input's shape and dtype is part of the graph's key
STATIC_TENSOR_ATTRS = {"shape", "ndim", "dtype", "device", "size", "dim", "numel",
                       "is_cuda", "layout"}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


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


# -- captured functions (CUDA-graph capture as the trace) ----------------------


class CaptureSpec(NamedTuple):
    """What one capture root reads: the parameter names that stay static
    (the marker's ``static=``), and, for a body nested in the caller of
    ``run``, the closure names it reads that are traced."""

    static: FrozenSet[str]
    closure: FrozenSet[str]


def _memo(tree: ast.Module, what: str, make):
    """``make(tree)``, computed once per parsed file: every rule of a scan
    asks for the same roots of the same tree."""
    memo = tree.__dict__.setdefault("_graftlint_memo", {})
    if what not in memo:
        memo[what] = make(tree)
    return memo[what]


def tree_nodes(tree: ast.Module) -> List[ast.AST]:
    """``list(ast.walk(tree))``, walked once per parsed file."""
    return _memo(tree, "nodes", lambda t: list(ast.walk(t)))


def module_defs(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Every function def in the file by bare name, methods and nested defs
    included, in source order: a name defined twice (a ``body`` per branch
    of one function) keeps every definition, so the file-local call graph
    reaches all of them."""
    return _memo(tree, "defs", _module_defs)


def _module_defs(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    defs: Dict[str, List[ast.AST]] = {}
    for node in tree_nodes(tree):
        if isinstance(node, _FUNCS):
            defs.setdefault(node.name, []).append(node)
    for nodes in defs.values():
        nodes.sort(key=lambda n: (n.lineno, n.col_offset))
    return defs


def _marker(dec: ast.AST) -> Optional[FrozenSet[str]]:
    """The static names of a capture-root marker decorator, else None."""
    call = dec if isinstance(dec, ast.Call) else None
    name = dotted_name(call.func if call else dec)
    if name is None or name.rpartition(".")[2] != CAPTURE_MARKER:
        return None
    static: Set[str] = set()
    for kw in call.keywords if call else ():
        if kw.arg == "static":
            static |= _const_strs(kw.value)
    return frozenset(static)


def _const_strs(node: ast.AST) -> Set[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for elt in node.elts:
            out |= _const_strs(elt)
        return out
    return set()


def _parents(tree: ast.Module) -> Dict[int, ast.AST]:
    return _memo(tree, "parents", _make_parents)


def _make_parents(tree: ast.Module) -> Dict[int, ast.AST]:
    parents: Dict[int, ast.AST] = {}
    for node in tree_nodes(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def _ancestors(node: ast.AST, parents: Dict[int, ast.AST]) -> Iterator[ast.AST]:
    cur = parents.get(id(node))
    while cur is not None:
        yield cur
        cur = parents.get(id(cur))


def _graph_cache_names(tree: ast.Module) -> Set[str]:
    """Names and attributes assigned a ``GraphCache(...)`` in the file."""
    out: Set[str] = set()
    for node in tree_nodes(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            name = dotted_name(node.value.func)
            if name is not None and name.rpartition(".")[2] == "GraphCache":
                for target in node.targets:
                    leaf = _leaf_name(target)
                    if leaf:
                        out.add(leaf)
    return out


def _leaf_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a receiver: ``self._shard_graphs[s]`` ->
    ``_shard_graphs``."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def graph_run_calls(tree: ast.Module) -> Iterator[ast.Call]:
    """Every ``<graph cache>.run(...)`` call in the file: the receiver's
    last identifier names a graph cache (``graphs``, ``self._graphs``,
    ``self._shard_graphs[s]``) or was assigned a ``GraphCache(...)``."""
    return iter(_memo(tree, "runs", _graph_run_calls))


def _graph_run_calls(tree: ast.Module) -> List[ast.Call]:
    runs = [node for node in tree_nodes(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "run"]
    if not runs:
        return []
    caches = _graph_cache_names(tree)
    return [node for node in runs
            if (leaf := _leaf_name(node.func.value))
            and ("graph" in leaf.lower() or leaf in caches)]


def run_argument(call: ast.Call, index: int, name: str) -> Optional[ast.AST]:
    """``GraphCache.run``'s argument ``name`` (positional ``index``)."""
    if len(call.args) > index and not any(isinstance(a, ast.Starred)
                                          for a in call.args[:index + 1]):
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _enclosing_functions(node: ast.AST, parents) -> List[ast.AST]:
    return [a for a in _ancestors(node, parents) if isinstance(a, _FUNCS + (ast.Lambda,))]


def _nested_defs(fn: ast.AST, name: str) -> List[ast.AST]:
    """Defs called ``name`` nested in ``fn`` (not inside a deeper def)."""
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNCS):
            if node.name == name:
                out.append(node)
            continue
        if isinstance(node, (ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return sorted(out, key=lambda n: (n.lineno, n.col_offset))


def _resolve_body(expr: ast.AST, call: ast.Call, parents, defs) -> List[ast.AST]:
    """The def or lambda nodes a ``run`` call's body expression names."""
    if isinstance(expr, ast.Lambda):
        return [expr]
    if isinstance(expr, ast.Name):
        for fn in _enclosing_functions(call, parents):
            nested = _nested_defs(fn, expr.id)
            if nested:
                return nested
        return list(defs.get(expr.id, ()))
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id in ("self", "cls")):
        for anc in _ancestors(call, parents):
            if isinstance(anc, ast.ClassDef):
                return [n for n in anc.body if isinstance(n, _FUNCS) and n.name == expr.attr]
        return list(defs.get(expr.attr, ()))
    return []


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names a function binds in its own scope: parameters and assignment
    targets (not inside nested defs)."""
    args = fn.args
    out = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    out |= {a.arg for a in (args.vararg, args.kwarg) if a is not None}
    for node in _own_nodes(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes of a function's own scope: its body, not its nested defs,
    lambdas or classes."""
    stack = list(fn.body) if isinstance(fn.body, list) else [fn.body]
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNCS + (ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _static_names(fn: ast.AST, key: Optional[ast.AST]) -> Set[str]:
    """Names of ``fn``'s scope that are static for a capture keyed by
    ``key``: the names the key reads, and (to a fixpoint) those assigned
    only from static names and constants."""
    static = {n.id for n in ast.walk(key) if isinstance(n, ast.Name)} if key is not None else set()
    assigns = [n for n in _own_nodes(fn) if isinstance(n, (ast.Assign, ast.AnnAssign))
               and n.value is not None]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if any(isinstance(v, ast.Call) for v in ast.walk(node.value)):
                continue
            reads = {v.id for v in ast.walk(node.value) if isinstance(v, ast.Name)}
            if not reads <= static:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                for name in ast.walk(target):
                    if isinstance(name, ast.Name) and name.id not in static:
                        static.add(name.id)
                        changed = True
    return static


def _closure_traced(body: ast.AST, call: ast.Call, parents) -> FrozenSet[str]:
    """The closure names a nested body reads that its enclosing functions
    bind and that are not static for the call's key."""
    own = _bound_names(body)
    reads = {n.id for n in ast.walk(body) if isinstance(n, ast.Name)
             and isinstance(n.ctx, ast.Load)} - own
    key = run_argument(call, 0, "key")
    traced: Set[str] = set()
    for fn in _enclosing_functions(body, parents):
        bound = _bound_names(fn)  # a nested def's name is not bound by assignment
        traced |= (reads & bound) - _static_names(fn, key)
        reads -= bound
    return frozenset(traced)


def capture_roots(tree: ast.Module) -> Dict[int, CaptureSpec]:
    """``id(def-or-lambda node) -> CaptureSpec`` for every capture root of
    the file: each body of a graph cache's ``run`` call and each def the
    capture-root marker marks."""
    return _memo(tree, "roots", _capture_roots)


def _capture_roots(tree: ast.Module) -> Dict[int, CaptureSpec]:
    roots: Dict[int, CaptureSpec] = {}
    for defs in module_defs(tree).values():
        for node in defs:
            for dec in node.decorator_list:
                static = _marker(dec)
                if static is not None:
                    roots[id(node)] = CaptureSpec(static, frozenset())
    calls = list(graph_run_calls(tree))
    if not calls:
        return roots
    parents = _parents(tree)
    defs = module_defs(tree)
    for call in calls:
        body = run_argument(call, 2, "body")
        if body is None:
            continue
        for node in _resolve_body(body, call, parents, defs):
            closure = _closure_traced(node, call, parents)
            prev = roots.get(id(node))
            if prev is not None:
                closure |= prev.closure
            roots[id(node)] = CaptureSpec(prev.static if prev else frozenset(), closure)
    return roots


def traced_params(fn: ast.AST, spec: CaptureSpec) -> Set[str]:
    """Names that arrive as captured tensors: the root's parameters (its
    ``*args`` too; static names, ``self`` and ``cls`` excluded) and its
    traced closure names."""
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    names += [a.arg for a in (args.vararg,) if a is not None]
    traced = {n for n in names if n not in spec.static and n not in ("self", "cls")}
    return traced | set(spec.closure)


def called_local_names(fn: ast.AST) -> Set[str]:
    """Bare and ``self.x(...)`` callee names inside a function body — the
    edges of the file-local call graph."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Name):
            out.add(func.id)
        elif (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id in ("self", "cls")
        ):
            out.add(func.attr)
    return out


def captured_functions(tree: ast.Module) -> Dict[int, Tuple[ast.AST, str]]:
    """``id(def-or-lambda node) -> (node, chain label)`` for every captured
    function of the file: the capture roots and what they reach through the
    file-local call graph (module doc)."""
    return _memo(tree, "captured", _captured_functions)


def _captured_functions(tree: ast.Module) -> Dict[int, Tuple[ast.AST, str]]:
    roots = capture_roots(tree)
    if not roots:
        return {}
    defs = module_defs(tree)
    by_id = {id(n): n for n in tree_nodes(tree) if id(n) in roots}
    reachable: Dict[int, Tuple[ast.AST, str]] = {}
    frontier = []
    for node in sorted(by_id.values(), key=lambda n: (n.lineno, n.col_offset)):
        label = getattr(node, "name", "<lambda>")
        reachable[id(node)] = (node, label)
        frontier.append((node, label))
    while frontier:
        node, chain = frontier.pop()
        for callee in sorted(called_local_names(node)):
            for target in defs.get(callee, ()):
                if id(target) in reachable:
                    continue
                label = f"{chain} -> {callee}"
                reachable[id(target)] = (target, label)
                frontier.append((target, label))
    return reachable


def qualnames(tree: ast.Module) -> Dict[int, str]:
    """``id(node) -> __qualname__`` of every def, lambda and generator
    expression of the file, as the interpreter names their code (a
    comprehension other than a generator expression runs inline, with no
    frame of its own)."""
    out: Dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.ClassDef,) + _FUNCS):
                name = prefix + child.name
                if not isinstance(child, ast.ClassDef):
                    out[id(child)] = name
                    # decorators and defaults run in the enclosing scope
                    for sub in child.decorator_list + child.args.defaults + [
                            d for d in child.args.kw_defaults if d is not None]:
                        visit_expr(sub, prefix)
                    visit(_Body(child.body), name + ".<locals>.")
                else:
                    for sub in child.decorator_list:
                        visit_expr(sub, prefix)
                    visit(_Body(child.body), name + ".")
            elif isinstance(child, (ast.Lambda, ast.GeneratorExp)):
                visit_expr(child, prefix)
            else:
                visit(child, prefix)

    def visit_expr(node: ast.AST, prefix: str) -> None:
        if isinstance(node, (ast.Lambda, ast.GeneratorExp)):
            name = prefix + ("<lambda>" if isinstance(node, ast.Lambda) else "<genexpr>")
            out[id(node)] = name
            if isinstance(node, ast.Lambda):
                for sub in node.args.defaults:
                    visit_expr(sub, prefix)
                visit_expr(node.body, name + ".<locals>.")
            else:
                # the first iterable is evaluated in the enclosing scope
                visit_expr(node.generators[0].iter, prefix)
                rest = [node.elt] + [g.target for g in node.generators] + [
                    x for i, g in enumerate(node.generators)
                    for x in ([g.iter] if i else []) + g.ifs]
                for sub in rest:  # a comprehension scope adds no "<locals>"
                    visit_expr(sub, name + ".")
            return
        visit(_Body([node]), prefix)

    visit(tree, "")
    return out


class _Body(ast.AST):
    """A statement list as one node, for :func:`qualnames`' walk."""

    _fields = ("body",)

    def __init__(self, body) -> None:
        super().__init__()
        self.body = body
