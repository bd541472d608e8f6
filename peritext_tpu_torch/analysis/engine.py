"""graftlint engine: file collection, per-file AST context, rule dispatch,
inline suppressions (the port's copy of the reference package's engine).

The engine is deliberately import-free with respect to the scanned code: it
parses source text with :mod:`ast` only, so it runs anywhere (CI lint jobs,
pre-commit) without torch or a card.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

from . import astutil

#: ``# graftlint: disable=PTL001,PTL006`` — suppress those rules on this line
_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Z0-9_,\s]+)")
#: ``# graftlint: boundary(reason)`` — declares a fault boundary (PTL005)
_BOUNDARY_RE = re.compile(r"#\s*graftlint:\s*boundary\(([^)]*)\)")
#: ruff/flake8 blind-except suppression doubles as a boundary declaration
_NOQA_BLE_RE = re.compile(r"#\s*noqa\b[^#]*\bBLE001\b")


@dataclass(frozen=True)
class LintConfig:
    """Project knobs shared by every rule."""

    #: directory names whose files are "merge/convergence scope" (PTL001,
    #: PTL004's shape checks, PTL006)
    merge_scope_dirs: frozenset = frozenset({"core", "ops", "parallel", "store"})
    #: '/'-joined path suffixes of INDIVIDUAL merge-scope files living in
    #: otherwise out-of-scope directories.  plan/ is the canonical split:
    #: the cost model (plan/model.py, plan/tuner.py) is observability —
    #: wall-clock reads are legal — but plan/fusion.py assembles the
    #: cross-tenant fusion groups that decide device dispatch order, so it
    #: must stay deterministic like the merge kernels it feeds.  obs/ has
    #: the same split: every other obs module reads clocks freely (that's
    #: the design rule — clock reads live THERE), but obs/timeseries.py is
    #: the round-counted history plane whose retention/anomaly scoring
    #: must replay byte-identically, so it joins the merge scope and its
    #: sampling overhead is fed in as data via note_overhead()
    merge_scope_files: frozenset = frozenset(
        {"plan/fusion.py", "obs/timeseries.py"}
    )
    #: functions that route a raw length into the padded-shape tables
    #: (streaming.py's ``_width_bucket`` is the canonical instance); PTL007
    #: bans them from the ragged modules
    bucket_fns: frozenset = frozenset({"_width_bucket", "width_bucket", "next_pow2"})


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-root-relative (baseline-stable), '/'-separated
    line: int
    col: int
    message: str
    #: stripped source line — the line-number-independent fingerprint basis
    context: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "context": self.context,
        }


class FileContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, display_path: str, source: str, tree: ast.Module, config: LintConfig):
        self.display_path = display_path
        self.tree = tree
        self.config = config
        self.lines = source.splitlines()
        self._parents: Dict[int, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
        self.suppressed: Dict[int, Set[str]] = {}
        self.boundaries: Dict[int, str] = {}
        for lineno, text in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppressed.setdefault(lineno, set()).update(rules)
            m = _BOUNDARY_RE.search(text)
            if m:
                self.boundaries[lineno] = m.group(1).strip()
                self.suppressed.setdefault(lineno, set()).add("PTL005")
            elif _NOQA_BLE_RE.search(text):
                self.suppressed.setdefault(lineno, set()).add("PTL005")
        parts = Path(display_path).parts[:-1]
        posix = Path(display_path).as_posix()
        self.in_merge_scope = (
            any(p in config.merge_scope_dirs for p in parts)
            or any(posix.endswith(f) for f in config.merge_scope_files)
        )
        self.module_aliases, self.from_imports = astutil.import_maps(tree)

    # -- helpers used by rules ------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def resolve(self, name: str) -> str:
        return astutil.resolve_name(name, self.module_aliases, self.from_imports)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule, self.display_path, lineno, col, message, self.line_text(lineno))


class Rule:
    """Base class: subclasses set ``rule_id``/``summary``/``rationale`` and
    implement :meth:`check`."""

    rule_id: str = "PTL000"
    #: "merge" rules only run on files under a merge-scope directory
    scope: str = "all"
    summary: str = ""
    rationale: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


def _registry() -> Dict[str, Rule]:
    from .rules import ALL_RULES

    return ALL_RULES


def all_rule_ids() -> List[str]:
    """Every registered rule id — derived from the registry, so a new rule
    module can never be silently excluded from the default scan."""
    return sorted(_registry())


def rule_table() -> List[Dict[str, str]]:
    """(id, scope, summary, rationale) for docs and ``--list-rules``."""
    return [
        {
            "id": rule.rule_id,
            "scope": rule.scope,
            "summary": rule.summary,
            "rationale": rule.rationale,
        }
        for rule in sorted(_registry().values(), key=lambda r: r.rule_id)
    ]


def collect_files(paths: Sequence[str | Path]) -> List[Path]:
    """Every ``.py`` file under ``paths``.  A nonexistent or non-Python
    path is an error, never an empty result — a typo'd scan target must
    not make lint a silent no-op."""
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(
                f for f in sorted(path.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        elif path.is_file():
            if path.suffix != ".py":
                raise ValueError(f"not a Python file: {path}")
            files.append(path)
        else:
            raise FileNotFoundError(f"no such file or directory: {path}")
    return files


def scan_file(
    path: Path,
    *,
    root: Optional[Path] = None,
    config: Optional[LintConfig] = None,
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    config = config or LintConfig()
    root = root or Path.cwd()
    try:
        display = path.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        display = path.as_posix()
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError, ValueError) as exc:
        return [Finding("PTL000", display, getattr(exc, "lineno", 1) or 1, 0,
                        f"unparseable file: {exc}", "")]
    ctx = FileContext(display, source, tree, config)
    wanted = set(rules) if rules is not None else None
    findings: List[Finding] = []
    for rule in _registry().values():
        if wanted is not None and rule.rule_id not in wanted:
            continue
        if rule.scope == "merge" and not ctx.in_merge_scope:
            continue
        for finding in rule.check(ctx):
            if finding.rule in ctx.suppressed.get(finding.line, ()):
                continue
            findings.append(finding)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def scan_paths(
    paths: Sequence[str | Path],
    *,
    root: Optional[Path] = None,
    config: Optional[LintConfig] = None,
    rules: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Lint every ``.py`` file under ``paths``; findings carry paths relative
    to ``root`` (the baseline anchor) and are sorted for stable output."""
    findings: List[Finding] = []
    for path in collect_files(paths):
        findings.extend(scan_file(path, root=root, config=config, rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
