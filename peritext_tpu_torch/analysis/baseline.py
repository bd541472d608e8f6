"""Attributed baseline: the ledger of known, *justified* findings.

The package self-scan must be clean — but some violations are intentional
(observability timing in a hot loop, transport jitter that is nondeterministic
by design).  Those live in ``peritext_tpu_torch/graftlint_baseline.json``, one
entry per finding, each carrying a human justification.  Fingerprints are
``(rule, path, stripped source line, occurrence count)`` — line-number drift
never invalidates an entry; editing or removing the offending line does.

* a scan finding with no baseline budget left → **new** (fails the lint);
* a baseline entry whose finding no longer occurs → **stale** (warned, so
  the ledger gets pruned, but lint stays green — deleting dead suppressions
  must never block a fix).
"""

from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .engine import Finding

BASELINE_NAME = "graftlint_baseline.json"

#: fingerprint key
Key = Tuple[str, str, str]  # (rule, path, context)


@dataclass
class BaselineEntry:
    rule: str
    path: str
    context: str
    count: int
    justification: str


def load_baseline(path: Path) -> Dict[Key, BaselineEntry]:
    data = json.loads(path.read_text(encoding="utf-8"))
    entries: Dict[Key, BaselineEntry] = {}
    for raw in data.get("findings", []):
        entry = BaselineEntry(
            rule=raw["rule"],
            path=raw["path"],
            context=raw["context"],
            count=int(raw.get("count", 1)),
            justification=raw.get("justification", ""),
        )
        key = (entry.rule, entry.path, entry.context)
        if key in entries:  # merge duplicates defensively
            entries[key].count += entry.count
        else:
            entries[key] = entry
    return entries


def save_baseline(path: Path, entries: Iterable[BaselineEntry]) -> None:
    payload = {
        "//": "graftlint attributed baseline — every entry is a known, "
              "justified violation; regenerate with --update-baseline",
        "version": 1,
        "findings": [
            {
                "rule": e.rule,
                "path": e.path,
                "context": e.context,
                "count": e.count,
                "justification": e.justification,
            }
            for e in sorted(entries, key=lambda e: (e.path, e.rule, e.context))
        ],
    }
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")


def apply_baseline(
    findings: Sequence[Finding], entries: Dict[Key, BaselineEntry]
) -> Tuple[List[Finding], List[BaselineEntry]]:
    """``(new, stale)``: findings not covered by the baseline, and baseline
    entries no longer matched by any finding (candidates for pruning)."""
    budget = Counter({key: e.count for key, e in entries.items()})
    new: List[Finding] = []
    for finding in findings:  # findings arrive line-sorted: earlier wins budget
        key = (finding.rule, finding.path, finding.context)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            new.append(finding)
    stale = [
        entries[key]
        for key, remaining in sorted(budget.items())
        if remaining > 0
    ]
    return new, stale


def update_baseline(
    findings: Sequence[Finding], old: Dict[Key, BaselineEntry]
) -> List[BaselineEntry]:
    """Rebuild entries from a scan, preserving existing justifications."""
    counts: Counter = Counter(
        (f.rule, f.path, f.context) for f in findings
    )
    out: List[BaselineEntry] = []
    for (rule, path, context), count in sorted(counts.items()):
        prior = old.get((rule, path, context))
        out.append(
            BaselineEntry(
                rule=rule,
                path=path,
                context=context,
                count=count,
                justification=prior.justification if prior else "TODO: justify or fix",
            )
        )
    return out


#: the port package: the only place its linter reads a default baseline from
#: or writes one to (the repo root's ``graftlint_baseline.json`` is the JAX
#: package's frozen ledger)
PACKAGE_DIR = Path(__file__).resolve().parent.parent


def package_baseline() -> Path:
    """The port package's own baseline file (it may not exist yet)."""
    return PACKAGE_DIR / BASELINE_NAME


def inside_package(path: str | Path) -> bool:
    """Whether ``path`` lies in the port package (the package itself
    included)."""
    resolved = Path(path).resolve()
    root = PACKAGE_DIR.resolve()
    return resolved == root or root in resolved.parents


def find_default_baseline() -> Optional[Path]:
    """The package's own baseline, whatever is scanned; None if absent.
    Never a walk up from the scanned paths: from a path outside the
    package that walk would reach the JAX package's baseline at the repo
    root."""
    hit = package_baseline()
    return hit if hit.is_file() else None
